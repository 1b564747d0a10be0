"""Instruction-trace capture from the port's diffusion tick, a port of
src/repro/sim/trace.py.

Traces are **not hand-written**: emission hooks live inside the sampling
code (core/sampling.py, core/diffusion.py) and fire while the tick runs, so
the recorded op stream follows the real control flow -- chunk counts from
``sampling._chunk_grid``, head-path routing from ``head_feed_mode``.  The
stream describes the paper's NPU (its vocab chunks, its ``isa.TILE_R``
logit tile), not the CUDA kernels that compute the same function on the
H100, so the same tick records the same ops on every device.

Where JAX runs the real functions under ``jax.eval_shape``, the port runs
them on ``torch.device("meta")`` tensors: no arithmetic, no parameter
memory, so a trace of the full llada-8b tick costs nothing on any host.
The kernel wrappers send meta tensors to their plain versions, which only
compute shapes there.

The emission hooks are no-ops unless a tracer is active (module-level
context installed by ``activate``), so serving paths pay nothing.  A loop
over vocab chunks emits its per-chunk op groups once, from the caller,
where the chunk count is known, and runs under ``suppress()``, as JAX's
scans do.  A tracer records only eager calls: a replayed CUDA graph runs
no Python (core/graphs.py), so one must never be active during a capture
or become a key of a cached tick function.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.sim import isa

# ---------------------------------------------------------------------------
# Trace data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceOp:
    """One recorded instruction: op name (an isa.ISA key), the logical
    tensor shape it covers, storage format (memory/net ops), pipeline stage
    label, and a free-form note (buffer names for SRAM ops)."""
    op: str
    shape: Tuple[int, ...] = ()
    fmt: str = "none"
    stage: str = "sampling"
    note: str = ""

    @property
    def elems(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 0

    @property
    def bytes(self) -> float:
        return self.elems * isa.fmt_bytes(self.fmt)

    @property
    def engine(self) -> str:
        return isa.ISA[self.op].engine

    def to_dict(self) -> Dict[str, Any]:
        return {"op": self.op, "shape": list(self.shape), "fmt": self.fmt,
                "stage": self.stage, "note": self.note}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceOp":
        return cls(op=d["op"], shape=tuple(int(s) for s in d["shape"]),
                   fmt=d["fmt"], stage=d["stage"], note=d.get("note", ""))


@dataclasses.dataclass
class Trace:
    ops: List[TraceOp] = dataclasses.field(default_factory=list)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[TraceOp]:
        return iter(self.ops)

    def op_names(self) -> List[str]:
        return [o.op for o in self.ops]

    def stages(self) -> List[str]:
        seen: List[str] = []
        for o in self.ops:
            if o.stage not in seen:
                seen.append(o.stage)
        return seen

    def hbm_bytes(self) -> float:
        return sum(o.bytes for o in self.ops if o.engine == "hbm")

    def to_json(self) -> str:
        return json.dumps({"meta": self.meta,
                           "ops": [o.to_dict() for o in self.ops]})

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        d = json.loads(s)
        return cls(ops=[TraceOp.from_dict(o) for o in d["ops"]],
                   meta=d.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())


class Tracer:
    """Mutable op-stream collector installed via ``activate``."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None):
        self.ops: List[TraceOp] = []
        self.meta: Dict[str, Any] = dict(meta or {})
        self._suppress = 0

    def emit(self, op: str, shape: Sequence[int] = (), fmt: str = "none",
             stage: str = "sampling", note: str = "") -> None:
        if self._suppress:
            return
        if op not in isa.ISA:
            raise ValueError(f"unknown trace op {op!r}")
        self.ops.append(TraceOp(op=op, shape=tuple(int(s) for s in shape),
                                fmt=fmt, stage=stage, note=note))

    def finish(self) -> Trace:
        return Trace(ops=list(self.ops), meta=dict(self.meta))


# ---------------------------------------------------------------------------
# Active-tracer plumbing (module-level so the tick needs no threading)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None


def is_active() -> bool:
    return _ACTIVE is not None and not _ACTIVE._suppress


@contextlib.contextmanager
def activate(tracer: Optional[Tracer]):
    """Install ``tracer`` as the emission target (no-op for ``None``)."""
    global _ACTIVE
    if tracer is None:
        yield
        return
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def suppress():
    """Silence emissions: wrap a loop whose body holds hooks when the
    caller has emitted the loop's per-iteration op groups itself."""
    if _ACTIVE is None:
        yield
        return
    _ACTIVE._suppress += 1
    try:
        yield
    finally:
        _ACTIVE._suppress -= 1


def emit(op: str, shape: Sequence[int] = (), fmt: str = "none",
         stage: str = "sampling", note: str = "") -> None:
    if _ACTIVE is not None:
        _ACTIVE.emit(op, shape, fmt, stage, note)


# ---------------------------------------------------------------------------
# Shared emission patterns referenced from more than one call site
# ---------------------------------------------------------------------------


def emit_combine(rows: int, stage: str = "combine") -> None:
    """The vocab-sharded Stable-Max combine: one pmax + psum + pmin of
    per-row (m, S, idx) partials, then the reciprocal.  Used by
    ``capture_sampling_trace(head_path='sharded')`` for the per-chip view
    and by ``sampling.combine_partials``, the in-mesh combine itself."""
    emit("COLL_PMAX", (rows,), "fp32", stage, note="m")
    emit("COLL_PSUM", (rows,), "fp32", stage, note="s_rescaled")
    emit("COLL_PMIN", (rows,), "int32", stage, note="argmax_tiebreak")
    emit("S_RECIP", (rows,), stage=stage)


def emit_legacy_head(rows: int, d: int, V: int, stage: str = "head") -> None:
    """The legacy full-logits LM head: GEMM over ``rows`` (= B*S for the
    pre-fusion serving tick) with the (rows, V) bf16 logits written back to
    HBM.  Called from ``core.diffusion.tick_forward`` for models on the
    legacy head path, and by ``capture_sampling_trace('legacy')``."""
    emit("HBM_RD", (rows, d), "bf16", stage, note="hidden")
    emit("HBM_RD", (d, V), "mxint4", stage, note="head_w")
    emit("GEMM_TILE", (rows, d, V), stage=stage)
    emit("HBM_WR", (rows, V), "bf16", stage, note="logits")


# ---------------------------------------------------------------------------
# Capture entry points
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    import torch
    return torch.empty(shape, dtype=dtype, device="meta")


def capture_sampling_trace(*, B: int, L: int, V: int, d: int,
                           fmt: str = "mxfp8_e4m3",
                           head_path: str = "fused",
                           chunk_v: int = 4096,
                           model_shards: int = 1,
                           data_shards: int = 1,
                           seq_len: Optional[int] = None,
                           temperature: float = 0.0,
                           mask_id: int = 0,
                           logit_scale: float = 1.0) -> Trace:
    """Record the sampling-stage op stream for one engine tick by running
    the port's sampling functions on meta tensors.

    head_path: 'fused' (streamed head + Stable-Max), 'unfused'
    (block-sliced head then Stable-Max), 'legacy' (full-sequence logits;
    needs ``seq_len``), 'sharded' (per-chip view of the SPMD tick over
    ``model_shards`` x ``data_shards``: the padded head shard's streamed
    partials, the combine op group, the transfer-selection tail), or
    'engine' (the bare sampling engine over pre-materialized (B, L, V)
    logits, no head -- the paper's Table 4 cross-validation block).
    """
    import torch

    from repro_torch.core import sampling as sampling_lib

    if head_path not in ("fused", "unfused", "legacy", "sharded", "engine"):
        raise ValueError(f"unknown head_path {head_path!r}")
    if head_path == "legacy" and seq_len is None:
        raise ValueError("head_path='legacy' needs seq_len (the full-"
                         "sequence rows the pre-fusion head materializes)")

    cfg = sampling_lib.SamplingConfig(fmt=fmt, temperature=temperature)
    tracer = Tracer(meta={
        "kind": "sampling", "B": B, "L": L, "V": V, "d": d, "fmt": fmt,
        "head_path": head_path, "chunk_v": chunk_v,
        "model_shards": model_shards, "data_shards": data_shards,
        "seq_len": seq_len, "temperature": temperature})
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    # JAX passes a key only at temperature > 0; any seed stands for it
    seed = 0 if temperature > 0.0 else None

    if head_path == "sharded":
        B_loc = -(-B // data_shards)
        w_pad = sampling_lib.pad_head_for_mesh(_meta((d, V), f32),
                                               model_shards)
        vloc = w_pad.shape[-1] // model_shards
        R_loc = B_loc * L
        with activate(tracer):
            sampling_lib.fused_head_local_partials(
                _meta((R_loc, d), bf16), _meta((d, vloc), f32), fmt,
                logit_scale=logit_scale, col_offset=0, suppress_id=mask_id,
                chunk_v=chunk_v, col_limit=V)
            emit_combine(R_loc)
            emit("S_ST", (2 * R_loc,), stage="tail", note="conf_idx_wb")
            sampling_lib._select_and_commit(
                _meta((B_loc, L), f32), _meta((B_loc, L), i32),
                _meta((B_loc, L), i32), _meta((B_loc, L), torch.bool),
                _meta((B_loc,), i32), cfg, None)
        return tracer.finish()

    x, k = _meta((B, L), i32), _meta((B,), i32)
    with activate(tracer):
        if head_path == "fused":
            sampling_lib.fused_sampling_step_full(
                _meta((B, L, d), bf16), _meta((d, V), f32), x, mask_id, k,
                cfg, seed, logit_scale=logit_scale, chunk_v=chunk_v)
        elif head_path == "unfused":
            logits = sampling_lib.head_logits(
                _meta((B, L, d), bf16), _meta((d, V), f32),
                logit_scale=logit_scale)
            sampling_lib.sampling_step_full(logits, x, mask_id, k, cfg, seed)
        else:   # legacy / engine: logits pre-materialized by the forward
            if head_path == "legacy":
                emit_legacy_head(B * seq_len, d, V)
            sampling_lib.sampling_step_full(_meta((B, L, V), bf16), x,
                                            mask_id, k, cfg, seed)
    return tracer.finish()


def capture_tick_trace(model, dcfg, mask_id: Optional[int] = None, *,
                       B: int, s_tot: int, mesh=None, quant=None) -> Trace:
    """Record one full serving-tick op stream (forward marker + sampling)
    from the port's ``core.diffusion.batched_tick`` on meta tensors.  The
    parameters and cache are shape-only (the model rebuilt on ``meta``:
    ``init`` and ``init_cache`` allocate nothing), so this works at full
    llada-8b width on any host.  With ``mesh`` (a launch/mesh.Mesh, or
    any mesh whose ``axis_names`` and ``shape`` hold 'data' and 'model';
    only its shape is read) it records
    the SPMD tick as one chip runs it, as JAX's capture inside shard_map
    does: B/n_data rows through the forward, this chip's
    (d, V_pad/n_model) head shard through the streamed partials, the
    combine's ``emit_combine`` inside ``sampling.combine_partials``, then
    the top-k and commit of its rows; no collective runs (meta tensors)."""
    import torch

    from repro_torch.core import diffusion
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.registry import build_model

    mask_id = model.cfg.mask_id if mask_id is None else mask_id
    shapes = build_model(model.cfg, device="meta")
    params = shapes.init()
    i32 = torch.int32
    tracer = Tracer(meta={
        "kind": "tick", "B": B, "s_tot": s_tot, "L": dcfg.block_length,
        "V": int(model.cfg.vocab), "d": int(model.cfg.d_model),
        "head_path": dcfg.head_path, "cache_mode": dcfg.cache_mode,
        "fmt": dcfg.sampling.fmt,
        "mesh": dict(mesh.shape) if mesh is not None else None})
    x = _meta((B, s_tot), i32)
    kv_valid = _meta((B, s_tot), torch.bool)
    block_start, k = _meta((B,), i32), _meta((B,), i32)
    if mesh is None:
        cache = (shapes.init_cache(B, s_tot)
                 if dcfg.cache_mode != "none" else None)
        # JAX always passes a key here: the tick seed stands for it
        diffusion.batched_tick(
            shapes, params, x, kv_valid, block_start, k, 0, cache, dcfg,
            mask_id, quant=quant, tracer=tracer)
        return tracer.finish()
    names = tuple(getattr(mesh, "axis_names", ()))
    if any(ax not in names for ax in mesh_lib.AXES):
        raise ValueError(f"SPMD tick needs mesh axes ('data', 'model'); "
                         f"got {names}")
    view = mesh_lib.shape_mesh(mesh.shape["data"], mesh.shape["model"])
    r0, r1 = view.rows(B)
    cache = (shapes.init_cache(r1 - r0, s_tot)
             if dcfg.cache_mode != "none" else None)
    tick = diffusion.get_spmd_tick_fn(shapes, dcfg, mask_id, view,
                                      jit_steps=False, quant=quant)
    with activate(tracer):
        tick(diffusion.place_spmd_params(params, view), x, kv_valid,
             block_start, k, 0, cache)
    return tracer.finish()
