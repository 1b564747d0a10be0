"""Blocked diffusion inference, ported from src/repro/core/diffusion.py.

Generation proceeds block by block over N_B blocks of length L.  Per
cache mode:

  * "none": every step is one batched tick, a full-sequence recompute;
  * "dual" / "prefix": each block begins with a **warm step** (a
    full-sequence forward that rewrites the whole KV cache and, with BAOS,
    recalibrates it), then T - 1 **refine steps** over the active block
    (dual: the suffix KV stays frozen from the warm step) or over the block
    and its suffix (prefix: the suffix KV is recomputed every step).

``batched_tick`` is one engine tick: ``tick_forward`` (the model's
forward over the canvas, with or without the warm KV cache) and
``tick_sample`` (each row's active block sliced, the head path, the top-k
transfer mask and the commit).  The
head path (``head_feed_mode``): "fused" streams hidden states through the
fused LM head + Stable-Max kernel; "unfused" applies the head to the
(B, L, d) slice and runs Stable-Max on the stored block logits; "legacy"
takes full-sequence logits out of the forward and slices them.

Randomness is an explicit uint32 seed: step t of a stream seeded s draws
its counter-Gumbel noise from ``tick_seed(s, t)``, so a saved state
resumes bit for bit.  Greedy decoding (temperature 0, the default) draws
nothing.  ``tick_seed`` also takes a device tick counter and gives the
seed as a device tensor, which the sampling kernels read from memory.

``get_tick_fn`` is the engine's tick, a CUDA graph on the card with
``jit_steps`` (core/graphs.py, the counterpart of ``jax.jit``);
``get_tick_stage_fns`` the same tick as two calls, forward and sampling
(the engine's breakdown mode); ``get_megatick_fn`` the JAX megatick: up
to K ticks with each row's block/step/k bookkeeping on the device and one
host sync per megastep.
``step``/``generate`` with ``jit_steps`` run each step as CUDA graphs too:
``step_graphs`` keeps, per (model, dcfg, mask id, quant, batch, canvas
length), the graphed steps and the static buffers they read (the
counterpart of JAX's lru-cached ``_cached_step_fn``/``_cached_commit_fn``
compiles), so a second ``generate`` of the same shapes captures nothing.
``get_paged_tick_fn`` and ``PagedMegatick`` are the tick and the megastep
on the paged pool: gather the pages into dense views, the unchanged tick
body (over a mesh the SPMD one), scatter back.  ``get_spmd_tick_fn`` is the tick over a (data, model)
mesh (launch/mesh.py): each rank's rows, the LM head's columns sharded
over ``model`` and merged by ``sampling.combine_partials``, the outputs
gathered over ``data``; ``step``, ``generate``, the megatick and the
engine take it through ``mesh=``.

``**fwd_kw`` takes ``quant``, a ``models/layers.QuantPolicy`` (the MX
fake-quant at every GEMM boundary and on both operands of the LM head),
bound into the steps as JAX binds it statically, and the forward's
tensor inputs ``FWD_TENSORS``: ``cross_kv`` (the audio family's encoder
K/V) and ``image_embeds`` (the vlm family's image), which every forward
of a step reads, the refine steps' too.  A captured graph reads them in
place as static buffers, keyed by address (core/graphs.py), so new
tensors capture anew and never replay a stale graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import baos as baos_lib
from repro_torch.core import graphs
from repro_torch.core import sampling as sampling_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.sim import trace as trace_lib

CACHE_MODES = ("none", "dual", "prefix")
HEAD_PATHS = ("fused", "unfused", "legacy")
# forward kwargs beside quant: tensors every forward of a step reads
FWD_TENSORS = ("cross_kv", "image_embeds")


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """The JAX DiffusionConfig's fields that the port runs.  ``cache_mode``
    defaults to 'none' here (the JAX default is 'dual')."""
    gen_length: int = 128
    block_length: int = 32
    steps_per_block: int = 8
    cache_mode: str = "none"          # none | prefix | dual
    head_path: str = "fused"          # fused | unfused | legacy
    head_chunk: int = 4096            # vocab chunk of the fused stream's
    #                                   plain version and of its trace
    sampling: sampling_lib.SamplingConfig = sampling_lib.SamplingConfig()
    baos: baos_lib.BAOSConfig = baos_lib.BAOSConfig(enabled=False)

    @property
    def num_blocks(self) -> int:
        if self.gen_length % self.block_length:
            raise ValueError(
                f"gen_length {self.gen_length} must be a multiple of "
                f"block_length {self.block_length}")
        return self.gen_length // self.block_length


def check_supported(dcfg: DiffusionConfig) -> None:
    """Raise for options that are unknown (ValueError) or that the port
    lacks (NotImplementedError, pointing at ROADMAP.md)."""
    if dcfg.cache_mode not in CACHE_MODES:
        raise ValueError(f"unknown cache_mode {dcfg.cache_mode!r}")
    if dcfg.head_path not in HEAD_PATHS:
        raise ValueError(f"unknown head_path {dcfg.head_path!r}")
    sampling_lib.check_supported(dcfg.sampling)
    baos_lib.check_supported(dcfg.baos)


def head_feed_mode(model, dcfg: DiffusionConfig) -> str:
    """The sampling stage's feed for ``model``: 'fused'/'unfused' (active
    blocks sliced at the hidden level, the head applied after) or 'logits'
    (the legacy full-logits forward, also for models without head_mode)."""
    if dcfg.head_path not in HEAD_PATHS:
        raise ValueError(f"unknown head_path {dcfg.head_path!r}")
    if dcfg.head_path != "legacy" and getattr(model, "supports_head_mode",
                                              False):
        return dcfg.head_path
    return "logits"


def _forward_head_mode(model, dcfg: DiffusionConfig) -> str:
    return "logits" if head_feed_mode(model, dcfg) == "logits" else "hidden"


def tick_seed(seed: sampling_lib.Seed, tick):
    """uint32 counter-Gumbel seed of tick ``tick`` of a stream seeded
    ``seed``: _mix32(seed ^ tick * 0x9E3779B9).  With ints an int; with a
    tensor tick (or seed), the same bits computed where the tensor lies, as
    a one-element int64 tensor (``sampling.Seed``): the form a captured
    graph computes on the device from a device tick counter."""
    mask = sampling_lib.MASK32
    if not isinstance(tick, torch.Tensor) and \
            not isinstance(seed, torch.Tensor):
        x = (int(seed) ^ (int(tick) * 0x9E3779B9)) & mask
        return int(sampling_lib._mix32(torch.tensor(x)))
    t = torch.as_tensor(tick).to(torch.int64).reshape(1) & mask
    x = sampling_lib._seed_bits(seed) ^ sampling_lib._mul32(t, 0x9E3779B9)
    return sampling_lib._mix32(x)


def _active_mask(batch: int, s_tot: int, block_start, block_len: int,
                 device) -> torch.Tensor:
    """(batch, s_tot) bool: positions in [block_start, block_start + L);
    ``block_start`` an int or a (batch,) tensor."""
    pos = torch.arange(s_tot, device=device)[None, :]
    bs = torch.as_tensor(block_start, device=device).reshape(-1, 1)
    return ((pos >= bs) & (pos < bs + block_len)).expand(batch, s_tot)


def _active_sampling_step(feats: torch.Tensor, xa: torch.Tensor,
                          k: torch.Tensor, seed, params: Dict,
                          mode: str, dcfg: DiffusionConfig, mask_id: int,
                          model, quant=None, axis=None):
    """Route one active block through the head path.  feats is (B, L, V)
    block logits (mode 'logits') or (B, L, d) hidden states (modes 'fused'
    and 'unfused').  Returns (new tokens, transfer, conf), each (B, L).

    With ``axis`` (a launch/mesh.Axis, JAX's ``axis_name`` inside
    shard_map) ``params['lm_head']`` is this rank's (d, V/n) column shard
    (``place_spmd_params``): the partials merge over the axis and
    ``col_limit`` masks the head's zero-pad columns."""
    if mode == "logits":
        return sampling_lib.sampling_step_full(feats, xa, mask_id, k,
                                               dcfg.sampling, seed)
    scale = float(model.cfg.logit_scale)
    if axis is not None:
        if mode != "fused":
            raise ValueError("the SPMD tick requires head_path='fused'")
        return sampling_lib.sharded_fused_sampling_step_full(
            feats, params["lm_head"], xa, mask_id, k, dcfg.sampling, seed,
            axis=axis, logit_scale=scale, quant=quant,
            chunk_v=dcfg.head_chunk, col_limit=int(model.cfg.vocab))
    if mode == "fused":
        return sampling_lib.fused_sampling_step_full(
            feats, params["lm_head"], xa, mask_id, k, dcfg.sampling, seed,
            logit_scale=scale, quant=quant, chunk_v=dcfg.head_chunk)
    # unfused: the head after the (B, L, d) slice, so at most (B, L, V)
    # block logits exist; JAX computes this product outside any Pallas
    # kernel, so it stays on torch.matmul
    logits = sampling_lib.head_logits(feats, params["lm_head"],
                                      logit_scale=scale, quant=quant)
    return sampling_lib.sampling_step_full(logits, xa, mask_id, k,
                                           dcfg.sampling, seed)


# ---------------------------------------------------------------------------
# Warm and refine steps (cache modes dual and prefix)
# ---------------------------------------------------------------------------

def warm_step(model, params, x: torch.Tensor, cache: Dict, block_start,
              dcfg: DiffusionConfig, head_mode: str = "logits", quant=None,
              **fwd_kw):
    """Full-sequence forward that rewrites the whole cache (and, with BAOS,
    recalibrates it).  Returns (active-block logits, or with
    ``head_mode='hidden'`` hidden states (B, L, d); the cache).
    ``block_start`` is an int, or a one-element device tensor (a graph's
    block start)."""
    B, s_tot = x.shape
    L = dcfg.block_length
    calib_mask = (_active_mask(B, s_tot, block_start, L, x.device)
                  if dcfg.baos.calib_scope == "active_block" else None)
    return model.forward(params, x, cache=cache, seg_start=0,
                         baos_cfg=dcfg.baos, calibrate=True,
                         calib_mask=calib_mask,
                         logits_slice=(block_start, L), head_mode=head_mode,
                         quant=quant, **fwd_kw)


def refine_step(model, params, x: torch.Tensor, cache: Dict,
                block_start, dcfg: DiffusionConfig, suffix_len: int = 0,
                head_mode: str = "logits", quant=None, **fwd_kw):
    """One refinement forward over the segment x[block_start:
    block_start + L + suffix_len] (dual: suffix_len 0; prefix: the whole
    suffix), its K/V written into the cache in place, the stored
    calibration read.  Returns (active-block feats, the cache).
    ``block_start`` is an int, or a one-element device tensor."""
    L = dcfg.block_length
    if isinstance(block_start, torch.Tensor):
        cols = block_start.reshape(()).to(torch.int64) + torch.arange(
            L + suffix_len, device=x.device)
        seg = x.index_select(1, cols)
    else:
        seg = x[:, block_start:block_start + L + suffix_len]
    return model.forward(params, seg, cache=cache, seg_start=block_start,
                         baos_cfg=dcfg.baos, calibrate=False,
                         logits_slice=(0, L), head_mode=head_mode,
                         quant=quant, **fwd_kw)


# ---------------------------------------------------------------------------
# Batched serving tick
# ---------------------------------------------------------------------------

def tick_forward(model, params, x: torch.Tensor,
                 kv_valid: Optional[torch.Tensor], block_start: torch.Tensor,
                 cache, dcfg: DiffusionConfig, quant=None, **fwd_kw):
    """Forward half of a tick: full-sequence hidden states (B, S, d), or
    full-sequence logits (B, S, V) on the legacy head path.  Without
    ``cache`` this is the full recompute (cache_mode 'none'; like the JAX
    forward it attends over all positions and ignores kv_valid); with it, a
    warm step per tick that rewrites every K/V of the cache in place
    (calibrated and MX-quantized with ``dcfg.baos`` on, over the rows'
    active blocks with calib_scope 'active_block') and attends through
    kv_valid.  An active tracer (sim/trace.py) records the forward as one
    XU_FORWARD marker and, on the legacy path, the full-sequence head the
    forward pays, as JAX's does."""
    check_supported(dcfg)
    head_mode = _forward_head_mode(model, dcfg)
    if trace_lib.is_active():
        B, s_tot = x.shape
        d = int(model.cfg.d_model)
        trace_lib.emit("XU_FORWARD", (B, s_tot, d), stage="forward",
                       note=f"cache={cache is not None}")
        if head_mode == "logits":
            trace_lib.emit_legacy_head(B * s_tot, d, int(model.cfg.vocab))
    if cache is None:
        return model.forward(params, x, kv_valid=kv_valid,
                             head_mode=head_mode, quant=quant, **fwd_kw)
    B, s_tot = x.shape
    calib_mask = None
    if dcfg.baos.calib_scope == "active_block":
        calib_mask = _active_mask(B, s_tot, block_start, dcfg.block_length,
                                  x.device)
    return model.forward(params, x, cache=cache, seg_start=0,
                         kv_valid=kv_valid, baos_cfg=dcfg.baos,
                         calibrate=True, calib_mask=calib_mask,
                         head_mode=head_mode, quant=quant, **fwd_kw)


def tick_sample(params, feats: torch.Tensor, x: torch.Tensor,
                block_start: torch.Tensor, k: torch.Tensor, seed,
                dcfg: DiffusionConfig, mask_id: int, model, quant=None,
                axis=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sampling half of a tick: each row's active block sliced out of the
    full-sequence feats ((B, L, d) hidden states, or (B, L, V) logits on
    the legacy path), the head path, top-k and commit of k tokens per row
    (k = 0 rows are no-ops), scattered back into the canvas.

    Returns (x_new, conf_min, masks_left): conf_min is the minimum
    confidence over the tokens committed this tick (+inf when none, the
    SlowFast signal), masks_left the masked positions left in each row's
    active block.  ``axis``: the vocab-sharded head of the SPMD tick
    (``_active_sampling_step``)."""
    L = dcfg.block_length
    B, S = x.shape
    # the JAX dynamic_slice clamps a start so the block fits; so does this
    start = torch.clamp(block_start.to(torch.int64), 0, S - L)
    cols = start[:, None] + torch.arange(L, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None]
    xa_new, transfer, conf = _active_sampling_step(
        feats[rows, cols], x[rows, cols], k, seed, params,
        head_feed_mode(model, dcfg), dcfg, mask_id, model, quant, axis)
    x_new = x.clone()
    x_new[rows, cols] = xa_new
    conf_min = torch.amin(torch.where(transfer, conf, float("inf")), dim=-1)
    masks_left = torch.sum(xa_new == mask_id, dim=-1).to(torch.int32)
    return x_new, conf_min, masks_left


def batched_tick(model, params, x: torch.Tensor,
                 kv_valid: Optional[torch.Tensor], block_start: torch.Tensor,
                 k: torch.Tensor, seed, cache, dcfg: DiffusionConfig,
                 mask_id: int, quant=None, tracer=None, axis=None,
                 **fwd_kw):
    """One engine tick over all serving slots: one forward, one sampling
    call.  Also the cache_mode='none' step of ``generate`` (block_start
    broadcast), so a one-slot engine runs exactly what generate runs.
    Returns (x_new, cache, conf_min, masks_left).

    ``tracer`` (a sim/trace.Tracer) records the tick's instruction stream
    for the cycle simulator.  Pass it only on eager calls (on meta tensors,
    sim/trace.capture_tick_trace, or on the card): a replayed CUDA graph
    runs no Python and would record nothing, so no graphed tick takes
    one.  ``axis``: the model axis of the SPMD tick (the head sharded
    over it, ``get_spmd_tick_fn``)."""
    with trace_lib.activate(tracer):
        feats, cache = tick_forward(model, params, x, kv_valid, block_start,
                                    cache, dcfg, quant, **fwd_kw)
        x_new, conf_min, masks_left = tick_sample(
            params, feats, x, block_start, k, seed, dcfg, mask_id, model,
            quant, axis)
    return x_new, cache, conf_min, masks_left


def get_tick_fn(model, dcfg: DiffusionConfig, mask_id: int,
                jit_steps: bool = True, quant=None, pool=None):
    """``batched_tick`` as ``tick(params, x, kv_valid, block_start, k,
    seed, cache=None, **fwd_kw) -> (x_new, cache, conf_min, masks_left)``,
    the JAX ``get_tick_fn`` (``fwd_kw``: ``FWD_TENSORS``).  With
    ``jit_steps`` and CUDA tensors it replays a CUDA graph
    (core/graphs.py, in memory ``pool``), the counterpart of ``jax.jit``:
    its tensor arguments are then its static buffers, read by address
    (``seed`` a ``sampling.Seed`` tensor, or it is baked in), and
    its outputs live until the next call.  Without, or on the CPU, the tick
    runs eagerly.  Each call makes a new tick: a graph holds the buffers it
    was captured on, so each engine, and each ``step_graphs`` entry, owns
    its own (JAX shares compiles, which hold no buffers)."""
    def tick(params, x, kv_valid, block_start, k, seed, cache=None,
             **fwd_kw):
        return batched_tick(model, params, x, kv_valid, block_start, k, seed,
                            cache, dcfg, mask_id, quant, **fwd_kw)

    return graphs.GraphedStep(tick, pool) if jit_steps else tick


def get_tick_stage_fns(model, dcfg: DiffusionConfig, mask_id: int,
                       jit_steps: bool = True, quant=None):
    """``(forward, sampling)``: the tick's two halves as separate calls,
    the engine's per-stage breakdown mode (the paper's Fig. 1 split), the
    JAX ``get_tick_stage_fns``.  ``forward(params, x, kv_valid,
    block_start, cache=None, **fwd_kw) -> (feats, cache)`` and
    ``sampling(params, feats, x, block_start, k, seed) -> (x_new,
    conf_min, masks_left)``;
    the math is ``batched_tick``'s.  The sampling stage owns the LM head
    (``feats`` are hidden states on the fused and unfused paths); on the
    legacy path the forward returns the full-sequence logits, so the head
    product is charged to the forward, as in JAX.

    With ``jit_steps`` and CUDA tensors each stage is a CUDA graph
    (core/graphs.py), both in one memory pool: the sampling graph reads
    the forward graph's ``feats`` output by address, so each captures
    once.  Without, or on the CPU, the stages run eagerly."""
    def forward(params, x, kv_valid, block_start, cache=None, **fwd_kw):
        return tick_forward(model, params, x, kv_valid, block_start, cache,
                            dcfg, quant, **fwd_kw)

    def sampling(params, feats, x, block_start, k, seed):
        return tick_sample(params, feats, x, block_start, k, seed, dcfg,
                           mask_id, model, quant)

    if not jit_steps:
        return forward, sampling
    pool = torch.cuda.graph_pool_handle() if torch.cuda.is_available() \
        else None
    return graphs.GraphedStep(forward, pool), graphs.GraphedStep(sampling,
                                                                 pool)


# ---------------------------------------------------------------------------
# The SPMD tick over a (data, model) mesh (launch/mesh.py)
# ---------------------------------------------------------------------------

class SpmdParams(dict):
    """Parameters placed for one mesh (``place_spmd_params``)."""
    mesh = None


def place_spmd_params(params: Dict, mesh) -> Dict:
    """This rank's parameters for the SPMD tick, placed once: the LM head
    zero-padded to MX-block-aligned shard boundaries
    (``sampling.pad_head_for_mesh``) and cut to this rank's column shard
    along ``model``, stored contiguously (16-byte rows: its width is a
    multiple of 32); every other leaf replicated (this rank's own
    tensors, shared with ``params``).  Parameters already placed for
    ``mesh`` pass through, as JAX's placement is a no-op on them."""
    if "model" not in getattr(mesh, "axis_names", ()):
        raise ValueError(f"SPMD params need a mesh with a 'model' axis; "
                         f"got {getattr(mesh, 'axis_names', None)}")
    if isinstance(params, SpmdParams) and params.mesh is mesh:
        return params
    n = mesh.shape["model"]
    w = sampling_lib.pad_head_for_mesh(params["lm_head"], n)
    vloc = w.shape[-1] // n
    m = mesh.axis("model").index
    out = SpmdParams(params)
    out["lm_head"] = w[:, m * vloc:(m + 1) * vloc].contiguous()
    out.mesh = mesh
    return out


def check_spmd(model, dcfg: DiffusionConfig, mesh, jit_steps: bool) -> None:
    """The SPMD tick's refusals, JAX's in type and meaning, then the
    port's one: a graphed step (``jit_steps`` on the card) over a mesh
    whose collectives a CUDA graph cannot capture (gloo)."""
    from repro_torch.launch import mesh as mesh_lib
    names = tuple(getattr(mesh, "axis_names", ()))
    for ax in mesh_lib.AXES:
        if ax not in names:
            raise ValueError(f"SPMD tick needs mesh axes ('data', 'model'); "
                             f"got {names}")
    if not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"mesh {mesh!r} is not a launch/mesh.Mesh")
    check_supported(dcfg)
    if head_feed_mode(model, dcfg) != "fused":
        raise ValueError(
            "the SPMD tick requires head_path='fused' and a "
            "head-mode-capable model (supports_head_mode)")
    if dcfg.sampling.temperature > 0.0 or dcfg.sampling.strategy == "random":
        raise NotImplementedError(
            "SPMD tick supports greedy Stable-Max decoding only "
            "(temperature == 0, strategy='stablemax'), as JAX's SPMD tick "
            "does; the decode step (launch/steps.build_serve_step) samples "
            "on any mesh")
    if jit_steps and mesh.device.type == "cuda" and not mesh.capturable:
        raise ValueError(
            f"jit_steps=True captures the SPMD tick in a CUDA graph, and "
            f"the {mesh.backend} collectives of {mesh!r} cannot be "
            f"captured: pass jit_steps=False")


def get_spmd_tick_fn(model, dcfg: DiffusionConfig, mask_id: int, mesh,
                     jit_steps: bool = True, quant=None, pool=None):
    """``batched_tick`` over a (data, model) mesh, the JAX
    ``get_spmd_tick_fn``: ``tick(params, x, kv_valid, block_start, k,
    seed, cache=None) -> (x_new, cache, conf_min, masks_left)``.  ``x``,
    ``kv_valid``, ``block_start`` and ``k`` are the whole batch, as a JAX
    host holds them; ``params`` come from ``place_spmd_params``;
    ``cache`` holds this rank's rows only.  The data axis shards the rows
    (each rank's forward sees its B/n_data rows), the model axis the LM
    head's columns: each rank streams its (d, V/n_model) shard through
    the fused head's shard entry (route A) and the per-row (m, idx, s)
    partials merge over ``model`` (``sampling.combine_partials``); the
    top-k and commit follow on each rank's rows.  The port is
    multi-controller, so the outputs are then gathered over ``data``: every
    rank's host sees the whole ``x_new``, ``conf_min`` and ``masks_left``,
    as JAX's one host does from its out_specs.

    Greedy tokens equal the single-device fused tick's: the shards fall
    on MX-block boundaries, and the combine's lowest-index tie rule is the
    fused head's first-column rule.  With ``jit_steps`` on the card the
    tick, collectives included, is a CUDA graph (NCCL only)."""
    check_spmd(model, dcfg, mesh, jit_steps)
    from repro_torch.launch import mesh as mesh_lib
    n_model, data, axis = (mesh.shape["model"], mesh.axis("data"),
                           mesh.axis("model"))
    vpad = -(-int(model.cfg.vocab) // (n_model * 32)) * n_model * 32

    def tick(params, x, kv_valid, block_start, k, seed, cache=None):
        if params["lm_head"].shape[-1] * n_model != vpad:
            raise ValueError(
                f"lm_head {tuple(params['lm_head'].shape)} is not a "
                f"{n_model}-way shard of the padded head: place the params "
                f"with place_spmd_params")
        r0, r1 = mesh.rows(x.shape[0])
        x_new, cache, conf_min, masks_left = batched_tick(
            model, params, x[r0:r1],
            None if kv_valid is None else kv_valid[r0:r1],
            block_start[r0:r1], k[r0:r1], seed, cache, dcfg, mask_id, quant,
            axis=axis)
        return (mesh_lib.all_gather_rows(x_new, data), cache,
                mesh_lib.all_gather_rows(conf_min, data),
                mesh_lib.all_gather_rows(masks_left, data))

    return graphs.GraphedStep(tick, pool) if jit_steps else tick


# ---------------------------------------------------------------------------
# Device-resident megatick: K ticks with the per-row scheduler state on the
# device and one host sync per megastep (the JAX get_megatick_fn)
# ---------------------------------------------------------------------------

def megatick_state(prompt_len, gen_blocks, dcfg: DiffusionConfig,
                   block_idx=None, step_in_block=None, block_masks_left=None,
                   last_conf=None, active=None, device=None) -> Dict:
    """Per-row state carried through a megatick, a dict of (B,) tensors on
    ``device`` (default: prompt_len's, or the CPU) with the JAX defaults:
    ``prompt_len``/``gen_blocks`` per row, the rest block 0, step 0, a full
    block of masks, last confidence -inf, every row active."""
    if device is None:
        device = (prompt_len.device if isinstance(prompt_len, torch.Tensor)
                  else "cpu")
    pl = torch.as_tensor(prompt_len).to(device=device, dtype=torch.int32)
    B = pl.shape[0]

    def vec(v, dtype, fill=None):
        if v is None:
            return torch.full((B,), fill, dtype=dtype, device=device)
        return torch.as_tensor(v).to(device=device, dtype=dtype)

    return {"prompt_len": pl,
            "gen_blocks": vec(gen_blocks, torch.int32),
            "block_idx": vec(block_idx, torch.int32, 0),
            "step_in_block": vec(step_in_block, torch.int32, 0),
            "block_masks_left": vec(block_masks_left, torch.int32,
                                    dcfg.block_length),
            "last_conf": vec(last_conf, torch.float32, float("-inf")),
            "active": vec(active, torch.bool, True)}


class Megatick:
    """The megastep of ``get_megatick_fn``.  A call runs up to
    ``k_req <= k_max`` serving ticks over the canvas ``x`` (and the warm
    ``cache``), both updated in place and returned (the port's counterpart
    of JAX's donation), with each row's block/step/k bookkeeping and the
    SlowFast early exit on the device.  Each tick appends one record to
    the ``(k_max, ...)`` buffers (post-tick active-block tokens ``xa``,
    ``block_start``, ``block_idx``, ``step_in_block``, ``masks_left``,
    ``k``, min committed ``conf``, ``active``, ``released``, ``early``;
    rows past ``n`` are zero).  The loop stops when every row has
    released, or with ``stop_on_release`` when any row releases, or after
    k_req ticks.  Tick j draws its noise from ``tick_seed(seed, tick + j)``.

    Returns ``(x, cache, tick + n, state, buffers, n)``; ``state`` and
    ``buffers`` are this object's device tensors, valid until the next
    call.

    JAX runs the loop as a ``lax.while_loop`` on the device.  Here every
    tick is one predicated step: it reads ``i``, ``k_req`` and the stop
    flag from device memory, and once the loop has stopped it commits
    nothing (every row gets k = 0) and changes no canvas, state, counter or
    buffer; in warm mode it rewrites the K/V from the unchanged canvas, as
    every tick does before it reads them.  With ``jit_steps`` on the card
    the step is a CUDA graph (core/graphs.py) replayed back to back: before
    it enqueues tick j + 1 the host waits for tick j - 1 and reads its stop
    flag (copied to pinned memory), so one tick is in flight while the host
    decides, and at most one tick runs after the stop.  ``ticks_wasted``
    counts those and ``ticks_run`` every tick enqueued; ``host_waits``
    counts the host's waits that drain the device's queue (the final read
    of the tick count), ``event_waits`` those that leave a tick in flight.
    Eagerly (``jit_steps=False``, or on the CPU) the host reads the flag
    after each tick, a wait that drains the queue, and wastes no tick.

    With ``mesh`` (JAX's megatick inside one shard_map) each rank runs the
    loop on its rows of the whole batch it is given (``x``, ``kv_valid``
    and ``state``; ``cache`` holds its rows only), each tick the SPMD
    tick's body with the head sharded over ``model``, and the stop flag
    reduced over ``data`` (a psum in JAX), so every rank stops at the
    same tick.  After the megastep the canvas, state and buffers are
    gathered over ``data``: the outputs are the whole batch's, as JAX's
    out_specs give its one host."""

    def __init__(self, model, dcfg: DiffusionConfig, mask_id: int,
                 k_max: int, jit_steps: bool = True,
                 slowfast_threshold: Optional[float] = None, quant=None,
                 mesh=None):
        if k_max < 1:
            raise ValueError(f"megatick k_max must be >= 1, got {k_max}")
        check_supported(dcfg)
        if mesh is not None:
            # the SPMD tick's checks (mesh axes, fused greedy head, a
            # capturable mesh for graphs)
            check_spmd(model, dcfg, mesh, jit_steps)
        self.mesh = mesh
        self._axis = None if mesh is None else mesh.axis("model")
        self.model, self.dcfg, self.mask_id = model, dcfg, int(mask_id)
        self.quant = quant
        self.k_max = int(k_max)
        self.thr = (None if slowfast_threshold is None
                    else float(slowfast_threshold))
        self.jit_steps = jit_steps
        self._step = (graphs.GraphedStep(self._tick) if jit_steps
                      else self._tick)
        self._carry: Dict[Tuple, Dict] = {}
        self.ticks_run = 0
        self.ticks_wasted = 0
        self.host_waits = 0
        self.event_waits = 0

    def _carry_for(self, x: torch.Tensor) -> Dict:
        """The device buffers of one batch shape, made at its first call
        (a graph replays against fixed addresses)."""
        key = (tuple(x.shape), x.device)
        c = self._carry.get(key)
        if c is not None:
            return c
        B, dev = x.shape[0], x.device
        L, T, K = (self.dcfg.block_length, self.dcfg.steps_per_block,
                   self.k_max)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        bufs = {"xa": z((K, B, L), torch.int32)}
        for name in ("block_start", "block_idx", "step_in_block",
                     "masks_left", "k"):
            bufs[name] = z((K, B), torch.int32)
        bufs["conf"] = z((K, B), torch.float32)
        for name in ("active", "released", "early"):
            bufs[name] = z((K, B), torch.bool)
        c = {"scalars": {"i": z((1,), torch.int32),
                         "stop": z((1,), torch.bool),
                         "tick": z((1,), torch.int64),
                         "seed": z((1,), torch.int64),
                         "k_req": z((1,), torch.int32),
                         "stop_on_release": z((1,), torch.bool)},
             "state": megatick_state(z((B,), torch.int32),
                                     z((B,), torch.int32), self.dcfg,
                                     device=dev),
             "bufs": bufs,
             "ksched": schedule_lib.linear_unmask_schedule(L, T).to(
                 device=dev, dtype=torch.int32),
             "flag": torch.zeros((1,), dtype=torch.bool,
                                 pin_memory=dev.type == "cuda")}
        self._carry[key] = c
        return c

    def canvas(self, B: int, S: int, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """A static canvas (B, S) int32 and an all-valid kv_valid for
        ``generate``, made once per shape, so the graphs captured on them
        are replayed by every later call of that shape."""
        key = ("canvas", B, S, torch.device(device))
        c = self._carry.get(key)
        if c is None:
            c = self._carry[key] = (
                torch.zeros((B, S), dtype=torch.int32, device=device),
                torch.ones((B, S), dtype=torch.bool, device=device))
        return c

    def _tick(self, params, x, kv_valid, cache, sc, st, bufs, ksched):
        """One predicated tick, in place on device tensors."""
        L, T = self.dcfg.block_length, self.dcfg.steps_per_block
        S = x.shape[1]
        run = (sc["i"] < sc["k_req"]) & ~sc["stop"]          # (1,)
        bi, t = st["block_idx"], st["step_in_block"]
        bml, lc = st["block_masks_left"], st["last_conf"]
        act = st["active"] & run
        bs = torch.where(act, st["prompt_len"] + bi * L, 0)
        dk = torch.where(t < T, ksched[torch.clamp(t, 0, T - 1).long()], bml)
        if self.thr is not None:
            fire = (t > 0) & (bml > 0) & torch.isfinite(lc) & (lc >= self.thr)
            k = torch.where(fire, bml, dk)
            early = fire & (bml > dk)
        else:
            k, early = dk, torch.zeros_like(act)
        k = torch.where(act, torch.clamp(k, max=L), 0)
        seed = tick_seed(sc["seed"], sc["tick"])
        x_new, _, conf_min, masks_left = batched_tick(
            self.model, params, x, kv_valid, bs, k, seed, cache, self.dcfg,
            self.mask_id, self.quant, axis=self._axis)
        boundary = act & (masks_left == 0)
        released = boundary & (bi + 1 >= st["gen_blocks"])
        new = {"block_idx": torch.where(boundary, bi + 1, bi),
               "step_in_block": torch.where(
                   act, torch.where(boundary, 0, t + 1), t),
               "last_conf": torch.where(
                   act, torch.where(boundary, float("-inf"), conf_min), lc),
               "block_masks_left": torch.where(
                   act, torch.where(boundary, L, masks_left), bml),
               "active": st["active"] & ~released}
        start = torch.clamp(bs.to(torch.int64), 0, S - L)
        cols = start[:, None] + torch.arange(L, device=x.device)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        upd = {"xa": x_new[rows, cols], "block_start": bs, "block_idx": bi,
               "step_in_block": t, "conf": conf_min,
               "masks_left": torch.where(act, masks_left, 0), "k": k,
               "active": act, "released": released, "early": early}
        row = torch.clamp(sc["i"], max=self.k_max - 1).to(torch.int64)
        for name, buf in bufs.items():
            keep = buf.index_select(0, row)
            put = torch.where(run.reshape((1,) * buf.dim()),
                              upd[name].to(buf.dtype)[None], keep)
            buf.index_copy_(0, row, put)
        any_active, any_released = new["active"].any(), released.any()
        if self.mesh is not None:
            from repro_torch.launch import mesh as mesh_lib
            data = self.mesh.axis("data")
            any_active = mesh_lib.any_over(any_active, data)
            any_released = mesh_lib.any_over(any_released, data)
        stop = sc["stop"] | (run & (~any_active | (
            sc["stop_on_release"] & any_released)))
        for name, v in new.items():
            st[name].copy_(v)
        x.copy_(x_new)
        sc["stop"].copy_(stop)
        sc["i"].add_(run.to(torch.int32))
        sc["tick"].add_(run.to(torch.int64))

    def __call__(self, params, x: torch.Tensor, kv_valid, state: Dict,
                 tick: int, k_req: int, stop_on_release: bool,
                 cache: Optional[Dict] = None, seed: int = 0):
        if self.mesh is None:
            return self._run(params, x, kv_valid, state, tick, k_req,
                             stop_on_release, cache, seed)
        from repro_torch.launch import mesh as mesh_lib
        r0, r1 = self.mesh.rows(x.shape[0])
        key = ("rows", tuple(x.shape), x.device)
        if key not in self._carry:          # static: the graphs read them
            self._carry[key] = (torch.empty_like(x[r0:r1]),
                                torch.empty_like(kv_valid[r0:r1]))
        x_l, kv_l = self._carry[key]
        x_l.copy_(x[r0:r1])
        kv_l.copy_(kv_valid[r0:r1])
        x_l, cache, tick, st, bufs, n = self._run(
            params, x_l, kv_l, {name: t[r0:r1] for name, t in state.items()},
            tick, k_req, stop_on_release, cache, seed)
        data = self.mesh.axis("data")
        x.copy_(mesh_lib.all_gather_rows(x_l, data))
        st = {name: mesh_lib.all_gather_rows(t, data)
              for name, t in st.items()}
        bufs = {name: mesh_lib.all_gather_rows(b.transpose(0, 1), data
                                               ).transpose(0, 1)
                for name, b in bufs.items()}
        return x, cache, tick, st, bufs, n

    def _run(self, params, x: torch.Tensor, kv_valid, state: Dict,
             tick: int, k_req: int, stop_on_release: bool,
             cache: Optional[Dict] = None, seed: int = 0):
        c = self._carry_for(x)
        sc, st, bufs = c["scalars"], c["state"], c["bufs"]
        k_req = max(0, min(int(k_req), self.k_max))
        for name, v in (("i", 0), ("stop", False), ("tick", int(tick)),
                        ("seed", int(seed) & sampling_lib.MASK32),
                        ("k_req", k_req),
                        ("stop_on_release", bool(stop_on_release))):
            sc[name].fill_(v)
        for name, t in st.items():
            t.copy_(state[name])
        for buf in bufs.values():
            buf.zero_()
        args = (params, x, kv_valid, cache, sc, st, bufs, c["ksched"])
        graphed = self.jit_steps and x.device.type == "cuda"
        enqueued = 0
        if graphed:
            flag = c["flag"]
            flag.fill_(False)
            done = [torch.cuda.Event(), torch.cuda.Event()]
            for j in range(k_req):
                if j >= 2:          # tick j - 2 is done: read its stop flag
                    done[j % 2].synchronize()
                    self.event_waits += 1
                    if bool(flag[0]):
                        break
                self._step(*args)
                flag.copy_(sc["stop"], non_blocking=True)
                done[j % 2].record()
                enqueued += 1
        else:
            for _ in range(k_req):
                self._step(*args)
                enqueued += 1
                self.host_waits += 1
                if bool(sc["stop"][0]):
                    break
        n = int(sc["i"][0])                 # the megastep's device sync
        self.host_waits += graphed
        self.ticks_run += enqueued
        self.ticks_wasted += enqueued - n
        return x, cache, int(tick) + n, st, bufs, n


def get_megatick_fn(model, dcfg: DiffusionConfig, mask_id: int, k_max: int,
                    jit_steps: bool = True,
                    slowfast_threshold: Optional[float] = None,
                    quant=None, mesh=None) -> Megatick:
    """The fused K-tick megastep (``Megatick``), the JAX get_megatick_fn
    (with ``mesh``, its shard_map branch): ``fn(params, x, kv_valid,
    state, tick, k_req,
    stop_on_release, cache=None, seed=0) -> (x, cache, tick, state,
    buffers, n_ticks)``, with ``tick`` the counter of the tick_seed stream
    in place of JAX's rng.  ``slowfast_threshold`` moves
    SlowFastPolicy.step_k onto the device.  Shared across calls with the
    same arguments, as JAX's lru_cache shares the compile: its graphs and
    the buffers they read are made once per shape (``generate`` runs on
    ``canvas``).  A serving engine makes its own ``Megatick``: its graphs
    hold the engine's buffers."""
    return _shared_megatick(
        model, dcfg, int(mask_id), int(k_max), bool(jit_steps),
        None if slowfast_threshold is None else float(slowfast_threshold),
        quant, mesh)


@functools.lru_cache(maxsize=16)
def _shared_megatick(model, dcfg, mask_id, k_max, jit_steps, threshold,
                     quant, mesh) -> Megatick:
    return Megatick(model, dcfg, mask_id, k_max, jit_steps=jit_steps,
                    slowfast_threshold=threshold, quant=quant, mesh=mesh)


# ---------------------------------------------------------------------------
# Paged block-pool tick: the serving canvas and KV cache live in fixed-size
# physical pages addressed through per-slot block tables
# (serving/cache_pool.PagedCachePool).  The device math is the unchanged
# batched tick: a paged tick gathers the pages into the dense (B, S) views
# the tick body expects, runs it, and scatters the results back, so greedy
# tokens equal the slot pool's by construction.  A cache is a dict; its
# leaves are taken in sorted key order, the order jax.tree flattens a dict
# in, so the per-leaf lists below line up with the JAX package's.
# ---------------------------------------------------------------------------

def _leaf_shapes(model, batch: int, s_tot: int):
    """The cache's keys in sorted order and their shapes, from
    ``device="meta"`` tensors (nothing is allocated)."""
    cache = model.init_cache(batch, s_tot, device="meta")
    return sorted(cache), [tuple(cache[n].shape) for n in sorted(cache)]


def _batch_axes(base, wider):
    axes = []
    for lb, lw in zip(base, wider):
        ax = [i for i, (a, b) in enumerate(zip(lb, lw)) if a != b]
        if len(ax) != 1:
            raise ValueError(f"cannot locate the batch axis of cache leaf "
                             f"with shape {lb}")
        axes.append(ax[0])
    return axes


def cache_batch_axes(model, s_tot: int) -> Dict[str, int]:
    """The batch axis of each leaf of ``model.init_cache``, probed as in
    ``paged_cache_layout`` (axis 1 for a stacked KV leaf, 2 for the
    hybrid's ``rec_state``/``rec_conv``)."""
    names, base = _leaf_shapes(model, 2, s_tot)
    return dict(zip(names, _batch_axes(base, _leaf_shapes(model, 3,
                                                          s_tot)[1])))


def paged_cache_layout(model, page_size: int, s_tot: int):
    """Probe ``model.init_cache``'s leaf layout for the paged pool.

    Returns ``(names, paged, batch_axis)``: the cache's keys in sorted
    order and, per key, whether the leaf carries a full sequence dimension
    (it then moves into a page store) and where its batch dimension lies
    (per-slot leaves -- the BAOS calibration, the recurrent families'
    states and conv rows, whose batch axis may be 2 -- are spilled and
    restored along it).  The probe builds ``device="meta"`` tensors, so no
    cache is allocated.  Layouts whose sequence axis is not axis 2 (with
    batch at axis 1) are rejected: the gather and scatter views assume
    (stack, batch, seq, ...)."""
    names, base = _leaf_shapes(model, 2, s_tot)
    _, grown = _leaf_shapes(model, 2, s_tot + page_size)
    batch_axis = _batch_axes(base, _leaf_shapes(model, 3, s_tot)[1])
    paged = []
    for lb, lg, ax in zip(base, grown, batch_axis):
        seq_axes = [i for i, (a, b) in enumerate(zip(lb, lg)) if a != b]
        if seq_axes and (seq_axes != [2] or ax != 1):
            raise ValueError(
                f"paged pool supports (stack, batch, seq, ...) cache "
                f"leaves only; got shape {lb} with seq axes {seq_axes}, "
                f"batch axis {ax}")
        paged.append(bool(seq_axes))
    return names, paged, batch_axis


def _page_index(table: torch.Tensor) -> torch.Tensor:
    return table.reshape(-1).to(torch.int64)


def gather_canvas_rows(canvas_pages: torch.Tensor, canvas_table: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(NP, page) canvas pages + (B, R) block table -> dense (B, S) rows,
    into ``out`` when given."""
    B, R = canvas_table.shape
    ps = canvas_pages.shape[1]
    idx = _page_index(canvas_table)
    if out is None:
        return canvas_pages.index_select(0, idx).reshape(B, R * ps)
    torch.index_select(canvas_pages, 0, idx, out=out.view(B * R, ps))
    return out


def scatter_canvas_rows(canvas_pages: torch.Tensor, canvas_table: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """Write dense (B, S) rows back through the block table, in place.

    Shared radix-cached prompt pages and the null page 0 appear more than
    once in the table, and where an index repeats, ``index_copy_`` on the
    card lets an arbitrary writer win.  Every writer of such a page writes
    the same values: prompt content never changes, and null-mapped tail
    and idle positions carry the page's own gathered content (a tick
    commits only inside each row's active block, which lies on private
    pages).  So the result does not depend on the order."""
    B, R = canvas_table.shape
    ps = canvas_pages.shape[1]
    return canvas_pages.index_copy_(0, _page_index(canvas_table),
                                    rows.reshape(B * R, ps))


def _paged_view(store: torch.Tensor, B: int, R: int) -> Tuple[int, ...]:
    """The (stack, B * R, page, ...) shape of a dense leaf of B rows."""
    return store.shape[:1] + (B * R, store.shape[2]) + store.shape[3:]


def _slot_rows(leaf: torch.Tensor, axis: int, rows) -> torch.Tensor:
    """A per-slot leaf, or its ``rows`` (r0, r1) along its batch axis."""
    return leaf if rows is None else leaf.narrow(axis, rows[0],
                                                 rows[1] - rows[0])


def gather_cache_rows(cache_store: Dict, kv_table: torch.Tensor, paged_flags,
                      out: Optional[Dict] = None, rows=None,
                      batch_axes=None) -> Dict:
    """Page-store cache -> the dense per-slot cache the tick body expects.
    Per-slot leaves pass through as the store's own tensors, or with
    ``out`` (a dict of dense buffers) are copied into it.  ``rows``
    (r0, r1): only those slots, a data rank's under a mesh (its KV pages,
    and its rows of each per-slot leaf along ``batch_axes``, the
    ``paged_cache_layout`` axes)."""
    if rows is not None:
        kv_table = kv_table[rows[0]:rows[1]]
    B, R = kv_table.shape
    idx = _page_index(kv_table)
    dense = {} if out is None else out
    axes = batch_axes or [1] * len(paged_flags)
    for name, paged, ax in zip(sorted(cache_store), paged_flags, axes):
        leaf = cache_store[name]
        if not paged:
            leaf = _slot_rows(leaf, ax, rows)
            if out is None:
                dense[name] = leaf
            else:
                out[name].copy_(leaf)
        elif out is None:
            dense[name] = leaf.index_select(1, idx).reshape(
                leaf.shape[:1] + (B, R * leaf.shape[2]) + leaf.shape[3:])
        else:
            torch.index_select(leaf, 1, idx,
                               out=out[name].view(_paged_view(leaf, B, R)))
    return dense


def scatter_cache_rows(cache_store: Dict, kv_table: torch.Tensor,
                       new_cache: Dict, paged_flags, rows=None,
                       batch_axes=None) -> Dict:
    """Write a tick's dense cache back into the page stores, in place.
    KV pages are private per slot (the warm tick rewrites every position
    every tick, so sharing would break the moment it was established).
    Only tail and idle entries alias the null page 0, and there the
    writers differ, so which one wins is arbitrary: safe, because those
    positions are masked out of ``kv_valid``, never read by a valid
    position, and every warm tick rewrites them before it attends.
    ``rows``/``batch_axes``: the slots ``gather_cache_rows`` took."""
    if rows is not None:
        kv_table = kv_table[rows[0]:rows[1]]
    B, R = kv_table.shape
    idx = _page_index(kv_table)
    axes = batch_axes or [1] * len(paged_flags)
    for name, paged, ax in zip(sorted(cache_store), paged_flags, axes):
        store, new = cache_store[name], new_cache[name]
        if paged:
            store.index_copy_(1, idx, new.reshape(_paged_view(store, B, R)))
            continue
        store = _slot_rows(store, ax, rows)
        if new.data_ptr() != store.data_ptr() or new.shape != store.shape:
            store.copy_(new)
    return cache_store


def get_paged_tick_fn(model, dcfg: DiffusionConfig, mask_id: int,
                      page_size: int, s_tot: int, with_cache: bool = True,
                      jit_steps: bool = True, quant=None, pool=None,
                      mesh=None):
    """``batched_tick`` reading and writing through block tables, the JAX
    ``get_paged_tick_fn``: ``tick(params, canvas_pages, cache_store,
    canvas_table, kv_table, kv_valid, block_start, k, seed) ->
    (canvas_pages, cache_store, x, conf_min, masks_left)``.  Gather the
    canvas and KV pages into dense (B, S) views, run the unchanged tick
    body, scatter back into the stores in place; ``x`` is the post-tick
    dense canvas, the copy that streaming diffs and request release read.
    With ``jit_steps`` on the card gather, tick and scatter are one CUDA
    graph (core/graphs.py, in memory ``pool``): the stores, tables and
    inputs are then its static buffers, written in place between calls,
    and the outputs live until the next call.  Without, or on the CPU, the
    same function runs eagerly.

    With ``mesh`` the body is the SPMD tick (``get_spmd_tick_fn``, whose
    checks the caller runs; ``params`` from ``place_spmd_params``), as JAX
    runs its shard_map tick on the dense views.  Every rank keeps the same
    page stores and tables (the engine's pool bookkeeping runs alike on
    each); a rank gathers the KV pages and per-slot rows of its ``data``
    shard's slots only and scatters only those back.  KV pages are private
    to a slot and a slot's rank is fixed (``mesh.rows``), so no rank reads
    another's; the canvas comes back whole from the tick's gather over
    ``data``, so the canvas pages, shared prefix pages included, stay equal
    on every rank."""
    _, paged, axes = (paged_cache_layout(model, page_size, s_tot)
                      if with_cache else (None, None, None))
    spmd = (None if mesh is None else
            get_spmd_tick_fn(model, dcfg, mask_id, mesh, jit_steps=False,
                             quant=quant))

    def tick(params, canvas_pages, cache_store, canvas_table, kv_table,
             kv_valid, block_start, k, seed):
        x = gather_canvas_rows(canvas_pages, canvas_table)
        rows = None if mesh is None else mesh.rows(x.shape[0])
        cache = (None if cache_store is None
                 else gather_cache_rows(cache_store, kv_table, paged,
                                        rows=rows, batch_axes=axes))
        if mesh is None:
            x_new, cache, conf_min, masks_left = batched_tick(
                model, params, x, kv_valid, block_start, k, seed, cache,
                dcfg, mask_id, quant)
        else:
            x_new, cache, conf_min, masks_left = spmd(
                params, x, kv_valid, block_start, k, seed, cache)
        scatter_canvas_rows(canvas_pages, canvas_table, x_new)
        if cache_store is not None:
            scatter_cache_rows(cache_store, kv_table, cache, paged,
                               rows=rows, batch_axes=axes)
        return canvas_pages, cache_store, x_new, conf_min, masks_left

    return graphs.GraphedStep(tick, pool) if jit_steps else tick


class PagedMegatick(Megatick):
    """The paged megastep, the JAX ``get_paged_megatick_fn``: ``fn(params,
    canvas_pages, cache_store, canvas_table, kv_table, kv_valid, state,
    tick, k_req, stop_on_release, seed=0) -> (canvas_pages, cache_store,
    x, tick + n, state, buffers, n)``.  The block tables are fixed across a
    megastep (admission and release happen at its boundaries), so the
    pages are gathered once into dense canvas and cache buffers that this
    object owns (made at the first call of a shape), the megatick runs on
    them as on the slot pool's, and they are scattered back once.  The
    buffers keep their addresses, so the megatick's graphs capture once;
    per-slot leaves are copied in and out with the KV, so a call on copies
    of the stores (the engine's warmup) leaves the engine's own untouched.
    ``x`` is the dense canvas buffer, valid until the next call.  With
    ``mesh`` the megatick is the SPMD one and the dense cache holds this
    rank's ``data`` rows only (``get_paged_tick_fn``'s design)."""

    def __init__(self, model, dcfg: DiffusionConfig, mask_id: int,
                 k_max: int, page_size: int, s_tot: int,
                 with_cache: bool = True, jit_steps: bool = True,
                 slowfast_threshold: Optional[float] = None, quant=None,
                 mesh=None):
        super().__init__(model, dcfg, mask_id, k_max, jit_steps=jit_steps,
                         slowfast_threshold=slowfast_threshold, quant=quant,
                         mesh=mesh)
        _, self.flags, self.axes = (
            paged_cache_layout(model, page_size, s_tot) if with_cache
            else (None, None, None))

    def _rows(self, B: int):
        return None if self.mesh is None else self.mesh.rows(B)

    def _dense_for(self, canvas_pages: torch.Tensor,
                   canvas_table: torch.Tensor, cache_store: Optional[Dict]):
        B, R = canvas_table.shape
        S, dev = R * canvas_pages.shape[1], canvas_pages.device
        key = ("dense", B, S, dev)
        if key not in self._carry:
            cache = None
            rows = self._rows(B)
            n = B if rows is None else rows[1] - rows[0]
            if cache_store is not None:
                cache = {}
                for name, paged, ax in zip(sorted(cache_store), self.flags,
                                           self.axes):
                    leaf = cache_store[name]
                    if paged:
                        shape = leaf.shape[:1] + (n, S) + leaf.shape[3:]
                    else:
                        shape = list(leaf.shape)
                        shape[ax] = n
                    cache[name] = torch.zeros(tuple(shape), dtype=leaf.dtype,
                                              device=dev)
            self._carry[key] = (torch.zeros((B, S), dtype=canvas_pages.dtype,
                                            device=dev), cache)
        return self._carry[key]

    def __call__(self, params, canvas_pages: torch.Tensor,
                 cache_store: Optional[Dict], canvas_table: torch.Tensor,
                 kv_table: torch.Tensor, kv_valid, state: Dict, tick: int,
                 k_req: int, stop_on_release: bool, seed: int = 0):
        x, cache = self._dense_for(canvas_pages, canvas_table, cache_store)
        rows = self._rows(x.shape[0])
        gather_canvas_rows(canvas_pages, canvas_table, out=x)
        if cache is not None:
            gather_cache_rows(cache_store, kv_table, self.flags, out=cache,
                              rows=rows, batch_axes=self.axes)
        x, cache, tick, st, bufs, n = super().__call__(
            params, x, kv_valid, state, tick, k_req, stop_on_release, cache,
            seed)
        scatter_canvas_rows(canvas_pages, canvas_table, x)
        if cache is not None:
            scatter_cache_rows(cache_store, kv_table, cache, self.flags,
                               rows=rows, batch_axes=self.axes)
        return canvas_pages, cache_store, x, tick, st, bufs, n


# ---------------------------------------------------------------------------
# Resumable per-request state machine and generate()
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiffusionState:
    """Everything needed to resume blocked-diffusion decoding of a request:
    the canvas ``x`` (prompt + masked generation region), the KV ``cache``
    (None for cache_mode 'none'; updated in place by each step), the
    per-block transfer schedule ``ks`` (B, steps_per_block) on the host,
    the seed and the number of ticks taken, and the host-side block/step
    counters."""
    x: torch.Tensor
    ks: torch.Tensor
    dcfg: DiffusionConfig
    mask_id: int
    prompt_len: int
    cache: Optional[Dict] = None
    seed: int = 0
    ticks: int = 0
    block_idx: int = 0
    step_in_block: int = 0

    @property
    def done(self) -> bool:
        return self.block_idx >= self.dcfg.num_blocks

    @property
    def block_start(self) -> int:
        return self.prompt_len + self.block_idx * self.dcfg.block_length


def init_state(model, prompt: torch.Tensor, dcfg: DiffusionConfig,
               seed: int = 0, mask_id: Optional[int] = None,
               cache: Optional[Dict] = None) -> DiffusionState:
    """Step-0 state of a (batched) request: masked canvas on the model's
    device, a KV cache for the cached modes (``cache`` if given, else a
    fresh one: a warm step rewrites all of it before anything reads it),
    transfer schedule, seed."""
    check_supported(dcfg)
    mask_id = model.cfg.mask_id if mask_id is None else mask_id
    B, P = prompt.shape
    x = torch.cat([prompt.to(device=model.device, dtype=torch.int32),
                   torch.full((B, dcfg.gen_length), mask_id,
                              dtype=torch.int32, device=model.device)], dim=1)
    if dcfg.cache_mode == "none":
        cache = None
    elif cache is None:
        cache = model.init_cache(B, P + dcfg.gen_length)
    ks = schedule_lib.get_num_transfer_tokens(
        torch.full((B,), dcfg.block_length, dtype=torch.int32),
        dcfg.steps_per_block)
    return DiffusionState(x=x, ks=ks, dcfg=dcfg, mask_id=mask_id,
                          prompt_len=P, cache=cache, seed=seed)


def step_forward(model, params, state: DiffusionState,
                 quant=None, **fwd_kw) -> torch.Tensor:
    """The forward of the next step of a cached mode: the warm step at
    step_in_block 0, a refine step after it.  Updates ``state.cache`` in
    place and returns the active block's feats ((B, L, d) hidden states,
    or (B, L, V) logits on the legacy path)."""
    dcfg = state.dcfg
    head_mode = _forward_head_mode(model, dcfg)
    bs = state.block_start
    if state.step_in_block == 0:
        feats, _ = warm_step(model, params, state.x, state.cache, bs, dcfg,
                             head_mode, quant, **fwd_kw)
    else:
        suffix = (state.x.shape[1] - (bs + dcfg.block_length)
                  if dcfg.cache_mode == "prefix" else 0)
        feats, _ = refine_step(model, params, state.x, state.cache, bs,
                               dcfg, suffix, head_mode, quant, **fwd_kw)
    return feats


def commit_block(model, params, state: DiffusionState, feats: torch.Tensor,
                 quant=None) -> torch.Tensor:
    """The sampling half of a cached-mode step: the head path on the
    active block's feats, top-k and commit of ks[:, t] tokens.  Returns the
    new canvas."""
    dcfg = state.dcfg
    L, bs = dcfg.block_length, state.block_start
    xa_new, _, _ = _active_sampling_step(
        feats, state.x[:, bs:bs + L],
        state.ks[:, state.step_in_block].to(state.x.device),
        tick_seed(state.seed, state.ticks), params,
        head_feed_mode(model, dcfg), dcfg, state.mask_id, model, quant)
    x = state.x.clone()
    x[:, bs:bs + L] = xa_new
    return x


def advance(state: DiffusionState, x: torch.Tensor) -> DiffusionState:
    """The state after a step that produced canvas ``x``: one more tick,
    the next step, or the next block after the last step."""
    t = state.step_in_block + 1
    block_idx = state.block_idx
    if t == state.dcfg.steps_per_block:
        t, block_idx = 0, block_idx + 1
    return dataclasses.replace(state, x=x, ticks=state.ticks + 1,
                               block_idx=block_idx, step_in_block=t)


# ---------------------------------------------------------------------------
# Graphed steps of step()/generate() (JAX's jit_steps)
# ---------------------------------------------------------------------------

class StepGraphs:
    """The graphed steps of ``step``/``generate`` for one (model, dcfg,
    mask id, quant) at one canvas shape (B, S), and the static device
    buffers they read: the canvas ``x``, the block start ``bs``, the
    step's ``k`` (ks[:, t]) and its tick ``seed``, written before each
    replay, and for the cached modes the KV ``cache`` that ``generate``
    decodes into.  Cache mode none runs ``get_tick_fn``'s graphed tick;
    the cached modes run three kinds of ``GraphedStep``: the warm step,
    the refine step (one per suffix length: prefix mode's suffix shrinks
    block by block, as JAX re-jits per suffix) and the commit.  All their
    graphs share one memory pool (they run one after another on one
    stream).  On the CPU the steps simply run, on the same buffers.

    Each step's graph bakes in the addresses of the params dict's tensors
    and of the cache it was given: a ``step`` on another state's cache
    captures anew (and keeps that cache alive with the graph)."""

    def __init__(self, model, dcfg: DiffusionConfig, mask_id: int, quant,
                 B: int, S: int, mesh=None):
        dev = model.device
        self.model, self.dcfg, self.mask_id, self.quant = (
            model, dcfg, int(mask_id), quant)
        self.mode = head_feed_mode(model, dcfg)
        self.pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                     else None)
        self.x = torch.zeros((B, S), dtype=torch.int32, device=dev)
        self.bs = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.k = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.seed = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._ks_host: Optional[torch.Tensor] = None
        self._ks = None
        self.cache = None
        self._steps: Dict[Tuple[str, int], graphs.GraphedStep] = {}
        if mesh is not None:
            self._steps["tick", 0] = get_spmd_tick_fn(
                model, dcfg, mask_id, mesh, True, quant, self.pool)
        elif dcfg.cache_mode == "none":
            self._steps["tick", 0] = get_tick_fn(model, dcfg, mask_id, True,
                                                 quant, self.pool)
        else:
            self.cache = model.init_cache(B, S)
            self._steps["commit", 0] = graphs.GraphedStep(self._commit,
                                                          self.pool)

    @property
    def captures(self) -> int:
        """Graphs captured so far by this entry's steps."""
        return sum(s.captures for s in self._steps.values())

    def _forward(self, kind: str, suffix: int) -> graphs.GraphedStep:
        fn = self._steps.get((kind, suffix))
        if fn is None:
            head_mode = _forward_head_mode(self.model, self.dcfg)

            def forward(params, x, cache, bs, **fwd_kw):
                bs = bs[:1]
                if kind == "warm":
                    return warm_step(self.model, params, x, cache, bs,
                                     self.dcfg, head_mode, self.quant,
                                     **fwd_kw)[0]
                return refine_step(self.model, params, x, cache, bs,
                                   self.dcfg, suffix, head_mode,
                                   self.quant, **fwd_kw)[0]

            fn = self._steps[kind, suffix] = graphs.GraphedStep(forward,
                                                                self.pool)
        return fn

    def _commit(self, params, feats, x, bs, k, seed):
        cols = bs[0] + torch.arange(self.dcfg.block_length, device=x.device)
        xa_new, _, _ = _active_sampling_step(
            feats, x.index_select(1, cols), k, seed, params, self.mode,
            self.dcfg, self.mask_id, self.model, self.quant)
        return x.clone().index_copy_(1, cols, xa_new)

    def __call__(self, params, state: DiffusionState,
                 **fwd_kw) -> torch.Tensor:
        """The canvas after ``state``'s next step (a new tensor); the
        forward reads ``fwd_kw`` (``FWD_TENSORS``) in place."""
        dcfg, t = self.dcfg, state.step_in_block
        if self._ks_host is None or not torch.equal(self._ks_host, state.ks):
            self._ks_host = state.ks.clone()
            self._ks = state.ks.to(device=self.k.device, dtype=torch.int64)
        self.x.copy_(state.x)
        self.bs.fill_(state.block_start)
        self.k.copy_(self._ks[:, t])
        self.seed.fill_(tick_seed(state.seed, state.ticks))
        if ("tick", 0) in self._steps:
            x_new = self._steps["tick", 0](params, self.x, None, self.bs,
                                           self.k, self.seed, None,
                                           **fwd_kw)[0]
            return x_new.clone()
        if t == 0:
            fwd = self._forward("warm", 0)
        else:
            S, L = self.x.shape[1], dcfg.block_length
            fwd = self._forward("refine", S - (state.block_start + L)
                                if dcfg.cache_mode == "prefix" else 0)
        feats = fwd(params, self.x, state.cache, self.bs, **fwd_kw)
        return self._steps["commit", 0](params, feats, self.x, self.bs,
                                        self.k, self.seed).clone()


_STEP_GRAPHS: Dict[Tuple, StepGraphs] = {}


def step_graphs(model, dcfg: DiffusionConfig, mask_id: int, quant, B: int,
                S: int, mesh=None) -> StepGraphs:
    """The ``StepGraphs`` of (model, dcfg, mask_id, quant, B, S[, mesh]),
    made at its first use and kept at module level, as JAX's lru_cache
    keeps its compiles; ``clear_step_graphs`` frees them.  With ``mesh``
    the step is the graphed SPMD tick (cache mode none)."""
    key = (model, dcfg, int(mask_id), quant, int(B), int(S), mesh)
    g = _STEP_GRAPHS.get(key)
    if g is None:
        check_supported(dcfg)
        g = _STEP_GRAPHS[key] = StepGraphs(model, dcfg, mask_id, quant, B, S,
                                           mesh)
    return g


def clear_step_graphs() -> None:
    """Free every graphed step and shared megatick (and the buffers,
    parameters and caches their graphs hold), e.g. before loading another
    model."""
    _STEP_GRAPHS.clear()
    _shared_megatick.cache_clear()


def split_fwd_kw(fwd_kw: Dict) -> Tuple[Optional[object], Dict]:
    """(the ``quant`` policy, the other forward kwargs) out of forward
    kwargs, which may be ``quant`` and ``FWD_TENSORS``."""
    extra = dict(fwd_kw)
    quant = extra.pop("quant", None)
    unknown = sorted(set(extra) - set(FWD_TENSORS))
    if unknown:
        raise ValueError(f"unsupported forward kwargs {unknown}; the port's "
                         f"forward takes quant and {', '.join(FWD_TENSORS)}")
    return quant, extra


def _check_mesh_step(dcfg: DiffusionConfig, mesh, extra: Dict,
                     what: str) -> None:
    if mesh is None:
        return
    if dcfg.cache_mode != "none":
        raise ValueError(
            f"{what}(mesh=...) supports cache_mode='none' only (the SPMD "
            "path runs the batched tick; use the serving engine for "
            "pooled warm-cache SPMD ticks)")
    if extra:
        raise ValueError(f"{what}(mesh=...) does not support extra forward "
                         "kwargs")


def step(model, params, state: DiffusionState, jit_steps: bool = True,
         mesh=None, **fwd_kw) -> DiffusionState:
    """Advance one denoising step: the forward for the cache mode (a
    batched tick for 'none'; warm at step_in_block 0, else refine), then
    the commit of ks[:, t] tokens of the active block.  With ``jit_steps``
    the step runs as the CUDA graphs of ``step_graphs`` (on the CPU the
    same code eagerly); ``fwd_kw`` takes ``quant`` and ``FWD_TENSORS``.
    With ``mesh`` (cache mode none only, params from
    ``place_spmd_params``) the step is the SPMD tick."""
    if state.done:
        raise ValueError("step() called on a finished DiffusionState")
    quant, extra = split_fwd_kw(fwd_kw)
    dcfg = state.dcfg
    _check_mesh_step(dcfg, mesh, extra, "step")
    if jit_steps:
        x = step_graphs(model, dcfg, state.mask_id, quant,
                        *state.x.shape, mesh=mesh)(params, state, **extra)
    elif mesh is not None:
        B = state.x.shape[0]
        dev = state.x.device
        x = get_spmd_tick_fn(model, dcfg, state.mask_id, mesh, False,
                             quant)(
            params, state.x, None,
            torch.full((B,), state.block_start, dtype=torch.int32,
                       device=dev),
            state.ks[:, state.step_in_block].to(dev),
            tick_seed(state.seed, state.ticks), None)[0]
    elif dcfg.cache_mode == "none":
        B = state.x.shape[0]
        dev = state.x.device
        x, _, _, _ = batched_tick(
            model, params, state.x, None,
            torch.full((B,), state.block_start, dtype=torch.int32,
                       device=dev),
            state.ks[:, state.step_in_block].to(dev),
            tick_seed(state.seed, state.ticks), None, dcfg, state.mask_id,
            quant, **extra)
    else:
        feats = step_forward(model, params, state, quant, **extra)
        x = commit_block(model, params, state, feats, quant)
    return advance(state, x)


def generate(model, params, prompt: torch.Tensor, dcfg: DiffusionConfig,
             seed: int = 0, mask_id: Optional[int] = None,
             megatick_k: int = 1, jit_steps: bool = True, mesh=None,
             **fwd_kw) -> torch.Tensor:
    """Blocked diffusion generation (paper Alg. 2 outer loops) in
    ``dcfg.cache_mode``.  prompt (B, P) int -> (B, P + gen_length)
    int32.  With ``jit_steps`` every step replays the CUDA graphs of
    ``step_graphs`` and decodes into its cache, so a second call with the
    same shapes captures nothing.  ``megatick_k > 1`` (cache_mode 'none'
    only, as in JAX) runs the ticks K at a time through
    ``get_megatick_fn`` (graphed on the card with ``jit_steps``); the
    tick_seed stream is the same, so the tokens equal the per-step
    path's.  ``fwd_kw`` takes ``quant`` (a ``layers.QuantPolicy``) and
    ``FWD_TENSORS`` (not with the megatick, as in JAX).

    With ``mesh`` (a launch/mesh.Mesh; cache mode none only, as in JAX)
    every step runs the SPMD tick (``get_spmd_tick_fn``): the batch rows
    shard over ``data``, the LM head's columns over ``model``; the params
    are placed once (``place_spmd_params``).  Every rank gets the whole
    canvas back.  A mesh whose collectives a graph cannot capture (gloo on
    the card) needs ``jit_steps=False``."""
    quant, extra = split_fwd_kw(fwd_kw)
    if mesh is not None:
        _check_mesh_step(dcfg, mesh, extra, "generate")
        check_spmd(model, dcfg, mesh, jit_steps)
        params = place_spmd_params(params, mesh)     # once, not per step
    if megatick_k > 1:
        if extra:
            raise ValueError("generate(megatick_k>1) does not support extra "
                             f"forward kwargs: {sorted(extra)}")
        return _generate_megatick(model, params, prompt, dcfg, seed,
                                  mask_id, megatick_k, jit_steps, quant,
                                  mesh)
    mask_id = int(model.cfg.mask_id if mask_id is None else mask_id)
    cache = None
    if jit_steps and dcfg.cache_mode != "none":
        B, P = prompt.shape
        cache = step_graphs(model, dcfg, mask_id, quant, B,
                            P + dcfg.gen_length).cache
    state = init_state(model, prompt, dcfg, seed=seed, mask_id=mask_id,
                       cache=cache)
    while not state.done:
        state = step(model, params, state, jit_steps=jit_steps, mesh=mesh,
                     quant=quant, **extra)
    return state.x


def _generate_megatick(model, params, prompt: torch.Tensor,
                       dcfg: DiffusionConfig, seed: int,
                       mask_id: Optional[int], megatick_k: int,
                       jit_steps: bool, quant=None,
                       mesh=None) -> torch.Tensor:
    """generate() through the megatick: the tick count is fixed
    (num_blocks * steps_per_block), so ceil(total / K) megasteps of K, on
    the shared megatick's static canvas."""
    if dcfg.cache_mode != "none":
        raise ValueError(
            "generate(megatick_k>1) requires cache_mode='none' (the "
            "megatick is built on the uniform batched tick)")
    check_supported(dcfg)
    mask_id = int(model.cfg.mask_id if mask_id is None else mask_id)
    B, P = prompt.shape
    dev = model.device
    fn = get_megatick_fn(model, dcfg, mask_id, int(megatick_k),
                         jit_steps=jit_steps, quant=quant, mesh=mesh)
    x, kv_valid = fn.canvas(B, P + dcfg.gen_length, dev)
    x[:, :P].copy_(prompt.to(device=dev, dtype=torch.int32))
    x[:, P:].fill_(mask_id)
    state = megatick_state(torch.full((B,), P, dtype=torch.int32),
                           torch.full((B,), dcfg.num_blocks,
                                      dtype=torch.int32), dcfg, device=dev)
    tick = 0
    total = dcfg.num_blocks * dcfg.steps_per_block
    for _ in range(-(-total // megatick_k)):
        x, _, tick, state, _, _ = fn(params, x, kv_valid, state, tick,
                                     megatick_k, False, None, seed)
    return x.clone()


# ---------------------------------------------------------------------------
# Training objective (LLaDA masked diffusion)
# ---------------------------------------------------------------------------

def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step``'s mask draw, on ``device``:
    seeded with (seed << 32) | step, so a step replayed from a checkpoint
    draws the same mask.  (JAX folds the step into a threefry key; its
    draw cannot be reproduced without JAX, so the tests hand JAX's own
    draw to ``masked_diffusion_loss`` instead.)"""
    return torch.Generator(device=device).manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def forward_mask(gen: torch.Generator, tokens: torch.Tensor, mask_id: int,
                 eps: float = 1e-3):
    """LLaDA forward process: t ~ U(eps, 1) per sequence, each position
    masked iid with probability t.  -> (noisy, mask, t (B, 1) f32)."""
    B, S = tokens.shape
    u = torch.rand((B, 1), generator=gen, device=tokens.device)
    t = torch.clamp(u * (1.0 - eps) + eps, min=eps)
    mask = torch.rand((B, S), generator=gen, device=tokens.device) < t
    noisy = torch.where(mask, mask_id, tokens)
    return noisy, mask, t


def masked_diffusion_loss(model, params, tokens: torch.Tensor,
                          gen: Optional[torch.Generator] = None,
                          quant=None, aux_weight: float = 0.0,
                          valid: Optional[torch.Tensor] = None,
                          loss_chunk: Optional[int] = None,
                          draw: Optional[Tuple] = None, axis=None,
                          **fwd_kw):
    """LLaDA objective: E_t E_mask [ 1/t * sum_masked CE ] / (B * S), the
    f32 function of JAX's ``masked_diffusion_loss``.  The mask comes from
    ``forward_mask(gen, ...)`` or, given ``draw``, is that
    ``(noisy, mask, t)``.  An MoE model adds ``aux_weight`` x its
    load-balance aux summed over the layers.  ``valid`` (B, S) weights
    each position's CE; ``loss_chunk`` takes the CE over sequence chunks,
    the f32 copy of the (B, S, V) logits never whole (when S divides).
    ``axis``, a launch/mesh ``Axis`` whose ranks each hold B rows of one
    global batch (a data mesh): the loss divides by the global
    B * axis.size * S, so the sum of the ranks' gradients is the global
    batch's, and the metrics come from sums over the axis (the MoE aux,
    not linear in the batch, comes global from models/moe.py under
    models/tp.Parallel(data=)).  Under the tensor-parallel body with a
    vocab-sharded head the logits are this rank's columns and the CE is
    models/tp.vocab_ce's global log-softmax.
    -> (loss, metrics: loss, ce_masked, mask_frac, aux, detached)."""
    cfg = model.cfg
    noisy, mask, t = draw if draw is not None else forward_mask(
        gen, tokens, cfg.mask_id)
    if cfg.moe is not None:
        logits, _, aux = model.forward(params, noisy, quant=quant,
                                       return_aux=True, **fwd_kw)
    else:
        logits, _ = model.forward(params, noisy, quant=quant, **fwd_kw)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    B, S = tokens.shape

    from repro_torch.models import tp as tp_lib

    def ce_of(lg, tk):
        lf = lg.to(torch.float32)
        if tp_lib.vocab_sharded(lf, cfg.vocab):
            return tp_lib.vocab_ce(lf, tk, cfg.vocab)
        gold = torch.gather(lf, -1, tk[..., None].to(torch.int64))[..., 0]
        return torch.logsumexp(lf, dim=-1) - gold

    if loss_chunk is not None and S % loss_chunk == 0:
        ce = torch.cat([ce_of(logits[:, c:c + loss_chunk],
                              tokens[:, c:c + loss_chunk])
                        for c in range(0, S, loss_chunk)], dim=1)
    else:
        ce = ce_of(logits, tokens)
    maskf = mask.to(torch.float32)
    w = maskf / t
    if valid is not None:
        w = w * valid.to(torch.float32)
    n = 1 if axis is None else axis.size
    loss = ce_loss = torch.sum(ce * w) / (B * n * S)
    if aux_weight:
        loss = loss + aux_weight * aux
    if axis is not None:
        from repro_torch.launch import mesh as mesh_lib
        sums = mesh_lib.all_reduce(torch.stack(
            [ce_loss.detach(), torch.sum(ce.detach() * maskf),
             torch.sum(maskf)]), "sum", axis)
        # the aux is the global batch's on every rank: counted once
        metrics = {"loss": (sums[0] + aux_weight * aux.detach()
                            if aux_weight else sums[0]),
                   "ce_masked": sums[1] / torch.clamp(sums[2], min=1.0),
                   "mask_frac": sums[2] / (B * n * S), "aux": aux}
        return loss, {k: v.detach() for k, v in metrics.items()}
    metrics = {"loss": loss,
               "ce_masked": torch.sum(ce * maskf) / torch.clamp(
                   torch.sum(maskf), min=1.0),
               "mask_frac": torch.mean(maskf),
               "aux": aux}
    return loss, {k: v.detach() for k, v in metrics.items()}
