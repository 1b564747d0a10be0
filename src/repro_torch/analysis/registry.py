"""Declarative registry the port's analysis passes read, the counterpart of
src/repro/analysis/registry.py: which functions are hot paths (the tick
functions and the kernel launchers), which modules carry thread-shared
state, which functions feed the event log, the NPU kernels' SRAM
footprints at production scale (the paper's design point, copied from
JAX's registry), every CUDA kernel instantiation's shared memory per block
on the H100, every entry point with its transfer, in-place and collective
budgets, and the CUDA-graph capture bounds.  New hot paths, kernels and
entry points register *here*; the passes never hardcode repo structure.

Everything that builds a model is built lazily inside functions, so the
pure-AST passes (hotpath_lint, locks) stay import-light and fast.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Tuple

# the source root the source-level passes scan: src/repro_torch
SRC_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
PKG_PREFIX = "repro_torch"


def src_files() -> List[str]:
    """All library sources, as ``repro_torch/...`` relpaths, sorted."""
    out = []
    for dirpath, _, files in os.walk(SRC_ROOT):
        for f in sorted(files):
            if f.endswith(".py"):
                full = os.path.join(dirpath, f)
                rel = os.path.relpath(full, os.path.dirname(SRC_ROOT))
                out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def abspath(rel: str) -> str:
    return os.path.join(os.path.dirname(SRC_ROOT), rel)


def default_allowlist_path() -> str:
    return os.path.join(os.path.dirname(__file__), "allowlist.txt")


# ---------------------------------------------------------------------------
# Hot paths: functions that run once per tick on device tensors, or that
# a CUDA graph captures, where a host sync is a per-tick round trip (and
# inside a capture an error).  A name covers every function nested in it
# (a closure, a graphed step); "*" every function of the module.
# ---------------------------------------------------------------------------

HOT_PATHS: Dict[str, object] = {
    "repro_torch/core/diffusion.py": {
        "warm_step", "refine_step", "_active_sampling_step", "tick_forward",
        "tick_sample", "batched_tick", "get_tick_fn", "get_spmd_tick_fn",
        "megatick_state", "get_megatick_fn", "get_tick_stage_fns",
        "gather_canvas_rows", "scatter_canvas_rows", "gather_cache_rows",
        "scatter_cache_rows", "get_paged_tick_fn",
    },
    "repro_torch/core/sampling.py": "*",
    "repro_torch/kernels/fused_head_sampling.py": "*",
    "repro_torch/kernels/stablemax_sampling.py": "*",
    "repro_torch/kernels/topk_mask.py": "*",
    "repro_torch/kernels/flash_bidir.py": "*",
    "repro_torch/kernels/baos_mx_quant.py": "*",
}

# ---------------------------------------------------------------------------
# Lock-discipline scope: every module that shares state across the asyncio
# frontend thread, the per-replica engine worker threads and the mesh
# followers' control threads.
# ---------------------------------------------------------------------------

LOCK_SCOPE_PREFIXES: Tuple[str, ...] = (
    "repro_torch/serving/",
    "repro_torch/obs/",
)


def lock_scope_files() -> List[str]:
    return [f for f in src_files()
            if f.startswith(LOCK_SCOPE_PREFIXES)]


# ---------------------------------------------------------------------------
# Event-emit paths: the emit side of the structured event log stays a dict
# build and a deque append; serialization and file I/O belong to the
# flusher thread (ANL-EMITIO).
# ---------------------------------------------------------------------------

EVENT_EMIT_PATHS: Dict[str, Tuple[str, ...]] = {
    "repro_torch/obs/events.py": ("EventLog.emit",),
    "repro_torch/obs/serving.py": ("ServingObs.event",),
    "repro_torch/serving/engine.py": ("ServingEngine._emit_commit",),
}


# ---------------------------------------------------------------------------
# NPU kernel SRAM footprints (the paper's design point): a copy of JAX's
# registry.kernel_specs.  Per grid step: streamed in/out blocks are double
# buffered (x2); scratch and resident intermediates are single.  The
# production point is LLaDA-8B (d=4096, V=126464, d_head=128) at an
# 8-slot x L=32 engine batch.
# ---------------------------------------------------------------------------

# the ~4 MiB weight-slab cap of the fused head's vocab chunk, so the double
# buffered slab fits a ~16 MiB/core on-chip budget at production d
W_SLAB_CAP_BYTES = 4 * 1024 * 1024


def head_chunk_cap(d: int, itemsize: int) -> int:
    """The fused head's vocab-chunk cap."""
    return max(128, W_SLAB_CAP_BYTES // (d * itemsize))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str                       # public kernel entry
    point: Dict[str, int]           # production shape point
    buffers: Dict[str, int]         # buffer name -> bytes per instance
    double_buffered: Tuple[str, ...]  # names counted twice (pipelining)

    def footprint(self) -> Dict[str, int]:
        return {n: b * (2 if n in self.double_buffered else 1)
                for n, b in self.buffers.items()}

    @property
    def total_bytes(self) -> int:
        return sum(self.footprint().values())


def kernel_specs(d: int = 4096, v: int = 126464, d_head: int = 128,
                 batch: int = 8, n_heads: int = 32, seq: int = 4096,
                 block_len: int = 32) -> List[KernelSpec]:
    """Per-kernel on-chip accounting at the given scale (defaults: LLaDA-8B
    production serving).  Dtypes: bf16 staging (2 B), fp32 scratch and
    accumulators (4 B), int32 indices (4 B)."""
    bf16, f32, i32 = 2, 4, 4
    rows = batch * block_len                       # flattened (B*L, d)
    tile_r = 8

    chunk = min(512, head_chunk_cap(d, bf16), v)
    fused_head = KernelSpec(
        "fused_head_sampling",
        {"rows": rows, "d": d, "V": v, "tile_r": tile_r, "chunk_v": chunk},
        {
            "hidden_tile": tile_r * d * bf16,
            "w_slab": d * chunk * bf16,
            "out_conf": tile_r * f32,
            "out_token": tile_r * i32,
            "scratch": 5 * tile_r * f32,           # m/s/best/idx/carry rows
        },
        ("hidden_tile", "w_slab", "out_conf", "out_token"))

    sm_chunk = min(512, v)
    stablemax = KernelSpec(
        "stablemax_sampling",
        {"rows": rows, "V": v, "tile_r": tile_r, "chunk_v": sm_chunk},
        {
            "logit_tile": tile_r * sm_chunk * bf16,
            "out_conf": tile_r * f32,
            "out_token": tile_r * i32,
            "scratch": 3 * tile_r * f32,
        },
        ("logit_tile", "out_conf", "out_token"))

    topk = KernelSpec(
        "topk_mask",
        {"rows": rows, "L": block_len, "tile_r": tile_r},
        {
            "conf_tile": tile_r * block_len * f32,
            "mask_tile": tile_r * block_len * i32,
            "k_tile": tile_r * i32,
            "out_tile": tile_r * block_len * i32,
            "rank_matrix": tile_r * block_len * block_len * f32,
        },
        ("conf_tile", "mask_tile", "k_tile", "out_tile"))

    bq, bk = 128, min(512, seq)
    flash = KernelSpec(
        "flash_bidir",
        {"B": batch, "H": n_heads, "S": seq, "D": d_head,
         "bq": bq, "bk": bk},
        {
            "q_tile": bq * d_head * bf16,
            "k_tile": bk * d_head * bf16,
            "v_tile": bk * d_head * bf16,
            "calib": 3 * d_head * bf16,            # fk / fv / cv rows
            "out_tile": bq * d_head * bf16,
            "m_l_scratch": 2 * bq * f32,
            "acc_scratch": bq * d_head * f32,
        },
        ("q_tile", "k_tile", "v_tile", "calib", "out_tile"))

    tile_s = 128
    baos = KernelSpec(
        "baos_mx_quant",
        {"G": batch * n_heads, "S": seq, "D": d_head, "tile_s": tile_s},
        {
            "x_tile": tile_s * d_head * f32,
            "center": d_head * f32,
            "factor": d_head * f32,
            "out_tile": tile_s * d_head * f32,
        },
        ("x_tile", "center", "factor", "out_tile"))

    return [fused_head, stablemax, topk, flash, baos]


# band for the fused-head static footprint vs the cycle simulator's
# exact-fit allocator peak (JAX's registry.SRAM_CROSSVAL_BAND)
SRAM_CROSSVAL_BAND: Tuple[float, float] = (0.8, 1.25)


# ---------------------------------------------------------------------------
# Hopper shared memory per block: every kernel instantiation the port
# launches, with its static shared memory (the __shared__ arrays) and the
# dynamic shared memory its largest launch requests, mirroring the
# constexpr formulas of kernels/csrc/*.cu.  chip_smoke.py holds each
# figure against cudaFuncGetAttributes on the card
# (<library>_kernel_attrs).
# ---------------------------------------------------------------------------

# sm_90's opt-in limit of shared memory per block: 227 KB
SMEM_LIMIT_BYTES = 232448

FMTS_CU = ("FMT_NONE", "FMT_BF16", "FMT_MXFP8", "FMT_MXINT8", "FMT_MXINT4",
           "FMT_MXFP6", "FMT_MXFP4")
# the bf16 head route: FMT_BF16 shares FMT_NONE's instantiation
HEAD_FMTS_CU = ("FMT_NONE", "FMT_MXFP8", "FMT_MXINT8", "FMT_MXINT4",
                "FMT_MXFP6", "FMT_MXFP4")
PART_BYTES = 20           # Part / State: four f32 and one int


@dataclasses.dataclass(frozen=True)
class SmemSpec:
    library: str          # kernels/csrc/<library>.cu
    kernel: str           # the instantiation, as its attribute table names it
    static_bytes: int     # __shared__ arrays
    dynamic_bytes: int    # the largest launch's dynamic request

    @property
    def total_bytes(self) -> int:
        return self.static_bytes + self.dynamic_bytes


def _head_f32_static(rpt: int) -> int:
    tm, tk, tn = 16 * rpt, 32, 64
    return 4 * max(tk * (tm + 1) + tk * tn, tm * (tn + 1))


def _head_tc_dynamic() -> int:
    stages, bk, bn, rows = 2, 128, 256, 64
    return stages * (bk * (bn + 8) + rows * (bk + 8)) * 2


def _flash_f32_dynamic(dt: int) -> int:
    bq, bk = 16, 32
    return (bq * dt + bk * (dt + 1) + bk * dt) * 4


def _flash_tc_dynamic(dt: int, qs: int, warps: int) -> int:
    stages, bkv = 3, 32
    return (2 * stages * bkv + warps * qs * 16) * (dt + 8) * 2 + 3 * dt * 4


def _flash_tc_max_warps(dt: int, qs: int) -> int:
    w = 8
    while w > 1 and _flash_tc_dynamic(dt, qs, w) > SMEM_LIMIT_BYTES:
        w -= 1
    return w


def _bwd_dq_dynamic(dt: int) -> int:
    return (2 * 16 * dt + 2 * 32 * (dt + 1)) * 4


def _bwd_dkv_dynamic(dt: int) -> int:
    rc, bk = 16, 32
    return (2 * bk * (dt + 1) + 2 * rc * dt + 2 * rc * bk + 4 * rc) * 4


def smem_specs() -> List[SmemSpec]:
    """Every instantiation's shared memory per block, in the order of the
    libraries' attribute tables."""
    out: List[SmemSpec] = []
    lib = "fused_head_sampling"
    for rpt in (1, 2, 4, 8):
        out.append(SmemSpec(lib, f"head_partials_kernel<float, {rpt}>",
                            _head_f32_static(rpt), 0))
    for fmt in HEAD_FMTS_CU:
        out.append(SmemSpec(lib, f"head_partials_tc_kernel<{fmt}>",
                            4 * 64 * PART_BYTES, _head_tc_dynamic()))
    out += [SmemSpec(lib, "head_combine_kernel", 0, 0),
            SmemSpec(lib, "head_shard_merge_kernel", 0, 0)]
    lib = "stablemax_sampling"
    for t in ("float", "__nv_bfloat16"):
        for fmt in FMTS_CU:
            for g in ("false", "true"):
                out.append(SmemSpec(lib, f"stablemax_kernel<{t}, {fmt}, {g}>",
                                    8 * PART_BYTES, 0))
    out += [SmemSpec(lib, "stablemax_combine_kernel", 0, 0),
            SmemSpec(lib, "stablemax_shard_merge_kernel", 0, 0)]
    lib = "topk_mask"
    for kt in ("int", "long long"):
        out.append(SmemSpec(lib, f"topk_mask_kernel<{kt}>", 4 * 64 * 4, 0))
    for kt in ("int", "long long"):
        out.append(SmemSpec(lib, f"topk_mask_kernel_cta<{kt}>", 1024 * 4, 0))
    out.append(SmemSpec(lib, "empty_kernel", 0, 0))
    lib = "flash_bidir"
    for dpl in (1, 2, 4, 8):
        out.append(SmemSpec(lib, f"flash_bidir_kernel<float, {dpl}>", 0,
                            _flash_f32_dynamic(32 * dpl)))
    for dt in (32, 64, 128, 256):
        for qs, name in ((1, "1"), (3, "SPLIT")):
            out.append(SmemSpec(
                lib, f"flash_bidir_tc_kernel<{dt}, {name}>", 0,
                _flash_tc_dynamic(dt, qs, _flash_tc_max_warps(dt, qs))))
    lib = "flash_bidir_bwd"
    for t in ("float", "__nv_bfloat16"):
        for dpl in (1, 2, 4, 8):
            out.append(SmemSpec(lib, f"flash_bidir_bwd_dq<{t}, {dpl}>", 0,
                                _bwd_dq_dynamic(32 * dpl)))
            out.append(SmemSpec(lib, f"flash_bidir_bwd_dkv<{t}, {dpl}>", 0,
                                _bwd_dkv_dynamic(32 * dpl)))
    lib = "baos_mx_quant"
    for t in ("float", "__nv_bfloat16"):
        for fmt in FMTS_CU:
            out.append(SmemSpec(lib, f"baos_mx_quant_kernel<{t}, {fmt}>",
                                0, 0))
    return out


# ---------------------------------------------------------------------------
# Entry points for the graph audit (graph_audit.py).  ``build(device)``
# returns (fn, args) at smoke scale: on ``meta`` for the traced rules (no
# weight is allocated), on ``cpu`` for the in-place rule.  Budgets:
#   max_h2d / max_d2h - cross-device copies per call (host to device,
#             device to host): the per-tick upload and fetch bound;
#   mesh_axes - the only axis names its collectives may run on;
#   inplace - (argnum, outnum) pairs: output outnum (a tensor or a dict of
#             them) must be argument argnum's storage, written in place
#             (the port's counterpart of JAX's buffer donation).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EntryPoint:
    name: str
    build: Callable            # device -> (fn, args)
    max_h2d: int = 0
    max_d2h: int = 0
    mesh_axes: Tuple[str, ...] = ()
    inplace: Tuple[Tuple[int, int], ...] = ()
    kernel_only: bool = False  # a kernel launcher: the sync scan only


SMOKE_B, SMOKE_PROMPT, SMOKE_GEN, SMOKE_BLOCK = 2, 8, 16, 8


def _smoke(device, cache_mode: str = "none"):
    """(cfg, model, params, dcfg, common inputs) of the smoke llada-8b on
    ``device``: meta builds shapes only, cpu a seeded model."""
    import torch

    from repro_torch.configs import base
    from repro_torch.core import diffusion
    from repro_torch.models.registry import build_model

    cfg = base.get_config("llada-8b", smoke=True)
    model = build_model(cfg, device)
    params = model.init() if device == "meta" else model.init(0)
    dcfg = diffusion.DiffusionConfig(
        gen_length=SMOKE_GEN, block_length=SMOKE_BLOCK, steps_per_block=4,
        cache_mode=cache_mode, head_path="fused")
    B, s_tot = SMOKE_B, SMOKE_PROMPT + SMOKE_GEN
    x = torch.full((B, s_tot), cfg.mask_id, dtype=torch.int32,
                   device=device)
    common = dict(
        x=x, kv_valid=torch.ones((B, s_tot), dtype=torch.bool,
                                 device=device),
        bs=torch.full((B,), SMOKE_PROMPT, dtype=torch.int32, device=device),
        k=torch.full((B,), 2, dtype=torch.int32, device=device))
    return cfg, model, params, dcfg, common


def _tick_entry(cache_mode: str):
    def build(device):
        from repro_torch.core import diffusion
        cfg, model, params, dcfg, c = _smoke(device, cache_mode)
        cache = (model.init_cache(SMOKE_B, c["x"].shape[1])
                 if cache_mode != "none" else None)
        fn = diffusion.get_tick_fn(model, dcfg, cfg.mask_id,
                                   jit_steps=False)
        return fn, (params, c["x"], c["kv_valid"], c["bs"], c["k"], 3,
                    cache)
    return build


def _tick_forward(device):
    from repro_torch.core import diffusion
    cfg, model, params, dcfg, c = _smoke(device)

    def fn(params, x, kv_valid, bs):
        return diffusion.tick_forward(model, params, x, kv_valid, bs, None,
                                      dcfg)
    return fn, (params, c["x"], c["kv_valid"], c["bs"])


def _tick_sample(device):
    import torch

    from repro_torch.core import diffusion
    cfg, model, params, dcfg, c = _smoke(device)
    B, S = c["x"].shape
    feats = torch.zeros((B, S, cfg.d_model), dtype=cfg.torch_dtype,
                        device=device)

    def fn(params, feats, x, bs, k):
        return diffusion.tick_sample(params, feats, x, bs, k, 3, dcfg,
                                     cfg.mask_id, model)
    return fn, (params, feats, c["x"], c["bs"], c["k"])


def _warm_step(device):
    from repro_torch.core import diffusion
    cfg, model, params, dcfg, c = _smoke(device, "dual")
    cache = model.init_cache(SMOKE_B, c["x"].shape[1])

    def fn(params, x, cache):
        return diffusion.warm_step(model, params, x, cache, SMOKE_PROMPT,
                                   dcfg)
    return fn, (params, c["x"], cache)


def _refine_step(device):
    from repro_torch.core import diffusion
    cfg, model, params, dcfg, c = _smoke(device, "dual")
    cache = model.init_cache(SMOKE_B, c["x"].shape[1])

    def fn(params, x, cache):
        return diffusion.refine_step(model, params, x, cache, SMOKE_PROMPT,
                                     dcfg)
    return fn, (params, c["x"], cache)


def _megatick(mesh_shape=None):
    def build(device):
        import numpy as np

        from repro_torch.core import diffusion
        from repro_torch.launch import mesh as mesh_lib
        cfg, model, params, dcfg, c = _smoke(device)
        mesh = None
        if mesh_shape is not None:
            mesh = mesh_lib.shape_mesh(*mesh_shape)
            params = diffusion.place_spmd_params(params, mesh)
        mt = diffusion.Megatick(model, dcfg, cfg.mask_id, 4,
                                jit_steps=False, mesh=mesh)
        zeros = np.full((SMOKE_B,), SMOKE_PROMPT, np.int32)
        state = diffusion.megatick_state(
            zeros, np.full((SMOKE_B,), 2, np.int32), dcfg,
            device=c["x"].device)
        if device == "meta" or mesh is not None:
            # the graphed step itself: one predicated tick on its buffers
            carry = mt._carry_for(c["x"])
            return mt._tick, (params, c["x"], c["kv_valid"], None,
                              carry["scalars"], carry["state"],
                              carry["bufs"], carry["ksched"])
        return mt, (params, c["x"], c["kv_valid"], state, 0, 2, False,
                    None, 5)
    return build


def _paged_tick(device):
    import torch

    from repro_torch.core import diffusion
    cfg, model, params, dcfg, c = _smoke(device)
    ps, s_tot = 8, c["x"].shape[1]
    R = s_tot // ps
    pages = torch.full((1 + SMOKE_B * R, ps), cfg.mask_id,
                       dtype=torch.int32, device=device)
    table = (1 + torch.arange(SMOKE_B * R, dtype=torch.int32,
                              device=device)).reshape(SMOKE_B, R)
    fn = diffusion.get_paged_tick_fn(model, dcfg, cfg.mask_id, ps, s_tot,
                                     with_cache=False, jit_steps=False)
    return fn, (params, pages, None, table, table, c["kv_valid"], c["bs"],
                c["k"], 3)


def _spmd_tick(device):
    from repro_torch.core import diffusion
    from repro_torch.launch import mesh as mesh_lib
    cfg, model, params, dcfg, c = _smoke(device)
    mesh = mesh_lib.shape_mesh(2, 2)
    tick = diffusion.get_spmd_tick_fn(model, dcfg, cfg.mask_id, mesh,
                                      jit_steps=False)
    return tick, (diffusion.place_spmd_params(params, mesh), c["x"],
                  c["kv_valid"], c["bs"], c["k"], 3, None)


def _kernel(name: str):
    def build(device):
        import torch

        from repro_torch.kernels import (baos_mx_quant, flash_bidir,
                                         fused_head_sampling,
                                         stablemax_sampling, topk_mask)
        f32 = torch.float32

        def t(*shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=device)
        d, v, dh = 64, 257, 16
        return {
            "fused_head_sampling": (fused_head_sampling.fused_head_sampling,
                                    (t(16, d), t(d, v))),
            "stablemax_sampling": (stablemax_sampling.stablemax_sampling,
                                   (t(16, v),)),
            "topk_mask": (topk_mask.topk_mask,
                          (t(4, 8), t(4, 8, dtype=torch.bool),
                           t(4, dtype=torch.int32))),
            "baos_mx_quant": (baos_mx_quant.baos_mx_quant,
                              (t(2, 128, 2, 32), t(2, 1, 2, 32),
                               t(2, 1, 2, 32))),
            "flash_bidir": (flash_bidir.flash_bidir,
                            (t(1, 32, 4, dh), t(1, 32, 4, dh),
                             t(1, 32, 4, dh))),
        }[name]
    return build


def entry_points() -> List[EntryPoint]:
    """Every registered entry point (built lazily by ``build``)."""
    eps = [
        EntryPoint("tick_forward", _tick_forward),
        EntryPoint("tick_sample", _tick_sample),
        EntryPoint("batched_tick", _tick_entry("none")),
        EntryPoint("batched_tick_warm", _tick_entry("dual"),
                   inplace=((6, 1),)),          # the cache, rewritten
        EntryPoint("warm_step", _warm_step, inplace=((2, 1),)),
        EntryPoint("refine_step", _refine_step),
        EntryPoint("spmd_tick", _spmd_tick, mesh_axes=("data", "model")),
        EntryPoint("megatick", _megatick(), inplace=((1, 0),)),
        EntryPoint("megatick_mesh", _megatick((2, 2)),
                   mesh_axes=("data", "model")),
        EntryPoint("paged_tick", _paged_tick, inplace=((1, 0),)),
    ]
    for name in ("fused_head_sampling", "stablemax_sampling", "topk_mask",
                 "baos_mx_quant", "flash_bidir"):
        eps.append(EntryPoint(f"kernels.{name}", _kernel(name),
                              kernel_only=True))
    return eps


# aten ops that read a tensor's value on the host, or whose output shape
# depends on its values: a sync inside an entry point (and inside a CUDA
# graph capture, an error)
SYNC_OPS: Tuple[str, ...] = (
    "_local_scalar_dense", "nonzero", "masked_select", "index(mask)",
    "unique_dim",
    "_unique", "_unique2", "unique_consecutive", "argwhere",
    "repeat_interleave",
)

# CUDA-graph capture bounds over the representative engine shape trace
# (graph_audit.check_recapture): graphs captured per graphed step.  A mixed
# k_req, both stop flags and fresh seeds are device operands and capture
# nothing new; only a new live batch shape may.
RECAPTURE_BOUNDS: Dict[str, int] = {
    "megatick": 1,
    "megatick_mesh": 1,
    "tick": 2,          # one per distinct live batch shape in the replay
}
