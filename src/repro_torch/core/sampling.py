"""Diffusion sampling stage (paper §3.2, Alg. 2), ported from
src/repro/core/sampling.py.

Per masked position, over the vocabulary logit vector z:
Stable-Max m = max z, i* = argmax z, conf = 1 / sum_j exp(z_j - m), then a
top-k over the block's positions and the masked commit.  Two head paths
feed it.  ``fused_sampling_step_full`` streams hidden states through the
fused LM-head kernel (kernels/fused_head_sampling.py), so the vocab-wide
logits are never stored.  ``sampling_step_full`` takes stored logits (the
unfused and legacy head paths) through ``stable_max``, one launch of
kernels/stablemax_sampling.py.  The top-k runs in kernels/topk_mask.py.
Each kernel module holds the plain PyTorch version the CPU runs.

Sampling precision (paper Fig. 1 / §6.1) is any format of core/mx.FORMATS
(names and aliases): the logits are fake-quantized to it before the
reductions, by the kernels on the card.  The transfer strategy is
"stablemax" (the highest-confidence positions commit) or "random" (a
uniform draw orders the selection; conf stays the Stable-Max conf).

Over a mesh (launch/mesh.py) the LM head's columns shard over the
``model`` axis: ``sharded_fused_sampling_step_full`` reduces this rank's
shard to per-row (m, idx, s) partials (the fused head's shard entry) and
``combine_partials`` merges them with one all_reduce MAX, SUM and MIN.
Every noise draw is indexed by the *global* row and column: a step over a
data shard passes ``row_offset`` (the flattened B * L index of its first
row) and a vocab shard draws at its global columns, so a sampled step on
any mesh draws what one device draws (GSPMD's partition of JAX's global
draw).  A sampled shard adds (best score, logit at its index) to its
partials, and the combine takes the token from the shard holding the best
score.

The trace hooks (sim/trace.py) record what the paper's NPU would execute
for each call, with JAX's op groups from the same places: ``stable_max``,
``head_logits``, the fused step's streamed head (emitted once with the
chunk count of ``_chunk_grid``), ``topk_transfer_mask`` and
``_select_and_commit``.  They are no-ops unless a tracer is active.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import mx
from repro_torch.sim import isa as isa_lib
from repro_torch.sim import trace as trace_lib

NEG_INF = -1e30
MASK32 = 0xFFFFFFFF
STRATEGIES = ("stablemax", "random")
# a counter-Gumbel seed: a uint32 int, or an int64 tensor holding one (the
# form a captured CUDA graph reads from device memory at every replay)
Seed = Union[int, torch.Tensor]
# Modeled storage format of the LM-head weight stream in traces (matches
# sim/analytical's w_bytes=0.5 MXINT4 default)
TRACE_W_FMT = "mxint4"
# the random strategy's draw: a counter stream apart from the Gumbel noise
# that the same tick seed drives ("RAND")
RANDOM_SALT = 0x52414E44


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    fmt: str = "mxfp8_e4m3"     # sampling precision: any core/mx format
    temperature: float = 0.0     # 0 => greedy (LLaDA reference)
    strategy: str = "stablemax"  # "stablemax" (low-confidence) | "random"
    suppress_mask_token: bool = True  # never sample the mask id itself


def check_supported(cfg: SamplingConfig) -> None:
    """ValueError for a format core/mx does not know or an unknown
    strategy; every other configuration runs."""
    mx.fmt_code(cfg.fmt)
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown sampling strategy {cfg.strategy!r}; "
                         f"expected one of {STRATEGIES}")


def _rows_of(a: torch.Tensor) -> int:
    """The product of the leading (non-vocab) dims, for trace hooks."""
    return int(math.prod(a.shape[:-1]))


def _emit_head_stream(R: int, d: int, chunk: int, n_chunks: int,
                      gumbel: bool = False) -> None:
    """Trace hook for the streamed-head chunk loop, emitted once by the
    caller with the chunk count of ``_chunk_grid`` (the loop itself runs
    under ``trace_lib.suppress()``).  One vocab chunk = weight slab burst
    into SRAM, matrix-unit logit tile, online (max+idx, exp, sum)
    reduction, carry rescale; the slab and logit tile are alloc/freed
    every chunk so the simulator's allocator observes the in-place
    reuse."""
    trace_lib.emit("HBM_RD", (R, d), "bf16", "stream", "hidden")
    trace_lib.emit("SRAM_ALLOC", (3, R), "fp32", "stream", "carry")
    for _ in range(n_chunks):
        trace_lib.emit("SRAM_ALLOC", (d, chunk), TRACE_W_FMT, "stream",
                       "w_slab")
        trace_lib.emit("HBM_RD", (d, chunk), TRACE_W_FMT, "stream", "head_w")
        trace_lib.emit("SRAM_ALLOC", (isa_lib.TILE_R, chunk), "fp32",
                       "stream", "logit_tile")
        trace_lib.emit("GEMM_TILE", (R, d, chunk), stage="stream")
        trace_lib.emit("V_RED_MAX_IDX", (R, chunk), stage="stream")
        trace_lib.emit("V_EXP_V", (R, chunk), stage="stream")
        trace_lib.emit("V_RED_SUM", (R, chunk), stage="stream")
        if gumbel:
            trace_lib.emit("V_GUMBEL", (R, chunk), stage="stream")
            trace_lib.emit("V_ADD_VV", (R, chunk), stage="stream",
                           note="gumbel_score")
            trace_lib.emit("V_RED_MAX", (R, chunk), stage="stream",
                           note="best_score")
            trace_lib.emit("V_SELECT_INT", (3, R), stage="stream",
                           note="best_update")
        trace_lib.emit("V_ADD_VV", (R,), stage="stream",
                       note="online_rescale")
        trace_lib.emit("SRAM_FREE", stage="stream", note="logit_tile")
        trace_lib.emit("SRAM_FREE", stage="stream", note="w_slab")
    trace_lib.emit("SRAM_FREE", stage="stream", note="carry")


# ---------------------------------------------------------------------------
# LM head and the counter-based Gumbel stream
# ---------------------------------------------------------------------------

def head_logits(hidden: torch.Tensor, w_head: torch.Tensor, *,
                logit_scale: float = 1.0, quant=None) -> torch.Tensor:
    """hidden (..., d) @ w_head (d, V) -> logits (..., V) in hidden.dtype:
    the ``quant`` policy's (models/layers.QuantPolicy) fake-quant of both
    operands when enabled, f32 accumulation, one rounding to the activation
    dtype, then x logit_scale in that dtype (the scale rounds to it first,
    as a weakly typed Python float does in JAX)."""
    if trace_lib.is_active():
        M, K, N = _rows_of(hidden), hidden.shape[-1], w_head.shape[-1]
        trace_lib.emit("HBM_RD", (M, K), "bf16", "head", "hidden")
        trace_lib.emit("HBM_RD", (K, N), TRACE_W_FMT, "head", "head_w")
        trace_lib.emit("GEMM_TILE", (M, K, N), stage="head")
        trace_lib.emit("HBM_WR", (M, N), "bf16", "head", "logits")
    if quant is not None and quant.enabled:
        hidden, w_head = quant.acts(hidden), quant.weights(w_head)
    dt = hidden.dtype
    z = torch.matmul(hidden, w_head.to(dt))
    # torch.full, not torch.tensor: a fill needs no host-to-device copy,
    # which a CUDA graph capture would refuse
    return z * torch.full((), logit_scale, dtype=dt, device=z.device)


def _chunk_grid(V: int, chunk_v: int) -> Tuple[int, int]:
    """(chunk, padded V): chunks are rounded down to multiples of the MX
    block (min one block) so per-chunk fake-quant sees exactly the 32-wide
    blocks full-row fake-quant sees."""
    chunk_v = max(mx.MX_BLOCK, chunk_v - chunk_v % mx.MX_BLOCK)
    ceil32 = -(-V // mx.MX_BLOCK) * mx.MX_BLOCK
    chunk = min(chunk_v, ceil32)
    return chunk, -(-V // chunk) * chunk


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split c in 16-bit halves
    so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style uint32 finalizer on int64 tensors holding uint32
    values (the JAX reference's uint32 wraparound, exactly)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def seed_tensor(seed: Seed, device) -> torch.Tensor:
    """``seed`` as the one-element int64 device tensor the sampling kernels
    read: a tensor passes through (checked), an int is filled in (a fill,
    no host-to-device copy)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 or \
                seed.device != torch.device(device):
            raise ValueError(f"a seed tensor must be one int64 on {device}; "
                             f"got {seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
        return seed
    return torch.full((1,), int(seed) & MASK32, dtype=torch.int64,
                      device=device)


def _seed_bits(seed: Seed):
    """A seed's uint32 bits: an int, or an int64 tensor broadcasting as a
    scalar."""
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int64).reshape(()) & MASK32
    return int(seed) & MASK32


def counter_uniform(seed: Seed, rows: torch.Tensor, cols: torch.Tensor
                    ) -> torch.Tensor:
    """The uniform u in (0, 1] behind ``counter_gumbel``: a hash of
    (seed, row, col), f32; ``seed`` an int or a tensor (``Seed``)."""
    rows = rows.to(torch.int64) & MASK32
    cols = cols.to(torch.int64) & MASK32
    h = _mix32(_mul32(rows, 0x9E3779B9) ^ _seed_bits(seed))
    h = _mix32(h ^ _mul32(cols, 0x85EBCA6B))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def counter_gumbel(seed: Seed, rows: torch.Tensor, cols: torch.Tensor
                   ) -> torch.Tensor:
    """Deterministic counter-based Gumbel(0,1) noise g(seed, row, col), the
    stream the fused-head kernel regenerates tile by tile."""
    u = counter_uniform(seed, rows, cols)
    return -torch.log(-torch.log(u))


def selection_seed(seed: Seed) -> Seed:
    """The seed of the random strategy's draw, _mix32(seed ^ RANDOM_SALT):
    derived from the tick seed and apart from its Gumbel stream.  A tensor
    seed gives a tensor, computed where it lies."""
    if isinstance(seed, torch.Tensor):
        return _mix32(_seed_bits(seed) ^ RANDOM_SALT)
    return int(_mix32(torch.tensor((int(seed) & MASK32) ^ RANDOM_SALT)))


def random_select(seed: Seed, shape: Tuple[int, int], device,
                  row_offset: int = 0) -> torch.Tensor:
    """The random strategy's selection key for a (B, L) block: a uniform
    in (0, 1] per position, ``counter_uniform`` on ``selection_seed(seed)``
    at (row row_offset + b, column l): ``row_offset`` is the global batch
    row of row 0 (a data shard's first).  A seed tensor is read from device
    memory, so a replayed graph draws each tick's.  (JAX draws
    ``jax.random.uniform(rng)``: the two packages select differently.)"""
    B, L = shape
    rows = torch.arange(B, device=device)[:, None]
    if row_offset:
        rows = rows + row_offset
    cols = torch.arange(L, device=device)[None, :]
    return counter_uniform(selection_seed(seed), rows, cols)


# ---------------------------------------------------------------------------
# Top-k transfer mask + commit
# ---------------------------------------------------------------------------

def topk_transfer_mask(conf: torch.Tensor, mask_idx: torch.Tensor,
                       k: torch.Tensor) -> torch.Tensor:
    """conf (B, L) float; mask_idx (B, L) bool (True = still masked);
    k (B,) int -> transfer mask (B, L) bool with exactly min(k, #masked)
    True entries per row, at the highest-confidence masked positions
    (ties toward the lower index).  On the card this is one launch: the
    kernel takes f32 conf, the bool mask and k as they come."""
    from repro_torch.kernels import topk_mask   # lazy: kernels import core
    if trace_lib.is_active():
        B, L = conf.shape
        trace_lib.emit("S_MAP_V_FP", (B * L,), stage="commit")
        trace_lib.emit("V_TOPK_MASK_PER_ELT", (B * L,), stage="commit")
    return topk_mask.topk_mask(conf, mask_idx, k)


def commit_tokens(x: torch.Tensor, x0: torch.Tensor, transfer: torch.Tensor
                  ) -> torch.Tensor:
    """Phase 4 integer masked update: commit sampled tokens where selected."""
    return torch.where(transfer, x0, x)


def _select_and_commit(conf, x0, x, m_idx, k, cfg: SamplingConfig,
                       seed: Optional[Seed], row_offset: int = 0):
    """Shared tail of the fused and unfused sampling steps: transfer
    selection (the Stable-Max conf, or under strategy 'random' the
    uniform draw of ``random_select`` at the block's global rows: the
    flattened ``row_offset`` over L), top-k mask, masked commit."""
    select = conf
    if cfg.strategy == "random":
        if seed is None:
            raise ValueError(
                "strategy='random' requires a seed: without one every call "
                "would reuse the identical transfer order")
        select = random_select(seed, tuple(conf.shape), conf.device,
                               row_offset // conf.shape[-1])
    x0 = torch.where(m_idx, x0, x)                 # keep committed tokens
    transfer = topk_transfer_mask(select, m_idx, k)
    if trace_lib.is_active():
        trace_lib.emit("V_SELECT_INT", (2 * int(math.prod(x.shape)),),
                       stage="commit")
    return commit_tokens(x, x0, transfer), transfer, conf


def stable_max(logits: torch.Tensor, fmt: str = "none",
               seed: Optional[Seed] = None, temperature: float = 0.0,
               suppress_id: Optional[int] = None, row_offset: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., V) -> (conf (...) f32, token (...) int32): the sampling
    fake-quant, the suppressed id masked after it, Stable-Max.  With
    temperature > 0 and a ``seed`` the token is the counter-Gumbel argmax
    (the stream the fused head draws, at global flattened rows
    ``row_offset`` onward; JAX draws jax.random.gumbel here) and conf the
    softmax probability of that token."""
    from repro_torch.kernels import stablemax_sampling as sms   # lazy
    *lead, V = logits.shape
    temp = temperature if seed is not None else 0.0
    if trace_lib.is_active():
        rows = _rows_of(logits)
        trace_lib.emit("HBM_RD", (rows, V), fmt, "stream", "logits")
        trace_lib.emit("SRAM_ALLOC", (3, rows), "fp32", "stream", "carry")
        if temp > 0.0:
            trace_lib.emit("V_GUMBEL", (rows, V), stage="stream")
            trace_lib.emit("V_ADD_VV", (rows, V), stage="stream",
                           note="gumbel_score")
        trace_lib.emit("V_RED_MAX_IDX", (rows, V), stage="stream")
        trace_lib.emit("V_EXP_V", (rows, V), stage="stream")
        trace_lib.emit("V_RED_SUM", (rows, V), stage="stream")
        trace_lib.emit("SRAM_FREE", stage="stream", note="carry")
        trace_lib.emit("S_RECIP", (rows,), stage="tail")
        trace_lib.emit("S_ST", (2 * rows,), stage="tail", note="conf_idx_wb")
    conf, idx = sms.stablemax_sampling(
        logits.reshape(-1, V).contiguous(), fmt=fmt, suppress_id=suppress_id,
        temperature=temp, seed=0 if seed is None else seed,
        row_offset=row_offset)
    return conf.reshape(lead), idx.reshape(lead)


def stable_max_two_pass(logits: torch.Tensor, fmt: str = "none"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's phase structure: pass 1 = V_RED_MAX_IDX, pass 2 =
    V_EXP_V + V_RED_SUM, then S_RECIP.  Numerically identical to greedy
    ``stable_max`` without suppression; kept separate because the
    analytical model charges it 2x logit reads (the single-pass kernel
    reads once).  Plain PyTorch, as JAX's is jnp."""
    z = mx.mx_fake_quant(logits, fmt).to(torch.float32)
    m = torch.amax(z, dim=-1)                              # pass 1a
    idx = torch.argmax(z, dim=-1).to(torch.int32)          # pass 1b
    s = torch.sum(torch.exp(z - m[..., None]), dim=-1)     # pass 2
    return 1.0 / s, idx


def sampling_step_full(logits: torch.Tensor, x: torch.Tensor, mask_id: int,
                       k: torch.Tensor, cfg: SamplingConfig,
                       seed: Optional[Seed] = None, row_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sampling stage on stored logits (B, L, V): Stable-Max (the CUDA
    kernel on the card), then top-k and commit.  Returns (new tokens
    (B, L), transfer (B, L), conf (B, L)); conf is the Stable-Max conf of
    the sampled tokens under either strategy.  Greedy without a
    ``seed``; strategy 'random' needs one (ValueError).  ``row_offset``
    is the global flattened (B * L) row of row 0, where the noise is
    drawn (a data shard's first row)."""
    check_supported(cfg)
    sup = mask_id if cfg.suppress_mask_token else None
    conf, x0 = stable_max(logits, cfg.fmt, seed, cfg.temperature,
                          suppress_id=sup, row_offset=row_offset)
    return _select_and_commit(conf, x0, x, x == mask_id, k, cfg, seed,
                              row_offset)


def fused_sampling_step_full(hidden: torch.Tensor, w_head: torch.Tensor,
                             x: torch.Tensor, mask_id: int, k: torch.Tensor,
                             cfg: SamplingConfig, seed: Optional[Seed] = None,
                             *, logit_scale: float = 1.0, quant=None,
                             chunk_v: int = 4096, row_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """One sampling stage fed by active-block hidden states: hidden
    (B, L, d) and w_head (d, V) stream through the fused head + Stable-Max
    (the CUDA kernel on the card, in every sampling format), then top-k
    and commit.  Returns (new tokens (B, L), transfer (B, L), conf (B, L)).
    ``seed`` (uint32) feeds the counter-Gumbel stream when
    cfg.temperature > 0 and the random strategy's draw; without one the
    step is greedy, as the JAX reference is without an rng.  ``chunk_v``
    is the vocab chunk of the plain version's stream and of the trace (the
    kernel tiles the vocab its own way).  An enabled ``quant`` policy
    fake-quantizes the hidden states and the head before the kernel, as
    JAX does before its Pallas kernel; the head's fake-quant runs on its
    padded rows (fused_head_sampling.head_storage), so the kernel reads
    the padded layout.  ``row_offset`` is the global flattened row of row
    0, where the noise is drawn (a data shard's first row)."""
    from repro_torch.kernels import fused_head_sampling as fhs   # lazy
    check_supported(cfg)
    if quant is not None and quant.enabled:
        V = w_head.shape[1]
        hidden = quant.acts(hidden)
        w_head = quant.weights(fhs.head_storage(w_head))[:, :V]
    B, L, d = hidden.shape
    R = B * L
    m_idx = x == mask_id
    sup = mask_id if cfg.suppress_mask_token else None
    temp = cfg.temperature if seed is not None else 0.0
    if trace_lib.is_active():
        chunk, Vp = _chunk_grid(w_head.shape[-1], chunk_v)
        _emit_head_stream(R, d, chunk, Vp // chunk, gumbel=temp > 0.0)
        trace_lib.emit("S_RECIP", (R,), stage="tail")
        trace_lib.emit("S_ST", (2 * R,), stage="tail", note="conf_idx_wb")
    with trace_lib.suppress():
        conf, x0 = fhs.fused_head_sampling(
            hidden.reshape(R, d), w_head, fmt=cfg.fmt,
            logit_scale=logit_scale, suppress_id=sup, temperature=temp,
            seed=0 if seed is None else seed, chunk_v=chunk_v,
            row_offset=row_offset)
    return _select_and_commit(conf.reshape(B, L), x0.reshape(B, L), x,
                              m_idx, k, cfg, seed, row_offset)


def sampling_step(logits: torch.Tensor, x: torch.Tensor, mask_id: int,
                  k: torch.Tensor, cfg: SamplingConfig,
                  seed: Optional[Seed] = None, row_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """As ``sampling_step_full`` without the confidence output."""
    new_x, transfer, _ = sampling_step_full(logits, x, mask_id, k, cfg, seed,
                                            row_offset)
    return new_x, transfer


def full_softmax_reference(logits: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The naive Eq. 2 path (materializes the V-wide probability vector);
    used only to validate Stable-Max equivalence in tests."""
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.argmax(logits, dim=-1).to(torch.int32)
    conf = torch.gather(p, -1, idx[..., None].to(torch.int64))[..., 0]
    return conf, idx


# ---------------------------------------------------------------------------
# Vocab-sharded Stable-Max: the LM head's columns split over a mesh axis
# (launch/mesh.py; JAX's shard_map axis 'model').  Each rank reduces its
# (d, V/n) shard to per-row (m, global idx, s) partials, and one max, one
# sum and one min over the axis merge them.  A sampled shard (temperature
# > 0 with a seed) adds (best, z_at): the best Gumbel score z/T + g of its
# columns, the noise drawn at the global row and column, and the logit at
# its index; the merge then takes the lowest index among the shards
# holding the best score, and conf = e^(z_at - m) / S from that shard.
# ---------------------------------------------------------------------------

BIG_INDEX = 1 << 30


def _sampled(temperature: float, seed: Optional[Seed]) -> float:
    """The temperature a step samples at: 0 (greedy) without a seed."""
    return temperature if seed is not None else 0.0


def local_partials(logits_shard: torch.Tensor, fmt: str = "none", *,
                   col_offset: int = 0, suppress_id: Optional[int] = None,
                   temperature: float = 0.0, seed: Seed = 0,
                   row_offset: int = 0) -> Tuple[torch.Tensor, ...]:
    """Per-shard partials of stored logits (..., V_loc) whose first column
    is global column ``col_offset``: (m, idx + col_offset, s) with s
    relative to m, ``suppress_id`` (a global column) masked after the
    fake-quant on the shard that holds it.  With temperature > 0: (m, idx,
    s, best, z_at), idx the first column of the best score z/T + g, the
    noise at the global (flattened row ``row_offset`` + r, column).  Plain
    PyTorch, as JAX's is jnp."""
    z = mx.mx_fake_quant(logits_shard, fmt).to(torch.float32)
    col = torch.arange(z.shape[-1], device=z.device)
    if suppress_id is not None and \
            0 <= suppress_id - col_offset < z.shape[-1]:
        z = torch.where(col == suppress_id - col_offset, NEG_INF, z)
    m = torch.amax(z, dim=-1)
    s = torch.sum(torch.exp(z - m[..., None]), dim=-1)
    if temperature <= 0.0:
        idx = torch.argmax(z, dim=-1).to(torch.int32) + col_offset
        return m, idx, s
    lead = z.shape[:-1]
    z2 = z.reshape(-1, z.shape[-1])
    rows = torch.arange(z2.shape[0], device=z.device)[:, None] + row_offset
    sc = z2 / temperature + counter_gumbel(seed, rows,
                                           col[None, :] + col_offset)
    best, i = torch.max(sc, dim=-1)                   # first occurrence
    z_at = torch.gather(z2, 1, i[:, None])[:, 0]
    return (m, (i.to(torch.int32) + col_offset).reshape(lead), s,
            best.reshape(lead), z_at.reshape(lead))


def combine_partials(m: torch.Tensor, gidx: torch.Tensor, s: torch.Tensor,
                     axis, best: Optional[torch.Tensor] = None,
                     z_at: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard (m, global idx, s) Stable-Max partials over
    ``axis`` (a launch/mesh.Axis, JAX's ``axis_name``): m = max_i m_i,
    S = sum_i S_i e^(m_i - m), the index from the shard holding the global
    max (the lowest index among ties).  One all_reduce MAX, one SUM and one
    MIN of per-row scalars.  Returns (conf = 1/S, idx int32).  With a
    sampled shard's ``best`` and ``z_at``: the index is the lowest among
    the shards holding the best score, and conf = e^(z_at - m) / S with
    that shard's z_at (two more all_reduces, MAX and MAX)."""
    from repro_torch.launch import mesh as mesh_lib   # lazy: launch -> core
    if trace_lib.is_active():
        trace_lib.emit_combine(int(math.prod(m.shape)))
    gm = mesh_lib.all_reduce(m, "max", axis)
    gs = mesh_lib.all_reduce(s * torch.exp(m - gm), "sum", axis)
    key = m if best is None else best
    top = gm if best is None else mesh_lib.all_reduce(best, "max", axis)
    cand = torch.where(key >= top, gidx.to(torch.int32),
                       torch.full_like(gidx, BIG_INDEX, dtype=torch.int32))
    gi = mesh_lib.all_reduce(cand, "min", axis)
    if best is None:
        return 1.0 / gs, gi.to(torch.int32)
    zw = mesh_lib.all_reduce(torch.where(
        gidx.to(torch.int32) == gi, z_at,
        torch.full_like(z_at, -float("inf"))), "max", axis)
    return torch.exp(zw - gm) / gs, gi.to(torch.int32)


def sharded_stable_max(logits_shard: torch.Tensor, axis, fmt: str = "none"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-Max over a vocab sharded on ``axis``: this rank's
    ``local_partials`` with global indices (shard x V_loc), then
    ``combine_partials``."""
    vloc = logits_shard.shape[-1]
    m, idx, s = local_partials(logits_shard, fmt,
                               col_offset=axis.index * vloc)
    return combine_partials(m, idx, s, axis)


def _combine(parts, axis):
    """``combine_partials`` of a shard entry's 3 (greedy) or 5 (sampled)
    partials."""
    m, gidx, s, *sampled = parts
    return combine_partials(m, gidx, s, axis, *sampled)


def sharded_sampling_step_full(logits_shard: torch.Tensor, x: torch.Tensor,
                               mask_id: int, k: torch.Tensor,
                               cfg: SamplingConfig,
                               seed: Optional[Seed] = None, *, axis,
                               row_offset: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``sampling_step_full`` on stored logits whose columns are sharded
    on ``axis`` (B, L, V / n), each shard a whole number of MX blocks:
    this rank's partials through Stable-Max's vocab-shard entry
    (kernels/stablemax_sampling.stablemax_shard_partials, route C: the
    CUDA kernel on the card), ``combine_partials``, then the transfer
    selection and commit (the same on every rank of the axis).  Samples
    as the single-device step does (temperature > 0 with a seed, either
    strategy), the noise at the global rows (``row_offset`` onward) and
    columns."""
    from repro_torch.kernels import stablemax_sampling as sms   # lazy
    check_supported(cfg)
    *lead, vloc = logits_shard.shape
    sup = mask_id if cfg.suppress_mask_token else None
    parts = sms.stablemax_shard_partials(
        logits_shard.reshape(-1, vloc).contiguous(), fmt=cfg.fmt,
        col_offset=axis.index * vloc, suppress_id=sup,
        temperature=_sampled(cfg.temperature, seed),
        seed=0 if seed is None else seed, row_offset=row_offset)
    conf, x0 = _combine(parts, axis)
    return _select_and_commit(conf.reshape(lead), x0.reshape(lead), x,
                              x == mask_id, k, cfg, seed, row_offset)


def sharded_fused_head_stable_max(hidden: torch.Tensor,
                                  w_shard: torch.Tensor, axis,
                                  fmt: str = "none", *,
                                  logit_scale: float = 1.0,
                                  suppress_id: Optional[int] = None,
                                  chunk_v: int = 4096, quant=None,
                                  col_limit: Optional[int] = None,
                                  temperature: float = 0.0, seed: Seed = 0,
                                  row_offset: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused head + Stable-Max with the head's columns sharded on
    ``axis``: this rank's (d, V_loc) shard (``w_shard``, column offset
    axis.index * V_loc) through the fused head's shard entry
    (kernels/fused_head_sampling.head_shard_partials: the CUDA kernel on
    the card), then ``combine_partials``.  ``col_limit`` masks the pad
    columns of ``pad_head_for_mesh``.  With temperature > 0 the token is
    the counter-Gumbel argmax at the global rows (``row_offset`` onward)
    and columns.  hidden (..., d) -> (conf (...), token (...))."""
    from repro_torch.kernels import fused_head_sampling as fhs   # lazy
    *lead, d = hidden.shape
    h = hidden.reshape(-1, d)
    if quant is not None and quant.enabled:
        h, w_shard = quant.acts(h), quant.weights(w_shard)
    vloc = w_shard.shape[-1]
    R = h.shape[0]
    if trace_lib.is_active():
        chunk, Vp = _chunk_grid(vloc, chunk_v)
        _emit_head_stream(R, d, chunk, Vp // chunk,
                          gumbel=temperature > 0.0)
    with trace_lib.suppress():
        parts = fhs.head_shard_partials(
            h, w_shard, fmt=fmt, logit_scale=logit_scale,
            col_offset=axis.index * vloc, col_limit=col_limit,
            suppress_id=suppress_id, chunk_v=chunk_v,
            temperature=temperature, seed=seed, row_offset=row_offset)
    conf, idx = _combine(parts, axis)
    if trace_lib.is_active():
        trace_lib.emit("S_ST", (2 * R,), stage="tail", note="conf_idx_wb")
    return conf.reshape(lead), idx.reshape(lead)


def sharded_fused_sampling_step_full(hidden: torch.Tensor,
                                     w_shard: torch.Tensor, x: torch.Tensor,
                                     mask_id: int, k: torch.Tensor,
                                     cfg: SamplingConfig,
                                     seed: Optional[Seed] = None, *, axis,
                                     logit_scale: float = 1.0, quant=None,
                                     chunk_v: int = 4096,
                                     col_limit: Optional[int] = None,
                                     row_offset: int = 0
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """``fused_sampling_step_full`` with the LM head column-sharded on
    ``axis``: per-shard partials, the combine, then the transfer selection
    and commit (the same on every rank of the axis).  Samples as the
    single-device step does, the noise at the global rows (``row_offset``
    onward) and columns."""
    check_supported(cfg)
    m_idx = x == mask_id
    sup = mask_id if cfg.suppress_mask_token else None
    conf, x0 = sharded_fused_head_stable_max(
        hidden, w_shard, axis, cfg.fmt, logit_scale=logit_scale,
        suppress_id=sup, chunk_v=chunk_v, quant=quant, col_limit=col_limit,
        temperature=_sampled(cfg.temperature, seed),
        seed=0 if seed is None else seed, row_offset=row_offset)
    return _select_and_commit(conf, x0, x, m_idx, k, cfg, seed, row_offset)


# ---------------------------------------------------------------------------
# The per-shard head math: pad_head_for_mesh and the streamed partials of
# one shard (JAX's jnp oracle; the kernel's plain version restricts it)
# ---------------------------------------------------------------------------

def pad_head_for_mesh(w_head: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Zero-pad the (d, V) LM head so it splits into ``n_shards`` equal
    vocab shards whose width is a multiple of the MX block (shard
    boundaries then fall on the full-row fake-quant's block boundaries).
    The head itself when already aligned."""
    step = n_shards * mx.MX_BLOCK
    V = w_head.shape[-1]
    Vp = -(-V // step) * step
    if Vp != V:
        w_head = F.pad(w_head, (0, Vp - V))
    return w_head


def fused_head_local_partials(hidden: torch.Tensor, w_shard: torch.Tensor,
                              fmt: str = "none", *, logit_scale: float = 1.0,
                              col_offset: int = 0,
                              suppress_id: Optional[int] = None,
                              chunk_v: int = 4096, quant=None,
                              col_limit: Optional[int] = None,
                              temperature: float = 0.0, seed: Seed = 0,
                              row_offset: int = 0
                              ) -> Tuple[torch.Tensor, ...]:
    """Streamed-head Stable-Max partials over one vocab shard, plain
    PyTorch (JAX's is its jnp oracle): hidden (R, d), w_shard (d, V_loc) ->
    (m (R,), gidx (R,) int32, s (R,)) with s relative to m and gidx global
    (``col_offset`` = shard * V_loc).  ``col_limit`` masks global columns
    >= the true vocab size (the zero pad of ``pad_head_for_mesh``).  One
    (R, chunk) logit tile at a time, never (R, V_loc).  With temperature
    > 0: (m, gidx, s, best, z_at), gidx the first column of the best
    score z/T + g (the noise at global row ``row_offset`` + r and the
    global column; an earlier chunk wins a tie) and z_at its logit."""
    R = hidden.shape[0]
    V = w_shard.shape[-1]
    chunk, Vp = _chunk_grid(V, chunk_v)
    if Vp != V:
        w_shard = F.pad(w_shard, (0, Vp - V))
    if quant is not None and quant.enabled:
        hidden, w_shard = quant.acts(hidden), quant.weights(w_shard)
    n_chunks = Vp // chunk
    if trace_lib.is_active():
        _emit_head_stream(R, hidden.shape[-1], chunk, n_chunks)
    dev = hidden.device
    m = torch.full((R,), NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((R,), dtype=torch.float32, device=dev)
    idx = torch.zeros((R,), dtype=torch.int64, device=dev)
    gumbel = temperature > 0.0
    best = torch.full_like(m, -float("inf"))
    z_at = torch.full_like(m, NEG_INF)
    rows = torch.arange(R, device=dev)[:, None] + row_offset
    with trace_lib.suppress():
        for c in range(n_chunks):
            z = head_logits(hidden, w_shard[:, c * chunk:(c + 1) * chunk],
                            logit_scale=logit_scale)
            z = mx.mx_fake_quant(z, fmt).to(torch.float32)
            col = c * chunk + torch.arange(chunk, device=dev)
            z = torch.where(col < V, z, NEG_INF)
            if col_limit is not None:
                z = torch.where(col + col_offset < col_limit, z, NEG_INF)
            if suppress_id is not None:
                z = torch.where(col + col_offset == suppress_id, NEG_INF, z)
            local_m = torch.amax(z, dim=-1)
            m_new = torch.maximum(m, local_m)
            s = s * torch.exp(m - m_new) + \
                torch.sum(torch.exp(z - m_new[:, None]), dim=-1)
            if gumbel:
                sc = z / temperature + counter_gumbel(
                    seed, rows, col[None, :] + col_offset)
                local_b, li = torch.max(sc, dim=-1)   # first occurrence
                upd = local_b > best                  # earlier chunk wins
                best = torch.where(upd, local_b, best)
                idx = torch.where(upd, li + c * chunk, idx)
                z_at = torch.where(upd, torch.gather(z, 1, li[:, None])[:, 0],
                                   z_at)
            else:
                local_i = torch.argmax(z, dim=-1) + c * chunk  # first
                idx = torch.where(local_m > m, local_i, idx)   # chunk wins
            m = m_new
    gidx = (idx + col_offset).to(torch.int32)
    return (m, gidx, s, best, z_at) if gumbel else (m, gidx, s)
