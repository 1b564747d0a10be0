"""One-pass Stable-Max over stored logits: CUDA kernel and plain version.

Port of the Pallas kernel src/repro/kernels/stablemax_sampling.py, the
twin of core/sampling.stable_max.  logits (R, V) -> per row the sampling
fake-quant (any format of core/mx: none | bf16 | an MX format in 32-column
blocks), the suppressed id masked after the quantization (it still counts
toward its block's amax), then max m, first-occurrence argmax and exp-sum
s: conf = 1/s, or, with temperature > 0, the counter-Gumbel argmax of
z/T + g with conf = exp(z_at - m)/s.  The Pallas kernel does the reduction alone; the
kernel here also does the fake-quant and the Gumbel draw, so the whole of
``stable_max`` is one launch, plus the merge of its partials: the kernel
splits V into the column ranges of ``vocab_plan``, folds each range of a
row into one partial (``stablemax_partials_plain`` computes the same
partials in plain arithmetic), and a second kernel merges them with the
combine rule (``fused_head_sampling.combine_rows_plain``).

``stablemax_sampling`` launches csrc/stablemax_sampling.cu for CUDA
tensors and runs ``stable_max_plain`` for CPU tensors (and meta tensors,
shapes only); a CUDA tensor never reaches the plain version.

Route C, ``stablemax_shard_partials``, is the vocab-shard entry: the same
per-CTA kernel over one rank's columns of stored logits, its partials
merged into that shard's (m, global idx, s), which
``sampling.combine_partials`` merges across ranks (the decode step over a
vocab-sharded head of a model with no head mode, launch/steps.py).  Its
plain version is ``sampling.local_partials`` with global indices; its
launches count under ``SHARD_NAME``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import mx
from repro_torch.core import sampling
from repro_torch.kernels import _build
from repro_torch.kernels.fused_head_sampling import range_partials

NAME = "stablemax_sampling"
SHARD_NAME = "stablemax_sampling_shard"
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's CTA steps through its range 2048 columns (64 MX blocks) at a
# time, two steps per pass; the plan aims at a few CTAs per SM
STEP_BLOCKS = 64
PASS_BLOCKS = 2 * STEP_BLOCKS
CTAS_PER_SM = 4


def stable_max_plain(logits: torch.Tensor, fmt: str = "none", *,
                     temperature: float = 0.0, seed: sampling.Seed = 0,
                     suppress_id: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: logits (R, V) -> (conf (R,) f32, token (R,) i32)."""
    R, V = logits.shape
    z = mx.mx_fake_quant(logits, fmt).to(torch.float32)
    col = torch.arange(V, device=logits.device)
    if suppress_id is not None:
        z = torch.where(col == suppress_id, sampling.NEG_INF, z)
    m = torch.amax(z, dim=-1)
    s = torch.sum(torch.exp(z - m[:, None]), dim=-1)
    if temperature > 0.0:
        rows = torch.arange(R, device=logits.device)[:, None]
        sc = z / temperature + sampling.counter_gumbel(seed, rows,
                                                       col[None, :])
        idx = torch.argmax(sc, dim=-1)                # first occurrence
        z_at = torch.gather(z, 1, idx[:, None])[:, 0]
        return torch.exp(z_at - m) / s, idx.to(torch.int32)
    return 1.0 / s, torch.argmax(z, dim=-1).to(torch.int32)


def vocab_plan(V: int, R: int, n_sm: int) -> Tuple[int, int]:
    """(columns per CTA, CTAs per row): V split into contiguous ranges of
    whole 32-column MX blocks, aligned to column 0 as a full-row fake-quant
    aligns them, about CTAS_PER_SM CTAs per SM over all R rows.  A range
    longer than one CTA step is rounded up to whole steps, and one longer
    than one pass to whole passes, so no CTA runs a step with no column;
    the last range may be ragged."""
    blocks = -(-V // mx.MX_BLOCK)
    n = max(1, min(blocks, -(-CTAS_PER_SM * n_sm // max(R, 1))))
    per = -(-blocks // n)
    for unit in (PASS_BLOCKS, STEP_BLOCKS):
        if per > unit:
            per = -(-per // unit) * unit
            break
    cols = per * mx.MX_BLOCK
    return cols, -(-V // cols)


def stablemax_partials_plain(logits: torch.Tensor, plan: Tuple[int, int],
                             fmt: str = "none", *, temperature: float = 0.0,
                             seed: sampling.Seed = 0,
                             suppress_id: Optional[int] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """The kernel's per-range partials in plain arithmetic: (m, idx, s,
    best, z_at), each (R, n_ranges), for the column ranges of ``plan``
    (``fused_head_sampling.range_partials`` per range)."""
    cols, n = plan
    z = mx.mx_fake_quant(logits, fmt)
    parts = [range_partials(z[:, r * cols:(r + 1) * cols], r * cols,
                            temperature=temperature, seed=seed,
                            suppress_id=suppress_id) for r in range(n)]
    return tuple(torch.stack(t, dim=1) for t in zip(*parts))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function(NAME, "stablemax_sampling_launch",
                           [p] * 8 + [i] * 5 + [f, p, i, p])


def stablemax_sampling(logits: torch.Tensor, *, fmt: str = "none",
                       suppress_id: Optional[int] = None,
                       temperature: float = 0.0,
                       seed: sampling.Seed = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (R, V) -> (conf (R,) f32, token (R,) i32).  ``fmt`` is any
    name or alias of core/mx.FORMATS.  ``seed`` is a uint32 int or an
    int64 tensor of one element holding one, read by the kernel from device
    memory.  CUDA tensors run the kernel; CPU tensors
    the plain version."""
    code = mx.fmt_code(fmt)
    if logits.dim() != 2:
        raise ValueError(f"expected logits (R, V); got "
                         f"{tuple(logits.shape)}")
    if logits.device.type in _build.PLAIN_DEVICES:
        return stable_max_plain(logits, fmt, temperature=temperature,
                                seed=seed, suppress_id=suppress_id)
    _build.refuse_grad(NAME, logits)
    if logits.device.type != "cuda":
        raise ValueError(f"logits on {logits.device}: need a CUDA device")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits dtype {logits.dtype} not in {_DTYPES}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    R, V = logits.shape
    dev = logits.device
    conf = torch.empty((R,), dtype=torch.float32, device=dev)
    token = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0 or V == 0:
        return conf, token
    cols, n_vt = vocab_plan(V, R, _build.sm_count(dev))
    gumbel = temperature > 0.0
    part_m = torch.empty((R, n_vt), dtype=torch.float32, device=dev)
    part_i = torch.empty((R, n_vt), dtype=torch.int32, device=dev)
    part_s = torch.empty_like(part_m)
    part_b = torch.empty_like(part_m) if gumbel else None
    part_z = torch.empty_like(part_m) if gumbel else None
    err = _kernel_fn()(logits.data_ptr(), part_m.data_ptr(),
                       part_i.data_ptr(), part_s.data_ptr(),
                       _build.ptr(part_b), _build.ptr(part_z),
                       conf.data_ptr(), token.data_ptr(), R, V, cols,
                       int(logits.dtype == torch.bfloat16), code,
                       float(temperature),
                       _build.ptr(sampling.seed_tensor(seed, dev) if gumbel
                                  else None),
                       -1 if suppress_id is None else int(suppress_id),
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[NAME] += 1
    return conf, token


def stablemax_shard_partials_plain(logits: torch.Tensor, fmt: str = "none",
                                   *, col_offset: int = 0,
                                   suppress_id: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, ...]:
    """Plain version of route C: ``sampling.local_partials`` with global
    indices (logits (R, V_loc) -> m, idx, s, each (R,))."""
    return sampling.local_partials(logits, fmt, col_offset=col_offset,
                                   suppress_id=suppress_id)


@functools.lru_cache(maxsize=None)
def _shard_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function(NAME, "stablemax_sampling_shard_launch",
                           [p] * 7 + [i] * 7 + [p])


def stablemax_shard_partials(logits: torch.Tensor, *, fmt: str = "none",
                             col_offset: int = 0,
                             suppress_id: Optional[int] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """Route C: one vocab shard of stored logits (R, V_loc), global
    columns ``col_offset`` onward, V_loc a multiple of the MX block (so
    the shard's blocks are the full row's) -> per-row greedy partials (m
    (R,) f32, the global index of the first column holding m (R,) i32, s
    (R,) f32 relative to m), the sampling fake-quant first and
    ``suppress_id`` (a global column) masked after it on the shard that
    holds it.  CUDA tensors run the kernel (``vocab_plan``'s CTAs, then a
    merge that emits the partials in place of (conf, token)); CPU tensors
    ``stablemax_shard_partials_plain``."""
    code = mx.fmt_code(fmt)
    if logits.dim() != 2:
        raise ValueError(f"expected logits (R, V_loc); got "
                         f"{tuple(logits.shape)}")
    if logits.device.type in _build.PLAIN_DEVICES:
        return stablemax_shard_partials_plain(
            logits, fmt, col_offset=col_offset, suppress_id=suppress_id)
    _build.refuse_grad(NAME, logits)
    if logits.device.type != "cuda":
        raise ValueError(f"logits on {logits.device}: need a CUDA device")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits dtype {logits.dtype} not in {_DTYPES}")
    R, V = logits.shape
    if V % mx.MX_BLOCK or not logits.is_contiguous():
        raise ValueError(f"a logit shard needs contiguous rows of a "
                         f"multiple of {mx.MX_BLOCK} columns; got "
                         f"{tuple(logits.shape)}")
    dev = logits.device
    m = torch.empty((R,), dtype=torch.float32, device=dev)
    idx = torch.empty((R,), dtype=torch.int32, device=dev)
    s = torch.empty_like(m)
    if R == 0 or V == 0:
        return m, idx, s
    cols, n_vt = vocab_plan(V, R, _build.sm_count(dev))
    part_m = torch.empty((R, n_vt), dtype=torch.float32, device=dev)
    part_i = torch.empty((R, n_vt), dtype=torch.int32, device=dev)
    part_s = torch.empty_like(part_m)
    # the suppressed id as a column of this shard (negative: not in it)
    sup = -1 if suppress_id is None else int(suppress_id) - int(col_offset)
    err = _shard_fn()(logits.data_ptr(), part_m.data_ptr(),
                      part_i.data_ptr(), part_s.data_ptr(), m.data_ptr(),
                      idx.data_ptr(), s.data_ptr(), R, V, cols,
                      int(logits.dtype == torch.bfloat16), code,
                      sup if sup < V else -1, int(col_offset),
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[SHARD_NAME] += 1
    return m, idx, s
