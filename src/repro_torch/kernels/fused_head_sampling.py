"""Fused LM head + Stable-Max sampling: CUDA kernel and plain version.

Port of the Pallas kernel src/repro/kernels/fused_head_sampling.py.
hidden (R, d) @ w_head (d, V) is reduced straight into per-row
(max, first-occurrence argmax, exp-sum): conf = 1/s, or, with
temperature > 0, the counter-Gumbel argmax with conf = exp(z_at - m)/s.
Per logit: f32 accumulate -> activation dtype -> x logit_scale -> sampling
fake-quant (any format of core/mx: none | bf16 | an MX format in
32-column blocks) -> activation dtype -> f32; the suppressed id is masked
after quantization, so it still counts toward its block's amax.

``fused_head_sampling`` launches csrc/fused_head_sampling.cu for CUDA
tensors and runs ``fused_head_stable_max`` (the plain version, a port of
the JAX oracle of the same name) for CPU tensors, and for meta tensors,
where it computes shapes only (sim/trace.py).  There is no fallback:
a CUDA tensor goes to the kernel or the call raises.  bf16 tensors take
the kernel's tensor-core route, which splits V across one CTA per SM by
``column_plan``: each CTA folds its column range into one partial per row
(``head_partials_plain`` computes the same partials in plain arithmetic)
and a second kernel merges them (``combine_rows_plain``).  f32 tensors
take its CUDA-core route (f32 FMAs, no TF32).

The bf16 route reads w_head in 16-byte row chunks, so each row must start
on a 16-byte address: its row stride must be a multiple of 8 elements.  A
vocabulary that is not (minicpm-2b: V 122753) is stored once, at load, by
``pad_head``: a (d, V) view of zero-padded (d, ``padded_vocab(V)``)
storage, which the plain path reads as the logical head and the kernel by
its row stride.  Nothing copies the head per call.  A hidden dim d that
is not a multiple of 8 (no config has one) would leave the hidden rows
(R, d) off 16-byte addresses: the bf16 route then reads a zero-padded copy
of them (``padded_hidden``, R x padded d x 2 bytes a call), and the
head's rows past d are never read, so the head keeps its layout.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import mx
from repro_torch.core import sampling
from repro_torch.kernels import _build

NAME = "fused_head_sampling"
# the launch count of the vocab-shard entry (route A of the SPMD tick):
# the same library, counted apart from the single-device entry
SHARD_NAME = "fused_head_sampling_shard"
# its sampled launches (temperature > 0), counted apart
SAMPLED_NAME = "fused_head_sampling_shard_sampled"
_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 route's row alignment in elements: 16 bytes of bf16
ROW_ALIGN = 8


def padded_vocab(V: int) -> int:
    """The row stride, in elements, of a head of V columns stored for the
    bf16 route: V rounded up to a multiple of ``ROW_ALIGN``."""
    return -(-V // ROW_ALIGN) * ROW_ALIGN


def pad_head(w: torch.Tensor) -> torch.Tensor:
    """w (d, V) as a (d, V) view of zero-padded (d, padded_vocab(V))
    storage, made once at load; ``w`` itself when its rows already lie
    16 bytes apart (V a multiple of 8, contiguous)."""
    d, V = w.shape
    if w.is_contiguous() and V % ROW_ALIGN == 0:
        return w
    full = torch.zeros((d, padded_vocab(V)), dtype=w.dtype, device=w.device)
    full[:, :V] = w
    return full[:, :V]


def padded_hidden(hidden: torch.Tensor) -> torch.Tensor:
    """The hidden rows (R, d) as the bf16 route reads them: ``hidden``
    itself where d is a multiple of ``ROW_ALIGN``, else a copy with each
    row zero-padded to ``ROW_ALIGN`` elements (the kernel reads it by its
    row stride and multiplies only the first d columns by a head row)."""
    d = hidden.shape[1]
    if d % ROW_ALIGN == 0:
        return hidden
    return torch.nn.functional.pad(hidden, (0, -d % ROW_ALIGN))


def head_storage(w: torch.Tensor) -> torch.Tensor:
    """The full rows behind a head w (d, V) with unit column stride: a
    (d, w.stride(0)) tensor, pad columns included (``w`` itself when it is
    contiguous).  A per-column function of the head (the QuantPolicy's
    weight fake-quant, whose MX blocks run along d) applied to it and
    sliced back to V keeps the padded layout."""
    if w.stride(1) != 1:
        raise ValueError(f"head column stride {w.stride(1)} != 1")
    return torch.as_strided(w, (w.shape[0], w.stride(0)), (w.stride(0), 1))


def fused_head_stable_max(hidden: torch.Tensor, w_head: torch.Tensor,
                          fmt: str = "none", *, logit_scale: float = 1.0,
                          temperature: float = 0.0, seed: sampling.Seed = 0,
                          suppress_id: Optional[int] = None,
                          chunk_v: int = 4096, row_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: hidden (R, d), w_head (d, V) -> (conf (R,) f32,
    token (R,) i32), streaming the head one vocab chunk at a time into the
    online (max, argmax, exp-sum) reduction like the JAX oracle.  Chunks
    are whole MX blocks (``sampling._chunk_grid``), so chunking changes
    only the order of the exp-sum.  The Gumbel noise of row r is drawn at
    global row ``row_offset`` + r."""
    R, _ = hidden.shape
    V = w_head.shape[-1]
    chunk, _ = sampling._chunk_grid(V, chunk_v)
    dev = hidden.device
    gumbel = temperature > 0.0
    m = torch.full((R,), sampling.NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((R,), dtype=torch.float32, device=dev)
    idx = torch.zeros((R,), dtype=torch.int64, device=dev)
    best = torch.full_like(m, sampling.NEG_INF)
    z_at = torch.full_like(m, sampling.NEG_INF)
    rows = torch.arange(R, device=dev)[:, None] + row_offset
    for c0 in range(0, V, chunk):
        z = sampling.head_logits(hidden, w_head[:, c0:c0 + chunk],
                                 logit_scale=logit_scale)
        z = mx.mx_fake_quant(z, fmt).to(torch.float32)
        col = torch.arange(c0, c0 + z.shape[1], device=dev)
        if suppress_id is not None:
            z = torch.where(col == suppress_id, sampling.NEG_INF, z)
        local_m = torch.amax(z, dim=-1)
        m_new = torch.maximum(m, local_m)
        s = s * torch.exp(m - m_new) + \
            torch.sum(torch.exp(z - m_new[:, None]), dim=-1)
        if gumbel:
            sc = z / temperature + sampling.counter_gumbel(seed, rows,
                                                           col[None, :])
            local_b, li = torch.max(sc, dim=-1)       # first occurrence
            z_li = torch.gather(z, 1, li[:, None])[:, 0]
            upd = local_b > best                      # earlier chunk wins ties
            best = torch.where(upd, local_b, best)
            idx = torch.where(upd, li + c0, idx)
            z_at = torch.where(upd, z_li, z_at)
        else:
            local_i = torch.argmax(z, dim=-1) + c0    # first occurrence
            idx = torch.where(local_m > m, local_i, idx)
        m = m_new
    conf = torch.exp(z_at - m) / s if gumbel else 1.0 / s
    return conf, idx.to(torch.int32)


def column_plan(V: int, n_sm: int) -> Tuple[int, int]:
    """(columns per CTA, CTAs): V split into n_sm or fewer contiguous ranges
    of whole 32-column MX blocks, aligned to column 0 as a full-row
    fake-quant aligns them; the last range may be ragged."""
    blocks = -(-V // mx.MX_BLOCK)
    cols = -(-blocks // n_sm) * mx.MX_BLOCK
    return cols, -(-V // cols)


def head_partials_plain(hidden: torch.Tensor, w_head: torch.Tensor,
                        plan: Tuple[int, int], fmt: str = "none", *,
                        logit_scale: float = 1.0, temperature: float = 0.0,
                        seed: sampling.Seed = 0,
                        suppress_id: Optional[int] = None,
                        row_offset: int = 0
                        ) -> Tuple[torch.Tensor, ...]:
    """The per-range partials of the tensor-core route in plain arithmetic:
    (m, idx, s, best, z_at), each (R, n_ranges), for the column ranges of
    ``plan``.  m is the range's largest quantized logit, s its exp-sum
    relative to m; idx is the first column holding m, or with
    temperature > 0 the first holding the largest Gumbel score best, whose
    logit is z_at (best and z_at are -inf/-1e30 when greedy)."""
    cols, n = plan
    V = w_head.shape[1]
    parts = []
    for r in range(n):
        c0, c1 = r * cols, min((r + 1) * cols, V)
        z = sampling.head_logits(hidden, w_head[:, c0:c1],
                                 logit_scale=logit_scale)
        parts.append(range_partials(mx.mx_fake_quant(z, fmt), c0,
                                    temperature=temperature, seed=seed,
                                    suppress_id=suppress_id,
                                    row_offset=row_offset))
    return tuple(torch.stack(t, dim=1) for t in zip(*parts))


def range_partials(z: torch.Tensor, c0: int, *, temperature: float = 0.0,
                   seed: sampling.Seed = 0,
                   suppress_id: Optional[int] = None, row_offset: int = 0
                   ) -> Tuple[torch.Tensor, ...]:
    """One column range's partials (m, idx, s, best, z_at), each (R,), from
    its fake-quantized logits z (R, n) of columns c0 .. c0 + n - 1: the
    suppressed id masked, m the largest logit, s the exp-sum relative to
    m, idx the first column holding m, or with temperature > 0 the first
    holding the largest Gumbel score best, whose logit is z_at (best and
    z_at are -inf/-1e30 when greedy); the noise of row r at global row
    ``row_offset`` + r."""
    z = z.to(torch.float32)
    col = torch.arange(c0, c0 + z.shape[1], device=z.device)
    if suppress_id is not None:
        z = torch.where(col == suppress_id, sampling.NEG_INF, z)
    m, i = torch.max(z, dim=-1)                       # first occurrence
    s = torch.sum(torch.exp(z - m[:, None]), dim=-1)
    best = torch.full_like(m, -float("inf"))
    z_at = torch.full_like(m, sampling.NEG_INF)
    if temperature > 0.0:
        rows = torch.arange(z.shape[0], device=z.device)[:, None] + \
            row_offset
        sc = z / temperature + sampling.counter_gumbel(seed, rows,
                                                       col[None, :])
        best, i = torch.max(sc, dim=-1)
        z_at = torch.gather(z, 1, i[:, None])[:, 0]
    return m, i + c0, s, best, z_at


def combine_rows_plain(m: torch.Tensor, idx: torch.Tensor, s: torch.Tensor,
                       best: torch.Tensor, z_at: torch.Tensor, gumbel: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge of per-range partials (R, n) into (conf, token), line for
    line as csrc/common.cuh combine_row: m = max m_t,
    s = sum s_t e^(m_t - m); the token is the lowest index among the
    ranges holding m, or with Gumbel among those holding the best score,
    with z_at from that range; conf = 1/s, or e^(z_at - m)/s."""
    big = torch.full_like(idx, 1 << 30)
    m_all = torch.amax(m, dim=1)
    s_all = torch.sum(s * torch.exp(m - m_all[:, None]), dim=1)
    if not gumbel:
        tok = torch.amin(torch.where(m >= m_all[:, None], idx, big), dim=1)
        return 1.0 / s_all, tok.to(torch.int32)
    b_all = torch.amax(best, dim=1)
    tok = torch.amin(torch.where(best >= b_all[:, None], idx, big), dim=1)
    zat = torch.gather(z_at, 1, torch.argmax((idx == tok[:, None]).to(
        torch.int32), dim=1)[:, None])[:, 0]
    return torch.exp(zat - m_all) / s_all, tok.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch = _build.function(
        NAME, "fused_head_sampling_launch",
        [p] * 9 + [i] * 7 + [f, f, p] + [i] * 4 + [p])
    tiles = _build.function(NAME, "fused_head_sampling_tiles", [i])
    shard = _build.function(
        NAME, "fused_head_sampling_shard_launch",
        [p] * 12 + [i] * 7 + [f, f, p] + [i] * 5 + [p])
    return launch, tiles, shard


def shard_columns(V_loc: int, col_offset: int,
                  col_limit: Optional[int]) -> int:
    """The columns of a shard at ``col_offset`` that lie below
    ``col_limit`` (the true vocabulary; None: all V_loc): the rest are the
    zero pad of ``sampling.pad_head_for_mesh``."""
    if col_limit is None:
        return V_loc
    return max(0, min(V_loc, col_limit - col_offset))


def head_shard_partials_plain(hidden: torch.Tensor, w_shard: torch.Tensor,
                              fmt: str = "none", *,
                              logit_scale: float = 1.0, col_offset: int = 0,
                              col_limit: Optional[int] = None,
                              suppress_id: Optional[int] = None,
                              chunk_v: int = 4096, temperature: float = 0.0,
                              seed: sampling.Seed = 0, row_offset: int = 0
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the shard entry: ``sampling.fused_head_local_
    partials`` (the streamed partials of one vocab shard, JAX's jnp
    oracle), restricted to what the kernel computes: (m, global idx, s),
    each (R,), plus (best, z_at) with temperature > 0, and a row with no
    valid column (a shard of pad only) as the kernel leaves it, m = -1e30,
    s = 0, idx = 2^30, best = -inf, z_at = -1e30 (no combine reads them:
    another shard holds a larger m and a larger best)."""
    parts = sampling.fused_head_local_partials(
        hidden, w_shard, fmt, logit_scale=logit_scale,
        col_offset=col_offset, suppress_id=suppress_id, chunk_v=chunk_v,
        col_limit=col_limit, temperature=temperature, seed=seed,
        row_offset=row_offset)
    m, gidx, s = parts[:3]
    empty = m <= sampling.NEG_INF
    out = (m, torch.where(empty, sampling.BIG_INDEX, gidx),
           torch.where(empty, 0.0, s))
    if temperature <= 0.0:
        return out
    best, z_at = parts[3:]
    return out + (torch.where(empty, -float("inf"), best),
                  torch.where(empty, sampling.NEG_INF, z_at))


def head_shard_partials(hidden: torch.Tensor, w_shard: torch.Tensor, *,
                        fmt: str = "none", logit_scale: float = 1.0,
                        col_offset: int = 0, col_limit: Optional[int] = None,
                        suppress_id: Optional[int] = None,
                        chunk_v: int = 4096, temperature: float = 0.0,
                        seed: sampling.Seed = 0, row_offset: int = 0
                        ) -> Tuple[torch.Tensor, ...]:
    """The fused head's vocab-shard entry: hidden (R, d) and one (d, V_loc)
    shard of a head padded by ``sampling.pad_head_for_mesh``, at global
    column ``col_offset`` -> per-row partials (m (R,) f32, the global
    index of the first column holding m (R,) i32, s (R,) f32 relative to
    m), the sampling fake-quant before the reductions and columns at or
    past ``col_limit`` (the true V) masked after it, as
    ``sampling.fused_head_local_partials`` masks them.  With temperature
    > 0 the index is that of the first column holding the best Gumbel
    score z/T + g, the noise drawn at global row ``row_offset`` + r and
    the global column (``seed`` as ``fused_head_sampling``'s), and the
    partials gain (best (R,) f32, z_at (R,) f32, the logit at the index).
    CUDA tensors run the kernel: the per-CTA partials of the single-device
    entry over the shard's first ``shard_columns`` columns (the rest are
    zero columns, so their logits are the zeros the kernel pads a block
    with), then a merge that emits the partials in place of (conf,
    token).  V_loc is a multiple of 32 (shard boundaries on MX blocks), so
    each rank's shard is its own contiguous storage with 16-byte rows: no
    copy of the head per call (a d that is not a multiple of 8 reads
    ``padded_hidden``).  CPU tensors run ``head_shard_partials_plain``."""
    code = mx.fmt_code(fmt)
    if hidden.dim() != 2 or w_shard.dim() != 2 or \
            hidden.shape[1] != w_shard.shape[0]:
        raise ValueError(f"expected hidden (R, d) and w_shard (d, V_loc); "
                         f"got {tuple(hidden.shape)} and "
                         f"{tuple(w_shard.shape)}")
    if hidden.device.type in _build.PLAIN_DEVICES:
        return head_shard_partials_plain(
            hidden, w_shard, fmt, logit_scale=logit_scale,
            col_offset=col_offset, col_limit=col_limit,
            suppress_id=suppress_id, chunk_v=chunk_v,
            temperature=temperature, seed=seed, row_offset=row_offset)
    _build.refuse_grad(NAME, hidden, w_shard)
    if hidden.device.type != "cuda" or w_shard.device != hidden.device:
        raise ValueError(f"hidden on {hidden.device} and w_shard on "
                         f"{w_shard.device}: both must be on one CUDA "
                         f"device")
    if hidden.dtype not in _DTYPES:
        raise ValueError(f"hidden dtype {hidden.dtype} not in {_DTYPES}")
    w = w_shard.to(hidden.dtype)
    R, d = hidden.shape
    V_loc, ldw = w.shape[1], w.stride(0)
    if V_loc % mx.MX_BLOCK or not hidden.is_contiguous() or \
            w.stride(1) != 1:
        raise ValueError(
            f"a head shard needs V_loc a multiple of {mx.MX_BLOCK} (got "
            f"{V_loc}), contiguous hidden and adjacent columns: pad the "
            f"head with sampling.pad_head_for_mesh")
    dev = hidden.device
    V = shard_columns(V_loc, col_offset, col_limit)
    bf16 = hidden.dtype == torch.bfloat16
    _, tiles, launch = _kernel_fns()
    if bf16:
        if ldw % ROW_ALIGN or w.data_ptr() % 16:
            raise ValueError(
                f"the bf16 route needs the shard's row stride to be a "
                f"multiple of {ROW_ALIGN} with 16-byte aligned rows; got row "
                f"stride {ldw}")
        hidden = padded_hidden(hidden)
        cols, n_parts = column_plan(max(V, 1), _build.sm_count(dev))
    else:
        cols, n_parts = 0, tiles(max(V, 1))
    gumbel = temperature > 0.0
    m = torch.empty((R,), dtype=torch.float32, device=dev)
    idx = torch.empty((R,), dtype=torch.int32, device=dev)
    s = torch.empty_like(m)
    best = torch.empty_like(m) if gumbel else None
    z_at = torch.empty_like(m) if gumbel else None
    out = (m, idx, s) + ((best, z_at) if gumbel else ())
    if R == 0:
        return out
    part_m = torch.empty((R, n_parts), dtype=torch.float32, device=dev)
    part_i = torch.empty((R, n_parts), dtype=torch.int32, device=dev)
    part_s = torch.empty_like(part_m)
    part_b = torch.empty_like(part_m) if gumbel else None
    part_z = torch.empty_like(part_m) if gumbel else None
    # the suppressed id as a column of this shard (negative: not in it)
    sup = -1 if suppress_id is None else int(suppress_id) - int(col_offset)
    err = launch(hidden.data_ptr(), w.data_ptr(), part_m.data_ptr(),
                 part_i.data_ptr(), part_s.data_ptr(), _build.ptr(part_b),
                 _build.ptr(part_z), m.data_ptr(), idx.data_ptr(),
                 s.data_ptr(), _build.ptr(best), _build.ptr(z_at), R, d,
                 hidden.shape[1], V, ldw, bf16, code, float(logit_scale),
                 float(temperature),
                 _build.ptr(sampling.seed_tensor(seed, dev) if gumbel
                            else None),
                 sup if sup < V_loc else -1, int(col_offset),
                 int(row_offset), cols, n_parts,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[SAMPLED_NAME if gumbel else SHARD_NAME] += 1
    return out


def fused_head_sampling(hidden: torch.Tensor, w_head: torch.Tensor, *,
                        fmt: str = "none", logit_scale: float = 1.0,
                        suppress_id: Optional[int] = None,
                        temperature: float = 0.0,
                        seed: sampling.Seed = 0, chunk_v: int = 4096,
                        row_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden (R, d), w_head (d, V) -> (conf (R,) f32, token (R,) i32)
    without materializing the (R, V) logits.  w_head joins the product in
    hidden's dtype.  ``fmt`` is any name or alias of core/mx.FORMATS (the
    kernel's fmt code, ``mx.fmt_code``).  ``chunk_v`` is the plain
    version's vocab chunk; the kernel splits V by ``column_plan``.
    ``seed`` is a uint32 int or an int64 tensor of one element holding one
    (``sampling.seed_tensor``); the kernel reads it from device memory, so
    a captured graph draws each replay's seed.  ``row_offset`` is the
    global row of row 0, where the noise is drawn (a data shard's first
    row): a sampled step on any mesh draws what one device draws.
    CUDA tensors run the kernel (bf16 needs w_head's row stride to be a
    multiple of 8, 16-byte rows: see ``pad_head``; a d that is not one
    reads ``padded_hidden``); CPU tensors the plain version."""
    code = mx.fmt_code(fmt)
    if hidden.dim() != 2 or w_head.dim() != 2 or \
            hidden.shape[1] != w_head.shape[0]:
        raise ValueError(f"expected hidden (R, d) and w_head (d, V); got "
                         f"{tuple(hidden.shape)} and {tuple(w_head.shape)}")
    if hidden.device.type in _build.PLAIN_DEVICES:
        return fused_head_stable_max(
            hidden, w_head, fmt, logit_scale=logit_scale,
            temperature=temperature, seed=seed, suppress_id=suppress_id,
            chunk_v=chunk_v, row_offset=row_offset)
    _build.refuse_grad(NAME, hidden, w_head)
    if hidden.device.type != "cuda" or w_head.device != hidden.device:
        raise ValueError(f"hidden on {hidden.device} and w_head on "
                         f"{w_head.device}: both must be on one CUDA device")
    if hidden.dtype not in _DTYPES:
        raise ValueError(f"hidden dtype {hidden.dtype} not in {_DTYPES}")
    w = w_head.to(hidden.dtype)
    if not hidden.is_contiguous() or w.stride(1) != 1:
        raise ValueError("hidden must be contiguous and w_head's columns "
                         "adjacent")
    R, d = hidden.shape
    V, ldw = w.shape[1], w.stride(0)
    launch, tiles, _ = _kernel_fns()
    dev = hidden.device
    bf16 = hidden.dtype == torch.bfloat16
    if bf16:
        if ldw % ROW_ALIGN or w.data_ptr() % 16:
            raise ValueError(
                f"the bf16 route needs w_head's rows 16 bytes apart and "
                f"aligned (row stride {ldw}); store the head with pad_head")
        hidden = padded_hidden(hidden)
        cols, n_parts = column_plan(V, _build.sm_count(dev))
    else:
        cols, n_parts = 0, tiles(V)
    gumbel = temperature > 0.0
    part_m = torch.empty((R, n_parts), dtype=torch.float32, device=dev)
    part_i = torch.empty((R, n_parts), dtype=torch.int32, device=dev)
    part_s = torch.empty_like(part_m)
    part_b = torch.empty_like(part_m) if gumbel else None
    part_z = torch.empty_like(part_m) if gumbel else None
    conf = torch.empty((R,), dtype=torch.float32, device=dev)
    token = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return conf, token
    err = launch(hidden.data_ptr(), w.data_ptr(), part_m.data_ptr(),
                 part_i.data_ptr(), part_s.data_ptr(), _build.ptr(part_b),
                 _build.ptr(part_z), conf.data_ptr(), token.data_ptr(),
                 R, d, hidden.shape[1], V, ldw, bf16, code,
                 float(logit_scale), float(temperature),
                 _build.ptr(sampling.seed_tensor(seed, dev) if gumbel
                            else None),
                 -1 if suppress_id is None else int(suppress_id),
                 int(row_offset), cols, n_parts,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[NAME] += 1
    return conf, token
