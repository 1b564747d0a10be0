"""Bidirectional GQA attention: CUDA kernel and plain version.

Port of the Pallas kernel src/repro/kernels/flash_bidir.py, the twin of the
model's layers.attention.  q (B, Sq, Hq, D) attends to k/v (B, Skv, Hkv, D)
with KV head = q_head // (Hq / Hkv).  Optional BAOS fusion as in the Pallas
kernel (q * f_k * D^-1/2 on the way in, out * f_v + c_v at the end), an
optional |q_pos - k_pos| < window mask (query row r at position
q_offset + r, key j at j: a segment of a longer cache), a per-row
``kv_valid`` (B, Skv) mask, and with ``causal=True`` JAX's causal mode
(``layers._mask_bias``): key position <= query position, and with a
window q_pos - k_pos < window.
Masked scores are -1e30, so a row with no valid key averages every key, as
the JAX reference does; the output divides by max(l, 1e-30).

``q_offset`` is a host int or an integer tensor on q's device: one
element, or a (B,) block-start buffer whose rows share one start (element
0 is read).  The kernel reads a tensor offset from device memory, once per
CTA, so a captured CUDA graph reads each replay's offset and no launch
waits for the host; the offset only places the window and the causal
mask, so without either it is not passed.  The plain version computes
with the same tensor.  Each CTA walks only the key tiles that some query
row of it can reach through the window or the causal mask, and walks
every tile again when one of its rows finds no valid key there (such a
row averages every key): the function is the same as a walk over every
tile.

``flash_bidir`` launches csrc/flash_bidir.cu for CUDA tensors and runs
``flash_bidir_plain`` for CPU tensors; a CUDA tensor never reaches the
plain version.  bf16 tensors take the kernel's tensor-core route: K, V and
(without BAOS) q are exact bf16 operands, D^-1/2 scales the f32 scores,
and the f32 operands -- q * f_k with BAOS, and always the probabilities
P -- enter the products as ``SPLIT_TERMS`` bf16 terms
t_i = bf16(x - t_0 - ... - t_(i-1)), so the products keep the f32
function of the Pallas kernel.  f32 tensors take its CUDA-core route (f32
FMAs, no TF32).  Any head dim D runs (``route``): up to 256 in the
smallest instantiated tile that holds it; bf16 takes the tensor-core route
where D is a multiple of 8, and otherwise the CUDA-core route on bf16
operands (rows D * 2 bytes apart are not 16-byte aligned, so that kernel
loads one value at a time: no padded copy).  D past 256 takes the wide
CUDA-core kernel, whose CTAs split the output columns into slices of
``WIDE_SLICE``; each slice forms the full-D scores, chunk by chunk of
``WIDE_CHUNK`` columns in the same order, so every slice of a row holds
the same (m, l).  The score scale is D^-1/2 of the true D on every route.

Gradients: while grad mode is on and q, k or v requires grad,
``flash_bidir`` runs as ``FlashBidir``, a ``torch.autograd.Function``
whose forward is the same kernel (or plain version) and whose backward is
``flash_bidir_bwd`` (the same routes by D and dtype; the wide route writes
each row's statistics, delta included, once, and every column slice of
dq and dk/dv reads them): csrc/flash_bidir_bwd.cu for CUDA tensors, which
replaces no Pallas kernel (the JAX package trains through jax.grad of
models/layers.attention), and ``flash_bidir_bwd_plain`` for CPU tensors.
A row with no valid key averages V whatever its scores, so its dq and its
share of dk are 0.  The backward's bf16 route runs on the tensor cores
with P and dS rounded once to bf16 (``BWD_P_TERMS``); ``bwd_plan`` picks
its CTAs and the row split of its dk/dv pass and sizes its scratch.

The cached forward under autograd (jax.grad of JAX's forward with a
cache): ``FlashBidir`` also takes the BAOS calibration, route B's second
source and a device query offset, and its backward returns d f_k = sum
dqs * q, d f_v = sum dO * o_s and d c_v = sum dO (B, Hkv, D) f32, summed
over positions and the GQA group (dqs the gradient of q * f_k, o_s the
uncorrected output), dk and dv in the smoothed space, dk2 and dv2 of the
second source (one softmax over both sources, the cache's stale copy of
the block masked by kv_valid as in the forward), and reads a tensor
offset from device memory in every kernel.  On the card, BAOS adds a
first kernel that forms q * f_k and dO * f_v in f32 (two bf16 terms each
on the bf16 routes, which enter every product as two: the tensor-core
instantiations with QT = 2, MASKED), has the dq pass write dqs in f32,
and a last kernel that rounds dq = dqs * f_k once and forms the three
column sums in a fixed order (no atomics); o_s is recomputed by one
forward launch (f_k fused, no f_v or c_v), counted as any forward launch
(``count_name``).
The dk/dv pass skips the cache's keys when k and v need no gradient (the
split refine's read-only cache).  Counted as ``flash_bidir_bwd_split``
(route B), ``flash_bidir_bwd_baos`` (BAOS) or ``flash_bidir_bwd_offset``
(a device offset), after bf16 scores and causal (``bwd_count_name``).
The plain backward (``flash_bidir_bwd_plain`` given the calibration or a
second source) is autograd through the plain forward.

Route B, ``extra_kv=(k2, v2, valid2)``: a second K/V source, the split
active-block cache's buffer (models/transformer.py; JAX's
``layers.attention(extra_kv=)``), in the cache's smoothed space, its key j
at position q_offset + j.  The kernel walks its keys after the cache's in
the same online softmax, BAOS fused once, and counts the launch as
``flash_bidir_split``; the plain version takes the two sources as one key
set.  Under autograd its gradient is the cached forward's (above).

Scores in bf16 (``score_dtype="bfloat16"``, JAX's
``layers.attention(score_dtype=bf16)``): qg = bf16(q * f_k * D^-1/2),
the scale rounded to q's dtype first and f_k fused in f32 as above; S =
bf16(qg . bf16(k)) from f32 sums; P = bf16(exp(bf16(S - bf16(m)))); l =
sum P and o = P . bf16(v) in f32; a masked score is bf16(-1e30), so a row
with no valid key still averages every key.  The plain version follows
JAX's chunks of ``kv_chunk`` keys (m each chunk's max, the chunks merged
in f32; route B's second source a chunk of its own).  Every kernel route
rounds at the same places, but relative to its running max, not a
chunk's: a rounding of its own, held by a tolerance (tests and
chip_smoke.py phase 15h).  The tensor-core route (``BS``
instantiations) rewrites q into that one bf16 term in shared memory, with
BAOS too, rounds S from the f32 accumulator, and enters P . V as one bf16
term; the CUDA-core and wide routes round the same values with a runtime
flag.  A masked key still adds exactly 0 once a row has seen a valid key,
so the REACH walk keeps the function.  The backward (every route) first
writes qg into a scratch of q's size (``flash_bidir_bwd_qscale``), which
its kernels read in place of q; S is recomputed and rounded, P formed as
the forward forms it, and dP = bf16(bf16(dp / l) - bf16(delta / l)), dS =
bf16(P dP), dq = bf16(dS K) D^-1/2, dk = bf16(dS^T qg) and dv rounded to
bf16, where JAX's gradient rounds them, and, as jax.grad does, the
softmax max's cotangent (minus the row's sum of dS, from a pass of its
own) added to the dS of the row's keys at the max; the bf16 tensor-core
route takes the MASKED instantiations alone.  The plain backward is
autograd through the plain bf16-score forward.  Cross-attention
(models/transformer.py) and the hybrid's attention (models/rglru.py)
keep f32 scores, as JAX's.

Launch counts: a launch with bf16 scores counts as ``flash_bidir_bf16s``
(a backward as ``flash_bidir_bwd_bf16s``), whatever its route; any other
with ``causal=True`` counts as ``flash_bidir_causal`` (either source),
any other route B launch as ``flash_bidir_split``, any other as
``flash_bidir_offset`` when its mask reads the offset from device memory
and else as ``flash_bidir``; a causal backward as
``flash_bidir_bwd_causal``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import sampling
from repro_torch.kernels import _build

NAME = "flash_bidir"
BWD_NAME = "flash_bidir_bwd"
# route B's launches (a second K/V source), counted apart from NAME's
SPLIT_NAME = "flash_bidir_split"
# launches of the cache alone whose mask reads the query offset from
# device memory; causal launches; causal backwards
OFFSET_NAME = "flash_bidir_offset"
CAUSAL_NAME = "flash_bidir_causal"
BWD_CAUSAL_NAME = "flash_bidir_bwd_causal"
# the cached forward's backward: with BAOS, over route B's two sources, and
# over the cache alone with a device query offset
BWD_BAOS_NAME = "flash_bidir_bwd_baos"
BWD_SPLIT_NAME = "flash_bidir_bwd_split"
BWD_OFFSET_NAME = "flash_bidir_bwd_offset"
# launches with bf16 scores (JAX's score_dtype="bfloat16"), forward and
# backward, whatever their route
BF16S_NAME = "flash_bidir_bf16s"
BWD_BF16S_NAME = "flash_bidir_bwd_bf16s"
# the score dtypes: JAX's default f32, and its bf16 scores
SCORE_DTYPES = ("float32", "bfloat16")
# JAX's default key chunk (layers.attention's kv_chunk): the plain
# bf16-score version rounds P relative to each chunk's max
KV_CHUNK = 1024
# a query offset: a host int, or an integer tensor on q's device
Offset = Union[int, torch.Tensor]
# the tile widths the kernel is instantiated for (csrc/flash_bidir.cu
# tile_of); a head dim runs in the smallest one that holds it
TILES = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_ROUTES = {torch.bfloat16: "tensor cores", torch.float32: "CUDA cores"}
# bf16 terms of each f32 operand on the tensor-core route (SPLIT in
# csrc/flash_bidir.cu): three carry the 24-bit f32 significand
SPLIT_TERMS = 3
# the backward's bf16 route (csrc/flash_bidir_bwd.cu, kept in step with
# its constants): dq CTAs of up to 8 warps of 16 rows over a ring of
# 64-key K/V tiles (3 stages; 32-key tiles under a mask and at tile 256,
# 2 stages there); dk/dv CTAs of 64 keys walking 32-row chunks through a
# 3-stage ring (8 warps at tile 256, where two warps share a key's sums,
# else 4); P and dS enter their products as one bf16 rounding each
BWD_STAGES, BWD_MAX_WARPS = 3, 8
BWD_BN, BWD_BM = 64, 32
# the fewest rows a block of the dk/dv pass's row split keeps (4 chunks)
BWD_MIN_SPLIT_ROWS = 128
BWD_P_TERMS = 1
SMEM_LIMIT_BYTES = 232448          # sm_90's opt-in shared memory a block
H100_SMS = 132
# head dims past TILES[-1]: the wide CUDA-core kernels (both .cu files)
# split the output columns over CTAs in slices of WIDE_SLICE and form the
# scores in chunks of WIDE_CHUNK columns
WIDE_ROUTE = "CUDA cores, column slices"
WIDE_SLICE, WIDE_CHUNK = 256, 128


def route(D: int, dtype: torch.dtype) -> Tuple[str, int]:
    """(route, tile width) the kernel runs head dim D of ``dtype`` in: up
    to 256 'tensor cores' for bf16 at a D that is a multiple of 8 and
    'CUDA cores' for any other, in the smallest of ``TILES`` >= D (columns
    past D are loaded as zeros and not stored); past 256 ``WIDE_ROUTE``,
    whose tile is the ``WIDE_SLICE`` output columns of a CTA."""
    if D < 1:
        raise ValueError(f"head dim {D} must be positive")
    if dtype not in _ROUTES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if D > TILES[-1]:
        return WIDE_ROUTE, WIDE_SLICE
    tile = next(t for t in TILES if t >= D)
    return ("CUDA cores" if D % 8 else _ROUTES[dtype]), tile


def n_slices(D: int) -> int:
    """The output slices of the wide route (1 up to 256)."""
    return -(-D // WIDE_SLICE)


def wide_smem() -> Tuple[int, int, int, int]:
    """Dynamic shared memory of the wide kernels, in bytes: the forward's
    CTA, and the backward's statistics, dq and dk/dv CTAs (the chunked S
    and dP products' q, dO, K and V chunks, plus each kernel's slice
    columns; csrc/flash_bidir.cu wide_smem_bytes, csrc/flash_bidir_bwd.cu
    wide_*_smem_bytes)."""
    bq, bk, ch, dv = 16, 32, WIDE_CHUNK, WIDE_SLICE
    sdp = 2 * bq * ch + 2 * bk * (ch + 1)
    return ((bq * ch + bk * (ch + 1) + bk * dv) * 4, sdp * 4,
            (sdp + bk * dv) * 4,
            (sdp + 2 * bq * bk + 5 * bq + 2 * bq * dv) * 4)


def check_score_dtype(score_dtype: str) -> bool:
    """Whether ``score_dtype`` asks for bf16 scores; a name outside
    ``SCORE_DTYPES`` raises ValueError."""
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"score_dtype {score_dtype!r} not in "
                         f"{SCORE_DTYPES}")
    return score_dtype == "bfloat16"


def score_scale(D: int, dtype: torch.dtype, bf16_scores: bool) -> float:
    """The softmax scale D^-1/2: with bf16 scores rounded to the
    activations' dtype first (JAX multiplies q by it in q's dtype)."""
    if not bf16_scores:
        return D ** -0.5
    return float(torch.tensor(D ** -0.5, dtype=dtype))


def offset_start(q_offset: Offset):
    """A query offset: an int as it is, or element 0 of an integer tensor
    as an int64 0-d tensor on its device (no host read)."""
    if not isinstance(q_offset, torch.Tensor):
        return q_offset
    if q_offset.numel() < 1 or q_offset.dtype.is_floating_point or \
            q_offset.dtype.is_complex or q_offset.dtype == torch.bool:
        raise ValueError(f"a q_offset tensor must hold integers; got "
                         f"{q_offset.dtype} {tuple(q_offset.shape)}")
    return q_offset.reshape(-1)[0].to(torch.int64)


def flash_bidir_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_valid: Optional[torch.Tensor] = None,
                      fk: Optional[torch.Tensor] = None,
                      fv: Optional[torch.Tensor] = None,
                      cv: Optional[torch.Tensor] = None,
                      window: Optional[int] = None,
                      q_offset: Offset = 0, extra_kv=None,
                      causal: bool = False, score_dtype: str = "float32",
                      kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Plain version: dense f32 scores and softmax, (B, Sq, Hq, D) in
    q's dtype; ``extra_kv`` joins the key set (its key j at q_offset + j).
    With ``score_dtype="bfloat16"``, JAX's bf16 scores in its chunks of
    ``kv_chunk`` keys (``_plain_bf16_scores``)."""
    if check_score_dtype(score_dtype):
        return _plain_bf16_scores(q, k, v, kv_valid, fk, fv, cv, window,
                                  q_offset, extra_kv, causal, kv_chunk)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_offset = offset_start(q_offset)
    kpos = None
    if extra_kv is not None:
        k2, v2, valid2 = extra_kv
        S2 = k2.shape[1]
        kpos = torch.cat([torch.arange(Skv, device=q.device),
                          q_offset + torch.arange(S2, device=q.device)])
        if kv_valid is not None or valid2 is not None:
            ones = torch.ones((B, Skv + S2), dtype=torch.bool,
                              device=q.device)
            kv_valid = torch.cat([ones[:, :Skv] if kv_valid is None
                                  else kv_valid.to(torch.bool),
                                  ones[:, Skv:] if valid2 is None
                                  else valid2.to(torch.bool)], dim=1)
        k, v = torch.cat([k, k2], dim=1), torch.cat([v, v2], dim=1)
        Skv += S2
    qf = q.to(torch.float32)
    if fk is not None:
        qf = qf * fk.to(torch.float32).repeat_interleave(G, dim=1)[:, None]
    qf = qf * D ** -0.5
    kf = k.to(torch.float32).repeat_interleave(G, dim=2)
    vf = v.to(torch.float32).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    ok = _mask(B, Sq, Skv, kv_valid, window, q_offset, q.device, kpos,
               causal)
    s = torch.where(ok, s, sampling.NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    l = torch.sum(p, dim=-1)                               # (B, Hq, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    o = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    if fv is not None:
        o = o * fv.to(torch.float32).repeat_interleave(G, dim=1)[:, None]
    if cv is not None:
        o = o + cv.to(torch.float32).repeat_interleave(G, dim=1)[:, None]
    return o.to(q.dtype)


# bf16(-1e30): a masked bf16 score (JAX adds the -1e30 bias in bf16)
NEG_BF16 = float(torch.tensor(sampling.NEG_INF, dtype=torch.bfloat16))


def _bf16_partial(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ok: torch.Tensor):
    """JAX's ``attention_partials.partial`` with bf16 scores over one
    chunk: qg (B, Sq, Hq, D) bf16, k/v (B, n, Hkv, D), ok (B, 1, Sq, n).
    (m, l, o) f32, (B, Hq, Sq[, D]).  Each step rounds where JAX's does,
    in the dtype JAX computes it in, so autograd differentiates the same
    roundings ``jax.grad`` does."""
    G = qg.shape[2] // k.shape[2]
    kg = k.to(torch.bfloat16).float().repeat_interleave(G, dim=2)
    vg = v.to(torch.bfloat16).float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qg.float(), kg).to(torch.bfloat16)
    s = torch.where(ok, s, torch.full((), NEG_BF16, dtype=torch.bfloat16,
                                      device=s.device))
    m = torch.clamp(torch.amax(s, dim=-1).float(), min=sampling.NEG_INF)
    p = torch.exp(s - m.to(torch.bfloat16)[..., None])
    o = torch.einsum("bhqk,bkhd->bhqd", p.float(), vg)
    return m, torch.sum(p.float(), dim=-1), o


def combine_partials(a, b):
    """Exact online-softmax merge of two (m, l, o_unnorm) partials (JAX's
    ``layers.combine_partials``)."""
    m_a, l_a, o_a = a
    m_b, l_b, o_b = b
    m = torch.maximum(m_a, m_b)
    ca, cb = torch.exp(m_a - m), torch.exp(m_b - m)
    return m, l_a * ca + l_b * cb, o_a * ca[..., None] + o_b * cb[..., None]


def _plain_bf16_scores(q, k, v, kv_valid, fk, fv, cv, window, q_offset,
                       extra_kv, causal, kv_chunk: int) -> torch.Tensor:
    """JAX's ``layers.attention`` with ``score_dtype=bfloat16``:
    qg = bf16(q * f_k * D^-1/2) (the scale rounded to q's dtype as JAX's
    is; f_k and the products in f32, as the port fuses BAOS), S =
    bf16(qg . bf16(k)) (f32 sums), P = bf16(exp(bf16(S - bf16(m)))) with
    m the chunk's max (at least -1e30), l = sum P and
    o = P . bf16(v) in f32, per chunk of ``kv_chunk`` keys (one chunk where
    it does not divide Skv; route B's second source a chunk of its own),
    chunks merged in f32; o / max(l, 1e-30), f_v, c_v in f32, rounded once
    to q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_offset = offset_start(q_offset)
    qf = q.to(torch.float32)
    if fk is not None:
        qf = qf * fk.to(torch.float32).repeat_interleave(G, dim=1)[:, None]
    qg = (qf * score_scale(D, q.dtype, True)).to(torch.bfloat16)
    ok = _mask(B, Sq, Skv, kv_valid, window, q_offset, q.device,
               causal=causal)
    n = max(1, Skv // kv_chunk) if Skv % kv_chunk == 0 else 1
    c = Skv // n
    part = None
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        p = _bf16_partial(qg, k[:, sl], v[:, sl], ok[..., sl])
        part = p if part is None else combine_partials(part, p)
    if extra_kv is not None:
        k2, v2, valid2 = extra_kv
        S2 = k2.shape[1]
        kpos = q_offset + torch.arange(S2, device=q.device)
        ok2 = _mask(B, Sq, S2, valid2, window, q_offset, q.device, kpos,
                    causal)
        part = combine_partials(part, _bf16_partial(qg, k2, v2, ok2))
    _, l, o = part
    o = (o / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    if fv is not None:
        o = o * fv.to(torch.float32).repeat_interleave(G, dim=1)[:, None]
    if cv is not None:
        o = o + cv.to(torch.float32).repeat_interleave(G, dim=1)[:, None]
    return o.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function(NAME, "flash_bidir_launch",
                           [p] * 7 + [i] + [p] * 4 + [i] * 6 +
                           [ctypes.c_float, i, i, p, i, i, i, p])


def _cal(t: Optional[torch.Tensor], shape, dev) -> Optional[int]:
    if t is None:
        return None
    if tuple(t.shape) != shape or t.dtype != torch.float32 or \
            t.device != dev or not t.is_contiguous():
        raise ValueError(f"BAOS calibration must be contiguous f32 {shape} "
                         f"on {dev}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.data_ptr()


def flash_bidir(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_valid: Optional[torch.Tensor] = None,
                fk: Optional[torch.Tensor] = None,
                fv: Optional[torch.Tensor] = None,
                cv: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                q_offset: Offset = 0, extra_kv=None,
                causal: bool = False, score_dtype: str = "float32",
                kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); kv_valid (B, Skv) bool;
    fk/fv/cv (B, Hkv, D) f32; query row r at position q_offset + r
    (``q_offset`` an int or an integer tensor on q's device, element 0
    read); ``extra_kv`` = (k2, v2, valid2): route B's second K/V source,
    (B, S2, Hkv, D) each and valid2 (B, S2) bool or None, key j at
    q_offset + j; ``causal``: key position <= query position;
    ``score_dtype`` "float32" or "bfloat16" (JAX's bf16 scores; the plain
    version rounds P relative to each chunk of ``kv_chunk`` keys, the
    kernel relative to its running max).  Returns (B, Sq, Hq, D) in q's
    dtype.  CUDA tensors run the kernel; CPU tensors the plain version.
    Under autograd (grad mode on, q, k or v requiring grad) the result
    carries ``FlashBidir``'s backward."""
    check_score_dtype(score_dtype)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} with k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)}: not a GQA attention")
    if kv_valid is not None and kv_valid.shape != (B, Skv):
        raise ValueError(f"kv_valid {tuple(kv_valid.shape)} != {(B, Skv)}")
    if extra_kv is not None:
        k2, v2, valid2 = extra_kv
        S2 = k2.shape[1]
        if k2.shape != (B, S2, Hkv, D) or v2.shape != k2.shape or \
                (valid2 is not None and valid2.shape != (B, S2)):
            raise ValueError(f"extra_kv k2 {tuple(k2.shape)}, v2 "
                             f"{tuple(v2.shape)}: not a second source of "
                             f"k {tuple(k.shape)}")
    k2, v2, valid2 = (None,) * 3 if extra_kv is None else tuple(extra_kv)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, fk, fv, cv, k2, v2)):
        return FlashBidir.apply(q, k, v, kv_valid, fk, fv, cv, k2, v2,
                                valid2, window, q_offset, causal,
                                score_dtype, kv_chunk)
    return _forward(q, k, v, kv_valid, fk, fv, cv, window, q_offset,
                    extra_kv, causal, score_dtype, kv_chunk)


def _forward(q, k, v, kv_valid, fk, fv, cv, window: Optional[int],
             q_offset: Offset, extra_kv=None, causal: bool = False,
             score_dtype: str = "float32", kv_chunk: int = KV_CHUNK):
    """One forward launch (or the plain version)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_bidir_plain(q, k, v, kv_valid, fk, fv, cv, window,
                                 q_offset, extra_kv, causal, score_dtype,
                                 kv_chunk)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: "
                         f"need one of {_DTYPES} for all three")
    route(D, q.dtype)
    bf16s = check_score_dtype(score_dtype)
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be positive")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    valid = None
    if kv_valid is not None:
        if kv_valid.device != dev or not kv_valid.is_contiguous():
            raise ValueError(f"kv_valid must be contiguous on {dev}")
        valid = kv_valid.to(torch.bool)
    k2 = v2 = valid2 = None
    S2 = 0
    if extra_kv is not None:
        k2, v2, valid2 = extra_kv
        S2 = k2.shape[1]
        if any(t.device != dev or t.dtype != q.dtype or
               not t.is_contiguous() for t in (k2, v2)):
            raise ValueError(f"extra_kv's k2 and v2 must be contiguous "
                             f"{q.dtype} on {dev}")
        if valid2 is not None:
            if valid2.device != dev or not valid2.is_contiguous():
                raise ValueError(f"extra_kv's valid2 must be contiguous on "
                                 f"{dev}")
            valid2 = valid2.to(torch.bool)
    # the offset places only the window and the causal mask; a tensor
    # reaches the kernel as a one-element int64 tensor on dev (a view, or a
    # conversion on the device that a graph captures)
    off, off_dev = 0, None
    if window is not None or causal:
        if not isinstance(q_offset, torch.Tensor):
            off = q_offset
        elif q_offset.device != dev:
            raise ValueError(f"q_offset on {q_offset.device}, q on {dev}")
        else:
            off_dev = offset_start(q_offset).reshape(1)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       _build.ptr(valid), _build.ptr(k2), _build.ptr(v2),
                       _build.ptr(valid2), S2,
                       _cal(fk, (B, Hkv, D), dev),
                       _cal(fv, (B, Hkv, D), dev), _cal(cv, (B, Hkv, D), dev),
                       out.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
                       score_scale(D, q.dtype, bf16s),
                       0 if window is None else int(window), off,
                       _build.ptr(off_dev), int(causal),
                       int(q.dtype == torch.bfloat16), 1 if bf16s else 0,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[count_name(extra_kv is not None, causal,
                                    off_dev is not None, bf16s)] += 1
    return out


def count_name(split: bool, causal: bool, device_offset: bool,
               bf16_scores: bool = False) -> str:
    """The launch-count entry of a forward launch (module docstring)."""
    if bf16_scores:
        return BF16S_NAME
    if causal:
        return CAUSAL_NAME
    if split:
        return SPLIT_NAME
    return OFFSET_NAME if device_offset else NAME


class FlashBidir(torch.autograd.Function):
    """Attention with a backward: the forward kernel (or plain version),
    unchanged, then ``flash_bidir_bwd`` from the saved inputs: q, k, v,
    the BAOS calibration, route B's second source and the query offset (a
    device tensor is saved as it is, so the backward reads the forward's
    block start).  The gradients it returns are those of the inputs that
    require grad; the cache's dk/dv are skipped where k and v do not (the
    split refine's read-only cache)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, fk, fv, cv, k2, v2, valid2, window,
                q_offset, causal=False, score_dtype="float32",
                kv_chunk=KV_CHUNK):
        off = q_offset if isinstance(q_offset, torch.Tensor) else None
        ctx.save_for_backward(q, k, v, kv_valid, fk, fv, cv, k2, v2, valid2,
                              off)
        ctx.window, ctx.causal = window, causal
        ctx.q_offset = None if off is not None else q_offset
        ctx.score_dtype, ctx.kv_chunk = score_dtype, kv_chunk
        extra = None if k2 is None else (k2, v2, valid2)
        return _forward(q, k, v, kv_valid, fk, fv, cv, window, q_offset,
                        extra, causal, score_dtype, kv_chunk)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, fk, fv, cv, k2, v2, valid2, off = \
            ctx.saved_tensors
        q_offset = off if off is not None else ctx.q_offset
        need = ctx.needs_input_grad
        extra = None if k2 is None else (k2, v2, valid2)
        dq, dk, dv, dfk, dfv, dcv, dk2, dv2 = flash_bidir_bwd(
            q, k, v, dout.contiguous(), kv_valid, ctx.window, q_offset,
            ctx.causal, ctx.score_dtype, ctx.kv_chunk, fk=fk, fv=fv, cv=cv,
            extra_kv=extra, needs=need[:3] + need[4:9])
        return (dq, dk, dv, None, dfk, dfv, dcv, dk2, dv2) + (None,) * 6


def _mask(B: int, Sq: int, Skv: int, kv_valid, window, q_offset, device,
          kpos: Optional[torch.Tensor] = None,
          causal: bool = False) -> torch.Tensor:
    """(B, 1, Sq, Skv) bool: the keys each query row attends to; query row
    r at ``q_offset + r`` (an int or a 0-d tensor), key j at ``kpos[j]``
    (default j); JAX's ``_mask_bias`` in modes bidir and causal."""
    ok = torch.ones((B, 1, Sq, Skv), dtype=torch.bool, device=device)
    if kv_valid is not None:
        ok = ok & kv_valid.to(torch.bool)[:, None, None, :]
    if window is not None or causal:
        qp = q_offset + torch.arange(Sq, device=device)[:, None]
        kp = (torch.arange(Skv, device=device) if kpos is None
              else kpos)[None, :]
        if causal:
            ok = ok & (kp <= qp)
            if window is not None:
                ok = ok & (qp - kp < window)
        else:
            ok = ok & (torch.abs(qp - kp) < window)
    return ok


def flash_bidir_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dout: torch.Tensor,
                          kv_valid: Optional[torch.Tensor] = None,
                          window: Optional[int] = None, q_offset: Offset = 0,
                          causal: bool = False,
                          score_dtype: str = "float32",
                          kv_chunk: int = KV_CHUNK, *,
                          fk: Optional[torch.Tensor] = None,
                          fv: Optional[torch.Tensor] = None,
                          cv: Optional[torch.Tensor] = None, extra_kv=None,
                          needs: Optional[Tuple[bool, ...]] = None
                          ) -> Tuple[Optional[torch.Tensor], ...]:
    """Plain version of the backward: (dq, dk, dv, dfk, dfv, dcv, dk2, dv2)
    as ``flash_bidir_bwd`` returns them.  Without the calibration, a second
    source or bf16 scores, step by step in f32 from recomputed
    probabilities, (dq, dk, dv) in the inputs' dtype: delta_i =
    sum_j p_ij dp_ij, the f32 value of dO_i . o_i (the forward's output,
    rounded to bf16, would carry that rounding into every ds_ij); dk and dv
    sum over the q heads of each KV head's group.  Otherwise autograd
    through ``flash_bidir_plain``: with bf16 scores JAX's structure of
    rounding as ``jax.grad`` differentiates it (dP, dS, dq and dk come
    out of bf16 products; dv is rounded to bf16); ``needs`` (8 flags for
    q, k, v, fk, fv, cv, k2, v2) leaves None where a gradient is not
    wanted."""
    if fk is not None or fv is not None or cv is not None or \
            extra_kv is not None or check_score_dtype(score_dtype):
        k2, v2, valid2 = (None,) * 3 if extra_kv is None else extra_kv
        needs = (True,) * 8 if needs is None else tuple(needs)
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip((q, k, v, fk, fv, cv, k2, v2), needs)]
            ext = None if k2 is None else (leaves[6], leaves[7], valid2)
            # bf16 scores: the plain forward's own body, as it runs it
            fwd = (functools.partial(_plain_bf16_scores, kv_chunk=kv_chunk)
                   if check_score_dtype(score_dtype) else flash_bidir_plain)
            out = fwd(leaves[0], leaves[1], leaves[2], kv_valid, leaves[3],
                      leaves[4], leaves[5], window, q_offset, ext, causal)
            want = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(out, want, dout,
                                           allow_unused=True))
        return tuple(None if t is None or not t.requires_grad else next(got)
                     for t in leaves)
    q_offset = offset_start(q_offset)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qf, dof = q.to(torch.float32), dout.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(G, dim=2)
    vf = v.to(torch.float32).repeat_interleave(G, dim=2)
    ok = _mask(B, Sq, Skv, kv_valid, window, q_offset, q.device,
               causal=causal)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = torch.where(ok, s, sampling.NEG_INF)
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.sum(p * dp, dim=-1, keepdim=True)
    ds = torch.where(ok, p * (dp - delta), 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Skv, Hkv, G, D).sum(dim=3)
    dv = dv.reshape(B, Skv, Hkv, G, D).sum(dim=3)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 5


def bwd_dq_bkv(dt: int, masked: bool) -> int:
    """Keys per K/V tile of the bf16 dq kernel at tile width ``dt``,
    ``masked`` where kv_valid, a window or the causal mask can hide a key
    (its MASKED instantiations)."""
    return 32 if dt == 256 or masked else 64


def bwd_dq_smem(dt: int, masked: bool, warps: int, terms: int = 1) -> int:
    """Dynamic shared memory of a bf16 dq CTA of ``warps`` warps at tile
    width ``dt``: the K and V rings and each warp's q and dO rows in
    ``terms`` bf16 terms each (2 with BAOS), bf16 rows padded by 8
    elements (csrc/flash_bidir_bwd.cu dq_tc_smem_bytes)."""
    stages = 2 if dt == 256 else BWD_STAGES
    return ((2 * stages * bwd_dq_bkv(dt, masked) + 2 * terms * 16 * warps)
            * (dt + 8) * 2)


def bwd_dq_max_warps(dt: int, masked: bool, terms: int = 1) -> int:
    """The most warps a bf16 dq CTA takes at tile width ``dt``."""
    w = BWD_MAX_WARPS
    while w > 1 and bwd_dq_smem(dt, masked, w, terms) > SMEM_LIMIT_BYTES:
        w -= 1
    return w


def bwd_dkv_stages(dt: int, terms: int = 1) -> int:
    """The dk/dv ring's depth: 2 at tile 256 with two terms, else 3."""
    return 2 if dt == 256 and terms == 2 else BWD_STAGES


def bwd_dkv_smem(dt: int, bf16_scores: bool = False, terms: int = 1) -> int:
    """Dynamic shared memory of a bf16 dk/dv CTA at tile width ``dt``: its
    K/V tile and the ring of row chunks (``terms`` bf16 terms of q and dO)
    with their statistics (a fourth row with bf16 scores: the softmax
    max's cotangent)."""
    st = bwd_dkv_stages(dt, terms)
    return ((2 * BWD_BN + 2 * terms * st * BWD_BM) * (dt + 8) * 2
            + st * (4 if bf16_scores else 3) * BWD_BM * 4)


def bwd_dkv_warps(dt: int) -> int:
    """Warps of a bf16 dk/dv CTA: one per 16 keys, two at tile 256."""
    return 4 * (2 if dt == 256 else 1)


def bwd_f32_smem(dt: int) -> Tuple[int, int]:
    """Dynamic shared memory of the CUDA-core route's dq and dk/dv CTAs
    (f32, and bf16 at a D that is not a multiple of 8)."""
    return ((2 * 16 * dt + 2 * 32 * (dt + 1)) * 4,
            (2 * 32 * (dt + 1) + 2 * 16 * dt + 2 * 16 * 32 + 5 * 16) * 4)


def _per_sm(warps: int, smem: int) -> int:
    """CTAs of ``warps`` warps and ``smem`` bytes an SM holds at once."""
    return min(SMEM_LIMIT_BYTES // smem, 64 // warps)


def _sm_time(ctas: int, work: float, warps: int, smem: int,
             n_sm: int) -> float:
    """The time the busiest SM takes, in warp-tasks at one warp's rate:
    ``ctas`` CTAs of ``warps`` warps, each ``work`` warp-tasks, spread
    evenly over ``n_sm`` SMs, as many resident at once as ``_per_sm``
    allows.  A model of the SM's rate, not a measurement: each of its
    first four resident warps (one per scheduler) adds a warp's rate, each
    of the next four half of one, more add nothing."""
    c = -(-ctas // n_sm)
    w = min(_per_sm(warps, smem), c) * warps
    return c * work / (min(w, 4) + 0.5 * max(0, min(w, 8) - 4))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``flash_bidir_bwd`` launches one call (module docstring)."""
    route: str              # 'tensor cores', 'CUDA cores' or WIDE_ROUTE
    tile: int               # DT: the smallest instantiated width >= D, or
    #                         the wide route's output slice
    masked: bool            # the bf16 MASKED instantiations (a mask can cut)
    dq_keys: int            # keys per K/V tile of the dq pass
    dq_warps: int           # warps of a dq CTA (16 rows each; f32: 4 x 4)
    dq_ctas: int
    dkv_ctas: int
    n_split: int            # row blocks of a group in the dk/dv pass
    split_rows: int         # packed rows a block holds (the last: the rest)
    stats_floats: int       # the row-statistics scratch
    part_floats: int        # the split partials' scratch (0: none)
    dq_smem: int            # dynamic shared memory of a dq / dk-dv CTA
    dkv_smem: int


@functools.lru_cache(maxsize=None)
def bwd_plan(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, D: int,
             dtype: torch.dtype, n_sm: int = H100_SMS,
             masked: bool = False, terms: int = 1) -> BwdPlan:
    """The launch plan of ``flash_bidir_bwd`` on a card of ``n_sm`` SMs;
    ``masked``: kv_valid, a window or the causal mask is given; ``terms``:
    bf16 terms of q and dO on the bf16 route (2 with BAOS, which takes the
    masked instantiations).  Skv counts the keys whose dk/dv the dk/dv pass
    forms (both of route B's sources, in whole 64-key tiles).

    bf16: each pass takes the layout whose busiest SM finishes first, by
    ``_sm_time``: a dq CTA of 1 to 8 warps (up to what its shared memory
    allows; the most warps on a tie), and for the dk/dv pass a cut
    of the G x Sq rows of a group into ``n_split`` contiguous blocks of
    whole 32-row chunks, each at least ``BWD_MIN_SPLIT_ROWS`` rows, at
    most two waves of CTAs (the fewest blocks on a tie).  The rows are not
    split where Skv / 64 x Hkv x B CTAs alone fill the card's n_sm SMs.
    The CUDA-core route (f32, and bf16 at a D that is not a multiple of
    8): its kernels' fixed grids, no split.  The wide route (D past 256):
    a statistics CTA per 16 rows of a q head, then a dq CTA per 16 rows
    and a dk/dv CTA per 32 keys, each for every output slice; its dq_ctas
    count the statistics CTAs too.  Cached: a train step asks for the
    same plan once a layer."""
    rte, dt = route(D, dtype)
    G = Hq // Hkv
    n_rows = G * Sq
    if rte == WIDE_ROUTE:
        _, st_smem, dq_smem, dkv_smem = wide_smem()
        n = n_slices(D)
        return BwdPlan(rte, dt, masked, 32, 4,
                       -(-Sq // 16) * Hq * B * (1 + n),
                       -(-Skv // 32) * Hkv * B * n, 1, n_rows,
                       3 * B * Hq * Sq, 0, dq_smem, dkv_smem)
    if rte == "CUDA cores":
        dq_smem, dkv_smem = bwd_f32_smem(dt)
        return BwdPlan(rte, dt, masked, 32, 4,
                       -(-Sq // 16) * Hq * B,
                       -(-Skv // 32) * Hkv * B, 1, n_rows,
                       3 * B * Hq * Sq, 0, dq_smem, dkv_smem)
    max_w = bwd_dq_max_warps(dt, masked, terms)

    def dq_ctas(w):
        return -(-n_rows // (16 * w)) * Hkv * B

    def dq_time(w):      # a CTA's K/V walk: half a warp's rows more
        return _sm_time(dq_ctas(w), min(w, -(-n_rows // 16)) + 0.5, w,
                        bwd_dq_smem(dt, masked, w, terms), n_sm)
    dq_w = min(range(1, max_w + 1), key=lambda w: (dq_time(w), -w))
    base = -(-Skv // BWD_BN) * Hkv * B
    kv_w = bwd_dkv_warps(dt)

    def rows_of(n):      # a block of n's rows, in whole chunks
        return -(-(-(-n_rows // n)) // BWD_BM) * BWD_BM

    # at least BWD_MIN_SPLIT_ROWS rows a block, at most two waves of the
    # CTAs an SM holds (each block more adds its partial sums' bytes)
    kv_smem = bwd_dkv_smem(dt, False, terms)
    most = min(n_rows // BWD_MIN_SPLIT_ROWS,
               2 * n_sm * _per_sm(kv_w, kv_smem) // base)
    cuts = range(1, max(1, most) + 1) if base < n_sm else [1]
    # a CTA's K/V tile and its sums' stores: one chunk's work more
    n_split = min(cuts, key=lambda n: (_sm_time(
        base * n, kv_w * (rows_of(n) // BWD_BM + 1), kv_w, kv_smem,
        n_sm), n))
    split_rows = rows_of(n_split)
    n_split = -(-n_rows // split_rows)
    nr = (n_rows + 3) // 4 * 4
    return BwdPlan("tensor cores", dt, masked, bwd_dq_bkv(dt, masked),
                   dq_w, dq_ctas(dq_w),
                   base * n_split, n_split, split_rows,
                   3 * B * Hkv * nr,
                   2 * n_split * B * Skv * Hkv * D if n_split > 1 else 0,
                   bwd_dq_smem(dt, masked, dq_w, terms), kv_smem)


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function(BWD_NAME, "flash_bidir_bwd_launch",
                           [p] * 11 + [i] * 6 +
                           [ctypes.c_float] + [i] * 8 + [p, p])


class _Extra(ctypes.Structure):
    """csrc/flash_bidir_bwd.cu BwdExtra, field by field: the cached
    forward's part of a backward launch."""
    _fields_ = [(name, ctypes.c_int if name in ("baos", "S2", "skip0")
                 else ctypes.c_void_p)
                for name in ("baos", "fk", "fv", "o_s", "dfk", "dfv", "dcv",
                             "q_hi", "q_lo", "d_hi", "d_lo", "dq32", "k2",
                             "v2", "valid2", "S2", "dk2", "dv2", "part2",
                             "skip0", "q_offset_dev")]


def bwd_count_name(split: bool, causal: bool, device_offset: bool,
                   baos: bool, bf16_scores: bool = False) -> str:
    """The launch-count entry of a backward launch: bf16 scores, causal,
    route B, BAOS, a device offset, in that order, else BWD_NAME."""
    if bf16_scores:
        return BWD_BF16S_NAME
    if causal:
        return BWD_CAUSAL_NAME
    if split:
        return BWD_SPLIT_NAME
    if baos:
        return BWD_BAOS_NAME
    return BWD_OFFSET_NAME if device_offset else BWD_NAME


def flash_bidir_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dout: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, q_offset: Offset = 0,
                    causal: bool = False, score_dtype: str = "float32",
                    kv_chunk: int = KV_CHUNK, *,
                    fk: Optional[torch.Tensor] = None,
                    fv: Optional[torch.Tensor] = None,
                    cv: Optional[torch.Tensor] = None, extra_kv=None,
                    needs: Optional[Tuple[bool, ...]] = None):
    """The gradients of ``flash_bidir`` for the output gradient ``dout``
    (B, Sq, Hq, D): (dq, dk, dv, dfk, dfv, dcv, dk2, dv2), those of q, k,
    v, BAOS's fk/fv/cv and route B's second source (``extra_kv``), None
    for an input not given or, by ``needs`` (8 flags in that order), not
    wanted.  dk, dv (and dk2, dv2) are in the cache's
    smoothed space; dfk, dfv, dcv (B, Hkv, D) f32.  CUDA tensors run
    csrc/flash_bidir_bwd.cu as ``bwd_plan`` lays it out (one count in
    ``launch_counts`` per call, ``bwd_count_name``: its kernels, dq then
    dk/dv, then on the bf16 route the split sum where n_split > 1; with
    bf16 scores first the query prescale, into a scratch of q's size; with
    BAOS first the terms of q * f_k and dO * f_v, last dq and the
    calibration's sums, and before them one forward launch for the
    uncorrected output o_s that df_v reads, counted as a forward launch);
    CPU tensors the plain version.
    ``q_offset`` an int or an integer tensor on q's device, read from
    device memory by every kernel."""
    bf16s = check_score_dtype(score_dtype)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or Hq % Hkv or \
            dout.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, dout {tuple(dout.shape)}: not "
                         f"a GQA attention")
    baos = fk is not None or fv is not None or cv is not None
    cached = baos or extra_kv is not None
    needs = (True,) * 8 if needs is None else tuple(needs)
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_bidir_bwd_plain(q, k, v, dout, kv_valid, window,
                                     q_offset, causal, score_dtype, kv_chunk,
                                     fk=fk, fv=fv, cv=cv, extra_kv=extra_kv,
                                     needs=needs)
    dev = q.device
    ts = (q, k, v, dout)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("q, k, v and dout must lie on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"q/k/v/dout dtypes "
                         f"{[str(t.dtype) for t in ts]}: need one of "
                         f"{_DTYPES} for all four")
    route(D, q.dtype)
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be positive")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k, v and dout must be contiguous")
    valid = None
    if kv_valid is not None:
        if kv_valid.device != dev or not kv_valid.is_contiguous():
            raise ValueError(f"kv_valid must be contiguous on {dev}")
        valid = kv_valid.to(torch.bool)
    k2 = v2 = valid2 = None
    S2 = 0
    if extra_kv is not None:
        k2, v2, valid2 = extra_kv
        S2 = k2.shape[1]
        if k2.shape != (B, S2, Hkv, D) or v2.shape != k2.shape or any(
                t.device != dev or t.dtype != q.dtype or
                not t.is_contiguous() for t in (k2, v2)):
            raise ValueError(f"extra_kv's k2 and v2 must be contiguous "
                             f"{q.dtype} (B, S2, Hkv, D) on {dev}")
        if valid2 is not None:
            if valid2.device != dev or not valid2.is_contiguous():
                raise ValueError(f"extra_kv's valid2 must be contiguous on "
                                 f"{dev}")
            valid2 = valid2.to(torch.bool)
    off, off_dev = 0, None
    if window is not None or causal:
        if not isinstance(q_offset, torch.Tensor):
            off = q_offset
        elif q_offset.device != dev:
            raise ValueError(f"q_offset on {q_offset.device}, q on {dev}")
        else:
            off_dev = offset_start(q_offset).reshape(1)
    cal = {"fk": fk, "fv": fv, "cv": cv}
    for t in cal.values():
        _cal(t, (B, Hkv, D), dev)
    skip0 = cached and not (needs[1] or needs[2])
    want2 = k2 is not None and (needs[6] or needs[7])
    dq = torch.empty_like(q)
    dk, dv = ((None, None) if skip0 else
              (torch.empty_like(k), torch.empty_like(v)))
    dk2, dv2 = ((torch.empty_like(k2), torch.empty_like(v2)) if want2
                else (None, None))
    grads_cal = {n: torch.empty((B, Hkv, D), dtype=torch.float32,
                                device=dev)
                 if cal[n] is not None and needs[3 + i] else None
                 for i, n in enumerate(("fk", "fv", "cv"))}
    if q.numel() == 0 or Skv + S2 == 0:
        zero = [t.zero_() if t is not None else None
                for t in (dq, dk, dv, *grads_cal.values(), dk2, dv2)]
        return tuple(zero)
    masked = (kv_valid is not None or valid2 is not None or
              window is not None or causal or bf16s or baos)
    n_tiles = (0 if skip0 else -(-Skv // BWD_BN)) + \
        (-(-S2 // BWD_BN) if want2 else 0)
    plan = bwd_plan(B, Sq, BWD_BN * max(n_tiles, 1) if cached else Skv, Hq,
                    Hkv, D, q.dtype, _build.sm_count(dev), masked,
                    2 if baos else 1)
    stats = torch.empty(plan.stats_floats // 3 * (4 if bf16s else 3),
                        dtype=torch.float32, device=dev)

    def parts(n_keys):
        if plan.n_split == 1 or not n_keys:
            return None
        return torch.empty(2 * plan.n_split * B * n_keys * Hkv * D,
                           dtype=torch.float32, device=dev)
    part = parts(0 if skip0 else Skv)
    qg = torch.empty_like(q) if bf16s and not baos else None
    ext = None
    if cached or off_dev is not None:
        ext = _Extra(S2=S2, skip0=1 if skip0 else 0,
                     baos=1 if baos else 0)
        if baos:
            two = q.dtype == torch.bfloat16
            scr = [torch.empty_like(q) for _ in range(4 if two else 2)]
            dq32 = torch.empty(q.shape, dtype=torch.float32, device=dev)
            o_s = None
            if grads_cal["fv"] is not None:
                o_s = _forward(q, k, v, kv_valid, fk, None, None, window,
                               q_offset, extra_kv, causal, score_dtype,
                               kv_chunk)
            ext.fk, ext.fv = _build.ptr(cal["fk"]), _build.ptr(cal["fv"])
            ext.o_s, ext.dq32 = _build.ptr(o_s), dq32.data_ptr()
            ext.q_hi, ext.d_hi = scr[0].data_ptr(), scr[1].data_ptr()
            if two:
                ext.q_lo, ext.d_lo = scr[2].data_ptr(), scr[3].data_ptr()
            ext.dfk, ext.dfv, ext.dcv = (_build.ptr(grads_cal[n])
                                         for n in ("fk", "fv", "cv"))
        if k2 is not None:
            part2 = parts(S2) if want2 else None
            ext.k2, ext.v2 = k2.data_ptr(), v2.data_ptr()
            ext.valid2 = _build.ptr(valid2)
            ext.dk2, ext.dv2 = _build.ptr(dk2), _build.ptr(dv2)
            ext.part2 = _build.ptr(part2)
        ext.q_offset_dev = _build.ptr(off_dev)
    err = _bwd_kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        _build.ptr(valid), dq.data_ptr(), _build.ptr(dk), _build.ptr(dv),
        stats.data_ptr(), _build.ptr(part), _build.ptr(qg),
        B, Sq, Skv, Hq, Hkv, D, score_scale(D, q.dtype, bf16s),
        0 if window is None else int(window), off, int(causal),
        int(q.dtype == torch.bfloat16), 1 if bf16s else 0, plan.dq_warps,
        plan.n_split, plan.split_rows,
        None if ext is None else ctypes.addressof(ext),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(BWD_NAME, err)
    _build.launch_counts[bwd_count_name(k2 is not None, causal,
                                        off_dev is not None, baos,
                                        bf16s)] += 1
    return (dq, dk, dv, grads_cal["fk"], grads_cal["fv"], grads_cal["cv"],
            dk2, dv2)
