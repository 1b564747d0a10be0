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
FMAs, no TF32).  Both take any head dim D that is a multiple of 8 up to
256, in the smallest instantiated tile that holds it (``route``); D past
256 or not a multiple of 8 raises ``NotImplementedError``
(``check_head_dim``), which ``models/layers.attention`` and the model's
config check call before any tick runs.

Gradients: while grad mode is on and q, k or v requires grad,
``flash_bidir`` runs as ``FlashBidir``, a ``torch.autograd.Function``
whose forward is the same kernel (or plain version) and whose backward is
``flash_bidir_bwd``: csrc/flash_bidir_bwd.cu for CUDA tensors, which
replaces no Pallas kernel (the JAX package trains through jax.grad of
models/layers.attention), and ``flash_bidir_bwd_plain`` for CPU tensors.
A row with no valid key averages V whatever its scores, so its dq and its
share of dk are 0.  BAOS calibration under autograd raises
``NotImplementedError``: training runs without a cache, as in JAX.

Route B, ``extra_kv=(k2, v2, valid2)``: a second K/V source, the split
active-block cache's buffer (models/transformer.py; JAX's
``layers.attention(extra_kv=)``), in the cache's smoothed space, its key j
at position q_offset + j.  The kernel walks its keys after the cache's in
the same online softmax, BAOS fused once, and counts the launch as
``flash_bidir_split``; the plain version takes the two sources as one key
set.  Autograd refuses it, as it refuses the calibration, and refuses a
tensor ``q_offset``: training runs without a cache.

Launch counts: a launch with ``causal=True`` counts as
``flash_bidir_causal`` (either source), any other route B launch as
``flash_bidir_split``, any other as ``flash_bidir_offset`` when its mask
reads the offset from device memory and else as ``flash_bidir``; a
causal backward as ``flash_bidir_bwd_causal``.
"""
from __future__ import annotations

import ctypes
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


def check_head_dim(D: int) -> None:
    """Raise NotImplementedError for a head dim the kernel does not take:
    past 256 or not a multiple of 8 (no config in src/repro/configs/ has
    one: their head dims are 64, 128 and 256)."""
    if not (8 <= D <= TILES[-1] and D % 8 == 0):
        raise NotImplementedError(
            f"head dim {D}: flash_bidir takes multiples of 8 up to "
            f"{TILES[-1]} (ROADMAP.md, Queue 3)")


def route(D: int, dtype: torch.dtype) -> Tuple[str, int]:
    """(route, tile width) the kernel runs head dim D of ``dtype`` in:
    'tensor cores' for bf16, 'CUDA cores' for f32, and the smallest of
    ``TILES`` >= D (columns past D are loaded as zeros and not stored)."""
    check_head_dim(D)
    if dtype not in _ROUTES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    return _ROUTES[dtype], next(t for t in TILES if t >= D)


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
                      causal: bool = False) -> torch.Tensor:
    """Plain version: dense f32 scores and softmax, (B, Sq, Hq, D) in
    q's dtype; ``extra_kv`` joins the key set (its key j at q_offset + j)."""
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


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function(NAME, "flash_bidir_launch",
                           [p] * 7 + [i] + [p] * 4 + [i] * 6 +
                           [ctypes.c_float, i, i, p, i, i, p])


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
                causal: bool = False) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); kv_valid (B, Skv) bool;
    fk/fv/cv (B, Hkv, D) f32; query row r at position q_offset + r
    (``q_offset`` an int or an integer tensor on q's device, element 0
    read); ``extra_kv`` = (k2, v2, valid2): route B's second K/V source,
    (B, S2, Hkv, D) each and valid2 (B, S2) bool or None, key j at
    q_offset + j; ``causal``: key position <= query position.  Returns
    (B, Sq, Hq, D) in q's dtype.  CUDA tensors run the kernel; CPU
    tensors the plain version.  Under autograd (grad mode on, q, k or v
    requiring grad) the result carries ``FlashBidir``'s backward."""
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
    extra = () if extra_kv is None else tuple(extra_kv)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, fk, fv, cv) + extra):
        if fk is not None or fv is not None or cv is not None:
            raise NotImplementedError(
                "flash_bidir's backward takes no BAOS calibration: training "
                "runs without a cache (ROADMAP.md, Queue 3)")
        if extra_kv is not None:
            raise NotImplementedError(
                "flash_bidir's backward takes no second K/V source: "
                "training runs without a cache (ROADMAP.md, Queue 3)")
        if isinstance(q_offset, torch.Tensor):
            raise ValueError("flash_bidir's backward takes no device query "
                             "offset: training runs without a cache")
        return FlashBidir.apply(q, k, v, kv_valid, window, q_offset, causal)
    return _forward(q, k, v, kv_valid, fk, fv, cv, window, q_offset,
                    extra_kv, causal)


def _forward(q, k, v, kv_valid, fk, fv, cv, window: Optional[int],
             q_offset: Offset, extra_kv=None, causal: bool = False):
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_bidir_plain(q, k, v, kv_valid, fk, fv, cv, window,
                                 q_offset, extra_kv, causal)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: "
                         f"need one of {_DTYPES} for all three")
    route(D, q.dtype)
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
                       out.data_ptr(), B, Sq, Skv, Hq, Hkv, D, D ** -0.5,
                       0 if window is None else int(window), off,
                       _build.ptr(off_dev), int(causal),
                       int(q.dtype == torch.bfloat16),
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[count_name(extra_kv is not None, causal,
                                    off_dev is not None)] += 1
    return out


def count_name(split: bool, causal: bool, device_offset: bool) -> str:
    """The launch-count entry of a forward launch (module docstring)."""
    if causal:
        return CAUSAL_NAME
    if split:
        return SPLIT_NAME
    return OFFSET_NAME if device_offset else NAME


class FlashBidir(torch.autograd.Function):
    """Attention with a backward: the forward kernel (or plain version),
    unchanged, then ``flash_bidir_bwd`` from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, window, q_offset, causal=False):
        ctx.save_for_backward(q, k, v, kv_valid)
        ctx.window, ctx.q_offset, ctx.causal = window, q_offset, causal
        return _forward(q, k, v, kv_valid, None, None, None, window,
                        q_offset, None, causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid = ctx.saved_tensors
        dq, dk, dv = flash_bidir_bwd(q, k, v, dout.contiguous(), kv_valid,
                                     ctx.window, ctx.q_offset, ctx.causal)
        return dq, dk, dv, None, None, None, None


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
                          window: Optional[int] = None, q_offset: int = 0,
                          causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version of the backward, step by step in f32 from recomputed
    probabilities: (dq, dk, dv) in the inputs' dtype.  delta_i =
    sum_j p_ij dp_ij, the f32 value of dO_i . o_i (the forward's output,
    rounded to bf16, would carry that rounding into every ds_ij); dk and dv
    sum over the q heads of each KV head's group."""
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
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function(BWD_NAME, "flash_bidir_bwd_launch",
                           [p] * 9 + [i] * 6 +
                           [ctypes.c_float, i, i, i, i, p])


def flash_bidir_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dout: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, q_offset: int = 0,
                    causal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_bidir`` (no BAOS) at q, k, v
    for the output gradient ``dout`` (B, Sq, Hq, D).  CUDA
    tensors run csrc/flash_bidir_bwd.cu (one count in ``launch_counts``
    per call: its two kernels, dq then dk/dv); CPU tensors the plain
    version.  ``q_offset`` is a host int (training runs without a cache):
    a tensor raises ValueError."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or Hq % Hkv or \
            dout.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, dout {tuple(dout.shape)}: not "
                         f"a GQA attention")
    if isinstance(q_offset, torch.Tensor):
        raise ValueError("flash_bidir_bwd takes a host q_offset: training "
                         "runs without a cache")
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_bidir_bwd_plain(q, k, v, dout, kv_valid, window,
                                     q_offset, causal)
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
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty(3 * B * Hq * Sq, dtype=torch.float32, device=dev)
    err = _bwd_kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        _build.ptr(valid), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), B, Sq, Skv, Hq, Hkv, D, D ** -0.5,
        0 if window is None else int(window), int(q_offset), int(causal),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(BWD_NAME, err)
    _build.launch_counts[BWD_CAUSAL_NAME if causal else BWD_NAME] += 1
    return dq, dk, dv
