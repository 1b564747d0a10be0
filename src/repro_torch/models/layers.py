"""Transformer building blocks, ported from src/repro/models/layers.py:
the MX quantization policy at the GEMM boundaries (``QuantPolicy``),
GEMMs with f32 accumulation (and an optional bias), RMSNorm, LayerNorm,
NeoX RoPE, SwiGLU, GELU and softplus as JAX computes them, the recurrent
families' causal conv and block-start captures (models/ssm.py,
models/rglru.py), and bidirectional GQA attention with the BAOS fusion
(kernels/flash_bidir.py on the card), plus the seeded parameter init with
the JAX package's distributions."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import mx
from repro_torch.kernels import flash_bidir


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """MX fake-quant at the GEMM boundaries (paper §3.1.1, the asymmetric
    data path), field for field the JAX QuantPolicy: weights in
    ``weight_fmt`` with MX blocks along the contraction (first) axis of
    (K, N) weights, activations in ``act_fmt`` along their last axis.  It
    stays plain PyTorch, as the JAX package computes it in jnp outside any
    Pallas kernel; weights are fake-quantized at every call, as in JAX."""
    enabled: bool = False
    weight_fmt: str = "mxint4"
    act_fmt: str = "mxint8"

    def weights(self, w: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return w
        return mx.mx_fake_quant(w, self.weight_fmt, axis=0)

    def acts(self, x: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return x
        return mx.mx_fake_quant(x, self.act_fmt, axis=-1)


def qdot(x: torch.Tensor, w: torch.Tensor,
         policy: Optional[QuantPolicy] = None,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) with the ``policy``'s fake-quant of both
    operands (when enabled), f32 accumulation and one rounding to x.dtype;
    ``bias`` is added in f32 before that rounding.  Without a bias a bf16
    product goes to cuBLAS, which accumulates in f32 (TF32 and
    reduced-precision reductions off, device.py) and rounds once; with one,
    the product runs in f32 so the bias joins before the cast."""
    if policy is not None and policy.enabled:
        x, w = policy.acts(x), policy.weights(w)
    w = w.to(x.dtype)
    if bias is None:
        return torch.matmul(x, w)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return (y + bias.to(torch.float32)).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """JAX's ``layer_norm``: mean and variance in f32, the normed value
    rounded to x.dtype, then ``* w + b`` in that dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no linear
    cut-off (``F.softplus`` switches to x past a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(xc: torch.Tensor, w: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width W = w.shape[0], without bias or
    activation: xc (B, S, C), w (W, C), ``conv_state`` (B, W - 1, C) the
    previous segment's trailing inputs (zeros when None).  The W products
    are summed left to right, as JAX's ``sum`` does."""
    W = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xc.shape[0], W - 1, xc.shape[2]), dtype=xc.dtype,
                          device=xc.device)
    else:
        pad = conv_state.to(xc.dtype)
    xp = torch.cat([pad, xc], dim=1)
    S = xc.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out


def capture_rows(x: torch.Tensor, capture_at, n: int) -> torch.Tensor:
    """The n rows of x (B, S, C) before position ``capture_at`` (an int or
    a one-element device tensor): JAX's dynamic_slice from
    max(capture_at - n, 0), zeros while capture_at < n."""
    S = x.shape[1]
    if isinstance(capture_at, torch.Tensor):
        at = capture_at.reshape(()).to(torch.int64)
        start = torch.clamp(at - n, 0, S - n)
        got = x.index_select(1, start + torch.arange(n, device=x.device))
        return torch.where(at >= n, got, torch.zeros_like(got))
    if capture_at < n:
        return torch.zeros_like(x[:, :n])
    start = min(capture_at - n, S - n)
    return x[:, start:start + n]


def row_at(x: torch.Tensor, capture_at) -> torch.Tensor:
    """Row max(capture_at - 1, 0) of x (B, S, ...), zeros while
    capture_at < 1; ``capture_at`` an int or a one-element device tensor."""
    if isinstance(capture_at, torch.Tensor):
        at = capture_at.reshape(()).to(torch.int64)
        idx = torch.clamp(at - 1, min=0).reshape(1)
        got = x.index_select(1, idx)[:, 0]
        return torch.where(at >= 1, got, torch.zeros_like(got))
    if capture_at < 1:
        return torch.zeros_like(x[:, 0])
    return x[:, capture_at - 1]


def check_head_mode(head_mode: str) -> None:
    """The recurrent models run the legacy head only
    (``supports_head_mode`` is False, as in JAX)."""
    if head_mode != "logits":
        raise ValueError(f"head_mode {head_mode!r}: this model returns "
                         "logits only (supports_head_mode is False)")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """GPT-NeoX half-split rotary embedding; x (B, S, H, D), positions
    (B, S) or (S,).  Frequencies exp(-log(theta) * i / half) in f32."""
    d = x.shape[-1]
    half = d // 2
    # a fill, not torch.tensor: no host-to-device copy (a CUDA graph
    # capture refuses one)
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_valid: Optional[torch.Tensor] = None,
              window: Optional[int] = None, baos_calib=None,
              q_offset: flash_bidir.Offset = 0, extra_kv=None,
              causal: bool = False, score_dtype: str = "float32",
              kv_chunk: int = flash_bidir.KV_CHUNK) -> torch.Tensor:
    """GQA attention, bidirectional or with ``causal`` JAX's causal mode,
    q (B, Sq, Hq, D) over k/v (B, Skv, Hkv, D) with a per-row ``kv_valid``
    (B, Skv) mask; key j sits at position j and query row r at
    ``q_offset + r`` (an int, or an integer tensor on the device: a
    graph's block start).  With ``baos_calib``
    (core/baos.BAOSCalib) k/v are the smoothed cache: f_k joins the query
    and f_v, c_v the output, in f32 inside the kernel (the JAX model rounds
    q * f_k and out * f_v + c_v to the activation dtype).  The hand-written
    kernel runs for CUDA tensors, its plain version for CPU ones, at any
    head dim (kernels/flash_bidir.route).  ``extra_kv`` = (k2, v2,
    valid2): a second K/V source in the same smoothed space (the split
    active-block buffer), its key j at position q_offset + j; one softmax
    spans both sources (the kernel's route B), as JAX merges the two
    sources' partials exactly.  ``score_dtype`` "bfloat16": JAX's bf16
    scores and probabilities (``kv_chunk``: JAX's chunk of keys, which
    only the plain version reads)."""
    fk = fv = cv = None
    if baos_calib is not None:
        B, _, Hkv, D = k.shape
        fk, fv, cv = (t.reshape(B, Hkv, D) for t in (
            baos_calib.k_scale, baos_calib.v_scale, baos_calib.v_center))
    return flash_bidir.flash_bidir(q, k, v, kv_valid, fk, fv, cv,
                                   window=window, q_offset=q_offset,
                                   extra_kv=extra_kv, causal=causal,
                                   score_dtype=score_dtype, kv_chunk=kv_chunk)


# ---------------------------------------------------------------------------
# Online-softmax partials (JAX's attention_partials / combine_partials /
# finalize_partials): plain PyTorch for the CPU and the tests.  Partials of
# disjoint key sets merge exactly, which is what lets the split cache's
# two sources share one softmax; on the card route B of flash_bidir
# computes the merged result in one pass.
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       q_pos: torch.Tensor, kv_pos: torch.Tensor,
                       kv_valid: torch.Tensor, mode: str = "bidir",
                       window: Optional[int] = None,
                       softmax_scale: Optional[float] = None):
    """(m, l, o_unnorm), each (B, Hkv, G, Sq[, D]) f32: the row max of the
    masked scores (at least -1e30), the exp-sum relative to it and the
    unnormalized output, over one key set: q (B, Sq, Hq, D), k/v
    (B, Skv, Hkv, D), q_pos (B, Sq), kv_pos and kv_valid (B, Skv);
    ``mode`` 'bidir' or 'causal', ``window`` |q - k| < window (causal:
    q - k < window).  JAX chunks the keys; one chunk computes the same
    function."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    ok = kv_valid.to(torch.bool)[:, None, :]
    qp, kp = q_pos[:, :, None], kv_pos[:, None, :]
    if mode == "causal":
        ok = ok & (kp <= qp)
        if window is not None:
            ok = ok & (qp - kp < window)
    elif window is not None:
        ok = ok & (torch.abs(qp - kp) < window)
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None]
    m = torch.clamp(torch.amax(s, dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    return m, torch.sum(p, dim=-1), o


combine_partials = flash_bidir.combine_partials


def finalize_partials(p, B: int, Sq: int, Hq: int, D: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """o / max(l, 1e-30) as (B, Sq, Hq, D) in ``dtype``."""
    _, l, o = p
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(dtype)


def seeded_generator(device: torch.device, seed: int
                     ) -> Optional[torch.Generator]:
    """The generator an ``init`` draws from: seeded on ``device``, or None
    on ``meta``, which has no generator and whose draws are shapes only
    (sim/trace.capture_tick_trace builds its parameters there)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    std = (2.0 / (d_in + d_out)) ** 0.5
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=device) * 0.02).to(dtype)
