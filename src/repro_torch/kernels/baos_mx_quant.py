"""BAOS smoothing + MX fake-quant of the KV write-back: CUDA kernel and
plain version.

Port of the Pallas kernel src/repro/kernels/baos_mx_quant.py, the twin of
core/baos.smooth_quantize.  x (B, S, H, D) with the calibration
center/scale (B, 1, H, D) f32: (x - c) / f per channel, then the MX
fake-quant of each 32-wide block along D in any format of core/mx.FORMATS
(mxint4 | mxint8 | mxfp8_e4m3 | mxfp6_e3m2 | mxfp4_e2m1, or the bf16 and
none pseudo-formats), cast to x's dtype.  The formats are core/mx's, as
the JAX model path writes its cache (core/baos.smooth_quantize): the
Pallas kernel itself casts every non-integer format through e4m3, so for
fp6 and fp4 it differs from that path, which never reaches it.  The
Pallas kernel takes the same data as (G = B * H, S, D); the model's
(B, S, H, D) layout is kept here so the output can be a slice of the KV
cache, written in place.

Any head dim D: where D is not a multiple of 32 the last block of each
head is partial, its amax over its real columns (core/mx's zero tail),
and only the D columns are stored.  The Pallas kernel refuses such a D;
the JAX model path, core/mx, takes it.

``baos_mx_quant`` launches csrc/baos_mx_quant.cu for CUDA tensors and runs
``baos_mx_quant_plain`` for CPU tensors; a CUDA tensor never reaches the
plain version.

Gradients (the cached forward under autograd, JAX's jax.grad of
core/baos.smooth_quantize): while grad mode is on and x, center or scale
requires grad, ``baos_mx_quant`` runs as ``BaosMxQuant``, whose backward
is ``baos_mx_quant_bwd``: the fake-quant's cotangent g' per format (0 for
the integer formats, fp6 and fp4; e4m3(g * scale) / scale for mxfp8, the
VJP of JAX's float8 cast; bf16(g) for bf16, g for none; core/mx
._E4M3Clip), then dx = g' / f in x's dtype and, summed over the
positions in a fixed order, dc = -sum g' / f and df = -sum g' (x - c) /
f^2, (B, 1, H, D) f32.  The kernel's backward is
``baos_mx_quant_bwd_launch`` of the same library, counted as
``baos_mx_quant_bwd``; the plain one is autograd through the plain
version.  Written into ``out`` under autograd, the result is a
differentiable copy.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import mx
from repro_torch.kernels import _build

NAME = "baos_mx_quant"
BWD_NAME = "baos_mx_quant_bwd"
# fmt argument of the C entry point (csrc/common.cuh Fmt), by the
# canonical name of every format of core/mx.FORMATS
FMT_CODES = mx.FMT_CODES
_DTYPES = (torch.float32, torch.bfloat16)
# the formats whose fake-quant passes a gradient; the others' is 0
GRAD_FORMATS = ("none", "bf16", "mxfp8_e4m3")


def grad_passes(fmt: str) -> bool:
    """Whether the fake-quant in ``fmt`` (a core/mx name or alias) passes
    a gradient (module docstring)."""
    return mx.FORMATS[fmt].name in GRAD_FORMATS


def baos_mx_quant_plain(x: torch.Tensor, center: torch.Tensor,
                        scale: torch.Tensor, fmt: str) -> torch.Tensor:
    """Plain version: (x - c) / f in f32, MX fake-quant along D, x's
    dtype."""
    xs = (x.to(torch.float32) - center) / scale
    return mx.mx_fake_quant(xs, fmt).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.function(NAME, "baos_mx_quant_launch",
                           [p] * 4 + [i] * 4 + [ll] * 4 + [i, i, p])


def _check_rows(t: torch.Tensor, name: str) -> None:
    """The kernel indexes (H, D) as one contiguous run per (b, s)."""
    H, D = t.shape[2], t.shape[3]
    if (H > 1 and t.stride(2) != D) or (D > 1 and t.stride(3) != 1):
        raise ValueError(f"{name}: the (H, D) dims must be contiguous; got "
                         f"strides {t.stride()}")


def baos_mx_quant(x: torch.Tensor, center: torch.Tensor,
                  scale: torch.Tensor, fmt: str = "mxint4",
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, H, D); center/scale (B, 1, H, D) f32 -> smoothed fake-quant
    (B, S, H, D) in x's dtype, written into ``out`` when given (any B and S
    strides, e.g. a slice of the KV cache).  CUDA tensors run the kernel;
    CPU tensors the plain version.  Under autograd the result carries
    ``BaosMxQuant``'s backward."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, center, scale)):
        y = BaosMxQuant.apply(x, center, scale, fmt)
        return y if out is None else out.copy_(y)
    return _forward(x, center, scale, fmt, out)


class BaosMxQuant(torch.autograd.Function):
    """baos_mx_quant with a backward (module docstring): the forward kernel
    (or plain version), then ``baos_mx_quant_bwd`` from the saved x,
    center and scale."""

    @staticmethod
    def forward(ctx, x, center, scale, fmt):
        ctx.save_for_backward(x, center, scale)
        ctx.fmt = fmt
        return _forward(x, center, scale, fmt, None)

    @staticmethod
    def backward(ctx, g):
        x, center, scale = ctx.saved_tensors
        dx, dc, df = baos_mx_quant_bwd(x, center, scale, g.contiguous(),
                                       ctx.fmt)
        return dx, dc, df, None


def baos_mx_quant_bwd(x: torch.Tensor, center: torch.Tensor,
                      scale: torch.Tensor, g: torch.Tensor, fmt: str):
    """(dx, dcenter, dscale) of ``baos_mx_quant`` for the output gradient
    g (B, S, H, D) of x's dtype: dx in x's dtype, the other two (B, 1, H,
    D) f32 (module docstring).  CUDA tensors run the kernel (one count in
    ``launch_counts`` as ``baos_mx_quant_bwd``: the elementwise pass with
    each CTA's partial sums, then the sum of the partials); CPU tensors
    autograd through the plain version."""
    code = mx.fmt_code(fmt)
    B, S, H, D = x.shape
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} != x {tuple(x.shape)}")
    if x.device.type in _build.PLAIN_DEVICES:
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, center, scale)]
            y = baos_mx_quant_plain(*ins, fmt)
            return torch.autograd.grad(y, ins, g)
    dev = x.device
    if g.device != dev or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"g must be contiguous {x.dtype} on {dev}")
    _check_rows(x, "x")
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dc, df = (torch.empty((B, 1, H, D), dtype=torch.float32, device=dev)
              for _ in range(2))
    part = torch.empty(2 * B * -(-S // 8) * H * D, dtype=torch.float32,
                       device=dev)
    err = _bwd_kernel_fn()(x.data_ptr(), center.data_ptr(), scale.data_ptr(),
                           g.data_ptr(), dx.data_ptr(), dc.data_ptr(),
                           df.data_ptr(), part.data_ptr(), B, S, H, D,
                           x.stride(0), x.stride(1), code,
                           int(x.dtype == torch.bfloat16),
                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[BWD_NAME] += 1
    return dx, dc, df


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fn():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.function(NAME, "baos_mx_quant_bwd_launch",
                           [p] * 8 + [i] * 4 + [ll] * 2 + [i, i, p])


def _forward(x, center, scale, fmt: str, out: Optional[torch.Tensor]):
    code = mx.fmt_code(fmt)
    if x.dim() != 4:
        raise ValueError(f"expected x (B, S, H, D); got {tuple(x.shape)}")
    B, S, H, D = x.shape
    cal = (B, 1, H, D)
    for name, t in (("center", center), ("scale", scale)):
        if tuple(t.shape) != cal:
            raise ValueError(f"{name} {tuple(t.shape)} != {cal}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype):
        raise ValueError(f"out {out.dtype} {tuple(out.shape)} != x "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type in _build.PLAIN_DEVICES:
        y = baos_mx_quant_plain(x, center, scale, fmt)
        return y if out is None else out.copy_(y)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (center, scale)):
        raise ValueError("x, center and scale must lie on one CUDA device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {_DTYPES}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in (center, scale)):
        raise ValueError("center and scale must be contiguous f32")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    elif out.device != dev:
        raise ValueError(f"out on {out.device}, x on {dev}")
    _check_rows(x, "x")
    _check_rows(out, "out")
    if x.numel() == 0:
        return out
    err = _kernel_fn()(x.data_ptr(), center.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), B, S, H, D, x.stride(0), x.stride(1),
                       out.stride(0), out.stride(1),
                       code,
                       int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[NAME] += 1
    return out
