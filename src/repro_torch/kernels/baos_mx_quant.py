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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import mx
from repro_torch.kernels import _build

NAME = "baos_mx_quant"
# fmt argument of the C entry point (csrc/common.cuh Fmt), by the
# canonical name of every format of core/mx.FORMATS
FMT_CODES = mx.FMT_CODES
_DTYPES = (torch.float32, torch.bfloat16)


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
    CPU tensors the plain version."""
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
    _build.refuse_grad(NAME, x, center, scale)
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
