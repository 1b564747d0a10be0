"""Microscaling (MX) data-format emulation (OCP MX spec), ported from
src/repro/core/mx.py.

Blocks of ``block`` contiguous elements along the last axis share one
power-of-two scale (E8M0): the smallest 2^e with amax / 2^e <= grid_max,
e = ceil(log2(amax / grid_max)).  Elements are fake-quantized
(quantize -> dequantize) so results are bit-faithful to the format.  The
CUDA kernels (csrc/common.cuh ``fake_quant``) apply the same exponent rule
with the device's log2f, the function torch.log2 calls on the card, and
the same IEEE divisions, so kernels and plain versions agree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

MX_BLOCK = 32  # OCP default block size


@dataclasses.dataclass(frozen=True)
class MXFormat:
    name: str
    element_bits: int
    emax: int           # exponent of the largest element magnitude
    is_int: bool
    frac_bits: int = 0  # INT formats: fraction bits (OCP fixed point)
    grid_max: float = 0.0   # largest representable element magnitude

    @property
    def bits_per_element(self) -> float:
        """Effective storage bits/element incl. the shared E8M0 scale byte."""
        return self.element_bits + 8.0 / MX_BLOCK


MXINT8 = MXFormat("mxint8", 8, 1, True, frac_bits=6, grid_max=127 / 64)
MXINT4 = MXFormat("mxint4", 4, 1, True, frac_bits=2, grid_max=7 / 4)
MXFP8 = MXFormat("mxfp8_e4m3", 8, 8, False, grid_max=448.0)
MXFP6 = MXFormat("mxfp6_e3m2", 6, 4, False, grid_max=28.0)
MXFP4 = MXFormat("mxfp4_e2m1", 4, 2, False, grid_max=6.0)
BF16 = MXFormat("bf16", 16, 127, False)   # bf16 rounding pseudo-format
NONE = MXFormat("none", 32, 127, False)   # exact passthrough (FP64 analogue)

FORMATS = {f.name: f for f in (MXINT8, MXINT4, MXFP8, MXFP6, MXFP4, BF16,
                               NONE)}
FORMATS.update({
    "int8": MXINT8, "int4": MXINT4, "fp8": MXFP8, "fp6": MXFP6,
    "fp4": MXFP4, "bf16": BF16, "fp64": NONE, "fp32": NONE,
})

# The format argument of the CUDA kernels (csrc/common.cuh enum Fmt), by
# canonical name; ``fmt_code`` takes every name and alias of FORMATS.
FMT_CODES = {"none": 0, "bf16": 1, "mxfp8_e4m3": 2, "mxint8": 3,
             "mxint4": 4, "mxfp6_e3m2": 5, "mxfp4_e2m1": 6}


def fmt_code(fmt: str) -> int:
    """The kernels' code of format ``fmt`` (a name or an alias of
    FORMATS); ValueError for a name core/mx does not know."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown MX format {fmt!r}; core/mx knows "
                         f"{sorted(FORMATS)}")
    return FMT_CODES[FORMATS[fmt].name]


_E2M1_GRID = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
_E3M2_GRID = np.array(
    sorted({0.0} | {m * 2.0 ** e for e in range(-2, 5)
                    for m in (1.0, 1.25, 1.5, 1.75)}
           | {0.0625 * k for k in range(4)}),
    np.float32)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _quant_grid(x: torch.Tensor, grid: np.ndarray) -> torch.Tensor:
    """Round |x| to nearest grid point (half rounds up), keep sign."""
    g = torch.as_tensor(grid, dtype=x.dtype, device=x.device)
    mids = (g[1:] + g[:-1]) / 2.0
    idx = torch.sum(torch.abs(x)[..., None] >= mids, dim=-1)
    return torch.sign(x) * g[idx]


# e4m3's largest finite value, and the least magnitude a cast without
# saturation (ml_dtypes', JAX's) sends to NaN: 464 is the tie between 448
# and the NaN code, and rounds to even, 448
E4M3_MAX, E4M3_NAN_ABOVE = 448.0, 464.0


def e4m3_cast(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (back in x's dtype) as JAX's cast rounds
    it: to nearest even, NaN past 464 (torch's own cast saturates)."""
    y = x.to(torch.float8_e4m3fn).to(x.dtype)
    return torch.where(x.abs() > E4M3_NAN_ABOVE,
                       torch.full_like(y, float("nan")), y)


class _E4M3Clip(torch.autograd.Function):
    """mxfp8's element rounding, clip to +-448 then cast to e4m3 (OCP MX's
    saturating conversion: the clip is explicit, since casts disagree on
    overflow), with jax.grad's derivative of JAX's
    ``clip(x, -448, 448).astype(float8_e4m3fn).astype(x.dtype)``: the
    cotangent cast to e4m3 and back (the VJP of JAX's float8 cast, NaN
    past 464), times jnp.clip's 1 inside, 1/2 at +-448 (its min/max tie),
    0 beyond.  Torch's own derivative would saturate the cotangent and
    pass all of it at the bound."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, -E4M3_MAX, E4M3_MAX).to(
            torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        a = x.abs()
        w = torch.where(a < E4M3_MAX, 1.0,
                        torch.where(a == E4M3_MAX, 0.5, 0.0))
        return e4m3_cast(g) * w.to(g.dtype)


def _quant_element(x: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """Quantize scaled elements x (already divided by the shared scale)."""
    if fmt.is_int:
        lo = -(2 ** (fmt.element_bits - 1))
        hi = 2 ** (fmt.element_bits - 1) - 1
        q = torch.clamp(_round_half_away(x * (2 ** fmt.frac_bits)), lo, hi)
        return q * (2.0 ** -fmt.frac_bits)
    if fmt is MXFP8:
        return _E4M3Clip.apply(x)
    if fmt is MXFP6:
        return _quant_grid(x, _E3M2_GRID)
    if fmt is MXFP4:
        return _quant_grid(x, _E2M1_GRID)
    raise ValueError(f"unknown element format {fmt}")


def _shared_scale(amax: torch.Tensor, fmt: MXFormat) -> torch.Tensor:
    """E8M0 power-of-two block scale: the smallest 2^e with
    amax / 2^e <= grid_max."""
    one = torch.ones_like(amax)
    safe = torch.where(amax > 0, amax, one)
    # a tensor divisor: on the card torch turns division by a Python float
    # into a multiplication by its rounded reciprocal, which the kernels'
    # IEEE division would not match
    e = torch.clamp(torch.ceil(torch.log2(
        safe / torch.full_like(safe, fmt.grid_max))), -127.0, 127.0)
    return torch.where(amax > 0, torch.exp2(e), one)


def _blockize(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Reshape the last axis into (nblocks, block), zero-padding the
    tail."""
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, block), pad


def _fake_quant_impl(x: torch.Tensor, fmt: MXFormat, block: int, axis: int
                     ) -> torch.Tensor:
    """Blocks of ``block`` along ``axis`` (padded with zeros at its end),
    computed in x's own layout: a (K, N) weight quantized along K stays
    row-major, with no transpose."""
    n = x.shape[axis]
    xf = x.to(torch.float32)
    pad = (-n) % block
    if pad:
        xf = F.pad(xf, (0, 0) * (x.ndim - 1 - axis) + (0, pad))
    shape = xf.shape
    xb = xf.reshape(*shape[:axis], -1, block, *shape[axis + 1:])
    amax = torch.amax(torch.abs(xb), dim=axis + 1, keepdim=True)
    scale = _shared_scale(amax, fmt)
    q = (_quant_element(xb / scale, fmt) * scale).reshape(shape)
    return q.narrow(axis, 0, n).to(x.dtype)


def mx_fake_quant(x: torch.Tensor, fmt: Union[MXFormat, str],
                  block: int = MX_BLOCK, axis: int = -1) -> torch.Tensor:
    """Quantize-dequantize ``x`` in MX format along ``axis``."""
    fmt = FORMATS[fmt] if isinstance(fmt, str) else fmt
    if fmt is NONE:
        return x
    if fmt is BF16:
        return x.to(torch.bfloat16).to(x.dtype)
    return _fake_quant_impl(x, fmt, block, axis % x.ndim)


def mx_quantize(x: torch.Tensor, fmt: Union[MXFormat, str],
                block: int = MX_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(element codes as f32 (..., nblocks, block), shared scales
    (..., nblocks, 1)).  Last-axis blocks."""
    fmt = FORMATS[fmt] if isinstance(fmt, str) else fmt
    xb, _ = _blockize(x.to(torch.float32), block)
    amax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    scale = _shared_scale(amax, fmt)
    return _quant_element(xb / scale, fmt), scale


def mx_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                  n: Optional[int] = None, dtype=torch.float32
                  ) -> torch.Tensor:
    x = (codes * scale).reshape(*codes.shape[:-2], -1)
    if n is not None:
        x = x[..., :n]
    return x.to(dtype)


def quant_error(x: torch.Tensor, fmt: Union[MXFormat, str],
                block: int = MX_BLOCK) -> torch.Tensor:
    """Relative L2 quantization error (the accuracy simulator's metric)."""
    q = mx_fake_quant(x, fmt, block)
    num = torch.linalg.vector_norm((q - x).to(torch.float32))
    den = torch.linalg.vector_norm(x.to(torch.float32)) + 1e-12
    return num / den


def storage_bytes(shape: Tuple[int, ...], fmt: Union[MXFormat, str],
                  block: int = MX_BLOCK) -> int:
    """HBM bytes for a tensor stored in ``fmt`` (scales included)."""
    fmt = FORMATS[fmt] if isinstance(fmt, str) else fmt
    n = int(np.prod(shape))
    if fmt is NONE:
        return 4 * n
    if fmt is BF16:
        return 2 * n
    nblocks = -(-shape[-1] // block) * (n // shape[-1])
    return (n * fmt.element_bits) // 8 + nblocks  # +1 E8M0 byte per block
