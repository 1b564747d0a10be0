"""Packed MX storage: real int4/int8 code buffers and E8M0 scale bytes,
ported from src/repro/core/packed.py.

Elsewhere the port, like the JAX package, emulates MX with fake-quant
(values carrying the quantization error).  This module is the storage
path: MXINT4 codes packed two to a byte (uint8) plus one scale-exponent
byte per 32-block, 4.25 bits an element against bf16's 16 (3.76x less
KV-cache or weight memory and traffic).

Round trip: ``unpack(pack(x), dtype=x.dtype) == mx.mx_fake_quant(x)`` bit
for bit, so a packed cache can replace the emulated one without changing
a value.  Plain tensor math, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import mx


class PackedMX(NamedTuple):
    codes: torch.Tensor      # uint8; int4: two codes a byte, last axis
    exponents: torch.Tensor  # uint8 E8M0 biased exponents, one a block
    fmt_name: str
    orig_last: int           # unpadded size of the last axis

    @property
    def nbytes(self) -> int:
        return self.codes.numel() + self.exponents.numel()


def _block_codes(x: torch.Tensor, fmt: mx.MXFormat, block: int):
    """-> (int codes (..., nb, block) int8, biased exponents (..., nb)
    uint8)."""
    xb, _ = mx._blockize(x.to(torch.float32), block)
    amax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    scale = mx._shared_scale(amax, fmt)
    q = mx._quant_element(xb / scale, fmt)          # grid values
    codes = torch.round(q * (2.0 ** fmt.frac_bits)).to(torch.int8)
    exp = torch.round(torch.log2(scale[..., 0])).to(torch.int32) + 127
    return codes, exp.to(torch.uint8)


def pack(x: torch.Tensor, fmt_name: str = "mxint4", block: int = 32
         ) -> PackedMX:
    fmt = mx.FORMATS[fmt_name]
    if not fmt.is_int:
        raise ValueError(
            f"packed storage implemented for MXINT formats; got {fmt_name}")
    codes, exp = _block_codes(x, fmt, block)
    flat = codes.reshape(*codes.shape[:-2], -1)     # (..., nb * block)
    if fmt.element_bits == 4:
        wide = flat.to(torch.int32)
        lo = wide[..., 0::2] & 0xF
        hi = wide[..., 1::2] & 0xF
        packed = (lo | (hi << 4)).to(torch.uint8)
    else:
        packed = flat.view(torch.uint8)
    return PackedMX(packed, exp, fmt_name, x.shape[-1])


def unpack(p: PackedMX, block: int = 32, dtype=torch.float32
           ) -> torch.Tensor:
    fmt = mx.FORMATS[p.fmt_name]
    if fmt.element_bits == 4:
        lo = (p.codes & 0xF).to(torch.int8)
        hi = ((p.codes >> 4) & 0xF).to(torch.int8)
        # sign-extend 4-bit two's complement
        lo = torch.where(lo >= 8, lo - 16, lo)
        hi = torch.where(hi >= 8, hi - 16, hi)
        flat = torch.stack([lo, hi], dim=-1).reshape(*p.codes.shape[:-1], -1)
    else:
        flat = p.codes.view(torch.int8)
    nb = p.exponents.shape[-1]
    vals = flat.reshape(*flat.shape[:-1], nb, block).to(torch.float32)
    vals = vals * (2.0 ** -fmt.frac_bits)
    scale = torch.exp2(p.exponents.to(torch.float32) - 127.0)[..., None]
    out = (vals * scale).reshape(*flat.shape[:-1], nb * block)
    return out[..., :p.orig_last].to(dtype)


def packed_bytes(shape: Tuple[int, ...], fmt_name: str = "mxint4",
                 block: int = 32) -> int:
    fmt = mx.FORMATS[fmt_name]
    n = 1
    for s in shape:
        n *= s
    nb = -(-shape[-1] // block) * (n // shape[-1])
    return n * fmt.element_bits // 8 + nb


def compression_ratio(shape, fmt_name="mxint4", baseline_bytes=2):
    n = 1
    for s in shape:
        n *= s
    return n * baseline_bytes / packed_bytes(shape, fmt_name)
