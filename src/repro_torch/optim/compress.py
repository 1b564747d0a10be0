"""Int8 error-feedback gradient compression for a cross-mesh all-reduce,
ported from src/repro/optim/compress.py.

Where links between groups of chips are the scarce resource, the
gradient reduction across them can be compressed 4x (f32 -> int8 codes
plus one f32 scale per block of 256) with error feedback: each step's
quantization residual is carried into the next step's gradient.  As in
JAX this is a library function that no step calls.

The arithmetic is JAX's: the scale is a block's amax / 127, floored at
1e-12; the codes round half to even (``torch.round``, as ``jnp.round``)
and clip to [-127, 127].  The all-reduce sums the *dequantized* f32
values over a launch/mesh ``Axis`` (int8 codes are not summable without
overflow) and divides by the axis size.  All leaves travel in one
collective; a sum is elementwise, so that changes no value.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.launch import mesh as mesh_lib

BLOCK = 256


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes (n_blocks, 256), f32 scales (n_blocks, 1)), the
    flattened x zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    b = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(b), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, shape
                  ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compressed_psum(grads: Any, axis: mesh_lib.Axis, error: Any
                    ) -> Tuple[Any, Any]:
    """The mean of ``grads`` over the ranks of ``axis`` (a launch/mesh
    ``Axis``, JAX's ``axis_name``), each rank's contribution int8 with
    error feedback.  Returns (reduced grads, f32 means; the new error
    state, (g + e) - dequant(quant(g + e)) per leaf)."""
    flat_g = tree_lib.leaves(grads)
    flat_e = tree_lib.leaves(error)
    deqs, new_err = [], []
    for g, e in zip(flat_g, flat_e):
        gf = g.to(torch.float32) + e
        q, s = _quant_int8(gf)
        deq = _dequant_int8(q, s, gf.shape)
        deqs.append(deq)
        new_err.append(gf - deq)
    total = mesh_lib.all_reduce(
        torch.cat([d.reshape(-1) for d in deqs]), "sum", axis) / axis.size
    red, at = [], 0
    for d in deqs:
        red.append(total[at:at + d.numel()].reshape(d.shape))
        at += d.numel()
    return tree_lib.unflatten(grads, red), tree_lib.unflatten(grads, new_err)


def init_error(params: Any) -> Any:
    """Zero f32 error state shaped like ``params``."""
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)
