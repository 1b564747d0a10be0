"""QuaRot-style Hadamard-rotation KV smoothing (the baseline of the
paper's Table 5, Ashkboos et al. 24), ported from src/repro/core/quarot.py.

A random-sign Hadamard rotation R (orthogonal) is applied along the head
dimension before quantization:

    K_r = K R,   Q_r = Q R     =>   Q_r K_rᵀ = Q Kᵀ   (exactly)
    V_r = V R,   out = (P V_r) Rᵀ

spreading channel outliers across all channels.  Unlike BAOS it is
static: one rotation for every diffusion step, so it cannot follow the
step-wise distribution shift Table 5 exposes.  Plain tensor math, as in
JAX (outside any Pallas kernel): the products are ``torch.matmul``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import mx


@functools.lru_cache(maxsize=16)
def hadamard_matrix(dim: int, seed: int = 0) -> np.ndarray:
    """Sylvester Hadamard (dim a power of two) with random signs from
    numpy's RandomState(seed): JAX's matrix exactly."""
    if dim & (dim - 1):
        raise ValueError(f"head_dim {dim} must be a power of 2")
    h = np.array([[1.0]])
    while h.shape[0] < dim:
        h = np.block([[h, h], [h, -h]])
    rng = np.random.RandomState(seed)
    signs = rng.choice([-1.0, 1.0], size=dim)
    return (h * signs) / np.sqrt(dim)


def _matrix(x: torch.Tensor, seed: int) -> torch.Tensor:
    return torch.as_tensor(hadamard_matrix(x.shape[-1], seed),
                           dtype=x.dtype, device=x.device)


def rotate(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Rotate along the trailing head-dim axis: x R."""
    return torch.matmul(x, _matrix(x, seed))


def unrotate(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """x Rᵀ, the inverse of ``rotate``."""
    return torch.matmul(x, _matrix(x, seed).T)


def quarot_quantize_kv(k: torch.Tensor, v: torch.Tensor,
                       fmt: str = "mxint4", seed: int = 0):
    """Rotate, then MX fake-quant (the cached representation)."""
    return (mx.mx_fake_quant(rotate(k, seed), fmt),
            mx.mx_fake_quant(rotate(v, seed), fmt))
