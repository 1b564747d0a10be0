"""Diffusion sampling stage (paper §3.2, Alg. 2), ported from
src/repro/core/sampling.py (the main-path subset).

Per masked position, over the vocabulary logit vector z:
Stable-Max m = max z, i* = argmax z, conf = 1 / sum_j exp(z_j - m), then a
top-k over the block's positions and the masked commit.  Two head paths
feed it.  ``fused_sampling_step_full`` streams hidden states through the
fused LM-head kernel (kernels/fused_head_sampling.py), so the vocab-wide
logits are never stored.  ``sampling_step_full`` takes stored logits (the
unfused and legacy head paths) through ``stable_max``, one launch of
kernels/stablemax_sampling.py.  The top-k runs in kernels/topk_mask.py.
Each kernel module holds the plain PyTorch version the CPU runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import mx

NEG_INF = -1e30
MASK32 = 0xFFFFFFFF
SUPPORTED_FMTS = ("none", "bf16", "mxfp8_e4m3")
# a counter-Gumbel seed: a uint32 int, or an int64 tensor holding one (the
# form a captured CUDA graph reads from device memory at every replay)
Seed = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    fmt: str = "mxfp8_e4m3"     # sampling precision: bf16 | mxfp8_e4m3 | none
    temperature: float = 0.0     # 0 => greedy (LLaDA reference)
    strategy: str = "stablemax"  # "stablemax" only in the port
    suppress_mask_token: bool = True  # never sample the mask id itself


def check_supported(cfg: SamplingConfig) -> None:
    """Raise for the sampling options this slice of the port lacks."""
    if cfg.strategy != "stablemax":
        raise NotImplementedError(
            f"strategy={cfg.strategy!r} is not ported yet (ROADMAP.md, "
            "Queue 1); the port samples with strategy='stablemax'")
    if cfg.fmt not in SUPPORTED_FMTS:
        raise NotImplementedError(
            f"sampling fmt {cfg.fmt!r} is not ported yet (ROADMAP.md, "
            f"Queue 1); the port supports {SUPPORTED_FMTS}")


# ---------------------------------------------------------------------------
# LM head and the counter-based Gumbel stream
# ---------------------------------------------------------------------------

def head_logits(hidden: torch.Tensor, w_head: torch.Tensor, *,
                logit_scale: float = 1.0, quant=None) -> torch.Tensor:
    """hidden (..., d) @ w_head (d, V) -> logits (..., V) in hidden.dtype:
    the ``quant`` policy's (models/layers.QuantPolicy) fake-quant of both
    operands when enabled, f32 accumulation, one rounding to the activation
    dtype, then x logit_scale in that dtype (the scale rounds to it first,
    as a weakly typed Python float does in JAX)."""
    if quant is not None and quant.enabled:
        hidden, w_head = quant.acts(hidden), quant.weights(w_head)
    dt = hidden.dtype
    z = torch.matmul(hidden, w_head.to(dt))
    # torch.full, not torch.tensor: a fill needs no host-to-device copy,
    # which a CUDA graph capture would refuse
    return z * torch.full((), logit_scale, dtype=dt, device=z.device)


def _chunk_grid(V: int, chunk_v: int) -> Tuple[int, int]:
    """(chunk, padded V): chunks are rounded down to multiples of the MX
    block (min one block) so per-chunk fake-quant sees exactly the 32-wide
    blocks full-row fake-quant sees."""
    chunk_v = max(mx.MX_BLOCK, chunk_v - chunk_v % mx.MX_BLOCK)
    ceil32 = -(-V // mx.MX_BLOCK) * mx.MX_BLOCK
    chunk = min(chunk_v, ceil32)
    return chunk, -(-V // chunk) * chunk


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split c in 16-bit halves
    so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style uint32 finalizer on int64 tensors holding uint32
    values (the JAX reference's uint32 wraparound, exactly)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def seed_tensor(seed: Seed, device) -> torch.Tensor:
    """``seed`` as the one-element int64 device tensor the sampling kernels
    read: a tensor passes through (checked), an int is filled in (a fill,
    no host-to-device copy)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1 or \
                seed.device != torch.device(device):
            raise ValueError(f"a seed tensor must be one int64 on {device}; "
                             f"got {seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
        return seed
    return torch.full((1,), int(seed) & MASK32, dtype=torch.int64,
                      device=device)


def _seed_bits(seed: Seed):
    """A seed's uint32 bits: an int, or an int64 tensor broadcasting as a
    scalar."""
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int64).reshape(()) & MASK32
    return int(seed) & MASK32


def counter_uniform(seed: Seed, rows: torch.Tensor, cols: torch.Tensor
                    ) -> torch.Tensor:
    """The uniform u in (0, 1] behind ``counter_gumbel``: a hash of
    (seed, row, col), f32; ``seed`` an int or a tensor (``Seed``)."""
    rows = rows.to(torch.int64) & MASK32
    cols = cols.to(torch.int64) & MASK32
    h = _mix32(_mul32(rows, 0x9E3779B9) ^ _seed_bits(seed))
    h = _mix32(h ^ _mul32(cols, 0x85EBCA6B))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def counter_gumbel(seed: Seed, rows: torch.Tensor, cols: torch.Tensor
                   ) -> torch.Tensor:
    """Deterministic counter-based Gumbel(0,1) noise g(seed, row, col), the
    stream the fused-head kernel regenerates tile by tile."""
    u = counter_uniform(seed, rows, cols)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Top-k transfer mask + commit
# ---------------------------------------------------------------------------

def topk_transfer_mask(conf: torch.Tensor, mask_idx: torch.Tensor,
                       k: torch.Tensor) -> torch.Tensor:
    """conf (B, L) float; mask_idx (B, L) bool (True = still masked);
    k (B,) int -> transfer mask (B, L) bool with exactly min(k, #masked)
    True entries per row, at the highest-confidence masked positions
    (ties toward the lower index).  On the card this is one launch: the
    kernel takes f32 conf, the bool mask and k as they come."""
    from repro_torch.kernels import topk_mask   # lazy: kernels import core
    return topk_mask.topk_mask(conf, mask_idx, k)


def commit_tokens(x: torch.Tensor, x0: torch.Tensor, transfer: torch.Tensor
                  ) -> torch.Tensor:
    """Phase 4 integer masked update: commit sampled tokens where selected."""
    return torch.where(transfer, x0, x)


def _select_and_commit(conf, x0, x, m_idx, k):
    """Transfer selection, top-k mask, masked commit."""
    x0 = torch.where(m_idx, x0, x)                 # keep committed tokens
    transfer = topk_transfer_mask(conf, m_idx, k)
    return commit_tokens(x, x0, transfer), transfer, conf


def stable_max(logits: torch.Tensor, fmt: str = "none",
               seed: Optional[Seed] = None, temperature: float = 0.0,
               suppress_id: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., V) -> (conf (...) f32, token (...) int32): the sampling
    fake-quant, the suppressed id masked after it, Stable-Max.  With
    temperature > 0 and a ``seed`` the token is the counter-Gumbel argmax
    (the stream the fused head draws; JAX draws jax.random.gumbel here) and
    conf the softmax probability of that token."""
    from repro_torch.kernels import stablemax_sampling as sms   # lazy
    *lead, V = logits.shape
    temp = temperature if seed is not None else 0.0
    conf, idx = sms.stablemax_sampling(
        logits.reshape(-1, V).contiguous(), fmt=fmt, suppress_id=suppress_id,
        temperature=temp, seed=0 if seed is None else seed)
    return conf.reshape(lead), idx.reshape(lead)


def sampling_step_full(logits: torch.Tensor, x: torch.Tensor, mask_id: int,
                       k: torch.Tensor, cfg: SamplingConfig,
                       seed: Optional[Seed] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sampling stage on stored logits (B, L, V): Stable-Max (the CUDA
    kernel on the card), then top-k and commit.  Returns (new tokens
    (B, L), transfer (B, L), conf (B, L)); greedy without a ``seed``."""
    check_supported(cfg)
    sup = mask_id if cfg.suppress_mask_token else None
    conf, x0 = stable_max(logits, cfg.fmt, seed, cfg.temperature,
                          suppress_id=sup)
    return _select_and_commit(conf, x0, x, x == mask_id, k)


def fused_sampling_step_full(hidden: torch.Tensor, w_head: torch.Tensor,
                             x: torch.Tensor, mask_id: int, k: torch.Tensor,
                             cfg: SamplingConfig, seed: Optional[Seed] = None,
                             *, logit_scale: float = 1.0, quant=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """One sampling stage fed by active-block hidden states: hidden
    (B, L, d) and w_head (d, V) stream through the fused head + Stable-Max
    (the CUDA kernel on the card), then top-k and commit.  Returns
    (new tokens (B, L), transfer (B, L), conf (B, L)).  ``seed`` (uint32)
    feeds the counter-Gumbel stream when cfg.temperature > 0; without one
    the step is greedy, as the JAX reference is without an rng.  An
    enabled ``quant`` policy fake-quantizes the hidden states and the head
    before the kernel, as JAX does before its Pallas kernel; the head's
    fake-quant runs on its padded rows (fused_head_sampling.head_storage),
    so the kernel reads the padded layout."""
    from repro_torch.kernels import fused_head_sampling as fhs   # lazy
    check_supported(cfg)
    if quant is not None and quant.enabled:
        V = w_head.shape[1]
        hidden = quant.acts(hidden)
        w_head = quant.weights(fhs.head_storage(w_head))[:, :V]
    B, L, d = hidden.shape
    m_idx = x == mask_id
    sup = mask_id if cfg.suppress_mask_token else None
    temp = cfg.temperature if seed is not None else 0.0
    conf, x0 = fhs.fused_head_sampling(
        hidden.reshape(B * L, d), w_head, fmt=cfg.fmt,
        logit_scale=logit_scale, suppress_id=sup, temperature=temp,
        seed=0 if seed is None else seed)
    return _select_and_commit(conf.reshape(B, L), x0.reshape(B, L), x,
                              m_idx, k)
