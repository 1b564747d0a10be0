"""Top-k transfer mask: CUDA kernel and plain version.

Port of the Pallas kernel src/repro/kernels/topk_mask.py.  Per row of
L <= 64 block positions: unmasked confidences become -1e30, the stable
descending rank is r_i = #{c_j > c_i} + #{j < i, c_j == c_i}, and
transfer_i = masked_i & (r_i < min(k, #masked)).  ``torch.topk`` is not
stable on ties, so the plain version computes the rank formula itself.

``topk_mask`` launches csrc/topk_mask.cu for CUDA tensors and runs
``topk_mask_plain`` for CPU tensors; a CUDA tensor never reaches the plain
version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import sampling
from repro_torch.kernels import _build

NAME = "topk_mask"
MAX_L = 64


def topk_mask_plain(conf: torch.Tensor, mask: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """conf (R, L) float, mask (R, L) bool, k (R,) int -> (R, L) bool."""
    c = torch.where(mask, conf.to(torch.float32), sampling.NEG_INF)
    L = c.shape[-1]
    ci, cj = c[:, :, None], c[:, None, :]
    pos = torch.arange(L, device=c.device)
    earlier = pos[None, :] < pos[:, None]            # [i, j]: j < i
    rank = torch.sum((cj > ci) | ((cj == ci) & earlier), dim=-1)
    take = torch.minimum(k.to(torch.int64)[:, None],
                         torch.sum(mask, dim=-1, keepdim=True))
    return (rank < take) & mask


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.function(NAME, "topk_mask_launch", [p] * 4 + [i, i, p])


def topk_mask(conf: torch.Tensor, mask: torch.Tensor, k: torch.Tensor
              ) -> torch.Tensor:
    """conf (R, L) f32, mask (R, L) bool, k (R,) int -> transfer (R, L)
    bool.  CUDA tensors run the kernel; CPU tensors the plain version."""
    if conf.dim() != 2 or mask.shape != conf.shape or \
            k.shape != conf.shape[:1]:
        raise ValueError(f"expected conf/mask (R, L) and k (R,); got "
                         f"{tuple(conf.shape)}, {tuple(mask.shape)}, "
                         f"{tuple(k.shape)}")
    if conf.device.type == "cpu":
        return topk_mask_plain(conf, mask, k)
    if conf.device.type != "cuda" or mask.device != conf.device or \
            k.device != conf.device:
        raise ValueError("conf, mask and k must lie on one CUDA device")
    R, L = conf.shape
    if not 1 <= L <= MAX_L:
        raise ValueError(f"block length {L} not in [1, {MAX_L}]")
    if not (conf.is_contiguous() and mask.is_contiguous() and
            k.is_contiguous()):
        raise ValueError("conf, mask and k must be contiguous")
    conf = conf.to(torch.float32)
    mask_i = mask.to(torch.int32)
    k_i = k.to(torch.int32)
    out = torch.empty((R, L), dtype=torch.int32, device=conf.device)
    if R == 0:
        return out.bool()
    err = _kernel_fn()(conf.data_ptr(), mask_i.data_ptr(), k_i.data_ptr(),
                       out.data_ptr(), R, L,
                       torch.cuda.current_stream(conf.device).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[NAME] += 1
    return out.bool()
