"""Top-k transfer mask: CUDA kernel and plain version.

Port of the Pallas kernel src/repro/kernels/topk_mask.py.  Per row of
L block positions: unmasked confidences become -1e30, the stable
descending rank is r_i = #{c_j > c_i} + #{j < i, c_j == c_i}, and
transfer_i = masked_i & (r_i < min(k, #masked)).  ``torch.topk`` is not
stable on ties, so the plain version computes the rank formula itself.

``topk_mask`` launches csrc/topk_mask.cu for CUDA tensors and runs
``topk_mask_plain`` for CPU tensors; a CUDA tensor never reaches the plain
version.  Launch latency bounds the kernel, not its bytes: the wrapper
hands it the bool mask and the integer k as the caller has them and takes
back a bool mask, so a top-k is one launch.  It is a plain launch:
programmatic dependent launch lost in the graphed tick (csrc/topk_mask.cu).
The kernel has two routes, ``route(L)``: one warp per row for L <= 64, one
CTA per row (the row streamed through shared memory) for any longer L.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import sampling
from repro_torch.kernels import _build

NAME = "topk_mask"
# the longest row the warp route holds (two positions a lane)
WARP_MAX_L = 64
_ROUTES = ("warp", "cta")


def route(L: int) -> str:
    """The kernel route for rows of L positions: 'warp' (one warp per row,
    L <= 64) or 'cta' (one CTA per row, any L)."""
    if L < 1:
        raise ValueError(f"block length {L} must be positive")
    return "warp" if L <= WARP_MAX_L else "cta"


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
def _kernel_fns():
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _build.function(NAME, "topk_mask_launch", [p] * 4 + [i] * 4 + [p])
    empty = _build.function(NAME, "topk_mask_empty_launch", [p])
    return launch, empty


def topk_mask(conf: torch.Tensor, mask: torch.Tensor, k: torch.Tensor
              ) -> torch.Tensor:
    """conf (R, L) f32, mask (R, L) bool, k (R,) int32 or int64 ->
    transfer (R, L) bool.  CUDA tensors run the kernel, one launch that
    reads these types as they are (nothing is cast around it); CPU tensors
    the plain version."""
    if conf.dim() != 2 or mask.shape != conf.shape or \
            k.shape != conf.shape[:1]:
        raise ValueError(f"expected conf/mask (R, L) and k (R,); got "
                         f"{tuple(conf.shape)}, {tuple(mask.shape)}, "
                         f"{tuple(k.shape)}")
    if conf.device.type in _build.PLAIN_DEVICES:
        return topk_mask_plain(conf, mask, k)
    _build.refuse_grad(NAME, conf)
    if conf.device.type != "cuda" or mask.device != conf.device or \
            k.device != conf.device:
        raise ValueError("conf, mask and k must lie on one CUDA device")
    R, L = conf.shape
    kernel_route = _ROUTES.index(route(L))
    if conf.dtype != torch.float32 or mask.dtype != torch.bool or \
            k.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"need conf f32, mask bool and k int32 or int64; "
                         f"got {conf.dtype}, {mask.dtype}, {k.dtype}")
    if not (conf.is_contiguous() and mask.is_contiguous() and
            k.is_contiguous()):
        raise ValueError("conf, mask and k must be contiguous")
    out = torch.empty((R, L), dtype=torch.bool, device=conf.device)
    if R == 0:
        return out
    err = _kernel_fns()[0](conf.data_ptr(), mask.data_ptr(), k.data_ptr(),
                           out.data_ptr(), R, L, int(k.dtype == torch.int64),
                           kernel_route,
                           torch.cuda.current_stream(conf.device).cuda_stream)
    _build.check(NAME, err)
    _build.launch_counts[NAME] += 1
    return out


def empty_launch(device) -> None:
    """Launch the empty kernel of csrc/topk_mask.cu once on ``device``'s
    current stream: the card's floor for one launch, which bounds
    ``topk_mask`` (not counted in ``launch_counts``)."""
    err = _kernel_fns()[1](torch.cuda.current_stream(device).cuda_stream)
    _build.check(NAME, err)
