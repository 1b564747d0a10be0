"""Transfer-token schedules for diffusion unmasking, ported from
src/repro/core/schedule.py.

``get_num_transfer_tokens`` splits the number of currently-masked positions
of the active block evenly over the remaining denoising steps, pushing the
remainder to the earliest steps (LLaDA reference behaviour).
"""
from __future__ import annotations

import torch


def get_num_transfer_tokens(mask_count: torch.Tensor, steps: int
                            ) -> torch.Tensor:
    """mask_count (B,) int masked positions -> (B, steps) int32 tokens per
    step."""
    base = mask_count[:, None] // steps
    rem = mask_count[:, None] % steps
    step_idx = torch.arange(steps, device=mask_count.device)[None, :]
    return (base + (step_idx < rem).to(base.dtype)).to(torch.int32)


def linear_unmask_schedule(block_len: int, steps: int) -> torch.Tensor:
    """Static schedule for a fully-masked block of ``block_len``."""
    return get_num_transfer_tokens(
        torch.tensor([block_len], dtype=torch.int32), steps)[0]
