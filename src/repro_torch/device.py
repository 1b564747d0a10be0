"""Device selection and matmul precision for the PyTorch port.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``
and resolves it here: without a card the call raises instead of quietly
running on the CPU, so the CPU path runs only when a caller (the tests)
asks for it.  Resolving also pins the precision the JAX reference uses:
f32 accumulation (``preferred_element_type=f32``) with no TF32 and no
reduced-precision bf16 reductions.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve(device: Optional[Union[str, torch.device]] = "cuda"
            ) -> torch.device:
    """The torch.device for ``device``; raises when it is a CUDA device and
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    set_precision()
    return dev
