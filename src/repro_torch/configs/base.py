"""Config registry of the port: the architectures it runs (``get_config``)
and their CPU smoke reductions, and the input shapes of the step builders
(``SHAPES``, launch/steps.py), as in src/repro/configs/base.py."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode
    block_length: int = 32    # active diffusion block for decode kinds
    prompt_len: int = 0       # decode: committed prefix inside seq_len


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """long_500k only for the sub-quadratic archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


REGISTRY: Dict[str, ModelConfig] = {}
SMOKE: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = SMOKE if smoke else REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(REGISTRY)


def _ensure_loaded() -> None:
    from repro_torch.configs import (  # noqa: F401
        codeqwen15_7b, internvl2_26b, llada_8b, llada_moe_7b_a1b, llama32_3b,
        mamba2_130m, minicpm_2b, moonshot_v1_16b_a3b, qwen2_0_5b,
        qwen2_moe_a27b, recurrentgemma_2b, whisper_medium)
