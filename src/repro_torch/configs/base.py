"""Config registry of the port: the architectures it runs (``get_config``)
and their CPU smoke reductions, as in src/repro/configs/base.py."""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

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


def _ensure_loaded() -> None:
    from repro_torch.configs import (  # noqa: F401
        codeqwen15_7b, internvl2_26b, llada_8b, llada_moe_7b_a1b, llama32_3b,
        mamba2_130m, minicpm_2b, moonshot_v1_16b_a3b, qwen2_0_5b,
        qwen2_moe_a27b, recurrentgemma_2b, whisper_medium)
