"""Model registry of the port: ``build_model(cfg, device)`` returns a model
with the JAX package's contract (``cfg``, ``init``, ``init_cache``,
``forward``, ``supports_head_mode``) bound to one device.  All six
families of the JAX package (``FAMILIES``): dense and moe
(models/transformer.py), ssm (models/ssm.MambaModel), hybrid
(models/rglru.GriffinModel), audio (models/whisper.WhisperModel) and vlm
(models/vlm.VLMModel); each model checks its own family's features."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch import device as device_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import GriffinModel
from repro_torch.models.ssm import MambaModel
from repro_torch.models.vlm import VLMModel
from repro_torch.models.whisper import WhisperModel


class TransformerModel:
    """A dLLM transformer (dense or MoE) on one device."""

    supports_head_mode = True        # forward(head_mode="hidden") works

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = device_lib.resolve(device)

    def init(self, seed: int = 0) -> Dict:
        return transformer.init_params(self.cfg, seed, self.device)

    def param_specs(self) -> Dict:
        return transformer.param_specs(self.cfg)

    def cache_specs(self, act_len: Optional[int] = None) -> Dict:
        return transformer.cache_specs(self.cfg, act_len)

    def init_cache(self, batch: int, s_tot: int,
                   act_len: Optional[int] = None,
                   device: Union[str, torch.device, None] = None) -> Dict:
        """The cache on ``device`` (default: the model's; ``"meta"``
        gives shapes and dtypes without allocating)."""
        return transformer.init_cache(self.cfg, batch, s_tot,
                                      self.device if device is None
                                      else device, act_len)

    def forward(self, params: Dict, tokens: torch.Tensor, **kw):
        return transformer.forward(params, self.cfg, tokens, **kw)


_MODELS = {"dense": TransformerModel, "moe": TransformerModel,
           "ssm": MambaModel, "hybrid": GriffinModel, "audio": WhisperModel,
           "vlm": VLMModel}
FAMILIES = tuple(_MODELS)


def build_model(cfg: ModelConfig, device: Union[str, torch.device] = "cuda"):
    model = _MODELS.get(cfg.family)
    if model is None:
        raise ValueError(f"unknown model family {cfg.family!r}; the port "
                         f"runs {FAMILIES}")
    return model(cfg, device)
