"""InternVL2-style VLM, ported from src/repro/models/vlm.py: a stub vision
tower and the dense backbone (models/transformer.py).

The vision tower is a stub, as in JAX: ``forward(image_embeds=...)`` takes
patch embeddings (B, n_image_tokens, d_model) already at the backbone's
width.  The sequence reserves its first ``n_image_tokens`` positions for
the image: on any pass whose segment holds at least ``n_image_tokens``
positions, the image embeddings (cast to the embedding dtype) replace the
first ``n_image_tokens`` token embeddings of the segment.  The condition
is JAX's and reads only the segment's shape, so a captured graph decides
it on the host; like JAX it also splices a prefix-mode refine segment
(block + suffix) that long, although that segment does not start at
position 0 (ROADMAP.md, Queue 3).  There is no ``head_mode``
(``supports_head_mode`` is False, as in JAX), so every path samples on
the legacy head.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch import device as device_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


class VLMModel:
    """The dense backbone with the image splice, on one device."""

    supports_head_mode = False

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        if cfg.family != "vlm":
            raise ValueError(f"VLMModel runs family 'vlm', not "
                             f"{cfg.family!r}")
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
        return transformer.init_cache(self.cfg, batch, s_tot,
                                      self.device if device is None
                                      else device, act_len)

    def embed(self, params: Dict, tokens: torch.Tensor,
              image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The segment's token embeddings, the image spliced over the first
        ``n_image_tokens`` when the segment holds that many."""
        embeds = transformer.embed(params, self.cfg, tokens)
        n_img = self.cfg.n_image_tokens
        if image_embeds is not None and embeds.shape[1] >= n_img > 0:
            embeds = torch.cat([image_embeds.to(embeds.dtype),
                                embeds[:, n_img:]], dim=1)
        return embeds

    def forward(self, params: Dict, tokens: Optional[torch.Tensor] = None,
                *, image_embeds: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None, **kw):
        if embeds is None and tokens is not None:
            embeds = self.embed(params, tokens, image_embeds)
        return transformer.forward(params, self.cfg, embeds=embeds, **kw)
