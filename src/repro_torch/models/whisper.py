"""Whisper-medium backbone, ported from src/repro/models/whisper.py: a
transformer encoder and a diffusion-decodable decoder with cross-attention
to it.

The conv audio frontend is a stub, as in JAX: ``encode`` takes frame
embeddings (B, n_audio_ctx, d_model) that a caller draws.  The encoder
(``enc_cfg``: the decoder's config with LayerNorm, the GELU MLP, no RoPE,
no MoE and no window) runs once per request; ``cross_kv`` turns its output
into every decoder layer's cross-attention K/V, computed once, and
``forward(cross_kv=...)`` reads them on every pass (models/transformer.py).
The decoder is the dense stack with LayerNorm and the GELU MLP.

Parameters: the decoder's (models/transformer.py, each layer with ``ln_x``
and ``xattn``) plus ``encoder``: ``layers`` (a list of transformer
layers), ``pos_embed`` (n_audio_ctx, d) and ``final_norm`` ``{w, b}``.
There is no ``head_mode`` (``supports_head_mode`` is False, as in JAX), so
every path samples on the legacy head.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import device as device_lib
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig


class WhisperModel:
    """The encoder-decoder on one device, with the transformer's forward
    contract on the decoder side."""

    supports_head_mode = False

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        if cfg.family != "audio":
            raise ValueError(f"WhisperModel runs family 'audio', not "
                             f"{cfg.family!r}")
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.enc_cfg = dataclasses.replace(
            cfg, n_layers=cfg.n_encoder_layers, norm="ln", ffn="gelu",
            rope_theta=0.0, moe=None, window=None, attn_mode="bidir")
        self.device = device_lib.resolve(device)

    def init(self, seed: int = 0) -> Dict:
        """Seeded parameters with the JAX package's distributions (torch's
        draws; for parity convert JAX's with ``bridge``): the decoder from
        ``seed``, the encoder from ``seed + 1``."""
        cfg, dev = self.cfg, self.device
        params = transformer.init_params(cfg, seed, dev, cross_attn=True)
        gen = layers.seeded_generator(dev, seed + 1)
        params["encoder"] = {
            "layers": [transformer.init_layer_params(gen, self.enc_cfg, dev)
                       for _ in range(self.enc_cfg.n_layers)],
            "pos_embed": (torch.randn((cfg.n_audio_ctx, cfg.d_model),
                                      generator=gen, device=dev) * 0.01
                          ).to(cfg.torch_dtype),
            "final_norm": transformer.norm_params(self.enc_cfg, cfg.d_model,
                                                  dev)}
        return params

    def param_specs(self) -> Dict:
        """The decoder's logical axes (each layer with ``ln_x`` and
        ``xattn``) plus the encoder's, JAX's ``param_specs``."""
        spec = transformer.param_specs(self.cfg, cross_attn=True)
        spec["encoder"] = {
            "layers": [transformer.layer_param_specs(self.enc_cfg)
                       for _ in range(self.enc_cfg.n_layers)],
            "pos_embed": (None, "embed"),
            "final_norm": transformer.norm_specs("ln")}
        return spec

    def cache_specs(self, act_len: Optional[int] = None) -> Dict:
        return transformer.cache_specs(self.cfg, act_len)

    def init_cache(self, batch: int, s_tot: int,
                   act_len: Optional[int] = None,
                   device: Union[str, torch.device, None] = None) -> Dict:
        return transformer.init_cache(self.cfg, batch, s_tot,
                                      self.device if device is None
                                      else device, act_len)

    def encode(self, params: Dict, audio_embeds: torch.Tensor
               ) -> torch.Tensor:
        """audio_embeds (B, n_audio_ctx, d), the stub frontend's output ->
        the encoder's output (B, n_audio_ctx, d): frames in the activation
        dtype plus ``pos_embed``, every encoder layer with all frames valid
        (bidirectional, no cache, BAOS off), the final LayerNorm."""
        cfg = self.enc_cfg
        enc = params["encoder"]
        x = audio_embeds.to(cfg.torch_dtype) + enc["pos_embed"][None]
        stack = {"layers": enc["layers"], "final_norm": enc["final_norm"]}
        return transformer.forward(stack, cfg, embeds=x,
                                   head_mode="hidden")[0]

    def cross_kv(self, params: Dict, enc_out: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross-attention K and V from the encoder's
        output, computed once: two (n_layers, B, S_enc, Hkv, D) stacks."""
        cfg = self.cfg
        B, S, _ = enc_out.shape
        shape = (B, S, cfg.n_kv_heads, cfg.d_head)
        return tuple(torch.stack([
            layers.qdot(enc_out, lp["xattn"][name]).reshape(shape)
            for lp in params["layers"]]) for name in ("wk", "wv"))

    def forward(self, params: Dict, tokens: torch.Tensor, **kw):
        return transformer.forward(params, self.cfg, tokens, **kw)
