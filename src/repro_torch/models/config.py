"""Model configuration: a copy of the JAX package's ``ModelConfig``
(src/repro/models/transformer.py), field for field, so a configuration
reads the same in both packages.  The port runs all six families
(``moe`` a models/moe.MoEConfig)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    norm: str = "rms"               # rms | ln
    ffn: str = "swiglu"             # swiglu | gelu
    mask_token_id: Optional[int] = None   # defaults to vocab - 1
    moe: Optional[object] = None
    window: Optional[int] = None    # local attention window (all attn layers)
    attn_mode: str = "bidir"        # bidir | causal
    block_pattern: Optional[Tuple[str, ...]] = None
    d_rnn: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    n_encoder_layers: int = 0
    n_audio_ctx: int = 1500
    n_image_tokens: int = 0
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    dtype: str = "bfloat16"
    attn_chunk: int = 1024
    remat: str = "none"
    sub_quadratic: bool = False
    unroll_layers: bool = False
    score_dtype: str = "float32"

    @property
    def mask_id(self) -> int:
        return self.mask_token_id if self.mask_token_id is not None \
            else self.vocab - 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """The JAX formula: every expert counted for an MoE model."""
        d, h = self.d_model, self.n_heads * self.d_head
        hkv = self.n_kv_heads * self.d_head
        attn = d * h + 2 * d * hkv + h * d
        if self.moe is not None:
            m = self.moe
            ff = m.num_experts * 3 * d * m.d_ff_expert + d * m.num_experts
            ff += 3 * d * (m.d_ff_shared or
                           m.num_shared_experts * m.d_ff_expert)
        else:
            ff = 3 * d * self.d_ff if self.ffn == "swiglu" \
                else 2 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Parameters one token reads: an MoE model's top-k experts only."""
        if self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        ff_all = m.num_experts * 3 * d * m.d_ff_expert
        ff_act = m.top_k * 3 * d * m.d_ff_expert
        return self.param_count() - self.n_layers * (ff_all - ff_act)
