"""minicpm-2b [dense]: llama-like with mu-param scaling.

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.  [arXiv:2404.06395]
mu-param: embed_scale=12, residual scale = 1.4/sqrt(40), logit scale =
256/2304 (dim_model_base / d_model).  Same entries as
src/repro/configs/minicpm_2b.py.  V is odd: the LM head is stored with
padded rows for the fused head's bf16 route
(kernels/fused_head_sampling.pad_head).
"""
import math

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_head=64,
    d_ff=5760, vocab=122753,
    embed_scale=12.0, residual_scale=1.4 / math.sqrt(40),
    logit_scale=256.0 / 2304.0,
)

SMOKE = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=257,
    embed_scale=12.0, residual_scale=1.4 / math.sqrt(2),
    logit_scale=16.0 / 64.0, dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
