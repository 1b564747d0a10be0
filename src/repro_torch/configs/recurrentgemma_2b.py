"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 pattern.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, lru width 2560,
local-attention window 2048, head_dim 256.  [arXiv:2402.19427]
Same entries as src/repro/configs/recurrentgemma_2b.py.
"""
import math

from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000, d_rnn=2560, window=2048,
    block_pattern=("rec", "rec", "attn"),
    embed_scale=math.sqrt(2560.0), norm="rms", ffn="geglu",
    rope_theta=10000.0, sub_quadratic=True, attn_chunk=2048,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab=257, d_rnn=64, window=32,
    block_pattern=("rec", "rec", "attn"),
    norm="rms", ffn="geglu", sub_quadratic=True, attn_chunk=64,
    dtype="float32",
)

base.register(CONFIG, SMOKE)
