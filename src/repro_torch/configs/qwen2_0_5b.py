"""qwen2-0.5b [dense]: GQA with QKV bias.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.  [arXiv:2407.10671]
Same entries as src/repro/configs/qwen2_0_5b.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab=151936, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=257, qkv_bias=True, dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
