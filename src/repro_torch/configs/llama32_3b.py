"""llama3.2-3b [dense]: small llama3 with GQA.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-3B]  Same entries as src/repro/configs/llama32_3b.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=128256, rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=257, dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
