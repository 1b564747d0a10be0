"""LLaDA-8B (the paper's primary model): llama-like dense dLLM.

32L d_model=4096 32H (kv=32) d_ff=12288 vocab=126464 (mask id 126336).
[arXiv LLaDA / GSAI-ML/LLaDA-8B-Instruct]  Same entries as
src/repro/configs/llada_8b.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llada-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=12288, vocab=126464, mask_token_id=126336,
)

SMOKE = ModelConfig(
    name="llada-8b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=257, mask_token_id=256, dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
