"""codeqwen1.5-7b [dense]: qwen1.5 architecture (full MHA KV, QKV bias).

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
[hf:Qwen/CodeQwen1.5-7B]  Same entries as src/repro/configs/codeqwen15_7b.py,
the JAX package's "paper-representative" cell (closest to LLaDA-8B).
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=13440, vocab=92416, qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=257, qkv_bias=True, dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
