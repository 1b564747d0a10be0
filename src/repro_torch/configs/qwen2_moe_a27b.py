"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts.

24L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=151936,
shared-expert hidden = 4*1408 = 5632, QKV bias.
[hf:Qwen/Qwen1.5-MoE-A2.7B]  Same entries as
src/repro/configs/qwen2_moe_a27b.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936, qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, d_ff_shared=5632),
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=64, vocab=257, qkv_bias=True,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                  num_shared_experts=2, d_ff_shared=128),
    dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
