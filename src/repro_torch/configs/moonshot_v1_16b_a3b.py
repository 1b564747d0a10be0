"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.

48L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=163840,
MoE 64e top-6 (+2 shared experts per the Moonlight/DeepSeek-V3 lineage).
[hf:moonshotai/Moonlight-16B-A3B]  Same entries as
src/repro/configs/moonshot_v1_16b_a3b.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=2816),
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=64, vocab=257,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, d_ff_shared=64),
    dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
