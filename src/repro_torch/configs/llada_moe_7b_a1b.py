"""LLaDA-MoE-7B-A1B (the paper's MoE model), approximate public config.

24L d_model=2048 16H (kv=16), 64 experts top-2, expert d_ff=1408,
vocab=126464.  The paper's Fig. 1 / Table 6 MoE track.  Same entries as
src/repro/configs/llada_moe_7b_a1b.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="llada-moe-7b-a1b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=126464, mask_token_id=126336,
    moe=MoEConfig(num_experts=64, top_k=2, d_ff_expert=1408),
)

SMOKE = ModelConfig(
    name="llada-moe-7b-a1b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=64, vocab=257, mask_token_id=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
