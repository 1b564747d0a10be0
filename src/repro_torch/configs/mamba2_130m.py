"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128, headdim=64 (d_inner =
2*d_model = 1536 -> 24 SSD heads).  [arXiv:2405.21060]  No KV cache: the
warm step checkpoints the SSM state at the active-block boundary instead.
Same entries as src/repro/configs/mamba2_130m.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_head=64,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64, conv_width=4,
    rope_theta=0.0, sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=64,
    d_ff=0, vocab=257, ssm_state=16, ssm_head_dim=64, conv_width=4,
    rope_theta=0.0, sub_quadratic=True, dtype="float32",
)

base.register(CONFIG, SMOKE)
