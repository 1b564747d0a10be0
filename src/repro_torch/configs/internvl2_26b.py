"""internvl2-26b [vlm]: InternViT (stub) + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  [arXiv:2404.16821]
The caller provides patch embeddings (B, 256, 6144), spliced over the
placeholder positions at the start of the sequence (models/vlm.py).  Same
entries as src/repro/configs/internvl2_26b.py.
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=92553, n_image_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=257, n_image_tokens=8, dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
