"""whisper-medium [audio]: enc-dec transformer backbone, conv frontend stub.

24L (x2: encoder + decoder) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
[arXiv:2212.04356]  The caller provides frame embeddings (B, 1500, 1024).
The decoder uses RoPE instead of Whisper's learned positions; LayerNorm +
GELU per the original.  Same entries as src/repro/configs/whisper_medium.py.
V is odd: the LM head is stored with padded rows
(kernels/fused_head_sampling.pad_head).
"""
from repro_torch.configs import base
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=51865, norm="ln", ffn="gelu",
    n_encoder_layers=24, n_audio_ctx=1500,
)

SMOKE = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=257, norm="ln", ffn="gelu",
    n_encoder_layers=2, n_audio_ctx=16, dtype="float32", attn_chunk=64,
)

base.register(CONFIG, SMOKE)
