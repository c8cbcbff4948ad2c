"""llama3.2-1b — 16L d2048 32H (GQA kv=8) hd=64 ff=8192 v=128256.

[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256,
    mlp_activation="silu", rope_theta=500000.0, tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
