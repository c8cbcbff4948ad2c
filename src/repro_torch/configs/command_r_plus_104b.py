"""command-r-plus-104b — 64L d12288 96H (GQA kv=8) hd=128 ff=33792 v=256000.

[hf:CohereForAI/c4ai-command-r-v01; unverified]  GQA, no biases.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    mlp_activation="silu", use_bias=False, rope_theta=75000000.0,
    tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
