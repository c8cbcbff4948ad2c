"""gemma-2b — 18L d2048 8H (MQA kv=1) hd=256 ff=16384 GeGLU v=256000.

[arXiv:2403.08295; hf]  Full-attention -> long_500k is N/A.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    mlp_activation="gelu",            # GeGLU
    rope_theta=10000.0, tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
