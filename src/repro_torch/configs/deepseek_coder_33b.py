"""deepseek-coder-33b — 62L d7168 56H (GQA kv=8) hd=128 ff=19200 v=32256.

[arXiv:2401.14196; hf]  llama-arch (SwiGLU, untied embeddings).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256,
    mlp_activation="silu", rope_theta=100000.0, tie_embeddings=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
