"""internvl2-76b — 80L d8192 64H (GQA kv=8) hd=128 ff=28672 v=128256.

[arXiv:2404.16821; unverified]  InternViT frontend is a STUB: input_specs()
provides 256 precomputed patch embeddings (3200-d), MLP-projected, prepended
to the text sequence.  LM backbone (llama3-70b-class) modeled exactly.
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    mlp_activation="silu", rope_theta=500000.0, tie_embeddings=False,
    frontend=FrontendConfig(kind="vision_patches", feature_dim=3200,
                            num_tokens=256),
    param_dtype="bfloat16", compute_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
