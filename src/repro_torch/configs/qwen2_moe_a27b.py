"""qwen2-moe-a2.7b — 24L d2048 16H (kv=16) expert-ff=1408 v=151936,
MoE: 60 routed top-4 + 4 shared experts.  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Routed experts are padded 60 -> 64 for even 16-way expert parallelism.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=5632, vocab_size=151936,
    mlp_activation="silu", use_bias=True, rope_theta=1000000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=60, num_shared_experts=4, experts_per_token=4,
                  d_ff_expert=1408, capacity_factor=1.25),
    param_dtype="bfloat16", compute_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
