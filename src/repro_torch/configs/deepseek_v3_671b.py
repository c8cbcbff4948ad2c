"""deepseek-v3-671b — 61L d7168 128H MLA ff(expert)=2048 v=129280,
MoE: 256 routed top-8 + 1 shared; first 3 layers dense (ff=18432).
[arXiv:2412.19437; hf]  MTP head not modeled (optional in paper; documented).

opt_state_dtype=bf16: fp32 Adam moments would need ~21 GB/chip at 256 chips —
bf16 moments keep the cell within a 16 GB HBM budget (DESIGN.md §2.1).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129280,
    attention_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mlp_activation="silu", rope_theta=10000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=256, num_shared_experts=1, experts_per_token=8,
                  d_ff_expert=2048, capacity_factor=1.25),
    first_dense_layers=3,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
