"""zamba2-7b — 81 layer slots: Mamba2 blocks + one weight-SHARED attention
block every 6th slot.  d3584, shared-attn 32H hd=112, ff=14336, v=32000,
ssm_state=64.  [arXiv:2411.15242; unverified]

Simplifications (DESIGN.md §2.1): the shared block is a standard pre-norm
attn+MLP block (zamba2's per-invocation LoRA adapters and concat-input are
omitted); Mamba2 d_inner=2*d (7168), P=64 => 112 ssm heads.
Mamba2 state decode => long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    mlp_activation="silu", rope_theta=10000.0, tie_embeddings=True,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  conv_width=4, chunk=64),
    shared_attn_every=6,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
