"""rwkv6-1.6b (Finch) — 24L d2048 attn-free ff=7168 v=65536.

[arXiv:2404.05892; unverified]  Data-dependent decay linear attention;
O(1)-state decode => long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    attention_type="none",
    ssm=SSMConfig(kind="rwkv6", state_dim=64, head_dim=64, chunk=64),
    tie_embeddings=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
