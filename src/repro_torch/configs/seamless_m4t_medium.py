"""seamless-m4t-medium — 12L enc + 12L dec, d1024 16H ff=4096 v=256206.

[arXiv:2308.11596; hf]  Enc-dec; audio frontend is a STUB: input_specs()
provides precomputed frame features (80-d fbank), projected into d_model.
Full attention -> long_500k N/A.
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    mlp_activation="silu", rope_theta=10000.0, tie_embeddings=True,
    frontend=FrontendConfig(kind="audio_frames", feature_dim=80),
    param_dtype="bfloat16", compute_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
