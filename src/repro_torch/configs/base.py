"""Architecture configuration schema.

One ``ArchConfig`` fully describes a model in this framework: the decoder (or
encoder-decoder) backbone, attention flavour (GQA / MQA / MLA / none), MLP or
MoE feed-forward, SSM blocks (RWKV6 / Mamba2-SSD) and hybrid interleaving, and
the modality frontend stub for audio / vision architectures.

Every assigned architecture gets one ``src/repro/configs/<id>.py`` (the port keeps copies under ``src/repro_torch/configs/``) exporting
``CONFIG`` (the exact published shape) built from this schema.  ``reduced()``
derives a tiny same-family config for CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    num_shared_experts: int = 0    # always-on experts
    experts_per_token: int = 0     # top-k
    d_ff_expert: int = 0           # hidden dim of each expert
    capacity_factor: float = 1.25
    # Experts are padded up to a multiple of the model axis for even EP
    # sharding; the router never selects padding experts.
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"      # "mamba2" | "rwkv6"
    state_dim: int = 64       # N (mamba2) or per-head key dim (rwkv6)
    head_dim: int = 64        # P (mamba2 value dim per head) / rwkv6 value dim
    num_heads: int = 0        # derived if 0: d_inner // head_dim
    expand: int = 2           # d_inner = expand * d_model (mamba2)
    conv_width: int = 4       # local conv width (mamba2)
    chunk: int = 64           # chunked-scan block length


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""

    kind: str = "none"        # "none" | "audio_frames" | "vision_patches"
    feature_dim: int = 0      # dim of the precomputed frame/patch features
    num_tokens: int = 0       # tokens contributed per example (vision)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | encdec | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attention_type: str = "gqa"     # gqa | mla | none
    rope_theta: float = 10000.0
    mla: Optional[MLAConfig] = None
    attn_logit_softcap: float = 0.0
    attn_chunk: int = 512           # flash/blockwise query/kv-chunk length
    # §Perf lever: iterate only the lower-triangular (q-chunk, kv-chunk)
    # pairs in causal flash attention (halves attention FLOPs/bytes).
    # False = paper-faithful baseline recorded in the roofline table.
    flash_causal_skip: bool = False
    # §Perf lever: "pallas" routes full-sequence attention through the
    # flash-attention Pallas kernel (kernels/flash_attn.py) — score tiles
    # stay in VMEM, never crossing HBM.  "xla" = blockwise-scan baseline.
    attn_impl: str = "xla"

    # feed-forward
    mlp_activation: str = "silu"    # silu (SwiGLU) | gelu (GeGLU)
    use_bias: bool = False
    moe: Optional[MoEConfig] = None
    moe_every: int = 1              # MoE layer frequency (1 = every layer)
    first_dense_layers: int = 0     # leading dense layers before MoE starts

    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    # §Perf lever: "pallas" routes the chunked WKV/SSD scan through the
    # linear-attention Pallas kernel (VMEM-resident decay block + carried
    # state).  "xla" = pure-jnp chunked scan baseline.
    ssm_impl: str = "xla"
    # hybrid: one weight-SHARED attention block every `shared_attn_every`
    # layer slots (zamba2-style); 0 disables.
    shared_attn_every: int = 0

    # encoder-decoder
    encoder_layers: int = 0         # >0 => enc-dec; num_layers = decoder layers
    frontend: FrontendConfig = FrontendConfig()

    # embeddings / norm / dtypes
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # optimizer state dtype; the largest archs use bf16 accumulators so the
    # per-device footprint stays within HBM at 256-512 chips (documented).
    opt_state_dtype: str = "float32"

    # memory policy
    remat: bool = True              # checkpoint each block in train_step
    loss_chunk: int = 512           # seq-chunked vocab-parallel CE

    # distribution
    pipeline_stages: int = 1        # >1: GPipe-style PP over the 'pod' axis
    # "tp": Megatron TP over `model` + FSDP over `data` (baseline rules).
    # "dp": no tensor parallelism — batch+FSDP over every mesh axis (small
    #       models whose TP collectives dominate; MoE keeps EP over `model`).
    tp_strategy: str = "tp"

    # Shapes that are architecturally impossible (recorded as N/A in the
    # roofline table).  e.g. full-attention archs skip long_500k.
    skip_shapes: Tuple[str, ...] = ()

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            attn_chunk=32,
            loss_chunk=32,
            param_dtype="float32",
            compute_dtype="float32",
            opt_state_dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=8,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                experts_per_token=2,
                d_ff_expert=32,
                # E/k = 4 guarantees zero capacity drops -> smoke tests can
                # assert exact prefill/decode vs forward equivalence.
                capacity_factor=4.0,
            )
            kw["first_dense_layers"] = min(self.first_dense_layers, 1)
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            )
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(
                kind=self.ssm.kind, state_dim=16, head_dim=16,
                expand=2, conv_width=4, chunk=16,
            )
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        if self.frontend.kind != "none":
            kw["frontend"] = FrontendConfig(
                kind=self.frontend.kind, feature_dim=24,
                num_tokens=min(self.frontend.num_tokens or 8, 8),
            )
        if self.shared_attn_every:
            kw["shared_attn_every"] = 3
            kw["num_layers"] = 7   # exercises groups + remainder
        return self.replace(**kw)
