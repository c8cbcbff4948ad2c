"""Architecture registry: --arch <id> -> ArchConfig.

Every arch of the reference's registry: the dense GQA decoders ``llama3.2-1b``, ``gemma-2b`` (MQA,
GeGLU), ``deepseek-coder-33b`` and ``command-r-plus-104b``, the MoE
decoders ``qwen2-moe-a2.7b`` (GQA with q/k/v biases, 4 shared experts)
and ``deepseek-v3-671b`` (absorbed MLA), the vlm ``internvl2-76b`` (a
vision-patch projector before the decoder), the encdec
``seamless-m4t-medium`` (a bidirectional encoder over audio-frame
features, cross-attention in every decoder layer), the recurrent
``rwkv6-1.6b`` and the hybrid ``zamba2-7b`` (Mamba2 blocks with one
weight-shared attention block every sixth slot).  All of them serve;
``llama3.2-1b``, ``rwkv6-1.6b`` and ``zamba2-7b`` also train.
"""
from typing import Dict

from repro_torch.configs import (command_r_plus_104b, deepseek_coder_33b,
                                 deepseek_v3_671b, gemma_2b, internvl2_76b,
                                 llama3_2_1b, qwen2_moe_a27b, rwkv6_1_6b,
                                 seamless_m4t_medium, zamba2_7b)
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma_2b, deepseek_coder_33b, llama3_2_1b, command_r_plus_104b,
              qwen2_moe_a27b, deepseek_v3_671b, rwkv6_1_6b,
              seamless_m4t_medium, internvl2_76b, zamba2_7b)}
ARCH_IDS = tuple(REGISTRY)

# The reference's optimized profile of the registered archs
# (``repro/configs/registry.py::OPTIMIZED_OVERRIDES``): the flash-attention
# kernel for full-sequence attention (the hybrid's shared block too), the
# ZeRO-3 ``dp_all`` layouts for the small dense and MoE models, and the WKV
# kernel for the RWKV6 scan.
# ``tp_strategy`` picks the sharded train step's layout
# (``parallel/sharding.py``); one device ignores it.
OPTIMIZED_OVERRIDES: Dict[str, dict] = {
    "gemma-2b":            {"attn_impl": "pallas", "tp_strategy": "dp_all"},
    "llama3.2-1b":         {"attn_impl": "pallas", "tp_strategy": "dp_all"},
    "qwen2-moe-a2.7b":     {"attn_impl": "pallas",
                            "tp_strategy": "dp_all_noep"},
    "deepseek-coder-33b":  {"attn_impl": "pallas"},
    "command-r-plus-104b": {"attn_impl": "pallas"},
    "internvl2-76b":       {"attn_impl": "pallas"},
    "deepseek-v3-671b":    {"attn_impl": "pallas"},
    "seamless-m4t-medium": {"attn_impl": "pallas"},
    "rwkv6-1.6b":          {"ssm_impl": "pallas"},
    "zamba2-7b":           {"attn_impl": "pallas"},
}


def get_arch(name: str, optimized: bool = False,
             global_batch: int = 0, devices: int = 256) -> ArchConfig:
    """``optimized=True`` applies OPTIMIZED_OVERRIDES, shape-aware as in the
    reference: a ``dp_all*`` layout only applies when the global batch
    divides the device count."""
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    cfg = REGISTRY[name]
    if optimized:
        ov = dict(OPTIMIZED_OVERRIDES.get(name, {}))
        if "tp_strategy" in ov and global_batch % max(devices, 1) != 0:
            ov.pop("tp_strategy")
        cfg = cfg.replace(**ov)
    return cfg
