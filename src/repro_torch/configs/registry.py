"""Architecture registry: --arch <id> -> ArchConfig.

The port serves ``llama3.2-1b`` (dense GQA), ``deepseek-v3-671b``
(absorbed MLA + MoE) and ``rwkv6-1.6b`` (RWKV6, recurrent state), and
trains ``llama3.2-1b``; ``gemma-2b`` (dense MQA, GeGLU) is registered as
the reduced speculative draft the reference's tests use; more archs join
as their families are ported.
"""
from typing import Dict

from repro_torch.configs import (deepseek_v3_671b, gemma_2b, llama3_2_1b,
                                 rwkv6_1_6b)
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma_2b, llama3_2_1b, deepseek_v3_671b, rwkv6_1_6b)}
ARCH_IDS = tuple(REGISTRY)

# The reference's optimized profile of the registered archs
# (``repro/configs/registry.py::OPTIMIZED_OVERRIDES``): the flash-attention
# kernel for full-sequence attention, the ZeRO-3 ``dp_all`` layout for the
# small dense model, and the WKV kernel for the RWKV6 scan.  ``tp_strategy`` is data here: one device has no
# mesh to lay out.
OPTIMIZED_OVERRIDES: Dict[str, dict] = {
    "gemma-2b":         {"attn_impl": "pallas", "tp_strategy": "dp_all"},
    "llama3.2-1b":      {"attn_impl": "pallas", "tp_strategy": "dp_all"},
    "deepseek-v3-671b": {"attn_impl": "pallas"},
    "rwkv6-1.6b":       {"ssm_impl": "pallas"},
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
