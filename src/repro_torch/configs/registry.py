"""Architecture registry: --arch <id> -> ArchConfig.

The port serves ``llama3.2-1b`` (dense GQA) and ``deepseek-v3-671b``
(absorbed MLA + MoE), and trains ``llama3.2-1b``; more archs join as
their families are ported.
"""
from typing import Dict

from repro_torch.configs import deepseek_v3_671b, llama3_2_1b
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                   for m in (llama3_2_1b, deepseek_v3_671b)}
ARCH_IDS = tuple(REGISTRY)

# The reference's optimized profile of the registered archs
# (``repro/configs/registry.py::OPTIMIZED_OVERRIDES``): the flash-attention
# kernel for full-sequence attention, and the ZeRO-3 ``dp_all`` layout for
# the small dense model.  ``tp_strategy`` is data here: one device has no
# mesh to lay out.
OPTIMIZED_OVERRIDES: Dict[str, dict] = {
    "llama3.2-1b":      {"attn_impl": "pallas", "tp_strategy": "dp_all"},
    "deepseek-v3-671b": {"attn_impl": "pallas"},
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
