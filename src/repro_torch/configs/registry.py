"""Architecture registry: --arch <id> -> ArchConfig.

The port serves ``llama3.2-1b`` (dense GQA) and ``deepseek-v3-671b``
(absorbed MLA + MoE); more archs join as their families are ported.
"""
from typing import Dict

from repro_torch.configs import deepseek_v3_671b, llama3_2_1b
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                   for m in (llama3_2_1b, deepseek_v3_671b)}
ARCH_IDS = tuple(REGISTRY)


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
