"""Architecture registry: --arch <id> -> ArchConfig.

The port's first slice serves ``llama3.2-1b`` only; more archs join as
their families are ported.
"""
from typing import Dict

from repro_torch.configs import llama3_2_1b
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                   for m in (llama3_2_1b,)}
ARCH_IDS = tuple(REGISTRY)


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
