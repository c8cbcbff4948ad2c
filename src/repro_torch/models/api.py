"""Public model API: build a model object from an ArchConfig."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serving, transformer
from repro_torch.models.modules import param_count


def resolve_device(device: Optional[str]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA where there is none raises; nothing falls
    back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch versions on the CPU")
        if dev.index is None:            # tensors report an indexed device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Model:
    """Functional model wrapper over the dense paged decoder."""

    def __init__(self, cfg: ArchConfig, device: Optional[str] = None):
        transformer._check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- params -----------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return transformer.init_params(gen, self.cfg)

    def num_params(self, params) -> int:
        return param_count(params)

    # ---- paged serving (physical KV arena; serving/kv_pool.py) ------------
    def init_paged_arena(self, num_blocks: int, block_size: int):
        return serving.init_paged_arena(self.cfg, num_blocks, block_size,
                                        self.device)

    def paged_prefill_step(self, params, tokens, arena, block_tables,
                           kv_lens, chunk_lens):
        return serving.paged_prefill_step(params, tokens, self.cfg, arena,
                                          block_tables, kv_lens, chunk_lens)

    def paged_decode_step(self, params, tokens, arena, block_tables,
                          kv_lens, write_mask):
        return serving.paged_decode_step(params, tokens, self.cfg, arena,
                                         block_tables, kv_lens, write_mask)


def build_model(cfg: ArchConfig, device: Optional[str] = None) -> Model:
    """``device`` defaults to CUDA and raises where there is none."""
    return Model(cfg, device)
