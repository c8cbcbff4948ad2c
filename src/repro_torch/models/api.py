"""Public model API: build a model object from an ArchConfig."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serving, transformer
from repro_torch.models.modules import MetaGenerator, param_count


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
    """Functional model wrapper over the served models: the attention
    families (dense GQA, MoE with GQA or absorbed MLA, vlm, encdec) on the
    paged arena or a dense per-sequence cache, the recurrent RWKV6 stack
    (ssm) and the zamba2 hybrid (Mamba2 blocks and a shared attention
    block), both on a dense per-sequence state; dense GQA, ssm and hybrid
    also train."""

    def __init__(self, cfg: ArchConfig, device: Optional[str] = None):
        transformer._check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- params -----------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return transformer.init_params(gen, self.cfg)

    def init_abstract(self) -> Dict[str, Any]:
        """``init``'s tree on the meta device: every leaf's path, shape and
        dtype, nothing drawn or allocated (the reference's
        ``jax.eval_shape`` of ``init``)."""
        return transformer.init_params(MetaGenerator(), self.cfg)

    def num_params(self, params=None) -> int:
        tree = params if params is not None else self.init_abstract()
        return param_count(tree)

    # ---- training (dense GQA, ssm, hybrid) ----------------------------------
    def loss(self, params, batch, count_fn=None):
        """(loss, metrics) of ``batch = {"tokens": (B, S + 1) int}``;
        ``count_fn`` gives the cross-entropy's denominator from the batch's
        count (a sharded step's global count)."""
        return transformer.loss_fn(params, batch, self.cfg,
                                   count_fn=count_fn)

    def logits(self, params, batch) -> torch.Tensor:
        return transformer.logits(params, batch, self.cfg)

    def forward(self, params, batch):
        return transformer.forward(params, batch, self.cfg)

    # ---- dense-cache serving ------------------------------------------------
    def init_cache(self, batch: int, max_len: int = 0, src_len: int = 0):
        """``max_len`` KV rows a sequence (attention families; the ssm
        state needs none), ``src_len`` cross rows (encdec)."""
        return serving.init_cache(self.cfg, batch, self.device, max_len,
                                  src_len)

    def prefill(self, params, batch, cache, length=None):
        """(logits at the last valid position (B, V), cache) of prompts
        ``batch = {"tokens": (B, n) int, ...}``, right-padded past
        ``length`` (attention families), into a cache as ``init_cache``
        returns it."""
        return serving.prefill(params, batch, self.cfg, cache, length)

    def decode_step(self, params, tokens, cache):
        return serving.decode_step(params, tokens, self.cfg, cache)

    # ---- paged serving (physical KV arena; serving/kv_pool.py) ------------
    def init_paged_arena(self, num_blocks: int, block_size: int):
        return serving.init_paged_arena(self.cfg, num_blocks, block_size,
                                        self.device)

    def init_paged_state(self, num_slots: int, src_len: int = 0):
        return serving.init_paged_state(self.cfg, num_slots, self.device,
                                        src_len)

    def paged_prefill_write(self, arena, layers_cache, block_ids):
        # saralint: ok[cow-gate] pass-through to the bucketed prefill scatter; the engine only hands it freshly alloc'd, never-shared pages
        return serving.paged_prefill_write(arena, layers_cache, block_ids)

    def paged_prefill_step(self, params, tokens, arena, block_tables,
                           kv_lens, chunk_lens):
        # saralint: ok[cow-gate] pass-through to the model step; each serving-layer call (engine _chunk_prefill, draft _draft_prefill) is gated or reasoned where it is made
        return serving.paged_prefill_step(params, tokens, self.cfg, arena,
                                          block_tables, kv_lens, chunk_lens)

    def paged_verify_step(self, params, tokens, arena, block_tables,
                          kv_lens, chunk_lens):
        """((S, C, V) f32 logits at every chunk row, arena): the
        speculative verifier."""
        # saralint: ok[cow-gate] pass-through to the model step; the engine's _spec_verify call is gated by _cow_chunk_pages where it is made
        return serving.paged_verify_step(params, tokens, self.cfg, arena,
                                         block_tables, kv_lens, chunk_lens)

    def paged_decode_step(self, params, tokens, arena, block_tables,
                          kv_lens, write_mask, state=None):
        """``state``: :meth:`init_paged_state`'s dense residue (an encdec
        model's cross K/V), where the reference passes it second."""
        # saralint: ok[cow-gate] pass-through to the model step; each serving-layer call (engine _paged_decode, the draft loop) is reasoned where it is made
        return serving.paged_decode_step(params, tokens, self.cfg, arena,
                                         block_tables, kv_lens, write_mask,
                                         state)

    def paged_shared_decode_step(self, params, tokens, arena, block_tables,
                                 kv_lens, write_mask, prefix_pages,
                                 prefix_lens, unique_tables, unique_lens):
        # saralint: ok[cow-gate] pass-through to the model step; the engine's _paged_shared_decode call is reasoned where it is made
        return serving.paged_shared_decode_step(
            params, tokens, self.cfg, arena, block_tables, kv_lens,
            write_mask, prefix_pages, prefix_lens, unique_tables,
            unique_lens)


def build_model(cfg: ArchConfig, device: Optional[str] = None) -> Model:
    """``device`` defaults to CUDA and raises where there is none."""
    return Model(cfg, device)
