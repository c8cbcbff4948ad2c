"""Paged serving steps: chunked prefill and batched decode through the
physical KV arena (the paged half of ``repro/models/serving.py``).

The arena is ``{"k": (L, NB, bs, KVH, hd), "v": ...}``; every step writes
its new rows into it in place and returns it beside the logits.  The
layer stack is a Python loop over layer views (the reference's
``lax.scan``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import dense, dtype_of, rmsnorm
from repro_torch.models.transformer import (Params, _check_family, _embed,
                                            _unembed_weight, layer_params,
                                            paged_decoder_layer_apply,
                                            paged_prefill_layer_apply)

Arena = Dict[str, torch.Tensor]


def init_paged_arena(cfg: ArchConfig, num_blocks: int, block_size: int,
                     device) -> Arena:
    """Per-layer physical KV pages ``(num_layers, num_blocks, block_size,
    KVH, hd)``.  The serving engine passes pool blocks + 1 and uses the
    trailing block as write-discard scratch for masked lanes."""
    _check_family(cfg)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    dt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _scan_paged_layers(body, x, params: Params, arena: Arena):
    """Run ``body(h, layer_p, k_pages, v_pages) -> h`` over the layer stack
    with each layer's arena pages (written in place)."""
    for i in range(arena["k"].shape[0]):
        x = body(x, layer_params(params["layers"], i), arena["k"][i],
                 arena["v"][i])
    return x


def _lm_head(params, h_last, cfg: ArchConfig) -> torch.Tensor:
    w = _unembed_weight(params, cfg)
    return dense(h_last, w, None, torch.float32, site="unembed")


def paged_decode_step(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                      arena: Arena, block_tables: torch.Tensor,
                      kv_lens: torch.Tensor, write_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, Arena]:
    """One batched decode step over every lane through the paged KV arena.

    tokens: (S, 1) int — one pending token per lane; block_tables: (S, W)
    int32; kv_lens: (S,) int32 rows already committed per lane (each
    lane's position); write_mask: (S,) int32 — lanes with 0 leave their
    pages untouched and their logits are discarded by the caller.
    Returns ((S, V) f32 logits, arena)."""
    _check_family(cfg)
    x = _embed(params, tokens, cfg)
    positions = kv_lens[:, None]
    wm = write_mask.to(torch.int32)

    def body(h, layer_p, ak, av):
        return paged_decoder_layer_apply(
            layer_p, h, positions, cfg, k_arena=ak, v_arena=av,
            block_tables=block_tables, kv_lens=kv_lens, write_mask=wm)

    x = _scan_paged_layers(body, x, params, arena)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, x[:, -1, :], cfg), arena


def paged_prefill_step(params: Params, tokens: torch.Tensor,
                       cfg: ArchConfig, arena: Arena,
                       block_tables: torch.Tensor, kv_lens: torch.Tensor,
                       chunk_lens: torch.Tensor
                       ) -> Tuple[torch.Tensor, Arena]:
    """One chunked-prefill step over every lane through the paged KV arena.

    tokens: (S, C) int — one prompt chunk per lane, right-padded;
    kv_lens: (S,) int32 rows already committed per lane (the chunk's
    absolute start); chunk_lens: (S,) int32 valid tokens per chunk — 0
    skips the lane (its rows write to the trash block and its logits row
    is garbage the caller ignores).  Each layer writes the chunk's K/V
    rows into the lane's pages, then attends causally over everything
    written so far.  Returns ((S, V) f32 logits at each lane's last valid
    chunk row, arena)."""
    _check_family(cfg)
    S, C = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = kv_lens[:, None] + torch.arange(C, device=kv_lens.device,
                                                dtype=kv_lens.dtype)[None]

    def body(h, layer_p, ak, av):
        return paged_prefill_layer_apply(
            layer_p, h, positions, cfg, k_arena=ak, v_arena=av,
            block_tables=block_tables, kv_lens=kv_lens,
            chunk_lens=chunk_lens)

    x = _scan_paged_layers(body, x, params, arena)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    last = torch.clamp(chunk_lens.long() - 1, 0, C - 1)
    h_last = x[torch.arange(S, device=x.device), last]
    return _lm_head(params, h_last, cfg), arena
