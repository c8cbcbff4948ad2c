"""Dense pre-norm decoder (GQA attention + gated MLP): parameters and the
paged layer bodies of ``repro/models/transformer.py``.

Per-layer leaves are stacked on a leading layer axis, as in the reference
(``layers/attn/wq`` is (L, d, q_dim)); a layer's parameters are views of
those stacks.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (gqa_paged_decode,
                                          gqa_paged_prefill,
                                          gqa_paged_shared_decode, init_gqa)
from repro_torch.models.mlp import init_mlp, mlp_apply
from repro_torch.models.modules import (dense_init, dtype_of, embed_init,
                                        rmsnorm)

Params = Dict[str, Any]


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.attention_type != "gqa":
        raise ValueError(f"the port serves dense GQA decoders only, got "
                         f"family {cfg.family!r} / {cfg.attention_type!r}")


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters for a dense GQA decoder, drawn from ``gen`` on
    ``gen.device``."""
    _check_family(cfg)
    dt = cfg.param_dtype
    L, d = cfg.num_layers, cfg.d_model
    zeros = dict(dtype=dtype_of(dt), device=gen.device)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dt),
        "ln_f": torch.zeros((d,), **zeros),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (d, cfg.vocab_size), dt)
    p["layers"] = {
        "ln1": torch.zeros((L, d), **zeros),
        "ln2": torch.zeros((L, d), **zeros),
        "attn": init_gqa(gen, cfg, lead=(L,)),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg, lead=(L,)),
    }
    return p


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _embed(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))


def _unembed_weight(params, cfg: ArchConfig) -> torch.Tensor:
    """(d, V): the tied embedding's transposed view (no copy), or the
    untied unembedding."""
    if cfg.tie_embeddings:
        return params["embed"].t()
    return params["unembed"]


def paged_decoder_layer_apply(p: Params, x, positions, cfg: ArchConfig, *,
                              k_arena, v_arena, block_tables, kv_lens,
                              write_mask) -> torch.Tensor:
    """One decoder layer's batched single-token decode through the paged KV
    arena (see models/attention.py::gqa_paged_decode for the arena
    contract; the arena is written in place).  Returns x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = gqa_paged_decode(p["attn"], h, positions, cfg, k_arena=k_arena,
                         v_arena=v_arena, block_tables=block_tables,
                         kv_lens=kv_lens, write_mask=write_mask)
    x = x + a.to(x.dtype)
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg).to(x.dtype)


def paged_shared_decoder_layer_apply(p: Params, x, positions,
                                     cfg: ArchConfig, *, k_arena, v_arena,
                                     block_tables, kv_lens, write_mask,
                                     prefix_pages, prefix_lens,
                                     unique_tables, unique_lens
                                     ) -> torch.Tensor:
    """Cascade-decode twin of :func:`paged_decoder_layer_apply`: attention
    over a shared page prefix runs once per step for every lane in the
    sharing group (models/attention.py::gqa_paged_shared_decode).  Dense
    MLP only.  Returns x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = gqa_paged_shared_decode(
        p["attn"], h, positions, cfg, k_arena=k_arena, v_arena=v_arena,
        block_tables=block_tables, kv_lens=kv_lens, write_mask=write_mask,
        prefix_pages=prefix_pages, prefix_lens=prefix_lens,
        unique_tables=unique_tables, unique_lens=unique_lens)
    x = x + a.to(x.dtype)
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg).to(x.dtype)


def paged_prefill_layer_apply(p: Params, x, positions, cfg: ArchConfig, *,
                              k_arena, v_arena, block_tables, kv_lens,
                              chunk_lens) -> torch.Tensor:
    """One decoder layer's chunked-prefill pass through the paged KV arena
    (see models/attention.py::gqa_paged_prefill; the arena is written in
    place).  Returns x."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = gqa_paged_prefill(p["attn"], h, positions, cfg, k_arena=k_arena,
                          v_arena=v_arena, block_tables=block_tables,
                          kv_lens=kv_lens, chunk_lens=chunk_lens)
    x = x + a.to(x.dtype)
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg).to(x.dtype)
