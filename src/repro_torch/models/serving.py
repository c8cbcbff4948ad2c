"""Serving steps (``repro/models/serving.py``): for the attention families,
chunked prefill, batched decode and cascade decode through the physical
KV arena; for the recurrent ssm family (RWKV6), exact-length prefill and
batched decode over a dense per-sequence state cache.

The arena is ``{"k": (L, NB, bs, KVH, hd), "v": ...}`` for GQA and the
latent ``{"k": c_kv (L, NB, bs, r), "v": k_rope (L, NB, bs, rd)}`` for
MLA; every step writes its new rows into it in place and returns it
beside the logits.  The layer stack is a Python loop over layer views
(the reference's ``lax.scan``), over ``dense_layers`` first where a model
has a leading dense stack.

The ssm cache is ``{"pos": (B,) int64, "layers": RWKVState}`` with every
state leaf stacked over the layers, ``(L, B, ...)``: the (H, K, V) f32 WKV
state and the two token-shift rows per sequence, O(1) in its length.
There is nothing to page, so recurrent families keep this dense layout,
as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import dense, dtype_of, rmsnorm
from repro_torch.models.ssm import init_rwkv_state
from repro_torch.models.transformer import (
    Params, _check_family, _embed, _scan_rwkv, _unembed_weight,
    layer_params, paged_decoder_layer_apply, paged_prefill_layer_apply,
    paged_shared_decoder_layer_apply)

Arena = Dict[str, torch.Tensor]
Cache = Dict[str, Any]

# families whose decode KV lives in the paged arena in the reference;
# ssm/hybrid keep the dense slot layout (their state is O(1) in length)
PAGED_FAMILIES = ("dense", "moe", "vlm", "encdec")

# families whose text layers run the paged chunked path in the reference
CHUNKED_PREFILL_FAMILIES = ("dense", "moe")


def _check_paged(cfg: ArchConfig) -> None:
    _check_family(cfg)
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"family {cfg.family!r} has no paged KV arena (it "
                         f"keeps recurrent state in the dense slot layout)")


def init_paged_arena(cfg: ArchConfig, num_blocks: int, block_size: int,
                     device) -> Arena:
    """Per-layer physical KV pages ``(num_layers, num_blocks, block_size,
    *feat)``: K/V rows ``(KVH, hd)`` for GQA, the compressed latent rows
    for MLA (``k`` holds c_kv (r,), ``v`` holds k_rope (rd,)).  The serving
    engine passes pool blocks + 1 and uses the trailing block as
    write-discard scratch for masked lanes."""
    _check_paged(cfg)
    dt = dtype_of(cfg.compute_dtype)
    lead = (cfg.num_layers, num_blocks, block_size)
    if cfg.attention_type == "mla":
        m = cfg.mla
        return {"k": torch.zeros(lead + (m.kv_lora_rank,), dtype=dt,
                                 device=device),
                "v": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dt,
                                 device=device)}
    shape = lead + (cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _scan_paged_layers(body, x, params: Params, arena: Arena):
    """Run ``body(h, layer_p, k_pages, v_pages) -> h`` over the layer stack
    with each layer's arena pages (written in place): the ``dense_layers``
    stack over the arena's first layers, then ``layers`` over the rest."""
    i = 0
    for name in ("dense_layers", "layers"):
        stack = params.get(name)
        if stack is None:
            continue
        for j in range(stack["ln1"].shape[0]):
            x = body(x, layer_params(stack, j), arena["k"][i], arena["v"][i])
            i += 1
    if i != arena["k"].shape[0]:
        raise ValueError(f"the parameters hold {i} layers, the arena "
                         f"{arena['k'].shape[0]}")
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
    _check_paged(cfg)
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


def paged_shared_decode_step(params: Params, tokens: torch.Tensor,
                             cfg: ArchConfig, arena: Arena,
                             block_tables: torch.Tensor,
                             kv_lens: torch.Tensor,
                             write_mask: torch.Tensor,
                             prefix_pages: torch.Tensor,
                             prefix_lens: torch.Tensor,
                             unique_tables: torch.Tensor,
                             unique_lens: torch.Tensor
                             ) -> Tuple[torch.Tensor, Arena]:
    """Cascade decode: :func:`paged_decode_step`, but each lane's attention
    splits into a shared-prefix phase (``prefix_pages`` (P,) read once per
    step for every lane of the sharing group, ``prefix_lens`` (S,) rows of
    it per lane, 0 outside the group) and a per-lane unique phase over
    ``unique_tables`` (S, W) / ``unique_lens`` (S,), merged by softmax
    state.  The KV write still goes through the full ``block_tables``.
    GQA text families only.  Returns ((S, V) f32 logits, arena)."""
    if cfg.family not in CHUNKED_PREFILL_FAMILIES or \
            cfg.attention_type == "mla":
        raise ValueError(f"family {cfg.family!r}/{cfg.attention_type} "
                         "cannot run shared-prefix cascade decode (GQA text "
                         "families only)")
    _check_paged(cfg)
    x = _embed(params, tokens, cfg)
    positions = kv_lens[:, None]
    wm = write_mask.to(torch.int32)

    def body(h, layer_p, ak, av):
        return paged_shared_decoder_layer_apply(
            layer_p, h, positions, cfg, k_arena=ak, v_arena=av,
            block_tables=block_tables, kv_lens=kv_lens, write_mask=wm,
            prefix_pages=prefix_pages, prefix_lens=prefix_lens,
            unique_tables=unique_tables, unique_lens=unique_lens)

    x = _scan_paged_layers(body, x, params, arena)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, x[:, -1, :], cfg), arena


def _paged_chunk(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                 arena: Arena, block_tables: torch.Tensor,
                 kv_lens: torch.Tensor, chunk_lens: torch.Tensor
                 ) -> torch.Tensor:
    """The ragged chunk pass shared by prefill and verify: every layer
    writes the chunk's K/V rows into the lane's pages, then attends
    causally over everything written so far.  Returns the final-normed
    hidden rows (S, C, d)."""
    _check_paged(cfg)
    C = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    positions = kv_lens[:, None] + torch.arange(C, device=kv_lens.device,
                                                dtype=kv_lens.dtype)[None]

    def body(h, layer_p, ak, av):
        return paged_prefill_layer_apply(
            layer_p, h, positions, cfg, k_arena=ak, v_arena=av,
            block_tables=block_tables, kv_lens=kv_lens,
            chunk_lens=chunk_lens)

    x = _scan_paged_layers(body, x, params, arena)
    return rmsnorm(x, params["ln_f"], cfg.norm_eps)


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
    S, C = tokens.shape
    x = _paged_chunk(params, tokens, cfg, arena, block_tables, kv_lens,
                     chunk_lens)
    last = torch.clamp(chunk_lens.long() - 1, 0, C - 1)
    h_last = x[torch.arange(S, device=x.device), last]
    return _lm_head(params, h_last, cfg), arena


def paged_verify_step(params: Params, tokens: torch.Tensor,
                      cfg: ArchConfig, arena: Arena,
                      block_tables: torch.Tensor, kv_lens: torch.Tensor,
                      chunk_lens: torch.Tensor
                      ) -> Tuple[torch.Tensor, Arena]:
    """Speculative-decode verifier: the ragged chunked-prefill pass with
    logits at every chunk row.

    As :func:`paged_prefill_step` (tokens (S, C) carry each lane's pending
    token followed by its draft proposals; their K/V rows land in the
    lane's pages before attention), except that the LM head runs over all
    C rows: row i's logits accept or correct draft token i+1.  Returns
    ((S, C, V) f32 logits, arena); rows past ``chunk_lens`` are garbage
    the caller ignores (their K/V went to the trash page)."""
    if cfg.family not in CHUNKED_PREFILL_FAMILIES:
        raise ValueError(f"family {cfg.family!r} cannot verify through the "
                         f"paged arena (chunked prefill supports "
                         f"{CHUNKED_PREFILL_FAMILIES})")
    x = _paged_chunk(params, tokens, cfg, arena, block_tables, kv_lens,
                     chunk_lens)
    return _lm_head(params, x, cfg), arena


# ---------------------------------------------------------------------------
# the dense per-sequence state of the recurrent (ssm) family
# ---------------------------------------------------------------------------

def _check_recurrent(cfg: ArchConfig) -> None:
    _check_family(cfg)
    if cfg.family != "ssm":
        raise ValueError(
            f"the dense-cache prefill/decode is ported for the ssm family "
            f"only, got {cfg.family!r}: the attention families' dense KV "
            f"cache and bucketed prefill wait for ROADMAP.md queue 1 item 10")


def init_cache(cfg: ArchConfig, batch: int, device) -> Cache:
    """A zero state cache for ``batch`` sequences (ssm family)."""
    _check_recurrent(cfg)
    return {"pos": torch.zeros((batch,), dtype=torch.int64, device=device),
            "layers": init_rwkv_state(cfg, batch,
                                      dtype_of(cfg.compute_dtype), device,
                                      lead=(cfg.num_layers,))}


def _run_ssm_stack(params: Params, x, cfg: ArchConfig, cache: Cache
                   ) -> Tuple[torch.Tensor, Cache]:
    """The RWKV6 stack over x (B, S, d) from the cache's states; returns
    (x after the final norm, the new cache with pos advanced by S)."""
    x, states = _scan_rwkv(params, x, cfg, cache["layers"])
    new = {"pos": cache["pos"] + x.shape[1], "layers": states}
    return rmsnorm(x, params["ln_f"], cfg.norm_eps), new


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """Run exact-length prompts ``batch["tokens"]`` (B, n) through the
    model from ``cache``.  Returns (f32 logits at the last position (B, V),
    the new cache).  Prompts are never padded: a recurrent state
    integrates every input token, so the reference's padded ``length``
    has no counterpart here."""
    _check_recurrent(cfg)
    x = _embed(params, batch["tokens"], cfg)
    x, new = _run_ssm_stack(params, x, cfg, cache)
    return _lm_head(params, x[:, -1, :], cfg), new


def decode_step(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step for every sequence of the cache: a prefill of one
    token.  tokens: (B, 1) int.  Returns ((B, V) f32 logits, the new
    cache)."""
    return prefill(params, {"tokens": tokens}, cfg, cache)
