"""Serving steps (``repro/models/serving.py``) over two KV layouts.

The paged layout (attention families): chunked prefill (dense and moe),
batched decode and cascade decode through the physical KV arena ``{"k":
(L, NB, bs, KVH, hd), "v": ...}`` for GQA, the latent ``{"k": c_kv (L,
NB, bs, r), "v": k_rope (L, NB, bs, rd)}`` for MLA.  Every step writes
its new rows into the arena in place and returns it beside the logits.
A bucketed prefill (vlm and encdec always, the others with
``prefill_chunk=None``) runs through the dense cache below and is
scattered into pages by :func:`paged_prefill_write`; an encdec model's
cross K/V stay dense per slot (:func:`init_paged_state`).

The dense layout (every family): a per-sequence cache, ``{"pos": (B,)
int64, "layers": ...}`` with every leaf stacked over the layers:

- dense / moe / vlm: ``KVCache`` k, v (L, B, S_max, KVH, hd) (MLA: the
  latent c_kv, k_rope) and length (L, B);
- encdec: the same for the decoder's self-attention, and ``cross_k`` /
  ``cross_v`` (L, B, S_src, KVH, hd);
- ssm (RWKV6): ``RWKVState``, the (H, K, V) f32 WKV state and the two
  token-shift rows per sequence, O(1) in its length;
- hybrid (zamba2): ``layers`` a ``MambaState`` stacked over the Mamba
  layers (the (H, P, N) f32 SSM state and the conv's last W - 1 input
  rows per sequence), ``attn`` a ``KVCache`` stacked over the groups: each
  call of the one shared attention block keeps its own K/V rows.

``prefill(..., length=)`` runs a right-padded bucket and corrects every
KV length by the padding, as the reference does; a recurrent state
integrates every token, so the ssm and hybrid families prefill exact
lengths only.
The layer stack is a Python loop over layer views (the reference's
``lax.scan``), over ``dense_layers`` first where a model has a leading
dense stack.  Every sequence of a batch keeps its own position and
lengths, where the reference decodes its dense slots one lane each under
``vmap``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (KVCache, cross_attention_kv,
                                          init_gqa_cache, init_mla_cache)
from repro_torch.models.modules import dense, dtype_of, rmsnorm
from repro_torch.models.ssm import init_mamba_state, init_rwkv_state
from repro_torch.models.transformer import (
    Params, _check_family, _embed, _frontend_embed, _scan_rwkv,
    _unembed_weight, decoder_layer_apply, encode, hybrid_layout,
    layer_params, paged_decoder_layer_apply, paged_prefill_layer_apply,
    paged_shared_decoder_layer_apply, run_hybrid_stack)

Arena = Dict[str, torch.Tensor]
Cache = Dict[str, Any]

# families whose decode KV can live in the paged arena: one homogeneous
# self-attention stack a step (encdec pages its self-attention K/V only,
# its fixed-length cross K/V stay dense per slot); ssm/hybrid keep the
# dense slot layout (their state is O(1) in length)
PAGED_FAMILIES = ("dense", "moe", "vlm", "encdec")

# families whose state integrates every token: they keep the dense slot
# layout and prefill exact-length prompts
RECURRENT_FAMILIES = ("ssm", "hybrid")

# families whose prefill can stream through the arena in chunks: pure
# text-token causal stacks.  vlm prepends frontend rows that are not
# tokens and encdec needs the encoder pass, so both keep the bucketed
# prefill, scattered into pages by paged_prefill_write
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


def init_paged_state(cfg: ArchConfig, num_slots: int, device,
                     src_len: int = 0) -> Dict[str, torch.Tensor]:
    """Slot-stacked per-lane state that stays dense under the paged layout:
    an encdec model's cross-attention K/V ``(L, num_slots, src_len, KVH,
    hd)``; nothing for the other families."""
    st: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        shape = (cfg.num_layers, num_slots, src_len, cfg.num_kv_heads,
                 cfg.head_dim)
        dt = dtype_of(cfg.compute_dtype)
        st["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        st["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return st


def paged_prefill_write(arena: Arena, layers_cache: KVCache,
                        block_ids: torch.Tensor) -> Arena:
    """Commit a freshly prefilled batch-1 dense cache into arena pages, in
    place.  ``block_ids`` (nblk,): physical pages in logical order.  The
    copy is at page granularity: the first ``nblk * block_size`` rows of
    the dense cache (stacked (L, 1, S_max, ...)) are reshaped into pages
    and scattered, so rows past the true length are bucket padding that
    decode masks and overwrites as tokens arrive.  Returns the arena."""
    nblk = block_ids.shape[0]
    ids = block_ids.to(device=arena["k"].device, dtype=torch.int64)
    for name, dense_leaf in (("k", layers_cache.k), ("v", layers_cache.v)):
        leaf = arena[name]
        bs = leaf.shape[2]
        rows = dense_leaf[:, 0, :nblk * bs]
        leaf[:, ids] = rows.reshape((rows.shape[0], nblk, bs)
                                    + tuple(rows.shape[2:])).to(leaf.dtype)
    return arena


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
                      kv_lens: torch.Tensor, write_mask: torch.Tensor,
                      state: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, Arena]:
    """One batched decode step over every lane through the paged KV arena.

    tokens: (S, 1) int — one pending token per lane; block_tables: (S, W)
    int32; kv_lens: (S,) int32 rows already committed per lane (each
    lane's position, vlm frontend rows included); write_mask: (S,) int32 —
    lanes with 0 leave their pages untouched and their logits are
    discarded by the caller; ``state`` the slot-stacked dense residue
    (:func:`init_paged_state`: an encdec model's cross K/V).
    Returns ((S, V) f32 logits, arena)."""
    _check_paged(cfg)
    x = _embed(params, tokens, cfg)
    positions = kv_lens[:, None]
    wm = write_mask.to(torch.int32)
    cross = (iter(zip(state["cross_k"], state["cross_v"]))
             if cfg.family == "encdec" else None)

    def body(h, layer_p, ak, av):
        return paged_decoder_layer_apply(
            layer_p, h, positions, cfg, k_arena=ak, v_arena=av,
            block_tables=block_tables, kv_lens=kv_lens, write_mask=wm,
            enc_kv=None if cross is None else next(cross))

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
    if cfg.family not in CHUNKED_PREFILL_FAMILIES:
        raise ValueError(f"family {cfg.family!r} cannot prefill through the "
                         f"paged arena in chunks (supported: "
                         f"{CHUNKED_PREFILL_FAMILIES})")
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
# the dense per-sequence cache (every family)
# ---------------------------------------------------------------------------

def _layer_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device) -> KVCache:
    if cfg.attention_type == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype, device)
    return init_gqa_cache(cfg, batch, max_len, dtype, device)


def _stack_cache(proto: KVCache, n: int) -> KVCache:
    """A per-layer cache repeated over ``n`` layers (copies)."""
    return KVCache(*(t.unsqueeze(0).repeat((n,) + (1,) * t.dim())
                     for t in proto))


def init_cache(cfg: ArchConfig, batch: int, device, max_len: int = 0,
               src_len: int = 0) -> Cache:
    """A zero cache for ``batch`` sequences: ``max_len`` KV rows a sequence
    for the attention families (and ``src_len`` cross rows for encdec),
    the O(1) recurrent state for ssm, both for hybrid (the Mamba states,
    and ``max_len`` rows a sequence for each call of the shared
    block)."""
    _check_family(cfg)
    dt = dtype_of(cfg.compute_dtype)
    cache: Cache = {"pos": torch.zeros((batch,), dtype=torch.int64,
                                       device=device)}
    if cfg.family == "ssm":
        cache["layers"] = init_rwkv_state(cfg, batch, dt, device,
                                          lead=(cfg.num_layers,))
        return cache
    if max_len < 1:
        raise ValueError(f"family {cfg.family!r} needs max_len >= 1 KV rows "
                         f"a sequence, got {max_len}")
    if cfg.family == "hybrid":
        n_m, n_groups, _, _ = hybrid_layout(cfg)
        cache["layers"] = init_mamba_state(cfg, batch, dt, device,
                                           lead=(n_m,))
        cache["attn"] = _stack_cache(
            _layer_kv_cache(cfg, batch, max_len, dt, device), n_groups)
        return cache
    cache["layers"] = _stack_cache(
        _layer_kv_cache(cfg, batch, max_len, dt, device), cfg.num_layers)
    if cfg.family == "encdec":
        shape = (cfg.num_layers, batch, src_len, cfg.num_kv_heads,
                 cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def _run_decoder_stack(params: Params, x, positions, cfg: ArchConfig,
                       cache: Cache, cross: bool = False,
                       fresh: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """The decoder layers over x with each layer's slice of the stacked
    cache (written in place), the ``dense_layers`` stack first; ``cross``
    adds each layer's cross-attention over ``cache["cross_k"/"cross_v"]``;
    ``fresh``: the cache holds no row yet (:func:`prefill`).  Returns (x,
    the stacked cache with the new lengths)."""
    lc = cache["layers"]
    lengths = []
    i = 0
    for name in ("dense_layers", "layers"):
        stack = params.get(name)
        if stack is None:
            continue
        for j in range(stack["ln1"].shape[0]):
            enc_kv = ((cache["cross_k"][i], cache["cross_v"][i]) if cross
                      else None)
            x, new, _ = decoder_layer_apply(
                layer_params(stack, j), x, positions, cfg,
                cache=KVCache(lc.k[i], lc.v[i], lc.length[i]),
                enc_kv=enc_kv, fresh=fresh)
            lengths.append(new.length)
            i += 1
    return x, KVCache(lc.k, lc.v, torch.stack(lengths))


def _run_recurrent_stack(params: Params, x, cfg: ArchConfig,
                         cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """The RWKV6 or hybrid stack over x (B, S, d) from the cache's states
    (the hybrid's shared block at each sequence's position, over its K/V
    rows, written in place); returns (x after the final norm, the new
    cache with pos advanced by S)."""
    S = x.shape[1]
    new = {"pos": cache["pos"] + S}
    if cfg.family == "hybrid":
        positions = cache["pos"][:, None] + torch.arange(S, device=x.device)
        x, new["layers"], new["attn"] = run_hybrid_stack(
            params, x, positions, cfg, cache["layers"], cache["attn"])
    else:
        x, new["layers"] = _scan_rwkv(params, x, cfg, cache["layers"])
    return rmsnorm(x, params["ln_f"], cfg.norm_eps), new


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            cache: Cache, length: Optional[int] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompts ``batch["tokens"]`` (B, n) through the model into
    ``cache``, as ``init_cache`` returns it (written in place).  Returns
    (f32 logits at the last valid position (B, V), the new cache).

    ``length`` marks the valid prompt tokens when the prompts are
    right-padded to a bucket: logits come from position ``length - 1``,
    ``pos`` advances by ``length`` and every KV length is corrected by the
    padding (causal masking already hid the padded keys from the prompt).
    vlm prepends ``batch["patch_embeds"]`` (B, n_img, feature_dim) through
    the projector (its rows count into ``pos`` and the KV lengths); encdec
    runs the encoder over ``batch["src_features"]`` (B, S_src,
    feature_dim) and fills the cross K/V.  A recurrent state integrates
    every token, so the ssm and hybrid families take exact lengths
    only.

    The cache holds no row yet, so GQA self-attention runs over the
    prompt's own rows, as a training forward does: under
    ``attn_impl="pallas"`` the flash forward kernel.  The reference
    attends over the whole cache blockwise, which gives the same rows."""
    _check_family(cfg)
    fam = cfg.family
    tokens = batch["tokens"]
    n = tokens.shape[1]
    length = n if length is None else int(length)
    if fam in RECURRENT_FAMILIES:
        if length != n:
            raise ValueError(f"the {fam} family prefills exact-length "
                             f"prompts: a padded bucket would enter its "
                             f"state")
        x = _embed(params, tokens, cfg)
        x, new = _run_recurrent_stack(params, x, cfg, cache)
        return _lm_head(params, x[:, -1, :], cfg), new
    pad = n - length
    pos0 = cache["pos"]
    new_cache = dict(cache)
    if fam == "encdec":
        enc_out = encode(params, batch["src_features"], cfg)
        kv = [cross_attention_kv(layer_params(params["layers"], i)["cross"],
                                 enc_out, cfg)
              for i in range(params["layers"]["ln1"].shape[0])]
        dt = cache["cross_k"].dtype
        new_cache["cross_k"] = torch.stack([k for k, _ in kv]).to(dt)
        new_cache["cross_v"] = torch.stack([v for _, v in kv]).to(dt)
        x = _embed(params, tokens, cfg)
    elif fam == "vlm":
        img = _frontend_embed(params, batch["patch_embeds"], cfg)
        x = torch.cat([img, _embed(params, tokens, cfg)], dim=1)
    else:
        x = _embed(params, tokens, cfg)
    positions = pos0[:, None] + torch.arange(x.shape[1], device=x.device)
    x, layers = _run_decoder_stack(params, x, positions, cfg, new_cache,
                                   cross=fam == "encdec", fresh=True)
    # the stack counted the padded width into every KV length
    new_cache["layers"] = KVCache(layers.k, layers.v, layers.length - pad)
    step = length + (x.shape[1] - n)            # + the vlm frontend rows
    new_cache["pos"] = pos0 + step
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, x[:, step - 1, :], cfg), new_cache


def decode_step(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step for every sequence of the cache, each at its own
    position.  tokens: (B, 1) int.  Returns ((B, V) f32 logits, the new
    cache)."""
    _check_family(cfg)
    if cfg.family in RECURRENT_FAMILIES:
        return prefill(params, {"tokens": tokens}, cfg, cache)
    x = _embed(params, tokens, cfg)
    positions = cache["pos"][:, None] + torch.arange(
        tokens.shape[1], device=x.device)
    x, layers = _run_decoder_stack(params, x, positions, cfg, cache,
                                   cross=cfg.family == "encdec")
    new_cache = dict(cache, layers=layers,
                     pos=cache["pos"] + tokens.shape[1])
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return _lm_head(params, x[:, -1, :], cfg), new_cache
