"""Attention (``repro/models/attention.py``).

- The blockwise route (``_chunked_attn``, with ``_chunked_attn_tri``): the
  reference's XLA attention, a loop over query and key chunks with running
  max / sum accumulators in f32, its logit softcap and its ``q_offset`` /
  ``kv_len`` masks.  It reaches no Pallas kernel in the reference, so here
  it is plain PyTorch.  The port decodes every lane of the dense layout
  in one call, so ``q_offset`` and ``kv_len`` may be per-lane ``(B,)``
  tensors where the reference's are scalars under ``vmap``.
- ``multihead_attention``: the flash-attention kernels for the calls the
  reference sends to its flash kernel (``impl="pallas"``, a full sequence
  from position 0, no softcap), the blockwise route for every other call.
- GQA self-attention with and without a dense ``KVCache`` (training,
  prefill, decode; ``causal=False`` for an encoder), cross-attention over
  an encoder's K/V, and absorbed MLA over a dense latent cache.
- The paged half: GQA (decode, cascade decode and chunked prefill) and
  absorbed MLA (decode and chunked prefill over the latent arena) through
  the physically paged KV arena and the paged kernels.

A dense cache write is in place: the new rows go into the cache's
``(B, S_max, ...)`` tensors at each sequence's length (clamped as the
reference's ``dynamic_update_slice`` clamps its start), and the returned
``KVCache`` holds the same tensors with the new lengths.  The paged arena
write is in place too: the chunk's K/V rows go into the flattened
``(NB * bs, KVH, hd)`` view of the layer's pages with ``index_copy_``,
where the reference rebuilds the array.  Rows a lane does not own this
step (past its chunk length, or a masked decode lane) all land in row 0
of the trash block, the arena's last page, which the pool never
allocates.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import dispatch
from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import (apply_rope, dense, dense_init,
                                        dtype_of, rmsnorm, softcap)
from repro_torch.parallel import tp as tp_mod

Params = Dict[str, Any]
NEG_INF = -2.0e38
Offset = Union[int, torch.Tensor]


class KVCache(NamedTuple):
    """A dense per-sequence cache: k, v (B, S_max, KVH, hd) for GQA, or
    c_kv (B, S_max, r) and k_rope (B, S_max, rd) for MLA; ``length`` (B,)
    int32 rows valid per sequence.  Stacked over layers the leaves gain a
    leading layer axis, ``length`` (L, B)."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


# ---------------------------------------------------------------------------
# the blockwise route
# ---------------------------------------------------------------------------

def _per_lane(x: Offset, device) -> torch.Tensor:
    """A scalar or (B,) offset as a (B', 1) int64 column (B' = 1 or B)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).reshape(-1, 1)
    return torch.full((1, 1), int(x), dtype=torch.int64, device=device)


def _block_step(carry, q_blk, k_blk, v_blk, mask, scale, logit_cap):
    """One (query chunk, key chunk) update of the running (m, l, acc), as
    the reference's ``kv_step``: scores and the value mix in f32 from the
    streams' dtype (a bf16 product is exact in f32), p rounded to v's
    dtype before the mix.  mask: (B', qc, kc) bool."""
    m, l, acc = carry
    # saralint: ok[dispatch-escape] activation-activation attention score; no weight shape for ADAPTNET to tile
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.float(),
                     k_blk.float()) * scale
    if logit_cap > 0.0:
        s = softcap(s, logit_cap)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    # saralint: ok[dispatch-escape] softmax-weights x values mix, both activations
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, acc_new


def _chunked_attn(q, k, v, *, causal: bool, q_offset: Offset,
                  kv_len: Offset, chunk: int, logit_cap: float = 0.0,
                  causal_skip: bool = False) -> torch.Tensor:
    """Blockwise attention.  q: (B, Sq, KVH, G, hd) grouped queries; k, v:
    (B, Skv, KVH, hd / hd_v); ``q_offset`` the absolute position of q[0]
    and ``kv_len`` the valid key rows, each an int or a (B,) tensor (one
    per sequence).  ``causal_skip`` with ``q_offset`` the int 0 is the
    reference's ``_chunked_attn_tri``: only the lower-triangular (query
    chunk, key chunk) pairs are walked, and only the diagonal pair is
    masked causally (every key of an earlier chunk precedes every query).
    Returns (B, Sq, KVH, G, hd_v) f32."""
    B, Sq, KVH, G, hd = q.shape
    Skv = k.shape[1]
    hd_v = v.shape[-1]
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    qc, kc = min(chunk, Sq), min(chunk, Skv)
    n_q, n_k = -(-Sq // qc), -(-Skv // kc)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, n_q * qc - Sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, n_k * kc - Skv))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n_k * kc - Skv))
    q_pos = _per_lane(q_offset, dev) + torch.arange(n_q * qc, device=dev)
    k_pos = torch.arange(n_k * kc, device=dev)
    kv_valid = k_pos[None, :] < _per_lane(kv_len, dev)      # (B', n_k*kc)

    def mask_of(i, j, diag=True):
        qs, ks = slice(i * qc, (i + 1) * qc), slice(j * kc, (j + 1) * kc)
        mask = kv_valid[:, None, ks]                        # (B', 1, kc)
        if causal and diag:
            mask = mask & (k_pos[None, None, ks] <= q_pos[:, qs, None])
        return mask

    def init():
        return (torch.full((B, KVH, G, qc), NEG_INF, device=dev),
                torch.zeros((B, KVH, G, qc), device=dev),
                torch.zeros((B, KVH, G, qc, hd_v), device=dev))

    def finish(carry):
        _, l, acc = carry
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,KVH,G,qc,hd)
        return out.permute(0, 3, 1, 2, 4)                   # (B,qc,KVH,G,hd)

    tri = (causal and causal_skip and not isinstance(q_offset, torch.Tensor)
           and q_offset == 0)
    blocks = []
    for i in range(n_q):
        q_blk = q[:, i * qc:(i + 1) * qc]
        carry = init()
        # the triangular walk: chunk pairs (i, j <= i) only, and only the
        # diagonal pair needs the causal mask
        for j in range(i + 1 if tri else n_k):
            ks = slice(j * kc, (j + 1) * kc)
            carry = _block_step(carry, q_blk, k[:, ks], v[:, ks],
                                mask_of(i, j, diag=not tri or i == j),
                                scale, logit_cap)
        blocks.append(finish(carry))
    return torch.cat(blocks, dim=1)[:, :Sq]


def init_gqa(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    """``lead`` prepends stacking axes (the layer axis) to every leaf."""
    dt = cfg.param_dtype
    d = cfg.d_model
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, cfg.q_dim), dt),
        "wk": dense_init(gen, lead + (d, cfg.kv_dim), dt),
        "wv": dense_init(gen, lead + (d, cfg.kv_dim), dt),
        "wo": dense_init(gen, lead + (cfg.q_dim, d), dt,
                         scale=1.0 / (cfg.q_dim ** 0.5 *
                                      (2 * cfg.num_layers) ** 0.5)),
    }
    if cfg.use_bias:
        z = dict(dtype=dtype_of(dt), device=gen.device)
        p["bq"] = torch.zeros(lead + (cfg.q_dim,), **z)
        p["bk"] = torch.zeros(lead + (cfg.kv_dim,), **z)
        p["bv"] = torch.zeros(lead + (cfg.kv_dim,), **z)
    return p


def head_tp(params, cfg: ArchConfig):
    """The ``model`` axis where a GQA block's ``wq`` holds a block of the
    heads (Megatron ``tp``: ``parallel/tp.py``), else None."""
    return tp_mod.local(cfg, params["wq"].shape[-1], cfg.q_dim)


def _proj_qkv(params, x, kv_x, cfg: ArchConfig, compute_dtype,
              site: str = "layer.attn"):
    """q, k, v (B, S, heads, hd) with the head counts of the weights held:
    under ``tp`` this rank's query heads, and the kv heads they use."""
    B = x.shape[0]
    tp = head_tp(params, cfg)
    same = kv_x is x
    x = tp_mod.copy_in(x, tp)
    kv_x = x if same else tp_mod.copy_in(kv_x, tp)
    q = dense(x, params["wq"], tp_mod.cols(
        params.get("bq"), params["wq"].shape[-1], tp), compute_dtype,
        site=f"{site}.q")
    k = dense(kv_x, params["wk"], tp_mod.cols(
        params.get("bk"), params["wk"].shape[-1], tp), compute_dtype,
        site=f"{site}.k")
    v = dense(kv_x, params["wv"], tp_mod.cols(
        params.get("bv"), params["wv"].shape[-1], tp), compute_dtype,
        site=f"{site}.v")
    hd = cfg.head_dim
    q = q.reshape(B, x.shape[1], -1, hd)
    k = k.reshape(B, kv_x.shape[1], -1, hd)
    v = v.reshape(B, kv_x.shape[1], -1, hd)
    heads = (cfg.num_heads, cfg.num_kv_heads, tp)
    return q, tp_mod.kv_for_heads(k, *heads), tp_mod.kv_for_heads(v, *heads)


def multihead_attention(q, k, v, *, causal: bool, q_offset: Offset = 0,
                        kv_len: Optional[Offset] = None, chunk: int = 1024,
                        logit_cap: float = 0.0, causal_skip: bool = False,
                        impl: str = "xla") -> torch.Tensor:
    """q: (B, Sq, H, hd); k: (B, Skv, KVH, hd); v: (B, Skv, KVH, hd_v).

    ``impl="pallas"`` (the reference's name for its flash-attention
    kernel) runs the flash-attention kernels for a full-sequence call from
    position 0 with no logit softcap, in blocks of ``min(chunk, 512)``.
    Every other call (decode, a softcap, ``q_offset`` / ``kv_len`` masks,
    or ``impl="xla"``) takes the blockwise route, as in the reference.
    The blockwise route returns f32, the flash kernels q's dtype."""
    B, Sq, H, hd = q.shape
    KVH, Skv = k.shape[2], k.shape[1]
    if kv_len is None:
        kv_len = Skv
    if (impl == "pallas" and logit_cap == 0.0
            and not isinstance(q_offset, torch.Tensor) and q_offset == 0
            and not isinstance(kv_len, torch.Tensor) and kv_len == Skv
            and Sq > 1):
        from repro_torch.kernels import ops as kops
        blk = min(chunk, 512)
        return kops.flash_attention(q, k, v, causal=causal, block_q=blk,
                                    block_k=blk)
    qg = q.reshape(B, Sq, KVH, H // KVH, hd)
    out = _chunked_attn(qg, k, v, causal=causal, q_offset=q_offset,
                        kv_len=kv_len, chunk=chunk, logit_cap=logit_cap,
                        causal_skip=causal_skip)
    return out.reshape(B, Sq, H, v.shape[-1])


def _cache_write(buf: torch.Tensor, start: torch.Tensor,
                 new: torch.Tensor) -> None:
    """Write ``new`` (B, S, ...) into ``buf`` (B, S_max, ...) at each
    sequence's ``start`` (B,), in place; the start is clamped to S_max - S
    as ``dynamic_update_slice`` clamps it (a free lane of the dense layout
    keeps decoding past its capacity; its rows are never read)."""
    B, S = new.shape[0], new.shape[1]
    s0 = torch.clamp(start.long(), 0, buf.shape[1] - S)
    rows = s0[:, None] + torch.arange(S, device=buf.device)
    lanes = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    buf[lanes, rows] = new.to(buf.dtype)


def _cache_update(cache: KVCache, k_new, v_new) -> KVCache:
    """The new rows written at each sequence's length; the lengths grow by
    the step's width."""
    _cache_write(cache.k, cache.length, k_new)
    _cache_write(cache.v, cache.length, v_new)
    return KVCache(cache.k, cache.v,
                   cache.length + k_new.shape[1])


def gqa_self_attention(params: Params, x: torch.Tensor,
                       positions: torch.Tensor, cfg: ArchConfig, *,
                       cache: Optional[KVCache] = None,
                       update_cache: bool = False, causal: bool = True,
                       fresh: bool = False
                       ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention for training (``cache=None``), prefill (a fresh
    cache) and decode (the cache holds the history; x is the new
    token(s)); ``causal=False`` is bidirectional (an encoder).  With a
    cache the attention takes the blockwise route over the whole cache,
    each sequence from its own length; ``fresh`` says the cache holds no
    row yet, so the new rows are the whole history and the attention runs
    over them alone, as without a cache (the flash kernels under
    ``attn_impl="pallas"``).  Returns (out, the cache with the new rows,
    or None without one)."""
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _proj_qkv(params, x, x, cfg, cdt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is not None and not fresh:
        start = cache.length
        new_cache = _cache_update(cache, k, v)
        out = multihead_attention(
            q, new_cache.k.to(cdt), new_cache.v.to(cdt), causal=causal,
            q_offset=start, kv_len=new_cache.length, chunk=cfg.attn_chunk,
            logit_cap=cfg.attn_logit_softcap)
    else:
        if cache is not None:        # fresh: the new rows are all its rows
            new_cache = _cache_update(cache, k, v)
        elif update_cache:
            raise ValueError("prefill with a cache must pass an initialized "
                             "cache")
        out = multihead_attention(q, k, v, causal=causal, q_offset=0,
                                  chunk=cfg.attn_chunk,
                                  logit_cap=cfg.attn_logit_softcap,
                                  causal_skip=cfg.flash_causal_skip,
                                  impl=cfg.attn_impl)
    B, S = x.shape[0], x.shape[1]
    o = dense(out.reshape(B, S, -1), params["wo"], None, cdt,
              site="layer.attn.out")
    return tp_mod.reduce_out(o, head_tp(params, cfg)), new_cache


def gqa_cross_attention(params: Params, x: torch.Tensor, enc_kv,
                        cfg: ArchConfig) -> torch.Tensor:
    """Cross-attention over an encoder's K/V ``enc_kv`` ((B, S_src, KVH,
    hd) each, no RoPE): the flash kernels for a prefill under
    ``attn_impl="pallas"``, the blockwise route for a decode step."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S = x.shape[0], x.shape[1]
    tp = head_tp(params, cfg)
    q = dense(tp_mod.copy_in(x, tp), params["wq"], tp_mod.cols(
        params.get("bq"), params["wq"].shape[-1], tp), cdt,
        site="layer.cross.q")
    q = q.reshape(B, S, -1, cfg.head_dim)
    k, v = enc_kv
    out = multihead_attention(q, k.to(cdt), v.to(cdt), causal=False,
                              chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    return tp_mod.reduce_out(dense(out.reshape(B, S, -1), params["wo"], None,
                                   cdt, site="layer.cross.out"), tp)


def cross_attention_kv(params: Params, enc_out: torch.Tensor,
                       cfg: ArchConfig):
    """The cross K/V of one decoder layer from the encoder output (B,
    S_src, d): ((B, S_src, KVH, hd), (B, S_src, KVH, hd))."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S = enc_out.shape[0], enc_out.shape[1]
    tp = head_tp(params, cfg)
    enc_out = tp_mod.copy_in(enc_out, tp)
    k = dense(enc_out, params["wk"], tp_mod.cols(
        params.get("bk"), params["wk"].shape[-1], tp), cdt,
        site="layer.cross.k")
    v = dense(enc_out, params["wv"], tp_mod.cols(
        params.get("bv"), params["wv"].shape[-1], tp), cdt,
        site="layer.cross.v")
    heads = (cfg.num_heads, cfg.num_kv_heads, tp)
    return (tp_mod.kv_for_heads(k.reshape(B, S, -1, cfg.head_dim), *heads),
            tp_mod.kv_for_heads(v.reshape(B, S, -1, cfg.head_dim), *heads))


def init_gqa_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def _paged_chunk_rows(tables: torch.Tensor, kv_lens: torch.Tensor,
                      chunk_lens: torch.Tensor, num_rows: int,
                      block_size: int, num_blocks: int) -> torch.Tensor:
    """Flat arena row for each of a lane's ``num_rows`` chunk positions
    ((S, C) int64).  Chunk row r lands at logical position
    ``kv_lens[lane] + r``; rows at or past a lane's ``chunk_lens`` land in
    row 0 of the trash block (the arena's trailing block, never
    pool-allocated), so ragged lanes and lanes with no chunk this step
    cannot corrupt live pages (the clamped table lookup keeps masked
    lanes in bounds)."""
    W = tables.shape[1]
    r = torch.arange(num_rows, device=tables.device)
    pos = kv_lens.long()[:, None] + r[None, :]                  # (S, C)
    blk = torch.gather(tables.long(), 1,
                       torch.clamp(pos // block_size, 0, W - 1))
    rows = blk * block_size + pos % block_size
    valid = r[None, :] < chunk_lens.long()[:, None]
    return torch.where(valid, rows,
                       torch.full_like(rows, (num_blocks - 1) * block_size))


def _arena_write_chunk(arena: torch.Tensor, rows: torch.Tensor,
                       new: torch.Tensor) -> torch.Tensor:
    """Write C new rows per lane into the flattened (NB*bs) arena, in
    place.  rows: (S, C); new: (S, C, *feat).  Masked rows all target the
    trash block's row 0 — colliding writes there are fine, it is discard
    space.  Returns the arena."""
    NB, bs = arena.shape[0], arena.shape[1]
    flat = arena.view((NB * bs,) + tuple(arena.shape[2:]))
    flat.index_copy_(0, rows.reshape(-1),
                     new.reshape((-1,) + tuple(new.shape[2:]))
                     .to(arena.dtype))
    return arena


def gqa_paged_decode(params: Params, x: torch.Tensor,
                     positions: torch.Tensor, cfg: ArchConfig, *, k_arena,
                     v_arena, block_tables, kv_lens, write_mask):
    """One-token batched decode through the paged KV arena.

    x: (S, 1, d) — one pending token per lane; positions: (S, 1);
    k_arena/v_arena: (NB, bs, KVH, hd) pages of this layer (trailing block
    is the write-discard scratch), written in place; block_tables: (S, W)
    int32; kv_lens: (S,) int32 tokens already in the arena; write_mask:
    (S,) int32 — 1 writes the new token's KV and attends over kv_len+1
    tokens, 0 leaves the live pages unchanged (the lane's output is
    discarded by the engine).  Returns out (S, 1, d).
    """
    from repro_torch.kernels import ops as kops
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _proj_qkv(params, x, x, cfg, cdt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    NB, bs = k_arena.shape[0], k_arena.shape[1]
    # decode is the C=1 case of the chunk write: write_mask doubles as the
    # 0/1 chunk length (masked lanes land in the trash block)
    wm = (write_mask > 0).to(kv_lens.dtype)
    rows = _paged_chunk_rows(block_tables, kv_lens, wm, 1, bs, NB)
    # saralint: ok[cow-gate] decode writes one row in place at row kv_len of the lane's exclusively-owned tail page (or the trash block when masked); shared prefix pages cover only rows < kv_len
    _arena_write_chunk(k_arena, rows, k[:, :1])
    _arena_write_chunk(v_arena, rows, v[:, :1])
    attn_len = kv_lens + wm
    o = kops.paged_attention(q[:, 0], k_arena, v_arena, block_tables,
                             attn_len, logit_cap=cfg.attn_logit_softcap)
    S = x.shape[0]
    return dense(o.reshape(S, 1, cfg.q_dim), params["wo"], None, cdt,
                 site="layer.attn.out")


def gqa_paged_shared_decode(params: Params, x: torch.Tensor,
                            positions: torch.Tensor, cfg: ArchConfig, *,
                            k_arena, v_arena, block_tables, kv_lens,
                            write_mask, prefix_pages, prefix_lens,
                            unique_tables, unique_lens):
    """Cascade-decode twin of :func:`gqa_paged_decode`: the KV write goes
    through the full per-lane ``block_tables`` exactly as there (the
    pending token's row lands in the lane's own, never shared, tail page),
    while attention splits into a shared-prefix phase over
    ``prefix_pages`` (read once for every sharing lane) and a per-lane
    unique phase over ``unique_tables``, merged by softmax state
    (kernels/ops.py::shared_paged_attention).  Rope is applied before the
    arena write, so attention over the cached rows is position-free and
    the split changes no lane's math, only how often the shared pages are
    read.  Returns out (S, 1, d)."""
    from repro_torch.kernels import ops as kops
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _proj_qkv(params, x, x, cfg, cdt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    NB, bs = k_arena.shape[0], k_arena.shape[1]
    wm = (write_mask > 0).to(kv_lens.dtype)
    rows = _paged_chunk_rows(block_tables, kv_lens, wm, 1, bs, NB)
    # saralint: ok[cow-gate] decode writes one row in place at row kv_len of the lane's exclusively-owned tail page (or the trash block when masked); shared prefix pages cover only rows < kv_len
    _arena_write_chunk(k_arena, rows, k[:, :1])
    _arena_write_chunk(v_arena, rows, v[:, :1])
    o = kops.shared_paged_attention(
        q[:, 0], k_arena, v_arena, unique_tables, unique_lens,
        prefix_pages, prefix_lens, logit_cap=cfg.attn_logit_softcap)
    S = x.shape[0]
    return dense(o.reshape(S, 1, cfg.q_dim), params["wo"], None, cdt,
                 site="layer.attn.out")


def gqa_paged_prefill(params: Params, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ArchConfig, *, k_arena,
                      v_arena, block_tables, kv_lens, chunk_lens):
    """Chunked-prefill attention through the paged KV arena.

    x: (S, C, d) — one prompt chunk per lane; positions: (S, C) absolute;
    kv_lens: (S,) int32 rows already committed per lane (the chunk's
    absolute start); chunk_lens: (S,) int32 valid new rows — rows at or
    past a lane's chunk length write to the trash block and their outputs
    are garbage the caller discards.  The chunk's K/V rows are written into
    the arena (in place) *before* attention, so chunk queries see their
    own keys causally.  Returns out (S, C, d).
    """
    from repro_torch.kernels import ops as kops
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _proj_qkv(params, x, x, cfg, cdt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    NB, bs = k_arena.shape[0], k_arena.shape[1]
    S, C = x.shape[0], x.shape[1]
    rows = _paged_chunk_rows(block_tables, kv_lens, chunk_lens, C, bs, NB)
    # saralint: ok[cow-gate] chunk rows land in place in pages the engine COW-forked via _cow_chunk_pages before this step runs (masked rows in the trash block)
    _arena_write_chunk(k_arena, rows, k)
    _arena_write_chunk(v_arena, rows, v)
    attn_len = kv_lens + chunk_lens
    o = kops.paged_prefill_attention(q, k_arena, v_arena, block_tables,
                                     kv_lens, attn_len,
                                     logit_cap=cfg.attn_logit_softcap)
    return dense(o.reshape(S, C, cfg.q_dim), params["wo"], None, cdt,
                 site="layer.attn.out")


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention), absorbed, paged
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    """``lead`` prepends stacking axes (the layer axis) to every leaf."""
    m = cfg.mla
    dt = cfg.param_dtype
    d, H = cfg.d_model, cfg.num_heads
    lead = tuple(lead)
    z = dict(dtype=dtype_of(dt), device=gen.device)
    return {
        "w_dq": dense_init(gen, lead + (d, m.q_lora_rank), dt),
        "q_norm": torch.zeros(lead + (m.q_lora_rank,), **z),
        "w_uq": dense_init(gen, lead + (m.q_lora_rank, H * (
            m.qk_nope_head_dim + m.qk_rope_head_dim)), dt),
        "w_dkv": dense_init(gen, lead + (d, m.kv_lora_rank +
                                         m.qk_rope_head_dim), dt),
        "kv_norm": torch.zeros(lead + (m.kv_lora_rank,), **z),
        "w_uk": dense_init(gen, lead + (m.kv_lora_rank,
                                        H * m.qk_nope_head_dim), dt),
        "w_uv": dense_init(gen, lead + (m.kv_lora_rank, H * m.v_head_dim),
                           dt),
        "wo": dense_init(gen, lead + (H * m.v_head_dim, d), dt,
                         scale=1.0 / ((H * m.v_head_dim) ** 0.5 *
                                      (2 * cfg.num_layers) ** 0.5)),
    }


def _mla_q(params, x, positions, cfg: ArchConfig, cdt, tp=None):
    """(q_nope, q_rope) over the heads ``w_uq`` holds; under ``tp`` the
    replicated latent enters this rank's heads through ``copy_in``."""
    m = cfg.mla
    B, S = x.shape[0], x.shape[1]
    cq = rmsnorm(dense(x, params["w_dq"], None, cdt,
                       site="layer.mla.q_down"), params["q_norm"],
                 cfg.norm_eps)
    q = dense(tp_mod.copy_in(cq, tp), params["w_uq"], None, cdt,
              site="layer.mla.q_up").reshape(
        B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim,
                                     m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params, x, positions, cfg: ArchConfig, cdt):
    m = cfg.mla
    dkv = dense(x, params["w_dkv"], None, cdt, site="layer.mla.kv_down")
    c_kv, k_rope = torch.split(dkv, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = rmsnorm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_absorb_q(q_nope, w_uk, cdt, *, site: str):
    """Absorb W_UK into the queries as the per-head bank GEMM
    x (..., H, S, d) @ w (H, d, r), one bank launch.  q_nope (..., S, H, d);
    w_uk (r, H, d).  The bank is a strided view of W_UK, read in place.
    Returns (..., S, H, r)."""
    wk = w_uk.to(cdt).permute(1, 2, 0)                      # (H, d, r)
    xq = q_nope.to(cdt).movedim(-2, -3)                     # (..., H, S, d)
    return dispatch.gemm(xq, wk, site=site).movedim(-3, -2)  # (..., S, H, r)


def _mla_mix_latent(o_lat, w_uv, cdt, *, site: str):
    """Mix attention's latent output up through W_UV as the per-head bank
    GEMM x (..., H, S, r) @ w (H, r, dv).  o_lat (..., S, H, r); w_uv
    (r, H, dv).  Returns (..., S, H, dv)."""
    wv = w_uv.to(cdt).permute(1, 0, 2)                      # (H, r, dv)
    xo = o_lat.to(cdt).movedim(-2, -3)                      # (..., H, S, r)
    return dispatch.gemm(xo, wv, site=site).movedim(-3, -2)  # (.., S, H, dv)


def mla_paged_prefill(params: Params, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ArchConfig, *,
                      ckv_arena, krope_arena, block_tables, kv_lens,
                      chunk_lens):
    """Absorbed-MLA chunked prefill through the paged latent arena.

    The arena stores the compressed (c_kv, k_rope) rows only, written in
    place before attention; chunk queries are absorbed through W_UK before
    the kernel and the latent mix goes through W_UV and W_O after.  Shapes
    as in :func:`gqa_paged_prefill` with ckv_arena (NB, bs, kv_lora_rank)
    and krope_arena (NB, bs, qk_rope_head_dim).  Returns out (S, C, d)."""
    from repro_torch.kernels import ops as kops
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    S, C = x.shape[0], x.shape[1]
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(params, x, positions, cfg, cdt)   # (S,C,H,*)
    c_kv, k_rope = _mla_ckv(params, x, positions, cfg, cdt)   # (S,C,r/rd)

    NB, bs = ckv_arena.shape[0], ckv_arena.shape[1]
    rows = _paged_chunk_rows(block_tables, kv_lens, chunk_lens, C, bs, NB)
    # saralint: ok[cow-gate] chunk rows land in place in pages the engine COW-forked via _cow_chunk_pages before this step runs (masked rows in the trash block)
    _arena_write_chunk(ckv_arena, rows, c_kv)
    _arena_write_chunk(krope_arena, rows, k_rope)

    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_abs = _mla_absorb_q(q_nope, w_uk, cdt, site="layer.mla.q_absorb")
    attn_len = kv_lens + chunk_lens
    o_lat = kops.mla_paged_prefill_attention(
        q_abs, q_rope, ckv_arena, krope_arena, block_tables, kv_lens,
        attn_len, qk_dim=m.qk_nope_head_dim + m.qk_rope_head_dim)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = _mla_mix_latent(o_lat, w_uv, cdt, site="layer.mla.v_mix")
    out = out.reshape(S, C, H * m.v_head_dim)
    return dense(out, params["wo"], None, cdt, site="layer.mla.out")


def mla_paged_decode(params: Params, x: torch.Tensor,
                     positions: torch.Tensor, cfg: ArchConfig, *, ckv_arena,
                     krope_arena, block_tables, kv_lens, write_mask):
    """Absorbed-MLA batched decode through the paged latent arena: the
    one-token form of :func:`mla_paged_prefill`, with the arena contract of
    :func:`gqa_paged_decode`.  Returns out (S, 1, d)."""
    from repro_torch.kernels import ops as kops
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    S = x.shape[0]
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(params, x, positions, cfg, cdt)   # (S,1,H,*)
    c_kv, k_rope = _mla_ckv(params, x, positions, cfg, cdt)   # (S,1,r/rd)

    NB, bs = ckv_arena.shape[0], ckv_arena.shape[1]
    wm = (write_mask > 0).to(kv_lens.dtype)
    rows = _paged_chunk_rows(block_tables, kv_lens, wm, 1, bs, NB)
    # saralint: ok[cow-gate] decode writes one row in place at row kv_len of the lane's exclusively-owned tail page (or the trash block when masked); shared prefix pages cover only rows < kv_len
    _arena_write_chunk(ckv_arena, rows, c_kv[:, :1])
    _arena_write_chunk(krope_arena, rows, k_rope[:, :1])

    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_abs = _mla_absorb_q(q_nope, w_uk, cdt,
                          site="layer.mla.q_absorb")[:, 0]
    attn_len = kv_lens + wm
    o_lat = kops.mla_paged_attention(
        q_abs, q_rope[:, 0], ckv_arena, krope_arena, block_tables, attn_len,
        qk_dim=m.qk_nope_head_dim + m.qk_rope_head_dim)       # (S, H, r)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = _mla_mix_latent(o_lat[:, None], w_uv, cdt,
                          site="layer.mla.v_mix")[:, 0]
    out = out.reshape(S, 1, H * m.v_head_dim)
    return dense(out, params["wo"], None, cdt, site="layer.mla.out")


def mla_self_attention(params: Params, x: torch.Tensor,
                       positions: torch.Tensor, cfg: ArchConfig, *,
                       cache: Optional[KVCache] = None,
                       update_cache: bool = False
                       ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """MLA self-attention.  Without a cache (training) the reference's
    expanded path: per-head keys (c_kv through W_UK, then the shared rope
    key broadcast over the heads) and values (c_kv through W_UV), causal
    full-sequence attention at hd = qk_nope + qk_rope (192) and hd_v =
    v_head_dim (128) through ``multihead_attention`` (the flash kernels
    under ``attn_impl="pallas"``), then W_O; returns (out, None).  Over a
    dense latent cache (prefill into a fresh cache, decode over the
    history) the absorbed path: the cache stores the compressed (c_kv,
    k_rope) rows only, the queries are absorbed through W_UK, the scores
    and the latent mix run in the compute dtype with the softmax in f32,
    each sequence masked at its own length; returns (out, the cache with
    the new rows)."""
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    B, S = x.shape[0], x.shape[1]
    H = cfg.num_heads
    # Megatron tp (training only): this rank's heads of w_uq / w_uk / w_uv
    # and wo; the latents, the shared rope key and their projections stay
    # replicated and enter the heads through copy_in
    tp = tp_mod.local(cfg, params["w_uk"].shape[-1],
                      H * m.qk_nope_head_dim)
    q_nope, q_rope = _mla_q(params, x, positions, cfg, cdt, tp)
    c_kv, k_rope = _mla_ckv(params, x, positions, cfg, cdt)
    if cache is None:
        if update_cache:
            raise ValueError("prefill with a cache must pass an initialized "
                             "cache")
        H = q_nope.shape[2]
        c_in = tp_mod.copy_in(c_kv, tp)
        k_nope = dense(c_in, params["w_uk"], None, cdt,
                       site="layer.mla.k_up").reshape(
            B, S, H, m.qk_nope_head_dim)
        v = dense(c_in, params["w_uv"], None, cdt,
                  site="layer.mla.v_up").reshape(B, S, H, m.v_head_dim)
        k_rope_b = tp_mod.copy_in(k_rope, tp)[:, :, None, :].expand(
            B, S, H, m.qk_rope_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_b], dim=-1)
        out = multihead_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                  causal_skip=cfg.flash_causal_skip,
                                  impl=cfg.attn_impl)
        out = out.reshape(B, S, H * m.v_head_dim)
        return tp_mod.reduce_out(dense(out, params["wo"], None, cdt,
                                       site="layer.mla.out"), tp), None
    start = cache.length
    new_cache = _cache_update(cache, c_kv, k_rope)
    ckv_all, krope_all = new_cache.k.to(cdt), new_cache.v.to(cdt)

    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_abs = _mla_absorb_q(q_nope, w_uk, cdt, site="layer.mla.q_absorb")
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(m.qk_nope_head_dim + m.qk_rope_head_dim)))
    # saralint: ok[dispatch-escape] latent attention scores against the cached activations, not a weight
    s_nope = torch.einsum("bshr,btr->bhst", q_abs, ckv_all)
    # saralint: ok[dispatch-escape] decoupled-rope scores against the cached activations, not a weight
    s_rope = torch.einsum("bshd,btd->bhst", q_rope, krope_all)
    s = (s_nope + s_rope).float() * scale
    t_pos = torch.arange(ckv_all.shape[1], device=x.device)
    q_pos = start.long()[:, None] + torch.arange(S, device=x.device)
    mask = (t_pos[None, None, :] <= q_pos[:, :, None]) & \
        (t_pos[None, None, :] < new_cache.length.long()[:, None, None])
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(cdt)
    # saralint: ok[dispatch-escape] softmax-weights x cached latent rows, both activations
    o_lat = torch.einsum("bhst,btr->bshr", p, ckv_all)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = _mla_mix_latent(o_lat, w_uv, cdt, site="layer.mla.v_mix")
    out = out.reshape(B, S, H * m.v_head_dim)
    return dense(out, params["wo"], None, cdt,
                 site="layer.mla.out"), new_cache


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device) -> KVCache:
    m = cfg.mla
    z = dict(dtype=dtype, device=device)
    return KVCache(torch.zeros((batch, max_len, m.kv_lora_rank), **z),
                   torch.zeros((batch, max_len, m.qk_rope_head_dim), **z),
                   torch.zeros((batch,), dtype=torch.int32, device=device))
