"""GQA attention through the physically paged KV arena (decode + chunked
prefill) — the paged half of ``repro/models/attention.py``.

The arena write is in place: the chunk's K/V rows go into the flattened
``(NB * bs, KVH, hd)`` view of the layer's pages with ``index_copy_``,
where the reference rebuilds the array.  Rows a lane does not own this
step (past its chunk length, or a masked decode lane) all land in row 0 of
the trash block, the arena's last page, which the pool never allocates.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import (apply_rope, dense, dense_init,
                                        dtype_of)

Params = Dict[str, Any]


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


def _proj_qkv(params, x, kv_x, cfg: ArchConfig, compute_dtype,
              site: str = "layer.attn"):
    B = x.shape[0]
    q = dense(x, params["wq"], params.get("bq"), compute_dtype,
              site=f"{site}.q")
    k = dense(kv_x, params["wk"], params.get("bk"), compute_dtype,
              site=f"{site}.k")
    v = dense(kv_x, params["wv"], params.get("bv"), compute_dtype,
              site=f"{site}.v")
    q = q.reshape(B, x.shape[1], cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, kv_x.shape[1], cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, kv_x.shape[1], cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


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
    _arena_write_chunk(k_arena, rows, k[:, :1])
    _arena_write_chunk(v_arena, rows, v[:, :1])
    attn_len = kv_lens + wm
    o = kops.paged_attention(q[:, 0], k_arena, v_arena, block_tables,
                             attn_len, logit_cap=cfg.attn_logit_softcap)
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
    _arena_write_chunk(k_arena, rows, k)
    _arena_write_chunk(v_arena, rows, v)
    attn_len = kv_lens + chunk_lens
    o = kops.paged_prefill_attention(q, k_arena, v_arena, block_tables,
                                     kv_lens, attn_len,
                                     logit_cap=cfg.attn_logit_softcap)
    return dense(o.reshape(S, C, cfg.q_dim), params["wo"], None, cdt,
                 site="layer.attn.out")
