"""Attention — the paged half of ``repro/models/attention.py``, GQA
(decode, cascade decode and chunked prefill) and absorbed MLA (decode and
chunked prefill over the latent arena) through the physically paged KV
arena, and full-sequence GQA self-attention for training (no cache),
through the flash-attention kernels.

The arena write is in place: the chunk's K/V rows go into the flattened
``(NB * bs, KVH, hd)`` view of the layer's pages with ``index_copy_``,
where the reference rebuilds the array.  Rows a lane does not own this
step (past its chunk length, or a masked decode lane) all land in row 0 of
the trash block, the arena's last page, which the pool never allocates.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import dispatch
from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import (apply_rope, dense, dense_init,
                                        dtype_of, rmsnorm)

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


def multihead_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                        chunk: int = 1024, logit_cap: float = 0.0,
                        causal_skip: bool = False, impl: str = "xla"):
    """q: (B, Sq, H, hd); k: (B, Skv, KVH, hd); v: (B, Skv, KVH, hd_v).

    ``impl="pallas"`` (the reference's name for its flash-attention
    kernel) runs the flash-attention kernels for a full-sequence call from
    position 0 with no logit softcap, in blocks of ``min(chunk, 512)``.
    Every other call is the reference's blockwise XLA route
    (``_chunked_attn``: decode, softcap, ``q_offset``/``kv_len`` masks, or
    ``impl="xla"``), which is not ported yet (ROADMAP queue 1 item 10) and
    raises; ``causal_skip`` belongs to that route."""
    Sq, Skv = q.shape[1], k.shape[1]
    if kv_len is None:
        kv_len = Skv
    if (impl == "pallas" and logit_cap == 0.0 and isinstance(q_offset, int)
            and q_offset == 0 and isinstance(kv_len, int) and kv_len == Skv
            and Sq > 1):
        from repro_torch.kernels import ops as kops
        blk = min(chunk, 512)
        return kops.flash_attention(q, k, v, causal=causal, block_q=blk,
                                    block_k=blk)
    raise NotImplementedError(
        f"attention impl={impl!r} with Sq={Sq}, q_offset={q_offset!r}, "
        f"kv_len={kv_len!r}, logit_cap={logit_cap}: the blockwise XLA route "
        f"(_chunked_attn) and the softcap/offset fallbacks are not ported "
        f"yet (ROADMAP queue 1 item 10); full-sequence attention runs with "
        f"attn_impl='pallas' (get_arch(..., optimized=True))")


def gqa_self_attention(params: Params, x: torch.Tensor,
                       positions: torch.Tensor, cfg: ArchConfig, *,
                       cache=None, update_cache: bool = False,
                       causal: bool = True):
    """Full-sequence self-attention for training (``cache=None``); the
    reference's prefill/decode through a dense cache is not ported (the
    port serves through the paged arena).  Returns (out, None)."""
    if cache is not None or update_cache:
        raise NotImplementedError("dense-cache prefill/decode is not ported "
                                  "(ROADMAP queue 1 item 10); serve through "
                                  "the paged arena")
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _proj_qkv(params, x, x, cfg, cdt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = multihead_attention(q, k, v, causal=causal, q_offset=0,
                              chunk=cfg.attn_chunk,
                              logit_cap=cfg.attn_logit_softcap,
                              causal_skip=cfg.flash_causal_skip,
                              impl=cfg.attn_impl)
    B, S = x.shape[0], x.shape[1]
    return dense(out.reshape(B, S, cfg.q_dim), params["wo"], None, cdt,
                 site="layer.attn.out"), None


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


def _mla_q(params, x, positions, cfg: ArchConfig, cdt):
    m = cfg.mla
    B, S = x.shape[0], x.shape[1]
    cq = rmsnorm(dense(x, params["w_dq"], None, cdt,
                       site="layer.mla.q_down"), params["q_norm"],
                 cfg.norm_eps)
    q = dense(cq, params["w_uq"], None, cdt, site="layer.mla.q_up").reshape(
        B, S, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
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
