"""Paged GQA attention over a physically paged KV arena: decode, prefill
and the two phases of cascade (shared-prefix) decode.

``paged_decode_cuda`` / ``paged_prefill_cuda`` / ``paged_decode_lse_cuda``
/ ``paged_prefix_cuda`` launch ``csrc/paged_attn.cu`` (replacing
``repro/kernels/paged_attn.py::paged_gqa_decode_pallas``,
``::paged_gqa_prefill_pallas``, ``::paged_gqa_decode_lse_pallas`` and
``::paged_gqa_prefix_pallas``); each counts the launches that returned no
error in its ``.launches`` (an empty problem launches nothing and counts
nothing).  The plain PyTorch versions port the reference's masked-dense
oracles (``repro/kernels/ref.py``): gather every lane's pages through its
block table, run one masked f32 softmax, zero the lanes of length 0.  They
serve CPU tensors and are what the kernels are held against on the card.

Arena (NB, bs, KVH, hd); tables (S, W) int32 page ids in logical order,
dead columns repeating the last live id; lengths (S,) int32 valid rows
(including a prefill chunk's own rows, written before the call).  The
``_lse`` / prefix forms also return the online-softmax state of every
query row, m (running max of the scores) and l (sum of exp(score - m)),
both f32; a row with nothing to attend comes back as (0, -1e30, 0), which
``merge_softmax_states`` treats as empty.
"""

from __future__ import annotations

import torch

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_gather(arena: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Linearize paged KV: arena (NB, bs, *feat) gathered through per-lane
    block tables (S, W) -> logical rows (S, W*bs, *feat)."""
    g = arena[tables.long()]                      # (S, W, bs, *feat)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) +
                     tuple(g.shape[3:]))


def paged_attention_plain(q, k_arena, v_arena, tables, lengths, *,
                          scale: float, logit_cap: float = 0.0):
    """Masked-dense decode attention over gathered pages (f32 softmax).

    q: (S, H, hd) one query per lane.  Returns (S, H, hd_v) in q's dtype;
    lanes of length 0 yield zeros."""
    paged_attention_plain.calls += 1
    S, H, hd = q.shape
    KVH = k_arena.shape[2]
    G = H // KVH
    k = paged_gather(k_arena, tables).float()          # (S, L, KVH, hd)
    v = paged_gather(v_arena, tables).float()
    qf = q.float().reshape(S, KVH, G, hd)
    s = torch.einsum("shgd,slhd->shgl", qf, k) * scale
    if logit_cap > 0.0:
        s = torch.tanh(s / logit_cap) * logit_cap
    lengths = lengths.to(q.device).long()
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < \
        lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shgl,slhd->shgd", p, v)
    o = torch.where((lengths > 0)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(S, H, v.shape[-1]).to(q.dtype)


paged_attention_plain.calls = 0


def paged_prefill_attention_plain(q, k_arena, v_arena, tables, starts,
                                  lengths, *, scale: float,
                                  logit_cap: float = 0.0):
    """Chunked-prefill attention over gathered pages (f32 softmax).

    q: (S, C, H, hd) one prompt chunk per lane; chunk row r attends
    causally to arena columns ``<= starts + r`` (and ``< lengths``).
    Returns (S, C, H, hd_v); lanes of length 0 yield zeros."""
    paged_prefill_attention_plain.calls += 1
    S, C, H, hd = q.shape
    KVH = k_arena.shape[2]
    G = H // KVH
    k = paged_gather(k_arena, tables).float()          # (S, L, KVH, hd)
    v = paged_gather(v_arena, tables).float()
    qf = q.float().reshape(S, C, KVH, G, hd)
    s = torch.einsum("schgd,slhd->shgcl", qf, k) * scale
    if logit_cap > 0.0:
        s = torch.tanh(s / logit_cap) * logit_cap
    dev = q.device
    lengths = lengths.to(dev).long()
    starts = starts.to(dev).long()
    col = torch.arange(k.shape[1], device=dev)
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]  # (S, C)
    mask = (col[None, None, :] < lengths[:, None, None]) & \
           (col[None, None, :] <= qpos[:, :, None])            # (S, C, L)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shgcl,slhd->schgd", p, v)
    o = torch.where((lengths > 0)[:, None, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(S, C, H, v.shape[-1]).to(q.dtype)


paged_prefill_attention_plain.calls = 0


def merge_softmax_states(o_a, m_a, l_a, o_b, m_b, l_b):
    """Combine two normalised partial attentions over disjoint key sets into
    the exact softmax over their union.

    ``o_*``: (..., hd_v) normalised outputs; ``m_*``: (...) running max of
    the raw scores; ``l_*``: (...) sum of ``exp(score - m)``.  An empty
    state (``l == 0``, ``m == -1e30``) leaves the other side as it is; two
    empty states give zeros.  Returns (o f32, m, l) of the union."""
    o_a, o_b = o_a.float(), o_b.float()
    m = torch.maximum(m_a, m_b)
    a = l_a * torch.exp(m_a - m)
    b = l_b * torch.exp(m_b - m)
    l = a + b
    denom = torch.clamp(l, min=1e-30)
    o = (o_a * a[..., None] + o_b * b[..., None]) / denom[..., None]
    return o, m, l


def _attention_lse(q, k, v, mask, scale: float, logit_cap: float):
    """One masked f32 softmax with its state.  q (S, H, hd); k, v (S, L,
    KVH, hd[_v]) f32; mask (S, L).  The mask is applied to p as well as to
    the scores: a fully masked row has m == -1e30, where every masked
    exp(s - m) would be exp(0) == 1, and must keep l == 0."""
    S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qf = q.float().reshape(S, KVH, G, hd)
    s = torch.einsum("shgd,slhd->shgl", qf, k) * scale
    if logit_cap > 0.0:
        s = torch.tanh(s / logit_cap) * logit_cap
    live = mask[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG))
    m = s.max(dim=-1).values                                  # (S, KVH, G)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("shgl,slhd->shgd", p, v) / \
        torch.clamp(l, min=1e-30)[..., None]
    return (o.reshape(S, H, v.shape[-1]).to(q.dtype), m.reshape(S, H),
            l.reshape(S, H))


def paged_attention_lse_plain(q, k_arena, v_arena, tables, lengths, *,
                              scale: float, logit_cap: float = 0.0):
    """:func:`paged_attention_plain` that also returns the softmax state:
    the per-lane unique phase of cascade decode.  q (S, H, hd); returns
    (o (S, H, hd_v) normalised in q's dtype, m (S, H) f32, l (S, H) f32);
    lanes of length 0 come back as (0, -1e30, 0)."""
    paged_attention_lse_plain.calls += 1
    k = paged_gather(k_arena, tables).float()            # (S, L, KVH, hd)
    v = paged_gather(v_arena, tables).float()
    lengths = lengths.to(q.device).long()
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < \
        lengths[:, None]
    return _attention_lse(q, k, v, mask, scale, logit_cap)


paged_attention_lse_plain.calls = 0


def shared_prefix_attention_plain(q, k_arena, v_arena, prefix_pages,
                                  prefix_lens, *, scale: float,
                                  logit_cap: float = 0.0):
    """Partial decode attention of every lane over ONE shared page list:
    the shared-prefix phase of cascade decode.  q (S, H, hd);
    prefix_pages (P,) int32; prefix_lens (S,) int32 prefix rows lane s
    attends (0 = not in the sharing group).  Returns (o, m, l) as
    :func:`paged_attention_lse_plain`; non-members come back as
    (0, -1e30, 0)."""
    shared_prefix_attention_plain.calls += 1
    S = q.shape[0]
    k = paged_gather(k_arena, prefix_pages[None]).float()  # (1, L, KVH, hd)
    v = paged_gather(v_arena, prefix_pages[None]).float()
    k = k.expand((S,) + tuple(k.shape[1:]))
    v = v.expand((S,) + tuple(v.shape[1:]))
    plen = prefix_lens.to(q.device).long()
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < \
        plen[:, None]
    return _attention_lse(q, k, v, mask, scale, logit_cap)


shared_prefix_attention_plain.calls = 0


def shared_paged_attention_plain(q, k_arena, v_arena, unique_tables,
                                 unique_lens, prefix_pages, prefix_lens, *,
                                 scale: float, logit_cap: float = 0.0):
    """Cascade decode in one pass: each lane's table is rebuilt gap-free,
    its ``prefix_lens // bs`` shared pages followed by its unique pages (the
    order its full block table has them in), and ONE masked softmax runs
    over it through :func:`paged_attention_plain`.  At the width of the
    lanes' full tables it is bitwise equal to ``paged_attention_plain``
    over those tables: the only difference is dead columns, whose scores
    are masked to -1e30 and whose p is exactly 0.  Returns (S, H, hd_v)."""
    S = q.shape[0]
    bs = k_arena.shape[1]
    pw, uw = prefix_pages.shape[0], unique_tables.shape[1]
    dev = q.device
    prefix_pages = prefix_pages.to(dev).long()
    unique_tables = unique_tables.to(dev).long()
    npref = prefix_lens.to(dev).long() // bs                  # (S,)
    j = torch.arange(pw + uw, device=dev)
    in_prefix = j[None, :] < npref[:, None]                   # (S, W)
    pref_cols = prefix_pages[torch.clamp(j, 0, pw - 1)][None] \
        .expand(S, pw + uw)
    uniq_idx = torch.clamp(j[None, :] - npref[:, None], 0, uw - 1)
    uniq_cols = torch.gather(unique_tables, 1, uniq_idx)
    combined = torch.where(in_prefix, pref_cols, uniq_cols)
    return paged_attention_plain(q, k_arena, v_arena, combined,
                                 prefix_lens.to(dev) + unique_lens.to(dev),
                                 scale=scale, logit_cap=logit_cap)


def _check(q, k_arena, v_arena, tables, lengths, starts=None,
           table_rows=None):
    """Validate what the kernels take; returns (KVH, G, hd, hd_v, NB, bs, W).
    ``tables`` has one row per lane, or ``table_rows`` rows."""
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_arena, v_arena, tables, lengths)):
        raise ValueError("paged attention kernels need every tensor on "
                         "q's CUDA device")
    if q.dtype not in _DTYPES or k_arena.dtype != q.dtype or \
            v_arena.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes q {q.dtype}, arenas "
                         f"{k_arena.dtype}/{v_arena.dtype}")
    ints = (tables, lengths) + ((starts,) if starts is not None else ())
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("tables, lengths and starts must be int32")
    if not all(t.is_contiguous() for t in (q, k_arena, v_arena) + ints):
        raise ValueError("paged attention kernels need contiguous tensors")
    NB, bs, KVH, hd = k_arena.shape
    hd_v = v_arena.shape[-1]
    if v_arena.shape[:3] != k_arena.shape[:3] or q.shape[-1] != hd or \
            q.shape[-2] % KVH:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} vs arenas "
                         f"{tuple(k_arena.shape)}/{tuple(v_arena.shape)}")
    S = q.shape[0]
    rows = S if table_rows is None else table_rows
    if tables.dim() != 2 or tables.shape[0] != rows or \
            lengths.shape != (S,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {S} lanes")
    return KVH, q.shape[-2] // KVH, hd, hd_v, NB, bs, tables.shape[1]


def paged_decode_cuda(q, k_arena, v_arena, tables, lengths, *,
                      scale: float, logit_cap: float = 0.0):
    """q (S, H, hd) -> (S, H, hd_v) through the CUDA decode kernel."""
    from repro_torch.kernels import _build
    KVH, G, hd, hd_v, NB, bs, W = _check(q, k_arena, v_arena, tables,
                                         lengths)
    S = q.shape[0]
    out = torch.empty((S, KVH * G, hd_v), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    err = _build.library("paged_attn").paged_decode_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), S, KVH, G, hd, hd_v, NB, bs, W, scale,
        logit_cap, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged decode attention")
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0      # kernel launches that returned no error


def paged_prefill_cuda(q, k_arena, v_arena, tables, starts, lengths, *,
                       scale: float, logit_cap: float = 0.0):
    """q (S, C, H, hd) -> (S, C, H, hd_v) through the CUDA prefill
    kernel."""
    from repro_torch.kernels import _build
    KVH, G, hd, hd_v, NB, bs, W = _check(q, k_arena, v_arena, tables,
                                         lengths, starts)
    S, C = q.shape[0], q.shape[1]
    if starts.shape != (S,):
        raise ValueError(f"starts {tuple(starts.shape)} does not match "
                         f"{S} lanes")
    if 32 * hd_v > 128 * 16:
        raise ValueError(f"the prefill kernel holds hd_v <= 64, got {hd_v}")
    out = torch.empty((S, C, KVH * G, hd_v), dtype=q.dtype, device=q.device)
    if S == 0 or C == 0:
        return out
    err = _build.library("paged_attn").paged_prefill_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), tables.data_ptr(),
        starts.data_ptr(), lengths.data_ptr(), S, C, KVH, G, hd, hd_v, NB,
        bs, W, scale, logit_cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged prefill attention")
    paged_prefill_cuda.launches += 1
    return out


paged_prefill_cuda.launches = 0     # kernel launches that returned no error


def _lse_outputs(q, hd_v, empty: bool):
    """(o, m, l) buffers; filled with the empty state (0, -1e30, 0) when no
    kernel will write them."""
    S, H = q.shape[0], q.shape[1]
    if empty:
        return (torch.zeros((S, H, hd_v), dtype=q.dtype, device=q.device),
                torch.full((S, H), NEG, dtype=torch.float32,
                           device=q.device),
                torch.zeros((S, H), dtype=torch.float32, device=q.device))
    return (torch.empty((S, H, hd_v), dtype=q.dtype, device=q.device),
            torch.empty((S, H), dtype=torch.float32, device=q.device),
            torch.empty((S, H), dtype=torch.float32, device=q.device))


def paged_decode_lse_cuda(q, k_arena, v_arena, tables, lengths, *,
                          scale: float, logit_cap: float = 0.0):
    """q (S, H, hd) -> (o (S, H, hd_v), m (S, H) f32, l (S, H) f32) through
    the CUDA decode kernel with its softmax-state outputs."""
    from repro_torch.kernels import _build
    KVH, G, hd, hd_v, NB, bs, W = _check(q, k_arena, v_arena, tables,
                                         lengths)
    S = q.shape[0]
    out, m, l = _lse_outputs(q, hd_v, S == 0)
    if S == 0:
        return out, m, l
    err = _build.library("paged_attn").paged_decode_lse_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), S, KVH, G, hd, hd_v, NB, bs,
        W, scale, logit_cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged decode-lse attention")
    paged_decode_lse_cuda.launches += 1
    return out, m, l


paged_decode_lse_cuda.launches = 0  # kernel launches that returned no error


def paged_prefix_cuda(q, k_arena, v_arena, prefix_pages, prefix_lens, *,
                      scale: float, logit_cap: float = 0.0):
    """q (S, H, hd) -> (o (S, H, hd_v), m (S, H) f32, l (S, H) f32) through
    the CUDA shared-prefix kernel: every lane's rows against the one page
    list ``prefix_pages`` (P,), masked per lane by ``prefix_lens`` (S,)."""
    from repro_torch.kernels import _build
    if prefix_pages.dim() != 1:
        raise ValueError(f"prefix_pages must be 1-D, got "
                         f"{tuple(prefix_pages.shape)}")
    pages = prefix_pages.reshape(1, -1)
    KVH, G, hd, hd_v, NB, bs, P = _check(q, k_arena, v_arena, pages,
                                         prefix_lens, table_rows=1)
    if 32 * hd_v > 128 * 16:
        raise ValueError(f"the prefix kernel holds hd_v <= 64, got {hd_v}")
    S = q.shape[0]
    out, m, l = _lse_outputs(q, hd_v, S == 0 or P == 0)
    if S == 0 or P == 0:
        return out, m, l
    err = _build.library("paged_attn").paged_prefix_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        pages.data_ptr(), prefix_lens.data_ptr(), S, KVH, G, hd, hd_v, NB,
        bs, P, scale, logit_cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "shared-prefix attention")
    paged_prefix_cuda.launches += 1
    return out, m, l


paged_prefix_cuda.launches = 0      # kernel launches that returned no error
