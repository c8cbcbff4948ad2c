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

Decode and decode-lse run one split-KV kernel, planned by
:func:`_decode_plan`: a CTA holds the query rows of one (lane, kv head),
and while those CTAs would fill at most half the card each lane's page
columns are cut into splits whose f32 partial states the last CTA to
arrive merges in split order (one launch, deterministic).  Prefill and
the shared-prefix phase run one tensor-core kernel, planned by
:func:`_attn_plan` (the same rule for the prefix phase, a measured one
for prefill): a CTA holds 64 flattened query rows of a (lane, kv head)
(the prefix phase stacks every lane's rows of a kv head into one such
chunk), and takes hd, hd_v <= 256.

Arena (NB, bs, KVH, hd); tables (S, W) int32 page ids in logical order,
dead columns repeating the last live id; lengths (S,) int32 valid rows
(including a prefill chunk's own rows, written before the call).  The
``_lse`` / prefix forms also return the online-softmax state of every
query row, m (running max of the scores) and l (sum of exp(score - m)),
both f32; a row with nothing to attend comes back as (0, -1e30, 0), which
``merge_softmax_states`` treats as empty.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels.rsa_gemm import _cdiv, _tickets

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_gather(arena: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Linearize paged KV: arena (NB, bs, *feat) gathered through per-lane
    block tables (S, W) -> logical rows (S, W*bs, *feat)."""
    g = arena[tables.long()]                      # (S, W, bs, *feat)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) +
                     tuple(g.shape[3:]))


def paged_decode_plain(q, k_arena, v_arena, tables, lengths, *,
                       scale: float, logit_cap: float = 0.0):
    """Masked-dense decode attention over gathered pages (f32 softmax).

    q: (S, H, hd) one query per lane.  Returns (S, H, hd_v) in q's dtype;
    lanes of length 0 yield zeros."""
    paged_decode_plain.calls += 1
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


paged_decode_plain.calls = 0


def paged_prefill_plain(q, k_arena, v_arena, tables, starts,
                        lengths, *, scale: float,
                        logit_cap: float = 0.0):
    """Chunked-prefill attention over gathered pages (f32 softmax).

    q: (S, C, H, hd) one prompt chunk per lane; chunk row r attends
    causally to arena columns ``<= starts + r`` (and ``< lengths``).
    Returns (S, C, H, hd_v); lanes of length 0 yield zeros."""
    paged_prefill_plain.calls += 1
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


paged_prefill_plain.calls = 0


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


def paged_decode_lse_plain(q, k_arena, v_arena, tables, lengths, *,
                           scale: float, logit_cap: float = 0.0):
    """:func:`paged_decode_plain` that also returns the softmax state:
    the per-lane unique phase of cascade decode.  q (S, H, hd); returns
    (o (S, H, hd_v) normalised in q's dtype, m (S, H) f32, l (S, H) f32);
    lanes of length 0 come back as (0, -1e30, 0)."""
    paged_decode_lse_plain.calls += 1
    k = paged_gather(k_arena, tables).float()            # (S, L, KVH, hd)
    v = paged_gather(v_arena, tables).float()
    lengths = lengths.to(q.device).long()
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < \
        lengths[:, None]
    return _attention_lse(q, k, v, mask, scale, logit_cap)


paged_decode_lse_plain.calls = 0


def paged_prefix_plain(q, k_arena, v_arena, prefix_pages,
                       prefix_lens, *, scale: float,
                       logit_cap: float = 0.0):
    """Partial decode attention of every lane over ONE shared page list:
    the shared-prefix phase of cascade decode.  q (S, H, hd);
    prefix_pages (P,) int32; prefix_lens (S,) int32 prefix rows lane s
    attends (0 = not in the sharing group).  Returns (o, m, l) as
    :func:`paged_decode_lse_plain`; non-members come back as
    (0, -1e30, 0)."""
    paged_prefix_plain.calls += 1
    S = q.shape[0]
    k = paged_gather(k_arena, prefix_pages[None]).float()  # (1, L, KVH, hd)
    v = paged_gather(v_arena, prefix_pages[None]).float()
    k = k.expand((S,) + tuple(k.shape[1:]))
    v = v.expand((S,) + tuple(v.shape[1:]))
    plen = prefix_lens.to(q.device).long()
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < \
        plen[:, None]
    return _attention_lse(q, k, v, mask, scale, logit_cap)


paged_prefix_plain.calls = 0


def shared_paged_attention_plain(q, k_arena, v_arena, unique_tables,
                                 unique_lens, prefix_pages, prefix_lens, *,
                                 scale: float, logit_cap: float = 0.0):
    """Cascade decode in one pass: each lane's table is rebuilt gap-free,
    its ``prefix_lens // bs`` shared pages followed by its unique pages (the
    order its full block table has them in), and ONE masked softmax runs
    over it through :func:`paged_decode_plain`.  At the width of the
    lanes' full tables it is bitwise equal to ``paged_decode_plain``
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
    return paged_decode_plain(q, k_arena, v_arena, combined,
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


class DecodePlan(NamedTuple):
    """How ``csrc/paged_attn.cu``'s split-KV kernel runs one decode call:
    a grid of (splits, KVH * rblocks, S) CTAs of ``warps`` warps."""
    rows: int       # query rows a CTA holds: G rounded up to 1, 2, 4 or 8
    rblocks: int    # row blocks of a kv head (G > 8)
    warps: int      # warps a CTA, 1-4 (fewer where a tile's rows are wide)
    splits: int     # page-column splits of a (lane, kv head, row block)
    pages: int      # page columns a split covers (splits * pages >= W)
    units: int      # (lane, kv head, row block) triples: one ticket each
    part: int       # f32 elements of one split's partial state

    @property
    def ctas(self) -> int:
        return self.splits * self.units

    @property
    def ws_elems(self) -> int:
        return self.units * self.splits * self.part if self.splits > 1 \
            else 0


_DEC_TILE = 32            # token rows of a tile (one a lane)
_DEC_STAGES = 2           # tiles in flight a warp
_DEC_MAX_WARPS = 4
_SMEM_MAX = 232448        # dynamic shared memory a CTA may take
_MAX_HD_V = 256           # 8 output columns a lane
_MIN_SPLIT_ROWS = 128     # a split covers at least one tile a warp
_SPLIT_CTAS_PER_SM = 2    # what a split plan aims at


def _row_bytes(width: int, esize: int) -> int:
    """A shared tile row: 32-byte multiple plus 16, so the 16-byte reads of
    eight consecutive rows fall in eight different bank groups."""
    return _cdiv(width * esize, 32) * 32 + 16


@functools.lru_cache(maxsize=4096)
def _decode_plan(S: int, KVH: int, G: int, W: int, bs: int, hd: int,
                 hd_v: int, esize: int, num_sms: int, *,
                 splits: Optional[int] = None) -> DecodePlan:
    """The decode kernel's rows, warps and split-KV plan for one call.

    The lengths live on the device, so the plan sees only the table width
    W.  A CTA holds up to 8 query rows of a kv head (more rows take more
    row blocks) and 4 warps, fewer where two stages of a warp's 32-row K
    and V tiles would not fit in shared memory.  While the S * KVH * rblocks
    CTAs fill at most half the SMs, the W page columns are cut into splits
    of ``pages`` columns, aiming at ``_SPLIT_CTAS_PER_SM`` CTAs an SM, each
    split at least ``_MIN_SPLIT_ROWS`` rows (a tile for every warp); a
    grid over half the card is not split.  ``splits`` overrides the rule
    (``launch/bench_decode.py`` times the choices).  Raises where the
    kernel does not hold the shape (hd_v > 256, or rows too wide for shared
    memory)."""
    if hd_v > _MAX_HD_V:
        raise ValueError(f"the decode kernel holds hd_v <= {_MAX_HD_V}, "
                         f"got {hd_v}")
    rows = 1 if G <= 1 else 2 if G <= 2 else 4 if G <= 4 else 8
    rblocks = _cdiv(G, rows)
    vec = 16 // esize
    kw, vw = _cdiv(hd, vec) * vec, _cdiv(hd_v, 8) * 8
    per_warp = 4 * rows * _DEC_TILE + _DEC_STAGES * _DEC_TILE * (
        _row_bytes(kw, esize) + _row_bytes(vw, esize))
    warps = min(_DEC_MAX_WARPS, (_SMEM_MAX - 4 * rows * kw) // per_warp)
    if warps < 1:
        raise ValueError(f"the decode kernel's tiles of hd {hd} / hd_v "
                         f"{hd_v} do not fit in shared memory")
    units = S * KVH * rblocks
    if splits is None:
        min_pages = _cdiv(_MIN_SPLIT_ROWS, bs)
        want = _cdiv(_SPLIT_CTAS_PER_SM * num_sms, max(units, 1))
        pages = W if 2 * units > num_sms else \
            max(min_pages, _cdiv(W, want))
    else:
        pages = _cdiv(W, max(1, splits))
    pages = max(1, pages)
    splits = max(1, _cdiv(W, pages))
    return DecodePlan(rows, rblocks, warps, splits, pages, units,
                      rows * (vw + 2))


# a ticket per unit of the decode and prefill / prefix kernels (each launch
# leaves its tickets zero), apart from the GEMM's tickets
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _decode(q, k_arena, v_arena, tables, lengths, scale, logit_cap, lse,
            plan):
    """One launch of the split-KV decode kernel; (o,) or (o, m, l)."""
    from repro_torch.kernels import _build
    KVH, G, hd, hd_v, NB, bs, W = _check(q, k_arena, v_arena, tables,
                                         lengths)
    S = q.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = plan or _decode_plan(S, KVH, G, W, bs, hd, hd_v,
                                q.element_size(), sms)
    if lse:
        out, m, l = _lse_outputs(q, hd_v, S == 0)
        state = (m.data_ptr(), l.data_ptr())
    else:
        out = torch.empty((S, KVH * G, hd_v), dtype=q.dtype,
                          device=q.device)
        state = ()
    if S == 0:
        return (out, m, l) if lse else (out,)
    ws = torch.empty(plan.ws_elems, dtype=torch.float32,
                     device=q.device) if plan.splits > 1 else None
    tickets = _tickets(q.device, plan.units, _TICKETS) \
        if plan.splits > 1 else None
    lib = _build.library("paged_attn")
    launch = lib.paged_decode_lse_launch if lse else lib.paged_decode_launch
    err = launch(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), *state, tables.data_ptr(),
        lengths.data_ptr(), S, KVH, G, hd, hd_v, NB, bs, W, scale,
        logit_cap, plan.rows, plan.warps, plan.splits, plan.pages,
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged decode-lse attention" if lse else
                 "paged decode attention")
    return (out, m, l) if lse else (out,)


class AttnPlan(NamedTuple):
    """How ``csrc/paged_attn.cu``'s tensor-core kernel runs one prefill or
    shared-prefix call: a grid of (splits, KVH * rtiles, lanes) CTAs of 4
    warps, each owning 64 flattened query rows of a (lane, kv head)."""
    width: int      # D: max(hd, hd_v) rounded up to 64, 128 or 256
    rtiles: int     # 64-row tiles of a (lane, kv head)
    splits: int     # page-column splits of a unit
    pages: int      # page columns a split covers (splits * pages >= W)
    units: int      # (lane, kv head, row tile) triples: one ticket each
    part: int       # f32 elements of one split's partial state

    @property
    def ctas(self) -> int:
        return self.splits * self.units

    @property
    def ws_elems(self) -> int:
        return self.units * self.splits * self.part if self.splits > 1 \
            else 0


_ATTN_TILE = 64           # query rows of a CTA, token rows of a K/V tile
_PREFILL_SPLIT_ROWS = 128  # prefill: a split covers at least two K/V tiles
_PREFILL_CTAS_PER_SM = 4   # prefill: what the grid of splits may reach


@functools.lru_cache(maxsize=4096)
def _attn_plan(lanes: int, rows: int, KVH: int, W: int, bs: int, hd: int,
               hd_v: int, esize: int, num_sms: int, *, prefill: bool = False,
               splits: Optional[int] = None) -> AttnPlan:
    """The prefill / shared-prefix kernel's plan for one call.

    ``rows`` query rows of each of ``lanes`` lanes and ``KVH`` kv heads
    (prefill: C * G of each lane; the prefix phase: S * G of its one page
    list) are cut into 64-row tiles, one unit each.  The prefix phase cuts
    the W page columns into splits as :func:`_decode_plan` does: while the
    units fill at most half the SMs, aiming at ``_SPLIT_CTAS_PER_SM`` CTAs
    an SM, each split at least one 64-row K/V tile.  Prefill (``prefill``)
    splits under its own rule, fitted to ``launch/bench_decode.py``'s
    timings: as many splits as keep the grid within
    ``_PREFILL_CTAS_PER_SM`` CTAs an SM, each split at least
    ``_PREFILL_SPLIT_ROWS`` rows.  A prefill grid mostly waits on the
    lanes with the longest causal reach (the others' splits past their
    limit return at once), so halving their serial tiles pays even where
    the units already fill the card (phase 3's 256 units: 2 splits).
    ``splits`` overrides either rule (``launch/bench_decode.py`` times the
    choices).  Raises where the kernel does not hold the shape (hd or hd_v
    > 256)."""
    if hd > _MAX_HD_V or hd_v > _MAX_HD_V:
        raise ValueError(f"the prefill and prefix kernels hold hd, hd_v <= "
                         f"{_MAX_HD_V}, got {hd} / {hd_v}")
    wide = max(hd, hd_v)
    width = 64 if wide <= 64 else 128 if wide <= 128 else 256
    rtiles = max(1, _cdiv(rows, _ATTN_TILE))
    units = lanes * KVH * rtiles
    if splits is not None:
        pages = _cdiv(W, max(1, splits))
    elif prefill:
        most = max(1, _PREFILL_CTAS_PER_SM * num_sms // max(units, 1))
        pages = _cdiv(W, min(most, max(1, _cdiv(
            W, _cdiv(_PREFILL_SPLIT_ROWS, bs)))))
    else:
        min_pages = _cdiv(_ATTN_TILE, bs)
        want = _cdiv(_SPLIT_CTAS_PER_SM * num_sms, max(units, 1))
        pages = W if 2 * units > num_sms else \
            max(min_pages, _cdiv(W, want))
    pages = max(1, pages)
    splits = max(1, _cdiv(W, pages))
    return AttnPlan(width, rtiles, splits, pages, units,
                    _ATTN_TILE * (width + 2))


def _sms(q) -> int:
    return torch.cuda.get_device_properties(q.device).multi_processor_count


def _attn_launch(fn, what, plan, q, k_arena, v_arena, out, state, tables,
                 starts, lengths, dims, scale, logit_cap):
    """One launch of the prefill / shared-prefix kernel under ``plan``,
    with its split workspace and tickets; raises on a launch error."""
    from repro_torch.kernels import _build
    ws = torch.empty(plan.ws_elems, dtype=torch.float32,
                     device=q.device) if plan.splits > 1 else None
    tickets = _tickets(q.device, plan.units, _TICKETS) \
        if plan.splits > 1 else None
    err = getattr(_build.library("paged_attn"), fn)(
        _DTYPES[q.dtype], q.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), out.data_ptr(), *state, tables.data_ptr(),
        *(() if starts is None else (starts.data_ptr(),)),
        lengths.data_ptr(), *dims, scale, logit_cap, plan.width,
        plan.splits, plan.pages,
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)


def paged_decode_cuda(q, k_arena, v_arena, tables, lengths, *,
                      scale: float, logit_cap: float = 0.0,
                      plan: Optional[DecodePlan] = None):
    """q (S, H, hd) -> (S, H, hd_v) through the CUDA split-KV decode
    kernel, under ``_decode_plan``'s plan unless ``plan`` gives another
    (to time it)."""
    out, = _decode(q, k_arena, v_arena, tables, lengths, scale, logit_cap,
                   False, plan)
    if q.shape[0]:
        paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0      # kernel launches that returned no error


def paged_prefill_cuda(q, k_arena, v_arena, tables, starts, lengths, *,
                       scale: float, logit_cap: float = 0.0,
                       plan: Optional[AttnPlan] = None):
    """q (S, C, H, hd) -> (S, C, H, hd_v) through the CUDA prefill kernel,
    under ``_attn_plan``'s plan unless ``plan`` gives another (to time
    it)."""
    KVH, G, hd, hd_v, NB, bs, W = _check(q, k_arena, v_arena, tables,
                                         lengths, starts)
    S, C = q.shape[0], q.shape[1]
    if starts.shape != (S,):
        raise ValueError(f"starts {tuple(starts.shape)} does not match "
                         f"{S} lanes")
    plan = plan or _attn_plan(S, C * G, KVH, W, bs, hd, hd_v,
                              q.element_size(), _sms(q), prefill=True)
    out = torch.empty((S, C, KVH * G, hd_v), dtype=q.dtype, device=q.device)
    if S == 0 or C == 0:
        return out
    _attn_launch("paged_prefill_launch", "paged prefill attention", plan, q,
                 k_arena, v_arena, out, (), tables, starts, lengths,
                 (S, C, KVH, G, hd, hd_v, NB, bs, W), scale, logit_cap)
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
                          scale: float, logit_cap: float = 0.0,
                          plan: Optional[DecodePlan] = None):
    """q (S, H, hd) -> (o (S, H, hd_v), m (S, H) f32, l (S, H) f32) through
    the CUDA split-KV decode kernel with its softmax-state outputs."""
    res = _decode(q, k_arena, v_arena, tables, lengths, scale, logit_cap,
                  True, plan)
    if q.shape[0]:
        paged_decode_lse_cuda.launches += 1
    return res


paged_decode_lse_cuda.launches = 0  # kernel launches that returned no error


def paged_prefix_cuda(q, k_arena, v_arena, prefix_pages, prefix_lens, *,
                      scale: float, logit_cap: float = 0.0,
                      plan: Optional[AttnPlan] = None):
    """q (S, H, hd) -> (o (S, H, hd_v), m (S, H) f32, l (S, H) f32) through
    the CUDA shared-prefix kernel: every lane's rows against the one page
    list ``prefix_pages`` (P,), masked per lane by ``prefix_lens`` (S,),
    under ``_attn_plan``'s split-KV plan (one chunk of S * G rows a kv
    head) unless ``plan`` gives another."""
    if prefix_pages.dim() != 1:
        raise ValueError(f"prefix_pages must be 1-D, got "
                         f"{tuple(prefix_pages.shape)}")
    pages = prefix_pages.reshape(1, -1)
    KVH, G, hd, hd_v, NB, bs, P = _check(q, k_arena, v_arena, pages,
                                         prefix_lens, table_rows=1)
    S = q.shape[0]
    plan = plan or _attn_plan(1, S * G, KVH, P, bs, hd, hd_v,
                              q.element_size(), _sms(q))
    out, m, l = _lse_outputs(q, hd_v, S == 0 or P == 0)
    if S == 0 or P == 0:
        return out, m, l
    _attn_launch("paged_prefix_launch", "shared-prefix attention", plan, q,
                 k_arena, v_arena, out, (m.data_ptr(), l.data_ptr()), pages,
                 None, prefix_lens, (S, KVH, G, hd, hd_v, NB, bs, P), scale,
                 logit_cap)
    paged_prefix_cuda.launches += 1
    return out, m, l


paged_prefix_cuda.launches = 0      # kernel launches that returned no error
