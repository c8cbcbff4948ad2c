"""Paged absorbed-MLA attention over the latent arena: decode and chunked
prefill.

``paged_mla_decode_cuda`` / ``paged_mla_prefill_cuda`` launch
``csrc/paged_mla.cu`` (replacing
``repro/kernels/paged_attn.py::paged_mla_decode_pallas`` and
``::paged_mla_prefill_pallas``) under :func:`_mla_plan`'s plan: row
blocks, and split-KV where the row blocks fill at most half the card (one
launch a call, split or not, merged in a fixed order).  Each counts the
launches that returned no error in its ``.launches`` (an empty problem
launches nothing and counts nothing).  The plain PyTorch versions port the
reference's masked-dense oracles
(``repro/kernels/ref.py::paged_mla_attention_ref`` and
``::paged_mla_prefill_attention_ref``): gather every lane's latent pages
through its block table, score ``q_abs . c_kv + q_rope . k_rope`` in f32,
one masked softmax, ``p @ c_kv``, zeros for a lane of length 0.  They
serve CPU tensors and are what the kernels are held against on the card.

Arenas: ckv (NB, bs, r) and krope (NB, bs, rd), shared by every head of a
lane; tables (S, W) int32 page ids in logical order, dead columns
repeating the last live id; lengths (S,) int32 valid rows (including a
prefill chunk's own rows, written before the call).  The output is the
latent mix (..., H, r) in q's dtype; the caller applies W_UV and W_O.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels.paged_attn import NEG, paged_gather
from repro_torch.kernels.rsa_gemm import _cdiv, _tickets

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 512                 # the largest r the kernel's accumulators hold
MAX_ROPE = 64                  # the largest rd
MAX_KEY = 576                  # the largest r + rd (a shared key row)


def _mla_scores(qa, qr, ckv, krope, scale: float):
    """f32 scores (..., L) of pre-absorbed queries qa (S, ..., r) / qr
    (S, ..., rd) against gathered latent rows ckv (S, L, r) / krope
    (S, L, rd)."""
    S, L = ckv.shape[0], ckv.shape[1]
    qa2 = qa.float().reshape(S, -1, qa.shape[-1])
    qr2 = qr.float().reshape(S, -1, qr.shape[-1])
    s = (torch.einsum("snr,slr->snl", qa2, ckv) +
         torch.einsum("snd,sld->snl", qr2, krope)) * scale
    return s.reshape(tuple(qa.shape[:-1]) + (L,))


def paged_mla_attention_plain(q_abs, q_rope, ckv_arena, krope_arena, tables,
                              lengths, *, scale: float):
    """Absorbed-MLA decode over gathered latent pages (f32 softmax).

    q_abs: (S, H, r); q_rope: (S, H, rd).  Returns o_lat (S, H, r) in
    q_abs's dtype; lanes of length 0 yield zeros."""
    paged_mla_attention_plain.calls += 1
    dev = q_abs.device
    ckv = paged_gather(ckv_arena, tables).float()              # (S, L, r)
    krope = paged_gather(krope_arena, tables).float()
    s = _mla_scores(q_abs, q_rope, ckv, krope, scale)          # (S, H, L)
    lengths = lengths.to(dev).long()
    mask = torch.arange(ckv.shape[1], device=dev)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("shl,slr->shr", p, ckv)
    o = torch.where((lengths > 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q_abs.dtype)


paged_mla_attention_plain.calls = 0


def paged_mla_prefill_attention_plain(q_abs, q_rope, ckv_arena, krope_arena,
                                      tables, starts, lengths, *,
                                      scale: float):
    """Absorbed-MLA chunked prefill over gathered latent pages (f32
    softmax).

    q_abs: (S, C, H, r); q_rope: (S, C, H, rd); chunk row c attends
    causally to arena columns ``<= starts + c`` (and ``< lengths``).
    Returns o_lat (S, C, H, r); lanes of length 0 yield zeros."""
    paged_mla_prefill_attention_plain.calls += 1
    dev = q_abs.device
    C = q_abs.shape[1]
    ckv = paged_gather(ckv_arena, tables).float()              # (S, L, r)
    krope = paged_gather(krope_arena, tables).float()
    s = _mla_scores(q_abs, q_rope, ckv, krope, scale)          # (S, C, H, L)
    lengths = lengths.to(dev).long()
    starts = starts.to(dev).long()
    col = torch.arange(ckv.shape[1], device=dev)
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]  # (S, C)
    mask = (col[None, None, :] < lengths[:, None, None]) & \
           (col[None, None, :] <= qpos[:, :, None])            # (S, C, L)
    s = torch.where(mask[:, :, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("schl,slr->schr", p, ckv)
    o = torch.where((lengths > 0)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.to(q_abs.dtype)


paged_mla_prefill_attention_plain.calls = 0


def _check(q_abs, q_rope, ckv_arena, krope_arena, tables, lengths,
           starts=None):
    """Validate what the kernels take; returns (H, r, rd, NB, bs, W)."""
    ts = (q_abs, q_rope, ckv_arena, krope_arena, tables, lengths) + \
        ((starts,) if starts is not None else ())
    if not all(t.is_cuda and t.device == q_abs.device for t in ts):
        raise ValueError("paged MLA kernels need every tensor on q_abs's "
                         "CUDA device")
    if q_abs.dtype not in _DTYPES or any(
            t.dtype != q_abs.dtype for t in (q_rope, ckv_arena, krope_arena)):
        raise ValueError(f"unsupported dtypes q_abs {q_abs.dtype}, q_rope "
                         f"{q_rope.dtype}, arenas {ckv_arena.dtype}/"
                         f"{krope_arena.dtype}")
    ints = (tables, lengths) + ((starts,) if starts is not None else ())
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("tables, lengths and starts must be int32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged MLA kernels need contiguous tensors")
    if ckv_arena.dim() != 3 or krope_arena.dim() != 3:
        raise ValueError(f"latent arenas must be (NB, bs, r) / (NB, bs, rd), "
                         f"got {tuple(ckv_arena.shape)} / "
                         f"{tuple(krope_arena.shape)}")
    NB, bs, r = ckv_arena.shape
    rd = krope_arena.shape[-1]
    if krope_arena.shape[:2] != (NB, bs) or q_abs.shape[-1] != r or \
            q_rope.shape[-1] != rd or q_rope.shape[:-1] != q_abs.shape[:-1]:
        raise ValueError(f"shape mismatch q_abs {tuple(q_abs.shape)} / q_rope "
                         f"{tuple(q_rope.shape)} vs arenas "
                         f"{tuple(ckv_arena.shape)} / "
                         f"{tuple(krope_arena.shape)}")
    _limits(r, rd)
    S = q_abs.shape[0]
    if tables.dim() != 2 or tables.shape[0] != S or lengths.shape != (S,) \
            or (starts is not None and starts.shape != (S,)):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {S} lanes")
    if S > 65535:
        raise ValueError(f"the MLA kernels take at most 65535 lanes, got {S}")
    return q_abs.shape[-2], r, rd, NB, bs, tables.shape[1]


def _limits(r: int, rd: int) -> None:
    """Raise for latent widths the kernel does not hold."""
    if not (0 < r <= MAX_RANK and 0 <= rd <= MAX_ROPE and
            r + rd <= MAX_KEY):
        raise ValueError(f"the MLA kernels hold r <= {MAX_RANK}, rd <= "
                         f"{MAX_ROPE} and r + rd <= {MAX_KEY}, got r = {r}, "
                         f"rd = {rd}")


class MlaPlan(NamedTuple):
    """How ``csrc/paged_mla.cu`` runs one decode or prefill call: a grid of
    (splits, rblocks, lanes) CTAs of ``rows * 4`` threads, each owning
    ``rows`` flattened query rows of a lane and one split of its page
    columns."""
    rows: int       # flattened query rows a CTA: 64 in bf16, 32 in f32
    dv: int         # accumulator width: r rounded up to 64 (f32), 128,
                    # 256 or 512
    rblocks: int    # row blocks of a lane's C * H rows
    splits: int     # page-column splits of a unit
    pages: int      # page columns a split covers (splits * pages >= W)
    units: int      # (lane, row block) pairs: one ticket each
    part: int       # f32 elements of one split's partial state

    @property
    def ctas(self) -> int:
        return self.splits * self.units

    @property
    def ws_elems(self) -> int:
        return self.units * self.splits * self.part if self.splits > 1 \
            else 0


_MLA_ROWS = {2: 64, 4: 32}     # query rows a CTA, and latent rows a tile,
                               # by element size (bf16: one wgmma M)
_MERGE_CAP = 1 << 20           # partial bytes the merging CTA reads


@functools.lru_cache(maxsize=4096)
def _mla_plan(S: int, rows_lane: int, W: int, bs: int, r: int, rd: int,
              esize: int, num_sms: int, *,
              splits: Optional[int] = None) -> MlaPlan:
    """The MLA kernel's plan for one call of ``S`` lanes with ``rows_lane``
    = C * H flattened query rows each (decode: H).

    A CTA takes 64 rows in bf16 (one wgmma M) and 32 in f32, and reads the
    latents in tiles of as many rows.  Its shared memory holds one CTA an
    SM, so while the S * rblocks units fill at most half the SMs, the W page
    columns are cut into splits of whole tiles, aiming at one CTA an SM,
    and at most as many as keep the partials the last CTA merges within
    ``_MERGE_CAP`` bytes (that merge runs on one SM); a grid over half the
    card is not split.  ``splits`` overrides the rule (``chip_smoke.py``
    phase 3, ``launch/bench_mla.py`` and the card tests force counts).
    Raises where the kernel does not hold the widths (r > 512, rd > 64 or
    r + rd > 576) or the element size."""
    _limits(r, rd)
    if esize not in _MLA_ROWS:
        raise ValueError(f"the MLA kernels take bf16 or f32, not {esize}-"
                         f"byte elements")
    rows = _MLA_ROWS[esize]
    dv = 64 if r <= 64 and esize == 4 else 128 if r <= 128 else \
        256 if r <= 256 else 512
    rblocks = max(1, _cdiv(rows_lane, rows))
    if rblocks > 65535:
        raise ValueError(f"{rows_lane} query rows a lane exceed the grid")
    units = S * rblocks
    part = rows * (dv + 2)
    if splits is not None:
        pages = _cdiv(W, max(1, splits))
    elif 2 * units > num_sms:
        pages = W
    else:
        tile = max(1, _cdiv(rows, bs))            # pages of a tile
        want = max(1, min(num_sms // max(units, 1),
                          _MERGE_CAP // (4 * part)))
        pages = _cdiv(_cdiv(W, want), tile) * tile
    pages = max(1, pages)
    splits = max(1, _cdiv(W, pages))
    return MlaPlan(rows, dv, rblocks, splits, pages, units, part)


# a ticket per (lane, row block) of the MLA kernel (each launch leaves its
# tickets zero), apart from the GEMM's and the GQA kernels'
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _launch(fn, what, plan, q_abs, q_rope, ckv_arena, krope_arena, out,
            tables, starts, lengths, dims, scale):
    """One launch of the MLA kernel under ``plan``, with its split
    workspace and tickets; raises on a launch error."""
    from repro_torch.kernels import _build
    dev = q_abs.device
    ws = torch.empty(plan.ws_elems, dtype=torch.float32, device=dev) \
        if plan.splits > 1 else None
    tickets = _tickets(dev, plan.units, _TICKETS) if plan.splits > 1 \
        else None
    err = getattr(_build.library("paged_mla"), fn)(
        _DTYPES[q_abs.dtype], q_abs.data_ptr(), q_rope.data_ptr(),
        ckv_arena.data_ptr(), krope_arena.data_ptr(), out.data_ptr(),
        tables.data_ptr(), *(() if starts is None else (starts.data_ptr(),)),
        lengths.data_ptr(), *dims, scale, plan.rows, plan.dv, plan.splits,
        plan.pages, None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)


def _sms(q) -> int:
    return torch.cuda.get_device_properties(q.device).multi_processor_count


def paged_mla_decode_cuda(q_abs, q_rope, ckv_arena, krope_arena, tables,
                          lengths, *, scale: float,
                          plan: Optional[MlaPlan] = None):
    """q_abs (S, H, r), q_rope (S, H, rd) -> o_lat (S, H, r) through the
    CUDA MLA kernel, under ``_mla_plan``'s plan unless ``plan`` gives
    another (to time it)."""
    if q_abs.dim() != 3:
        raise ValueError(f"q_abs must be (S, H, r), got {tuple(q_abs.shape)}")
    H, r, rd, NB, bs, W = _check(q_abs, q_rope, ckv_arena, krope_arena,
                                 tables, lengths)
    S = q_abs.shape[0]
    out = torch.empty_like(q_abs)
    if S == 0 or H == 0:
        return out
    plan = plan or _mla_plan(S, H, W, bs, r, rd, q_abs.element_size(),
                             _sms(q_abs))
    _launch("paged_mla_decode_launch", "paged MLA decode attention", plan,
            q_abs, q_rope, ckv_arena, krope_arena, out, tables, None,
            lengths, (S, H, r, rd, NB, bs, W), scale)
    paged_mla_decode_cuda.launches += 1
    return out


paged_mla_decode_cuda.launches = 0  # kernel launches that returned no error


def paged_mla_prefill_cuda(q_abs, q_rope, ckv_arena, krope_arena, tables,
                           starts, lengths, *, scale: float,
                           plan: Optional[MlaPlan] = None):
    """q_abs (S, C, H, r), q_rope (S, C, H, rd) -> o_lat (S, C, H, r)
    through the CUDA MLA kernel, under ``_mla_plan``'s plan unless ``plan``
    gives another (to time it)."""
    if q_abs.dim() != 4:
        raise ValueError(f"q_abs must be (S, C, H, r), got "
                         f"{tuple(q_abs.shape)}")
    H, r, rd, NB, bs, W = _check(q_abs, q_rope, ckv_arena, krope_arena,
                                 tables, lengths, starts)
    S, C = q_abs.shape[0], q_abs.shape[1]
    out = torch.empty_like(q_abs)
    if S == 0 or C == 0 or H == 0:
        return out
    plan = plan or _mla_plan(S, C * H, W, bs, r, rd, q_abs.element_size(),
                             _sms(q_abs))
    _launch("paged_mla_prefill_launch", "paged MLA prefill attention", plan,
            q_abs, q_rope, ckv_arena, krope_arena, out, tables, starts,
            lengths, (S, C, H, r, rd, NB, bs, W), scale)
    paged_mla_prefill_cuda.launches += 1
    return out


paged_mla_prefill_cuda.launches = 0  # kernel launches that returned no error
