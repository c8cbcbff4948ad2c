"""Flash attention, forward and backward: full-sequence causal or
bidirectional GQA attention that never writes an (Sq, Skv) score matrix
to memory.

``flash_fwd_cuda`` / ``flash_dq_cuda`` / ``flash_dkv_cuda`` launch the
three kernels of ``csrc/flash_attn.cu`` (replacing
``repro/kernels/flash_attn.py::_flash_fwd`` and the dq and dk/dv
``pallas_call`` sites of ``::_flash_bwd``); each counts the launches that
returned no error in its ``.launches`` (an empty problem launches nothing
and counts nothing).  The kernels take any Sq/Skv and mask the ragged
edges themselves.

:func:`_flash_plan` decides how the three kernels run a call (the
forward's and dk/dv's ring stages, the query rows of a forward or dq CTA,
the kv rows of a dk/dv CTA and the query heads it walks, so the partials
a kv head's group is summed from); each kernel issues its heaviest causal
tiles first, in the order :func:`_fwd_ctas` (forward and dq) and
:func:`_dkv_ctas` spell out.  bf16 runs all three on kernels of their
own, on the tensor cores (bf16 tiles in shared memory, p and ds as
register operands of ``mma.sync``), under the plan's bf16 rules.  All
three f32 kernels past hd 128 run on pairs of CTAs that split the head
dim in halves (:func:`_half_cols`) and exchange their partial scores, so
the three build each score from the same quarters in the same order.

``flash_fwd_plain`` / ``flash_dq_plain`` / ``flash_dkv_plain`` are the
plain PyTorch versions, used for CPU tensors and as what the kernels are
held against on the card.  They follow the reference's arithmetic block for block: operands padded to
(bq, bk) multiples, the same (q-block, kv-block) pair order (``_pairs``:
i-major for the forward and dq, j-major for dk/dv), masked scores set to
``NEG = -1e30`` (so a masked column gives p = 0, never NaN), p cast to v's
type before p @ v, l clamped at 1e-30, ds cast to the operand type before
ds @ k and ds^T @ q, and per-q-head dk/dv summed over each kv head's group
of G heads in the output type.  Scores, softmax state and accumulators are
f32 throughout.

Layouts are the model's: q (B, Sq, H, hd), k (B, Skv, KVH, hd), v (B, Skv,
KVH, hd_v), o (B, Sq, H, hd_v) in q's type, lse and delta (B, H, Sq) f32.
H must be a multiple of KVH; hd and hd_v are at most 256 (``MAX_HEAD_DIM``;
the f32 kernels split heads wider than 128 into the halves of a CTA pair,
the source's header says how); a causal mask
compares absolute positions (column <= row), as the reference's does.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256             # the widest hd / hd_v the kernels' tiles hold


def _pairs(n_q: int, n_k: int, bq: int, bk: int, causal: bool,
           order: str) -> List[Tuple[int, int, bool, bool]]:
    """(q-block i, kv-block j, start, emit) in the reference's order.
    Causal keeps the pairs that overlap the lower triangle; in j order a kv
    block past every q row is visited once, fully masked, so its dk/dv
    block is written (as zeros)."""
    def overlap(i: int, j: int) -> bool:
        return (not causal) or ((i + 1) * bq - 1 >= j * bk)

    if order == "i":
        ps = [(i, j) for i in range(n_q) for j in range(n_k) if overlap(i, j)]
        key = 0
    else:
        ps = []
        for j in range(n_k):
            js = [(i, j) for i in range(n_q) if overlap(i, j)]
            ps.extend(js if js else [(n_q - 1, j)])
        key = 1
    n = len(ps)
    return [(i, j, t == 0 or ps[t][key] != ps[t - 1][key],
             t == n - 1 or ps[t][key] != ps[t + 1][key])
            for t, (i, j) in enumerate(ps)]


def _split_bf16(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) in bf16 with hi = bf16(p) and lo = bf16(p - hi): the pair
    the tensor-core dk/dv multiplies do by (two products), so that dv
    takes the f32 p as the reference's does.  p - hi is exact in f32 and
    lo rounds it to 8 bits, so hi + lo is p to within 2^-17 of |p|."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def _heads_major(x: torch.Tensor, rows: int, G: int = 1) -> torch.Tensor:
    """(B, S, heads, d) padded to ``rows`` -> (B, heads * G, rows, d), each
    kv head repeated for its G query heads."""
    x = F.pad(x, (0, 0, 0, 0, 0, rows - x.shape[1])).transpose(1, 2)
    return x.repeat_interleave(G, dim=1) if G > 1 else x


# ln 2 as high bits (n * _LN2_HI is exact for |n| < 2^21) and the rest
_LOG2E = 1.4426950408889634
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_EXP_TERMS = [1.0 / math.factorial(k) for k in range(14)]


def _exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp, taken in f64 and rounded: the correctly rounded value (but
    for ~1e-8 of arguments on the CPU) the kernels' and the reference's
    f32 exp approximate to an ulp or two.  On the CPU it is built from f64
    adds and multiplies, an exact rounding and an exact power of two, so
    every element gets the same bits however the elementwise kernels split
    the tensor: torch 2.13's vectorised CPU exp has returned values ~1e-4
    (f32) and ~1e-10 (f64) off on part of a tensor on its first call in a
    process.  x = n ln 2 + r with |r| <= ln 2 / 2, exp(r) by its Taylor
    series to r^13 (error < 2^-57), times 2^n; x is clamped to [-200, 100],
    whose ends round to 0 and inf in f32.  A CUDA tensor takes torch's f64
    exp, one element a thread (the formula's 15 passes over f64 tensors
    made the plain versions 5x slower on the card)."""
    if x.is_cuda:
        return torch.exp(x.double()).float()
    d = x.double().clamp(-200.0, 100.0)
    n = torch.round(d * _LOG2E)
    r = (d - n * _LN2_HI) - n * _LN2_LO
    e = torch.full_like(r, _EXP_TERMS[-1])
    for c in reversed(_EXP_TERMS[:-1]):
        e = e * r + c
    two_n = ((n.long() + 1023) << 52).view(torch.float64)
    return (e * two_n).float()


def _masked_scores(qb, kb, i, j, bq, bk, kv_len, causal, scale):
    """f32 (B, H, bq, bk) scores of q-block i against kv-block j, masked
    to NEG past kv_len and (causal) above the diagonal."""
    s = (qb.float() @ kb.float().transpose(-1, -2)) * scale
    row = i * bq + torch.arange(bq, device=s.device)[:, None]
    col = j * bk + torch.arange(bk, device=s.device)[None, :]
    m = col < kv_len
    if causal:
        m = m & (col <= row)
    return torch.where(m, s, torch.full_like(s, NEG))


def flash_fwd_plain(q, k, v, *, causal: bool, scale: float, bq: int,
                    bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, Sq, H, hd_v) in q's type, lse (B, H, Sq) f32)."""
    flash_fwd_plain.calls += 1
    B, Sq, H, _ = q.shape
    Skv, KVH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    n_q, n_k = -(-Sq // bq), -(-Skv // bk)
    qh = _heads_major(q, n_q * bq)
    kh, vh = _heads_major(k, n_k * bk, G), _heads_major(v, n_k * bk, G)
    o = torch.empty((B, H, n_q * bq, hd_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, n_q * bq), dtype=torch.float32, device=q.device)
    for i, j, start, emit in _pairs(n_q, n_k, bq, bk, causal, "i"):
        rows = slice(i * bq, (i + 1) * bq)
        cols = slice(j * bk, (j + 1) * bk)
        if start:
            m = torch.full((B, H, bq), NEG, device=q.device)
            l = torch.zeros((B, H, bq), device=q.device)
            acc = torch.zeros((B, H, bq, hd_v), device=q.device)
        s = _masked_scores(qh[:, :, rows], kh[:, :, cols], i, j, bq, bk, Skv,
                           causal, scale)
        m_new = torch.maximum(m, s.amax(-1))
        p = _exp(s - m_new[..., None])
        corr = _exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + \
            p.to(v.dtype).float() @ vh[:, :, cols].float()
        m = m_new
        if emit:
            lc = torch.clamp(l, min=1e-30)
            o[:, :, rows] = (acc / lc[..., None]).to(q.dtype)
            lse[:, :, rows] = m + torch.log(lc.double()).float()
    return o[:, :, :Sq].transpose(1, 2).contiguous(), \
        lse[:, :, :Sq].contiguous()


flash_fwd_plain.calls = 0


def _bwd_blocks(q, k, v, do, lse, delta, causal, scale, bq, bk):
    """The padded, head-major operands of the backward and ``block(i, j)``,
    which recomputes pair (i, j)'s p = exp(s - lse) and ds = p (dp - delta)
    * scale as the reference's dq and dk/dv kernels both do."""
    B, Sq, H, _ = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    n_q, n_k = -(-Sq // bq), -(-Skv // bk)
    qh, doh = _heads_major(q, n_q * bq), _heads_major(do, n_q * bq)
    kh, vh = _heads_major(k, n_k * bk, G), _heads_major(v, n_k * bk, G)
    pad = (0, n_q * bq - Sq)
    lse_p, delta_p = F.pad(lse, pad), F.pad(delta, pad)

    def block(i, j):
        rows = slice(i * bq, (i + 1) * bq)
        cols = slice(j * bk, (j + 1) * bk)
        s = _masked_scores(qh[:, :, rows], kh[:, :, cols], i, j, bq, bk, Skv,
                           causal, scale)
        p = _exp(s - lse_p[:, :, rows, None])
        do_f = doh[:, :, rows].float()
        dp = do_f @ vh[:, :, cols].float().transpose(-1, -2)
        ds = p * (dp - delta_p[:, :, rows, None]) * scale
        return rows, cols, p, do_f, ds

    return qh, kh, n_q, n_k, block


def flash_dq_plain(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                   bq: int, bk: int) -> torch.Tensor:
    """dq (B, Sq, H, hd) in q's type from the saved lse and delta =
    rowsum(do * o) (both (B, H, Sq) f32)."""
    flash_dq_plain.calls += 1
    B, Sq, H, hd = q.shape
    _, kh, n_q, n_k, block = _bwd_blocks(q, k, v, do, lse, delta, causal,
                                         scale, bq, bk)
    dq = torch.empty((B, H, n_q * bq, hd), dtype=q.dtype, device=q.device)
    for i, j, start, emit in _pairs(n_q, n_k, bq, bk, causal, "i"):
        rows, cols, _, _, ds = block(i, j)
        if start:
            acc = torch.zeros((B, H, bq, hd), device=q.device)
        acc = acc + ds.to(k.dtype).float() @ kh[:, :, cols].float()
        if emit:
            dq[:, :, rows] = acc.to(q.dtype)
    return dq[:, :, :Sq].transpose(1, 2).contiguous()


flash_dq_plain.calls = 0


def flash_dkv_plain(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                    bq: int, bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk (B, Skv, KVH, hd), dv (B, Skv, KVH, hd_v)) in q's type: the
    per-q-head dk/dv, each in q's type, summed over each kv head's
    group."""
    flash_dkv_plain.calls += 1
    B, Sq, H, hd = q.shape
    Skv, KVH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    qh, _, n_q, n_k, block = _bwd_blocks(q, k, v, do, lse, delta, causal,
                                         scale, bq, bk)
    dk = torch.empty((B, H, n_k * bk, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, H, n_k * bk, hd_v), dtype=q.dtype, device=q.device)
    for i, j, start, emit in _pairs(n_q, n_k, bq, bk, causal, "j"):
        rows, cols, p, do_f, ds = block(i, j)
        if start:
            dk_acc = torch.zeros((B, H, bk, hd), device=q.device)
            dv_acc = torch.zeros((B, H, bk, hd_v), device=q.device)
        dv_acc = dv_acc + p.transpose(-1, -2) @ do_f
        dk_acc = dk_acc + ds.to(q.dtype).float().transpose(-1, -2) @ \
            qh[:, :, rows].float()
        if emit:
            dk[:, :, cols] = dk_acc.to(q.dtype)
            dv[:, :, cols] = dv_acc.to(q.dtype)
    dk = dk.reshape(B, KVH, G, n_k * bk, hd).sum(2)
    dv = dv.reshape(B, KVH, G, n_k * bk, hd_v).sum(2)
    return (dk[:, :, :Skv].transpose(1, 2).contiguous(),
            dv[:, :, :Skv].transpose(1, 2).contiguous())


flash_dkv_plain.calls = 0


def _check(q, k, v, *extra):
    """Validate what the kernels take; returns (B, Sq, Skv, H, KVH, hd,
    hd_v)."""
    ts = (q, k, v) + extra
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash kernels need every tensor on q's CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash kernels need contiguous tensors")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, heads, d), got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KVH, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if k.shape != (B, Skv, KVH, hd) or v.shape[:3] != (B, Skv, KVH) or \
            KVH == 0 or H % KVH:
        raise ValueError(f"shape mismatch q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if max(hd, hd_v) > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels hold hd, hd_v <= "
                         f"{MAX_HEAD_DIM}, got {hd} / {hd_v}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B {B}, H {H}")
    return B, Sq, Skv, H, KVH, hd, hd_v


def _check_stats(lse, delta, B, H, Sq):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq):
            raise ValueError(f"{name} must be f32 (B, H, Sq) = "
                             f"{(B, H, Sq)}, got {t.dtype} {tuple(t.shape)}")


class FlashPlan(NamedTuple):
    """How ``csrc/flash_attn.cu`` runs one forward, dq and dk/dv call."""
    fwd_stages: int  # K/V tiles in the forward's cp.async ring
    dkv_rows: int    # kv rows of a dk/dv CTA, 64 or 128 (2 x rows threads)
    dkv_stages: int  # q / do / lse / delta tiles in dk/dv's ring
    heads: int       # query heads a dk/dv CTA walks, in g order
    parts: int       # dk/dv CTAs of one kv head's group: ceil(G / heads),
    #                  whose f32 partials a second kernel sums (G > 1)
    dq_rows: int     # query rows of a dq CTA, 64 or 128 (2 x rows threads)
    slices: int = 1  # CTAs a unit (blockIdx.y), as the source derives them
    #                  from hd and hd_v: ceil(max(hd, hd_v) / 128) = 2
    #                  past W = 128, the 2 CTAs of a cluster of each f32
    #                  kernel, each owning half of hd and of hd_v, and
    #                  bf16 dk/dv's 128-column slices of dk / dv (the bf16
    #                  forward and dq hold all of o's / dq's columns: one
    #                  CTA whatever this says)
    fwd_rows: int = 64  # query rows of a forward CTA, 16 a warp (f32: 64,
    #                     128 past W = 128; bf16: 64 or 128)
    dq_stages: int = 2  # K/V tiles in dq's ring (f32 up to W = 128:
    #                     always 2; past it and bf16: 1 or 2)


_TILE = 64                # rows of a forward CTA and of each ring tile
_MAX_SMEM = 232448        # shared memory a CTA may have on the H100
_SM_SMEM = 233472         # shared memory of an SM (228 KB; 1 KB a CTA is
#                           the runtime's)
_FWD_CTAS = {64: 3, 128: 1, 256: 1}  # forward CTAs an SM by W: its
#                                      launch bounds
_MAX_PARTS = 8            # partials a kv head's group is summed from
_SLICE = 128              # past W = 128: bf16 dk/dv's column slices, and
#                           the most columns a paired f32 CTA holds
_WQT = 32                 # query rows of a ring tile of the paired f32 dk/dv
_WKT = 32                 # kv rows of a ring tile of the paired f32 forward
#                           and dq
_PAIR_HEAD = 40           # floats before their tiles: four mbarriers and the
#                           slack that aligns the tiles to 128 bytes


def _width(hd: int, hd_v: int) -> int:
    """W: the kernels' tile width, max(hd, hd_v) rounded up to 64, 128 or
    256 (hd 192 runs the 256-wide tiles)."""
    m = max(hd, hd_v)
    return 64 if m <= 64 else 128 if m <= _SLICE else 256


def _fwd_smem(W: int, stages: int) -> int:
    """Shared bytes of a forward CTA: q, p, and K/V tiles a stage (rows
    W + 4 floats apart, p's 72) — ``fwd_smem`` of the source.  At W = 256
    a CTA of a pair: its four mbarriers and alignment slack, its half of
    128 q rows (rows 132 floats apart), their p of a 32-key tile (40), two
    buffers of its partner's halves of S (32 floats a query row each) and
    32-key K / V tiles a stage."""
    if W > _SLICE:
        return 4 * (_PAIR_HEAD + 128 * (_SLICE + 4) + 128 * (_WKT + 8) +
                    2 * _WKT * 128 + stages * 2 * _WKT * (_SLICE + 4))
    return 4 * (_TILE * (W + 4) + stages * _TILE * 2 * (W + 4) + _TILE * 72)


def _dq_smem(rows: int, W: int, stages: int = 2) -> int:
    """Shared bytes of a dq CTA of ``rows`` query rows: q, do, ds, and the
    K/V tiles of its 2-stage ring — ``dq_smem`` of the source.  At W = 256
    a CTA of a pair: its four mbarriers and alignment slack, its halves of
    ``rows`` q and do rows (rows 132 floats apart), their ds of a 32-key
    tile (40), its warps' quarters and two buffers of its partner's halves
    of S and dP (128 floats a query row each), and ``stages`` 32-key K / V
    tiles."""
    if W > _SLICE:
        return 4 * (_PAIR_HEAD + 2 * rows * (_SLICE + 4) +
                    rows * (_WKT + 8) +
                    2 * 128 * rows + stages * 2 * _WKT * (_SLICE + 4))
    return 4 * (2 * rows * (W + 4) + rows * 72 + 2 * 2 * _TILE * (W + 4))


def _dkv_smem(rows: int, W: int, stages: int) -> int:
    """Shared bytes of a dk/dv CTA of ``rows`` kv rows: K, V, p^T / ds^T,
    and q, do, lse, delta a stage — ``dkv_smem`` of the source.  At W =
    256 a CTA of a pair: its four mbarriers, its half of K and V (rows 132
    floats apart), p^T / ds^T of a 32-query tile for each of its two
    column groups (40), its warps' quarters and two buffers of its
    partner's halves (128 floats a kv row each) and 32-query q / do / lse
    / delta tiles a stage."""
    if W > _SLICE:
        return 4 * (8 + 2 * rows * (_SLICE + 4) + 2 * rows * (_WQT + 8) +
                    2 * 128 * rows +
                    stages * (2 * _WQT * (_SLICE + 4) + 2 * _WQT))
    return 4 * (2 * rows * (W + 4) + rows * 72 +
                stages * (2 * _TILE * (W + 4) + 2 * _TILE))


def _half_cols(d: int) -> int:
    """The columns of a head dim ``d`` that each CTA of a paired f32
    dk/dv owns (d of k, q, dk or of v, do, dv), a quarter to each of its
    two column groups of warps: half of d rounded up to 8, so each half
    and quarter starts on a 16-byte boundary — ``half_cols`` of the
    source.  MLA's 192 / 128 gives 96 / 64."""
    return ((d + 1) // 2 + 7) & ~7


def _tc_stride(W: int) -> int:
    """Bytes of a bf16 row of a W-wide tile in the tensor-core kernels'
    shared memory: 2 W and 16 of padding."""
    return 2 * W + 16


def _fwd_tc_smem(W: int, stages: int, rows: int = _TILE) -> int:
    """Shared bytes of a bf16 forward CTA: its ``rows`` q rows and K/V
    tiles a stage, bf16 — ``fwd_tc_smem`` of the source."""
    return _tc_stride(W) * (rows + stages * 2 * _TILE)


def _dkv_tc_smem(rows: int, W: int, stages: int) -> int:
    """Shared bytes of a bf16 dk/dv CTA of ``rows`` kv rows: K and V, and
    q, do (bf16), lse and delta (f32) a stage — ``dkv_tc_smem`` of the
    source."""
    return 2 * rows * _tc_stride(W) + \
        stages * (2 * _TILE * _tc_stride(W) + 2 * _TILE * 4)


def _dq_tc_smem(rows: int, W: int, stages: int) -> int:
    """Shared bytes of a bf16 dq CTA of ``rows`` query rows: q and do, and
    K and V tiles a stage, all bf16 — ``dq_tc_smem`` of the source."""
    return _tc_stride(W) * (2 * rows + stages * 2 * _TILE)


@functools.lru_cache(maxsize=1024)
def _flash_plan(H: int, KVH: int, hd: int, hd_v: int, *,
                dtype: torch.dtype = torch.float32,
                fwd_units: Optional[int] = None, num_sms: int = 132,
                fwd_stages: Optional[int] = None,
                fwd_rows: Optional[int] = None,
                dkv_rows: Optional[int] = None,
                dkv_stages: Optional[int] = None,
                heads: Optional[int] = None,
                dq_rows: Optional[int] = None,
                dq_stages: Optional[int] = None) -> FlashPlan:
    """The three kernels' plan for one call.

    A forward CTA holds 64 query rows (4 warps); its ring takes the most
    stages (up to 2) that keep the most CTAs an SM its registers allow:
    at W = 64 one stage and three CTAs (two stages would leave two), at W
    = 128 two.  A dq CTA holds 128 query rows and a dk/dv CTA 128 kv rows
    (8 warps) where that fits two ring stages, else 64 (W = 128).  Past W
    = 128 each kernel runs a cluster of ``slices`` = 2 CTAs of 8 warps a
    (128 query rows, head, batch) (forward: ``fwd_rows`` = 128), (64 query
    rows, head, batch) (dq) or (64 kv rows, head group, batch) (dk/dv),
    each owning half of the head dim (:func:`_half_cols`) and streaming
    32-row K / V (dk/dv: q / do) tiles through a ring of 2 stages, one CTA
    an SM.  dq's ring always has 2 stages up to W = 128 (at W = 64, 128
    rows and 2 stages measured 2-3% faster than 64 rows and 1 stage, two
    CTAs an SM; PERF.md §6); dk/dv's takes 2 where they fit, else 1.  A
    dk/dv CTA walks ceil(G / 8) query heads, so a kv head's group is
    summed from at most 8 partials.  ``fwd_stages``, ``dq_rows``,
    ``dkv_rows``, ``dkv_stages`` (rows 64 or 128, stages 1 or 2),
    ``dq_stages`` (past W = 128) and ``heads`` override the rules
    (``launch/bench_flash.py`` times the choices).

    bf16 (``dtype``) runs all three kernels on the tensor cores, whose
    tiles stay bf16 (``_fwd_tc_smem``, ``_dkv_tc_smem``, ``_dq_tc_smem``),
    under rules of their own (``launch/bench_flash.py --dtype bf16
    --variant`` timed them; PERF.md §6): a forward or dq CTA holds 128
    query rows (8 warps), unless the call's ``fwd_units`` (its (query
    row, head, batch) count, B H Sq) give fewer 128-row CTAs than
    ``num_sms``: then 64 rows, twice the CTAs (seamless's encoder, 16
    heads of 128 rows: 32 CTAs).  The forward's ring has 2 stages, dq's 2
    where they fit, else 1 (128 rows at W = 256).  A dk/dv CTA holds 64
    kv rows with 2 stages up to W = 128 and 128 rows with 1 stage at 256.
    ``fwd_rows`` (64 or 128) overrides the forward's rows.  Raises where
    the kernels do not take the plan."""
    if max(hd, hd_v) > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels hold hd, hd_v <= "
                         f"{MAX_HEAD_DIM}, got {hd} / {hd_v}")
    if dtype not in _DTYPES:
        raise ValueError(f"no flash kernels for {dtype}")
    W, G = _width(hd, hd_v), H // KVH
    tc = dtype == torch.bfloat16
    if tc:
        few = fwd_units is not None and fwd_units < num_sms * 128
        fwd_rows = fwd_rows or (64 if few else 128)
        if fwd_rows not in (64, 128):
            raise ValueError(f"a bf16 forward CTA holds 64 or 128 query "
                             f"rows, not {fwd_rows}")
        dkv_rows = dkv_rows or (64 if W <= _SLICE else 128)
        dq_rows = dq_rows or (64 if few else 128)
    else:
        rows = 128 if W > _SLICE else 64
        if (fwd_rows or rows) != rows:
            raise ValueError(f"an f32 forward CTA holds {rows} query rows at "
                             f"width {W}")
        if W <= _SLICE and dq_stages not in (None, 2):
            raise ValueError("an f32 dq ring has 2 stages up to width 128")
        fwd_rows = rows
        dkv_rows = dkv_rows or (128 if _dkv_smem(128, W, 2) <= _MAX_SMEM
                                else 64)
        dq_rows = dq_rows or (128 if _dq_smem(128, W) <= _MAX_SMEM
                              else 64)
    if dkv_rows not in (64, 128):
        raise ValueError(f"a dk/dv CTA holds 64 or 128 kv rows, not "
                         f"{dkv_rows}")
    if dq_rows not in (64, 128):
        raise ValueError(f"a dq CTA holds 64 or 128 query rows, not "
                         f"{dq_rows}")
    if not tc and _dq_smem(dq_rows, W) > _MAX_SMEM:
        raise ValueError(f"a dq CTA of {dq_rows} query rows does not fit "
                         f"at width {W}")

    def ring(smem, stages) -> int:
        if stages is None:
            stages = 2 if smem(2) <= _MAX_SMEM else 1
        if stages not in (1, 2) or smem(stages) > _MAX_SMEM:
            raise ValueError(f"{stages} ring stages do not fit at width {W}")
        return stages

    if tc:
        fwd_smem = functools.partial(_fwd_tc_smem, W, rows=fwd_rows)
        dkv_smem = functools.partial(_dkv_tc_smem, dkv_rows, W)
        dq_stages = ring(functools.partial(_dq_tc_smem, dq_rows, W),
                         dq_stages)
    else:
        fwd_smem = functools.partial(_fwd_smem, W)
        dkv_smem = functools.partial(_dkv_smem, dkv_rows, W)
        if W > _SLICE:
            dq_stages = ring(functools.partial(_dq_smem, dq_rows, W),
                             dq_stages)
        if fwd_stages is None:   # the most CTAs an SM, then the most stages
            fwd_stages = max((1, 2), key=lambda n: (min(
                _FWD_CTAS[W], _SM_SMEM // (_fwd_smem(W, n) + 1024)), n))

    heads = heads or -(-G // _MAX_PARTS)
    if not 1 <= heads <= G:
        raise ValueError(f"a dk/dv CTA walks 1 to G = {G} heads, not {heads}")
    slices = -(-max(hd, hd_v) // _SLICE) if W > _SLICE else 1
    return FlashPlan(ring(fwd_smem, fwd_stages), dkv_rows,
                     ring(dkv_smem, dkv_stages), heads, -(-G // heads),
                     dq_rows, slices, fwd_rows, dq_stages or 2)


def _fwd_ctas(B: int, Sq: int, H: int,
              rows: int = _TILE) -> List[Tuple[int, int, int]]:
    """(query tile, head, batch) of each forward CTA (64 query rows; in
    bf16 the plan's ``fwd_rows``) or dq CTA (the plan's ``dq_rows``),
    ``rows`` a tile, in launch order, as both kernels decode
    ``blockIdx.x``: the last (causally heaviest) tile of every head first,
    a kv group's heads side by side.  Past W = 128 each f32 unit is a
    cluster of the plan's ``slices`` = 2 CTAs (``blockIdx.y``), each
    owning half of the head dim (not the bf16 forward's or dq's, whose
    CTAs own all of o's / dq's columns)."""
    nqt, HB = -(-Sq // rows), H * B
    return [(nqt - 1 - lin // HB, lin % H, (lin // H) % B)
            for lin in range(nqt * HB)]



def _dkv_ctas(plan: FlashPlan, B: int, Skv: int, KVH: int,
              G: int) -> List[Tuple[int, int, int, range]]:
    """(kv tile, kv head, batch, query heads g) of each dk/dv CTA in launch
    order, as the kernel decodes ``blockIdx.x``: kv tile 0 (the longest
    causal walk) first, the ``parts`` CTAs of a group side by side."""
    cs, per = plan.parts, B * KVH * plan.parts
    out = []
    for lin in range(-(-Skv // plan.dkv_rows) * per):
        rank = lin % cs
        out.append((lin // per, (lin // cs) % KVH, (lin // (cs * KVH)) % B,
                    range(rank * plan.heads, min(G, (rank + 1) * plan.heads))))
    return out


def _call_plan(q, k, v) -> FlashPlan:
    """The plan the three wrappers run a call under unless given one:
    :func:`_flash_plan`'s rules for q's type, the call's (query row,
    head, batch) count and the card's SMs."""
    B, Sq, H, hd = q.shape
    return _flash_plan(
        H, k.shape[2], hd, v.shape[-1], dtype=q.dtype, fwd_units=B * H * Sq,
        num_sms=torch.cuda.get_device_properties(q.device)
        .multi_processor_count)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_cuda(q, k, v, *, causal: bool, scale: float,
                   plan: Optional[FlashPlan] = None):
    """(o, lse) through the CUDA forward kernel, under :func:`_flash_plan`'s
    plan unless ``plan`` gives another (to time it)."""
    from repro_torch.kernels import _build
    B, Sq, Skv, H, KVH, hd, hd_v = _check(q, k, v)
    plan = plan or _call_plan(q, k, v)
    o = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B * Sq * H == 0:
        return o, lse
    if Skv == 0:
        raise ValueError("flash attention needs at least one key")
    err = _build.library("flash_attn").flash_fwd_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, Sq, Skv, H, KVH, hd, hd_v,
        int(causal), scale, plan.fwd_stages, plan.fwd_rows, _stream(q))
    _build.check(err, "flash attention forward")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0      # kernel launches that returned no error


def flash_dq_cuda(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  plan: Optional[FlashPlan] = None):
    """dq (B, Sq, H, hd) through the CUDA dq kernel, under
    :func:`_flash_plan`'s plan unless ``plan`` gives another."""
    from repro_torch.kernels import _build
    B, Sq, Skv, H, KVH, hd, hd_v = _check(q, k, v, do, lse, delta)
    plan = plan or _call_plan(q, k, v)
    if do.shape != (B, Sq, H, hd_v) or do.dtype != q.dtype:
        raise ValueError(f"do must be {(B, Sq, H, hd_v)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    _check_stats(lse, delta, B, H, Sq)
    dq = torch.empty_like(q)
    if B * Sq * H == 0:
        return dq
    if Skv == 0:
        return dq.zero_()
    err = _build.library("flash_attn").flash_dq_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B,
        Sq, Skv, H, KVH, hd, hd_v, int(causal), scale, plan.dq_rows,
        plan.dq_stages, _stream(q))
    _build.check(err, "flash attention dq")
    flash_dq_cuda.launches += 1
    return dq


flash_dq_cuda.launches = 0


def flash_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                   plan: Optional[FlashPlan] = None):
    """(dk (B, Skv, KVH, hd), dv (B, Skv, KVH, hd_v)) through the CUDA
    dk/dv kernel, which sums each kv head's G query heads itself, under
    :func:`_flash_plan`'s plan unless ``plan`` gives another.  Where G >
    1 a second kernel sums the group's partials from an f32 scratch: one
    call, one count."""
    from repro_torch.kernels import _build
    B, Sq, Skv, H, KVH, hd, hd_v = _check(q, k, v, do, lse, delta)
    plan = plan or _call_plan(q, k, v)
    if do.shape != (B, Sq, H, hd_v) or do.dtype != q.dtype:
        raise ValueError(f"do must be {(B, Sq, H, hd_v)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    _check_stats(lse, delta, B, H, Sq)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B * Skv * KVH == 0:
        return dk, dv
    if Sq == 0:
        return dk.zero_(), dv.zero_()
    ws = torch.empty(plan.parts * B * Skv * KVH * (hd + hd_v),
                     dtype=torch.float32, device=q.device) \
        if H > KVH else None
    err = _build.library("flash_attn").flash_dkv_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Sq, Skv, H, KVH, hd, hd_v, int(causal), scale,
        plan.dkv_rows, plan.dkv_stages, plan.heads, plan.parts,
        None if ws is None else ws.data_ptr(), _stream(q))
    _build.check(err, "flash attention dk/dv")
    flash_dkv_cuda.launches += 1
    return dk, dv


flash_dkv_cuda.launches = 0
