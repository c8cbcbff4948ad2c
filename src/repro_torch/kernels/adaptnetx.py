"""ADAPTNETX — fused ADAPTNET queries: the (M, K, N) ids pick one row of
each embedding table, and ``relu(x @ w1 + b1) @ w2 + b2`` gives the
tile-class logits (the raw encoding of ``core/adaptnet.py``).  The argmax
is left to the caller, so tests can check the whole distribution.

``adaptnetx_cuda`` launches ``csrc/adaptnetx.cu`` (replacing
``repro/kernels/adaptnetx.py::adaptnetx_pallas``) under
``_adaptnetx_plan``'s plan, or a plan the caller forces, and counts the
calls whose launch returned no error in ``.launches`` (an empty batch
launches nothing and counts nothing).  ``adaptnetx_plain`` is the plain
PyTorch version, used for CPU tensors and as what the kernel is held
against on the card.

Both take ids (B, 3) int32 (a query per row) and f32 tables: emb_m, emb_k,
emb_n (rows, E), w1 (3E, H), b1 (H,), w2 (H, C), b2 (C,), and return (B, C)
f32 logits.  Each id is clamped to [0, rows - 1] of its table, as JAX's
gather and the reference's ``np.clip`` do.

The kernel sums in one fixed order whatever the plan: hidden unit j is a
sequential fma over the 3E inputs, then + b1[j], then relu; the hidden
units fall in chunks of 32, chunk g's partial for class c is a sequential
fma over its units, and the logits are b2[c] plus the partials added in
ascending g.  So every plan gives the same bits, and a query alone the
bits of the same query in any batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

MAX_E = 64                     # the kernel holds 3E <= 192 inputs
MAX_H = 1024                   # and H <= 1024 hidden units
UNITS = 32                     # hidden units a chunk
MAX_CLUSTER = 8                # portable thread-block cluster size
SMEM_MAX = 232_448             # shared memory a CTA may use (227 KB)
CT_MAX = 256                   # classes a tile where C is larger
QT = 4                         # queries a tile (``launch/bench_adaptnetx``)
QT_MAX = 64                    # the kernel's largest: a thread loads each id
# a raw-encoding net's leaves, in the kernel's operand order
OPERANDS = ("emb_m", "emb_k", "emb_n", "w1", "b1", "w2", "b2")
# the forced plans ``launch/bench_adaptnetx.py``, ``chip_smoke.py`` and the
# card tests run beside the plan (a shape skips those it cannot take): a
# CTA holding 1 to 32 chunks is, over 4 chunks (H = 128), a cluster of 4,
# a cluster of 2 and one CTA; over 32 (H = 1024), clusters of 8, 4, 2 and
# one CTA
VARIANTS = (
    ("1 chunk a CTA", {"chunks": 1}),
    ("2 chunks a CTA", {"chunks": 2}),
    ("4 chunks a CTA", {"chunks": 4}),
    ("8 chunks a CTA", {"chunks": 8}),
    ("16 chunks a CTA", {"chunks": 16}),
    ("32 chunks a CTA", {"chunks": 32}),
    ("qt 1", {"qt": 1}),
    ("qt 2", {"qt": 2}),
    ("qt 4", {"qt": 4}),
    ("qt 8", {"qt": 8}),
    ("qt 16", {"qt": 16}),
    ("qt 64", {"qt": 64}),
    ("ct 64", {"ct": 64}),
    ("1 stage", {"stages": 1}),
)


class AdaptnetxPlan(NamedTuple):
    qt: int          # queries a tile
    tiles: int       # query tiles
    ct: int          # classes a tile
    ctiles: int      # class tiles
    groups: int      # CTAs over the hidden units of a (query, class) tile
    chunks: int      # 32-unit hidden chunks a CTA
    stages: int      # chunk buffers of the ring (== chunks: all at entry)
    ctas: int
    smem: int        # dynamic shared memory a CTA, bytes

    @property
    def combine(self) -> str:
        """How the partials meet: "none" (one CTA holds every chunk) or
        "cluster" (a thread-block cluster of the ``groups`` CTAs)."""
        return "none" if self.groups == 1 else "cluster"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r4(a: int) -> int:
    return _cdiv(a, 4) * 4


def _adaptnetx_smem(E: int, H: int, qt: int, ct: int, stages: int) -> int:
    """Bytes of a CTA's shared memory: ``csrc/adaptnetx.cu``'s Layout (the
    mbarriers, the stage buffers, x, a wave's h, b2's tile, every chunk's
    partials of the tile)."""
    in_dim, qtp = 3 * E, _r4(qt)
    stage = in_dim * UNITS + UNITS * ct + UNITS
    return 4 * (_r4(2 * stages + 2) + stages * stage + in_dim * qtp
                + stages * UNITS * qtp + _r4(ct)
                + _r4(_cdiv(H, UNITS) * qt * ct))


def _adaptnetx_plan(B: int, E: int, H: int, C: int, *,
                    qt: Optional[int] = None, ct: Optional[int] = None,
                    chunks: Optional[int] = None,
                    stages: Optional[int] = None) -> AdaptnetxPlan:
    """The kernel's plan for B queries of a net of widths (E, H, C).

    The rule (``launch/bench_adaptnetx.py``): up to QT queries a tile
    and every class in one tile up to CT_MAX; the hidden chunks spread
    over a cluster of up to MAX_CLUSTER CTAs, each holding every chunk of
    its share at once; the ring shrinks (then the query tile halves)
    until a CTA fits its shared memory.  Each keyword forces that choice;
    a forced plan the shape cannot take raises ValueError, as does a
    shape the kernel does not hold."""
    if not (B >= 1 and 1 <= E <= MAX_E and 1 <= H <= MAX_H and C >= 1):
        raise ValueError(f"the ADAPTNETX kernel holds B >= 1, E <= {MAX_E},"
                         f" H <= {MAX_H}, C >= 1; got B={B} E={E} H={H} "
                         f"C={C}")
    nchunk = _cdiv(H, UNITS)
    if ct is None:
        ct = C if C <= CT_MAX else CT_MAX
    elif not (1 <= ct <= C and (ct == C or ct % 4 == 0)):
        raise ValueError(f"a class tile is C or a multiple of 4 below it, "
                         f"not {ct} (C={C})")
    if chunks is None:
        chunks = _cdiv(nchunk, min(nchunk, MAX_CLUSTER))
    elif not _cdiv(nchunk, MAX_CLUSTER) <= chunks <= nchunk:
        raise ValueError(f"a cluster of up to {MAX_CLUSTER} CTAs over "
                         f"{nchunk} chunks holds {_cdiv(nchunk, MAX_CLUSTER)}"
                         f" to {nchunk} a CTA, not {chunks}")
    groups = _cdiv(nchunk, chunks)
    if qt is not None and not 1 <= qt <= min(B, QT_MAX):
        raise ValueError(f"a query tile holds 1 to {min(B, QT_MAX)} "
                         f"queries, not {qt}")
    if stages is not None and not 1 <= stages <= chunks:
        raise ValueError(f"the ring holds 1 to {chunks} stages, not {stages}")
    q, s = qt or min(B, QT), stages or chunks
    while _adaptnetx_smem(E, H, q, ct, s) > SMEM_MAX:
        if stages is None and s > 1:
            s -= 1
        elif qt is None and q > 1:
            q, s = _cdiv(q, 2), stages or chunks
        else:
            raise ValueError(
                f"a CTA of {q} queries, {ct} classes, {chunks} chunks and "
                f"{s} stages needs {_adaptnetx_smem(E, H, q, ct, s)} bytes "
                f"of shared memory, more than {SMEM_MAX}")
    tiles, ctiles = _cdiv(B, q), _cdiv(C, ct)
    return AdaptnetxPlan(q, tiles, ct, ctiles, groups, chunks, s,
                         groups * tiles * ctiles,
                         _adaptnetx_smem(E, H, q, ct, s))


def _check_plan(plan: AdaptnetxPlan, B: int, E: int, H: int, C: int
                ) -> None:
    """Raise unless ``plan`` is the plan its own choices give at these
    widths (so its tiles and shared memory are theirs), before any
    launch."""
    try:
        same = plan == _adaptnetx_plan(B, E, H, C, qt=plan.qt, ct=plan.ct,
                                       chunks=plan.chunks,
                                       stages=plan.stages)
    except ValueError:
        same = False
    if not same:
        raise ValueError(f"plan {plan} is not one for (B, E, H, C) = "
                         f"{(B, E, H, C)}")


def launch_args(ids, tables, out, plan: AdaptnetxPlan, stream) -> tuple:
    """``adaptnetx_launch``'s arguments for ``plan``."""
    emb_m, emb_k, emb_n, w1, b1, w2, b2 = tables
    E, (H, C) = emb_m.shape[1], w2.shape
    return (ids.data_ptr(), emb_m.data_ptr(), emb_k.data_ptr(),
            emb_n.data_ptr(), emb_m.shape[0], emb_k.shape[0],
            emb_n.shape[0], E, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), H, C, out.data_ptr(), ids.shape[0], plan.qt,
            plan.ct, plan.groups, plan.chunks, plan.stages, stream)


def adaptnetx_plain(ids, emb_m, emb_k, emb_n, w1, b1, w2, b2
                    ) -> torch.Tensor:
    """(B, C) f32 logits of the B queries in ``ids`` (B, 3)."""
    adaptnetx_plain.calls += 1
    x = torch.cat([t[ids[:, i].long().clamp(0, t.shape[0] - 1)]
                   for i, t in enumerate((emb_m, emb_k, emb_n))], dim=-1)
    h = torch.relu(x.float() @ w1.float() + b1.float())
    return h @ w2.float() + b2.float()


adaptnetx_plain.calls = 0


def adaptnetx_cuda(ids, emb_m, emb_k, emb_n, w1, b1, w2, b2, *,
                   plan: Optional[AdaptnetxPlan] = None) -> torch.Tensor:
    """(B, C) f32 logits through the CUDA kernel, under
    ``_adaptnetx_plan``'s plan unless ``plan`` gives another.  Every
    operand must be a contiguous CUDA tensor on one card, ids int32, the
    rest f32."""
    from repro_torch.kernels import _build
    tables = (emb_m, emb_k, emb_n, w1, b1, w2, b2)
    if ids.dim() != 2 or ids.shape[1] != 3:
        raise ValueError(f"ids must be (B, 3), got {tuple(ids.shape)}")
    if ids.dtype != torch.int32 or any(t.dtype != torch.float32
                                       for t in tables):
        raise ValueError("ADAPTNETX takes int32 ids and f32 tables")
    dev = ids.device
    if not ids.is_cuda or any(t.device != dev for t in tables):
        raise ValueError("ADAPTNETX needs every operand on one CUDA card")
    if not all(t.is_contiguous() for t in (ids,) + tables):
        raise ValueError("ADAPTNETX needs contiguous operands")
    E = emb_m.shape[1]
    H, C = w2.shape
    if emb_k.shape[1] != E or emb_n.shape[1] != E or \
            w1.shape != (3 * E, H) or b1.shape != (H,) or b2.shape != (C,):
        raise ValueError(
            f"shape mismatch: emb {tuple(emb_m.shape)} / "
            f"{tuple(emb_k.shape)} / {tuple(emb_n.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)},"
            f" b2 {tuple(b2.shape)}")
    if not (1 <= E <= MAX_E and 1 <= H <= MAX_H and C >= 1) or \
            min(emb_m.shape[0], emb_k.shape[0], emb_n.shape[0]) < 1:
        raise ValueError(f"the ADAPTNETX kernel holds E <= {MAX_E}, H <= "
                         f"{MAX_H}, C >= 1 and non-empty tables; got E={E} "
                         f"H={H} C={C}")
    B = ids.shape[0]
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    if plan is None:
        plan = _adaptnetx_plan(B, E, H, C)
    else:
        _check_plan(plan, B, E, H, C)
    err = _build.library("adaptnetx").adaptnetx_launch(*launch_args(
        ids, tables, out, plan, torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "ADAPTNETX")
    adaptnetx_cuda.launches += 1
    return out


adaptnetx_cuda.launches = 0          # calls whose launch returned no error
