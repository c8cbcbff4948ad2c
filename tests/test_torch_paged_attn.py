"""Paged attention parity: the port's plain decode and prefill versions
(what CPU tensors run, and what the CUDA kernels are held against on the
card) against the reference's Pallas kernels in interpret mode and its
masked-dense oracles (``repro.kernels.ref``).

Inputs cover ragged lengths across page boundaries, a length-0 lane, dead
table columns (tail-padded with the last live id), G = 2 query heads per kv
head, and a tanh soft cap.  Tolerance: f32 throughout; 2e-5 absolute on
outputs of magnitude ~1 covers the different summation orders (online
softmax in the Pallas kernel, one masked softmax in the oracles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attn import paged_gqa_decode_lse_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attn import (NEG, _attn_plan, _decode_plan,
                                            merge_softmax_states,
                                            paged_decode_lse_plain,
                                            paged_decode_plain,
                                            paged_gather,
                                            paged_prefill_plain)

BS = 4
TOL = 2e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _tables(lengths, bs, width):
    """Disjoint contiguous pages per lane, tail-padded with the last live
    id (a lane of length 0 keeps an all-zero row)."""
    t = np.zeros((len(lengths), width), np.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nblk = -(-int(n) // bs)
        if nblk == 0:
            continue
        t[i, :nblk] = np.arange(nxt, nxt + nblk)
        t[i, nblk:] = nxt + nblk - 1
        nxt += nblk
    return t, nxt


def _arena(rng, NB, KVH, hd):
    return (rng.standard_normal((NB, BS, KVH, hd)).astype(np.float32),
            rng.standard_normal((NB, BS, KVH, hd)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_paged_gather_matches_reference():
    rng = np.random.default_rng(0)
    arena = rng.standard_normal((6, BS, 2, 3)).astype(np.float32)
    tables = np.array([[1, 4, 4], [0, 2, 5]], np.int32)
    ours = paged_gather(_t(arena), _t(tables)).numpy()
    theirs = np.asarray(jref.paged_gather(jnp.asarray(arena),
                                          jnp.asarray(tables)))
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("KVH,G", [(2, 2), (1, 4)])
def test_decode_plain_matches_pallas_and_ref(cap, KVH, G):
    rng = np.random.default_rng(int(cap) + KVH)
    lengths = np.array([6, 8, 9, 7, 0, 1], np.int32)  # ragged + empty lane
    hd = 16
    tables, used = _tables(lengths, BS, width=5)      # dead columns
    k, v = _arena(rng, used + 2, KVH, hd)
    q = rng.standard_normal((len(lengths), KVH * G, hd)).astype(np.float32)
    scale = 1.0 / hd ** 0.5
    ours = paged_decode_plain(_t(q), _t(k), _t(v), _t(tables),
                              _t(lengths), scale=scale,
                              logit_cap=cap).numpy()
    args = [jnp.asarray(x) for x in (q, k, v, tables, lengths)]
    pallas = np.asarray(jops.paged_attention(*args, logit_cap=cap,
                                             impl="pallas", interpret=True))
    oracle = np.asarray(jref.paged_attention_ref(*args, scale=scale,
                                                 logit_cap=cap))
    assert np.abs(ours - pallas).max() <= TOL
    assert np.abs(ours - oracle).max() <= TOL
    assert np.all(ours[4] == 0.0)                     # the length-0 lane
    # the wrapper runs the plain version for CPU tensors
    ops.reset_counts()
    via = ops.paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(lengths),
                              logit_cap=cap).numpy()
    assert np.array_equal(via, ours)
    assert ops.launch_counts()["paged_decode"] == 0


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("KVH,G", [(2, 2), (1, 4)])
def test_prefill_plain_matches_pallas_and_ref(cap, KVH, G):
    rng = np.random.default_rng(10 + int(cap) + KVH)
    C, hd = 5, 16
    starts = np.array([0, 3, 8, 0, 6], np.int32)
    chunks = np.array([5, 4, 2, 0, 1], np.int32)      # ragged + empty lane
    lengths = starts + chunks
    tables, used = _tables(lengths, BS, width=4)
    k, v = _arena(rng, used + 2, KVH, hd)
    q = rng.standard_normal((len(starts), C, KVH * G, hd)).astype(np.float32)
    scale = 1.0 / hd ** 0.5
    ours = paged_prefill_plain(
        _t(q), _t(k), _t(v), _t(tables), _t(starts), _t(lengths),
        scale=scale, logit_cap=cap).numpy()
    args = [jnp.asarray(x) for x in (q, k, v, tables, starts, lengths)]
    pallas = np.asarray(jops.paged_prefill_attention(
        *args, logit_cap=cap, impl="pallas", interpret=True))
    oracle = np.asarray(jref.paged_prefill_attention_ref(
        *args, scale=scale, logit_cap=cap))
    assert np.abs(ours - oracle).max() <= TOL
    # rows at or past a lane's chunk are garbage the caller discards; the
    # Pallas kernel and the oracles agree on the live rows
    for s, c in enumerate(chunks):
        assert np.abs(ours[s, :c] - pallas[s, :c]).max(initial=0.0) <= TOL
    assert np.all(ours[3] == 0.0)                     # the length-0 lane
    ops.reset_counts()
    via = ops.paged_prefill_attention(
        _t(q), _t(k), _t(v), _t(tables), _t(starts), _t(lengths),
        logit_cap=cap).numpy()
    assert np.array_equal(via, ours)
    assert ops.launch_counts()["paged_prefill"] == 0


def test_decode_is_the_one_row_prefill():
    """Decode equals prefill with C = 1 at start = length - 1 — the
    identity the CUDA kernel's shared code path rests on."""
    rng = np.random.default_rng(4)
    lengths = np.array([3, 4, 5, 0], np.int32)
    tables, used = _tables(lengths, BS, width=3)
    k, v = _arena(rng, used + 1, 2, 8)
    q = rng.standard_normal((4, 4, 8)).astype(np.float32)
    dec = paged_decode_plain(_t(q), _t(k), _t(v), _t(tables),
                             _t(lengths), scale=0.3)
    pre = paged_prefill_plain(
        _t(q[:, None]), _t(k), _t(v), _t(tables),
        _t(np.maximum(lengths - 1, 0)), _t(lengths), scale=0.3)
    assert torch.allclose(dec, pre[:, 0], atol=1e-6)


# ---------------------------------------------------------------------------
# the split-KV decode kernel's arithmetic (csrc/paged_attn.cu): each split's
# page columns attended alone, the states merged in ascending split order
# ---------------------------------------------------------------------------

def _split_decode(q, k, v, tables, lengths, plan, scale, cap):
    """The plain twin of the kernel's split-and-merge: split j attends the
    page columns [j * pages, (j + 1) * pages) through
    ``paged_decode_lse_plain`` (a lane whose length ends before them
    gets the empty state), and ``merge_softmax_states`` folds the splits in
    ascending order from the empty state.  Returns (o, m, l)."""
    S, W = tables.shape
    bs = k.shape[1]
    H, hd_v = q.shape[1], v.shape[-1]
    o = torch.zeros((S, H, hd_v))
    m = torch.full((S, H), NEG)
    l = torch.zeros((S, H))
    for j in range(plan.splits):
        c0, c1 = j * plan.pages, min((j + 1) * plan.pages, W)
        if c1 <= c0:
            continue
        lens = torch.clamp(lengths - c0 * bs, 0, (c1 - c0) * bs)
        part = paged_decode_lse_plain(
            q, k, v, tables[:, c0:c1].contiguous(), lens, scale=scale,
            logit_cap=cap)
        o, m, l = merge_softmax_states(o, m, l, *part)
    return o.to(q.dtype), m, l


# lengths 0, 1, 16, 17, one shorter than the first split (3), two past
# several splits; with bs = 4 and W = 100 every split of lanes 0-4 is empty
SPLIT_LENGTHS = np.array([0, 1, 16, 17, 3, 250, 399, 128], np.int32)


@pytest.mark.parametrize("splits", [None, 1, 3, 7],
                         ids=["plan", "1", "3", "7"])
@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("KVH,G", [(2, 2), (1, 4)])
def test_split_decode_twin_matches_plain_and_pallas(splits, cap, KVH, G):
    """The twin equals the one-softmax plain versions and the reference's
    Pallas kernels (interpret) within this file's 2e-5 on o and 1e-5 on m
    (l: 1e-5 of its size, a sum of up to 400 terms), for the rule's plan
    (4 splits of 32 pages here) and forced split counts; the empty lane is
    exactly (0, -1e30, 0)."""
    rng = np.random.default_rng(40 + int(cap) + KVH + (splits or 0))
    hd, W = 16, 100
    tables, used = _tables(SPLIT_LENGTHS, BS, width=W)
    k, v = _arena(rng, used + 2, KVH, hd)
    S = len(SPLIT_LENGTHS)
    q = rng.standard_normal((S, KVH * G, hd)).astype(np.float32)
    scale = 1.0 / hd ** 0.5
    plan = _decode_plan(S, KVH, G, W, BS, hd, hd, 4, 132, splits=splits)
    if splits is None:
        assert plan.splits == 4 and plan.pages == 32
    tq, tk, tv, tt, tl = (_t(x) for x in (q, k, v, tables, SPLIT_LENGTHS))
    o, m, l = _split_decode(tq, tk, tv, tt, tl, plan, scale, cap)
    plain = paged_decode_plain(tq, tk, tv, tt, tl, scale=scale,
                               logit_cap=cap)
    lo, lm, ll = paged_decode_lse_plain(tq, tk, tv, tt, tl, scale=scale,
                                        logit_cap=cap)
    assert (o - plain).abs().max().item() <= TOL
    assert (o - lo).abs().max().item() <= TOL
    assert (m - lm).abs().max().item() <= 1e-5
    assert ((l - ll).abs() / ll.clamp(min=1.0)).max().item() <= 1e-5
    args = [jnp.asarray(x) for x in (q, k, v, tables, SPLIT_LENGTHS)]
    pallas = np.asarray(jops.paged_attention(*args, logit_cap=cap,
                                             impl="pallas", interpret=True))
    assert np.abs(o.numpy() - pallas).max() <= TOL
    po, pm, pl = paged_gqa_decode_lse_pallas(
        args[0].reshape(S, KVH, G, hd), *args[1:], scale, True,
        logit_cap=cap)
    assert np.abs(o.numpy() - np.asarray(po).reshape(S, -1, hd)).max() \
        <= TOL
    assert np.abs(m.numpy() - np.asarray(pm).reshape(S, -1)).max() <= 1e-5
    pl = np.asarray(pl).reshape(S, -1)
    assert (np.abs(l.numpy() - pl) / np.maximum(pl, 1.0)).max() <= 1e-5
    assert torch.all(o[0] == 0) and torch.all(m[0] == NEG) and \
        torch.all(l[0] == 0)


def _split_columns(plan, W):
    return [range(j * plan.pages, min((j + 1) * plan.pages, W))
            for j in range(plan.splits)]


DECODE_GRID = [(S, KVH, G, W, bs)
               for S in (1, 2, 8, 16, 64, 256)
               for KVH in (1, 2, 8)
               for G in (1, 3, 4, 8, 12)
               for W in (0, 1, 3, 16, 35, 64, 512)
               for bs in (4, 16, 64)]


@pytest.mark.parametrize("chunk", range(4))
def test_decode_plan_covers_every_column_once(chunk):
    """On a grid: every page column lies in exactly one split, every split
    but an all-dead tail holds at least one column, a split plan keeps
    within half the card's CTAs before splitting and takes at least 128
    rows a split, and a grid that fills over half the card is not split.
    The plan is a pure function of its inputs."""
    for S, KVH, G, W, bs in DECODE_GRID[chunk::4]:
        for hd, esize in ((64, 2), (256, 4)):
            plan = _decode_plan(S, KVH, G, W, bs, hd, hd, esize, 132)
            assert plan == _decode_plan(S, KVH, G, W, bs, hd, hd, esize, 132)
            cols = [c for r in _split_columns(plan, W) for c in r]
            assert cols == list(range(W)), (S, KVH, G, W, bs)
            assert all(len(r) > 0 for r in _split_columns(plan, W)) or W == 0
            assert plan.rows in (1, 2, 4, 8) and plan.rows >= min(G, 8)
            assert plan.rows * plan.rblocks >= G
            assert plan.units == S * KVH * plan.rblocks
            assert 1 <= plan.warps <= 4
            if 2 * plan.units > 132:
                assert plan.splits == 1
            if plan.splits > 1:
                assert plan.pages * bs >= 128
                assert plan.ws_elems == plan.ctas * plan.part


def test_decode_plan_shapes_of_the_paths():
    """Phase 3's and phase 4's decode (8 lanes, 8 kv heads, G = 4, hd 64,
    pages of 16, bf16) splits 5 ways, the long context (one lane of 8192
    rows) 32 ways, 16+ lanes not at all; gemma-2b's G = 8, hd 256 fits
    (3 warps in bf16, 1 in f32); hd_v past 256 raises."""
    p = _decode_plan(8, 8, 4, 64, 16, 64, 64, 2, 132)
    assert (p.rows, p.warps, p.splits, p.pages) == (4, 4, 5, 13)
    p = _decode_plan(1, 8, 4, 512, 16, 64, 64, 2, 132)
    assert (p.splits, p.pages, p.ctas) == (32, 16, 256)
    assert _decode_plan(16, 8, 4, 64, 16, 64, 64, 2, 132).splits == 1
    assert _decode_plan(8, 1, 8, 64, 16, 256, 256, 2, 132).warps == 3
    assert _decode_plan(8, 1, 8, 64, 16, 256, 256, 4, 132).warps == 1
    with pytest.raises(ValueError, match="hd_v <= 256"):
        _decode_plan(8, 8, 4, 64, 16, 64, 512, 2, 132)


# ---------------------------------------------------------------------------
# the prefill / shared-prefix kernel's plan (csrc/paged_attn.cu)
# ---------------------------------------------------------------------------

ATTN_GRID = [(lanes, rows, KVH, W, bs)
             for lanes in (1, 2, 8, 64)
             for rows in (1, 8, 32, 33, 64, 256, 512)
             for KVH in (1, 2, 8)
             for W in (0, 1, 3, 16, 35, 64, 512)
             for bs in (4, 16, 64)]


@pytest.mark.parametrize("prefill", [False, True], ids=["prefix", "prefill"])
@pytest.mark.parametrize("chunk", range(2))
def test_attn_plan_covers_every_column_once(prefill, chunk):
    """On a grid, both rules: every page column lies in exactly one split
    and every split holds one; the units are the 64-row tiles of every
    (lane, kv head); the prefix phase
    splits only while its units fill at most half the card, each split at
    least one 64-row tile; prefill keeps its grid within 4 CTAs an SM and
    each split at least 128 rows; the plan is a pure function."""
    for lanes, rows, KVH, W, bs in ATTN_GRID[chunk::2]:
        for hd, esize in ((64, 2), (128, 2), (256, 4)):
            plan = _attn_plan(lanes, rows, KVH, W, bs, hd, hd, esize, 132,
                              prefill=prefill)
            assert plan == _attn_plan(lanes, rows, KVH, W, bs, hd, hd, esize,
                                      132, prefill=prefill)
            cols = [c for r in _split_columns(plan, W) for c in r]
            assert cols == list(range(W)), (lanes, rows, KVH, W, bs)
            assert all(len(r) > 0 for r in _split_columns(plan, W)) or W == 0
            assert plan.rtiles == -(-rows // 64) and plan.width == hd
            assert plan.units == lanes * KVH * plan.rtiles
            assert plan.part == 64 * (hd + 2)
            if plan.splits > 1:
                assert plan.ws_elems == plan.ctas * plan.part
                if prefill:
                    assert plan.ctas <= 4 * 132
                    assert plan.pages * bs >= 128 or \
                        plan.pages * bs * plan.splits >= W * bs
                else:
                    assert 2 * plan.units <= 132
                    assert plan.pages * bs >= 64
            else:
                assert plan.ws_elems == 0


def test_attn_plan_shapes_of_the_paths():
    """Phase 3's prefill (8 lanes, 64-row chunks, G = 4, 8 kv heads, hd 64,
    32 page columns of 16, bf16) runs 2 splits of 256 units; one lane's
    late chunk (28 columns) 4 splits; phase 5's prefix phase (8 lanes x G
    = 4 = 32 rows, 32 columns) 8 splits of 8 units; the width is
    the larger of hd and hd_v rounded up to 64, 128 or 256; hd or hd_v
    past 256 raises."""
    p = _attn_plan(8, 256, 8, 32, 16, 64, 64, 2, 132, prefill=True)
    assert (p.rtiles, p.units, p.splits, p.pages) == (4, 256, 2, 16)
    p = _attn_plan(1, 256, 8, 28, 16, 64, 64, 2, 132, prefill=True)
    assert (p.splits, p.pages, p.ctas) == (4, 7, 128)
    p = _attn_plan(1, 32, 8, 32, 16, 64, 64, 2, 132)
    assert (p.units, p.splits, p.pages, p.ctas) == (8, 8, 4, 64)
    for hd, esize, width in ((64, 2, 64), (128, 2, 128), (256, 2, 256),
                             (64, 4, 64), (200, 4, 256), (16, 2, 64)):
        p = _attn_plan(8, 256, 8, 32, 16, hd, hd, esize, 132, prefill=True)
        assert (p.width, p.part) == (width, 64 * (width + 2))
    assert _attn_plan(1, 32, 8, 32, 16, 64, 256, 2, 132).width == 256
    for hd, hd_v in ((64, 512), (512, 64)):
        with pytest.raises(ValueError, match="hd, hd_v <= 256"):
            _attn_plan(1, 32, 8, 32, 16, hd, hd_v, 2, 132)


@pytest.mark.parametrize("hd", [128, 256])
def test_prefill_plain_matches_pallas_at_wide_heads(hd):
    """The plain prefill against the reference's Pallas kernel (interpret)
    and oracle at the widths the CUDA kernel now takes (hd 128: qwen2-moe,
    deepseek-coder, command-r-plus; hd 256: gemma-2b, G = 8), with ragged
    starts, an empty lane and the soft cap."""
    rng = np.random.default_rng(hd)
    KVH, G, C = 1, 8 if hd == 256 else 4, 4
    starts = np.array([0, 3, 9, 0], np.int32)
    chunks = np.array([4, 3, 1, 0], np.int32)
    lengths = starts + chunks
    tables, used = _tables(lengths, BS, width=4)
    k, v = _arena(rng, used + 2, KVH, hd)
    q = rng.standard_normal((4, C, KVH * G, hd)).astype(np.float32)
    scale = 1.0 / hd ** 0.5
    for cap in (0.0, 5.0):
        ours = paged_prefill_plain(
            _t(q), _t(k), _t(v), _t(tables), _t(starts), _t(lengths),
            scale=scale, logit_cap=cap).numpy()
        args = [jnp.asarray(x) for x in (q, k, v, tables, starts, lengths)]
        pallas = np.asarray(jops.paged_prefill_attention(
            *args, logit_cap=cap, impl="pallas", interpret=True))
        oracle = np.asarray(jref.paged_prefill_attention_ref(
            *args, scale=scale, logit_cap=cap))
        assert np.abs(ours - oracle).max() <= TOL
        for s, c in enumerate(chunks):
            assert np.abs(ours[s, :c] - pallas[s, :c]).max(initial=0.0) \
                <= TOL
        assert np.all(ours[3] == 0.0)
