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
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attn import (paged_attention_plain,
                                            paged_gather,
                                            paged_prefill_attention_plain)

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
    ours = paged_attention_plain(_t(q), _t(k), _t(v), _t(tables),
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
    ours = paged_prefill_attention_plain(
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
    dec = paged_attention_plain(_t(q), _t(k), _t(v), _t(tables),
                                _t(lengths), scale=0.3)
    pre = paged_prefill_attention_plain(
        _t(q[:, None]), _t(k), _t(v), _t(tables),
        _t(np.maximum(lengths - 1, 0)), _t(lengths), scale=0.3)
    assert torch.allclose(dec, pre[:, 0], atol=1e-6)
