"""Absorbed-MLA parity: the port's plain paged MLA decode and prefill (what
CPU tensors run, and what the CUDA kernels are held against on the card)
against the reference's Pallas kernels in interpret mode and its
masked-dense oracles; the port's ``mla_paged_decode`` / ``mla_paged_prefill``
layer functions (outputs and both latent arenas) against the reference's;
and one chunk-prefill step then one decode step of the reduced
``deepseek-v3-671b`` model (leading dense layer, then a MoE layer) against
the reference model from the same weights.

Inputs cover ragged lengths across page boundaries, a length-0 lane, dead
table columns (tail-padded with the last live id), ragged prefill starts
with an empty lane, and the reduced scale ``1/sqrt(qk_dim)`` with
``qk_dim = 24`` (nope 16 + rope 8), which is neither ``1/sqrt(r)`` nor
``1/sqrt(r + rd)``.  Tolerances, f32 throughout: 2e-5 absolute on kernel
outputs of magnitude ~1 (online softmax in the Pallas kernel, one masked
softmax in the oracles: summation order only); 1e-4 on logits and 1e-5 on
arena rows of the model steps (two layers of f32 GEMMs summed in
different orders).  The trash block (the arena's last page) is excluded:
colliding masked writes land there in an unspecified order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attn import (paged_mla_decode_pallas,
                                      paged_mla_prefill_pallas)
from repro.models import attention as jattn
from repro.models.api import build_model as jbuild
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attn import (NEG, _attention_lse,
                                            merge_softmax_states,
                                            paged_gather)
from repro_torch.kernels.paged_mla import (_MERGE_CAP, _mla_plan,
                                           paged_mla_decode_plain,
                                           paged_mla_prefill_plain)
from repro_torch.models import attention as tattn
from repro_torch.models.api import build_model as tbuild

BS = 4
TOL = 2e-5
ARCH = "deepseek-v3-671b"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


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


def _latent(rng, NB, r, rd):
    return (rng.standard_normal((NB, BS, r)).astype(np.float32),
            rng.standard_normal((NB, BS, rd)).astype(np.float32))


@pytest.mark.parametrize("H,r,rd,qk_dim", [(4, 16, 8, 24), (2, 32, 16, 48)])
def test_decode_plain_matches_pallas_and_ref(H, r, rd, qk_dim):
    rng = np.random.default_rng(H + r)
    lengths = np.array([6, 8, 9, 7, 0, 1], np.int32)  # ragged + empty lane
    tables, used = _tables(lengths, BS, width=5)      # dead columns
    ckv, krope = _latent(rng, used + 2, r, rd)
    S = len(lengths)
    qa = rng.standard_normal((S, H, r)).astype(np.float32)
    qr = rng.standard_normal((S, H, rd)).astype(np.float32)
    scale = 1.0 / qk_dim ** 0.5
    ours = paged_mla_decode_plain(_t(qa), _t(qr), _t(ckv), _t(krope),
                                  _t(tables), _t(lengths),
                                  scale=scale).numpy()
    args = [jnp.asarray(a) for a in (qa, qr, ckv, krope, tables, lengths)]
    pallas = np.asarray(paged_mla_decode_pallas(*args, scale, True))
    oracle = np.asarray(jref.paged_mla_attention_ref(*args, scale=scale))
    assert ours.shape == (S, H, r)
    assert np.abs(ours - pallas).max() < TOL
    assert np.abs(ours - oracle).max() < TOL
    assert (ours[4] == 0).all()                       # empty lane: zeros
    # the public wrapper takes the plain version for CPU tensors, with the
    # scale 1/sqrt(qk_dim), as the reference's wrapper
    wrapped = ops.mla_paged_attention(_t(qa), _t(qr), _t(ckv), _t(krope),
                                      _t(tables), _t(lengths),
                                      qk_dim=qk_dim).numpy()
    theirs = np.asarray(jops.mla_paged_attention(*args, qk_dim=qk_dim,
                                                 impl="xla"))
    assert np.abs(wrapped - theirs).max() < TOL


@pytest.mark.parametrize("H,r,rd,qk_dim", [(4, 16, 8, 24), (2, 32, 16, 48)])
def test_prefill_plain_matches_pallas_and_ref(H, r, rd, qk_dim):
    rng = np.random.default_rng(10 + H + r)
    C = 5
    starts = np.array([0, 3, 6, 0, 2], np.int32)
    chunks = np.array([5, 4, 2, 0, 5], np.int32)      # lane 3 empty
    lengths = starts + chunks
    tables, used = _tables(lengths, BS, width=4)
    ckv, krope = _latent(rng, used + 2, r, rd)
    S = len(lengths)
    qa = rng.standard_normal((S, C, H, r)).astype(np.float32)
    qr = rng.standard_normal((S, C, H, rd)).astype(np.float32)
    scale = 1.0 / qk_dim ** 0.5
    ours = paged_mla_prefill_plain(
        _t(qa), _t(qr), _t(ckv), _t(krope), _t(tables), _t(starts),
        _t(lengths), scale=scale).numpy()
    args = [jnp.asarray(a) for a in (qa, qr, ckv, krope, tables, starts,
                                     lengths)]
    pallas = np.asarray(paged_mla_prefill_pallas(*args, scale, True))
    oracle = np.asarray(jref.paged_mla_prefill_attention_ref(*args,
                                                             scale=scale))
    assert ours.shape == (S, C, H, r)
    # rows past a lane's chunk are garbage the caller discards; compare
    # the live ones
    live = np.arange(C)[None, :] < chunks[:, None]
    assert np.abs(ours - pallas)[live].max() < TOL
    assert np.abs(ours - oracle)[live].max() < TOL
    assert (ours[3] == 0).all()
    wrapped = ops.mla_paged_prefill_attention(
        _t(qa), _t(qr), _t(ckv), _t(krope), _t(tables), _t(starts),
        _t(lengths), qk_dim=qk_dim).numpy()
    theirs = np.asarray(jops.mla_paged_prefill_attention(
        *args, qk_dim=qk_dim, impl="xla"))
    assert np.abs(wrapped - theirs)[live].max() < TOL


# ---------------------------------------------------------------------------
# the split-KV MLA kernel's arithmetic (csrc/paged_mla.cu): each split's page
# columns attended alone, the states merged in ascending split order
# ---------------------------------------------------------------------------

def _split_mla_decode(qa, qr, ckv, kr, tables, lengths, plan, scale):
    """The plain twin of the kernel's split-and-merge.  MLA decode is GQA
    with one kv head: key [c_kv | k_rope], value c_kv, the H heads its
    group.  Split j attends the page columns [j * pages, (j + 1) * pages)
    alone (a lane whose length ends before them gets the empty state) and
    ``merge_softmax_states`` folds the splits in ascending order from the
    empty state.  Returns (o, m, l)."""
    S, W = tables.shape
    bs = ckv.shape[1]
    H, r = qa.shape[1], qa.shape[2]
    q = torch.cat([qa, qr], -1)
    o = torch.zeros((S, H, r))
    m = torch.full((S, H), NEG)
    l = torch.zeros((S, H))
    for j in range(plan.splits):
        c0, c1 = j * plan.pages, min((j + 1) * plan.pages, W)
        if c1 <= c0:
            continue
        t = tables[:, c0:c1].contiguous()
        c = paged_gather(ckv, t).float()[:, :, None]          # (S, L, 1, r)
        k = torch.cat([c, paged_gather(kr, t).float()[:, :, None]], -1)
        lens = torch.clamp(lengths.long() - c0 * bs, 0, (c1 - c0) * bs)
        mask = torch.arange(k.shape[1])[None, :] < lens[:, None]
        part = _attention_lse(q, k, c, mask, scale, 0.0)
        o, m, l = merge_softmax_states(o, m, l, *part)
    return o, m, l


# lengths 0, 1, 4, 5 (a page boundary), one inside the first split, two
# across several; with bs = 4 and W = 100 splits of 8 pages are 32 rows
SPLIT_LENGTHS = np.array([0, 1, 4, 5, 3, 250, 399, 128], np.int32)


@pytest.mark.parametrize("splits", [None, 1, 3, 7, 100],
                         ids=["plan", "1", "3", "7", "100"])
@pytest.mark.parametrize("H,r,rd", [(4, 16, 8), (16, 32, 16)])
def test_split_mla_decode_twin_matches_plain_pallas_and_ref(splits, H, r,
                                                            rd):
    """The twin equals the one-softmax plain decode, the reference's Pallas
    kernel (interpret) and ``ref.paged_mla_attention_ref`` within this
    file's 2e-5, for the rule's plan and forced split counts (a split of
    one page each at 100); the empty lane is exactly (0, -1e30, 0)."""
    rng = np.random.default_rng(60 + H + (splits or 0))
    W = 100
    tables, used = _tables(SPLIT_LENGTHS, BS, width=W)
    ckv, krope = _latent(rng, used + 2, r, rd)
    S = len(SPLIT_LENGTHS)
    qa = rng.standard_normal((S, H, r)).astype(np.float32)
    qr = rng.standard_normal((S, H, rd)).astype(np.float32)
    scale = 1.0 / (r + rd) ** 0.5
    plan = _mla_plan(S, H, W, BS, r, rd, 4, 132, splits=splits)
    if splits is None:     # 8 units, at most 16 splits of whole 32-row tiles
        assert (plan.units, plan.splits, plan.pages) == (8, 13, 8)
    else:
        assert plan.splits == splits
    t = [_t(x) for x in (qa, qr, ckv, krope, tables, SPLIT_LENGTHS)]
    o, m, l = _split_mla_decode(*t, plan, scale)
    plain = paged_mla_decode_plain(*t, scale=scale)
    assert (o - plain).abs().max().item() <= TOL
    args = [jnp.asarray(a) for a in (qa, qr, ckv, krope, tables,
                                     SPLIT_LENGTHS)]
    pallas = np.asarray(paged_mla_decode_pallas(*args, scale, True))
    oracle = np.asarray(jref.paged_mla_attention_ref(*args, scale=scale))
    assert np.abs(o.numpy() - pallas).max() <= TOL
    assert np.abs(o.numpy() - oracle).max() <= TOL
    assert torch.all(o[0] == 0) and torch.all(m[0] == NEG) and \
        torch.all(l[0] == 0)


def _split_columns(plan, W):
    return [range(j * plan.pages, min((j + 1) * plan.pages, W))
            for j in range(plan.splits)]


MLA_GRID = [(S, rows, W, bs)
            for S in (1, 2, 8, 16, 64)
            for rows in (1, 4, 16, 128, 64 * 16, 64 * 128)
            for W in (0, 1, 3, 16, 35, 64, 256)
            for bs in (4, 16, 64)]


@pytest.mark.parametrize("chunk", range(3))
def test_mla_plan_covers_every_column_once(chunk):
    """On a grid (decode: rows = H; prefill: C * H): every page column lies
    in exactly one split and every split holds at least one; the row
    blocks cover the lane's rows; units and the workspace are exact; a
    split plan keeps to one CTA an SM and whole latent tiles (64 rows in
    bf16, 32 in f32) and a merge of at most ``_MERGE_CAP`` bytes, and a
    grid over half the card is not split.  The plan is a pure function of
    its inputs."""
    for S, rows, W, bs in MLA_GRID[chunk::3]:
        for r, rd, esize in ((512, 64, 2), (16, 8, 4), (100, 20, 2)):
            plan = _mla_plan(S, rows, W, bs, r, rd, esize, 132)
            assert plan == _mla_plan(S, rows, W, bs, r, rd, esize, 132)
            cols = [c for x in _split_columns(plan, W) for c in x]
            assert cols == list(range(W)), (S, rows, W, bs)
            assert all(len(x) > 0 for x in _split_columns(plan, W)) or W == 0
            assert plan.rows == (64 if esize == 2 else 32)
            assert plan.rblocks == -(-rows // plan.rows)
            assert plan.units == S * plan.rblocks
            assert plan.dv >= r and plan.dv in (64, 128, 256, 512)
            assert plan.dv >= 128 or esize == 4     # a wgmma n of 64 or more
            assert plan.part == plan.rows * (plan.dv + 2)
            if 2 * plan.units > 132:
                assert plan.splits == 1
            if plan.splits > 1:
                tile = 64 if esize == 2 else 32
                assert plan.ctas <= 132
                assert plan.pages % max(1, -(-tile // bs)) == 0
                assert plan.splits * plan.part * 4 <= _MERGE_CAP
                assert plan.ws_elems == plan.ctas * plan.part
            else:
                assert plan.ws_elems == 0


def test_mla_plan_shapes_of_the_paths_and_limits():
    """Phase 3's decode (8 lanes, 128 heads, 35 pages of 16, bf16) runs 5
    splits of 8 pages over 16 units (80 CTAs); one lane of 4096 rows 7
    splits of 40 pages (the merge's cap: 7 partials of 131584 bytes);
    phase 3's and phase 6's prefill chunk (64 rows x 128 heads a lane, 1024
    units) is not split; f32 takes 32-row CTAs.  Widths past the kernel's
    (r > 512, rd > 64, r + rd > 576) and other element sizes raise."""
    p = _mla_plan(8, 128, 35, 16, 512, 64, 2, 132)
    assert (p.rows, p.dv, p.rblocks, p.units) == (64, 512, 2, 16)
    assert (p.splits, p.pages, p.ctas) == (5, 8, 80)
    assert p.ws_elems == 80 * 64 * 514
    p = _mla_plan(1, 128, 256, 16, 512, 64, 2, 132)
    assert (p.splits, p.pages, p.ctas) == (7, 40, 14)
    assert _mla_plan(1, 128, 256, 16, 512, 64, 2, 132,
                     splits=64).ctas == 128
    p = _mla_plan(8, 64 * 128, 35, 16, 512, 64, 2, 132)
    assert (p.units, p.splits) == (1024, 1)
    p = _mla_plan(8, 128, 35, 16, 512, 64, 4, 132)
    assert (p.rows, p.rblocks, p.units, p.splits) == (32, 4, 32, 4)
    assert _mla_plan(8, 4, 35, 16, 16, 8, 2, 132).dv == 128
    assert _mla_plan(8, 4, 35, 16, 16, 8, 4, 132).dv == 64
    assert _mla_plan(8, 128, 35, 16, 512, 64, 2, 132, splits=3).splits == 3
    for r, rd in ((513, 8), (512, 65), (520, 56), (0, 8)):
        with pytest.raises(ValueError, match="r <= 512"):
            _mla_plan(8, 128, 35, 16, r, rd, 2, 132)
    with pytest.raises(ValueError, match="bf16 or f32"):
        _mla_plan(8, 128, 35, 16, 512, 64, 1, 132)


@pytest.fixture(scope="module")
def layer():
    """One reduced MLA layer's parameters, JAX-initialised, in both
    packages."""
    cfg = get_arch(ARCH).reduced()
    jp = jattn.init_mla(jax.random.PRNGKey(3), cfg)
    tp = {k: _t(v) for k, v in jp.items()}
    return cfg, tget_arch(ARCH).reduced(), jp, tp


def _arena_pair(rng, cfg, NB):
    m = cfg.mla
    ckv = rng.standard_normal((NB, BS, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((NB, BS, m.qk_rope_head_dim)).astype(np.float32)
    return ckv, kr


def test_mla_paged_prefill_matches_reference(layer):
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(1)
    S, C, W = 3, 5, 4
    NB = S * W + 1
    tables = np.arange(S * W, dtype=np.int32).reshape(S, W)
    kv0 = np.array([0, 4, 2], np.int32)
    chunk = np.array([5, 3, 0], np.int32)             # ragged + empty lane
    x = rng.standard_normal((S, C, jcfg.d_model)).astype(np.float32)
    pos = kv0[:, None] + np.arange(C, dtype=np.int32)[None]
    ckv, kr = _arena_pair(rng, jcfg, NB)
    jo, jckv, jkr = jattn.mla_paged_prefill(
        jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
        ckv_arena=jnp.asarray(ckv), krope_arena=jnp.asarray(kr),
        block_tables=jnp.asarray(tables), kv_lens=jnp.asarray(kv0),
        chunk_lens=jnp.asarray(chunk))
    tckv, tkr = _t(ckv), _t(kr)
    with torch.no_grad():
        to = tattn.mla_paged_prefill(
            tp, _t(x), _t(pos), tcfg, ckv_arena=tckv, krope_arena=tkr,
            block_tables=_t(tables), kv_lens=_t(kv0), chunk_lens=_t(chunk))
    live = np.arange(C)[None, :] < chunk[:, None]
    assert np.abs(to.numpy() - np.asarray(jo))[live].max() < 1e-4
    assert np.abs(tckv.numpy() - np.asarray(jckv))[:-1].max() < 1e-5
    assert np.abs(tkr.numpy() - np.asarray(jkr))[:-1].max() < 1e-5


def test_mla_paged_decode_matches_reference(layer):
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(2)
    S, W = 3, 4
    NB = S * W + 1
    tables = np.arange(S * W, dtype=np.int32).reshape(S, W)
    kv = np.array([7, 0, 12], np.int32)               # page boundary at 12
    wm = np.array([1, 1, 0], np.int32)                # lane 2 masked
    x = rng.standard_normal((S, 1, jcfg.d_model)).astype(np.float32)
    ckv, kr = _arena_pair(rng, jcfg, NB)
    jo, jckv, jkr = jattn.mla_paged_decode(
        jp, jnp.asarray(x), jnp.asarray(kv[:, None]), jcfg,
        ckv_arena=jnp.asarray(ckv), krope_arena=jnp.asarray(kr),
        block_tables=jnp.asarray(tables), kv_lens=jnp.asarray(kv),
        write_mask=jnp.asarray(wm))
    tckv, tkr = _t(ckv), _t(kr)
    with torch.no_grad():
        to = tattn.mla_paged_decode(
            tp, _t(x), _t(kv[:, None]), tcfg, ckv_arena=tckv,
            krope_arena=tkr, block_tables=_t(tables), kv_lens=_t(kv),
            write_mask=_t(wm))
    assert np.abs(to.numpy() - np.asarray(jo))[:2].max() < 1e-4
    assert np.abs(tckv.numpy() - np.asarray(jckv))[:-1].max() < 1e-5
    assert np.abs(tkr.numpy() - np.asarray(jkr))[:-1].max() < 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = get_arch(ARCH).reduced()
    tcfg = tget_arch(ARCH).reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    return jm, jparams, tbuild(tcfg, device="cpu"), tparams


def test_model_prefill_then_decode_logits_and_arena(models):
    jm, jparams, tm, tparams = models
    cfg = tm.cfg
    assert "dense_layers" in tparams and "moe" in tparams["layers"]
    rng = np.random.default_rng(0)
    S, C, W = 3, 5, 4
    NB = S * W + 1
    tables = np.arange(S * W, dtype=np.int32).reshape(S, W)
    tables[2] = tables[2, 0]                       # dead columns
    kv0 = np.zeros(S, np.int32)
    chunk = np.array([5, 3, 0], np.int32)          # ragged + empty lane
    toks = rng.integers(0, cfg.vocab_size, (S, C)).astype(np.int32)

    ja = jm.init_paged_arena(NB, BS)
    jl, ja = jm.paged_prefill_step(jparams, jnp.asarray(toks), ja,
                                   jnp.asarray(tables), jnp.asarray(kv0),
                                   jnp.asarray(chunk))
    ta = tm.init_paged_arena(NB, BS)
    assert ta["k"].shape == tuple(ja["k"].shape)   # latent c_kv pages
    assert ta["v"].shape == tuple(ja["v"].shape)   # latent k_rope pages
    with torch.no_grad():
        tl, ta = tm.paged_prefill_step(tparams, _t(toks), ta, _t(tables),
                                       _t(kv0), _t(chunk))
    live = [0, 1]
    assert np.abs(tl.numpy()[live] - np.asarray(jl)[live]).max() < 1e-4
    for name in ("k", "v"):
        diff = np.abs(ta[name].numpy()[:, :-1] - np.asarray(ja[name])[:, :-1])
        assert diff.max() < 1e-5

    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    wm = np.array([1, 1, 0], np.int32)
    jd, ja = jm.paged_decode_step(jparams, jnp.asarray(nxt), {}, ja,
                                  jnp.asarray(tables), jnp.asarray(chunk),
                                  jnp.asarray(wm))
    with torch.no_grad():
        td, ta = tm.paged_decode_step(tparams, _t(nxt), ta, _t(tables),
                                      _t(chunk), _t(wm))
    assert np.abs(td.numpy()[live] - np.asarray(jd)[live]).max() < 1e-4
    for name in ("k", "v"):
        diff = np.abs(ta[name].numpy()[:, :-1] - np.asarray(ja[name])[:, :-1])
        assert diff.max() < 1e-5


def test_cascade_decode_raises_for_mla(models):
    """Cascade decode is GQA-only, as in the reference."""
    from repro_torch.models import serving
    with pytest.raises(ValueError, match="cascade"):
        serving.paged_shared_decode_step(None, None, models[2].cfg, None,
                                         *[None] * 7)
