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
from repro_torch.kernels.paged_mla import (paged_mla_attention_plain,
                                           paged_mla_prefill_attention_plain)
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
    ours = paged_mla_attention_plain(_t(qa), _t(qr), _t(ckv), _t(krope),
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
    ours = paged_mla_prefill_attention_plain(
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
