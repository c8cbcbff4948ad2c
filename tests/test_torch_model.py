"""Model parity: the port's paged chunk-prefill and decode steps against the
reference's, from the same weights (JAX-initialised reduced llama3.2-1b,
carried across through ``repro_torch.checkpoint.params_from_numpy``).

Two lanes with ragged chunks (plus an empty lane) stream one prefill step,
then one decode step; logits and the written arenas must agree to f32
tolerance: 1e-4 absolute on logits of magnitude ~1 (two layers of f32
GEMMs and softmax summed in different orders), 1e-5 on arena rows.  The
trash block (the arena's last page) takes every masked row in both
packages, so it is excluded from the comparison: colliding writes there
land in an unspecified order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models.api import build_model as jbuild
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.models.api import build_model as tbuild

BS, C, W = 4, 5, 4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jcfg = get_arch("llama3.2-1b").reduced()
    tcfg = tget_arch("llama3.2-1b").reduced()
    # the copied config gives the same reduced preset
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    return jm, jparams, tbuild(tcfg, device="cpu"), tparams


def test_prefill_then_decode_logits_and_arena(models):
    jm, jparams, tm, tparams = models
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    S = 3
    NB = S * W + 1
    tables = np.arange(S * W, dtype=np.int32).reshape(S, W)
    tables[2] = tables[2, 0]                       # dead columns
    kv0 = np.array([0, 0, 0], np.int32)
    chunk = np.array([5, 3, 0], np.int32)          # ragged + empty lane
    toks = rng.integers(0, cfg.vocab_size, (S, C)).astype(np.int32)

    ja = jm.init_paged_arena(NB, BS)
    jl, ja = jm.paged_prefill_step(jparams, jnp.asarray(toks), ja,
                                   jnp.asarray(tables), jnp.asarray(kv0),
                                   jnp.asarray(chunk))
    ta = tm.init_paged_arena(NB, BS)
    with torch.no_grad():
        tl, ta = tm.paged_prefill_step(tparams, torch.from_numpy(toks), ta,
                                       torch.from_numpy(tables),
                                       torch.from_numpy(kv0),
                                       torch.from_numpy(chunk))
    live = [0, 1]              # the empty lane's logits are garbage
    assert np.abs(tl.numpy()[live] - np.asarray(jl)[live]).max() < 1e-4
    for name in ("k", "v"):
        diff = np.abs(ta[name].numpy()[:, :-1] - np.asarray(ja[name])[:, :-1])
        assert diff.max() < 1e-5

    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    wm = np.array([1, 1, 0], np.int32)              # lane 2 masked
    jd, ja = jm.paged_decode_step(jparams, jnp.asarray(nxt), {}, ja,
                                  jnp.asarray(tables), jnp.asarray(chunk),
                                  jnp.asarray(wm))
    with torch.no_grad():
        td, ta = tm.paged_decode_step(tparams, torch.from_numpy(nxt), ta,
                                      torch.from_numpy(tables),
                                      torch.from_numpy(chunk),
                                      torch.from_numpy(wm))
    assert np.abs(td.numpy()[live] - np.asarray(jd)[live]).max() < 1e-4
    for name in ("k", "v"):
        diff = np.abs(ta[name].numpy()[:, :-1] - np.asarray(ja[name])[:, :-1])
        assert diff.max() < 1e-5
