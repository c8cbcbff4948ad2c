"""ADAPTNET parity: the port's datasets, forwards, fused ADAPTNETX query and
trainer against the JAX package's on the same numpy inputs.

- ``sample_workloads``, ``Dataset.split`` and ``synthetic_g``: bitwise
  (the same numpy code).
- The plain ADAPTNETX against ``ref.adaptnetx_ref`` and the Pallas kernel
  in interpret mode on the reference's kernel-test cases, and against
  ``logits_fn``: 1e-5, the reference's own tolerance (f32 sums of 48 and
  128 terms in another order).
- ``logits_np``: bitwise (a numpy copy of the reference's).  ``logits``
  (torch) against ``logits_fn``: 1e-5 relative to the largest logit
  (summation order).  Bucket ids equal, at the bucket edges and above
  ``dim_max`` too.
- ``train`` from the JAX init: each epoch's accuracies within one sample,
  and every final leaf within the larger of 1e-4 of the leaf's largest
  magnitude and 2e-3 of the farthest any parameter moved from the init.
  The second term is AdamW's: its step is the learning rate times a
  normalised gradient, so a gradient entry whose terms cancel (relative
  error up to 1.7e-3 between the two packages' f32 sums at step 1 here)
  moves by the learning rate times that error, however small the entry.
  It binds only on the raw encoding's embedding rows (1.3e-5 against
  1e-4 x 0.089 on one ``emb_k`` entry; the travel is 0.023).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptnet as JA
from repro.core import dataset as JD
from repro.core import workloads as JW
from repro.kernels import ref as jref
from repro.kernels.adaptnetx import adaptnetx_pallas
from repro_torch.core import adaptnet as A
from repro_torch.core import dataset as D
from repro_torch.core import tpu_costmodel as tcm
from repro_torch.core import workloads as W
from repro_torch.kernels import ops
from repro_torch.kernels.adaptnetx import OPERANDS as LEAVES
from repro_torch.kernels.adaptnetx import adaptnetx_plain

KERNEL_IDS = ([1, 1, 1], [9999, 5000, 1], [123, 4567, 8910])
TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _torch(params):
    return {k: torch.tensor(np.asarray(v)) for k, v in params.items()}


def _jparams(num_classes, seed=0, **kw):
    return JA.init_params(jax.random.PRNGKey(seed),
                          JA.AdaptNetConfig(num_classes=num_classes, **kw))


# ---------------------------------------------------------------------------
# datasets and workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist,seed,max_dim", [
    ("loguniform", 0, 10_000), ("uniform", 3, 10_000),
    ("loguniform", 7, 1 << 18)])
def test_sample_workloads_and_split_bitwise(dist, seed, max_dim):
    ours = D.sample_workloads(5000, dist=dist, seed=seed, max_dim=max_dim)
    theirs = JD.sample_workloads(5000, dist=dist, seed=seed, max_dim=max_dim)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    labels = np.arange(5000, dtype=np.int32) % 135
    for frac, s in ((0.9, 0), (0.75, 5)):
        a = D.Dataset(ours, labels, 135).split(frac, seed=s)
        b = JD.Dataset(theirs, labels, 135).split(frac, seed=s)
        for x, y in zip(a, b):
            assert np.array_equal(x.features, y.features)
            assert np.array_equal(x.labels, y.labels)
            assert x.num_classes == y.num_classes


def test_workloads_copy_bitwise():
    assert [tuple(vars(l).values()) for l in W.synthetic_g()] == \
        [tuple(vars(l).values()) for l in JW.synthetic_g()]
    for name, fn in JW.WORKLOADS.items():
        assert [(l.name, l.M, l.K, l.N) for l in W.WORKLOADS[name]()] == \
            [(l.name, l.M, l.K, l.N) for l in fn()]
        for x, y in zip(W.layer_dims(W.WORKLOADS[name]()),
                        JW.layer_dims(fn())):
            assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# ADAPTNETX: the plain version against the reference's kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [75, 108, 135])
def test_adaptnetx_plain_matches_pallas_and_ref(num_classes):
    jp = _jparams(num_classes)
    tp = _torch(jp)
    for ids in KERNEL_IDS:
        jids = jnp.asarray(ids, jnp.int32)
        pallas = adaptnetx_pallas(jids, jp["emb_m"], jp["emb_k"], jp["emb_n"],
                                  jp["w1"], jp["b1"], jp["w2"], jp["b2"],
                                  interpret=True)
        gold = jref.adaptnetx_ref(jids, *(jp[k] for k in LEAVES))
        ours = adaptnetx_plain(torch.tensor([ids], dtype=torch.int32),
                               *(tp[k] for k in LEAVES))[0].numpy()
        np.testing.assert_allclose(ours, np.asarray(pallas), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(ours, np.asarray(gold), rtol=TOL,
                                   atol=TOL)
        # the public wrapper: (3,) ids give (C,) logits
        one = ops.adaptnetx_recommend(torch.tensor(ids), tp)
        assert one.shape == (num_classes,) and one.dtype == torch.float32
        np.testing.assert_allclose(one.numpy(), ours, rtol=0, atol=0)


def test_adaptnetx_matches_host_adaptnet():
    """The fused query computes the software ADAPTNET: a batch of queries
    (the reference's vmap written out), ids past the table and negative
    ids clamped as ``logits_fn`` clips them."""
    jp = _jparams(108, seed=3)
    tp = _torch(jp)
    feats = np.array([[300, 4000, 77], [1, 1, 1], [20000, 10000, 10001],
                      [-5, 0, 123456], [9999, 5000, 1]], np.int32)
    sw = np.asarray(JA.logits_fn(jp, jnp.asarray(feats)))
    hw = ops.adaptnetx_recommend(torch.tensor(feats), tp)
    assert hw.shape == (5, 108)
    np.testing.assert_allclose(hw.numpy(), sw, rtol=TOL, atol=TOL)
    # the reference's own single-query case against its kernel
    pallas = adaptnetx_pallas(jnp.asarray(feats[0]), *(jp[k] for k in LEAVES),
                              interpret=True)
    np.testing.assert_allclose(hw[0].numpy(), np.asarray(pallas), rtol=TOL,
                               atol=TOL)


def test_adaptnetx_wrapper_casts_and_counts_plain_calls():
    """bf16 weights are cast to f32 as the reference's call casts them;
    on CPU tensors the wrapper runs the plain version only."""
    tp = _torch(_jparams(75))
    half = {k: (v.to(torch.bfloat16) if k in ("w1", "b1", "w2", "b2")
                else v) for k, v in tp.items()}
    ops.reset_counts()
    out = ops.adaptnetx_recommend(torch.tensor([[5, 6, 7], [8, 9, 10]]),
                                  half)
    want = adaptnetx_plain(torch.tensor([[5, 6, 7], [8, 9, 10]]),
                           *(half[k].float() for k in LEAVES))
    assert torch.equal(out, want)
    counts = ops.launch_counts()
    assert counts["adaptnetx"] == 0 and counts["plain_calls"] == 2
    with pytest.raises(ValueError, match="ids"):
        ops.adaptnetx_recommend(torch.zeros(2, 4, dtype=torch.int32), tp)
    empty = ops.adaptnetx_recommend(torch.zeros(0, 3, dtype=torch.int32), tp)
    assert empty.shape == (0, 75)
    ops.reset_counts()


# ---------------------------------------------------------------------------
# the forwards: raw and logbucket
# ---------------------------------------------------------------------------

def _edge_feats(edges, max_dim):
    """Dims at, just below and just above bucket edges, small dims, and
    dims past max_dim."""
    e = np.asarray(edges, np.float64)
    vals = np.concatenate([np.floor(e), np.ceil(e), np.ceil(e) + 1,
                           np.maximum(np.floor(e) - 1, 0),
                           [0, 1, 2, 127, 128, 129, 2047, 2048, 2049,
                            max_dim - 1, max_dim, max_dim + 1, 3 * max_dim,
                            128256, 129280]])
    vals = np.unique(vals.astype(np.int64))
    rng = np.random.default_rng(0)
    return np.stack([rng.permutation(vals) for _ in range(3)], 1)


@pytest.mark.parametrize("num_buckets,max_dim", [(256, 1 << 18), (64, 256),
                                                 (32, 4096)])
def test_logbucket_forwards_match_reference(num_buckets, max_dim):
    jp = _jparams(135, seed=1, encoding="logbucket", num_buckets=num_buckets,
                  max_dim=max_dim)
    tp = _torch(jp)
    feats = _edge_feats(np.asarray(jp["bucket_edges"]), max_dim)
    # the bucket ids: torch's searchsorted against both reference forwards
    ours = A.bucket_ids(tp, torch.tensor(feats)).numpy()
    ff = feats.astype(np.float32)
    assert np.array_equal(ours, np.searchsorted(np.asarray(jp["bucket_edges"]),
                                                ff, side="right"))
    assert np.array_equal(ours, np.asarray(jnp.searchsorted(
        jp["bucket_edges"], jnp.asarray(ff), side="right")))
    # the numpy twin: bitwise, on the reference's arrays and on tensors
    want_np = JA.logits_np(jp, feats)
    for params in ({k: np.asarray(v) for k, v in jp.items()}, tp):
        got = A.logits_np(params, feats)
        assert got.dtype == want_np.dtype and np.array_equal(got, want_np)
    # the torch forward against logits_fn
    want = np.asarray(JA.logits_fn(jp, jnp.asarray(feats)))
    got = A.logits(tp, torch.tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    assert A.trained_max_dim(tp) == JA.trained_max_dim(jp) == max_dim


def test_raw_forwards_match_reference():
    jp = _jparams(135, seed=2)
    tp = _torch(jp)
    rng = np.random.default_rng(1)
    feats = np.concatenate([
        rng.integers(0, 10_001, (64, 3)),
        [[10_000, 10_001, 250_000], [0, 1, 2], [-3, 5, 10_000]]]).astype(
            np.int32)
    want_np = JA.logits_np(jp, feats)
    got_np = A.logits_np(tp, feats)
    assert np.array_equal(got_np, want_np)
    want = np.asarray(JA.logits_fn(jp, jnp.asarray(feats)))
    got = A.logits(tp, torch.tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    assert A.trained_max_dim(tp) == JA.trained_max_dim(jp) == 10_000


def test_init_params_shapes_match_reference():
    for kw in (dict(), dict(encoding="logbucket", num_buckets=64,
                            max_dim=4096)):
        jp = _jparams(135, **kw)
        gen = torch.Generator()
        gen.manual_seed(0)
        tp = A.init_params(gen, A.AdaptNetConfig(num_classes=135, **kw))
        assert set(tp) == set(jp)
        for k in jp:
            assert tuple(tp[k].shape) == tuple(jp[k].shape), k
            assert tp[k].dtype == torch.float32
        if "bucket_edges" in jp:
            assert np.array_equal(tp["bucket_edges"].numpy(),
                                  np.asarray(jp["bucket_edges"]))
        # the reference's scales, to sampling error
        assert abs(tp["emb_m"].std().item() - 0.02) < 0.002
        w1 = tp["w1"]
        assert abs(w1.std().item() * w1.shape[0] ** 0.5 - 1.0) < 0.1


# ---------------------------------------------------------------------------
# training from one init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encoding", ["raw", "logbucket"])
def test_train_matches_reference_from_one_init(encoding):
    feats = D.sample_workloads(4096, seed=5)
    labels = tcm.best_tile_config(feats[:, 0], feats[:, 1],
                                  feats[:, 2]).astype(np.int32)
    kw = dict(num_classes=tcm.NUM_TILE_CLASSES, encoding=encoding,
              num_buckets=64)
    jcfg = JA.AdaptNetConfig(**kw)
    tr, te = D.Dataset(feats, labels, tcm.NUM_TILE_CLASSES).split()
    jtr, jte = JD.Dataset(feats, labels, tcm.NUM_TILE_CLASSES).split()
    common = dict(epochs=2, batch=512, lr=3e-3, seed=0, log=False)
    theirs = JA.train(jtr, jte, cfg=jcfg, **common)
    # the reference's train starts from init_params(PRNGKey(seed))
    init = JA.init_params(jax.random.PRNGKey(0), jcfg)
    ours = A.train(tr, te, cfg=A.AdaptNetConfig(**kw), device="cpu",
                   params={k: np.asarray(v) for k, v in init.items()},
                   **common)
    assert set(ours.params) == set(theirs.params)
    travel = max(np.abs(np.asarray(theirs.params[k]) - np.asarray(init[k]))
                 .max() for k in A.TRAINABLE)
    for k, want in theirs.params.items():
        want = np.asarray(want)
        got = ours.params[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        tol = max(1e-4 * np.abs(want).max(), 2e-3 * travel)
        assert np.abs(got - want).max() <= tol, k
        if k in ("bucket_edges", "dim_max"):
            assert np.array_equal(got, want), k
    assert len(ours.history) == len(theirs.history) == 2
    for (e1, tr1, va1), (e2, tr2, va2) in zip(ours.history, theirs.history):
        assert e1 == e2
        assert abs(tr1 - tr2) <= 1.0 / 512 + 1e-12
        assert abs(va1 - va2) <= 1.0 / len(te.labels) + 1e-12
    assert abs(ours.test_accuracy - theirs.test_accuracy) <= \
        1.0 / len(te.labels) + 1e-12
    # predict / accuracy agree with the reference's on the final params
    jpred = JA.predict(theirs.params, te.features)
    tpred = A.predict(ours.params, te.features)
    assert np.mean(jpred != tpred) <= 1.0 / len(te.labels) + 1e-12
