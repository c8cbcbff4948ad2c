"""Fig. 7e parity: the port's classifier baselines (``core/baselines.py``)
and ADAPTNET's trainer on a SAGAR-labelled set against the JAX package's
on the same numpy inputs.

- ``random_forest``: numpy copied, so predictions and accuracy bitwise.
- ``logistic_regression``: autograd and ``jax.grad`` sum the gradient in
  another order, so W and b are held to 1e-5 of their largest magnitude;
  the predictions (float64 on the host in both) equal except where the
  reference's two best logits are within 1e-5 of the largest logit.
- ``knn``: f32 distances; predictions equal wherever the k-th and
  (k+1)-th distances differ by more than 1e-5 of the k-th (two distinct
  points tied at the k-th place may be taken in another order).  The tied
  rows are counted; a mismatch outside them fails.
- ``plain_mlp`` from the reference's init (``jax.random`` draws numbers
  torch cannot, so the test carries the init across): the final leaves
  within 1e-4 of the leaf's largest magnitude or 2e-3 of the largest
  travel from the init, the tolerance ``tests/test_torch_adaptnet.py``
  uses for AdamW (ROADMAP §3), accuracies within one test sample.
- ADAPTNET's ``train`` on a 4 000-sample SAGAR set (108 classes) from the
  reference's init: the same tolerance, epoch accuracies within one
  sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptnet as JA
from repro.core import baselines as JB
from repro.core import dataset as JD
from repro_torch.core import adaptnet as A
from repro_torch.core import baselines as B
from repro_torch.core import dataset as D


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sets():
    """The same 4 000-sample SAGAR set (2^14 MACs, seed 11) split in both
    packages."""
    ours, theirs = D.generate(4000, seed=11), JD.generate(4000, seed=11)
    assert np.array_equal(ours.features, theirs.features)
    assert np.array_equal(ours.labels, theirs.labels)
    return ours.split(), theirs.split()


def _closure(fn):
    """The free variables of a reference ``predict`` closure: where the
    reference keeps its trained weights."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def test_random_forest_bitwise(sets):
    (tr, te), (jtr, jte) = sets
    ours = B.random_forest(tr, te, n_trees=3, max_depth=6)
    theirs = JB.random_forest(jtr, jte, n_trees=3, max_depth=6)
    assert ours.name == theirs.name == "RandomForest-3"
    assert ours.accuracy == theirs.accuracy
    q = np.concatenate([te.features, tr.features[:500]])
    assert np.array_equal(ours.predict(q), theirs.predict(q))


def test_logistic_regression_matches_reference(sets):
    (tr, te), (jtr, jte) = sets
    ours = B.logistic_regression(tr, te, device="cpu")
    theirs = JB.logistic_regression(jtr, jte)
    assert ours.name == theirs.name == "LogReg"
    ref = _closure(theirs.predict)
    W, b = ours.params
    for got, want in ((W, ref["Wn"]), (b, ref["bn"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    pa, pb = ours.predict(te.features), theirs.predict(te.features)
    q = (np.log1p(te.features.astype(np.float64)) - ref["mu"]) / ref["sd"]
    lg = np.sort(q @ ref["Wn"] + ref["bn"], -1)
    near = (lg[:, -1] - lg[:, -2]) <= 1e-5 * np.abs(lg).max(-1)
    assert np.all((pa == pb) | near)
    assert abs(ours.accuracy - theirs.accuracy) <= \
        np.sum(near) / len(te.labels) + 1e-12


def test_knn_matches_reference_off_ties(sets):
    (tr, te), (jtr, jte) = sets
    k = 5
    ours = B.knn(tr, te, k=k, device="cpu")
    theirs = JB.knn(jtr, jte, k=k)
    assert ours.name == theirs.name == "kNN-5"
    pa, pb = ours.predict(te.features), theirs.predict(te.features)
    # the k-th and (k+1)-th f32 distances of each query, as the port takes
    # them (the training subset: the reference's permutation, seed 0)
    ref = _closure(theirs.predict)
    X = np.asarray(_closure(ref["_pred"].__wrapped__)["Xj"])
    q = ((np.log1p(te.features.astype(np.float64)) - ref["mu"]) /
         ref["sd"]).astype(np.float32)
    d = np.sort(((X[None] - q[:, None]) ** 2).sum(-1), -1)
    tied = (d[:, k] - d[:, k - 1]) <= 1e-5 * np.maximum(d[:, k - 1], 1e-30)
    assert np.all((pa == pb) | tied), np.flatnonzero((pa != pb) & ~tied)
    assert np.sum(pa != pb) <= np.sum(tied)


def _jax_mlp_init(sizes):
    """The reference's ``plain_mlp`` init, as its body draws it."""
    key = jax.random.PRNGKey(0)
    out = []
    for i in range(len(sizes) - 1):
        key, k = jax.random.split(key)
        out.append({"w": jax.random.normal(k, (sizes[i], sizes[i + 1])) /
                    np.sqrt(sizes[i]),
                    "b": jnp.zeros((sizes[i + 1],))})
    return out


def test_plain_mlp_matches_reference_from_its_init(sets):
    (tr, te), (jtr, jte) = sets
    kw = dict(hidden=(32, 32), epochs=2, batch=256)
    theirs = JB.plain_mlp(jtr, jte, **kw)
    init = _jax_mlp_init((3, 32, 32, tr.num_classes))
    ours = B.plain_mlp(tr, te, device="cpu",
                       params=[{k: np.asarray(v) for k, v in layer.items()}
                               for layer in init], **kw)
    assert ours.name == theirs.name
    final = _closure(theirs.predict)["params"]
    travel = max(np.abs(np.asarray(f[k]) - np.asarray(i[k])).max()
                 for f, i in zip(final, init) for k in ("w", "b"))
    assert travel > 0
    for got, want in zip(ours.params, final):
        for k in ("w", "b"):
            w = np.asarray(want[k])
            assert got[k].shape == w.shape and got[k].dtype == w.dtype
            tol = max(1e-4 * np.abs(w).max(), 2e-3 * travel)
            assert np.abs(got[k] - w).max() <= tol, k
    assert abs(ours.accuracy - theirs.accuracy) <= 1.0 / len(te.labels) + \
        1e-12


def test_plain_mlp_default_init_and_run_all_names(sets):
    """Without ``params`` the port draws its own init (seeded, so two runs
    agree); ``run_all`` returns the reference's four names in its
    order."""
    (tr, te), _ = sets
    small = D.Dataset(tr.features[:1500], tr.labels[:1500], tr.num_classes)
    a = B.plain_mlp(small, te, hidden=(16,), epochs=1, batch=512,
                    device="cpu")
    b = B.plain_mlp(small, te, hidden=(16,), epochs=1, batch=512,
                    device="cpu")
    for la, lb in zip(a.params, b.params):
        assert all(np.array_equal(la[k], lb[k]) for k in ("w", "b"))
    res = B.run_all(small, te, device="cpu")
    assert list(res) == ["LogReg", "kNN-5", "MLP(128,128)",
                         "RandomForest-12"]
    assert all(0.0 <= r.accuracy <= 1.0 for r in res.values())


def test_adaptnet_train_on_sagar_labels_matches_reference(sets):
    """ADAPTNET (raw encoding, 108 classes) from the reference's init: the
    epoch accuracies within one sample and every leaf within AdamW's
    tolerance (``tests/test_torch_adaptnet.py``)."""
    (tr, te), (jtr, jte) = sets
    common = dict(epochs=2, batch=512, lr=3e-3, seed=0, log=False)
    jcfg = JA.AdaptNetConfig(num_classes=108)
    theirs = JA.train(jtr, jte, cfg=jcfg, **common)
    init = JA.init_params(jax.random.PRNGKey(0), jcfg)
    ours = A.train(tr, te, cfg=A.AdaptNetConfig(num_classes=108),
                   device="cpu",
                   params={k: np.asarray(v) for k, v in init.items()},
                   **common)
    travel = max(np.abs(np.asarray(theirs.params[k]) - np.asarray(init[k]))
                 .max() for k in A.TRAINABLE)
    for k, want in theirs.params.items():
        want = np.asarray(want)
        got = ours.params[k].numpy()
        tol = max(1e-4 * np.abs(want).max(), 2e-3 * travel)
        assert np.abs(got - want).max() <= tol, k
    for (e1, tr1, va1), (e2, tr2, va2) in zip(ours.history, theirs.history):
        assert e1 == e2
        assert abs(tr1 - tr2) <= 1.0 / 512 + 1e-12
        assert abs(va1 - va2) <= 1.0 / len(te.labels) + 1e-12
    pred = A.predict(ours.params, te.features)
    jpred = JA.predict(theirs.params, te.features)
    assert np.mean(pred != jpred) <= 1.0 / len(te.labels) + 1e-12
