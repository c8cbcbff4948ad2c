"""Classical classifier baselines for Fig. 7e (ADAPTNET vs. the field).

The port of ``repro/core/baselines.py``.  The paper compares SVCs, XGBoost
and MLPs; the reference implements the comparison set itself, and so does
the port: kNN, multinomial logistic regression and a plain MLP on
log-features (no embeddings, which isolates ADAPTNET's embedding
contribution) in PyTorch, and a random forest (the tree-ensemble stand-in
for XGBoost) in numpy, copied.

All baselines receive log-scaled features, the representation most
favorable to them; ADAPTNET's advantage comes from per-integer embeddings
that can express the ceil-quantization cliffs of the config space.

The torch baselines run on ``device`` (CUDA unless the caller names
another; ``models.api.resolve_device``).  Where they differ from the
reference's numbers, it is by summation order:

- ``knn``: f32 distances in 512-query chunks and ``torch.topk``; both
  packages break a vote tie towards the lowest class, but two distinct
  points whose f32 distances tie at the k-th place may be taken in
  another order.
- ``logistic_regression``: autograd sums the gradient in another order
  than ``jax.grad``; its ``predict`` is the reference's numpy float64
  product on the host.
- ``plain_mlp``: the port's ``AdamW`` with the reference's batch order;
  its init draws from a ``torch.Generator`` (``jax.random`` draws other
  numbers), so a test passes the reference's init as ``params``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dataset import Dataset


def _logfeat(x: np.ndarray) -> np.ndarray:
    return np.log1p(x.astype(np.float64))


def _device(device: Optional[str]) -> torch.device:
    from repro_torch.models.api import resolve_device
    return resolve_device(device)


@dataclass
class BaselineResult:
    name: str
    accuracy: float
    train_seconds: float
    predict: Callable[[np.ndarray], np.ndarray]
    # the trained weights on the host: (W, b) of the logistic regression,
    # the MLP's layers ({"w", "b"} each); None for kNN and the forest
    params: Optional[object] = None


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------

def knn(train: Dataset, test: Dataset, k: int = 5, max_train: int = 60_000,
        device: Optional[str] = None) -> BaselineResult:
    dev = _device(device)
    t0 = time.time()
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(train.labels))[:max_train]
    X = _logfeat(train.features[idx])
    y = train.labels[idx]
    mu, sd = X.mean(0), X.std(0) + 1e-9
    Xn = (X - mu) / sd

    Xt = torch.as_tensor(Xn, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y, dtype=torch.int64, device=dev)

    @torch.no_grad()
    def _pred(q: torch.Tensor) -> torch.Tensor:
        d = torch.sum((Xt[None] - q[:, None]) ** 2, -1)
        nb = torch.topk(d, k, dim=-1, largest=False).indices
        votes = torch.nn.functional.one_hot(
            yt[nb], train.num_classes).sum(1)               # (B, C)
        return torch.argmax(votes, -1)          # first of equal: lowest class

    def predict(feats: np.ndarray) -> np.ndarray:
        q = (_logfeat(feats) - mu) / sd
        out = [_pred(torch.as_tensor(q[lo:lo + 512], dtype=torch.float32,
                                     device=dev)).cpu().numpy()
               for lo in range(0, len(q), 512)]
        return np.concatenate(out) if out else np.zeros((0,), np.int64)

    acc = float(np.mean(predict(test.features) == test.labels))
    return BaselineResult("kNN-5", acc, time.time() - t0, predict)


# ---------------------------------------------------------------------------
# multinomial logistic regression (a linear SVC-class stand-in)
# ---------------------------------------------------------------------------

def _cross_entropy(lg: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(lg, -1)
    gold = lg.gather(1, y[:, None])[:, 0]
    return torch.mean(lse - gold)


def logistic_regression(train: Dataset, test: Dataset, epochs: int = 30,
                        lr: float = 0.5, device: Optional[str] = None
                        ) -> BaselineResult:
    dev = _device(device)
    t0 = time.time()
    X = _logfeat(train.features)
    mu, sd = X.mean(0), X.std(0) + 1e-9
    Xn = torch.as_tensor((X - mu) / sd, dtype=torch.float32, device=dev)
    y = torch.as_tensor(train.labels, dtype=torch.int64, device=dev)
    C = train.num_classes
    W = torch.zeros((X.shape[1], C), device=dev)
    b = torch.zeros((C,), device=dev)

    for _ in range(epochs):
        W.requires_grad_()
        b.requires_grad_()
        with torch.enable_grad():
            gW, gb = torch.autograd.grad(_cross_entropy(Xn @ W + b, y),
                                         (W, b))
        with torch.no_grad():
            W, b = W - lr * gW, b - lr * gb

    Wn, bn = W.cpu().numpy(), b.cpu().numpy()

    def predict(feats: np.ndarray) -> np.ndarray:
        q = (_logfeat(feats) - mu) / sd
        return np.argmax(q @ Wn + bn, -1)

    acc = float(np.mean(predict(test.features) == test.labels))
    return BaselineResult("LogReg", acc, time.time() - t0, predict,
                          params=(Wn, bn))


# ---------------------------------------------------------------------------
# plain MLP on log features (no embeddings)
# ---------------------------------------------------------------------------

def _mlp_fwd(params, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = x @ params[str(i)]["w"] + params[str(i)]["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def plain_mlp(train: Dataset, test: Dataset,
              hidden: Tuple[int, ...] = (128, 128), epochs: int = 20,
              batch: int = 1024, lr: float = 3e-3,
              device: Optional[str] = None,
              params: Optional[Sequence[Dict]] = None) -> BaselineResult:
    """``params``: the starting layers, a sequence of {"w", "b"}, copied
    to the device (default: w ~ N(0, 1) / sqrt(fan-in) and b = 0, the
    reference's scales, drawn from a generator seeded 0).  Layer ``i`` is
    keyed ``str(i)`` in the tree AdamW updates, so its leaves come in the
    reference's order."""
    from repro_torch.optim.adamw import AdamW, apply_updates, tree_map
    dev = _device(device)
    t0 = time.time()
    X = _logfeat(train.features)
    mu, sd = X.mean(0), X.std(0) + 1e-9
    Xn = torch.as_tensor((X - mu) / sd, dtype=torch.float32, device=dev)
    y = torch.as_tensor(train.labels, dtype=torch.int64, device=dev)
    C = train.num_classes
    sizes = (X.shape[1],) + tuple(hidden) + (C,)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        tree = {str(i): {"w": torch.randn((sizes[i], sizes[i + 1]),
                                          generator=gen, device=dev) /
                         float(np.sqrt(sizes[i])),
                         "b": torch.zeros((sizes[i + 1],), device=dev)}
                for i in range(len(sizes) - 1)}
    else:
        tree = {str(i): {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                         device=dev)
                         for k, v in layer.items()}
                for i, layer in enumerate(params)}

    opt = AdamW(lr=lr, weight_decay=0.0)
    opt_state = opt.init(tree)

    def step(xb, yb):
        nonlocal tree, opt_state
        leaves = tree_map(lambda v: v.detach().requires_grad_(), tree)
        keys = [(i, k) for i in leaves for k in leaves[i]]
        with torch.enable_grad():
            g = torch.autograd.grad(_cross_entropy(_mlp_fwd(leaves, xb), yb),
                                    [leaves[i][k] for i, k in keys])
        grads = {i: {} for i in leaves}
        for (i, k), gk in zip(keys, g):
            grads[i][k] = gk
        updates, opt_state, _ = opt.update(grads, opt_state, tree)
        tree = apply_updates(tree, updates)

    rng = np.random.default_rng(0)
    n = len(train.labels)
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for s in range(n // batch):
            idx = order[s * batch:(s + 1) * batch]
            step(Xn[idx], y[idx])

    @torch.no_grad()
    def predict(feats: np.ndarray) -> np.ndarray:
        q = torch.as_tensor((_logfeat(feats) - mu) / sd, dtype=torch.float32,
                            device=dev)
        return torch.argmax(_mlp_fwd(tree, q), -1).cpu().numpy()

    acc = float(np.mean(predict(test.features) == test.labels))
    return BaselineResult(
        "MLP(128,128)", acc, time.time() - t0, predict,
        params=[{k: v.cpu().numpy() for k, v in tree[str(i)].items()}
                for i in range(len(tree))])


# ---------------------------------------------------------------------------
# random forest (axis-aligned CART, histogram splits) — XGBoost stand-in
# ---------------------------------------------------------------------------

class _Tree:
    __slots__ = ("feat", "thr", "left", "right", "leaf")

    def __init__(self):
        self.leaf = None


def _grow(X, y, C, depth, max_depth, min_leaf, rng) -> _Tree:
    node = _Tree()
    if depth >= max_depth or len(y) < 2 * min_leaf or \
            np.all(y == y[0]):
        node.leaf = np.bincount(y, minlength=C)
        return node
    best = (None, None, np.inf)
    counts = np.bincount(y, minlength=C).astype(np.float64)
    total_gini = 1.0 - np.sum((counts / len(y)) ** 2)
    feats = rng.choice(X.shape[1], size=X.shape[1], replace=False)
    for f in feats:
        xs = X[:, f]
        qs = np.quantile(xs, np.linspace(0.05, 0.95, 16))
        for thr in np.unique(qs):
            mask = xs <= thr
            nl = int(mask.sum())
            if nl < min_leaf or len(y) - nl < min_leaf:
                continue
            cl = np.bincount(y[mask], minlength=C).astype(np.float64)
            cr = counts - cl
            gl = 1.0 - np.sum((cl / max(nl, 1)) ** 2)
            gr = 1.0 - np.sum((cr / max(len(y) - nl, 1)) ** 2)
            g = (nl * gl + (len(y) - nl) * gr) / len(y)
            if g < best[2]:
                best = (f, thr, g)
    if best[0] is None or best[2] >= total_gini:
        node.leaf = np.bincount(y, minlength=C)
        return node
    f, thr, _ = best
    mask = X[:, f] <= thr
    node.feat, node.thr = f, thr
    node.left = _grow(X[mask], y[mask], C, depth + 1, max_depth, min_leaf, rng)
    node.right = _grow(X[~mask], y[~mask], C, depth + 1, max_depth, min_leaf,
                       rng)
    return node


def _tree_predict_counts(node: _Tree, X: np.ndarray, out: np.ndarray,
                         idx: np.ndarray):
    if node.leaf is not None:
        out[idx] += node.leaf / max(node.leaf.sum(), 1)
        return
    mask = X[idx, node.feat] <= node.thr
    _tree_predict_counts(node.left, X, out, idx[mask])
    _tree_predict_counts(node.right, X, out, idx[~mask])


def random_forest(train: Dataset, test: Dataset, n_trees: int = 12,
                  max_depth: int = 12, max_train: int = 40_000
                  ) -> BaselineResult:
    """numpy on the host, as the reference's."""
    t0 = time.time()
    rng = np.random.default_rng(0)
    sel = rng.permutation(len(train.labels))[:max_train]
    X = _logfeat(train.features[sel])
    y = train.labels[sel].astype(np.int64)
    C = train.num_classes
    trees = []
    for t in range(n_trees):
        bs = rng.integers(0, len(y), len(y))
        trees.append(_grow(X[bs], y[bs], C, 0, max_depth, 8,
                           np.random.default_rng(t)))

    def predict(feats: np.ndarray) -> np.ndarray:
        Xq = _logfeat(feats)
        probs = np.zeros((len(Xq), C))
        for tree in trees:
            _tree_predict_counts(tree, Xq, probs, np.arange(len(Xq)))
        return np.argmax(probs, -1)

    acc = float(np.mean(predict(test.features) == test.labels))
    return BaselineResult(f"RandomForest-{n_trees}", acc,
                          time.time() - t0, predict)


def run_all(train: Dataset, test: Dataset, device: Optional[str] = None
            ) -> Dict[str, BaselineResult]:
    """The four baselines, in the reference's order; the torch ones on
    ``device``."""
    out = {}
    for fn in (logistic_regression, knn, plain_mlp):
        r = fn(train, test, device=device)
        out[r.name] = r
    r = random_forest(train, test)
    out[r.name] = r
    return out
