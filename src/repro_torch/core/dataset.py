"""GEMM-workload datasets for ADAPTNET training.

A copy of ``repro/core/dataset.py`` (numpy only): ``MAX_DIM``,
``Dataset`` (with ``split``), ``sample_workloads``, the SAGAR-labelled
``generate`` and the ``relative_performance`` / ``geomean_relative``
scores.  Paper §III-B samples M/N/K from positive integers <= 10^4;
sampling here is log-uniform by default (``dist="uniform"`` is the
paper's sampler).  ``generate`` labels each workload with the exhaustive
oracle over the paper's RSA configuration space (``core/costmodel.py``,
EDP by default), bit for bit the reference's labels; the relative scores
are that cost model's EDP or cycles of a pick over the best, model
numbers for the paper's 28 nm array.  The serving trainers label with
the tile cost model (``core/tpu_costmodel.py``) instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core.rsa import RSAInstance, SAGAR_INSTANCE, enumerate_configs

MAX_DIM = 10_000


@dataclass
class Dataset:
    features: np.ndarray      # (n, 3) int32: M, K, N
    labels: np.ndarray        # (n,) int32 class ids
    num_classes: int

    def split(self, train_frac: float = 0.9, seed: int = 0
              ) -> Tuple["Dataset", "Dataset"]:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.labels))
        k = int(len(idx) * train_frac)
        tr, te = idx[:k], idx[k:]
        return (Dataset(self.features[tr], self.labels[tr], self.num_classes),
                Dataset(self.features[te], self.labels[te], self.num_classes))


def sample_workloads(n: int, *, dist: str = "loguniform", seed: int = 0,
                     max_dim: int = MAX_DIM) -> np.ndarray:
    """(n, 3) int32 dims in [1, max_dim]; ``max_dim`` widens the range
    beyond the paper's 10^4 (the serving trainer covers lm_head-scale dims
    up to 2^18, ``launch/train_adaptnet.py``)."""
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        dims = rng.integers(1, max_dim + 1, size=(n, 3))
    elif dist == "loguniform":
        dims = np.exp(rng.uniform(0.0, np.log(max_dim), size=(n, 3)))
        dims = np.clip(dims.astype(np.int64) + 1, 1, max_dim)
    else:
        raise ValueError(dist)
    return dims.astype(np.int32)


def generate(n: int = 400_000, *, inst: RSAInstance = SAGAR_INSTANCE,
             dist: str = "loguniform", objective: str = "edp",
             seed: int = 0, chunk: int = 100_000) -> Dataset:
    """Label n workloads with the exhaustive-search oracle (vectorized)."""
    feats = sample_workloads(n, dist=dist, seed=seed)
    labels = np.empty(n, np.int32)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        labels[lo:hi] = cm.best_config(
            inst, feats[lo:hi, 0], feats[lo:hi, 1], feats[lo:hi, 2],
            objective=objective)
    return Dataset(feats, labels, num_classes=len(enumerate_configs(inst)))


def relative_performance(inst: RSAInstance, feats: np.ndarray,
                         pred: np.ndarray, metric: str = "edp") -> np.ndarray:
    """per-sample predicted-config cost / oracle cost (>= 1)."""
    cost = cm.sweep_configs(inst, feats[:, 0], feats[:, 1], feats[:, 2])
    table = cost.edp if metric == "edp" else cost.runtime
    chosen = np.take_along_axis(table, pred[:, None].astype(int), -1)[:, 0]
    return chosen / table.min(axis=-1)


def geomean_relative(inst: RSAInstance, feats: np.ndarray, pred: np.ndarray,
                     metric: str = "edp") -> float:
    rel = relative_performance(inst, feats, pred, metric)
    return float(np.exp(np.mean(np.log(rel))))
