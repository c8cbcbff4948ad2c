"""GEMM-workload datasets for ADAPTNET training.

The part of ``repro/core/dataset.py`` that the port's trainers need,
copied: ``MAX_DIM``, ``Dataset`` (with ``split``) and ``sample_workloads``.
Paper §III-B samples M/N/K from positive integers <= 10^4; sampling here
is log-uniform by default (``dist="uniform"`` is the paper's sampler).
The SAGAR-labelled ``generate`` and the ``relative_*`` helpers rest on the
paper's RSA cost model, which the port does not have yet (ROADMAP queue 1
item 18); the port labels with the tile cost model
(``core/tpu_costmodel.py``) instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

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
