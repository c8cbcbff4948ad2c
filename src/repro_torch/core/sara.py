"""SARA — the self-adaptive recommender every GEMM site asks for its tile.

Port of ``repro/core/sara.py::SaraDispatcher`` in oracle mode: the
recommendation is the argmin of the tile cost model
(``core/tpu_costmodel.py``), memoized per (M, K, N).  The ADAPTNET path
and an H100 tile space are later slices (ROADMAP queue 1); constructing
the dispatcher in any other mode raises.

Execution lives in the dispatch layer (``repro_torch.dispatch``): model
GEMM sites call ``dispatch.gemm(x, w, site=...)``, which asks the active
dispatcher for the configuration and runs the RSA GEMM kernel with it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import tpu_costmodel as tcm


@dataclass
class SaraDispatcher:
    """Per-shape tile-configuration recommender (the paper's SARA runtime).

    ``recommend(M, K, N) -> TPUTileConfig`` resolves a GEMM shape to the
    tile blocks + residency mode the RSA kernel runs with, by exhaustive
    cost-model search.  Recommendations are memoized per shape —
    ``cache_info()`` / ``cache_clear()`` expose the cache, and
    ``source_of`` / ``source_info`` report which path produced each one
    (always ``"oracle"`` in this port)."""

    mode: str = "oracle"
    _cache: Dict = field(default_factory=dict)
    _sources: Dict = field(default_factory=dict)
    _hits: int = 0
    _misses: int = 0
    _n_oracle: int = 0

    def __post_init__(self) -> None:
        if self.mode != "oracle":
            raise ValueError(f"dispatcher mode {self.mode!r} is not ported "
                             "(only 'oracle'; adaptnet mode needs an H100 "
                             "tile space, see ROADMAP)")

    # -- recommendation ------------------------------------------------------
    def _oracle_cfg(self, M, K, N) -> tcm.TPUTileConfig:
        return tcm.TILE_CONFIGS[int(tcm.best_tile_config(M, K, N))]

    def recommend(self, M: int, K: int, N: int) -> tcm.TPUTileConfig:
        key = (int(M), int(K), int(N))
        if key in self._cache:
            self._hits += 1
            return self._cache[key]
        self._misses += 1
        cfg = self._oracle_cfg(M, K, N)
        self._commit(key, cfg)
        return cfg

    def recommend_batch(self, shapes: Sequence[Tuple[int, int, int]]
                        ) -> List[tcm.TPUTileConfig]:
        """Batch recommendation: one vectorized oracle sweep for every
        uncached shape (in-batch duplicates count as hits, as in the
        scalar path)."""
        keys = [(int(M), int(K), int(N)) for M, K, N in shapes]
        todo = []
        seen = set()
        for key in keys:
            if key in self._cache or key in seen:
                self._hits += 1
                continue
            self._misses += 1
            seen.add(key)
            todo.append(key)
        if todo:
            ms, ks, ns = zip(*todo)
            cids = np.atleast_1d(tcm.best_tile_config(
                np.asarray(ms), np.asarray(ks), np.asarray(ns)))
            for key, cid in zip(todo, cids):
                self._commit(key, tcm.TILE_CONFIGS[int(cid)])
        return [self._cache[k] for k in keys]

    def _commit(self, key, cfg: tcm.TPUTileConfig) -> None:
        self._cache[key] = cfg
        self._sources[key] = "oracle"
        self._n_oracle += 1

    def source_of(self, M: int, K: int, N: int) -> str:
        """Provenance of a cached recommendation ("oracle")."""
        return self._sources.get((int(M), int(K), int(N)), "oracle")

    def cache_info(self) -> Dict[str, int]:
        """Recommendation-cache statistics (the serving engine reports the
        hit rate)."""
        return {"hits": self._hits, "misses": self._misses,
                "size": len(self._cache)}

    def source_info(self) -> Dict[str, int]:
        """How many distinct shapes each recommendation source decided."""
        return {"adaptnet": 0, "oracle": self._n_oracle,
                "oracle_fallback": 0}

    def cache_clear(self) -> None:
        self._cache.clear()
        self._sources.clear()
        self._hits = self._misses = self._n_oracle = 0
