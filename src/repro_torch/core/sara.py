"""SARA — the self-adaptive recommender every GEMM site asks for its tile.

Port of ``repro/core/sara.py::SaraDispatcher``.  Two recommendation
paths, as in the reference:

  - "oracle": argmin of the tile cost model (``core/tpu_costmodel.py``),
    an exhaustive search;
  - "adaptnet": one lookup through a trained ADAPTNET-TPU
    (``core/adaptnet.py``), resolved on the host through the numpy twin
    ``logits_np`` so the picks are bit for bit the reference's; shapes
    outside the net's trained range fall back to the oracle.

Recommendations are memoized per (M, K, N).  The tile space is the TPU
model's, copied so the port recommends what the reference does; an H100
tile space is later work (ROADMAP queue 1 item 14).

Execution lives in the dispatch layer (``repro_torch.dispatch``): model
GEMM sites call ``dispatch.gemm(x, w, site=...)``, which asks the active
dispatcher for the configuration and runs the RSA GEMM kernel with it.
``SaraDispatcher.gemm`` is the one-call self-adaptive GEMM over that
layer, with this dispatcher active and its ``execute`` mode (the
reference's ``use_pallas`` switch).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tpu_costmodel as tcm
from repro_torch.core.adaptnet import logits_np, trained_max_dim

MODES = ("oracle", "adaptnet")


def load_adaptnet(directory: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """(params, metadata) of an ADAPTNET-TPU saved by either package's
    ``launch/train_adaptnet.py`` (the checkpoint manager's layout).  The
    params dict is flat, so the checkpoint's flat keys restore it as it
    is; the leaves stay numpy on the host, where the dispatcher's
    ``logits_np`` reads them."""
    from repro_torch.checkpoint import CheckpointManager
    _, flat, meta = CheckpointManager(directory).restore_flat()
    return {k: np.asarray(v) for k, v in flat.items()}, meta


@dataclass
class SaraDispatcher:
    """Per-shape tile-configuration recommender (the paper's SARA runtime).

    ``recommend(M, K, N) -> TPUTileConfig`` resolves a GEMM shape to the
    tile blocks + residency mode the RSA kernel runs with, through the
    oracle or (``mode="adaptnet"``) a trained ADAPTNET-TPU.
    ``cache_info()`` / ``cache_clear()`` expose the memo, and
    ``source_of`` / ``source_info`` report which path produced each
    recommendation.  Build adaptnet-mode instances with
    ``from_checkpoint(dir)``."""

    mode: str = "oracle"                   # "oracle" | "adaptnet"
    adaptnet_params: Optional[Dict] = None
    # how ``gemm`` runs: "auto" (the RSA kernel on CUDA tensors, the plain
    # version on CPU tensors), "kernel" or "torch" (``dispatch.context``)
    execute: str = "auto"
    _cache: Dict = field(default_factory=dict)
    _sources: Dict = field(default_factory=dict)
    _hits: int = 0
    _misses: int = 0
    _n_adaptnet: int = 0
    _n_oracle: int = 0
    _n_fallback: int = 0

    def __post_init__(self) -> None:
        from repro_torch.dispatch.context import EXECUTE_MODES
        if self.mode not in MODES:
            raise ValueError(f"unknown dispatcher mode {self.mode!r} "
                             f"(one of {MODES})")
        if self.execute not in EXECUTE_MODES:
            raise ValueError(f"unknown execute mode {self.execute!r} "
                             f"(one of {EXECUTE_MODES})")

    def __setattr__(self, name, value):
        # flipping the recommendation source on a live dispatcher must not
        # keep serving stale cached recommendations (or stale per-source
        # counters: the telemetry restarts with the new source)
        if (name in ("mode", "adaptnet_params")
                and self.__dict__.get(name) is not value
                and self.__dict__.get("_cache")):
            self.cache_clear()
        object.__setattr__(self, name, value)

    @classmethod
    def from_checkpoint(cls, directory: str, **kw) -> "SaraDispatcher":
        """An adaptnet-mode dispatcher driven by a saved ADAPTNET-TPU."""
        params, _ = load_adaptnet(directory)
        return cls(mode="adaptnet", adaptnet_params=params, **kw)

    # -- recommendation ------------------------------------------------------
    def _adaptnet_active(self) -> bool:
        return self.mode == "adaptnet" and self.adaptnet_params is not None

    def in_trained_range(self, M: int, K: int, N: int) -> bool:
        """Whether the installed ADAPTNET can represent this shape.  Raw
        params alias every dim > 10^4, so those shapes go to the oracle;
        logbucket params record their coverage bound."""
        if not self._adaptnet_active():
            return False
        return max(int(M), int(K), int(N)) <= trained_max_dim(
            self.adaptnet_params)

    def _oracle_cfg(self, M, K, N) -> tcm.TPUTileConfig:
        return tcm.TILE_CONFIGS[int(tcm.best_tile_config(M, K, N))]

    def recommend(self, M: int, K: int, N: int) -> tcm.TPUTileConfig:
        key = (int(M), int(K), int(N))
        if key in self._cache:
            self._hits += 1
            return self._cache[key]
        self._misses += 1
        if self._adaptnet_active():
            if self.in_trained_range(M, K, N):
                cid = int(np.argmax(logits_np(
                    self.adaptnet_params, np.array([key], np.int64)), -1)[0])
                cfg, src = tcm.TILE_CONFIGS[cid], "adaptnet"
            else:
                # shapes the net was never trained to represent get the
                # exhaustive-search answer, not an aliased embedding row
                cfg, src = self._oracle_cfg(M, K, N), "oracle_fallback"
        else:
            cfg, src = self._oracle_cfg(M, K, N), "oracle"
        self._commit(key, cfg, src)
        return cfg

    def recommend_batch(self, shapes: Sequence[Tuple[int, int, int]]
                        ) -> List[tcm.TPUTileConfig]:
        """Batch recommendation: one ADAPTNET forward for every uncached
        in-range shape, one vectorized oracle sweep for the rest (in-batch
        duplicates count as hits, as in the scalar path)."""
        keys = [(int(M), int(K), int(N)) for M, K, N in shapes]
        out: List[Optional[tcm.TPUTileConfig]] = [None] * len(keys)
        net_idx, orc_idx = [], []
        seen = set()
        for i, key in enumerate(keys):
            if key in self._cache:
                self._hits += 1
                out[i] = self._cache[key]
                continue
            if key in seen:
                self._hits += 1
                continue
            self._misses += 1
            seen.add(key)
            (net_idx if self.in_trained_range(*key) else orc_idx).append(i)
        if net_idx:
            feats = np.asarray([keys[i] for i in net_idx], np.int64)
            cids = np.argmax(logits_np(self.adaptnet_params, feats), -1)
            for i, cid in zip(net_idx, cids):
                self._commit(keys[i], tcm.TILE_CONFIGS[int(cid)], "adaptnet")
        if orc_idx:
            ms, ks, ns = zip(*(keys[i] for i in orc_idx))
            src = "oracle_fallback" if self._adaptnet_active() else "oracle"
            cids = np.atleast_1d(tcm.best_tile_config(
                np.asarray(ms), np.asarray(ks), np.asarray(ns)))
            for i, cid in zip(orc_idx, cids):
                self._commit(keys[i], tcm.TILE_CONFIGS[int(cid)], src)
        return [out[i] if out[i] is not None else self._cache[keys[i]]
                for i in range(len(keys))]

    def _commit(self, key, cfg: tcm.TPUTileConfig, src: str) -> None:
        self._cache[key] = cfg
        self._sources[key] = src
        if src == "adaptnet":
            self._n_adaptnet += 1
        elif src == "oracle_fallback":
            self._n_fallback += 1
        else:
            self._n_oracle += 1

    def source_of(self, M: int, K: int, N: int) -> str:
        """Provenance of a cached recommendation: "adaptnet", "oracle", or
        "oracle_fallback" (adaptnet mode, shape outside the trained
        range)."""
        return self._sources.get((int(M), int(K), int(N)), "oracle")

    def cache_info(self) -> Dict[str, int]:
        """Recommendation-cache statistics (the serving engine reports the
        hit rate)."""
        return {"hits": self._hits, "misses": self._misses,
                "size": len(self._cache)}

    def source_info(self) -> Dict[str, int]:
        """How many distinct shapes each recommendation source decided."""
        return {"adaptnet": self._n_adaptnet, "oracle": self._n_oracle,
                "oracle_fallback": self._n_fallback}

    def cache_clear(self) -> None:
        self._cache.clear()
        self._sources.clear()
        self._hits = self._misses = 0
        self._n_adaptnet = self._n_oracle = self._n_fallback = 0

    def recommend_sharding(self, M: int, K: int, N: int,
                           data: int = 16, model: int = 16) -> tcm.ShardPlan:
        """The mesh-level recommendation for an (M, K, N) GEMM on a
        (data, model) mesh: the TPU planner's lowest-latency sharding."""
        return tcm.plan_gemm_sharding(M, K, N, data=data, model=model)

    # -- execution -----------------------------------------------------------
    def gemm(self, x, w, *, site: str = "sara.gemm"):
        """Self-adaptive GEMM: (..., M, K) @ (K, N) through the dispatch
        layer with this dispatcher active under its ``execute`` mode; the
        active registry records the site.  Nothing falls back: "kernel" on
        CPU tensors raises."""
        from repro_torch import dispatch
        with dispatch.use(self, execute=self.execute):
            return dispatch.gemm(x, w, site=site)


def train_adaptnet_tpu(n_samples: int = 150_000, epochs: int = 10,
                       seed: int = 0, log: bool = False,
                       device: Optional[str] = None):
    """Train a raw-encoding ADAPTNET-TPU on the tile-config space (labels
    from the oracle); returns (params, test_accuracy, geomean_rel_time),
    the last the TPU cost model's time of each test pick over the best
    (a model number, not a measurement).  Runs on ``device`` (CUDA unless
    the caller names another)."""
    from repro_torch.core import adaptnet as A
    from repro_torch.core.dataset import Dataset, sample_workloads

    feats = sample_workloads(n_samples, dist="loguniform", seed=seed)
    labels = tcm.best_tile_config(feats[:, 0], feats[:, 1],
                                  feats[:, 2]).astype(np.int32)
    ds = Dataset(feats, labels, num_classes=tcm.NUM_TILE_CLASSES)
    tr, te = ds.split()
    res = A.train(tr, te, epochs=epochs, log=log, device=device)
    pred = A.predict(res.params, te.features)
    cost = tcm.tile_cost_seconds(te.features[:, 0], te.features[:, 1],
                                 te.features[:, 2])
    chosen = np.take_along_axis(cost, pred[:, None].astype(int), -1)[:, 0]
    rel = chosen / cost.min(-1)
    geomean = float(np.exp(np.mean(np.log(np.clip(rel, 1.0, None)))))
    return res.params, res.test_accuracy, geomean
