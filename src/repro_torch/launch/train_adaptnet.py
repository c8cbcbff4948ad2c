"""ADAPTNET-TPU serving trainer — the offline half of the self-adaptive
loop, ported from ``repro/launch/train_adaptnet.py``.

Trains the recommendation network (logbucket encoding, so lm_head-scale
dims are representable) on a serving-realistic shape distribution,
evaluates it against the tile-space oracle, and saves the params in the
checkpoint manager's layout, which ``SaraDispatcher.from_checkpoint`` and
``serve.py --dispatcher adaptnet`` load (a net saved by either package
loads in the other's ``load_adaptnet``):

  PYTHONPATH=src python -m repro_torch.launch.train_adaptnet \\
      --samples 30000 --epochs 5 --out build/adaptnet --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --dispatcher adaptnet --adaptnet-ckpt build/adaptnet

Training runs on CUDA unless ``--device cpu`` is given.  The shape
distribution mixes

  sites       the (M, K, N) of every GEMM site of the given registry archs
              across decode batch sizes (M = live lanes) and prefill token
              counts, lm_head columns at full vocab included;
  background  log-uniform over [1, max_dim]^3, for shapes outside the
              site list (reduced configs, new architectures).

Labels come from the exhaustive tile-space oracle (closed-form cost
model).  The default archs are the reference's.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import adaptnet as A
from repro_torch.core import tpu_costmodel as tcm
from repro_torch.core.dataset import Dataset, sample_workloads

DECODE_MS = (1, 2, 4, 8, 16, 32, 64)
PREFILL_MS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
DEFAULT_ARCHS = ("llama3.2-1b", "gemma-2b", "qwen2-moe-a2.7b",
                 "deepseek-coder-33b")


def serving_gemm_shapes(archs: Sequence[str] = DEFAULT_ARCHS,
                        ms: Sequence[int] = DECODE_MS + PREFILL_MS,
                        reduced: bool = False
                        ) -> List[Tuple[int, int, int]]:
    """Distinct (M, K, N) of every GEMM site the serving engine would run
    for these architectures across decode/prefill token counts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving.engine import gemm_sites

    shapes = set()
    for name in archs:
        cfg = get_arch(name)
        if reduced:
            cfg = cfg.reduced()
        for m in ms:
            for _, M, K, N in gemm_sites(cfg, m):
                shapes.add((int(M), int(K), int(N)))
    return sorted(shapes)


def build_serving_dataset(n: int, *,
                          shapes: Optional[Sequence[Tuple[int, int, int]]]
                          = None,
                          max_dim: int = A.MAX_DIM_SERVING,
                          site_frac: float = 0.5, seed: int = 0,
                          chunk: int = 100_000) -> Dataset:
    """``site_frac`` of the samples are draws from the serving site list,
    the rest log-uniform background over [1, max_dim]^3."""
    sites = np.asarray(shapes if shapes is not None else
                       serving_gemm_shapes(), np.int64)
    sites = sites[(sites <= max_dim).all(axis=1)]
    if not len(sites):
        raise ValueError(f"no serving shapes fit max_dim={max_dim}")
    rng = np.random.default_rng(seed)
    n_sites = int(n * site_frac)
    feats = np.concatenate([
        sites[rng.integers(0, len(sites), n_sites)],
        sample_workloads(n - n_sites, dist="loguniform", seed=seed + 1,
                         max_dim=max_dim).astype(np.int64),
    ]).astype(np.int32)
    rng.shuffle(feats)
    labels = np.empty(n, np.int32)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        labels[lo:hi] = tcm.best_tile_config(
            feats[lo:hi, 0], feats[lo:hi, 1], feats[lo:hi, 2])
    return Dataset(feats, labels, num_classes=tcm.NUM_TILE_CLASSES)


def train_serving_adaptnet(samples: int = 200_000, epochs: int = 10, *,
                           shapes: Optional[Sequence[Tuple[int, int, int]]]
                           = None,
                           max_dim: int = A.MAX_DIM_SERVING,
                           num_buckets: int = 256, site_frac: float = 0.5,
                           seed: int = 0, log: bool = True,
                           device: Optional[str] = None
                           ) -> Tuple[Dict, dict]:
    """Train ADAPTNET-TPU (logbucket encoding) on the serving shape
    distribution on ``device`` (CUDA unless the caller names another);
    returns (params, info), info carrying the accuracy, the geomean tile
    cost of the picks over the oracle's (the TPU cost model's number, not
    a measurement) and the encoding metadata saved with the checkpoint."""
    ds = build_serving_dataset(samples, shapes=shapes, max_dim=max_dim,
                               site_frac=site_frac, seed=seed)
    tr, te = ds.split()
    cfg = A.AdaptNetConfig(num_classes=ds.num_classes, encoding="logbucket",
                           num_buckets=num_buckets, max_dim=max_dim)
    res = A.train(tr, te, epochs=epochs, seed=seed, log=log, cfg=cfg,
                  device=device)
    pred = A.predict(res.params, te.features)
    cost = tcm.tile_cost_seconds(te.features[:, 0], te.features[:, 1],
                                 te.features[:, 2])
    chosen = np.take_along_axis(cost, pred[:, None].astype(int), -1)[:, 0]
    rel = np.clip(chosen / cost.min(-1), 1.0, None)
    info = {
        "encoding": "logbucket",
        "num_buckets": num_buckets,
        "max_dim": int(max_dim),
        "num_classes": int(ds.num_classes),
        "samples": int(samples),
        "epochs": int(epochs),
        "site_frac": float(site_frac),
        "accuracy": float(res.test_accuracy),
        "geomean_rel_time": float(np.exp(np.mean(np.log(rel)))),
        "train_seconds": float(res.train_seconds),
    }
    return res.params, info


def save_adaptnet(directory: str, params: Dict, info: dict) -> None:
    """Persist a trained ADAPTNET-TPU as a step-0 checkpoint; the params
    (bucket_edges / dim_max included) restore with
    ``core.sara.load_adaptnet`` in either package."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    tree = {k: torch.as_tensor(v) if not isinstance(v, torch.Tensor) else v
            for k, v in params.items()}
    CheckpointManager(directory, keep=1).save(0, tree, metadata=info)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=200_000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--out", default="build/adaptnet",
                    help="checkpoint directory for the trained artifact")
    ap.add_argument("--max-dim", type=int, default=A.MAX_DIM_SERVING)
    ap.add_argument("--buckets", type=int, default=256)
    ap.add_argument("--site-frac", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--quiet", action="store_true")
    a = ap.parse_args(argv)

    params, info = train_serving_adaptnet(
        a.samples, a.epochs, max_dim=a.max_dim, num_buckets=a.buckets,
        site_frac=a.site_frac, seed=a.seed, log=not a.quiet, device=a.device)
    save_adaptnet(a.out, params, info)

    # round-trip through the loader the dispatcher uses, and check a
    # recommendation on a real serving shape (llama3.2-1b lm_head)
    from repro_torch.core.sara import SaraDispatcher, load_adaptnet
    params2, meta = load_adaptnet(a.out)
    assert meta["accuracy"] == info["accuracy"]
    disp = SaraDispatcher(mode="adaptnet", adaptnet_params=params2)
    cfg = disp.recommend(64, 2048, 128256)
    src = disp.source_of(64, 2048, 128256)
    print(f"adaptnet-tpu: acc={info['accuracy']:.4f} "
          f"geomean_rel_time={info['geomean_rel_time']:.4f} (TPU cost "
          f"model) -> saved to {a.out}")
    print(f"  lm_head probe (64x2048x128256): [{cfg.describe()}] src={src}")


if __name__ == "__main__":
    main()
