"""ADAPTNET — the paper's recommendation network (Fig. 7f), in PyTorch.

The port of ``repro/core/adaptnet.py``.  Architecture: one trainable
embedding table per input feature (M, K, N), concatenated, one 128-unit
hidden layer, softmax over tile-configuration classes.

Two feature encodings (``AdaptNetConfig.encoding``), as in the reference:

  "raw"        the paper's direct per-dim embedding lookup over [0, 10^4];
               dims beyond the table clip, so every dim > 10^4 aliases to
               one row.  The fused ADAPTNETX kernel
               (``kernels/adaptnetx.py``) computes this form.
  "logbucket"  log-spaced bucket embeddings over [1, max_dim] plus per-dim
               continuous features (log2 magnitude and the position within
               the 128/512/2048 alignment periods).  The serving
               dispatcher's nets use it; the params carry their
               ``bucket_edges`` and ``dim_max``, so a checkpoint is
               self-describing.

``logits`` is the torch forward (training, ``predict``).  ``logits_np`` is
a numpy copy of the reference's host twin, which the dispatcher calls on
every cache miss: the same numpy operations on the same arrays, so its
picks are bit for bit the reference's.  Randomness comes from an explicit
``torch.Generator``; ``jax.random`` draws other numbers, so a test starts
both packages from one init by passing the params to ``train``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.dataset import MAX_DIM, Dataset
from repro_torch.optim.adamw import AdamW, apply_updates, cosine_schedule

EMBED_DIM = 16
HIDDEN = 128
VOCAB = MAX_DIM + 1

# logbucket encoding: covers every registry arch's GEMM dims (the largest
# lm_head N is 256000 < 2^18); the alignment periods mirror the tile
# space's block granularities (BLOCK_MN up to 512, BLOCK_K up to 2048)
MAX_DIM_SERVING = 1 << 18
ALIGN_PERIODS = (128.0, 512.0, 2048.0)
N_CONT = 1 + len(ALIGN_PERIODS)          # log2 magnitude + one per period

# the leaves training updates; bucket_edges / dim_max are data
TRAINABLE = ("emb_m", "emb_k", "emb_n", "w1", "b1", "w2", "b2")


@dataclass
class AdaptNetConfig:
    num_classes: int
    embed_dim: int = EMBED_DIM
    hidden: int = HIDDEN
    vocab: int = VOCAB
    encoding: str = "raw"                # "raw" | "logbucket"
    num_buckets: int = 256               # logbucket table rows per feature
    max_dim: int = MAX_DIM_SERVING       # logbucket coverage [1, max_dim]


def init_params(gen: torch.Generator, cfg: AdaptNetConfig
                ) -> Dict[str, torch.Tensor]:
    """Fresh f32 params on ``gen``'s device, drawn from ``gen`` with the
    reference's scales."""
    e = cfg.embed_dim
    if cfg.encoding == "logbucket":
        vocab = cfg.num_buckets
        in_dim = 3 * e + 3 * N_CONT
    elif cfg.encoding == "raw":
        vocab = cfg.vocab
        in_dim = 3 * e
    else:
        raise ValueError(f"unknown encoding {cfg.encoding!r}")
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    f32 = dict(dtype=torch.float32, device=dev)
    params = {
        "emb_m": normal(vocab, e) * 0.02,
        "emb_k": normal(vocab, e) * 0.02,
        "emb_n": normal(vocab, e) * 0.02,
        "w1": normal(in_dim, cfg.hidden) * (1.0 / math.sqrt(in_dim)),
        "b1": torch.zeros(cfg.hidden, **f32),
        "w2": normal(cfg.hidden, cfg.num_classes) *
              (1.0 / math.sqrt(cfg.hidden)),
        "b2": torch.zeros(cfg.num_classes, **f32),
    }
    if cfg.encoding == "logbucket":
        edges = np.geomspace(1.0, cfg.max_dim, cfg.num_buckets + 1)[1:-1]
        params["bucket_edges"] = torch.tensor(edges, **f32)
        params["dim_max"] = torch.tensor(float(cfg.max_dim), **f32)
    return params


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def trained_max_dim(params: Dict) -> int:
    """Largest dim the params' encoding can represent: the recorded
    coverage bound of logbucket params, the embedding-table extent of raw
    params (beyond which lookups alias)."""
    if "dim_max" in params:
        return int(_np(params["dim_max"]))
    return MAX_DIM


def bucket_ids(params: Dict, feats: torch.Tensor) -> torch.Tensor:
    """(B, 3) logbucket row of each dim: the count of interior edges at or
    below it (``searchsorted`` side "right", on f32 values, as the
    reference's both forwards take it)."""
    return torch.searchsorted(params["bucket_edges"],
                              feats.to(torch.float32).contiguous(),
                              right=True)


def _encode_logbucket(params: Dict, feats: torch.Tensor) -> torch.Tensor:
    f = feats.to(torch.float32)
    idx = bucket_ids(params, feats)
    m = params["emb_m"][idx[:, 0]]
    k = params["emb_k"][idx[:, 1]]
    n = params["emb_n"][idx[:, 2]]
    logd = torch.log2(torch.clamp(f, min=1.0)) / math.log2(
        float(MAX_DIM_SERVING))
    cont = [logd] + [torch.remainder(f, p) / p for p in ALIGN_PERIODS]
    return torch.cat([m, k, n] + cont, dim=-1)


def logits(params: Dict, feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, 3) integer (M, K, N) on the params' device -> (B,
    num_classes) f32; the reference's ``logits_fn``."""
    if "bucket_edges" in params:
        h = _encode_logbucket(params, feats)
    else:
        f = feats.long().clamp(0, VOCAB - 1)
        h = torch.cat([params["emb_m"][f[:, 0]], params["emb_k"][f[:, 1]],
                       params["emb_n"][f[:, 2]]], dim=-1)
    # saralint: ok[dispatch-escape] ADAPTNET's own recommender MLP — routing it through dispatch.gemm would recurse into the dispatcher it implements
    h = torch.relu(h @ params["w1"] + params["b1"])
    # saralint: ok[dispatch-escape] ADAPTNET's own recommender MLP — routing it through dispatch.gemm would recurse into the dispatcher it implements
    return h @ params["w2"] + params["b2"]


def logits_np(params: Dict, feats: np.ndarray) -> np.ndarray:
    """The numpy twin of ``logits`` that the dispatcher resolves every
    cache miss through, host-side: a copy of the reference's
    ``logits_np``, so the same arrays give the same bits."""
    p = {k: _np(v) for k, v in params.items()}
    f = np.asarray(feats)
    if "bucket_edges" in p:
        ff = f.astype(np.float32)
        idx = np.searchsorted(p["bucket_edges"], ff, side="right")
        emb = [p["emb_m"][idx[:, 0]], p["emb_k"][idx[:, 1]],
               p["emb_n"][idx[:, 2]]]
        logd = np.log2(np.maximum(ff, 1.0)) / np.log2(float(MAX_DIM_SERVING))
        cont = [logd] + [np.mod(ff, per) / per for per in ALIGN_PERIODS]
        h = np.concatenate(emb + cont, axis=-1, dtype=np.float32)
    else:
        h = np.concatenate([p["emb_m"][np.clip(f[:, 0], 0, VOCAB - 1)],
                            p["emb_k"][np.clip(f[:, 1], 0, VOCAB - 1)],
                            p["emb_n"][np.clip(f[:, 2], 0, VOCAB - 1)]],
                           axis=-1)
    # saralint: ok[dispatch-escape] host-side NumPy twin of the recommender MLP, the dispatcher's own lookup on every cache miss; dispatching it would recurse into itself
    h = np.maximum(h @ p["w1"] + p["b1"], 0.0)
    # saralint: ok[dispatch-escape] host-side NumPy twin of the recommender MLP, the dispatcher's own lookup on every cache miss; dispatching it would recurse into itself
    return h @ p["w2"] + p["b2"]


@torch.no_grad()
def predict(params: Dict, feats: np.ndarray, batch: int = 8192
            ) -> np.ndarray:
    """Argmax class of each (M, K, N) row, in batches on the params'
    device."""
    dev = params["w1"].device
    out = []
    for lo in range(0, len(feats), batch):
        f = torch.as_tensor(np.asarray(feats[lo:lo + batch]), device=dev)
        out.append(logits(params, f).argmax(-1).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.int64)


def accuracy(params: Dict, ds: Dataset) -> float:
    pred = predict(params, ds.features)
    return float(np.mean(pred == ds.labels))


@dataclass
class TrainResult:
    params: Dict
    history: list          # (epoch, train_acc, val_acc)
    test_accuracy: float
    train_seconds: float


def train(train_ds: Dataset, test_ds: Dataset, *, epochs: int = 20,
          batch: int = 1024, lr: float = 3e-3, seed: int = 0,
          log: bool = True, cfg: Optional[AdaptNetConfig] = None,
          device: Optional[str] = None,
          params: Optional[Dict] = None) -> TrainResult:
    """The reference's ``train``: AdamW (no weight decay, clip 1.0) on a
    cosine schedule with ``min(200, total // 10)`` warmup steps, batches in
    the reference's numpy order.  Runs on ``device`` (CUDA unless the
    caller names another); ``params`` is the starting point (default: a
    fresh ``init_params`` from ``seed``), copied to the device."""
    from repro_torch.models.api import resolve_device
    dev = resolve_device(device)
    if cfg is None:
        cfg = AdaptNetConfig(num_classes=train_ds.num_classes)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(gen, cfg)
    params = {k: torch.tensor(_np(v), dtype=torch.float32, device=dev)
              for k, v in params.items()}
    n = len(train_ds.labels)
    steps_per_epoch = n // batch
    total_steps = epochs * steps_per_epoch
    opt = AdamW(lr=cosine_schedule(lr, warmup=min(200, total_steps // 10),
                                   total=total_steps),
                weight_decay=0.0, clip_norm=1.0)
    trained = {k: params[k] for k in TRAINABLE}
    opt_state = opt.init(trained)

    def step(xb, yb):
        nonlocal trained, opt_state
        leaves = {k: v.detach().requires_grad_() for k, v in trained.items()}
        with torch.enable_grad():
            lg = logits({**params, **leaves}, xb)
            lse = torch.logsumexp(lg, dim=-1)
            gold = lg.gather(1, yb[:, None])[:, 0]
            loss = torch.mean(lse - gold)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        acc = torch.mean((lg.detach().argmax(-1) == yb).float())
        updates, opt_state, _ = opt.update(dict(zip(leaves, grads)),
                                           opt_state, trained)
        trained = apply_updates(trained, updates)
        return acc

    rng = np.random.default_rng(seed)
    feats = torch.as_tensor(train_ds.features, device=dev)
    labels = torch.as_tensor(train_ds.labels, device=dev).long()
    hist = []
    t0 = time.time()
    for ep in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        accs = []
        for s in range(steps_per_epoch):
            idx = order[s * batch:(s + 1) * batch]
            accs.append(step(feats[idx], labels[idx]))
        params.update(trained)
        train_acc = float(np.mean(torch.stack(accs).cpu().numpy()
                                  .astype(np.float64))) if accs else 0.0
        val_acc = accuracy(params, test_ds)
        hist.append((ep, train_acc, val_acc))
        if log:
            print(f"  adaptnet epoch {ep}: train_acc={train_acc:.4f} "
                  f"val_acc={val_acc:.4f}")
    return TrainResult(params=params, history=hist,
                       test_accuracy=accuracy(params, test_ds),
                       train_seconds=time.time() - t0)
