"""Deterministic synthetic LM data pipeline — a copy of
``repro/data/pipeline.py`` (pure numpy), so the port's batches are the
reference's bit for bit.

Generates a learnable token stream (noisy affine bigram process) so e2e
training shows a real loss drop below the uniform-entropy floor.  The
stream is a pure function of (seed, shard, step): restart-safe (a resumed
run sees exactly the data it would have seen), and host-shardable (each
data-parallel host generates only its rows).

A background thread prefetches `prefetch` batches ahead.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    noise: float = 0.05       # fraction of tokens resampled uniformly
    # host sharding: this host generates rows [row_start, row_start+rows)
    row_start: int = 0
    rows: Optional[int] = None

    @property
    def local_rows(self) -> int:
        return self.rows if self.rows is not None else self.global_batch


def _batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Tokens (local_rows, seq_len + 1) — pure function of (cfg, step)."""
    V = cfg.vocab_size
    out = np.empty((cfg.local_rows, cfg.seq_len + 1), np.int32)
    for i in range(cfg.local_rows):
        row = cfg.row_start + i
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row]))
        a = 31 % V or 1
        c = 17 % V
        t = np.empty(cfg.seq_len + 1, np.int64)
        t[0] = rng.integers(0, V)
        noise = rng.random(cfg.seq_len) < cfg.noise
        rand = rng.integers(0, V, cfg.seq_len)
        for j in range(cfg.seq_len):
            t[j + 1] = rand[j] if noise[j] else (a * t[j] + c) % V
        out[i] = t.astype(np.int32)
    return {"tokens": out}


class Loader:
    """Iterator over batches with background prefetch + seekable step."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put((s, _batch(self.cfg, s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        s, b = self._q.get()
        self.step = s + 1
        return b

    def close(self):
        self._stop.set()


def make_loader(vocab_size: int, seq_len: int, global_batch: int,
                seed: int = 1234, start_step: int = 0, **kw) -> Loader:
    return Loader(DataConfig(vocab_size=vocab_size, seq_len=seq_len,
                             global_batch=global_batch, seed=seed, **kw),
                  start_step=start_step)
