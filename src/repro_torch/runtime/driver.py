"""Fault-tolerant training driver — the port of ``repro/runtime/driver.py``,
with the same restart and straggler logic, on the port's checkpoints.

  - periodic async checkpoints (atomic; crash-safe),
  - restart-from-latest on ANY step failure (restore params/opt/loader
    position and continue — the e2e test injects failures and asserts the
    loss trajectory is unaffected),
  - straggler monitor: per-step wall time vs. an EWMA; a step slower than
    `straggler_factor` x EWMA fires the mitigation callback (on real fleets:
    re-slice the job / evict the node; here: recorded + surfaced),
  - elastic re-mesh is not ported: one device has no mesh.

Every exception of a step is caught and restored from, so a caller that
must not retry (a kernel that fails) reads ``restarts``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


@dataclass
class DriverConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    max_restarts: int = 10


@dataclass
class StepEvent:
    step: int
    seconds: float
    is_straggler: bool
    metrics: Dict[str, float]


class TrainDriver:
    def __init__(self, cfg: DriverConfig, *, train_step: Callable,
                 make_batch: Callable[[int], Any],
                 fail_injector: Optional[Callable[[int], None]] = None,
                 straggler_callback: Optional[Callable] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.make_batch = make_batch
        self.fail_injector = fail_injector
        self.straggler_callback = straggler_callback
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep)
        self.events: List[StepEvent] = []
        self.restarts = 0
        self._ewma: Optional[float] = None

    # ------------------------------------------------------------------
    def _maybe_checkpoint(self, step: int, params, opt_state, force=False):
        if force or (step > 0 and step % self.cfg.checkpoint_every == 0):
            self.ckpt.save(step, {"params": params, "opt": opt_state},
                           metadata={"step": step}, blocking=False)

    def _restore(self, params, opt_state):
        step, tree, _ = self.ckpt.restore(
            {"params": params, "opt": opt_state})
        return step, tree["params"], tree["opt"]

    # ------------------------------------------------------------------
    def run(self, params, opt_state, *, start_step: int, num_steps: int):
        """Run the loop; returns (params, opt_state, metrics_history)."""
        step = start_step
        history: List[Dict[str, float]] = []
        # initial checkpoint so step-0 failures can restore
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       metadata={"step": step}, blocking=True)
        while step < start_step + num_steps:
            try:
                if self.fail_injector is not None:
                    self.fail_injector(step)     # may raise (simulated crash)
                batch = self.make_batch(step)
                t0 = time.time()
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                straggler = (self._ewma is not None and
                             dt > self.cfg.straggler_factor * self._ewma)
                if straggler and self.straggler_callback is not None:
                    self.straggler_callback(step, dt, self._ewma)
                a = self.cfg.ewma_alpha
                self._ewma = dt if self._ewma is None else \
                    (1 - a) * self._ewma + a * dt
                self.events.append(StepEvent(step, dt, straggler, metrics))
                history.append({"step": step, **metrics})
                step += 1
                self._maybe_checkpoint(step, params, opt_state)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — node failure path
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}"
                    ) from e
                self.ckpt.wait()
                step, params, opt_state = self._restore(params, opt_state)
        self.ckpt.wait()
        self._maybe_checkpoint(step, params, opt_state, force=True)
        self.ckpt.wait()
        return params, opt_state, history

    # ------------------------------------------------------------------
    def straggler_report(self) -> Dict[str, float]:
        ss = [e for e in self.events if e.is_straggler]
        return {"steps": len(self.events), "stragglers": len(ss),
                "restarts": self.restarts,
                "mean_step_s": float(np.mean([e.seconds for e in self.events]))
                if self.events else 0.0}
