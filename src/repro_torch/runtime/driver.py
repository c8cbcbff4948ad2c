"""Fault-tolerant training driver — the port of ``repro/runtime/driver.py``,
with the same restart and straggler logic, on the port's checkpoints.

  - periodic async checkpoints (atomic; crash-safe),
  - restart-from-latest on ANY step failure (restore params/opt/loader
    position and continue — the e2e test injects failures and asserts the
    loss trajectory is unaffected),
  - straggler monitor: per-step wall time vs. an EWMA; a step slower than
    `straggler_factor` x EWMA fires the mitigation callback (on real fleets:
    re-slice the job / evict the node; here: recorded + surfaced),
  - on a mesh (``mesh`` and the tree's ``specs`` given) the restart is
    collective: a save gathers every leaf and rank 0 writes it, every rank
    learns whether any rank failed before the step's collectives start,
    and then every rank restores the same step, resharded onto the mesh
    (``checkpoint.restore_resharded``, which also restores a checkpoint
    another mesh wrote: the elastic re-mesh).

Every exception of a step is caught and restored from, so a caller that
must not retry (a kernel that fails) reads ``restarts``.  On a mesh an
exception raised inside the step itself, where peers may wait in a
collective, is raised: the rank leaves, and its peers' collectives fail
rather than wait on it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import (CheckpointManager, restore_resharded,
                                    save_sharded)


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
                 straggler_callback: Optional[Callable] = None,
                 mesh=None, specs: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.specs = specs          # {"params": ..., "opt": ...} on a mesh
        self.train_step = train_step
        self.make_batch = make_batch
        self.fail_injector = fail_injector
        self.straggler_callback = straggler_callback
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep)
        self.events: List[StepEvent] = []
        self.restarts = 0
        self._ewma: Optional[float] = None

    # ------------------------------------------------------------------
    def _save(self, step: int, params, opt_state, blocking: bool):
        tree = {"params": params, "opt": opt_state}
        if self.mesh is None:
            self.ckpt.save(step, tree, metadata={"step": step},
                           blocking=blocking)
        else:
            save_sharded(self.ckpt, step, tree, self.specs, self.mesh,
                         metadata={"step": step}, blocking=blocking)

    def _maybe_checkpoint(self, step: int, params, opt_state, force=False):
        if force or (step > 0 and step % self.cfg.checkpoint_every == 0):
            self._save(step, params, opt_state, blocking=False)

    def _restore(self, params, opt_state):
        self.ckpt.wait()
        tree = {"params": params, "opt": opt_state}
        if self.mesh is None:
            step, tree, _ = self.ckpt.restore(tree)
        else:
            import torch.distributed as dist
            dist.barrier()             # rank 0's write is on disk
            step, tree, _ = restore_resharded(self.cfg.checkpoint_dir, tree,
                                              self.mesh, self.specs)
        return step, tree["params"], tree["opt"]

    def _any_failed(self, failed: bool) -> bool:
        """Whether any rank of the mesh failed (every rank learns it)."""
        if self.mesh is None:
            return failed
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import collective_device
        flag = torch.tensor([float(failed)], device=collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item() > 0)

    # ------------------------------------------------------------------
    def run(self, params, opt_state, *, start_step: int, num_steps: int):
        """Run the loop; returns (params, opt_state, metrics_history)."""
        step = start_step
        history: List[Dict[str, float]] = []
        # initial checkpoint so step-0 failures can restore
        self._save(step, params, opt_state, blocking=True)
        while step < start_step + num_steps:
            agreed = False
            try:
                failed = None
                try:
                    if self.fail_injector is not None:
                        self.fail_injector(step)  # may raise (simulated crash)
                    batch = self.make_batch(step)
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001
                    if self.mesh is None:
                        raise
                    failed = e
                if self._any_failed(failed is not None):
                    raise failed or RuntimeError(
                        f"a peer rank failed before step {step}")
                agreed = True
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
                if self.mesh is not None and agreed:
                    raise              # inside the step's collectives
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}"
                    ) from e
                step, params, opt_state = self._restore(params, opt_state)
        self.ckpt.wait()
        self._maybe_checkpoint(step, params, opt_state, force=True)
        self.ckpt.wait()
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()             # rank 0's last write is on disk
        return params, opt_state, history

    # ------------------------------------------------------------------
    def straggler_report(self) -> Dict[str, float]:
        ss = [e for e in self.events if e.is_straggler]
        return {"steps": len(self.events), "stragglers": len(ss),
                "restarts": self.restarts,
                "mean_step_s": float(np.mean([e.seconds for e in self.events]))
                if self.events else 0.0}
