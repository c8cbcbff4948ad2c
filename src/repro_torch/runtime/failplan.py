"""Seeded fail-injection scheduling shared by the training and serving
fault harnesses (the port's copy of ``repro/runtime/failplan.py``; its
numpy draws are the reference's bit for bit).

Both fault-tolerance loops in this repo need the same primitive: "does a
simulated fault fire at step N?", answered deterministically from a seed
so a failing run can be replayed bit-for-bit.  ``TrainDriver``'s
``fail_injector`` used to hand-roll this per test (a ``fail_steps`` set
plus a ``fired`` set so a restored step does not re-fire); the serving
chaos harness (``serving/faults.py``) needs the probability-scheduled
variant.  One utility keeps the two harnesses from drifting.

:class:`FaultSchedule` supports both trigger styles:

  * explicit steps (``steps={5, 11}``) — the restart tests' style;
  * per-step probability (``probability=0.05``) — the chaos harness's
    style, drawn from a counter-based RNG keyed on ``(seed, salt,
    step)`` so the outcome for a given step is independent of how many
    other draws happened before it (retries and replays see the same
    schedule).

``fires`` marks each firing step so a step replayed after a restore does
not fail forever (``once=True``, the default); ``peek`` answers without
consuming.  ``pick`` derives a deterministic victim index for the same
step, for harnesses that must also choose *what* to break.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Set, Type

import numpy as np


class FaultSchedule:
    """Deterministic fail-injection trigger: explicit steps and/or a
    per-step probability, seeded and replay-stable."""

    def __init__(self, seed: int = 0, probability: float = 0.0,
                 steps: Iterable[int] = (), salt: int = 0,
                 once: bool = True):
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got "
                             f"{probability}")
        self.seed = int(seed)
        self.probability = float(probability)
        self.steps: Set[int] = set(int(s) for s in steps)
        self.salt = int(salt)
        self.once = once
        self.fired: Set[int] = set()

    def _draw(self, step: int, stream: int) -> np.random.Generator:
        # counter-based: one generator per (seed, salt, step, stream), so
        # the answer for a step never depends on draw order or retries
        return np.random.default_rng(
            (self.seed, self.salt, int(step), stream))

    def peek(self, step: int) -> bool:
        """Would a fault fire at ``step``?  Does not consume the firing."""
        if step in self.steps:
            return True
        if self.probability <= 0.0:
            return False
        return bool(self._draw(step, 0).random() < self.probability)

    def fires(self, step: int) -> bool:
        """True when a fault fires at ``step``.  With ``once`` (default)
        each step fires at most one fault, so a step replayed after a
        restart/restore makes progress instead of failing forever."""
        if self.once and step in self.fired:
            return False
        if not self.peek(step):
            return False
        self.fired.add(step)
        return True

    def pick(self, step: int, n: int) -> int:
        """Deterministic victim index in ``[0, n)`` for ``step`` — the
        'what breaks' companion draw to ``fires``'s 'when'."""
        if n <= 0:
            raise ValueError("pick needs n >= 1")
        return int(self._draw(step, 1).integers(n))


def make_fail_injector(schedule: FaultSchedule,
                       exc_type: Type[BaseException] = RuntimeError,
                       message: str = "injected fault"
                       ) -> Callable[[int], None]:
    """Adapt a :class:`FaultSchedule` to ``TrainDriver``'s
    ``fail_injector`` interface: a callable of the step index that raises
    when the schedule fires."""

    def injector(step: int) -> None:
        if schedule.fires(step):
            raise exc_type(f"{message} at step {step}")

    return injector
