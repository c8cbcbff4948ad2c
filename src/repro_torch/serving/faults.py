"""Serving fault model: terminal request outcomes, fault attribution,
and the deterministic chaos-injection harness (the port's copy of
``repro/serving/faults.py``: same outcomes, counters, salts and draws).

Terminal outcomes (the four failure states plus normal completion and
admission rejection) close a request's lifecycle exactly once:

  ``done``       retired normally (budget or EOS)
  ``failed``     a step-level fault (pool/sanitizer) was attributed to
                 this request, or its preemption budget ran out
  ``expired``    its deadline passed while it sat in the queue
  ``shed``       admission control dropped it: the rolling-TTFT estimate
                 of queue delay already exceeded its deadline
  ``cancelled``  the caller revoked it (``Request.cancel()``)
  ``rejected``   it could never be served (invalid shape / larger than
                 the whole pool) and was refused at submit

Fault *attribution* is how the engine's error boundary decides between
failing one request and retrying the whole step: a ``PoolError`` /
``SanitizerError`` that names the request(s) it belongs to (via the
``rids`` attribute, attached with :func:`attach_rids` at the raise site)
fails exactly those requests; an unattributable fault is treated as
transient engine trouble and retried with exponential backoff.

The :class:`FaultInjector` is the serving twin of ``TrainDriver``'s
``fail_injector`` (both schedule through
:class:`repro_torch.runtime.failplan.FaultSchedule`, so the two harnesses
cannot drift): a seed-driven chaos harness that injects

  ``pool_oom``   an attributed :class:`PoolError` against a live request
                 (simulated allocation failure on its lane)
  ``poison``     NaN-poisons one fully-written, exclusively-owned page of
                 a decode lane — the KV-arena sanitizer's poison scan is the
                 detection oracle, so this requires ``sanitize=True``
  ``stall``      forces a lane to skip committing for ``stall_steps``
                 steps (its writes land in the trash page, the token is
                 replayed — a simulated slow/stuck lane)
  ``preempt``    forcibly preempts a mid-prefill lane (exercises the
                 recompute-on-readmit path and the preemption budget)

Every draw is keyed on ``(seed, kind, step)``, so one seed reproduces
one fault sequence bit-for-bit regardless of retries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.failplan import FaultSchedule
from repro_torch.serving.kv_pool import PoolError

# terminal request outcomes (Request.outcome; "" = still live)
OUTCOMES = ("done", "failed", "expired", "shed", "cancelled", "rejected")

# outcome -> the always-on counter it bumps (declared in obs/trace.py
# COUNTERS, the closed taxonomy)
OUTCOME_COUNTERS = {
    "failed": "requests_failed",
    "expired": "requests_expired",
    "shed": "requests_shed",
    "cancelled": "requests_cancelled",
    "rejected": "requests_rejected",
}


def attach_rids(exc: BaseException, rids: Sequence[str]) -> BaseException:
    """Mark an exception as attributable to specific requests.  The
    engine's step error boundary fails exactly these requests instead of
    retrying (or surfacing) the whole step."""
    exc.rids = [str(r) for r in rids]     # type: ignore[attr-defined]
    return exc


def fault_rids(exc: BaseException) -> List[str]:
    """The request ids a fault is attributed to ([] = unattributable)."""
    rids = getattr(exc, "rids", None)
    return [str(r) for r in rids] if rids else []


@dataclass
class ChaosConfig:
    """Knobs for the chaos harness (``EngineConfig.chaos``).  Every
    probability is per engine step; at most one fault of each kind fires
    per step.  ``poison_p > 0`` requires ``EngineConfig.sanitize`` — the
    sanitizer's poison scan is what detects (and therefore contains) the
    injected page, without it the fault would surface as silent garbage
    tokens."""

    seed: int = 0
    pool_oom_p: float = 0.0     # attributed PoolError against a live lane
    poison_p: float = 0.0       # NaN-poison one page of a decode lane
    stall_p: float = 0.0        # force a lane to stall (skip commit)
    stall_steps: int = 2        # how long a forced stall lasts
    preempt_p: float = 0.0      # force-preempt a mid-prefill lane

    def any_enabled(self) -> bool:
        return any(p > 0 for p in (self.pool_oom_p, self.poison_p,
                                   self.stall_p, self.preempt_p))


# stable per-kind RNG salts (changing these reshuffles every seeded
# chaos schedule, so they are part of the reproducibility contract)
_SALTS = {"pool_oom": 1, "poison": 2, "stall": 3, "preempt": 4}


class FaultInjector:
    """Deterministic, seed-driven fault injection for the serving engine.

    The engine offers candidates (live requests / poisonable pages) at
    its injection points; the injector decides *whether* (per-kind
    :class:`FaultSchedule`) and *what* (deterministic victim pick) and
    records every injection as a ``fault`` trace event + the
    ``faults_injected`` counter.  ``injected`` keeps per-kind totals for
    ``summary()`` and the chaos benchmark."""

    def __init__(self, chaos: ChaosConfig, recorder=None):
        self.chaos = chaos
        self.recorder = recorder
        probs = {"pool_oom": chaos.pool_oom_p, "poison": chaos.poison_p,
                 "stall": chaos.stall_p, "preempt": chaos.preempt_p}
        self._sched = {kind: FaultSchedule(chaos.seed, probability=p,
                                           salt=_SALTS[kind])
                       for kind, p in probs.items()}
        self.injected: Dict[str, int] = {k: 0 for k in _SALTS}
        self._stalled_until: Dict[str, int] = {}   # rid -> last forced step

    # -- bookkeeping ---------------------------------------------------------
    def _record(self, kind: str, step: int, rid: str, **args) -> None:
        self.injected[kind] += 1
        if self.recorder is not None:
            self.recorder.count("faults_injected", 1)
            self.recorder.instant("fault", "fault", track="faults",
                                  kind=kind, rid=rid, step=step, **args)

    def total_injected(self) -> int:
        return sum(self.injected.values())

    def summary(self) -> Dict[str, int]:
        return {f"chaos_{k}_injected": v for k, v in self.injected.items()}

    # -- injection points (called by the engine) -----------------------------
    def pool_oom(self, step: int, candidates: Sequence) -> Optional[object]:
        """A simulated allocation failure attributed to one live request;
        returns the victim Request (the engine raises the attributed
        PoolError) or None."""
        if not candidates or not self._sched["pool_oom"].fires(step):
            return None
        victim = candidates[self._sched["pool_oom"].pick(
            step, len(candidates))]
        self._record("pool_oom", step, victim.rid)
        return victim

    def oom_error(self, step: int, req) -> PoolError:
        """The attributed PoolError for a ``pool_oom`` victim."""
        return attach_rids(PoolError(
            f"chaos: injected pool OOM against request {req.rid} "
            f"at step {step}"), [req.rid])

    def poison(self, step: int,
               candidates: Sequence[Tuple[object, List[int]]]
               ) -> Optional[Tuple[object, int]]:
        """Pick a (request, physical page) to NaN-poison, from candidates
        of (request, eligible_pages) — eligible pages are fully-written
        and exclusively owned, so the poison is both guaranteed to be
        streamed by that lane's next decode and invisible to every other
        lane.  Returns None when the schedule does not fire or nothing
        qualifies."""
        candidates = [(r, pages) for r, pages in candidates if pages]
        if not candidates or not self._sched["poison"].fires(step):
            return None
        sched = self._sched["poison"]
        req, pages = candidates[sched.pick(step, len(candidates))]
        page = pages[sched.pick(step + 1_000_003, len(pages))]
        self._record("poison", step, req.rid, page=page)
        return req, page

    def stall_lanes(self, step: int, candidates: Sequence) -> List:
        """Lanes forced to stall this step: ongoing forced stalls plus at
        most one new victim when the schedule fires.  A stall lasts
        ``stall_steps`` engine steps."""
        out = [r for r in candidates
               if self._stalled_until.get(r.rid, -1) >= step]
        fresh = [r for r in candidates
                 if self._stalled_until.get(r.rid, -1) < step]
        if fresh and self._sched["stall"].fires(step):
            victim = fresh[self._sched["stall"].pick(step, len(fresh))]
            self._stalled_until[victim.rid] = \
                step + max(self.chaos.stall_steps, 1) - 1
            self._record("stall", step, victim.rid,
                         steps=self.chaos.stall_steps)
            out.append(victim)
        return out

    def preempt(self, step: int, candidates: Sequence) -> Optional[object]:
        """A mid-prefill lane to forcibly preempt, or None."""
        if not candidates or not self._sched["preempt"].fires(step):
            return None
        victim = candidates[self._sched["preempt"].pick(
            step, len(candidates))]
        self._record("preempt", step, victim.rid)
        return victim
