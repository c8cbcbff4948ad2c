"""Site registry: which GEMM sites executed with which config.

``dispatch.gemm`` records one ``SiteRecord`` per site on every call (the
port runs eagerly; the reference records once per jit trace).  Records
are grouped into named *scopes* (one per engine entry point, e.g.
``prefill_chunk`` or ``decode``) and a site recorded again overwrites its
entry, so reading a scope back gives the plan its last call executed —
how the serving engine derives its ``gemm_plan``.

A record holds two plans.  The recommendation (``cfg`` and the clamped
blocks and mode, ``executed()``) is the tile the reference's Pallas kernel
runs, kept so the port's registry equals the reference's.  The port's
kernel does not run those blocks: its tile, operand roles and split-K are
``kernels/rsa_gemm.py::_psum_plan``'s and only ``block_k`` and the mode
reach it.  What it ran is ``ran``, recorded by the launch itself
(``rsa_gemm_cuda``'s ``on_launch``); it is empty on the torch backend.

With a ``recorder`` (:class:`repro_torch.obs.TraceRecorder`) attached, a
record also emits one ``dispatch`` trace event and counts
``dispatch_records``, as the reference's does at trace time: only inside
a watched model call whose argument signature is new (``JitWatch``, the
port's stand-in for a trace), once a (scope, site, shape) in that call,
so eager repeats (a site in every layer, every draft round) and calls of
a signature already seen emit nothing.  Outside every watched call each
record emits, as an eager call of the reference's does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hw import DATAFLOW_NAMES
from repro_torch.core.tpu_costmodel import TPUTileConfig


@dataclass(frozen=True)
class SiteRecord:
    site: str
    m: int
    k: int
    n: int
    cfg: TPUTileConfig         # the dispatcher's recommendation
    block_m: int               # its blocks, clamped to the padded shape
    block_n: int
    block_k: int
    mode: int
    backend: str               # "kernel" | "torch"
    source: str = "oracle"     # recommendation provenance
    shard_plan: str = ""       # mesh-level plan name ("" when meshless)
    # what the card ran, by role ("fwd"; a differentiable 2-D GEMM's
    # backward adds "dx" and "dw"): kernels/rsa_gemm.py's RanPlan, set by
    # each launch; empty on the torch backend
    ran: Dict[str, object] = field(default_factory=dict, compare=False,
                                   repr=False)

    def executed(self) -> Tuple[int, int, int, int]:
        """The recommendation the reference executes for this site
        (clamped blocks + residency mode), the thing plan agreement
        compares.  The port's kernel runs ``ran_plan()`` instead."""
        return (self.block_m, self.block_n, self.block_k, self.mode)

    def ran_plan(self):
        """The plan the card ran for this site's forward GEMM (a
        ``RanPlan``), or None (the torch backend, or not launched yet)."""
        return self.ran.get("fwd")

    def recommendation(self) -> str:
        """The recommendation, its backend and provenance, as text."""
        s = (f"bm={self.block_m} bn={self.block_n} bk={self.block_k} "
             f"{DATAFLOW_NAMES[self.mode]} @{self.backend}")
        if self.source != "oracle":
            s += f" src={self.source}"
        if self.shard_plan:
            s += f" shard={self.shard_plan}"
        return s

    def describe(self) -> str:
        """The recommendation, then what the card ran, if it ran."""
        ran = self.ran_plan()
        return self.recommendation() + \
            (f" ran[{ran.describe()}]" if ran is not None else "")


class SiteRegistry:
    """Scope -> site-name -> SiteRecord, insertion-ordered; with a
    ``recorder``, a ``dispatch`` trace event per site a trace records."""

    def __init__(self, recorder=None) -> None:
        self._scopes: Dict[str, Dict[str, SiteRecord]] = {}
        self._stack: List[str] = []
        self.records: int = 0          # total record() calls
        self.recorder = recorder

    # -- scoping -------------------------------------------------------------
    @contextlib.contextmanager
    def scope(self, name: str):
        self._stack.append(name)
        try:
            yield self
        finally:
            self._stack.pop()

    def current_scope(self) -> str:
        return self._stack[-1] if self._stack else "_"

    # -- recording (called by dispatch.gemm on every call) -------------------
    def record(self, site: str, m: int, k: int, n: int, cfg: TPUTileConfig,
               block_m: int, block_n: int, block_k: int, mode: int,
               backend: str, source: str = "oracle",
               shard_plan: str = "") -> SiteRecord:
        rec = SiteRecord(site, m, k, n, cfg, block_m, block_n, block_k,
                         mode, backend, source, shard_plan)
        scope = self._scopes.setdefault(self.current_scope(), {})
        key = site
        if key in scope and (scope[key].m, scope[key].k, scope[key].n) != \
                (m, k, n):
            # same site at a second shape inside one scope
            key = f"{site}[{m}x{k}x{n}]"
        scope[key] = rec
        self.records += 1
        if self.recorder is not None:
            tracing = getattr(self.recorder, "tracing", None)
            if tracing is None:
                self._emit(rec)          # eager: every call records
            elif tracing and (self.current_scope(), key) not in \
                    self.recorder.traced:
                self.recorder.traced.add((self.current_scope(), key))
                self._emit(rec)
        return rec

    def _emit(self, rec: SiteRecord) -> None:
        """One ``dispatch`` trace event per recorded site (trace time)."""
        self.recorder.count("dispatch_records")
        if not self.recorder.spans:
            return
        from repro_torch.core.tpu_costmodel import tile_cost_seconds
        costs = tile_cost_seconds(rec.m, rec.k, rec.n)
        self.recorder.instant(
            "dispatch", f"{self.current_scope()}/{rec.site}",
            track="dispatch", site=rec.site, scope=self.current_scope(),
            m=rec.m, k=rec.k, n=rec.n,
            block_m=rec.block_m, block_n=rec.block_n, block_k=rec.block_k,
            mode=DATAFLOW_NAMES[rec.mode], backend=rec.backend,
            source=rec.source,
            cost_s=float(costs[rec.cfg.class_id]),
            cost_best_s=float(costs.min()))

    # -- read-back -----------------------------------------------------------
    def scopes(self) -> Tuple[str, ...]:
        return tuple(self._scopes)

    def sites(self, scope: Optional[str] = None) -> Dict[str, SiteRecord]:
        return dict(self._scopes.get(scope or self.current_scope(), {}))

    def plan(self, scope: Optional[str] = None) -> Dict[str, str]:
        """A scope's plan: site -> the recommendation and, for a site the
        kernel ran, what it ran (``SiteRecord.describe``)."""
        return {name: rec.describe()
                for name, rec in self._scopes.get(scope or
                                                  self.current_scope(),
                                                  {}).items()}

    def backends(self, scope: Optional[str] = None) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self._scopes.get(scope or self.current_scope(),
                                    {}).values():
            out[rec.backend] = out.get(rec.backend, 0) + 1
        return out

    def sources(self, scope: Optional[str] = None) -> Dict[str, int]:
        """Recommendation provenance per executed site of a scope."""
        out: Dict[str, int] = {}
        for rec in self._scopes.get(scope or self.current_scope(),
                                    {}).values():
            out[rec.source] = out.get(rec.source, 0) + 1
        return out

    def clear(self) -> None:
        self._scopes.clear()
        self.records = 0
