"""Site registry: which GEMM sites executed with which config.

``dispatch.gemm`` records one ``SiteRecord`` per site on every call (the
port runs eagerly; the reference records once per jit trace).  Records
are grouped into named *scopes* (one per engine entry point, e.g.
``prefill_chunk`` or ``decode``) and a site recorded again overwrites its
entry, so reading a scope back gives the plan its last call executed —
how the serving engine derives its ``gemm_plan``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
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
    block_m: int               # executed blocks (clamped to the padded shape)
    block_n: int
    block_k: int
    mode: int
    backend: str               # "kernel" | "torch"
    source: str = "oracle"     # recommendation provenance

    def executed(self) -> Tuple[int, int, int, int]:
        """The tile configuration this site actually ran with (clamped
        blocks + residency mode) — the thing plan-agreement compares."""
        return (self.block_m, self.block_n, self.block_k, self.mode)

    def describe(self) -> str:
        s = (f"bm={self.block_m} bn={self.block_n} bk={self.block_k} "
             f"{DATAFLOW_NAMES[self.mode]} @{self.backend}")
        if self.source != "oracle":
            s += f" src={self.source}"
        return s


class SiteRegistry:
    """Scope -> site-name -> SiteRecord, insertion-ordered."""

    def __init__(self) -> None:
        self._scopes: Dict[str, Dict[str, SiteRecord]] = {}
        self._stack: List[str] = []
        self.records: int = 0          # total record() calls

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
               backend: str, source: str = "oracle") -> SiteRecord:
        rec = SiteRecord(site, m, k, n, cfg, block_m, block_n, block_k,
                         mode, backend, source)
        scope = self._scopes.setdefault(self.current_scope(), {})
        key = site
        if key in scope and (scope[key].m, scope[key].k, scope[key].n) != \
                (m, k, n):
            # same site at a second shape inside one scope
            key = f"{site}[{m}x{k}x{n}]"
        scope[key] = rec
        self.records += 1
        return rec

    # -- read-back -----------------------------------------------------------
    def scopes(self) -> Tuple[str, ...]:
        return tuple(self._scopes)

    def sites(self, scope: Optional[str] = None) -> Dict[str, SiteRecord]:
        return dict(self._scopes.get(scope or self.current_scope(), {}))

    def plan(self, scope: Optional[str] = None) -> Dict[str, str]:
        """The executed plan of a scope: site -> config description."""
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
