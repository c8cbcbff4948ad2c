"""Serving telemetry: TTFT, per-request latency percentiles, decode
throughput, slot utilization, SARA recommendation-cache hit rate, and
executed-GEMM dispatch stats (plan reconfigurations, sites per backend).

All timestamps are whatever clock the engine passes in (wall seconds for
live serving, virtual step time for simulated traces) — the math only needs
them to be consistent.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def percentile(xs, q: float) -> Optional[float]:
    """Percentile of a sample list, or ``None`` when there are no samples.

    ``None`` (not 0.0) is load-bearing: a run where no request ever
    completed must not report a perfect p99 — "no measurement" and "a
    measured zero" are different facts, and the old 0.0 silently
    conflated them."""
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


@dataclass
class ServingMetrics:
    ttft: List[float] = field(default_factory=list)         # first token - arrival
    latency: List[float] = field(default_factory=list)      # done - arrival
    queue_delay: List[float] = field(default_factory=list)  # admit - arrival
    decode_steps: int = 0
    decode_tokens: int = 0
    decode_s: float = 0.0
    prefill_tokens: int = 0
    prefill_s: float = 0.0
    slot_occupancy: List[float] = field(default_factory=list)  # active/slots per step
    completed: int = 0
    stalls: int = 0
    preemptions: int = 0
    # terminal failure outcomes (serving/faults.py): requests that left
    # the system without completing, by cause — plus the goodput twin of
    # ``completed``: completions that also met their deadline (what the
    # chaos benchmark reports as in-deadline completions/s)
    failed: int = 0
    expired: int = 0
    shed: int = 0
    cancelled: int = 0
    rejected: int = 0
    completed_in_deadline: int = 0
    # scheduler.plan() gave up a matched prefix under pool pressure and
    # re-admitted as a cache miss — a silent-fallback storm signal
    prefix_cache_fallbacks: int = 0
    # KV rows actually streamed by decode vs what a masked-dense decode
    # over full slot capacity would stream (the paged-arena win)
    kv_read_tokens: int = 0
    kv_read_tokens_dense: int = 0
    # KV rows prefill actually wrote into pages vs the padded-bucket
    # equivalent (the chunked-prefill win: writes scale with real prompt
    # tokens, not bucket shapes)
    prefill_kv_write_rows: int = 0
    prefill_kv_write_rows_padded: int = 0
    # Cross-request prefix cache (serving/prefix_cache.py): prompt tokens /
    # pages an admission mapped from cached pages instead of recomputing,
    # and the analytic prefill FLOPs that avoided (per-token GEMM cost
    # summed over the model's sites at M=1)
    cache_hit_tokens: int = 0
    cache_hit_pages: int = 0
    prefill_flops_saved: float = 0.0
    # Speculative decoding (serving/spec_decode.py): verify steps taken,
    # draft tokens proposed/accepted, bonus tokens committed from the
    # verify argmax, and draft-pool preemptions (draft arena dry -> the
    # lane fell back to a plain C=1 verify that step)
    spec_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_bonus: int = 0
    spec_draft_preempts: int = 0
    # Rolling windows (last ``rolling_window`` samples) so a long run's
    # summary reports live behaviour, not lifetime averages: a regression
    # an hour in is invisible in a lifetime p99 but jumps out of a
    # 64-sample one.
    rolling_window: int = 64
    _ttft_win: deque = field(default_factory=lambda: deque(maxlen=64))
    _latency_win: deque = field(default_factory=lambda: deque(maxlen=64))
    _decode_win: deque = field(default_factory=lambda: deque(maxlen=64))

    def __post_init__(self) -> None:
        if self.rolling_window != 64:
            self._ttft_win = deque(maxlen=self.rolling_window)
            self._latency_win = deque(maxlen=self.rolling_window)
            self._decode_win = deque(maxlen=self.rolling_window)

    # -- recording ------------------------------------------------------------
    def on_first_token(self, arrival: float, t: float) -> None:
        self.ttft.append(t - arrival)
        self._ttft_win.append(t - arrival)

    def on_retire(self, arrival: float, admit: float, t: float,
                  in_deadline: bool = True) -> None:
        self.latency.append(t - arrival)
        self._latency_win.append(t - arrival)
        self.queue_delay.append(admit - arrival)
        self.completed += 1
        if in_deadline:
            self.completed_in_deadline += 1

    def on_finish(self, outcome: str) -> None:
        """One request left the system on a terminal failure outcome
        (``failed`` / ``expired`` / ``shed`` / ``cancelled`` /
        ``rejected`` — see ``serving/faults.py``)."""
        if outcome == "failed":
            self.failed += 1
        elif outcome == "expired":
            self.expired += 1
        elif outcome == "shed":
            self.shed += 1
        elif outcome == "cancelled":
            self.cancelled += 1
        elif outcome == "rejected":
            self.rejected += 1
        else:
            raise ValueError(f"unknown terminal outcome {outcome!r}")

    def ttft_estimate(self) -> Optional[float]:
        """Estimated queue-to-first-token delay for an arriving request:
        the rolling-window TTFT median (live behaviour, not lifetime).
        ``None`` until a first token has been produced — admission
        control must not shed on a guess."""
        return percentile(self._ttft_win, 50)

    def on_prefill(self, tokens: int, seconds: float,
                   kv_write_rows: int = 0,
                   kv_write_rows_padded: int = 0) -> None:
        """One prefill call (a whole padded bucket, or one chunk batch).
        ``kv_write_rows`` counts KV rows committed to the paged arena;
        ``kv_write_rows_padded`` is what the padded-bucket path streams for
        the same work (bucket-shape rows per request)."""
        self.prefill_tokens += tokens
        self.prefill_s += seconds
        self.prefill_kv_write_rows += kv_write_rows
        self.prefill_kv_write_rows_padded += kv_write_rows_padded

    def on_cache_hit(self, tokens: int, pages: int,
                     flops_per_token: float = 0.0) -> None:
        """One admission that matched a cached prefix: ``tokens`` context
        tokens arrived pre-written in ``pages`` shared pages."""
        self.cache_hit_tokens += tokens
        self.cache_hit_pages += pages
        self.prefill_flops_saved += tokens * flops_per_token

    def on_spec_step(self, lanes: int, drafted: int, accepted: int,
                     bonus: int, preempts: int = 0) -> None:
        """One engine step that went through the speculative verify path.
        ``drafted`` counts draft tokens proposed across all ``lanes``,
        ``accepted`` the subset the target's verify pass kept, ``bonus``
        the corrected/extension tokens committed from the verify argmax
        (one per non-stalled lane).  Committed tokens are reported
        separately through :meth:`on_decode_step` so ``decode_tok_s``
        stays comparable with plain decode."""
        self.spec_steps += 1
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_bonus += bonus
        self.spec_draft_preempts += preempts

    def on_decode_step(self, active: int, slots: int, tokens: int,
                       seconds: float, kv_read_tokens: int = 0,
                       kv_read_tokens_dense: int = 0) -> None:
        self.decode_steps += 1
        self.decode_tokens += tokens
        self.decode_s += seconds
        self._decode_win.append((tokens, seconds))
        self.slot_occupancy.append(active / slots if slots else 0.0)
        self.kv_read_tokens += kv_read_tokens
        self.kv_read_tokens_dense += kv_read_tokens_dense

    # -- summary --------------------------------------------------------------
    def summary(self, sara_cache: Dict = None,
                dispatch: Dict = None) -> Dict[str, float]:
        """Lifetime aggregates + ``*_roll`` rolling-window twins.

        Percentile keys are ``None`` when no sample exists (e.g. a run
        where nothing completed) — callers that format or compare must
        treat ``None`` as "not measured", never as zero."""
        win_tok = sum(t for t, _ in self._decode_win)
        win_s = sum(s for _, s in self._decode_win)
        out = {
            "completed": self.completed,
            "completed_in_deadline": self.completed_in_deadline,
            "requests_failed": self.failed,
            "requests_expired": self.expired,
            "requests_shed": self.shed,
            "requests_cancelled": self.cancelled,
            "requests_rejected": self.rejected,
            "prefix_cache_fallbacks": self.prefix_cache_fallbacks,
            "decode_steps": self.decode_steps,
            "ttft_p50_s": percentile(self.ttft, 50),
            "ttft_p99_s": percentile(self.ttft, 99),
            "latency_p50_s": percentile(self.latency, 50),
            "latency_p99_s": percentile(self.latency, 99),
            "queue_delay_p50_s": percentile(self.queue_delay, 50),
            # rolling-window (last rolling_window samples) live behaviour
            "ttft_p50_s_roll": percentile(self._ttft_win, 50),
            "ttft_p99_s_roll": percentile(self._ttft_win, 99),
            "latency_p99_s_roll": percentile(self._latency_win, 99),
            "decode_tok_s_roll": (win_tok / max(win_s, 1e-9)
                                  if self._decode_win else None),
            "decode_tok_s": self.decode_tokens / max(self.decode_s, 1e-9),
            "prefill_tok_s": self.prefill_tokens / max(self.prefill_s, 1e-9),
            "slot_utilization": (float(np.mean(self.slot_occupancy))
                                 if self.slot_occupancy else 0.0),
            "stalls": self.stalls,
            "preemptions": self.preemptions,
            "kv_read_tokens_per_step": (self.kv_read_tokens
                                        / max(self.decode_steps, 1)),
            "kv_read_tokens_dense_per_step": (self.kv_read_tokens_dense
                                              / max(self.decode_steps, 1)),
            # neutral 1.0 when no KV rows were measured (recurrent-state
            # families) instead of a misleading 0x "reduction"
            "kv_read_reduction_x": (self.kv_read_tokens_dense
                                    / max(self.kv_read_tokens, 1)
                                    if self.kv_read_tokens_dense else 1.0),
            "prefill_kv_write_rows": self.prefill_kv_write_rows,
            "prefill_kv_write_rows_padded": self.prefill_kv_write_rows_padded,
            "prefill_kv_write_reduction_x": (
                self.prefill_kv_write_rows_padded
                / max(self.prefill_kv_write_rows, 1)
                if self.prefill_kv_write_rows_padded else 1.0),
            "cache_hit_tokens": self.cache_hit_tokens,
            "cache_hit_pages": self.cache_hit_pages,
            "prefill_flops_saved": self.prefill_flops_saved,
            "spec_steps": self.spec_steps,
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_bonus_tokens": self.spec_bonus,
            "spec_draft_preempts": self.spec_draft_preempts,
            "spec_accept_rate": (self.spec_accepted / self.spec_drafted
                                 if self.spec_drafted else None),
            "spec_accepted_per_step": ((self.spec_accepted + self.spec_bonus)
                                       / self.spec_steps
                                       if self.spec_steps else None),
        }
        if sara_cache:
            hits = sara_cache.get("hits", 0)
            total = hits + sara_cache.get("misses", 0)
            out["sara_cache_hit_rate"] = hits / total if total else 0.0
            out["sara_cache_size"] = sara_cache.get("size", 0)
        if dispatch:
            out.update(dispatch)        # executed-plan stats from the engine
        return out

    def report(self, sara_cache: Dict = None, dispatch: Dict = None) -> str:
        s = self.summary(sara_cache, dispatch)
        def fmt(v):
            if v is None:
                return "n/a (no samples)"
            return f"{v:.4g}" if isinstance(v, float) else str(v)
        return "\n".join(f"  {k:<22} {fmt(v)}" for k, v in s.items())
