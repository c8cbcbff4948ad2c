"""Speculative decoding over the paged KV arena (``repro/serving/
spec_decode.py``).

The engine's spec path (``ServingEngine._spec_decode_step``) splits one
decode step into three moves:

1. **Draft**: a draft model proposes up to ``spec_k`` tokens a lane.  Its
   KV lives in a second page arena under a second :class:`KVBlockPool`
   (the target's page economics: per-request tables, alloc / extend /
   free, preemption when dry).
2. **Verify**: ONE target pass checks every lane's pending token plus its
   drafts through the ragged chunked-prefill kernel
   (``models/serving.paged_verify_step``: C = spec_k + 1 rows a lane,
   logits at every row).  Row i answers "what would greedy decode emit
   after draft i tokens?".
3. **Accept**: :func:`accept_tokens` commits the longest draft prefix the
   verify argmax agrees with, plus one corrected token from the first
   disagreeing row (or a bonus extension when every draft matches).

Every committed token is a target verify argmax, so the generated
sequence equals plain greedy decode's; speculation only changes how many
tokens commit a step.  Rejected drafts need no rollback on either arena:
per-lane lengths do not advance over the rejected rows, and the next
step's writes land at the same positions.  Where target pages are shared
with the prefix cache the engine copies them on write first; draft pages
are never shared.

Draft-KV bookkeeping: ``_rows[rid]`` counts the draft-arena rows that
hold the request's real context.  :meth:`SpecDecoder.draft` first
"catches up" any gap below ``L - 1`` by streaming ``context[rows:L-1]``
through draft prefill chunks, then runs k greedy rounds of the draft's
paged decode step, each feeding the previous round's argmax back on the
device (the reference fuses the rounds in one ``lax.scan``; here they
are k eager calls with no host synchronisation between them, and the
(k, S) tokens come to the host once).  After a commit of c tokens the
engine calls :meth:`SpecDecoder.commit` with the target's new row count
``L + c - 1``: accepted draft rows already hold the right K/V, so the
steady-state catch-up is empty.  The same mechanism covers fresh
admissions (a full-context catch-up), divergence after a rejection, and
readmission after preemption (:meth:`release` drops the rows).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.obs import JitWatch, TraceRecorder
from repro_torch.serving.kv_pool import KVArena, KVBlockPool, PoolError


def accept_tokens(drafts: Sequence[int],
                  verify_argmax: Sequence[int]) -> Tuple[int, List[int]]:
    """The accept rule: the longest matching draft prefix plus one
    corrected token.

    ``drafts`` are the k proposed tokens; ``verify_argmax`` the target's
    greedy picks at the k+1 verify rows (row i conditions on the pending
    token plus drafts < i).  Returns ``(a, committed)``: ``a`` accepted
    draft tokens and ``committed == verify_argmax[:a + 1]`` (in the
    accepted region the argmax equals the draft; entry ``a`` is the
    target's correction, or the bonus token when all were accepted).  The
    caller commits ``committed`` in order, stopping early on EOS."""
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(verify_argmax[a]):
        a += 1
    return a, [int(t) for t in verify_argmax[:a + 1]]


def resolve_draft(cfg: ArchConfig, params, name: str, seed: int):
    """Resolve ``EngineConfig.spec_draft`` to ``(draft_cfg,
    draft_params)``.

    ``"self"`` shares the target's config and params (self-speculation:
    the draft agrees with the verifier, the acceptance upper bound).  Any
    other value names a registry arch: reduced when the target is, sharing
    the params when it resolves to the target's exact config, else with
    fresh params from ``seed + 2`` on the target's device (a draft that
    really disagrees)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.api import build_model
    from repro_torch.models.serving import CHUNKED_PREFILL_FAMILIES

    if name == "self":
        return cfg, params
    draft = get_arch(name)
    if cfg.name.endswith("-reduced"):
        draft = draft.reduced()
    if draft.family not in CHUNKED_PREFILL_FAMILIES:
        raise ValueError(
            f"spec_draft {name!r} has family {draft.family!r}; the draft "
            f"runs the chunked paged path, which supports "
            f"{CHUNKED_PREFILL_FAMILIES}")
    if draft.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"spec_draft {name!r} vocab {draft.vocab_size} != target "
            f"vocab {cfg.vocab_size}: draft tokens must be target tokens")
    if draft == cfg:
        return draft, params
    return draft, build_model(draft, params["embed"].device).init(seed + 2)


class SpecDecoder:
    """The draft side of speculative decoding: the draft model, its page
    pool and arena, and each request's draft row count.

    The engine calls :meth:`draft` (inside its ``spec_draft`` dispatch
    scope), then :meth:`commit` per lane after acceptance, and
    :meth:`release` whenever a request leaves its slot (retire, terminal
    failure, preemption), so draft pages never outlive target pages.

    ``recorder`` (the engine's ``TraceRecorder``) takes the draft pool's
    arena events and the two watched draft calls, ``spec_draft_prefill``
    (a catch-up chunk) and ``spec_draft_loop`` (the k rounds as one
    watched call, so that its compile events match the reference's fused
    ``lax.scan``); without one a private recorder counts them."""

    def __init__(self, draft_cfg: ArchConfig, draft_params, *,
                 num_slots: int, block_size: int, num_blocks: int,
                 max_blocks_per_slot: int, chunk: int, spec_k: int,
                 recorder=None):
        from repro_torch.models.api import build_model

        self.cfg = draft_cfg
        self.params = draft_params
        self.model = build_model(draft_cfg, draft_params["embed"].device)
        self.device = self.model.device
        self.num_slots = num_slots
        self.chunk = max(1, int(chunk))
        self.spec_k = max(1, int(spec_k))
        self._max_blocks = max_blocks_per_slot
        # the target's page economics, with the trailing write-discard
        # page for masked rows; draft pages are private (never shared,
        # pinned or reachable from the prefix cache)
        self.pool = KVBlockPool(num_blocks, block_size)
        self.arena = KVArena(
            self.model.init_paged_arena(num_blocks + 1, block_size),
            block_size)
        self.pool.bind_arena(self.arena)
        rec = recorder if recorder is not None else TraceRecorder()
        self.pool.attach_recorder(rec)
        self._rows: Dict[str, int] = {}
        self._draft_prefill = JitWatch(self.model.paged_prefill_step,
                                       "spec_draft_prefill", rec)
        self._draft_loop = JitWatch(self._loop, "spec_draft_loop", rec)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- lifecycle ------------------------------------------------------------
    def rows(self, rid: str) -> int:
        """Draft-arena rows that hold ``rid``'s real context (0 for a
        request that has not drafted, or was released)."""
        return self._rows.get(rid, 0)

    def commit(self, rid: str, rows: int) -> None:
        """Record the draft row count after acceptance (the target's new
        kv rows: the context minus the new pending token).  Accepted draft
        rows already hold the committed tokens; rows past ``rows`` are
        rejected ones the next catch-up overwrites in place."""
        self._rows[rid] = int(rows)

    def release(self, rid: str) -> None:
        """Drop ``rid``'s draft pages and row count (retired, failed or
        preempted, or a draft-lane preemption under pool pressure).  Safe
        for requests that never drafted."""
        if rid in self.pool.live_requests():
            self.pool.free(rid)
        self._rows.pop(rid, None)

    def live_pages(self) -> int:
        return self.pool.num_in_use

    def check(self) -> None:
        self.pool.check()

    # -- drafting -------------------------------------------------------------
    def _reserve(self, rid: str, num_tokens: int) -> None:
        if rid in self.pool.live_requests():
            table = self.pool.table(rid)
            if table.capacity(self.pool.block_size) >= num_tokens:
                table.num_tokens = max(table.num_tokens, num_tokens)
                return
            self.pool.extend(rid, num_tokens)
        else:
            self.pool.alloc(rid, num_tokens)

    def draft(self, lanes: Dict[int, Tuple[object, int]]
              ) -> Tuple[Dict[int, List[int]], int]:
        """Propose draft tokens for ``lanes`` (slot -> (request, k)).

        Returns ``(drafts, preempts)``: ``drafts[slot]`` is the lane's k
        proposed tokens.  A lane whose draft-page reservation fails is
        draft-preempted: its pages free at once (room for the other
        lanes), it is absent from ``drafts`` (the engine verifies only its
        pending token this step), and it catches up in full once the
        draft pool can hold it again.

        Catch-up chunks and the k rounds are batched over every drafting
        lane at fixed shapes (the chunk width, the table width, spec_k
        rounds); a steady-state step (no catch-up gap) is k decode calls
        and one copy of the tokens to the host."""
        S, C = self.num_slots, self.chunk
        preempts = 0
        jobs: Dict[int, List] = {}     # slot -> [req, k, pos]
        for slot, (req, k) in sorted(lanes.items()):
            if k <= 0:
                continue
            L = req.context_len
            # rows past L-1 may hold rejected drafts of an earlier step;
            # round one re-feeds the pending row, so it yields this
            # step's d_1
            pos = min(self._rows.get(req.rid, 0), L - 1)
            try:
                self._reserve(req.rid, L + k - 1)
            except PoolError:
                self.release(req.rid)
                preempts += 1
                continue
            jobs[slot] = [req, k, pos]
        if not jobs:
            return {}, preempts

        # catch-up: stream context[pos:L-1] through ragged prefill chunks;
        # a steady-state lane (pos == L-1 after a commit) skips it, its
        # only unwritten row being the pending token round one writes
        while any(j[2] < j[0].context_len - 1 for j in jobs.values()):
            toks = np.zeros((S, C), np.int32)
            chunk = np.zeros((S,), np.int32)
            kv = np.zeros((S,), np.int32)
            for slot, (req, k, pos) in sorted(jobs.items()):
                n = min(C, req.context_len - 1 - pos)
                if n <= 0:
                    continue
                toks[slot, :n] = req.context()[pos:pos + n]
                chunk[slot] = n
                kv[slot] = pos
            rids = [jobs[s][0].rid if s in jobs and chunk[s] > 0 else None
                    for s in range(S)]
            tables = self.pool.dense_block_table(rids, self._max_blocks)
            with torch.no_grad():
                # saralint: ok[cow-gate] draft arena pages are private per request (never shared, pinned, or reachable from the prefix cache)
                self._draft_prefill(
                    self.params, self._tensor(toks), self.arena.leaves,
                    self._tensor(tables), self._tensor(kv),
                    self._tensor(chunk))
            for slot in sorted(jobs):
                jobs[slot][2] += int(chunk[slot])

        # the k rounds: every lane feeds its pending token at row L-1 and
        # each round's argmax is the next round's token, on the device.
        # Round i writes a lane's K/V only while i < nwrites[lane], so a
        # lane drafting fewer tokens stops writing (its later tokens are
        # dropped below) and the positions advance by the write mask
        first = np.zeros((S, 1), np.int32)
        kv = np.zeros((S,), np.int32)
        nwrites = np.zeros((S,), np.int32)
        for slot, (req, k, pos) in sorted(jobs.items()):
            first[slot, 0] = req.context()[req.context_len - 1]
            kv[slot] = req.context_len - 1
            nwrites[slot] = k
        rids = [jobs[s][0].rid if s in jobs else None for s in range(S)]
        tables = self.pool.dense_block_table(rids, self._max_blocks)
        with torch.no_grad():
            # saralint: ok[cow-gate] draft arena pages are private per request (never shared, pinned, or reachable from the prefix cache)
            toks = self._draft_loop(
                self.params, self._tensor(first), self.arena.leaves,
                self._tensor(tables), self._tensor(kv),
                self._tensor(nwrites)).cpu().numpy()      # (spec_k, S)
        drafts = {slot: [int(t) for t in toks[:jobs[slot][1], slot]]
                  for slot in jobs}
        for slot, (req, k, pos) in jobs.items():
            self._rows[req.rid] = req.context_len - 1 + k
        return drafts, preempts

    def _loop(self, params, first, leaves, tables, kv, nwrites
              ) -> torch.Tensor:
        """The k draft rounds, (spec_k, S) tokens on the device: round i
        feeds the previous round's argmax and writes a lane's K/V only
        while i < nwrites[lane]."""
        feed, pos, rounds = first, kv, []
        for i in range(self.spec_k):
            wm = (nwrites > i).to(torch.int32)
            # saralint: ok[cow-gate] draft arena pages are private per request (never shared, pinned, or reachable from the prefix cache)
            logits, _ = self.model.paged_decode_step(
                params, feed, leaves, tables, pos, wm)
            nxt = torch.argmax(logits, -1).to(torch.int32)
            rounds.append(nxt)
            feed = nxt[:, None]
            pos = pos + wm
        return torch.stack(rounds)
