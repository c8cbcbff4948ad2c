"""Paged KV-cache block pool + the physical arena it meters.

The pool divides the KV-cache budget into fixed-size blocks of
``block_size`` tokens and hands them out to requests on demand — the
admission-control half of continuous batching (cf. the paged backends in
vLLM/flashinfer).  Each live request owns a *block table*: the ordered list
of physical block ids backing its logical token range.  Blocks are
allocated lazily as a request's sequence crosses block boundaries and all
return to the free list when the request retires, so short requests stop
holding memory the moment they finish instead of at the end of a wave.

Physical layout: a pool can be *bound* to a :class:`KVArena` — the
per-layer K/V page tensors ``(layers, num_blocks + 1, block_size, *feat)``
the paged attention kernels (``kernels/paged_attn.py``) reads through dense
per-slot block tables.  Pool block id ``b`` IS arena page ``b``; the
arena's one extra trailing block is the engine's write-discard scratch for
masked decode lanes and is never pool-allocated.  ``defrag()`` computes the
{old: new} remapping that compacts live block tables to the front AND
applies it to the bound arena as one batched gather over the page axis, so
the freed tail is physically contiguous (the flashinfer-style layout the
ROADMAP named).  Unbound pools (the engine's dense fallback layout) keep
defrag as pure bookkeeping, exactly as before.

Sharing (prefix caching): pages are *refcounted*.  ``share(rid, pages)``
maps already-written pages into a new request's table without copying —
the vLLM block-pool move that makes cross-request prefix reuse free.  Two
counters guard each page: ``_refs`` (how many block tables name it) and
``_pins`` (whether the prefix cache holds it); a page returns to the free
list only when both hit zero.  ``ensure_writable(rid, i)`` is the
copy-on-write gate: before a request writes into logical page ``i``, a
page that is shared (refs > 1) or cached (pinned) is replaced by a fresh
private copy (one page gather in the bound arena), so the sibling readers
never observe the write.  ``defrag()`` moves only exclusively-owned,
unpinned pages — shared/pinned pages are landmarks other tables and the
cache index at by physical id.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


class PoolError(RuntimeError):
    pass


class SanitizerError(PoolError):
    """A sanitize-mode trap fired: use-after-free through a stale block
    table, a poisoned page read, or a refcount/pin leak at teardown."""


class KVArena:
    """Physical KV pages for a :class:`KVBlockPool`.

    ``leaves`` maps names (``"k"``/``"v"``) to page tensors shaped
    ``(layers, num_blocks + 1, block_size, *feat)`` — built by
    ``models/serving.py::init_paged_arena``.  The trailing page is the
    write-discard scratch (``trash_block``).  The leaves are torch tensors
    updated in place: the model's prefill/decode steps write rows into
    them, and ``apply_moves`` / ``copy_page`` / ``poison_page`` rewrite
    pages in place (the reference rebuilds its jnp arrays).
    """

    def __init__(self, leaves: Dict[str, Any], block_size: int):
        shapes = {k: v.shape for k, v in leaves.items()}
        nb = {s[1] for s in shapes.values()}
        bsz = {s[2] for s in shapes.values()}
        if len(nb) != 1 or bsz != {block_size}:
            raise ValueError(f"inconsistent arena leaves: {shapes}")
        self.leaves = leaves
        self.block_size = block_size
        self.num_blocks = nb.pop() - 1       # pool-allocatable pages

    @property
    def trash_block(self) -> int:
        return self.num_blocks

    def apply_moves(self, moves: Dict[int, int]) -> int:
        """Mirror a defrag move map in storage: one batched gather per leaf
        over the page axis (new page ``n`` takes old page ``moves^-1(n)``;
        untouched pages — including the trash page — map to themselves).
        Returns the number of pages moved."""
        if not moves:
            return 0
        src = np.arange(self.num_blocks + 1)
        for old, new in moves.items():
            src[new] = old
        for leaf in self.leaves.values():
            idx = torch.as_tensor(src, device=leaf.device)
            leaf.copy_(leaf.index_select(1, idx))
        return len(moves)

    def copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page (copy-on-write divergence): every leaf's
        page ``dst`` becomes a copy of page ``src``."""
        for leaf in self.leaves.values():
            leaf[:, dst].copy_(leaf[:, src])

    def poison_page(self, bid: int) -> None:
        """Sanitize mode: fill a just-freed page with NaN so any read
        through a stale block table surfaces as NaN logits instead of
        silently serving another request's KV rows.  Never applied to the
        trash page — masked-lane writes legitimately land there."""
        for leaf in self.leaves.values():
            leaf[:, bid].fill_(float("nan"))

    def unpoison_page(self, bid: int) -> None:
        """Sanitize mode: zero a page on (re-)allocation, restoring the
        fresh-arena state, so poison lives only on free pages."""
        for leaf in self.leaves.values():
            leaf[:, bid].zero_()


@dataclass
class BlockTable:
    """Ordered physical block ids backing one request's token range."""

    request_id: str
    blocks: List[int] = field(default_factory=list)
    num_tokens: int = 0

    def capacity(self, block_size: int) -> int:
        return len(self.blocks) * block_size


class KVBlockPool:
    """Fixed-size-block KV allocator with per-request block tables.

    The admission-control half of paged KV: ``alloc`` / ``extend`` /
    ``free`` move blocks between the free list and per-request
    :class:`BlockTable`\\ s, ``can_alloc`` / ``blocks_for`` answer the
    scheduler's budget questions, ``dense_block_table`` materializes the
    (slots, width) int32 tables the paged kernels consume, and ``defrag``
    compacts live blocks to the front (mirroring moves into the bound
    :class:`KVArena`'s storage when one is attached via ``bind_arena``).
    ``check()`` asserts the ownership invariants; tests call it after
    every scenario.

    Pages are refcounted for cross-request sharing: ``share`` maps live
    pages into a new table, ``pin``/``unpin`` add a cache reference, and
    ``ensure_writable`` performs copy-on-write before a request mutates a
    page other owners can still see."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 sanitize: bool = False):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(num_blocks))
        self._refs: List[int] = [0] * num_blocks   # block-table references
        self._pins: List[int] = [0] * num_blocks   # prefix-cache references
        self._tables: Dict[str, BlockTable] = {}
        self.peak_in_use = 0
        self.arena: Optional[KVArena] = None
        self.defrag_moves = 0          # lifetime pages moved by defrag()
        self.shared_pages = 0          # lifetime pages mapped via share()
        self.cow_copies = 0            # lifetime copy-on-write divergences
        # sanitize mode: freed pages are NaN-poisoned in the bound arena
        # and every allocation bumps the page's generation counter, so a
        # stale block table (use-after-free) is trappable by generation
        # mismatch or by poison surfacing in decode logits.
        self.sanitize = sanitize
        self._gen: List[int] = [0] * num_blocks    # bumped per allocation
        self.poison_fills = 0          # lifetime pages NaN-poisoned
        self.generation_faults = 0     # stale-table traps fired
        self.sanitize_checks = 0       # check()/assert_generations runs
        # optional trace sink (an object with ``count`` / ``instant``):
        # reserve / grow / free / defrag / share / cow land as "arena"
        # events + counters
        self.recorder = None

    def attach_recorder(self, recorder) -> None:
        self.recorder = recorder

    def _trace(self, name: str, rid: str, blocks: int, **args) -> None:
        if self.recorder is None:
            return
        self.recorder.count(f"kv_{name}_blocks", blocks)
        self.recorder.instant("arena", name, track="arena", rid=rid,
                              blocks=blocks, in_use=self.num_in_use, **args)

    def bind_arena(self, arena: KVArena) -> None:
        """Attach physical page storage; defrag() moves now mirror into it."""
        if arena.num_blocks != self.num_blocks or \
                arena.block_size != self.block_size:
            raise ValueError(
                f"arena ({arena.num_blocks} blocks x {arena.block_size}) "
                f"does not match pool ({self.num_blocks} x {self.block_size})")
        self.arena = arena

    # -- accounting ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-max(num_tokens, 0) // self.block_size)

    def can_alloc(self, num_tokens: int) -> bool:
        return self.blocks_for(num_tokens) <= self.num_free

    def utilization(self) -> float:
        return self.num_in_use / self.num_blocks

    def fragmentation(self) -> float:
        """Fraction of live block-table adjacencies that are physically
        non-contiguous (0.0 = fully compact)."""
        pairs = jumps = 0
        for t in self._tables.values():
            for a, b in zip(t.blocks, t.blocks[1:]):
                pairs += 1
                jumps += b != a + 1
        return jumps / pairs if pairs else 0.0

    def table(self, request_id: str) -> BlockTable:
        return self._tables[request_id]

    def live_requests(self) -> List[str]:
        return list(self._tables)

    @staticmethod
    def table_width(need: int, cap: int) -> int:
        """Block-table width for the paged decode kernel: the needed page
        count rounded up to a power of two (one jit compilation per width
        bucket), clamped to the per-slot maximum."""
        width = 1
        while width < need:
            width *= 2
        return max(1, min(width, cap))

    def dense_block_table(self, rids: Sequence[Optional[str]],
                          width: int) -> np.ndarray:
        """(len(rids), width) int32 block table for the paged decode kernel:
        row i holds ``rids[i]``'s block ids in logical order, tail-padded
        with the last live id (consecutive grid steps mapping to the same
        page elide the DMA); ``None``/empty rows are all zeros (the kernel
        masks them out via length 0)."""
        t = np.zeros((len(rids), width), np.int32)
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            blocks = self._tables[rid].blocks[:width]
            if blocks:
                t[i, :len(blocks)] = blocks
                t[i, len(blocks):] = blocks[-1]
        return t

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def pincount(self, bid: int) -> int:
        return self._pins[bid]

    def generation(self, bid: int) -> int:
        return self._gen[bid]

    # -- sanitizer: generation tags + leak audit -----------------------------
    def table_generations(self, rids: Sequence[Optional[str]],
                          width: int) -> np.ndarray:
        """Generation stamp per :meth:`dense_block_table` entry, captured
        at table-build time.  ``assert_generations`` replays the pair to
        trap tables consumed after their pages were reclaimed."""
        g = np.zeros((len(rids), width), np.int64)
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            blocks = self._tables[rid].blocks[:width]
            if blocks:
                gens = [self._gen[b] for b in blocks]
                g[i, :len(gens)] = gens
                g[i, len(gens):] = gens[-1]
        return g

    def assert_generations(self, rids: Sequence[Optional[str]],
                           tables: np.ndarray, gens: np.ndarray) -> None:
        """Trap use-after-free through a stale block table: every
        (page, generation) pair captured when the table was built must
        still be current — a page freed and re-allocated since then
        carries a later generation.  Raises :class:`SanitizerError`."""
        self.sanitize_checks += 1
        tables = np.asarray(tables)
        gens = np.asarray(gens)
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            for j in range(tables.shape[1]):
                bid = int(tables[i, j])
                if self._gen[bid] != int(gens[i, j]):
                    self.generation_faults += 1
                    err = SanitizerError(
                        f"use-after-free: lane {i} ({rid}) block table names "
                        f"page {bid} at generation {int(gens[i, j])} but the "
                        f"page is now generation {self._gen[bid]} — it was "
                        "reclaimed and re-allocated after the table was "
                        "built")
                    # structured attribution: the engine's fault boundary
                    # fails exactly this request instead of the engine
                    err.rids = [str(rid)]
                    raise err

    def audit_leaks(self, expected_pins: Optional[Sequence[int]] = None
                    ) -> Dict[str, int]:
        """Teardown audit: after every request drains, no table may
        survive, no page may keep a table reference, and the pinned set
        must equal ``expected_pins`` (the prefix-cache trie's pages).
        Raises :class:`SanitizerError` on any leak; returns the totals
        the engine folds into ``summary()``."""
        if self._tables:
            raise SanitizerError(
                f"leak audit: {len(self._tables)} block table(s) never "
                f"freed: {sorted(self._tables)[:8]}")
        leaked = [b for b in range(self.num_blocks) if self._refs[b] != 0]
        if leaked:
            raise SanitizerError(
                f"leak audit: {len(leaked)} page(s) keep table references "
                f"with no live table: {leaked[:8]}")
        pinned = {b for b in range(self.num_blocks) if self._pins[b] > 0}
        if expected_pins is not None:
            expect = set(expected_pins)
            if pinned != expect:
                raise SanitizerError(
                    "leak audit: pinned pages disagree with the prefix "
                    f"cache trie (pinned-not-in-trie: "
                    f"{sorted(pinned - expect)[:8]}, trie-not-pinned: "
                    f"{sorted(expect - pinned)[:8]})")
        self.check()
        return {
            "kv_leaked_tables": 0,
            "kv_leaked_refs": 0,
            "kv_pinned_pages": len(pinned),
            "kv_poison_fills": self.poison_fills,
        }

    # -- alloc / extend / free ----------------------------------------------
    def _take_block(self, request_id: str) -> int:
        bid = self._free.popleft()
        if self._refs[bid] or self._pins[bid]:
            raise PoolError(f"block {bid} double-allocated "
                            f"(refs={self._refs[bid]} pins={self._pins[bid]} "
                            f"-> {request_id})")
        self._refs[bid] = 1
        self._gen[bid] += 1
        if self.sanitize and self.arena is not None:
            # saralint: ok[cow-gate] the page was just taken from the free list: its refcount is 1 and its taker the only reader
            self.arena.unpoison_page(bid)
        return bid

    def _release_block(self, bid: int) -> None:
        """A page's last reference dropped: return it to the free list and,
        under sanitize with bound storage, NaN-poison its rows."""
        self._free.append(bid)
        if self.sanitize and self.arena is not None:
            # saralint: ok[cow-gate] the page's last reference and pin just dropped: no block table or trie entry maps it
            self.arena.poison_page(bid)
            self.poison_fills += 1

    def alloc(self, request_id: str, num_tokens: int) -> BlockTable:
        """Reserve blocks covering ``num_tokens`` for a new request."""
        if request_id in self._tables:
            raise PoolError(f"request {request_id} already has a block table")
        need = self.blocks_for(num_tokens)
        if need > self.num_free:
            raise PoolError(f"OOM: need {need} blocks, {self.num_free} free")
        t = BlockTable(request_id)
        for _ in range(need):
            t.blocks.append(self._take_block(request_id))
        t.num_tokens = num_tokens
        self._tables[request_id] = t
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        self._trace("reserve", request_id, need, tokens=num_tokens)
        return t

    def extend(self, request_id: str, num_tokens: int) -> List[int]:
        """Grow a request's table to cover ``num_tokens`` total; returns the
        newly allocated block ids (empty if capacity already suffices)."""
        t = self._tables[request_id]
        if num_tokens < t.num_tokens:
            raise PoolError("extend cannot shrink a table")
        need = self.blocks_for(num_tokens) - len(t.blocks)
        if need > self.num_free:
            raise PoolError(f"OOM: need {need} blocks, {self.num_free} free")
        new = [self._take_block(request_id) for _ in range(need)]
        t.blocks.extend(new)
        t.num_tokens = num_tokens
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        if new:
            self._trace("grow", request_id, len(new), tokens=num_tokens)
        return new

    def free(self, request_id: str) -> int:
        """Release the request's reference on every block in its table;
        returns the number of pages actually reclaimed (a shared or pinned
        page outlives the release — its last owner reclaims it)."""
        t = self._tables.pop(request_id)
        released = 0
        for bid in t.blocks:
            if self._refs[bid] <= 0:
                raise PoolError(f"block {bid} freed with refcount 0 "
                                f"({request_id})")
            self._refs[bid] -= 1
            if self._refs[bid] == 0 and self._pins[bid] == 0:
                self._release_block(bid)
                released += 1
        self._trace("free", request_id, released, held=len(t.blocks))
        return released

    # -- sharing: refcounts, pins, copy-on-write -----------------------------
    def share(self, request_id: str, pages: Sequence[int]) -> BlockTable:
        """Map already-written live pages into a new request's table without
        copying (one new table reference per page).  The table's initial
        ``num_tokens`` is the shared pages' full capacity; the caller
        ``extend``\\ s it for the suffix it still has to prefill."""
        if request_id in self._tables:
            raise PoolError(f"request {request_id} already has a block table")
        t = BlockTable(request_id)
        for bid in pages:
            if not 0 <= bid < self.num_blocks or \
                    (self._refs[bid] == 0 and self._pins[bid] == 0):
                raise PoolError(f"cannot share dead page {bid}")
            self._refs[bid] += 1
            t.blocks.append(bid)
        t.num_tokens = len(t.blocks) * self.block_size
        self._tables[request_id] = t
        self.shared_pages += len(t.blocks)
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        if t.blocks:
            self._trace("share", request_id, len(t.blocks))
        return t

    def pin(self, bid: int) -> None:
        """Add a cache reference: the page survives (and never moves) after
        every table releases it, until ``unpin``."""
        if self._refs[bid] == 0 and self._pins[bid] == 0:
            raise PoolError(f"cannot pin free block {bid}")
        self._pins[bid] += 1

    def unpin(self, bid: int) -> bool:
        """Drop a cache reference; returns True when that reclaimed the
        page (no table references it either)."""
        if self._pins[bid] <= 0:
            raise PoolError(f"block {bid} not pinned")
        self._pins[bid] -= 1
        if self._pins[bid] == 0 and self._refs[bid] == 0:
            self._release_block(bid)
            return True
        return False

    def ensure_writable(self, request_id: str, page_index: int) -> int:
        """Copy-on-write gate: make logical page ``page_index`` of the
        request's table safe to mutate.  Exclusive unpinned pages pass
        through; a shared or pinned page is swapped for a fresh private
        copy (page gather in the bound arena).  Returns the physical id
        the caller may now write.  Raises :class:`PoolError` when no free
        block is available for the copy (caller may evict cache entries
        and retry)."""
        t = self._tables[request_id]
        bid = t.blocks[page_index]
        if self._refs[bid] == 1 and self._pins[bid] == 0:
            return bid
        if not self._free:
            raise PoolError(f"OOM: copy-on-write of block {bid} needs a "
                            f"free block")
        new = self._take_block(request_id)
        if self.arena is not None:
            self.arena.copy_page(bid, new)
        t.blocks[page_index] = new
        self._refs[bid] -= 1
        if self._refs[bid] == 0 and self._pins[bid] == 0:
            self._release_block(bid)
        self.cow_copies += 1
        self.peak_in_use = max(self.peak_in_use, self.num_in_use)
        self._trace("cow", request_id, 1, src=bid, dst=new,
                    page_index=page_index)
        return new

    # -- defrag --------------------------------------------------------------
    def defrag(self) -> Dict[int, int]:
        """Compact exclusively-owned live blocks to the lowest physical ids
        (stable order: table order within request, requests by first block)
        and mirror the moves into the bound arena's page storage (a single
        batched gather per K/V leaf).  Shared (refcount > 1) and pinned
        pages never move: other tables and the prefix-cache index hold
        them by physical id.  With no sharing this degenerates to full
        compaction with a contiguous free tail.  Returns the
        {old_id: new_id} move map."""
        immovable = {bid for bid in range(self.num_blocks)
                     if self._pins[bid] > 0 or self._refs[bid] > 1}
        order = sorted(self._tables.values(),
                       key=lambda t: t.blocks[0] if t.blocks else 0)
        moves: Dict[int, int] = {}
        occupied = set(immovable)
        nxt = 0
        for t in order:
            for i, bid in enumerate(t.blocks):
                if bid in immovable:
                    continue
                while nxt in immovable:
                    nxt += 1
                if bid != nxt:
                    moves[bid] = nxt
                t.blocks[i] = nxt
                occupied.add(nxt)
                nxt += 1
        new_refs = [0] * self.num_blocks
        for t in self._tables.values():
            for bid in t.blocks:
                new_refs[bid] += 1
        self._refs = new_refs
        self._free = deque(b for b in range(self.num_blocks)
                           if b not in occupied)
        if self.arena is not None:
            # the counter records physical page moves, so it only advances
            # when storage is bound (unbound defrag is table bookkeeping)
            # saralint: ok[cow-gate] defrag relocates whole pages and never moves shared/pinned ones (immovable landmarks); content is copied, not mutated
            self.arena.apply_moves(moves)
            self.defrag_moves += len(moves)
        self._trace("defrag", "_pool", len(moves),
                    storage_moved=self.arena is not None,
                    pinned_landmarks=len(immovable))
        return moves

    # -- invariant check (tests / debug / per-step under sanitize) -----------
    def check(self) -> None:
        self.sanitize_checks += 1
        refs = [0] * self.num_blocks
        for t in self._tables.values():
            if len(set(t.blocks)) != len(t.blocks):
                raise PoolError(f"table {t.request_id} names a page twice")
            for bid in t.blocks:
                refs[bid] += 1
        if refs != self._refs:
            bad = [b for b in range(self.num_blocks)
                   if refs[b] != self._refs[b]]
            raise PoolError(f"refcount drift on blocks {bad[:8]}")
        if any(p < 0 for p in self._pins):
            raise PoolError("negative pin count")
        free = sorted(self._free)
        if len(free) != len(set(free)):
            raise PoolError("free list names a block twice")
        expect = [b for b in range(self.num_blocks)
                  if refs[b] == 0 and self._pins[b] == 0]
        if free != expect:
            raise PoolError("free list does not equal the unreferenced, "
                            "unpinned block set")
