"""Cross-request prefix cache: a page-granular radix trie over token ids.

Most serving traffic at scale shares prompt *prefixes* — system prompts,
few-shot preambles, conversation history.  This index remembers, per
completed prefill, which physical KV pages hold which token-id page
(``block_size`` tokens), keyed by the exact token bytes, so a later
request whose prompt starts with the same tokens can ``share`` those
pages instead of recomputing and rewriting them (the vLLM/SGLang
radix-cache move on top of this repo's refcounted block pool).

Granularity is one pool page: a trie node holds the physical page id for
one ``block_size``-token span, children keyed by the *next* span's token
bytes.  ``match`` walks the longest cached prefix of a prompt;
``insert`` pins a finished request's fully-covered prompt pages into the
trie (pin = cache reference in
:class:`~repro_torch.serving.kv_pool.KVBlockPool` — the page survives
table frees and never moves in defrag); ``evict`` drops
least-recently-used *leaf* entries whose page no live table still
references, walking leaves-first so an interior page is never orphaned
while a longer cached prefix still needs it.

Correctness leans on one immutability argument: a cached page covers only
rows ``< floor(prompt_len / block_size) * block_size``, and its donor
only ever writes rows ``>= prompt_len`` after insertion (decode appends),
so a pinned page's content is frozen by construction; writers that *do*
touch a shared page (the suffix chunk of a whole-prompt hit) go through
the pool's copy-on-write gate first.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional

import numpy as np

from .kv_pool import KVBlockPool


class _Node:
    __slots__ = ("key", "page", "parent", "children", "stamp")

    def __init__(self, key: Optional[bytes], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.stamp = 0


class PrefixCache:
    """Radix/trie index from token-id prefixes to pinned pool pages."""

    def __init__(self, pool: KVBlockPool, recorder=None):
        self.pool = pool
        self.block_size = pool.block_size
        self.recorder = recorder
        self._root = _Node(None, -1, None)
        self._clock = 0                 # monotone LRU stamp
        self.hits = 0                   # submits that matched >= 1 page
        self.misses = 0
        self.reused_pages = 0           # lifetime pages returned by match
        self.inserted_pages = 0
        self.evicted_pages = 0

    # -- lookup --------------------------------------------------------------
    def _page_keys(self, tokens: np.ndarray, limit: Optional[int] = None):
        n_full = len(tokens) // self.block_size
        if limit is not None:
            n_full = min(n_full, limit)
        for i in range(n_full):
            yield tokens[i * self.block_size:(i + 1) * self.block_size] \
                .astype(np.int32, copy=False).tobytes()

    def match(self, tokens: np.ndarray) -> List[int]:
        """Longest cached prefix of ``tokens``, full pages only.  Returns
        the physical page ids in logical order (possibly empty) and
        touches every node on the path for LRU.  Pure lookup — the
        scheduler calls :meth:`record_lookup` once per *admission*, so a
        request re-tried across steps is not double-counted."""
        node, pages = self._root, []
        for key in self._page_keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            self._clock += 1
            child.stamp = self._clock
            pages.append(child.page)
            node = child
        return pages

    def record_lookup(self, matched_pages: int) -> None:
        """Account one admission-time lookup in the hit/miss counters."""
        if matched_pages > 0:
            self.hits += 1
            self.reused_pages += matched_pages
        else:
            self.misses += 1

    # -- insert --------------------------------------------------------------
    def insert(self, tokens: np.ndarray, blocks: List[int]) -> int:
        """Index a finished prefill: pin ``blocks[i]`` as the page for the
        i-th full token page of ``tokens``.  Spans already cached keep
        their existing page (the donor's copy — possibly a COW divergence
        of the cached one — is simply not indexed).  Returns the number of
        newly pinned pages."""
        node, added = self._root, 0
        n_full = min(len(tokens) // self.block_size, len(blocks))
        for i, key in enumerate(self._page_keys(tokens, n_full)):
            child = node.children.get(key)
            if child is None:
                page = blocks[i]
                self.pool.pin(page)
                child = _Node(key, page, node)
                node.children[key] = child
                added += 1
            self._clock += 1
            child.stamp = self._clock
            node = child
        self.inserted_pages += added
        if added and self.recorder is not None:
            self.recorder.count("prefix_cache_inserted_pages", added)
        return added

    # -- eviction ------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, need_pages: int,
              exclude: Optional[Iterable[int]] = None) -> int:
        """Unpin least-recently-used cached prefixes until ``need_pages``
        pool pages have actually been reclaimed (only pages no live table
        references free immediately).  Leaves evict first so interior
        pages are never orphaned.  ``exclude`` names physical pages that
        must survive this call even when otherwise evictable — the
        scheduler passes the pages a just-matched prefix is about to
        ``share``, which no table references yet.  Returns the number of
        pages freed.

        One trie walk collects the candidate leaves into a min-stamp
        heap; evicting a node pushes its parent when that exposes a new
        leaf, so the cost is O(trie + freed * log leaves) per call rather
        than a full rescan per freed page.  Refcounts cannot change while
        this runs (nothing here touches tables), so a candidate skipped
        as referenced or excluded stays skipped."""
        skip = frozenset(exclude) if exclude is not None else frozenset()
        freed = 0
        heap, tie = [], 0
        for leaf in self._leaves():
            heap.append((leaf.stamp, tie, leaf))
            tie += 1
        heapq.heapify(heap)
        while freed < need_pages and heap:
            _, _, node = heapq.heappop(heap)
            if node.page in skip or self.pool.refcount(node.page) != 0:
                continue
            parent = node.parent
            del parent.children[node.key]
            self.pool.unpin(node.page)
            freed += 1
            self.evicted_pages += 1
            if parent is not self._root and not parent.children:
                tie += 1
                heapq.heappush(heap, (parent.stamp, tie, parent))
        if freed and self.recorder is not None:
            self.recorder.count("prefix_cache_evicted_pages", freed)
        return freed

    def clear(self) -> int:
        """Drop every cache entry (unpinning all pages); returns the
        number of entries removed.  Tests and shutdown paths use this to
        return the pool to the fully-free state."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.unpin(n.page)
            dropped += 1
        self._root.children.clear()
        return dropped

    def pages(self) -> List[int]:
        """Every physical page the trie currently pins (one per node).
        The sanitizer's teardown audit compares this against the pool's
        pinned set — they must agree exactly."""
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    # -- snapshot / restore ---------------------------------------------------
    def export_state(self) -> Dict:
        """JSON-serializable trie dump for engine snapshots: the nodes in
        parent-before-child order (``parent`` indexes the same list, -1 =
        root), each with its physical page, LRU stamp, and the key span's
        token ids; plus the LRU clock and lifetime counters."""
        nodes: List[Dict] = []
        stack = [(c, -1) for c in self._root.children.values()]
        while stack:
            node, pidx = stack.pop()
            idx = len(nodes)
            nodes.append({
                "parent": pidx,
                "page": int(node.page),
                "stamp": int(node.stamp),
                "key": np.frombuffer(node.key, np.int32).tolist(),
            })
            stack.extend((c, idx) for c in node.children.values())
        return {"nodes": nodes, "clock": int(self._clock),
                "hits": int(self.hits), "misses": int(self.misses),
                "reused_pages": int(self.reused_pages),
                "inserted_pages": int(self.inserted_pages),
                "evicted_pages": int(self.evicted_pages)}

    def restore_state(self, state: Dict) -> int:
        """Rebuild the trie from :meth:`export_state`.  Does NOT touch
        pool pin counts: snapshot restore rebuilds the pool (pins
        included) wholesale from the same checkpoint, so re-pinning here
        would double-count every cached page.  Only valid on an empty
        cache over that restored pool.  Returns the node count."""
        if self._root.children:
            raise ValueError("restore_state needs an empty prefix cache")
        built: List[_Node] = []
        for spec in state["nodes"]:
            parent = (self._root if spec["parent"] < 0
                      else built[spec["parent"]])
            key = np.asarray(spec["key"], np.int32).tobytes()
            node = _Node(key, int(spec["page"]), parent)
            node.stamp = int(spec["stamp"])
            parent.children[key] = node
            built.append(node)
        self._clock = int(state["clock"])
        self.hits = int(state["hits"])
        self.misses = int(state["misses"])
        self.reused_pages = int(state["reused_pages"])
        self.inserted_pages = int(state["inserted_pages"])
        self.evicted_pages = int(state["evicted_pages"])
        return len(built)

    # -- stats ---------------------------------------------------------------
    @property
    def num_entries(self) -> int:
        count, stack = 0, list(self._root.children.values())
        while stack:
            n = stack.pop()
            count += 1
            stack.extend(n.children.values())
        return count

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_cache_hits": self.hits,
            "prefix_cache_misses": self.misses,
            "prefix_cache_hit_rate": round(self.hit_rate(), 4),
            "prefix_cache_reused_pages": self.reused_pages,
            "prefix_cache_inserted_pages": self.inserted_pages,
            "prefix_cache_evicted_pages": self.evicted_pages,
            "prefix_cache_entries": self.num_entries,
        }
