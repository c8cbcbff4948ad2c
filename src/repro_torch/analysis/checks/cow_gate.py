"""cow-gate: arena writers must be reachable only behind the COW gate.

KV pages are refcounted and shared across requests (prefix cache, COW
forks).  Writing a shared or pinned page corrupts every other reader, so
each write path must first pass ``KVBlockPool.ensure_writable`` (or the
engine's chunk-level ``_cow_chunk_pages`` wrapper), which forks the page
when its refcount > 1 or it is pinned.  In the port the hazard is
immediate: every arena write lands in place in the page tensors, where
the reference builds new arrays.

The pass flags any function in ``serving/`` or ``models/`` that calls a
known arena-writing entry point without also calling a gate in the same
function body.  Call sites that are safe by construction — e.g. decode
appending into a tail page the request owns exclusively — carry a
``# saralint: ok[cow-gate] <reason>`` pragma documenting the ownership
argument.

The writers (``WRITERS``), found by auditing ``models/`` and ``serving/``
for in-place writes into arena storage (``index_copy_``, ``copy_``,
``fill_`` / ``zero_``, slice assignment) and for the calls that reach
them:

* ``models/attention.py::_arena_write_chunk`` — ``index_copy_`` of a
  chunk's K/V rows (GQA and MLA, prefill and decode);
* ``models/serving.py::paged_prefill_write`` — slice assignment of a
  bucketed prefill's pages (and its ``models/api.py`` method);
* ``models/serving.py::paged_{prefill,verify,decode,shared_decode}_step``
  — the model steps, which write each layer's rows before attending (and
  their ``models/api.py`` methods);
* the engine's ``JitWatch`` wrappers of those steps: ``_paged_write``,
  ``_chunk_prefill``, ``_paged_decode``, ``_paged_shared_decode``,
  ``_spec_verify``; the draft's ``_draft_prefill`` and ``_draft_loop``
  (``serving/spec_decode.py``);
* ``serving/kv_pool.py::KVArena.copy_page`` / ``apply_moves`` (``copy_``
  of pages) and ``poison_page`` / ``unpoison_page`` (the sanitizer's
  ``fill_`` / ``zero_`` of a page);
* ``serving/snapshot.py::_copy`` — ``copy_`` of a snapshot into a whole
  arena leaf (and into the dense slot caches).
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Context, ERROR, Finding, register

CHECK = "cow-gate"

#: entry points that mutate arena page storage
WRITERS = {
    "_arena_write_chunk",       # models/attention.py chunk scatter
    "paged_prefill_write",      # model-level bucketed KV scatter
    "paged_prefill_step",       # model step: chunk rows written per layer
    "paged_verify_step",        # model step: spec-decode verify rows
    "paged_decode_step",        # model step: decode append + attend
    "paged_shared_decode_step",  # model step: cascade decode append
    "_paged_write",             # engine JitWatch: bucketed prefill write
    "_chunk_prefill",           # engine JitWatch: ragged chunk prefill
    "_paged_decode",            # engine JitWatch: decode append + attend
    "_paged_shared_decode",     # engine JitWatch: cascade decode append
    "_spec_verify",             # engine JitWatch: spec-decode verify chunk
    "_draft_prefill",           # spec_decode JitWatch: draft catch-up
    "_draft_loop",              # spec_decode JitWatch: draft rounds
    "copy_page",                # raw arena page copy
    "apply_moves",              # raw arena defrag gather
    "poison_page",              # sanitizer: NaN-fill a page
    "unpoison_page",            # sanitizer: zero a page
    "_copy",                    # snapshot restore into arena leaves
}

#: calls that establish copy-on-write protection for the writes that follow
GATES = {"ensure_writable", "_cow_chunk_pages"}


def _call_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return ""


@register("cow-gate",
          "arena writers reachable without ensure_writable protection")
def check(ctx: Context) -> Iterable[Finding]:
    for sf in ctx.files:
        if not (sf.rel.startswith(("serving/", "models/"))
                or "/serving/" in sf.rel or "/models/" in sf.rel):
            continue
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in GATES:
                continue                    # this *is* the gate
            calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
            names = {_call_name(c) for c in calls}
            if names & GATES:
                continue                    # gated in this body
            seen = set()
            for c in calls:
                name = _call_name(c)
                if name in WRITERS and name not in seen:
                    seen.add(name)
                    yield Finding(
                        check=CHECK, severity=ERROR, path=sf.rel,
                        line=c.lineno,
                        message=(f"'{fn.name}' calls arena writer '{name}' "
                                 "with no ensure_writable/_cow_chunk_pages "
                                 "gate in scope — shared or pinned pages "
                                 "would be mutated in place"))
