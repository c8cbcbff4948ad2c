"""obs-taxonomy: trace string literals must match the declared taxonomy.

``obs/trace.py`` declares the event taxonomy (``CATEGORIES``,
``STEP_PHASES``, ``COUNTERS``, ``GAUGES``).  ``validate_trace`` enforces
categories at export time, but a typo'd phase/counter/gauge string
silently creates a new series that no dashboard or test ever reads.
This pass checks, at every recorder call site:

* ``.emit/.instant/.slice/.span`` — first literal argument must be a
  declared category;
* ``.phase`` (step timeline) — literal must be a declared step phase;
* ``.count`` / ``.gauge`` — literal must be a declared counter / gauge.

Only calls whose receiver is a recorder-ish attribute (``obs``, ``rec``,
``recorder``, ``timeline``, ``tl``) are considered, so ``list.count(x)``
never trips it; non-literal first arguments (f-strings, variables) are
skipped.  The taxonomy is read from the scanned tree's own
``obs/trace.py``, so fixture corpora carry their own declarations.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Tuple

from ..core import Context, ERROR, Finding, register

CHECK = "obs-taxonomy"

RECEIVERS = {"obs", "rec", "recorder", "timeline", "tl"}
CATEGORY_METHODS = {"emit", "instant", "slice", "span"}

_TAXONOMY_NAMES = ("CATEGORIES", "STEP_PHASES", "COUNTERS", "GAUGES")


def _taxonomy(ctx: Context) -> Optional[Dict[str, Tuple[str, ...]]]:
    trace = ctx.find("obs/trace.py")
    if trace is None:
        return None
    out: Dict[str, Tuple[str, ...]] = {}
    for node in trace.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in _TAXONOMY_NAMES \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                vals = tuple(e.value for e in node.value.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, str))
                out[t.id] = vals
    return out or None


def _receiver_tail(func: ast.Attribute) -> str:
    base = func.value
    if isinstance(base, ast.Attribute):
        return base.attr
    if isinstance(base, ast.Name):
        return base.id
    return ""


def _first_literal(call: ast.Call) -> Optional[Tuple[str, int]]:
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, a.lineno
    return None


@register("obs-taxonomy",
          "trace category/phase/counter literals vs obs/trace.py taxonomy")
def check(ctx: Context) -> Iterable[Finding]:
    tax = _taxonomy(ctx)
    if tax is None:
        return
    categories = tax.get("CATEGORIES", ())
    phases = tax.get("STEP_PHASES", ())
    counters = tax.get("COUNTERS", ())
    gauges = tax.get("GAUGES", ())
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            if _receiver_tail(node.func) not in RECEIVERS:
                continue
            method = node.func.attr
            lit = _first_literal(node)
            if lit is None:
                continue
            value, line = lit
            bad = None
            if method in CATEGORY_METHODS and value not in categories:
                bad = ("category", "CATEGORIES", categories)
            elif method == "phase" and value not in phases:
                bad = ("step phase", "STEP_PHASES", phases)
            elif method == "count" and value not in counters:
                bad = ("counter", "COUNTERS", counters)
            elif method == "gauge" and value not in gauges:
                bad = ("gauge", "GAUGES", gauges)
            if bad is None:
                continue
            kind, decl, known = bad
            yield Finding(
                check=CHECK, severity=ERROR, path=sf.rel, line=line,
                message=(f'.{method}("{value}"): unknown {kind} — declare it '
                         f"in obs/trace.py {decl} or fix the literal "
                         f"(known: {', '.join(known) or '<none>'})"))
