"""saralint core: findings, suppressions, source model, check registry.

The port's own copy of the reference's ``analysis/core.py``, unchanged
but for its examples (the port keeps no import of the JAX package).

A *check* is a function ``fn(ctx: Context) -> Iterable[Finding]``
registered under a kebab-case id with :func:`register`.  The runner
parses every ``.py`` file under the requested paths once into
:class:`SourceFile` records (AST + import aliases + suppression
pragmas), hands the whole :class:`Context` to each check (so passes can
reason across files, e.g. ops.py wrappers vs their plain twins), then
applies inline suppressions::

    s = torch.einsum("bqhd,bkhd->bhqk", q, k)  # saralint: ok[dispatch-escape] activation-activation score

A pragma suppresses findings of that check id on the same line or the
line directly below it (i.e. it may trail the flagged line or sit on its
own line above).  A pragma with no reason text does not count — it
produces a ``suppression-reason`` error instead, so every suppression in
the tree documents *why* the contract does not apply.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(r"#\s*saralint:\s*ok\[([a-z0-9_-]+)\]\s*(.*?)\s*$")

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Finding:
    """One contract violation at ``path:line``."""

    check: str
    severity: str               # "error" | "warning"
    path: str                   # scan-root-relative posix path
    line: int                   # 1-indexed
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tail = f"  (suppressed: {self.suppress_reason})" if self.suppressed else ""
        return f"{self.location}: {self.severity}[{self.check}] {self.message}{tail}"


def _collect_imports(tree: ast.AST) -> Dict[str, str]:
    """Alias -> dotted module/name map.  Relative imports keep their dots
    (``from . import ref`` -> ``ref: .ref``) so checks can match suffixes."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                dotted = f"{base}.{a.name}" if base and not base.endswith(".") \
                    else f"{base}{a.name}"
                out[a.asname or a.name] = dotted
    return out


def _collect_pragmas(lines: Sequence[str]) -> Dict[int, List[Tuple[str, str]]]:
    out: Dict[int, List[Tuple[str, str]]] = {}
    for i, text in enumerate(lines, start=1):
        for m in PRAGMA_RE.finditer(text):
            out.setdefault(i, []).append((m.group(1), m.group(2)))
    return out


class SourceFile:
    """One parsed module: text, AST, import aliases, pragmas, parents."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        try:
            self.rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            self.rel = path.as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        self.imports = _collect_imports(self.tree)
        self.pragmas = _collect_pragmas(self.lines)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self._parents.get(cur)
        return None

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Best-effort dotted name for a Name/Attribute chain, with the
        base segment expanded through this file's import aliases
        (``F.linear`` -> ``torch.nn.functional.linear``)."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        parts.append(self.imports.get(cur.id, cur.id))
        return ".".join(reversed(parts))

    def pragma_for(self, line: int, check: str) -> Optional[str]:
        """Reason text if a pragma for ``check`` covers ``line`` (same
        line or the line above); None if not suppressed."""
        for lno in (line, line - 1):
            for cid, reason in self.pragmas.get(lno, ()):
                if cid == check:
                    return reason
        return None


class Context:
    """Everything a check may look at: all scanned files plus lookups."""

    def __init__(self, files: List[SourceFile], root: Path):
        self.files = files
        self.root = root
        self.by_rel = {f.rel: f for f in files}

    def find(self, rel_suffix: str) -> Optional[SourceFile]:
        """First file whose root-relative path ends with ``rel_suffix``."""
        for f in self.files:
            if f.rel == rel_suffix or f.rel.endswith("/" + rel_suffix):
                return f
        return None


CheckFn = Callable[[Context], Iterable[Finding]]
CHECKS: Dict[str, Tuple[str, CheckFn]] = {}


def register(check_id: str, description: str):
    def deco(fn: CheckFn) -> CheckFn:
        if check_id in CHECKS:
            raise ValueError(f"duplicate check id: {check_id}")
        CHECKS[check_id] = (description, fn)
        return fn
    return deco


def collect_files(paths: Sequence[str]) -> Tuple[List[SourceFile], Path]:
    """Parse every ``.py`` under ``paths``.  Relative paths are computed
    against the first argument (a directory) so check scoping such as
    ``models/`` works for both the real tree and fixture corpora."""
    roots = [Path(p) for p in paths]
    scan_root = roots[0] if roots[0].is_dir() else roots[0].parent
    files: List[SourceFile] = []
    seen = set()
    for r in roots:
        candidates = sorted(r.rglob("*.py")) if r.is_dir() else [r]
        for p in candidates:
            key = p.resolve()
            if key in seen:
                continue
            seen.add(key)
            files.append(SourceFile(p, scan_root))
    return files, scan_root


def apply_suppressions(findings: List[Finding],
                       ctx: Context) -> List[Finding]:
    """Mark findings covered by a pragma; add a ``suppression-reason``
    error for every pragma used without a reason."""
    extra: List[Finding] = []
    for f in findings:
        sf = ctx.by_rel.get(f.path)
        if sf is None:
            continue
        reason = sf.pragma_for(f.line, f.check)
        if reason is None:
            continue
        f.suppressed = True
        f.suppress_reason = reason or "<missing>"
        if not reason:
            extra.append(Finding(
                check="suppression-reason", severity=ERROR, path=f.path,
                line=f.line,
                message=(f"saralint: ok[{f.check}] suppression must state a "
                         "reason"),
            ))
    return findings + extra


def run_paths(paths: Sequence[str],
              only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run (a subset of) the registered checks over ``paths``; returns
    all findings, suppressed ones included and marked."""
    files, root = collect_files(paths)
    ctx = Context(files, root)
    findings: List[Finding] = []
    for cid, (_desc, fn) in sorted(CHECKS.items()):
        if only and cid not in only:
            continue
        findings.extend(fn(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.check))
    return apply_suppressions(findings, ctx)


def render_report(findings: List[Finding], as_json: bool = False,
                  show_suppressed: bool = False) -> str:
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    if as_json:
        payload = {
            "findings": [f.to_dict() for f in findings],
            "summary": {
                "errors": sum(1 for f in active if f.severity == ERROR),
                "warnings": sum(1 for f in active if f.severity == WARNING),
                "suppressed": len(suppressed),
            },
        }
        return json.dumps(payload, indent=2)
    lines = [f.render() for f in active]
    if show_suppressed:
        lines += [f.render() for f in suppressed]
    lines.append(
        f"saralint: {sum(1 for f in active if f.severity == ERROR)} error(s), "
        f"{sum(1 for f in active if f.severity == WARNING)} warning(s), "
        f"{len(suppressed)} suppressed")
    return "\n".join(lines)
