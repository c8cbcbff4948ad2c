"""kernel-contract: plain twins, launch counters and C launch signatures.

The port's counterpart of the reference's ``pallas-contract``.  Every
hand-written kernel under ``kernels/`` is reached through a ``*_cuda``
function that launches it and counts its launches, and has a plain
PyTorch twin ``*_plain`` that runs for CPU tensors and counts its calls.
The parity tests and ``chip_smoke.py``'s gates ("each kernel launched",
"0 plain calls") rest on that pairing, so this pass checks, across
files:

* every ``*_cuda`` function of a ``kernels/`` module has a ``*_plain``
  twin of the same stem in the same module (a function, or a module-level
  name bound to one);
* every public ``kernels/ops.py`` wrapper that reaches a ``*_cuda``
  function (directly or through a helper or class of ``ops.py``) also
  references that kernel's plain twin, or has a ``<wrapper>_plain`` twin
  of its own, as the reference's wrappers keep ``<wrapper>_ref``;
* every ``*_cuda`` function is reported by ``ops.launch_counts()`` (its
  ``.launches``), and every plain twin is summed into its
  ``plain_calls`` (its ``.calls``).

And at each launch through a ``_build`` library
(``_build.library("lib").fn(...)``, a local bound to the library, or
``getattr(library, fn)`` where ``fn`` is a literal or a parameter every
call of the enclosing function passes a literal for): ``fn`` is declared in
``_build.SIGNATURES["lib"]``, and the call passes as many arguments as
that entry declares.  ``library()`` sets ``argtypes`` only for the
declared functions, so an undeclared one would be called unchecked, and
a miscounted call reads garbage for its trailing parameters.

Static resolution is best-effort, as in the reference: a function name
that is not resolved so, a starred argument whose length is not fixed, or a
signature entry that is not a literal list expression is skipped, never
guessed.  A starred call of a module function whose every ``return`` is
a tuple literal of one length (``*launch_args(...)``) counts as that
length.  The reference's BlockSpec / grid / scalar-prefetch arithmetic
has no counterpart: a CUDA launch has no BlockSpecs.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core import Context, ERROR, Finding, SourceFile, register

CHECK = "kernel-contract"


def _in_kernels(sf: SourceFile) -> bool:
    return sf.rel.startswith("kernels/") or "/kernels/" in sf.rel


def _module_names(sf: SourceFile) -> Tuple[Dict[str, ast.AST], Dict[str, str]]:
    """Module-level function defs by name, and module-level aliases
    ``a = b`` (b a Name) as {a: b}."""
    defs: Dict[str, ast.AST] = {}
    aliases: Dict[str, str] = {}
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defs[node.name] = node
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases[t.id] = node.value.id
    return defs, aliases


def _resolve(name: str, aliases: Dict[str, str]) -> str:
    seen = set()
    while name in aliases and name not in seen:
        seen.add(name)
        name = aliases[name]
    return name


def _names_in(node: ast.AST) -> Set[str]:
    """Every Name id and Attribute attr referenced under ``node``."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _used_names(node: ast.AST) -> Set[str]:
    """Name ids under ``node`` used as values, not as the base of an
    attribute (``rsa_gemm_cuda.launches`` reads a counter; it launches
    nothing)."""
    bases = {id(n.value) for n in ast.walk(node)
             if isinstance(n, ast.Attribute)}
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and id(n) not in bases}


def _counted(fn: ast.AST, attr: str, key: Optional[str]) -> Set[str]:
    """Names X of ``X.<attr>`` read in ``fn``'s returned dict: under the
    entry ``key``, or under every entry but ``plain_calls`` if None."""
    out: Set[str] = set()
    for ret in ast.walk(fn):
        if not (isinstance(ret, ast.Return) and isinstance(ret.value, ast.Dict)):
            continue
        for k, v in zip(ret.value.keys, ret.value.values):
            kname = k.value if isinstance(k, ast.Constant) else None
            if (key is None and kname == "plain_calls") or \
                    (key is not None and kname != key):
                continue
            for n in ast.walk(v):
                if isinstance(n, ast.Attribute) and n.attr == attr \
                        and isinstance(n.value, ast.Name):
                    out.add(n.value.id)
    return out


def _check_twins(ctx: Context) -> Iterable[Finding]:
    kfiles = [sf for sf in ctx.files if _in_kernels(sf)]
    all_aliases: Dict[str, str] = {}
    twins: Dict[str, str] = {}          # cuda name -> resolved plain name
    for sf in kfiles:
        defs, aliases = _module_names(sf)
        all_aliases.update(aliases)
        for name, node in defs.items():
            if not (isinstance(node, ast.FunctionDef)
                    and name.endswith("_cuda")):
                continue
            plain = name[:-len("_cuda")] + "_plain"
            if plain in defs or plain in aliases:
                twins[name] = _resolve(plain, aliases)
                continue
            yield Finding(
                check=CHECK, severity=ERROR, path=sf.rel, line=node.lineno,
                message=(f"kernel entry '{name}' has no plain twin: define "
                         f"{plain} (or bind it to the plain version) in the "
                         "same module"))

    ops = ctx.find("kernels/ops.py")
    if ops is None:
        return
    defs, aliases = _module_names(ops)
    all_aliases.update(aliases)

    def reach(node: ast.AST, seen: Set[str]) -> Tuple[Set[str], Set[str]]:
        """(names referenced, names used as values) under ``node`` and the
        ops.py helpers and classes it references."""
        names, used = _names_in(node), _used_names(node)
        for n in list(names):
            if n in defs and n not in seen:
                seen.add(n)
                more, more_used = reach(defs[n], seen)
                names |= more
                used |= more_used
        return names, used

    for name, node in defs.items():
        if not isinstance(node, ast.FunctionDef) or name.startswith("_"):
            continue
        names, used = reach(node, {name})
        resolved = {_resolve(n, all_aliases) for n in names}
        if f"{name}_plain" in names:
            continue                    # the wrapper's own plain twin
        for cuda in sorted(n for n in used if n in twins):
            plain = twins[cuda]
            if plain in resolved:
                continue
            yield Finding(
                check=CHECK, severity=ERROR, path=ops.rel, line=node.lineno,
                message=(f"wrapper '{name}' launches '{cuda}' but never "
                         f"references its plain twin '{plain}' (nor a "
                         f"{name}_plain of its own): CPU tensors would have "
                         "no path"))

    lc = defs.get("launch_counts")
    if lc is None:
        return
    launched = {_resolve(n, all_aliases) for n in _counted(lc, "launches",
                                                           None)}
    plain_counted = {_resolve(n, all_aliases)
                     for n in _counted(lc, "calls", "plain_calls")}
    for cuda, plain in sorted(twins.items()):
        if cuda not in launched:
            yield Finding(
                check=CHECK, severity=ERROR, path=ops.rel, line=lc.lineno,
                message=(f"launch_counts() does not report "
                         f"{cuda}.launches: a run could not show that it "
                         "went through this kernel"))
        if plain not in plain_counted:
            yield Finding(
                check=CHECK, severity=ERROR, path=ops.rel, line=lc.lineno,
                message=(f"launch_counts()['plain_calls'] does not count "
                         f"{plain}.calls: a '0 plain calls' gate would "
                         "miss it"))


# ---------------------------------------------------------------------------
# launch arguments against _build.SIGNATURES
# ---------------------------------------------------------------------------

def _list_len(node: ast.AST) -> Optional[int]:
    """Length of a literal list expression (``[a, b] + [c] * 4``)."""
    if isinstance(node, (ast.List, ast.Tuple)):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _list_len(node.left), _list_len(node.right)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                k = _list_len(seq)
                return None if k is None else k * n.value
    return None


def _signatures(ctx: Context) -> Optional[Dict[str, Dict[str, Optional[int]]]]:
    build = ctx.find("kernels/_build.py")
    if build is None:
        return None
    for node in build.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SIGNATURES"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            out: Dict[str, Dict[str, Optional[int]]] = {}
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant) and isinstance(v, ast.Dict)):
                    continue
                out[k.value] = {
                    fk.value: _list_len(fv)
                    for fk, fv in zip(v.keys, v.values)
                    if isinstance(fk, ast.Constant)}
            return out
    return None


def _library_name(sf: SourceFile, node: ast.AST) -> Optional[str]:
    """``lib`` of a ``_build.library("lib")`` call, else None."""
    if not (isinstance(node, ast.Call) and node.args):
        return None
    dotted = sf.dotted(node.func) or ""
    if not (dotted == "library" or dotted.endswith("_build.library")):
        return None
    a = node.args[0]
    return a.value if isinstance(a, ast.Constant) \
        and isinstance(a.value, str) else None


def _local_value(sf: SourceFile, name: str, at: ast.AST) -> Optional[ast.AST]:
    """The value of the one assignment to ``name`` in the enclosing
    function; None if there is none or more than one."""
    fn = sf.enclosing_function(at)
    found: List[ast.AST] = []
    for stmt in ast.walk(fn if fn is not None else sf.tree):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == name:
            found.append(stmt.value)
    return found[0] if len(found) == 1 else None


def _library_of(sf: SourceFile, node: ast.AST, at: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        node = _local_value(sf, node.id, at)
    return _library_name(sf, node) if node is not None else None


def _targets(sf: SourceFile, func: ast.AST, at: ast.AST, depth: int = 0
             ) -> Optional[List[Tuple[str, str]]]:
    """The (library, function) pairs a launch's callee may be; None if it
    is not a launch through a ``_build`` library or cannot be resolved."""
    if depth > 4:
        return None
    if isinstance(func, ast.Name):
        value = _local_value(sf, func.id, at)
        return _targets(sf, value, at, depth + 1) if value is not None \
            else None
    if isinstance(func, ast.IfExp):
        a = _targets(sf, func.body, at, depth + 1)
        b = _targets(sf, func.orelse, at, depth + 1)
        return None if a is None or b is None else a + b
    if isinstance(func, ast.Attribute):
        lib = _library_of(sf, func.value, at)
        return [(lib, func.attr)] if lib else None
    if isinstance(func, ast.Call) and isinstance(func.func, ast.Name) \
            and func.func.id == "getattr" and len(func.args) == 2:
        lib = _library_of(sf, func.args[0], at)
        name = func.args[1]
        if lib and isinstance(name, ast.Constant) \
                and isinstance(name.value, str):
            return [(lib, name.value)]
        if lib and isinstance(name, ast.Name):
            names = _param_literals(sf, name.id, at)
            return [(lib, n) for n in names] if names else None
    return None


def _param_literals(sf: SourceFile, param: str, at: ast.AST
                    ) -> Optional[List[str]]:
    """The string literals the module passes for parameter ``param`` of
    the function enclosing ``at`` (``_launch("wkv_bshk_launch", ...)``);
    None unless every call of it in the module passes one."""
    fn = sf.enclosing_function(at)
    if fn is None or param not in [a.arg for a in fn.args.args]:
        return None
    pos = [a.arg for a in fn.args.args].index(param)
    out: List[str] = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == fn.name):
            continue
        vals = [k.value for k in node.keywords if k.arg == param]
        if not vals and len(node.args) > pos \
                and not any(isinstance(a, ast.Starred)
                            for a in node.args[:pos + 1]):
            vals = [node.args[pos]]
        if not (vals and isinstance(vals[0], ast.Constant)
                and isinstance(vals[0].value, str)):
            return None
        out.append(vals[0].value)
    return out or None


def _tuple_return_len(sf: SourceFile, call: ast.AST) -> Optional[int]:
    """Length of what a module function returns, when every ``return`` of
    it is a tuple literal of one length."""
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)):
        return None
    for node in sf.tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == call.func.id:
            lens = {_list_len(r.value) if isinstance(r.value, ast.Tuple)
                    else None
                    for r in ast.walk(node) if isinstance(r, ast.Return)}
            return lens.pop() if len(lens) == 1 else None
    return None


def _arg_count(sf: SourceFile, call: ast.Call) -> Optional[int]:
    n = 0
    for a in call.args:
        if isinstance(a, ast.Starred):
            k = _tuple_return_len(sf, a.value)
            if k is None:
                return None
            n += k
        else:
            n += 1
    return n


def _check_launches(ctx: Context) -> Iterable[Finding]:
    sigs = _signatures(ctx)
    if sigs is None:
        return
    for sf in ctx.files:
        if not _in_kernels(sf):
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            targets = _targets(sf, node.func, node)
            if not targets:
                continue
            got = _arg_count(sf, node)
            for lib, fn in targets:
                declared = sigs.get(lib, {})
                if fn not in declared:
                    yield Finding(
                        check=CHECK, severity=ERROR, path=sf.rel,
                        line=node.lineno,
                        message=(f"launch of {lib}.{fn}, which "
                                 f"_build.SIGNATURES[{lib!r}] does not "
                                 "declare: library() sets no argtypes "
                                 "for it"))
                    continue
                want = declared[fn]
                if got is not None and want is not None and got != want:
                    yield Finding(
                        check=CHECK, severity=ERROR, path=sf.rel,
                        line=node.lineno,
                        message=(f"{lib}.{fn} launched with {got} "
                                 f"argument(s) but _build.SIGNATURES "
                                 f"declares {want}"))


@register("kernel-contract",
          "plain twins, launch counters and launch arity vs _build.SIGNATURES")
def check(ctx: Context) -> Iterable[Finding]:
    yield from _check_twins(ctx)
    yield from _check_launches(ctx)
