"""dispatch-escape: model GEMMs must route through ``dispatch.gemm``.

The paper's 99.93%-of-best result assumes ADAPTNET observes *every*
layer GEMM shape; a raw contraction in model code is a shape the
recommender never sees and a tile choice the RSA never makes.  This pass
flags every raw contraction in ``models/`` and ``core/adaptnet.py``:

* the torch contractions ``torch.einsum``, ``torch.matmul``,
  ``torch.mm``, ``torch.bmm``, ``torch.addmm``, ``torch.baddbmm``,
  ``torch.tensordot``, ``torch.nn.functional.linear``, and NumPy's
  ``einsum`` / ``dot`` / ``matmul`` / ``tensordot``;
* the ``@`` operator;
* the method forms ``x.matmul(w)``, ``x.mm(w)`` and ``x.bmm(w)`` (the
  receiver is an operand);
* an ``nn.Linear`` built in scope, always an error: it hides a weight
  GEMM inside a module call.

A contraction is an

* **error** when an operand looks like a *weight* (``w_uk``, ``w1``,
  ``params["w2"]``, ``kernel`` ...) — a true escape that should be
  rerouted through ``dispatch.gemm``;
* **warning** otherwise — typically an activation-activation contraction
  (attention scores, recurrence mixes) that dispatch legitimately does
  not own, to be annotated with a
  ``# saralint: ok[dispatch-escape] <reason>`` pragma.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional

from ..core import Context, ERROR, Finding, SourceFile, WARNING, register

CHECK = "dispatch-escape"

GEMM_FUNCS = {
    "torch.einsum", "torch.matmul", "torch.mm", "torch.bmm", "torch.addmm",
    "torch.baddbmm", "torch.tensordot", "torch.nn.functional.linear",
    "numpy.einsum", "numpy.dot", "numpy.matmul", "numpy.tensordot",
}

#: tensor methods that contract their receiver with their argument
GEMM_METHODS = {"matmul", "mm", "bmm"}

#: module classes that own a weight GEMM
GEMM_MODULES = {"torch.nn.Linear"}

_WEIGHT_NAME = re.compile(r"^(w|wt|weight|kernel|proj)(_|\d|$)")

#: layout/cast wrappers to look through when deciding weight-likeness
_TRANSPARENT_ATTRS = {"astype", "reshape", "transpose", "swapaxes", "T",
                      "to", "float", "t", "mT", "view", "contiguous",
                      "permute"}


def _in_scope(sf: SourceFile) -> bool:
    return sf.rel.startswith("models/") or sf.rel == "core/adaptnet.py"


def _weight_like(node: ast.AST) -> bool:
    while True:
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TRANSPARENT_ATTRS:
            node = node.func.value
        elif isinstance(node, ast.Attribute) and node.attr in _TRANSPARENT_ATTRS:
            node = node.value
        else:
            break
    if isinstance(node, ast.Name):
        return bool(_WEIGHT_NAME.match(node.id))
    if isinstance(node, ast.Attribute):
        return bool(_WEIGHT_NAME.match(node.attr))
    if isinstance(node, ast.Subscript):
        s = node.slice
        if isinstance(s, ast.Constant) and isinstance(s.value, str):
            return bool(_WEIGHT_NAME.match(s.value))
    return False


def _operands(call: ast.Call) -> List[ast.AST]:
    """Tensor operands of a contraction call (skip einsum's spec string)."""
    ops = []
    for a in call.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            continue
        if isinstance(a, ast.Starred):
            continue
        ops.append(a)
    return ops


def _module_root(sf: SourceFile, node: ast.AST) -> bool:
    """Whether an attribute chain starts at an imported module (``torch``,
    ``np``, ``F``): ``torch.mm`` is a function, ``x.mm`` a method."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in sf.imports


def _method_operands(sf: SourceFile, call: ast.Call) -> Optional[List[ast.AST]]:
    """Operands of ``x.matmul(w)`` / ``x.mm(w)`` / ``x.bmm(w)``: the
    receiver and the arguments; None for any other call."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr in GEMM_METHODS):
        return None
    if _module_root(sf, func.value):
        return None
    return [func.value] + _operands(call)


def _finding(sf: SourceFile, node: ast.AST, what: str,
             weighted: bool) -> Finding:
    return Finding(
        check=CHECK, severity=ERROR if weighted else WARNING,
        path=sf.rel, line=node.lineno,
        message=(f"raw {what} "
                 + ("contracts a weight operand — route it through "
                    "dispatch.gemm(site=...)"
                    if weighted else
                    "bypasses the dispatch layer — route through "
                    "dispatch.gemm or annotate why dispatch does not own "
                    "this contraction")))


@register("dispatch-escape",
          "model GEMMs not routed through dispatch.gemm")
def check(ctx: Context) -> Iterable[Finding]:
    for sf in ctx.files:
        if not _in_scope(sf):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                dotted = sf.dotted(node.func)
                if dotted in GEMM_MODULES:
                    yield Finding(
                        check=CHECK, severity=ERROR, path=sf.rel,
                        line=node.lineno,
                        message=("nn.Linear hides a weight GEMM inside a "
                                 "module call — keep the weight in params "
                                 "and route it through "
                                 "dispatch.gemm(site=...)"))
                    continue
                if dotted in GEMM_FUNCS:
                    fn = dotted.rsplit(".", 1)[-1]
                    spec = ""
                    if node.args and isinstance(node.args[0], ast.Constant) \
                            and isinstance(node.args[0].value, str):
                        spec = f' "{node.args[0].value}"'
                    yield _finding(sf, node, f"{fn}{spec}", any(
                        _weight_like(a) for a in _operands(node)))
                    continue
                ops = _method_operands(sf, node)
                if ops is not None:
                    yield _finding(sf, node, f".{node.func.attr}()",
                                   any(_weight_like(a) for a in ops))
            elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
                weighted = _weight_like(node.right) or _weight_like(node.left)
                yield _finding(sf, node, "@ matmul", weighted)
