"""The ambient mesh — the port of ``repro/parallel/hints.py``.

The launch layer sets the mesh (``use_mesh``); the dispatch layer reads it
(``current_mesh``) to record each GEMM site's mesh-level plan.  The
reference also pins activations with ``with_sharding_constraint``
(``hint``) so that GSPMD keeps the batch sharded through its scans, and
keeps an ambient layout for that.  The port has no GSPMD: each rank holds
its own rows and the parameters' local blocks, laid out explicitly by
``parallel/sharding.py`` and the sharded train step, so there is no
propagation for a hint to steer, and neither ``hint`` nor the layout is
ported (ROADMAP §3).
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

_MESH: Optional[Any] = None


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev
