"""saralint: contract-checking static analysis for the port.

The port's copy of the reference's ``repro.analysis`` (it imports nothing
of the JAX package), rescoped to PyTorch and CUDA.  The port's
correctness rests on the same cross-cutting contracts: every weight GEMM
must route through ``dispatch.gemm`` (or ADAPTNET never observes the
shape), every write into a KV page that may be shared must pass the
``ensure_writable`` copy-on-write gate (the port's arena writes happen in
place, so a write past the gate corrupts another request's pages at
once), trace taxonomy strings must match ``obs/trace.py``, and every
hand-written kernel must keep its plain twin, counted where the launch
gates read it, and be launched with the arguments its C signature
declares.  ``python -m repro_torch.analysis src/repro_torch`` is the
gate.

Checks: ``dispatch-escape`` (torch contractions, ``@``, the ``matmul`` /
``mm`` / ``bmm`` methods and ``nn.Linear`` in ``models/`` and
``core/adaptnet.py``), ``cow-gate`` (the port's arena writers),
``obs-taxonomy`` (as the reference's) and ``kernel-contract`` (the port's
counterpart of ``pallas-contract``).  Two of the reference's checks have
no counterpart: ``pallas-contract``'s BlockSpec / grid / scalar-prefetch
half (a CUDA launch has no BlockSpecs; its argument count against the
library's C signature is checked instead), and ``retrace-hazard`` (the
port runs eagerly and traces nothing; ``obs.trace.JitWatch`` counts new
argument signatures at run time).

Suppression syntax, as the reference's: ``# saralint: ok[check-id]
<reason>`` on the flagged line or the line above; the reason is required.
"""

from .core import (  # noqa: F401
    CHECKS,
    Context,
    Finding,
    SourceFile,
    collect_files,
    register,
    run_paths,
)

# Importing the package registers every built-in check.
from . import checks  # noqa: F401,E402
