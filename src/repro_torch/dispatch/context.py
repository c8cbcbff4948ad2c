"""Ambient dispatch policy (dispatcher + execution mode + registry).

The policy is an explicit stack manipulated by the ``use`` context
manager; ``active()`` returns the top of the stack (or a lazily-built
default: oracle dispatcher, ``execute="auto"``, process-wide registry).
PyTorch runs eagerly, so the policy is read on every call (the reference
reads it once per jit trace).

Execution modes, shared by the GEMM and the paged-attention wrappers:

  auto   — the hand-written CUDA kernel for CUDA tensors, the plain
           PyTorch version for CPU tensors;
  kernel — the CUDA kernel; a CPU tensor raises;
  torch  — the plain PyTorch version on any device (the comparison
           baseline ``chip_smoke.py`` holds the kernels against).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from typing import List, Optional

import torch

from repro_torch.dispatch.registry import SiteRegistry

EXECUTE_MODES = ("auto", "kernel", "torch")


@dataclass(frozen=True)
class DispatchPolicy:
    dispatcher: "SaraDispatcher"       # noqa: F821 (resolved lazily)
    execute: str = "auto"              # "auto" | "kernel" | "torch"
    registry: SiteRegistry = None

    def backend(self, t: torch.Tensor) -> str:
        """Resolve the mode for an operand: "kernel" or "torch"."""
        if self.execute == "torch":
            return "torch"
        if self.execute == "kernel" or t.is_cuda:
            if not t.is_cuda:
                raise ValueError(f"execute='kernel' needs CUDA tensors, got "
                                 f"a tensor on {t.device}")
            return "kernel"
        if t.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for device "
                             f"{t.device}")
        return "torch"


_DEFAULT_REGISTRY = SiteRegistry()
_STACK: List[DispatchPolicy] = []
_DEFAULT: Optional[DispatchPolicy] = None


def default_registry() -> SiteRegistry:
    return _DEFAULT_REGISTRY


def active() -> DispatchPolicy:
    """The innermost policy, or the lazily-built process default."""
    if _STACK:
        return _STACK[-1]
    global _DEFAULT
    if _DEFAULT is None:
        from repro_torch.core.sara import SaraDispatcher
        _DEFAULT = DispatchPolicy(dispatcher=SaraDispatcher(),
                                  registry=_DEFAULT_REGISTRY)
    return _DEFAULT


@contextlib.contextmanager
def use(dispatcher=None, execute: Optional[str] = None,
        registry: Optional[SiteRegistry] = None):
    """Install a dispatch policy; unset fields inherit from the active one.

        with dispatch.use(my_dispatcher, execute="kernel"):
            engine.step()
    """
    if execute is not None and execute not in EXECUTE_MODES:
        raise ValueError(f"execute must be one of {EXECUTE_MODES}, "
                         f"got {execute!r}")
    base = active()
    pol = replace(
        base,
        dispatcher=dispatcher if dispatcher is not None else base.dispatcher,
        execute=execute if execute is not None else base.execute,
        registry=registry if registry is not None else base.registry)
    _STACK.append(pol)
    try:
        yield pol
    finally:
        _STACK.pop()
