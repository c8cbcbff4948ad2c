"""SARA dispatch layer: every model GEMM goes through ``gemm(x, w, site=)``.

``gemm`` asks the active dispatcher (``context.use``) for the (M, K, N)
tile recommendation, clamps the blocks to the operand extent, records the
executed configuration in the active ``SiteRegistry``, and runs the RSA
GEMM kernel (CUDA tensors) or its plain version (CPU tensors, or
``execute="torch"``).
"""

from repro_torch.dispatch.context import (EXECUTE_MODES, DispatchPolicy,
                                          active, default_registry,
                                          use)
from repro_torch.dispatch.executor import gemm
from repro_torch.dispatch.registry import SiteRecord, SiteRegistry

__all__ = ["EXECUTE_MODES", "DispatchPolicy", "SiteRecord", "SiteRegistry",
           "active", "default_registry", "gemm", "use"]
