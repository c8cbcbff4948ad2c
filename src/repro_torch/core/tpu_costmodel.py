"""The RSA configuration space the recommender searches (copied verbatim
from ``repro/core/tpu_costmodel.py``; the sharding planner is left out).

The MXU is a 128x128 systolic array; the runtime-reconfigurable knobs on a
TPU GEMM are the Pallas BlockSpec tiling (block_m, block_n, block_k) and the
residency mode (which operand's tile stays pinned in VMEM while the others
stream — the dataflow analogue):

  OS: C tile resident, K streamed     traffic = MK*Nt + KN*Mt + MN
  WS: B tile resident, M streamed     traffic = KN + MK*Nt + MN*(2Kt-1)
  IS: A tile resident, N streamed     traffic = MK + KN*Mt + MN*(2Kt-1)

(Xt = number of tiles along X.)  Cost = max(compute, memory) under MXU
alignment padding; configs whose working set exceeds VMEM are infeasible.
The best config is workload-dependent in exactly the way the paper's Fig. 7c
shows for the RSA — ADAPTNET-TPU learns this space (core/sara.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.hw import IS, OS, TPU_V5E, WS

BLOCK_MN = (128, 256, 512)
BLOCK_K = (128, 256, 512, 1024, 2048)
DTYPE_BYTES = 2            # bf16


@dataclass(frozen=True)
class TPUTileConfig:
    class_id: int
    block_m: int
    block_n: int
    block_k: int
    mode: int              # OS | WS | IS

    def describe(self) -> str:
        from repro_torch.core.hw import DATAFLOW_NAMES
        return (f"bm={self.block_m} bn={self.block_n} bk={self.block_k} "
                f"{DATAFLOW_NAMES[self.mode]}")


def enumerate_tile_configs() -> List[TPUTileConfig]:
    out = []
    cid = 0
    for bm in BLOCK_MN:
        for bn in BLOCK_MN:
            for bk in BLOCK_K:
                for mode in (OS, WS, IS):
                    out.append(TPUTileConfig(cid, bm, bn, bk, mode))
                    cid += 1
    return out


TILE_CONFIGS = enumerate_tile_configs()
NUM_TILE_CLASSES = len(TILE_CONFIGS)


def _cols():
    return (np.array([c.block_m for c in TILE_CONFIGS]),
            np.array([c.block_n for c in TILE_CONFIGS]),
            np.array([c.block_k for c in TILE_CONFIGS]),
            np.array([c.mode for c in TILE_CONFIGS]))


def tile_cost_seconds(M, K, N) -> np.ndarray:
    """(workloads..., n_configs) estimated per-chip GEMM time."""
    bm, bn, bk, mode = _cols()
    M = np.asarray(M, np.float64)[..., None]
    K = np.asarray(K, np.float64)[..., None]
    N = np.asarray(N, np.float64)[..., None]

    Mt = np.ceil(M / bm)
    Nt = np.ceil(N / bn)
    Kt = np.ceil(K / bk)
    # compute with padding to full tiles (MXU runs whole blocks)
    flops = 2.0 * (Mt * bm) * (Nt * bn) * (Kt * bk)
    t_compute = flops / TPU_V5E.peak_bf16_flops

    traffic_os = M * K * Nt + K * N * Mt + M * N
    traffic_ws = K * N + M * K * Nt + M * N * (2 * Kt - 1)
    traffic_is = M * K + K * N * Mt + M * N * (2 * Kt - 1)
    traffic = np.where(mode == OS, traffic_os,
                       np.where(mode == WS, traffic_ws, traffic_is))
    t_mem = traffic * DTYPE_BYTES / TPU_V5E.hbm_bw

    # VMEM feasibility: resident + streaming double-buffers
    vmem = (bm * bk + bk * bn + bm * bn) * 2 * DTYPE_BYTES
    feasible = vmem <= TPU_V5E.vmem_bytes
    t = np.maximum(t_compute, t_mem)
    return np.where(feasible, t, np.inf)


def best_tile_config(M, K, N) -> np.ndarray:
    """Argmin with a deterministic physical tie-break: the max(compute, mem)
    roofline plateaus across many tilings for small GEMMs, so near-ties
    (within 1%) prefer fewer grid launches, then larger K blocks (less
    accumulator churn) — the same rule a human kernel engineer applies."""
    bm, bn, bk, _ = _cols()
    t = tile_cost_seconds(M, K, N)
    Mb = np.asarray(M, np.float64)[..., None]
    Nb = np.asarray(N, np.float64)[..., None]
    grid = np.ceil(Mb / bm) * np.ceil(Nb / bn)
    grid = grid / grid.max()
    key = t * (1.0 + 0.01 * grid + 1e-4 * (1.0 - bk / max(BLOCK_K)))
    return np.argmin(key, axis=-1)
