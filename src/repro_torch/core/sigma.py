"""SIGMA analytical performance model (paper §V-C, Fig. 14).

SIGMA [30] streams operands over a Benes network directly to a flexible
multiplier substrate and reduces partial sums through a forest of adder
trees (FAN).  The paper's comparison uses SIGMA's own analytical model:
time to (a) stream operands, (b) multiply, (c) reduce — sparsity-aware.

Closed form used here (per GEMM M x K x N, `flex` multipliers, density d):
  useful_macs   = M*K*N * d
  rounds        = ceil(useful_macs / flex)     (1 round/cycle, pipelined)
  fill          = K*d / bw + log2(K)           (first-operand distribution +
                                                adder-tree latency; streaming
                                                overlaps with compute after
                                                the pipeline fills)
This reproduces the paper's Fig.-14 ordering with no store-and-forward
penalty: SIGMA_C (compute-normalized, 16384 MACs) slightly beats SAGAR on
dense workloads; SIGMA_A (area-normalized, 2734 MACs) is ~6x slower and only
overtakes SAGAR beyond ~70-85% operand sparsity.

A copy of the reference's ``repro/core/sigma.py`` (numpy only); its
cycles are model numbers.
"""

from __future__ import annotations

import numpy as np

SIGMA_C_MACS = 16384
SIGMA_A_MACS = 2734
BW_FACTOR = 16.0            # Benes delivers a K-slice in K/16 cycles


def sigma_runtime(M, K, N, *, num_macs: int = SIGMA_C_MACS,
                  density: float = 1.0) -> np.ndarray:
    M = np.asarray(M, np.float64)
    K = np.asarray(K, np.float64)
    N = np.asarray(N, np.float64)
    useful = M * K * N * density
    rounds = np.ceil(useful / num_macs)
    fill = np.maximum(K * density / BW_FACTOR, 1.0) + \
        np.log2(np.maximum(K, 2.0))
    return rounds + fill


def sigma_c_runtime(M, K, N, density: float = 1.0):
    return sigma_runtime(M, K, N, num_macs=SIGMA_C_MACS, density=density)


def sigma_a_runtime(M, K, N, density: float = 1.0):
    return sigma_runtime(M, K, N, num_macs=SIGMA_A_MACS, density=density)
