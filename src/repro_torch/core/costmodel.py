"""SCALE-Sim-equivalent analytical cost model for systolic GEMM.

Closed forms (validated by hand + property tests) replace cycle-accurate
simulation so that labeling ~10^6 workloads takes seconds on one core
instead of the paper's week on ~200 Xeons (DESIGN.md §2).

Per-pass runtime on an R x C MAC array (SCALE-Sim §III conventions):
  OS: map M->R, N->C, stream K:     T = 2R + C + K - 2
  WS: preload KxN tile, stream M:   T = R + C + M - 1
  IS: preload KxM tile, stream N:   T = R + C + N - 1
Folds (serialization steps over the partition grid p x q):
  OS: ceil(ceil(M/R)/p) * ceil(ceil(N/C)/q)
  WS: ceil(ceil(K/R)/p) * ceil(ceil(N/C)/q)
  IS: ceil(ceil(K/R)/p) * ceil(ceil(M/C)/q)

System kinds:
  MONOLITHIC  — p=q=1, no extra latency.
  RSA (SAGAR) — partitions fed by pipelined bypass links: +ceil(cells/8)
                pipeline fill per pass (paper Fig. 13h), UNIFIED scratchpad:
                reads are multicast-collated, so reads match an equivalent
                monolithic array (the paper's headline reuse property).
  DISTRIBUTED — independent units behind a mesh NoC: per-pass operand
                distribution latency of HOP_CYCLES * 2*sqrt(P) cycles
                (round-trip across the mesh diameter), and per-unit SRAM
                streams with NO collation: reads scale with the number of
                active units.  HOP_CYCLES=8 is the single calibrated
                constant, chosen so the Fig.-3 motivating GEMM reproduces
                the paper's reported optimum (32x32, ~2x over monolithic);
                the 4x SRAM-read excess of the 32x32 distributed config is
                reproduced with no calibration (it is structural).

Energy (paper Fig. 11d narrative): fine-grained gating is impractical, so
every MAC burns every cycle => E_compute = num_macs * T * e_mac; SRAM reads
dominate the rest; distributed adds NoC hop energy; EDP = E * T.

A copy of the reference's ``repro/core/costmodel.py`` (numpy only): the
same float64 expressions in the same order, so every cost and every
oracle label is the reference's bit for bit.  Its cycles, energies and
EDPs are model numbers for the paper's 28 nm array, not measurements of
the H100 the port runs on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.hw import IS, OS, TECH_28NM, WS
from repro_torch.core.rsa import CELL, RSAInstance, config_table

HOP_CYCLES = 8.0          # mesh-NoC hop (calibrated, see module docstring)
# RSA bypass links are SMART-style pipelined wires (paper §II-C), not a
# packet-switched NoC: staging operands into P concurrent partitions costs
# ~2*sqrt(P) cycles per pass at 1 cycle/stage — 8x cheaper than the mesh.
# This is the term that makes the optimal partitioning workload-dependent
# (interior optima, paper Fig. 7c) instead of degenerating to finest-grid.
RSA_STAGE_CYCLES = 1.0
BYTES_PER_ELEM = 1        # int8 operands (32.768 TOPS at 2^14 MACs @ 1 GHz)

MONOLITHIC = "monolithic"
RSA = "rsa"
DISTRIBUTED = "distributed"


def _ceil_div(a, b):
    return -(-a // b)


@dataclass
class GEMMCost:
    runtime: np.ndarray           # cycles
    sram_reads: np.ndarray        # element reads
    sram_writes: np.ndarray       # element writes
    energy_pj: np.ndarray
    edp: np.ndarray               # pJ * cycles
    theoretical_min_cycles: np.ndarray
    theoretical_min_reads: np.ndarray


def gemm_cost(M, K, N, R, C, p, q, df, *, system: str = RSA,
              num_macs_total: int | None = None) -> GEMMCost:
    """Vectorized cost.  All of (M,K,N) and (R,C,p,q,df) broadcast together.

    (M,K,N): workload dims;  (R,C): sub-array MAC dims;  (p,q): partition
    grid;  df: dataflow id;  system: MONOLITHIC | RSA | DISTRIBUTED.
    """
    M = np.asarray(M, np.float64)
    K = np.asarray(K, np.float64)
    N = np.asarray(N, np.float64)
    R = np.asarray(R, np.float64)
    C = np.asarray(C, np.float64)
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    df = np.asarray(df)

    P = p * q
    macs = R * C * P if num_macs_total is None else float(num_macs_total)

    # ---- folds per partition ---------------------------------------------
    fM_R = _ceil_div(M, R)
    fN_C = _ceil_div(N, C)
    fK_R = _ceil_div(K, R)
    fM_C = _ceil_div(M, C)
    folds_os = _ceil_div(fM_R, p) * _ceil_div(fN_C, q)
    folds_ws = _ceil_div(fK_R, p) * _ceil_div(fN_C, q)
    folds_is = _ceil_div(fK_R, p) * _ceil_div(fM_C, q)
    folds = np.where(df == OS, folds_os,
                     np.where(df == WS, folds_ws, folds_is))

    # ---- per-pass latency ---------------------------------------------------
    t_os = 2 * R + C + K - 2
    t_ws = R + C + M - 1
    t_is = R + C + N - 1
    t_pass = np.where(df == OS, t_os, np.where(df == WS, t_ws, t_is))

    if system == DISTRIBUTED:
        t_pass = t_pass + HOP_CYCLES * 2.0 * np.sqrt(P)
    elif system == RSA:
        # pipelined bypass staging (see RSA_STAGE_CYCLES) + relay fill of
        # ceil(cells spanned / 8) (paper Fig. 13h)
        cells_span = np.maximum(p * R, q * C) / CELL
        t_pass = (t_pass + RSA_STAGE_CYCLES * 2.0 * np.sqrt(P) +
                  _ceil_div(cells_span, TECH_28NM.bypass_cells_per_stage))
    runtime = folds * t_pass

    # ---- SRAM traffic -------------------------------------------------------
    # streams per pass on one unit (operands entering the array edges):
    stream_os = (R + C) * K
    stream_ws = R * C + M * R            # preload W + stream inputs
    stream_is = R * C + N * R
    stream = np.where(df == OS, stream_os,
                      np.where(df == WS, stream_ws, stream_is))
    if system == DISTRIBUTED:
        reads = folds * P * stream       # every unit streams privately
    elif system == RSA:
        # unified SRAM, multicast by read collation (paper §II-D): per global
        # step the array reads p*R rows + q*C cols ONCE each.
        coll_os = (p * R + q * C) * K
        coll_ws = p * R * q * C + M * p * R
        coll_is = p * R * q * C + N * p * R
        reads = folds * np.where(df == OS, coll_os,
                                 np.where(df == WS, coll_ws, coll_is))
    else:
        reads = folds * stream

    # psum read-modify-write when K is folded (WS/IS)
    k_folds = np.where(df == OS, 1.0, fK_R)
    writes = M * N + (k_folds - 1) * M * N        # final + partial writes
    reads = reads + (k_folds - 1) * M * N         # partial re-reads

    # ---- energy -------------------------------------------------------------
    # Fine-grained (per-MAC) gating is impractical (paper §V-A), but whole
    # idle PARTITIONS gate at the bypass-mux boundary: active fraction =
    # tiles_mapped / (folds * P).  This is what makes the energy-optimal
    # geometry workload-dependent (Fig. 7c).
    tiles_os = fM_R * fN_C
    tiles_ws = fK_R * fN_C
    tiles_is = fK_R * fM_C
    tiles = np.where(df == OS, tiles_os,
                     np.where(df == WS, tiles_ws, tiles_is))
    occupancy = np.minimum(1.0, tiles / np.maximum(folds * P, 1.0))
    t = TECH_28NM
    e_compute = macs * occupancy * runtime * t.e_mac_pj
    e_sram = (reads * t.e_sram_read_pj_per_byte +
              writes * t.e_sram_write_pj_per_byte) * BYTES_PER_ELEM
    e_noc = np.zeros_like(e_sram)
    if system == DISTRIBUTED:
        hops = np.sqrt(P)
        e_noc = reads * hops * t.e_noc_hop_pj_per_byte * BYTES_PER_ELEM
    e_dram = (M * K + K * N + M * N) * t.e_dram_pj_per_byte * BYTES_PER_ELEM
    energy = e_compute + e_sram + e_noc + e_dram
    edp = energy * runtime

    return GEMMCost(
        runtime=runtime,
        sram_reads=reads,
        sram_writes=writes,
        energy_pj=energy,
        edp=edp,
        theoretical_min_cycles=np.maximum(M * N * K / macs, 1.0),
        theoretical_min_reads=M * K + K * N,
    )


# ---------------------------------------------------------------------------
# RSA-wide sweep: cost of every configuration for a batch of workloads
# ---------------------------------------------------------------------------

def sweep_configs(inst: RSAInstance, M, K, N, *, system: str = RSA
                  ) -> GEMMCost:
    """Cost of all configs (axis -1) for workloads (leading axes)."""
    tab = config_table(inst)
    M = np.asarray(M, np.float64)[..., None]
    K = np.asarray(K, np.float64)[..., None]
    N = np.asarray(N, np.float64)[..., None]
    return gemm_cost(M, K, N, tab["R"], tab["C"], tab["p"], tab["q"],
                     tab["df"], system=system,
                     num_macs_total=inst.num_macs)


def best_config(inst: RSAInstance, M, K, N, *, system: str = RSA,
                objective: str = "runtime") -> np.ndarray:
    """Oracle labels: argmin config id per workload (ties -> fewer reads,
    then lower id, deterministically)."""
    cost = sweep_configs(inst, M, K, N, system=system)
    key1 = cost.runtime if objective == "runtime" else cost.edp
    # lexicographic argmin via epsilon tie-breaking on reads
    key = key1 * (1.0 + 1e-12) + cost.sram_reads * 1e-9 / (
        1.0 + cost.sram_reads.max(axis=-1, keepdims=True))
    return np.argmin(key, axis=-1)


def oracle_runtime(inst: RSAInstance, M, K, N, *, system: str = RSA
                   ) -> np.ndarray:
    cost = sweep_configs(inst, M, K, N, system=system)
    return cost.runtime.min(axis=-1)


def runtime_of_class(inst: RSAInstance, M, K, N, class_ids) -> np.ndarray:
    cost = sweep_configs(inst, M, K, N, system=RSA)
    return np.take_along_axis(cost.runtime,
                              np.asarray(class_ids)[..., None],
                              axis=-1)[..., 0]


# fixed-configuration systems (paper baselines, Table III)
def monolithic_cost(M, K, N, rows: int, cols: int, df) -> GEMMCost:
    return gemm_cost(M, K, N, rows, cols, 1, 1, df, system=MONOLITHIC)


def distributed_cost(M, K, N, unit_rows: int, unit_cols: int,
                     num_units: int, df) -> GEMMCost:
    import math
    pr = int(math.isqrt(num_units))
    qc = num_units // pr
    return gemm_cost(M, K, N, unit_rows, unit_cols, pr, qc, df,
                     system=DISTRIBUTED)


def best_dataflow_cost(cost_fn, M, K, N, *args) -> Dict[str, np.ndarray]:
    """min over the three dataflows for fixed-geometry systems."""
    runs = []
    for df in (OS, WS, IS):
        c = cost_fn(M, K, N, *args, df)
        runs.append(c)
    runtime = np.stack([c.runtime for c in runs])
    reads = np.stack([c.sram_reads for c in runs])
    energy = np.stack([c.energy_pj for c in runs])
    edp = np.stack([c.edp for c in runs])
    idx = np.argmin(runtime, axis=0)
    take = lambda a: np.take_along_axis(a, idx[None], axis=0)[0]
    return {"runtime": take(runtime), "sram_reads": take(reads),
            "energy_pj": take(energy), "edp": take(edp), "dataflow": idx}
