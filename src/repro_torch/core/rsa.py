"""RECONFIGURABLE SYSTOLIC ARRAY (RSA) configuration space.

An RSA instance is a grid of `systolic-cells` (4x4 MAC sub-grids in SAGAR,
paper §II-B) with muxed bypass links.  A *configuration* is:

  (sub-array rows a, sub-array cols b, dataflow in {OS, WS, IS})

where (a, b) are measured in cells and must tile the cell grid evenly
(a | grid_rows, b | grid_cols) — the partition grid is then
(grid_rows/a) x (grid_cols/b) identical sub-arrays, every one of them
simultaneously active on a slice of the GEMM (paper Fig. 5d).

The paper reports 858 raw configurations for 2^14 MACs but never states the
enumeration rule; we use the clean even-tiling space (DESIGN.md §2.1):
108 classes at 2^14 MACs (6 x 6 x 3), 90 at 2^13, 75 at 2^12.  The learning
problem is isomorphic: one categorical class per (shape, dims, dataflow).

A copy of the reference's ``repro/core/rsa.py`` (numpy only), so that
the port enumerates the same classes in the same order.  The SAGAR
configurations describe the paper's 28 nm array, which no kernel of the
port executes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.core.hw import DATAFLOW_NAMES, IS, OS, WS

CELL = 4                                  # MACs per systolic-cell edge


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclass(frozen=True)
class RSAInstance:
    """A physical RSA: cell grid of (grid_rows x grid_cols) systolic-cells."""
    grid_rows: int
    grid_cols: int

    @property
    def num_macs(self) -> int:
        return self.grid_rows * self.grid_cols * CELL * CELL

    @property
    def rows(self) -> int:
        return self.grid_rows * CELL

    @property
    def cols(self) -> int:
        return self.grid_cols * CELL


@dataclass(frozen=True)
class RSAConfig:
    """One runtime configuration (= one ADAPTNET output class)."""
    class_id: int
    sub_rows: int          # sub-array height in MACs
    sub_cols: int          # sub-array width in MACs
    part_rows: int         # partition grid height
    part_cols: int         # partition grid width
    dataflow: int          # OS | WS | IS

    @property
    def num_partitions(self) -> int:
        return self.part_rows * self.part_cols

    def describe(self) -> str:
        return (f"{self.part_rows}x{self.part_cols} grid of "
                f"{self.sub_rows}x{self.sub_cols} arrays, "
                f"{DATAFLOW_NAMES[self.dataflow]}")


def make_instance(num_macs: int) -> RSAInstance:
    """Cell grid for a power-of-two MAC budget (squarish, SAGAR layout)."""
    cells = num_macs // (CELL * CELL)
    import math
    r = 2 ** (int(math.log2(cells)) // 2)
    c = cells // r
    if c < r:
        r, c = c, r
    return RSAInstance(r, c)


SAGAR_INSTANCE = RSAInstance(32, 32)      # 2^14 MACs, paper §IV-B


def enumerate_configs(inst: RSAInstance) -> List[RSAConfig]:
    cfgs: List[RSAConfig] = []
    cid = 0
    for a in _divisors(inst.grid_rows):
        for b in _divisors(inst.grid_cols):
            for df in (OS, WS, IS):
                cfgs.append(RSAConfig(
                    class_id=cid,
                    sub_rows=a * CELL, sub_cols=b * CELL,
                    part_rows=inst.grid_rows // a,
                    part_cols=inst.grid_cols // b,
                    dataflow=df))
                cid += 1
    return cfgs


def config_table(inst: RSAInstance) -> dict:
    """Vectorized columns for the cost model: arrays of shape (n_configs,)."""
    cfgs = enumerate_configs(inst)
    return {
        "R": np.array([c.sub_rows for c in cfgs]),
        "C": np.array([c.sub_cols for c in cfgs]),
        "p": np.array([c.part_rows for c in cfgs]),
        "q": np.array([c.part_cols for c in cfgs]),
        "df": np.array([c.dataflow for c in cfgs]),
        "configs": cfgs,
    }
