"""ADAPTNETX cycle/cost models (paper §IV-A, Fig. 9a).

Two ways to run ADAPTNET inference in hardware:

1. On `systolic-cells` borrowed from the main array: each dense layer is a
   GEMV on an r x c systolic sub-array (WS folds + skew fill).  The paper's
   best point: 1134 cycles at 1024 multipliers (64 cells).

2. On ADAPTNETX — a dedicated 1-D multiplier row + binary-tree reduction,
   input-stationary: the input vector is pinned at the multipliers, weight
   matrix rows stream through at 1 row/cycle/unit.  The paper's best point:
   576 cycles at 512 multipliers (2 units).

These closed forms land on the paper's numbers with no tuning beyond the
lookup-overhead constant (embedding + argmax + control ~ a few tens of
cycles).

A copy of the reference's ``repro/core/adaptnetx_model.py``: the cycles
of the paper's ADAPTNETX hardware, a model.  The port's ADAPTNETX kernel
(``kernels/adaptnetx.py``) computes the same net on the H100; its times
are measured by ``chip_smoke.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core.adaptnet import EMBED_DIM, HIDDEN

LOOKUP_CYCLES = 12          # 3 embedding row fetches (SRAM) + concat control
ARGMAX_CYCLES_PER_8 = 1     # comparator tree on the output vector


def adaptnet_layer_dims(num_classes: int) -> List[Tuple[int, int]]:
    return [(3 * EMBED_DIM, HIDDEN), (HIDDEN, num_classes)]


def cycles_on_systolic_cells(num_multipliers: int, num_classes: int,
                             cell: int = 4) -> int:
    """GEMV on a square-ish array of 4x4 systolic cells, WS dataflow."""
    cells = max(1, num_multipliers // (cell * cell))
    r_cells = 2 ** (int(math.log2(cells)) // 2)
    c_cells = cells // r_cells
    R, C = r_cells * cell, c_cells * cell
    total = LOOKUP_CYCLES
    for din, dout in adaptnet_layer_dims(num_classes):
        folds = math.ceil(din / R) * math.ceil(dout / C)
        # per fold: preload R rows of weights, stream 1 input row + skew
        total += folds * (R + C + 1 - 1)
    total += math.ceil(num_classes / 8) * ARGMAX_CYCLES_PER_8
    return total


def cycles_on_adaptnetx(num_multipliers: int, num_classes: int,
                        units: int = 2) -> int:
    """1-D IS units with binary-tree reduction (paper Fig. 9b)."""
    m_per_unit = max(1, num_multipliers // units)
    total = LOOKUP_CYCLES
    for din, dout in adaptnet_layer_dims(num_classes):
        chunks = math.ceil(din / m_per_unit)      # passes over the input vec
        tree = math.ceil(math.log2(min(din, m_per_unit))) + 1
        # one output/cycle/unit sustained; fill = tree depth
        total += math.ceil(dout / units) * chunks + tree
    total += math.ceil(num_classes / 8) * ARGMAX_CYCLES_PER_8
    return total


@dataclass
class AdaptNetXDesign:
    num_multipliers: int = 512
    units: int = 2
    sram_kb: int = 512           # embedding tables + weights (paper §IV-B)

    def cycles(self, num_classes: int) -> int:
        return cycles_on_adaptnetx(self.num_multipliers, num_classes,
                                   self.units)

    def model_bytes(self, num_classes: int) -> int:
        """1 byte/weight (int8): tables dominate (paper footnote 1)."""
        from repro_torch.core.adaptnet import VOCAB
        table = 3 * VOCAB * EMBED_DIM
        dense = (3 * EMBED_DIM) * HIDDEN + HIDDEN * num_classes
        return table + dense


def sweep_multipliers(num_classes: int, points=(64, 128, 256, 512, 1024, 2048)):
    return {
        "systolic_cells": {m: cycles_on_systolic_cells(m, num_classes)
                           for m in points},
        "adaptnetx": {m: cycles_on_adaptnetx(m, num_classes)
                      for m in points},
    }
