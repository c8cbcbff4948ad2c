"""Constants of the recommender's tile space.

``TPUChip`` is the hardware model the tile cost model
(``core/tpu_costmodel.py``) prices configurations against.  It is copied
unchanged from the reference (``repro/core/hw.py``) so that the port
recommends exactly the tile the reference does; it does not describe the
H100 the port runs on.  An H100 tile space is later work (ROADMAP queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TPUChip:
    peak_bf16_flops: float = 197e12
    hbm_bw: float = 819e9
    ici_link_bw: float = 50e9
    hbm_bytes: float = 16e9
    vmem_bytes: float = 16 * 2 ** 20
    mxu_dim: int = 128


TPU_V5E = TPUChip()


# Dataflow ids (paper: output/weight/input stationary)
OS, WS, IS = 0, 1, 2
DATAFLOW_NAMES = {OS: "OS", WS: "WS", IS: "IS"}
