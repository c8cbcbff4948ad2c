"""Hardware constants.

``GPUChip`` describes the card the port runs on: ``H100`` holds the
published peaks of one NVIDIA H100 SXM (dense rates, no sparsity, at its
700 W limit), the ones ``chip_smoke.py``'s bounds and the step roofline
(``launch/roofline.py``) divide by.

Two more hardware models live here, both copied from the reference
(``repro/core/hw.py``):

1. ``TPUChip``, the chip the recommender's tile cost model
   (``core/tpu_costmodel.py``) prices configurations against, so that the
   port recommends exactly the tile the reference does.  It does not
   describe the H100 the port runs on; an H100 tile space is later work
   (ROADMAP queue 1 item 14).  Its one addition, ``peak_flops``, gives
   the step roofline the reference's divisor.
2. ``AcceleratorTech``, the paper's 28 nm accelerator technology constants
   that the SAGAR cost model (``core/costmodel.py``) and the PPA
   arithmetic (``core/ppa.py``) read.  They describe the paper's array,
   which no kernel of the port executes: every cycle, energy and EDP
   derived from them is a model number.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPUChip:
    """One GPU's published peaks: the counterpart of the reference
    roofline's ``TPU_V5E`` (``repro/launch/hlo_analysis.py``)."""
    name: str = "NVIDIA H100 80GB HBM3, 700 W"
    peak_bf16_flops: float = 989e12     # dense bf16 on the tensor cores
    peak_f32_flops: float = 67e12       # f32 outside the tensor cores
    hbm_bw: float = 3.35e12             # HBM3 bytes/s
    hbm_bytes: float = 80e9

    def peak_flops(self, dtype: str) -> float:
        """The peak of a step computing in ``dtype`` ("float32" runs on
        the CUDA cores: TF32 is off, as the reference's f32 training)."""
        return self.peak_f32_flops if dtype == "float32" else \
            self.peak_bf16_flops


H100 = GPUChip()


@dataclass(frozen=True)
class TPUChip:
    peak_bf16_flops: float = 197e12
    hbm_bw: float = 819e9
    ici_link_bw: float = 50e9
    hbm_bytes: float = 16e9
    vmem_bytes: float = 16 * 2 ** 20
    mxu_dim: int = 128

    def peak_flops(self, dtype: str) -> float:
        """The bf16 peak whatever ``dtype``, as the reference's roofline
        divides by it."""
        return self.peak_bf16_flops


TPU_V5E = TPUChip()


@dataclass(frozen=True)
class AcceleratorTech:
    freq_hz: float = 1e9                # SAGAR runs at 1 GHz (paper §V-B)
    # per-op energies (28nm-class, pJ) — Dally et al. CACM'20 + Horowitz
    # ISSCC'14 scaling; the paper cites 100 fJ/bit-mm wire energy.
    e_mac_pj: float = 1.0               # one 8-bit-ish MAC
    e_sram_read_pj_per_byte: float = 6.0
    e_sram_write_pj_per_byte: float = 8.0
    e_dram_pj_per_byte: float = 160.0
    e_wire_fj_per_bit_mm: float = 100.0
    e_noc_hop_pj_per_byte: float = 2.0  # mesh NoC hop (router+link)
    # NoC latency per hop (cycles) for the distributed baseline (OpenSMART)
    noc_hop_cycles: float = 1.0
    # SAGAR bypass pipelining: 8 systolic-cells per pipeline stage (Fig 13h)
    bypass_cells_per_stage: int = 8

    # published PnR numbers (paper Fig. 13b) used by core/ppa.py
    sagar_area_mm2: float = 81.90
    sagar_power_w: float = 13.01
    sagar_tops: float = 32.768
    adaptnetx_area_frac: float = 0.0865
    adaptnetx_power_frac: float = 0.0136


TECH_28NM = AcceleratorTech()


# Dataflow ids (paper: output/weight/input stationary)
OS, WS, IS = 0, 1, 2
DATAFLOW_NAMES = {OS: "OS", WS: "WS", IS: "IS"}
