"""Post-layout PPA arithmetic (paper §V-B, Fig. 13) — published constants.

RTL/PnR cannot run in software; what CAN be reproduced is the paper's PPA
*arithmetic*: given the published component numbers, recompute the headline
ratios (3.2x compute density, 3.5x power efficiency, <10% area / ~50% power
over monolithic, ADAPTNETX at 8.65% area / 1.36% power) and validate them in
tests/benchmarks.  Component breakdowns follow Fig. 13c-d.

A copy of the reference's ``repro/core/ppa.py``: the paper's published
28 nm numbers, not measurements of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hw import TECH_28NM


@dataclass(frozen=True)
class PPA:
    name: str
    area_mm2: float
    power_w: float
    tops: float

    @property
    def compute_density(self) -> float:        # TOPS / mm^2
        return self.tops / self.area_mm2

    @property
    def power_efficiency(self) -> float:       # TOPS / W
        return self.tops / self.power_w


# paper Fig. 13b-d (28 nm, 1 GHz, 2^14 MACs => 32.768 TOPS)
SAGAR = PPA("SAGAR", area_mm2=81.90, power_w=13.01, tops=32.768)

# monolithic 128x128: SAGAR is ~8% larger and ~50% more power (paper §V-B)
MONOLITHIC = PPA("monolithic-128x128", area_mm2=81.90 / 1.08,
                 power_w=13.01 / 1.50, tops=32.768)

# distributed 1024x 4x4 with mesh NoC: 3.2x SAGAR area, 3.5x SAGAR power
DISTRIBUTED_4x4 = PPA("distributed-1024x4x4", area_mm2=81.90 * 3.2,
                      power_w=13.01 * 3.5, tops=32.768)

# SIGMA comparison points (paper §V-C): SAGAR fits 45% more compute at equal
# area; compute-equivalent SIGMA takes ~43% more power and ~30% more area.
SIGMA_COMPUTE_EQ = PPA("SIGMA-compute-eq", area_mm2=81.90 / 0.70,
                       power_w=13.01 / 0.57, tops=32.768)

ADAPTNETX_AREA_MM2 = SAGAR.area_mm2 * TECH_28NM.adaptnetx_area_frac
ADAPTNETX_POWER_W = SAGAR.power_w * TECH_28NM.adaptnetx_power_frac


def headline_ratios() -> dict:
    return {
        "density_vs_distributed":
            SAGAR.compute_density / DISTRIBUTED_4x4.compute_density,
        "power_eff_vs_distributed":
            SAGAR.power_efficiency / DISTRIBUTED_4x4.power_efficiency,
        "area_overhead_vs_monolithic":
            SAGAR.area_mm2 / MONOLITHIC.area_mm2 - 1.0,
        "power_overhead_vs_monolithic":
            SAGAR.power_w / MONOLITHIC.power_w - 1.0,
        "adaptnetx_area_frac": TECH_28NM.adaptnetx_area_frac,
        "adaptnetx_power_frac": TECH_28NM.adaptnetx_power_frac,
        "sigma_compute_eq_power_saving":
            1.0 - SAGAR.power_w / SIGMA_COMPUTE_EQ.power_w,
        "sigma_compute_eq_area_saving":
            1.0 - SAGAR.area_mm2 / SIGMA_COMPUTE_EQ.area_mm2,
    }
