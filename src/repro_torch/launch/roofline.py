"""A step's roofline terms and its kernels' device time — the port of the
roofline and profile parts of ``repro/launch/hlo_analysis.py``.

The reference models a step's time from its compiled HLO: it parses the
HLO for FLOPs, HBM bytes and collective bytes and divides each by a TPU
peak.  The card has no HLO to parse, so the port has no counterpart of
that parser; it measures instead.  ``RooflineTerms`` keeps the
reference's ideal terms (the model's FLOPs at the peak of the step's
dtype, its compulsory bytes at the memory rate) and sets them against
the step's measured wall ``step_s`` and its kernels' device time
``busy_s``.  ``profile_kernels`` and ``profile_by_kernel`` read those
kernels from a ``torch.profiler`` run, as ``profile_hlo`` and
``profile_by_opcode`` read instructions from the HLO.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hw import H100


@dataclass
class RooflineTerms:
    """Seconds, bytes and FLOPs of one step.  The ideal terms are the
    reference's (``model_flops`` at ``chips`` x the peak of ``dtype``,
    ``model_min_bytes`` at ``chips`` x the memory rate); ``step_s`` (the
    wall of a step, median of the timed runs) takes the place of the
    reference's modelled ``bound_s``.  ``busy_s`` is the device time of
    the kernels of one step run under the profiler and ``profiled_s`` that
    step's wall (both ``None`` where not measured, as on the CPU): the
    idle share sets them against each other, not against ``step_s``, so
    that the spread between steps cannot push it below 0."""
    model_flops: float
    model_min_bytes: float
    step_s: float = 0.0
    busy_s: Optional[float] = None
    profiled_s: Optional[float] = None
    dtype: str = "bfloat16"
    chips: int = 1
    chip: object = H100

    @property
    def peak_flops(self) -> float:
        return self.chip.peak_flops(self.dtype)

    @property
    def ideal_compute_s(self) -> float:
        return self.model_flops / (self.chips * self.peak_flops)

    @property
    def ideal_memory_s(self) -> float:
        return self.model_min_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def dominant(self) -> str:
        """The larger ideal term: what bounds the step on the roofline."""
        return ("compute" if self.ideal_compute_s >= self.ideal_memory_s
                else "memory")

    @property
    def bound_s(self) -> float:
        return max(self.ideal_compute_s, self.ideal_memory_s)

    @property
    def roofline_fraction(self) -> float:
        """time(MODEL_FLOPS at peak) / the step's wall — MFU-style."""
        if self.step_s <= 0:
            return 0.0
        return self.ideal_compute_s / self.step_s

    @property
    def memory_attainment(self) -> float:
        """compulsory bytes at the memory rate / the step's wall."""
        if self.step_s <= 0:
            return 0.0
        return self.ideal_memory_s / self.step_s

    @property
    def bound_attainment(self) -> float:
        """max(ideal compute, compulsory memory) / the step's wall: the
        roofline fraction that credits memory-bound steps (decode) with
        their unavoidable weight and cache traffic."""
        if self.step_s <= 0:
            return 0.0
        return self.bound_s / self.step_s

    @property
    def idle_share(self) -> Optional[float]:
        """The share of the profiled step's wall in which no kernel ran.
        Below 0 only where the kernel events overlap or count a kernel
        twice."""
        if self.busy_s is None or not self.profiled_s:
            return None
        return 1.0 - self.busy_s / self.profiled_s

    def to_dict(self) -> dict:
        return {
            "chip": getattr(self.chip, "name", type(self.chip).__name__),
            "chips": self.chips, "dtype": self.dtype,
            "peak_flops": self.peak_flops, "hbm_bw": self.chip.hbm_bw,
            "model_flops": self.model_flops,
            "model_min_bytes": self.model_min_bytes,
            "ideal_compute_s": self.ideal_compute_s,
            "ideal_memory_s": self.ideal_memory_s,
            "dominant": self.dominant, "bound_s": self.bound_s,
            "step_s": self.step_s, "busy_s": self.busy_s,
            "profiled_s": self.profiled_s,
            "idle_share": self.idle_share,
            "roofline_fraction": self.roofline_fraction,
            "memory_attainment": self.memory_attainment,
            "bound_attainment": self.bound_attainment,
        }


# ---------------------------------------------------------------------------
# profile: the kernels that took the device time
# ---------------------------------------------------------------------------

# the port's kernel families: a substring of the kernel's name on the card
# -> the family (rows of PERF.md's kernel table)
KERNEL_FAMILIES: Tuple[Tuple[str, str], ...] = (
    ("psum_wgmma", "rsa_gemm"), ("psum_f32", "rsa_gemm"),
    ("paged_decode_kernel", "paged_decode"),
    ("paged_attn_tc_kernel", "paged_prefill"),
    ("paged_mla_kernel", "paged_mla"),
    ("flash_fwd", "flash_fwd"), ("flash_dq", "flash_dq"),
    ("flash_dkv", "flash_dkv"),
    ("wkv_", "wkv"),
    ("adaptnetx_kernel", "adaptnetx"),
)


def kernel_family(name: str) -> Optional[str]:
    """The port's kernel family of a kernel name, or ``None`` for a kernel
    of torch's own."""
    for key, fam in KERNEL_FAMILIES:
        if key in name:
            return fam
    return None


def kernel_events(prof) -> List[Tuple[str, float]]:
    """(name, device µs) of every kernel a ``torch.profiler`` run recorded.

    The kernels' own events only: a CPU op's self device time is the time
    of the kernels it launched, which the kernel events count already (as
    torch's own table sums it), so counting both counts each kernel
    twice."""
    from torch.autograd import DeviceType
    return [(e.name, float(e.self_device_time_total))
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def _rows(events: List[Tuple[str, float]], key) -> List[dict]:
    busy = sum(us for _, us in events)
    agg: Dict[str, dict] = {}
    for name, us in events:
        k = key(name)
        r = agg.setdefault(k, {"kernel": k, "launches": 0, "device_ms": 0.0})
        r["launches"] += 1
        r["device_ms"] += us / 1e3
    for r in agg.values():
        r["share"] = r["device_ms"] * 1e3 / busy if busy > 0 else 0.0
    return sorted(agg.values(), key=lambda r: r["device_ms"], reverse=True)


def profile_kernels(prof, top: int = 25) -> List[dict]:
    """The ``top`` kernels by device time: name, launches, device ms and
    share of the kernels' whole device time (the counterpart of the
    reference's ``profile_hlo``)."""
    return _rows(kernel_events(prof), lambda n: n)[:top]


def profile_by_kernel(prof) -> List[dict]:
    """The same rows grouped by the port's kernel families, each of
    torch's own kernels a group of its own (the counterpart of the
    reference's ``profile_by_opcode``); ``family`` is ``None`` for
    torch's."""
    rows = _rows(kernel_events(prof), lambda n: kernel_family(n) or n)
    families = {fam for _, fam in KERNEL_FAMILIES}
    for r in rows:
        r["family"] = r["kernel"] if r["kernel"] in families else None
    return rows
