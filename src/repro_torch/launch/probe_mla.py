"""Where a tile's time goes in the paged MLA kernel, on the card.

    PYTHONPATH=src python -m repro_torch.launch.probe_mla

Builds a copy of ``csrc/paged_mla.cu`` with ``clock64`` probes (thread 0
of each CTA records the cycle at fixed points) into ``build/probe_mla/``,
runs it at deepseek-v3's widths (128 heads, r = 512, rd = 64, pages of
16, bf16, L2 cold) on one lane's late prefill chunk (128 CTAs of 8 tiles
each, nearly one a SM) and on one decode lane of 4096 rows unsplit (2
CTAs, so nothing else contends), and prints, for the CTA that ran longest,
the cycles from its entry to: its length read (``limit``), its first
copies issued (``prologue``), and for each tile the tile landed (after the
ring's wait and barrier), S done (``scores``), the softmax and P written
(``softmax``), past the barrier that hands P to both halves (``p in``)
and P V done (``end``); then the loop's end.  Thread 0 is in half 0, which computes S
and the softmax while half 1 issues the next tile's copies.  The probes are a diagnostic: the copy is
never the kernel the port runs.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_mla import _mla_plan
from repro_torch.launch.bench_mla import BS, H, QK, R, RD, mla_inputs

NPROBE = 128
# (anchor in the source, probe inserted before it) - each anchor once
PROBES = [
    ("  const int rows_lane = p.C * p.H;\n", "  PROBE(0);\n"),
    ("  const int c_end = min(limit, c_cap);\n", "  PROBE(1);\n"),
    ("  float o[NV][4], mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};\n",
     "  PROBE(2);\n"),
    ("    float cr0, cr1;                               // this tile's O "
     "corrections\n", "    if (t < 24) PROBE(3 + 5 * t);\n"),
    ("      // online softmax in log2 units",
     "      if (t < 24) PROBE(4 + 5 * t);\n"),
    ("    __syncthreads();                              // p and the "
     "corrections are in\n", "    if (t < 24) PROBE(5 + 5 * t);\n"),
    ("    if (half == 1) {\n      cr0 = csh[r0];",
     "    if (t < 24) PROBE(6 + 5 * t);\n"),
    ("  }\n  cp_async_wait<0>();\n",
     "    if (t < 24) PROBE(7 + 5 * t);\n"),
    ("  // l: half 0's quad shares", "  PROBE(123);\n"),
]
HEADER = (
    "__device__ long long g_probe[1024 * %d];\n"
    "#define PROBE(e) do { if (threadIdx.x == 0) { const int cta_ = "
    "(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; "
    "if (cta_ < 1024) g_probe[cta_ * %d + (e)] = clock64(); } } while (0)\n"
) % (NPROBE, NPROBE)
FOOTER = (
    '\nextern "C" int probe_read(long long* host) { return (int)'
    "cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * 1024 * %d); }\n"
    'extern "C" int probe_clear() { static long long z[1024 * %d]; return '
    "(int)cudaMemcpyToSymbol(g_probe, z, sizeof(z)); }\n") % (NPROBE, NPROBE)


def build() -> ctypes.CDLL:
    """The instrumented library, with the kernel's launch signatures."""
    src = (_build.CSRC / "paged_mla.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        src = src.replace(anchor, probe + anchor)
    out = _build.BUILD_DIR.parent / "probe_mla"
    out.mkdir(parents=True, exist_ok=True)
    (out / "paged_mla_probe.cu").write_text(src + FOOTER)
    lib = out / "paged_mla_probe.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(out / "paged_mla_probe.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES["paged_mla"].items():
        getattr(dll, fn).argtypes = argtypes
    dll.probe_read.argtypes = [ctypes.c_void_p]
    return dll


def run(dll, starts, chunks, lengths, sms):
    """One call (prefill when ``starts`` is given, else decode), cold L2;
    the probes of the CTA that ran longest, as cycles from its entry."""
    prefill = starts is not None
    lens_list = [s + c for s, c in zip(starts, chunks)] if prefill \
        else lengths
    ckv, kr, tables, lens, gen = mla_inputs(lens_list, torch.bfloat16)
    S, W = len(lens_list), tables.shape[1]
    C = 64 if prefill else 1
    shape = (S, C, H) if prefill else (S, H)
    qa = torch.randn(shape + (R,), generator=gen, device="cuda").bfloat16()
    qr = torch.randn(shape + (RD,), generator=gen, device="cuda").bfloat16()
    o = torch.empty_like(qa)
    plan = _mla_plan(S, C * H, W, BS, R, RD, 2, sms, splits=1)
    ptrs = (1, qa.data_ptr(), qr.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
            o.data_ptr(), tables.data_ptr())
    tail = (QK ** -0.5, plan.rows, plan.dv, plan.splits, plan.pages, None,
            None, None)
    if prefill:
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        args = ptrs + (st.data_ptr(), lens.data_ptr(), S, C, H, R, RD,
                       ckv.shape[0], BS, W) + tail
        launch = dll.paged_mla_prefill_launch
    else:
        args = ptrs + (lens.data_ptr(), S, H, R, RD, ckv.shape[0], BS,
                       W) + tail
        launch = dll.paged_mla_decode_launch
    launch(*args)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    torch.cuda.synchronize()
    dll.probe_clear()
    _build.check(launch(*args), "probed MLA attention")
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (1024 * NPROBE))()
    dll.probe_read(buf)
    rows = [buf[c * NPROBE:(c + 1) * NPROBE]
            for c in range(min(plan.ctas, 1024))]
    slow = max((r for r in rows if r[0]),
               key=lambda r: max(x for x in r if x) - r[0])
    return plan, {i: slow[i] - slow[0] for i in range(NPROBE) if slow[i]}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mla: needs a CUDA card")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dll = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, starts, chunks, lengths in (
            ("late prefill chunk", [448], [64], None),
            ("one decode lane of 4096, unsplit", None, None, [4096])):
        plan, c = run(dll, starts, chunks, lengths, sms)
        print(f"{name}, {plan.ctas} CTAs: cycles from entry of the longest "
              f"CTA: limit {c.get(1)} prologue {c.get(2)}")
        for t in range(24):
            if 3 + 5 * t in c:
                print(f"  tile {t}: landed {c[3 + 5 * t]} scores "
                      f"{c.get(4 + 5 * t)} softmax {c.get(5 + 5 * t)} p in "
                      f"{c.get(6 + 5 * t)} end {c.get(7 + 5 * t)}")
        print(f"  loop end {c.get(123)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
