"""Where a tile's time goes in the prefill / shared-prefix kernel, on the card.

    PYTHONPATH=src python -m repro_torch.launch.probe_attn

Builds a copy of ``csrc/paged_attn.cu`` with ``clock64`` probes (thread 0
of each CTA records the cycle at fixed points) into ``build/probe_attn/``,
runs the shared-prefix phase at llama3.2-1b's widths (8 lanes, 8 kv heads,
G = 4, hd 64, bf16, pages of 16) over a 128-page prefix unsplit and over
phase 5's 24-page prefix under its plan, and prints, for the CTA that ran
longest, the cycles from its entry to: its lengths read (``limit``), its
first copies issued (``prologue``), and for each tile the tile landed
(after the ring's wait and barrier, before the next tile's copies are
issued), the scores done (``softmax``), the softmax done (``pv``) and p @ V
issued (``end``); then the loop's end, the split's ticket and the merge's
end.  The probes are a diagnostic: the copy is never the kernel the port
runs.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import _attn_plan

KVH, G, HD, BS = 8, 4, 64, 16
NPROBE = 128
# (anchor in the source, probe inserted before it) - each anchor once
PROBES = [
    ("  const int* trow = p.tables + (long long)s * p.W;\n  const int span",
     "  PROBE(0);\n"),
    ("  const int c_end = min(limit, c_cap);\n", "  PROBE(1);\n"),
    ("  float o[NV][4], mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};\n",
     "  PROBE(2);\n"),
    ("      if (nxt < ntiles) load(nxt % STAGES);\n",
     "      if (t < 30) PROBE(3 + 4 * t);\n"),
    ("      const float mn0 = fmaxf(mrow[0], quad_max(mx0))",
     "      if (t < 30) PROBE(4 + 4 * t);\n"),
    ("      // O += P V, p in the value type\n",
     "      if (t < 30) PROBE(5 + 4 * t);\n"),
    ("    if constexpr (STAGES == 1) __syncthreads();   // the stage is "
     "refilled next\n", "    if (t < 30) PROBE(6 + 4 * t);\n"),
    ("  lrow[0] = quad_sum(lrow[0]);\n", "  PROBE(123);\n"),
    ("  if (!last) return;\n  __threadfence();\n  if (active) {",
     "  PROBE(124);\n"),
    ("  if (tid == 0) p.tickets[unit] = 0;\n}\n\ntemplate <typename T, int D,"
     " int STAGES>\nint launch_attn", "  PROBE(125);\n"),
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
    src = (_build.CSRC / "paged_attn.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        src = src.replace(anchor, probe + anchor)
    out = _build.BUILD_DIR.parent / "probe_attn"
    out.mkdir(parents=True, exist_ok=True)
    (out / "paged_attn_probe.cu").write_text(src + FOOTER)
    lib = out / "paged_attn_probe.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(lib),
                        str(out / "paged_attn_probe.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES["paged_attn"].items():
        getattr(dll, fn).argtypes = argtypes
    dll.probe_read.argtypes = [ctypes.c_void_p]
    return dll


def run(dll, P, splits, sms):
    """One call of the prefix phase over P pages, cold L2; the probes of the
    CTA that ran longest, as cycles from its entry."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(P)
    pages = list(range(P)) + [P - 1] * 8
    k, v = (torch.randn((P, BS, KVH, HD), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    q = torch.randn((8, KVH * G, HD), generator=gen, device="cuda").bfloat16()
    i32 = dict(dtype=torch.int32, device="cuda")
    pg = torch.tensor(pages, **i32)
    pl = torch.tensor([P * BS] * 8, **i32)
    plan = _attn_plan(1, 8 * G, KVH, len(pages), BS, HD, HD, 2, sms,
                      splits=splits)
    o = torch.empty_like(q)
    m = torch.empty((8, KVH * G), device="cuda")
    l = torch.empty_like(m)
    ws = torch.empty(max(plan.ws_elems, 1), device="cuda")
    tickets = torch.zeros(max(plan.units, 1), **i32)
    args = (1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), pg.data_ptr(), pl.data_ptr(), 8, KVH,
            G, HD, HD, P, BS, len(pages), HD ** -0.5, 0.0, plan.width,
            plan.splits, plan.pages, ws.data_ptr(), tickets.data_ptr(), None)
    dll.paged_prefix_launch(*args)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    torch.cuda.synchronize()
    dll.probe_clear()
    _build.check(dll.paged_prefix_launch(*args), "probed prefix attention")
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
        print("probe_attn: needs a CUDA card")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dll = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for P, splits in ((128, 1), (24, None)):
        plan, c = run(dll, P, splits, sms)
        print(f"prefix over {P} pages, {plan.splits} splits x {plan.units} "
              f"units: cycles from entry of the longest CTA: limit "
              f"{c.get(1)} prologue {c.get(2)}")
        for t in range(30):
            if 3 + 4 * t in c:
                print(f"  tile {t}: landed {c[3 + 4 * t]} softmax "
                      f"{c.get(4 + 4 * t)} pv {c.get(5 + 4 * t)} end "
                      f"{c.get(6 + 4 * t)}")
        print(f"  loop end {c.get(123)} ticket {c.get(124)} merged "
              f"{c.get(125)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
