"""Where the ADAPTNETX kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.probe_adaptnetx

Builds a copy of ``csrc/adaptnetx.cu`` with probes into
``build/probe_adaptnetx/``: thread 0 of each CTA reads the global timer
(ns, one clock for every SM) and ``clock64`` at the points of
``POINTS``, each placed before a comment of the source.  The probed
kernel runs at E = 16, H = 128, C = 135 (path A's widths, f32,
tables of 10 001 rows) for one query under the plan and the variants in
``PROBED`` and for a batch of 64 under the plan, 7 times each with L2
flushed before each run and 7 times without (the same launch again, its
code, arguments and weights cached); for each point it prints the median
over the runs of the latest CTA's time since the launch's first CTA
entered, and of thread 0's cycles since its own CTA's entry.  The
probes are a diagnostic: the copy is never the kernel the port runs.
Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.adaptnetx import (VARIANTS, _adaptnetx_plan,
                                           launch_args)

MAXC, NPT = 4096, 16           # CTAs and points recorded
# the forced variant probed beside the plan at one query: one CTA
PROBED = ("4 chunks a CTA",)
_P = ctypes.c_void_p
HEADER = (
    "__device__ long long g_ns[%d * %d], g_clk[%d * %d];\n"
    "#define PROBE(e) do { if (threadIdx.x == 0) { long long t_; "
    "asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t_)); "
    "const int i_ = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
    "blockIdx.x) * %d + (e); if (i_ < %d * %d) { g_ns[i_] = t_; "
    "g_clk[i_] = clock64(); } } } while (0)\n"
) % (MAXC, NPT, MAXC, NPT, NPT, MAXC, NPT)
FOOTER = (
    '\nextern "C" int probe_read(long long* ns, long long* clk) { int e = '
    "(int)cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns)); return e ? e : "
    "(int)cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk)); }\n"
    'extern "C" int probe_clear() { static long long z[%d * %d]; int e = '
    "(int)cudaMemcpyToSymbol(g_ns, z, sizeof(z)); return e ? e : "
    "(int)cudaMemcpyToSymbol(g_clk, z, sizeof(z)); }\n") % (MAXC, NPT)

# (point, the source comment it goes before): the ring's two are taken
# in its first wave
POINTS = (
    ("entry", "  // the query tile's ids"),
    ("ids requested", "  // every weight byte of this CTA's"),
    ("weight copies issued", "  // the embedding rows"),
    ("rows gathered", "  // the ring: waves of"),
    ("weights landed", "    // h = relu(x w1 + b1)"),
    ("h done", "    // this wave's partials"),
    ("partials stored", "  // the combine"),
    ("combined", "  // the sum, in ascending chunks"),
    ("logits stored", "  // done"),
)


def instrument(src: str) -> str:
    """``src`` with its probes inserted (each anchor must occur once, or
    the build stops)."""
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    for i, (_, anchor) in enumerate(POINTS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        indent = anchor[:len(anchor) - len(anchor.lstrip())]
        ring = "if (w0 == 0) " if indent == "    " else ""
        src = src.replace(anchor, f"{indent}{ring}PROBE({i});\n{anchor}")
    return src + FOOTER


def build():
    out = _build.BUILD_DIR.parent / "probe_adaptnetx"
    out.mkdir(parents=True, exist_ok=True)
    (out / "adaptnetx_probe.cu").write_text(
        instrument((_build.CSRC / "adaptnetx.cu").read_text()))
    lib = out / "adaptnetx_probe.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(out / "adaptnetx_probe.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.adaptnetx_launch.argtypes = \
        _build.SIGNATURES["adaptnetx"]["adaptnetx_launch"]
    dll.probe_read.argtypes = [_P, _P]
    return dll


def run(dll, B, name, kw, reps=7):
    """One plan's probes, L2 flushed before each run (cold) and not
    (warm: the same launch again)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    E, H, C, rows = 16, 128, 135, 10_001

    def rn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
    p = (rn(rows, E) * 0.02, rn(rows, E) * 0.02, rn(rows, E) * 0.02,
         rn(3 * E, H) / (3 * E) ** 0.5, rn(H) * 0.1, rn(H, C) / H ** 0.5,
         rn(C) * 0.1)
    ids = torch.randint(0, rows, (B, 3), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = torch.empty(B, C, device="cuda")
    plan = _adaptnetx_plan(B, E, H, C, **kw)
    args = launch_args(ids, p, out, plan,
                       torch.cuda.current_stream().cuda_stream)
    ctas = plan.ctas
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    npt = len(POINTS)
    med = statistics.median
    res = {}
    _build.check(dll.adaptnetx_launch(*args), "probed ADAPTNETX")
    for cold in (True, False):
        since_launch = [[] for _ in range(npt)]
        since_entry = [[] for _ in range(npt)]
        for _ in range(reps):
            if cold:
                flush.zero_()
            torch.cuda.synchronize()
            dll.probe_clear()
            _build.check(dll.adaptnetx_launch(*args), "probed ADAPTNETX")
            torch.cuda.synchronize()
            ns, clk = ((ctypes.c_longlong * (MAXC * NPT))()
                       for _ in range(2))
            dll.probe_read(ns, clk)
            rows_ = [(ns[c * NPT:c * NPT + npt], clk[c * NPT:c * NPT + npt])
                     for c in range(ctas)]
            t0 = min(t[0] for t, _ in rows_)
            for i in range(npt):
                since_launch[i].append(max(t[i] - t0 for t, _ in rows_))
                since_entry[i].append(max(c[i] - c[0] for _, c in rows_))
        res[cold] = [(med(a), med(b)) for a, b in zip(since_launch,
                                                      since_entry)]
    print(f"B={B} {name}, {ctas} CTAs (E={E}, H={H}, C={C}, f32; median "
          f"of {reps} runs, the latest CTA; ns since the first entry, "
          f"cycles since its CTA's entry):", flush=True)
    for i, (point, _) in enumerate(POINTS):
        (nc_, cc), (nw, cw) = res[True][i], res[False][i]
        print(f"  {point:<22} L2 cold {nc_:>7.0f} ns {cc:>7.0f} cyc   "
              f"warm {nw:>7.0f} ns {cw:>7.0f} cyc", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_adaptnetx: needs a CUDA card")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dll = build()
    forced = dict(VARIANTS)
    plans = [(1, "plan", {})] + [(1, n, forced[n]) for n in PROBED] + \
        [(64, "plan", {})]
    for B, name, kw in plans:
        run(dll, B, name, kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
