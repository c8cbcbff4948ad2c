"""Where the WKV kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.probe_wkv

Builds a copy of ``csrc/linear_attn.cu`` with ``clock64`` probes (thread 0
of each CTA records the cycle at fixed points, each just after a barrier
where one is) into ``build/probe_wkv/``, and runs it at rwkv6's widths
(H = 32, K = V = 64, f32, L2 cold).

Prefill, on the one-chunk prefill (B = 1, S = 64: 32 intra CTAs, one an
SM, so nothing contends) and on the full prefill (S = 512: 256 CTAs, two
an SM): for the intra CTA that ran longest, the cycles from its entry to
the end of each phase (its loads stored, the cumsum, the bonus diagonal
with r_hat and the decay written, A's pairs inside the sub-chunks, A
across them, v stored, k_hat, o_intra, dS); then the same for the inter
kernel (r_hat and h_{c-1} in shared memory, the fold, and its end).

Decode, at the served step (B = 8, S = 1, 512 CTAs): each CTA's thread 0
also reads the global timer (ns, one clock for every SM) at its entry,
once its operands and state have landed (r . h done), once its new state
is stored, after the barrier before o, and at its exit.  It prints the
launch's span (first entry to last exit), how far apart the CTAs start,
and each phase's median and largest time over the CTAs.  Then it times
(median device time of 15 runs, L2 flushed, as ``launch/bench_wkv.py``)
the probed kernel whole and cut short: "state" returns once the new state
is stored (no reduction, no o), "copy" stores the state as loaded (the
row's loads issued, no arithmetic) -- beside the kernel the port runs, one
``state0.clone()`` and the timer's floor.  The probes are a diagnostic:
the copy is never the kernel the port runs.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.linear_attn import _wkv_plan, wkv_bshk_cuda
from repro_torch.launch.bench_gemm import timer

NPROBE = 32
INTRA = ["loads", "cumsum", "diag, r_hat", "A in sub-chunks", "A across",
         "v stored", "k_hat", "o_intra", "dS"]
INTER = ["r_hat, h", "end"]
# (anchor in the source, probe inserted before it) - each anchor once
PROBES = [
    ("  // every global load of the chunk issued", "  PROBE(0);\n"),
    ("  // the cumsum, in registers", "  PROBE(1);\n"),
    ("  // the bonus diagonal, on A's diagonal", "  PROBE(2);\n"),
    ("  // A's pairs inside the sub-chunks", "  __syncthreads();\n  PROBE(3);\n"),
    ("  {\n    // across sub-chunks", "  __syncthreads();\n  PROBE(4);\n"),
    ("    __syncthreads();  // A is done with the scratch",
     "    __syncthreads();\n    PROBE(5);\n"),
    ("  // k decayed to the chunk end", "  PROBE(6);\n"),
    ("  // o_intra = A' v, to the workspace", "  PROBE(7);\n"),
    ("  // dS_c = k_hat^T v", "  __syncthreads();\n  PROBE(8);\n"),
    ("  }\n}\n\n// h_c = exp(wsum_c)", "  }\n  __syncthreads();\n  PROBE(9);\n"
     "}\n\n// h_c = exp(wsum_c)"),
    ("  // r_hat's rows, all in flight", "  PROBE(20);\n"),
    ("  // o = o_intra + r_hat h_{c-1}", "  PROBE(21);\n"),
    # the decode kernel: entry, the cut to a plain copy, r . h done (the
    # thread's operands and state landed), the state stored (and the cut
    # there), the barrier before o
    ("  // a row's operands where the thread needs them", "  DPROBE(0);\n"),
    ("  for (int s = 0; s < a.S; ++s) {\n    const size_t g = ((size_t)b * "
     "a.S + s) * H + hh;\n    // r . h over",
     "  if (g_cut == 2) {\n    store_state(a.sf, h);\n    DPROBE(4);\n"
     "    return;\n  }\n"),
    ("    for (int i = 0; i < MAXR; ++i) {\n      const float e = expf(",
     "    DPROBE(1);\n"),
    ("    float d = 0.f, vo = to_f(ov);",
     "    DPROBE(2);\n    if (g_cut == 1) {\n      DPROBE(4);\n"
     "      return;\n    }\n"),
    ("    if (tid < VT && vt0 + tid < V) {", "    DPROBE(3);\n"),
]
DPROBES = ["operands and state landed", "state stored", "barrier before o",
           "exit"]
CUTS = {0: "whole", 1: "state", 2: "copy"}
HEADER = (
    "__device__ long long g_probe[4096 * %d];\n"
    "#define PROBE(e) do { if (threadIdx.x == 0 && blockIdx.y == 0 && "
    "blockIdx.x < 4096) g_probe[blockIdx.x * %d + (e)] = clock64(); } "
    "while (0)\n"
    "__device__ long long g_dns[4096 * 8], g_dclk[4096 * 8];\n"
    "__device__ int g_cut;\n"
    "#define DPROBE(e) do { if (threadIdx.x == 0) { long long t_; "
    "asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t_)); "
    "const int i_ = (blockIdx.y * gridDim.x + blockIdx.x) * 8 + (e); "
    "if (i_ < 4096 * 8) { g_dns[i_] = t_; g_dclk[i_] = clock64(); } } "
    "} while (0)\n") % (NPROBE, NPROBE)
FOOTER = (
    '\nextern "C" int probe_read(long long* host) { return (int)'
    "cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * 4096 * %d); }\n"
    'extern "C" int probe_clear() { static long long z[4096 * %d]; return '
    "(int)cudaMemcpyToSymbol(g_probe, z, sizeof(z)); }\n"
    'extern "C" int probe_decode_read(long long* ns, long long* clk) { '
    "int e = (int)cudaMemcpyFromSymbol(ns, g_dns, sizeof(g_dns)); return e ? "
    "e : (int)cudaMemcpyFromSymbol(clk, g_dclk, sizeof(g_dclk)); }\n"
    'extern "C" int probe_set_cut(int c) { return (int)'
    "cudaMemcpyToSymbol(g_cut, &c, sizeof(int)); }\n") % (NPROBE, NPROBE)


def build() -> ctypes.CDLL:
    """The instrumented library, with the kernel's launch signatures."""
    src = (_build.CSRC / "linear_attn.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        if anchor.startswith("  }\n}\n"):
            src = src.replace(anchor, probe)
        else:
            src = src.replace(anchor, probe + anchor)
    # the inter kernel's end: its last closing brace before the decode
    # kernel's section; the decode kernel's: its last before the launches'
    for head, probe in (("// decode (chunk 1): one CTA per", "  PROBE(22);\n"),
                        ("// launches\n", "  DPROBE(4);\n")):
        i = src.index(head)
        j = src.rindex("}\n", 0, i)
        src = src[:j] + probe + src[j:]
    out = _build.BUILD_DIR.parent / "probe_wkv"
    out.mkdir(parents=True, exist_ok=True)
    (out / "linear_attn_probe.cu").write_text(src + FOOTER)
    lib = out / "linear_attn_probe.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(out / "linear_attn_probe.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES["linear_attn"].items():
        getattr(dll, fn).argtypes = argtypes
    dll.probe_read.argtypes = [ctypes.c_void_p]
    dll.probe_decode_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return dll


def run(dll, S):
    """One call at B = 1, H = 32, K = V = 64, chunk 64, f32, cold L2,
    under the plan with V whole and the chain folded; the probes of the
    longest intra and inter CTAs, as cycles from each one's entry."""
    B, H, K = 1, 32, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
    r, k, v = rn(B, S, H, K), rn(B, S, H, K), rn(B, S, H, K)
    lw = -torch.exp(rn(B, S, H, K) * 0.5 - 2.0)
    u, s0 = rn(H, K) * 0.1, rn(B, H, K, K) * 0.3
    o, sf = torch.empty_like(v), torch.empty_like(s0)
    plan = _wkv_plan(B, S, H, K, K, 64, variant="chunked", chain="fold",
                     vt=K)
    ws = torch.empty(plan.ws_elems, device="cuda")
    args = (0, r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), sf.data_ptr(), B, S,
            H, K, K, 64, 0, 0, K, ws.data_ptr(), None)
    dll.wkv_bshk_launch(*args)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    torch.cuda.synchronize()
    dll.probe_clear()
    _build.check(dll.wkv_bshk_launch(*args), "probed WKV scan")
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (4096 * NPROBE))()
    dll.probe_read(buf)
    rows = [buf[c * NPROBE:(c + 1) * NPROBE] for c in range(B * H * S // 64)]

    def slowest(lo, hi):
        live = [r_ for r_ in rows if r_[lo]]
        row = max(live, key=lambda r_: max(x for x in r_[lo:hi] if x)
                  - r_[lo])
        return {i - lo: row[i] - row[lo] for i in range(lo, hi) if row[i]}
    return plan, slowest(0, 10), slowest(20, 23)


def decode(dll):
    """The decode step at B = 8, S = 1, H = 32, K = V = 64, f32: one probed
    call from a cold L2, then the probed kernel's times whole and cut short
    beside the port's kernel, a state copy and the timer's floor."""
    B, H, K = 8, 32, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
    r, k, v = rn(B, 1, H, K), rn(B, 1, H, K), rn(B, 1, H, K)
    lw = -torch.exp(rn(B, 1, H, K) * 0.5 - 2.0)
    u, s0 = rn(H, K) * 0.1, rn(B, H, K, K) * 0.3
    o, sf = torch.empty_like(v), torch.empty_like(s0)
    plan = _wkv_plan(B, 1, H, K, K, 1)
    args = (0, r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), sf.data_ptr(), B, 1,
            H, K, K, 1, 1, 0, plan.vt, None, None)

    def call():
        _build.check(dll.wkv_bshk_launch(*args), "probed WKV decode")
    dll.probe_set_cut(0)
    call()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    n = plan.ctas
    ns, clk = ((ctypes.c_longlong * (4096 * 8))() for _ in range(2))
    dll.probe_decode_read(ns, clk)
    rows = [(ns[8 * c:8 * c + 5], clk[8 * c:8 * c + 5]) for c in range(n)]
    entry = [t[0] for t, _ in rows]
    t0 = min(entry)
    span = max(t[4] for t, _ in rows) - t0
    steps = sorted({b - a for a, b in zip(sorted(entry), sorted(entry)[1:])
                    if b > a})
    print(f"decode B={B} S=1 H={H} K=V={K}, {n} CTAs of {plan.vt} columns,"
          f" one probed call from a cold L2 (global timer, ns; its finest "
          f"step seen {steps[0] if steps else 'none'}):")
    print(f"  span first entry -> last exit {span} ns; CTA entries spread "
          f"over {max(entry) - t0} ns (median entry at "
          f"{sorted(entry)[n // 2] - t0})")
    for i, name in enumerate(DPROBES):
        d_ns = sorted(t[i + 1] - t[i] for t, _ in rows)
        d_clk = sorted(c[i + 1] - c[i] for _, c in rows)
        print(f"  {'entry' if i == 0 else DPROBES[i - 1]} -> {name}: median"
              f" {d_ns[n // 2]} ns ({d_clk[n // 2]} cycles), largest "
              f"{d_ns[-1]} ns ({d_clk[-1]} cycles)")
    times = {}
    for cut, name in CUTS.items():
        dll.probe_set_cut(cut)
        times[f"probed, {name}"] = timer(call)
    dll.probe_set_cut(0)
    times["the port's kernel"] = timer(
        lambda: wkv_bshk_cuda(r, k, v, lw, u, s0, chunk=1))
    times["state0.clone()"] = timer(lambda: s0.clone())
    one = torch.zeros(1, device="cuda")
    times["timer floor (one-element add)"] = floor = timer(
        lambda: one.add_(1.0))
    for name, ms in times.items():
        print(f"  {name}: {ms:.4f} ms (net of the floor {ms - floor:.4f})")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_wkv: needs a CUDA card")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    dll = build()
    for S in (64, 512):
        plan, intra, inter = run(dll, S)
        marks = " ".join(f"{name} {intra.get(i + 1)}"
                         for i, name in enumerate(INTRA))
        print(f"S={S}, {plan.n * 32} intra CTAs: cycles from entry of the "
              f"longest: {marks}")
        print(f"  inter, {plan.ctas} CTAs: "
              + " ".join(f"{name} {inter.get(i + 1)}"
                         for i, name in enumerate(INTER)))
    decode(dll)
    return 0


if __name__ == "__main__":
    sys.exit(main())
