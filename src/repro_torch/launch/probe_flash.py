"""Where a wide f32 flash CTA's time goes (hd or hd_v past 128), on the card.

    PYTHONPATH=src python src/repro_torch/launch/probe_flash.py [--out FILE]

Builds a copy of ``csrc/flash_attn.cu`` (of the tree whose ``src/`` is on
``PYTHONPATH``: run it as a file with ``PYTHONPATH`` at the parent
commit's ``src/`` to probe the parent's kernels) with ``clock64`` probes
in its wide f32 forward, dq and dk/dv kernels into
``build/probe_flash/``, runs each at gemma-2b's training attention (B =
2, S = 1024, 8 / 1 heads, hd 256, causal) and the expanded MLA's (B = 1,
S = 1024, 128 / 128 heads, hd 192 / hd_v 128, causal) under that tree's
plan, and prints, per section of the tile loop, the share of thread 0's
cycles (warp 0's view: a barrier's wait counts where it is waited for)
summed over every CTA, and the cycles and tiles of the CTA that ran
longest.  The sections are each kernel's own: the earlier one-slot
kernels (the forward's ``WIDE`` instance of ``flash_fwd_kernel``,
``flash_dq_wide_kernel``, ``flash_dkv_wide_kernel``) spend their time in
their copies (issue, wait and barriers, or ``fetch``) and their products;
the paired kernels (``flash_fwd_pair_kernel``, ``flash_dq_pair_kernel``,
``flash_dkv_pair_kernel``) in their ring (issuing the next tile's copies,
the copy wait, the barrier), their products of the scores, the sum of
their quarters (dq's and dk/dv's with the sibling warp's) and the send,
the wait for the partner CTA's halves, and the products that follow.  A tree's kernel of each role is the
paired one where the source has it.  The probes are a diagnostic: the
copy is never the kernel the port runs.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import _flash_plan

NPROBE = 16
MAX_CTAS = 8192
# name, B, S, H, KVH, hd, hd_v
SHAPES = [("gemma-2b hd 256", 2, 1024, 8, 1, 256, 256),
          ("MLA 192/128", 1, 1024, 128, 128, 192, 128)]
# per kernel: its role, the sections (probe slot i) and (anchor, probe,
# after) edits inside the kernel's body, each anchor found there once;
# PACC(i) adds the cycles since the last stamp to slot i; slot NPROBE - 2
# takes the total, NPROBE - 1 the tiles
KERNELS = {
    # the earlier wide forward: flash_fwd_kernel's WQ = WIDE instance, one
    # ring stage (its W <= 128 instances carry the probes but never run
    # here; slice 1 of MLA's returns before PSTART)
    "flash_fwd_kernel": {
        "role": "fwd",
        "sections": ["copy issue", "copy wait", "barrier", "S", "softmax",
                     "PV", "end barrier", "other"],
        "edits": [
            ("  const int n = cdiv_c(kv_end, KT), stages = a.stages;\n",
             "  PSTART();\n", True),
            ("    if (stages == 1) {\n      load(t);", "    PACC(7);\n",
             False),
            ("    cp_async_wait_ring();\n    __syncthreads();  // tile t "
             "landed", "    PACC(0);\n", False),
            ("    __syncthreads();  // tile t landed; every warp is past tile "
             "t - 1\n", "    PACC(1);\n", False),
            ("    __syncthreads();  // tile t landed; every warp is past tile "
             "t - 1\n", "    PACC(2);\n", True),
            ("    nt_product(s, Qs + r0 * LQ, LQ, Ks + lx * LQ, LQ, hd4);\n",
             "    PACC(3);\n", True),
            ("    __syncwarp();  // a row's p comes from the 8 lanes of its "
             "own warp\n", "    PACC(4);\n", False),
            ("    nn_product<NCV>(o, Ps + r0 * LDP, LDP, Vs + 4 * lx, LV);\n",
             "    PACC(5);\n", True),
            ("    if (stages == 1) __syncthreads();  // the one slot is "
             "reloaded next\n", "    PACC(6);\n    PTILE();\n", True),
            ("  T* og = static_cast<T*>(a.o1);\n", "  PEND();\n", False),
        ],
    },
    # the earlier wide dq: every kv tile's 128-column chunks through one slot
    "flash_dq_wide_kernel": {
        "role": "dq",
        "sections": ["fetch", "S, dP", "ds", "dq", "other"],
        "edits": [
            ("  const int n = cdiv_c(kv_end, KT), nch = cdiv_c(max(a.hd, "
             "a.hdv), CW);\n", "  PSTART();\n", True),
            ("    __syncthreads();\n    const int o = c * CW;\n",
             "    PACC(4);\n", False),
            ("    cp_async_wait_ring();\n    __syncthreads();\n",
             "    PACC(0);\n", True),
            ("        nt_accum(dp, Os + r0 * LF + o, LF, Vc + lx * LC, LC, "
             "max(0, min(CW, hdv4 - o)));\n      }\n", "      PACC(1);\n",
             True),
            ("      __syncwarp();  // a row's ds comes from the 8 lanes of its "
             "own warp\n", "      PACC(2);\n", False),
            ("      nn_product<NCV>(dq, Ds + r0 * LDP, LDP, Kc + 4 * lx, "
             "LC);\n", "      PACC(3);\n      PTILE();\n", True),
            ("  T* dqg = static_cast<T*>(a.o1);\n  const int dw",
             "  PEND();\n", False),
        ],
    },
    # the paired kernels: a 2-stage ring of bulk copies, the scores summed
    # over quarters (dq: with the sibling warp's) and the partner's halves
    "flash_fwd_pair_kernel": {
        "role": "fwd",
        "sections": ["ring issue", "copy wait", "barrier", "S",
                     "half, send", "exchange", "softmax", "PV", "other"],
        "edits": [
            ("  const int n = cdiv_c(kv_end, WKT), stages = a.stages;\n",
             "  PSTART();\n", True),
            ("    if (stages == 1) {\n      load(t);", "    PACC(8);\n",
             False),
            ("    cp_async_wait_ring();\n    mbar_wait(&full", "    PACC(0);\n",
             False),
            ("    __syncthreads();  // tile t landed; every warp is past tile "
             "t - 1\n", "    PACC(1);\n", False),
            ("    __syncthreads();  // tile t landed; every warp is past tile "
             "t - 1\n", "    PACC(2);\n", True),
            ("    const float* Kt = ring + (t % stages) * SLOT;\n",
             "    PACC(0);\n", False),
            ("      nt_product(sb, Qw + hk / 2, LC, Kt + lx * ldk + hk / 2, ldk, "
             "k4b);\n", "      PACC(3);\n", True),
            ("      mbar_wait(&bars[par], (t >> 1) & 1);\n",
             "      PACC(4);\n", False),
            ("      mbar_wait(&bars[par], (t >> 1) & 1);\n",
             "      PACC(5);\n", True),
            ("      __syncwarp();  // a row's p comes from the 8 lanes of "
             "its own warp\n", "      PACC(6);\n", False),
            ("      nn_product<NV, WKT>(o, Pw, LP, Vt + 4 * lx, ldv);\n",
             "      PACC(7);\n", True),
            ("    if (stages == 1) __syncthreads();  // the one slot is "
             "reloaded next\n", "    PACC(8);\n    PTILE();\n", True),
            ("  float* og = static_cast<float*>(a.o1);\n", "  PEND();\n",
             False),
        ],
    },
    "flash_dq_pair_kernel": {
        "role": "dq",
        "sections": ["ring issue", "copy wait", "barrier", "S, dP",
                     "quarters, send", "exchange", "ds", "dq", "other"],
        "edits": [
            ("  const int n = cdiv_c(kv_end, WKT), stages = a.stages;\n",
             "  PSTART();\n", True),
            ("    if (stages == 1) {\n      load(t);", "    PACC(8);\n",
             False),
            ("    cp_async_wait_ring();\n    mbar_wait(&full", "    PACC(0);\n",
             False),
            ("    __syncthreads();  // tile t landed; every warp is past tile "
             "t - 1\n", "    PACC(1);\n", False),
            ("    __syncthreads();  // tile t landed; every warp is past tile "
             "t - 1\n", "    PACC(2);\n", True),
            ("    const float* Kt = ring + (t % stages) * SLOT;\n",
             "    PACC(0);\n", False),
            ("      nt_product(dp, Os + r0 * LC + qv0, LC, Vt + lx * ldv + qv0, "
             "ldv, v4);\n", "      PACC(3);\n", True),
            ("      mbar_wait(&bars[par], (t >> 1) & 1);\n",
             "      PACC(4);\n", False),
            ("      mbar_wait(&bars[par], (t >> 1) & 1);\n",
             "      PACC(5);\n", True),
            ("      asm volatile(\"bar.sync %0, 64;\\n\" ::\"r\"(1 + rg) : "
             "\"memory\");  // both halves of ds written\n",
             "      PACC(6);\n", False),
            ("Kt + qk0 + 32 * NK + 2 * lx);\n", "      PACC(7);\n", True),
            ("    if (stages == 1) __syncthreads();  // the one slot is "
             "reloaded next\n", "    PACC(8);\n    PTILE();\n", True),
            ("  float* dqg = static_cast<float*>(a.o1);\n", "  PEND();\n",
             False),
        ],
    },
    "flash_dkv_wide_kernel": {
        "role": "dkv",
        "sections": ["fetch", "S", "p", "dv", "dP", "ds", "dk", "other"],
        "edits": [
            ("  const int n = (g1 - g0) * nqt, nch = cdiv_c(max(a.hd, a.hdv), "
             "CW);\n", "  PSTART();\n", True),
            ("    __syncthreads();\n    const int h = kvh * G + g0",
             "    PACC(7);\n", False),
            ("    __syncthreads();\n  };\n", "    PACC(0);\n", False),
            ("      if (live) nt_accum(x, Ks + r0 * LF + c * CW, LF, Qc + lx "
             "* LC, LC, max(0, min(CW, hd4 - c * CW)));\n", "      PACC(1);\n",
             True),
            ("    if (dvw > 0) {\n      if (held != sl)", "    PACC(2);\n",
             False),
            ("        nn_product<NCV>(dv, Ps + r0 * LDP, LDP, Oc + 4 * lx, "
             "LC);\n", "        PACC(3);\n", True),
            ("        if (live) nt_accum(x, Vs + r0 * LF + c * CW, LF, Oc + "
             "lx * LC, LC, max(0, min(CW, hdv4 - c * CW)));\n",
             "        PACC(4);\n", True),
            ("      if (held != sl) fetch(t, held = sl);\n      if (live) {\n"
             "        __syncwarp();\n        nn_product<NCV>(dk",
             "      PACC(5);\n", False),
            ("        nn_product<NCV>(dk, Ps + r0 * LDP, LDP, Qc + 4 * lx, "
             "LC);\n", "        PACC(6);\n", True),
            ("  if (g1 - g0 > 1 && n > 0) return;", "  PEND();\n", False),
            ("      for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
             "        for (int c = 0; c < 4 * NCV; ++c) dk[i][c] = "
             "dv[i][c] = 0.f;\n    }\n", "    PACC(7);\n    PTILE();\n",
             True),
        ],
    },
    "flash_dkv_pair_kernel": {
        "role": "dkv",
        "sections": ["ring issue", "S, dP", "quarters, send", "exchange",
                     "p", "dv", "ds", "dk", "other", "copy wait", "barrier"],
        "edits": [
            ("  const int n = (g1 - g0) * nqt, stages = a.stages;\n",
             "  PSTART();\n", True),
            ("    __syncthreads();  // tile t landed; every warp is past tile t "
             "- 1\n    if (stages > 1) {\n      if (t + stages - 1 < n) load(t"
             " + stages - 1);", "    PACC(9);\n", False),
            ("    if (stages > 1) {\n      if (t + stages - 1 < n) load(t + "
             "stages - 1);", "    PACC(10);\n", False),
            ("    const int i0 = q_begin + (t % nqt) * WQT, par = t & 1;\n",
             "    PACC(0);\n", True),
            ("      nt_product(dp, Vs + r0 * LC + qv0, LC, Ot + lx * LC + qv0, "
             "LC, v4);\n", "      PACC(1);\n", True),
            ("      mbar_wait(&bars[par], (t >> 1) & 1);\n",
             "      PACC(2);\n", False),
            ("      mbar_wait(&bars[par], (t >> 1) & 1);\n",
             "      PACC(3);\n", True),
            ("      __syncwarp();  // a kv row's p comes", "      PACC(4);\n",
             False),
            ("      if (dvq > 0) nn_product<NV, WQT>(dv, Pw, LQ, Ot + qv0 + 4 * "
             "lx, LC);\n", "      PACC(5);\n", True),
            ("      if (dkq > 0) nn_product<NK, WQT>", "      PACC(6);\n",
             False),
            ("(dk, Pw, LQ, Qt + qk0 + 4 * lx, LC);\n", "      PACC(7);\n",
             True),
            ("    if (stages == 1) __syncthreads();  // the one slot is "
             "reloaded next\n", "    PACC(8);\n    PTILE();\n", False),
            ("  if (g1 - g0 > 1 && n > 0) return;", "  PEND();\n", False),
        ],
    },
}
# thread 0 counts in shared memory (a global add at every stamp would
# stall its warp on the load and skew the barriers; registers would crowd
# the kernel's own) and writes its counts once at the end
HEADER = (
    "__device__ long long g_probe[%d * %d];\n"
    "#define PCTA_ ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
    "blockIdx.x)\n"
    "#define PSTART() __shared__ long long pc_[%d]; long long pt_ = "
    "clock64(); const long long p0_ = pt_; if (threadIdx.x == 0) for (int "
    "e_ = 0; e_ < %d; ++e_) pc_[e_] = 0\n"
    "#define PACC(e) do { if (threadIdx.x == 0) { const long long now_ = "
    "clock64(); pc_[e] += now_ - pt_; pt_ = now_; } } while (0)\n"
    "#define PTILE() do { if (threadIdx.x == 0) pc_[%d] += 1; } while (0)\n"
    "#define PEND() do { if (threadIdx.x == 0 && PCTA_ < %d) { pc_[%d] = "
    "clock64() - p0_; for (int e_ = 0; e_ < %d; ++e_) g_probe[PCTA_ * %d + "
    "e_] = pc_[e_]; } } while (0)\n"
) % (MAX_CTAS, NPROBE, NPROBE, NPROBE, NPROBE - 1, MAX_CTAS, NPROBE - 2,
     NPROBE, NPROBE)
FOOTER = (
    '\nextern "C" int probe_read(long long* host) { return (int)'
    "cudaMemcpyFromSymbol(host, g_probe, sizeof(long long) * %d * %d); }\n"
    'extern "C" int probe_clear() { static long long z[%d * %d]; return '
    "(int)cudaMemcpyToSymbol(g_probe, z, sizeof(z)); }\n") % (
        MAX_CTAS, NPROBE, MAX_CTAS, NPROBE)


# the kernels a role may have, the paired one first
ROLES = {"fwd": ("flash_fwd_pair_kernel", "flash_fwd_kernel"),
         "dq": ("flash_dq_pair_kernel", "flash_dq_wide_kernel"),
         "dkv": ("flash_dkv_pair_kernel", "flash_dkv_wide_kernel")}


def instrument(src: str):
    """(instrumented source, {role: (kernel name, its section names)})."""
    picked = {}
    for role, names in ROLES.items():
        name = next((k for k in names if f" {k}(const Args a" in src), None)
        if name is None:
            raise RuntimeError(f"no wide f32 {role} kernel this probe knows")
        spec = KERNELS[name]
        begin = src.index(f" {name}(const Args a")
        end = src.index("\n}\n", begin) + 3
        body = src[begin:end]
        for anchor, probe, after in spec["edits"]:
            if body.count(anchor) != 1:
                raise RuntimeError(f"{name}: probe anchor not found once: "
                                   f"{anchor!r}")
            body = body.replace(anchor, anchor + probe if after
                                else probe + anchor)
        src = src[:begin] + body + src[end:]
        picked[role] = (name, spec["sections"])
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    return src + FOOTER, picked


def build():
    src, picked = instrument((_build.CSRC / "flash_attn.cu").read_text())
    out = _build.BUILD_DIR.parent / "probe_flash"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attn_probe.cu").write_text(src)
    lib = out / "flash_attn_probe.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(lib),
                        str(out / "flash_attn_probe.cu"),
                        *_build.LIB_FLAGS.get("flash_attn", [])],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES["flash_attn"].items():
        getattr(dll, fn).argtypes = argtypes
    dll.probe_read.argtypes = [ctypes.c_void_p]
    return dll, picked


def run(dll, role, sections, B, S, H, KVH, hd, hd_v):
    """One call of ``role``'s kernel under the tree's f32 plan, cold L2:
    the section shares of every CTA's thread 0, and the longest CTA's
    cycles."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + hd)
    q, do = (torch.randn((B, S, H, d), generator=gen, device="cuda")
             for d in (hd, hd_v))
    k = torch.randn((B, S, KVH, hd), generator=gen, device="cuda")
    v = torch.randn((B, S, KVH, hd_v), generator=gen, device="cuda")
    lse = torch.randn((B, H, S), generator=gen, device="cuda").abs() + 5
    delta = torch.randn((B, H, S), generator=gen, device="cuda")
    plan = _flash_plan(H, KVH, hd, hd_v)
    dims = (B, S, S, H, KVH, hd, hd_v, 1, hd ** -0.5)
    if role == "fwd":
        o = torch.empty_like(do)
        fn, args = dll.flash_fwd_launch, (
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *dims, plan.fwd_stages, plan.fwd_rows, None)
    elif role == "dq":
        dq = torch.empty_like(q)
        fn, args = dll.flash_dq_launch, (
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
            plan.dq_rows, plan.dq_stages, None)
    else:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        ws = torch.empty(plan.parts * B * S * KVH * (hd + hd_v),
                         device="cuda") if H > KVH else None
        fn, args = dll.flash_dkv_launch, (
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims, plan.dkv_rows, plan.dkv_stages, plan.heads, plan.parts,
            None if ws is None else ws.data_ptr(), None)
    _build.check(fn(*args), f"probed {role}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    torch.cuda.synchronize()
    dll.probe_clear()
    _build.check(fn(*args), f"probed {role}")
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (MAX_CTAS * NPROBE))()
    dll.probe_read(buf)
    rows = [buf[c * NPROBE:(c + 1) * NPROBE] for c in range(MAX_CTAS)]
    rows = [r for r in rows if r[NPROBE - 2]]
    sums = [sum(r[i] for r in rows) for i in range(len(sections))]
    total = sum(r[NPROBE - 2] for r in rows)
    slow = max(rows, key=lambda r: r[NPROBE - 2])
    return {"plan": plan._asdict(), "ctas": len(rows),
            "share": {s: sums[i] / total for i, s in enumerate(sections)},
            "longest": {"cycles": slow[NPROBE - 2], "tiles": slow[NPROBE - 1],
                        **{s: slow[i] for i, s in enumerate(sections)}}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_flash: needs a CUDA card")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    dll, picked = build()
    recs = {}
    for role, (name, sections) in picked.items():
        for shape, *dims in SHAPES:
            rec = run(dll, role, sections, *dims)
            recs.setdefault(name, {})[shape] = rec
            lg = rec["longest"]
            print(f"{name} {shape}: {rec['ctas']} CTAs; share of thread 0's "
                  "cycles: " + ", ".join(f"{s} {100 * x:.1f}%"
                                          for s, x in rec["share"].items()))
            print(f"  longest CTA: {lg['cycles']} cycles, {lg['tiles']} "
                  "tiles: " + ", ".join(f"{s} {lg[s]}" for s in sections))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": recs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
