"""Time the WKV kernel (``csrc/linear_attn.cu``) under the plans its rule
rejected, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_wkv [--out FILE]

For each case (``chip_smoke.py`` phase 3's: the rwkv6 prefill B = 1, S =
512, H = 32, K = V = 64 at chunk 64; the ragged S = 100 with decays down
to -e; a one-chunk prefill S = 64; the decode step B = 8, S = 1 at chunk
1; and ``linear_attn`` at BH = 64, S = 1024, chunk 64; then phase 8's
prompt lengths, B = 1 at S = 64 n for n = 1 .. 8 chunks) the kernel runs
under ``_wkv_plan``'s plan and under every forced chunked variant: where
the chain lives (folded into the inter kernel or its own kernel) and the
V tile (V whole or halved) -- the choices ``_wkv_plan`` makes.  Each time
is the median device time of 15 runs
between CUDA events, L2 flushed before each run, beside the plain
version and the bound (``chip_smoke.py``'s: bytes of every input read
once and every output written once over 3.35 TB/s against the f32
operations over 67 TFLOP/s).  Every variant is held to the plain version
(1e-5 of the output's largest magnitude) and to itself run to run,
bitwise; whether its bits equal the plan's is printed, and beside the
WKV cases one copy of the state (``state0.clone()``: the state's bytes in
and out, a yardstick for decode).  The first line is
the card's name and power limit, then the build's registers and spills
of each WKV kernel, then the timer's floor (one launch of a one-element
add), which each device time below includes; the decode line also gives
its time and the state copy's net of that floor.  One line per variant;
the records go to ``--out`` as JSON.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.linear_attn import (_wkv_plan, linear_attn_cuda,
                                             linear_attn_plain,
                                             wkv_bshk_cuda, wkv_bshk_plain)
from repro_torch.launch.bench_gemm import timer

HBM, PEAK_F32 = 3.35e12, 67e12
H, K = 32, 64                      # rwkv6-1.6b's heads and head width
# name, B, S, chunk, decays down to -e
CASES = [("prefill", 1, 512, 64, False), ("ragged", 1, 100, 64, True),
         ("one chunk", 1, 64, 64, False), ("decode", 8, 1, 1, False)]
LINEAR = ("linear_attn", 64, 1024, 64)
SWEEP = [(f"prompt n={n}", 1, 64 * n, 64, False) for n in range(1, 9)]


def wkv_ops(B, Hh, Kk, V, S, chunk):
    """``chip_smoke.py``'s count of the chunked scan's f32 operations."""
    ops = 0
    for c0 in range(0, S, chunk):
        lc = min(chunk, S - c0)
        pairs = lc * (lc - 1) // 2
        ops += (2 * lc * Kk * V + 5 * pairs * Kk + 2 * pairs * V
                + lc * (3 * Kk + 2 * V) + 7 * lc * Kk + 2 * lc * Kk * V
                + 3 * Kk * V)
    return B * Hh * ops


def bound_ms(nbytes, flops):
    t_b, t_o = nbytes / HBM * 1e3, flops / PEAK_F32 * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def variants(B, S, Hh, V, chunk):
    """The plan and every forced chunked variant: {name: plan}."""
    out = {"plan": _wkv_plan(B, S, Hh, K, V, chunk)}
    if chunk == 1:
        return out
    for chain in ("fold", "launch"):
        for vt in (V, V // 2):
            out[f"{chain} vt={vt}"] = _wkv_plan(B, S, Hh, K, V, chunk,
                                                variant="chunked",
                                                chain=chain, vt=vt)
    return out


def inputs(gen, shape_k, shape_v, strong):
    def rn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
    if strong:
        lw = -torch.exp(torch.rand(shape_k, generator=gen, device="cuda")
                        * 13.0 - 12.0)
    else:
        lw = -torch.exp(rn(*shape_k) * 0.5 - 2.0)
    return rn(*shape_k), rn(*shape_k), rn(*shape_v), lw


def run_case(name, B, S, chunk, strong, gen):
    """Every variant of one case; returns its record."""
    V = K
    Sp = -(-S // chunk) * chunk                       # padded to the chunk
    linear = name == "linear_attn"
    Hh = 1 if linear else H
    shp_k = (B, Sp, K) if linear else (B, Sp, Hh, K)
    shp_v = (B, Sp, V) if linear else (B, Sp, Hh, V)
    r, k, v, lw = inputs(gen, shp_k, shp_v, strong)
    if Sp != S:                                       # zero rows, as ops pads
        for t in (r, k, v, lw):
            t[:, S:] = 0
    if linear:
        u = torch.randn((B, K), generator=gen, device="cuda") * 0.1
        args = (r * 0.5, k * 0.5, v, lw, u)

        def kernel(p):
            return (linear_attn_cuda(*args, chunk=chunk, plan=p),)

        def plain():
            return (linear_attn_plain(*args, chunk=chunk),)
        nbytes = (3 * B * S * K + 2 * B * S * V + B * K) * 4
    else:
        u = torch.randn((Hh, K), generator=gen, device="cuda") * 0.1
        s0 = torch.randn((B, Hh, K, V), generator=gen, device="cuda") * 0.3
        args = (r, k, v, lw, u, s0)

        def kernel(p):
            return wkv_bshk_cuda(*args, chunk=chunk, plan=p)

        def plain():
            return wkv_bshk_plain(*args, chunk=chunk)
        nbytes = (3 * B * S * Hh * K + 2 * B * S * Hh * V + Hh * K) * 4 + \
            2 * B * Hh * K * V * 4
    want = plain()
    b_ms, b_by = bound_ms(nbytes, wkv_ops(B, Hh, K, V, S, chunk))
    rec = {"name": name, "B": B, "S": S, "H": Hh, "K": K, "V": V,
           "chunk": chunk, "strong_decays": strong, "bound_ms": b_ms,
           "bound_by": b_by, "plain_ms": timer(plain), "variants": {}}
    if not linear:      # a yardstick: one copy of the state, in and out
        rec["state_copy_ms"] = timer(lambda: s0.clone())
    plan = _wkv_plan(B, Sp, Hh, K, V, chunk)
    rec["plan"] = plan._asdict()
    ref = kernel(plan)
    for key, p in variants(B, Sp, Hh, V, chunk).items():
        got = kernel(p)
        again = kernel(p)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        tol = max(1e-5 * max(1.0, w.abs().max().item()) for w in want)
        rec["variants"][key] = {
            "plan": p._asdict(), "ms": timer(lambda: kernel(p)),
            "max_abs_err": err, "tol": tol, "ok": err <= tol,
            "run_to_run": all(torch.equal(a, b) for a, b in zip(got, again)),
            "bitwise_plan": all(torch.equal(a, b) for a, b in zip(got, ref))}
    return rec


def build_report() -> list:
    """ptxas's registers, shared memory and spills of each WKV kernel."""
    from repro_torch.kernels import _build
    log = _build.build_all()["linear_attn"].with_suffix(".log")
    lines, fn = [], None
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "wkv" in fn and ("registers" in line or "spill" in line):
            kind = re.search(r"wkv_(\w+?)_kernel", fn)
            t = ["bf16" if "bfloat16" in fn else "f32"] + \
                re.findall(r"Lb([01])E", fn)
            lines.append(f"wkv_{kind.group(1) if kind else '?'}_kernel"
                         f"<{', '.join(t)}>: {line.strip()}")
    return lines


def _line(rec, key, v):
    p = v["plan"]
    how = (f"vt={p['vt']} x{p['vsplit']} = {p['ctas']} CTAs" if
           p["variant"] == "decode" else
           f"{p['chain']} vt={p['vt']} x{p['vsplit']} = {p['ctas']} CTAs")
    return (f"{rec['name']:<12} S={rec['S']:<5} {key:<22} {how}: "
            f"{v['ms']:.4f} ms, err {v['max_abs_err']:.2e} "
            f"{'ok' if v['ok'] else 'FAIL'}, run to run {v['run_to_run']}, "
            f"plan bits {v['bitwise_plan']}  (plain {rec['plain_ms']:.4f}, "
            f"bound {rec['bound_ms']:.4f} {rec['bound_by']}"
            + (f", state copy {rec['state_copy_ms']:.4f}"
               if "state_copy_ms" in rec else "") + ")"
            + (f"\n  net of the timer's floor: kernel {v['net_ms']:.4f}, "
               f"state copy {rec['state_copy_net_ms']:.4f}, bound "
               f"{rec['bound_ms']:.4f} ms" if "net_ms" in v else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/bench_wkv.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_wkv: needs a CUDA card")
        return 2
    print(card_line(), flush=True)
    report = {"device": torch.cuda.get_device_name(0), "card": card_line(),
              "build": build_report(), "cases": []}
    for line in report["build"]:
        print(line, flush=True)
    one = torch.zeros(1, device="cuda")
    report["floor_ms"] = timer(lambda: one.add_(1.0))
    print(f"timer floor (one launch adding 1 to one element): "
          f"{report['floor_ms']:.4f} ms", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    ok = True
    for case in CASES + [LINEAR + (False,)] + SWEEP:
        rec = run_case(*case, gen)
        if rec["chunk"] == 1:
            rec["state_copy_net_ms"] = rec["state_copy_ms"] - \
                report["floor_ms"]
            for v in rec["variants"].values():
                v["net_ms"] = v["ms"] - report["floor_ms"]
        report["cases"].append(rec)
        for key, v in rec["variants"].items():
            ok &= v["ok"] and v["run_to_run"]
            print(_line(rec, key, v), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
