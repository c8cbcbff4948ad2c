"""Time the flash-attention kernels on the card against SDPA and their
bounds, and the plan's alternatives against the plan.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash [--variant] [--out FILE]

For phase 7's attention (B = 2, S = 1024, 32 / 8 heads, hd 64, causal,
f32) and causal S = 512, 2048 and 4096 (B = 1 at 4096), the forward, dq
and dk/dv kernels run under ``_flash_plan``'s plan, each beside its bound
(the larger of its bytes over 3.35 TB/s and its flops over the 67 TFLOP/s
f32 CUDA-core peak, the causal pairs counted) and beside
``F.scaled_dot_product_attention`` in f32 with ``enable_gqa=True`` (its
forward; its backward through autograd computes dq, dk and dv at once), a
yardstick the port never calls.  With ``--variant`` the forward also runs
with 1 and 2 ring stages (three and two CTAs an SM), dq with 64 and 128
query rows a CTA (its ring has 2 stages), and dk/dv with 64 and 128 kv
rows a CTA, 1 and 2 stages, one or two heads a CTA, and every head of a
group in one CTA;
each variant is held to the plan's result, bitwise (two heads a dk/dv
CTA: at the gradients' 3e-5 + 1e-3 relative, as the pairs are summed
first).  Each time is the median device time of 15
runs between CUDA events, L2 flushed before each.  The build's registers
and spills and each flash kernel's FFMA and LDS counts in its SASS
(``cuobjdump -sass``) are printed first.  One line per case; the records
go to ``--out`` as JSON.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import (
    _dkv_smem, _dq_smem, _flash_plan, _MAX_SMEM, _width, flash_dkv_cuda,
    flash_dq_cuda, flash_fwd_cuda)
from repro_torch.launch.bench_gemm import timer

H, KVH, HD = 32, 8, 64          # llama3.2-1b's attention
PEAK_F32, HBM = 67e12, 3.35e12
# name, B, S (causal)
CASES = [("phase 7", 2, 1024), ("S 512", 2, 512), ("S 2048", 2, 2048),
         ("S 4096", 1, 4096)]


def _short(fn: str) -> str:
    """A mangled flash kernel's name and template arguments, short."""
    m = re.search(r"(flash_(?:fwd|dq|dkv_sum|dkv)(?:_wide)?_kernel)", fn)
    args = ["bf16" if "bfloat16" in fn else "f32"]
    args += re.findall(r"Li(\d+)E", fn)
    args += ["true" if b == "1" else "false" for b in re.findall(r"Lb(\d)E", fn)]
    return f"{m.group(1) if m else fn}<{', '.join(args)}>"


def mainloops(sass: str) -> dict:
    """{function: [(FFMA, LDS) of each innermost loop, most FFMA first]}
    of a ``cuobjdump -sass`` listing: a loop runs from a backward branch's
    target to the branch, innermost when it holds no other loop."""
    funcs, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if fn and m:
            funcs[fn].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)]
        counts = [tuple(sum(bool(re.match(rf"(@\S+ )?{op}\b", t))
                            for x, t in ins if a <= x <= b)
                        for op in ("FFMA", "LDS")) for a, b in inner]
        out[fn] = sorted(counts, reverse=True)
    return out


def build_report(paths) -> list:
    """ptxas's registers and spills of each flash kernel, and the FFMA and
    LDS instructions of the three innermost loops of each (the products'
    mainloops) in the library's SASS."""
    lines = []
    log = paths["flash_attn"].with_suffix(".log")
    fn = None
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in line or "spill" in line) and \
                "flash" in fn:
            lines.append(f"{_short(fn)}: {line.strip()}")
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(exe).exists():
        sass = subprocess.run([exe, "-sass", str(paths["flash_attn"])],
                              capture_output=True, text=True).stdout
        for fn, loops in mainloops(sass).items():
            if "flash" in fn and loops:
                lines.append(f"{_short(fn)}: SASS innermost loops (FFMA, LDS) "
                             + ", ".join(f"({f}, {n})" for f, n in loops[:3]))
    return lines


def inputs(B, S, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + S)
    q, do = (torch.randn((B, S, H, HD), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((B, S, KVH, HD), generator=gen, device="cuda")
            for _ in range(2))
    return q, k, v, do


def bounds(B, S):
    """(fwd, dq, dkv) bound ms: chip_smoke.py's byte and flop counts."""
    pairs = B * H * S * (S + 1) // 2
    qb, kb, st = B * S * H * HD * 4, B * S * KVH * HD * 4, 4 * B * H * S

    def b(nbytes, flops):
        return max(nbytes / HBM, flops / PEAK_F32) * 1e3
    return (b(2 * qb + 2 * kb + st, 4 * HD * pairs),
            b(3 * qb + 2 * kb + 2 * st, 6 * HD * pairs),
            b(2 * qb + 4 * kb + 2 * st, 8 * HD * pairs))


def run_case(name, B, S, variants):
    import torch.nn.functional as F
    q, k, v, do = inputs(B, S)
    scale = HD ** -0.5
    kw = dict(causal=True, scale=scale)
    plan = _flash_plan(H, KVH, HD, HD)
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    st = (q, k, v, do, lse, delta)
    bf, bq, bd = bounds(B, S)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    gout = do.transpose(1, 2)
    rec = {"name": name, "B": B, "S": S, "H": H, "KVH": KVH, "hd": HD,
           "plan": plan._asdict(),
           "fwd": {"ms": timer(lambda: flash_fwd_cuda(q, k, v, **kw)),
                   "bound_ms": bf},
           "dq": {"ms": timer(lambda: flash_dq_cuda(*st, **kw)),
                  "bound_ms": bq},
           "dkv": {"ms": timer(lambda: flash_dkv_cuda(*st, **kw)),
                   "bound_ms": bd},
           "sdpa_fwd_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)),
           "sdpa_bwd_ms": timer(lambda: torch.autograd.grad(
               out, (qt, kt, vt), gout, retain_graph=True)),
           "variants": {}}
    if variants:
        W, G = _width(HD, HD), H // KVH
        want = (o, lse)
        for n in (1, 2):
            p = _flash_plan(H, KVH, HD, HD, fwd_stages=n)
            got = flash_fwd_cuda(q, k, v, plan=p, **kw)
            rec["variants"][f"fwd stages {n}"] = {
                "ms": timer(lambda: flash_fwd_cuda(q, k, v, plan=p, **kw)),
                "is_plan": p == plan,
                "ok": all(torch.equal(x, y) for x, y in zip(got, want))}
        want = flash_dq_cuda(*st, **kw)
        for r in (64, 128):
            if _dq_smem(r, W) > _MAX_SMEM:
                continue
            p = _flash_plan(H, KVH, HD, HD, dq_rows=r)
            got = flash_dq_cuda(*st, plan=p, **kw)
            rec["variants"][f"dq rows {r}"] = {
                "ms": timer(lambda: flash_dq_cuda(*st, plan=p, **kw)),
                "is_plan": p == plan, "ok": torch.equal(got, want)}
        want = flash_dkv_cuda(*st, **kw)
        dkv = [dict(dkv_rows=r, dkv_stages=n, heads=hs) for r in (64, 128)
               for n in (1, 2) for hs in (1, 2)
               if _dkv_smem(r, W, n) <= _MAX_SMEM]
        dkv.append(dict(heads=G))
        for var in dkv:
            p = _flash_plan(H, KVH, HD, HD, **var)
            got = flash_dkv_cuda(*st, plan=p, **kw)
            label = (f"dkv rows {p.dkv_rows} stages {p.dkv_stages} heads "
                     f"{p.heads}")
            # the same f32 adds in the same order, unless a CTA pairs
            # heads up before the group sum: then the gradients' tolerance
            same = p.heads == plan.heads or p.parts == 1
            rec["variants"][label] = {
                "ms": timer(lambda: flash_dkv_cuda(*st, plan=p, **kw)),
                "is_plan": p == plan,
                "ok": all(torch.equal(x, y) if same else
                          torch.allclose(x, y, atol=3e-5, rtol=1e-3)
                          for x, y in zip(got, want))}
    return rec


def _line(rec):
    def k(name):
        r = rec[name]
        return (f"{name} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, "
                f"{100 * r['bound_ms'] / r['ms']:.0f}%)")
    head = (f"{rec['name']:<8} B={rec['B']} S={rec['S']}: " +
            "  ".join(k(n) for n in ("fwd", "dq", "dkv")) +
            f"  SDPA fwd {rec['sdpa_fwd_ms']:.4f} bwd "
            f"{rec['sdpa_bwd_ms']:.4f}")
    for name, v in rec["variants"].items():
        head += (f"\n    {name:<28} {v['ms']:.4f}{'*' if v['is_plan'] else ''}"
                 f"{'' if v['ok'] else ' (MISMATCH)'}")
    return head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="store_true",
                    help="also time the plan's alternatives")
    ap.add_argument("--out", default="build/bench_flash.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_flash: needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    report = build_report(_build.build_all())
    for line in report:
        print(line)
    recs, ok = [], True
    for name, B, S in CASES:
        rec = run_case(name, B, S, args.variant)
        recs.append(rec)
        ok &= all(v["ok"] for v in rec["variants"].values())
        print(_line(rec), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "build": report,
                               "cases": recs}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
