"""Time the flash-attention kernels on the card against SDPA and their
bounds, and the plan's alternatives against the plan.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash [--dtype bf16] [--variant] [--out FILE]

For phase 7's attention (B = 2, S = 1024, 32 / 8 heads, hd 64, causal)
and causal S = 512, 2048 and 4096 (B = 1 at 4096), and at gemma-2b's
training attention (B = 2, S = 1024, 8 / 1 heads, hd 256) and the
expanded MLA's (B = 1, S = 1024, 128 / 128 heads, hd 192 / hd_v 128), the
forward, dq and dk/dv kernels run under ``_flash_plan``'s plan, each
beside its bound (the larger of its bytes over 3.35 TB/s and its flops
over the peak of its type: 67 TFLOP/s f32 on the CUDA cores, 989 TFLOP/s
bf16 on the tensor cores; the causal pairs counted) and beside
``F.scaled_dot_product_attention`` in the same type with
``enable_gqa=True`` (its forward; its backward through autograd computes
dq, dk and dv at once), a yardstick the port never calls.  ``--dtype
bf16`` (the tensor-core forward, dq and dk/dv) runs seamless-m4t-medium's
encoder (B = 1, S = 128, 16 heads x 64, bidirectional) and llama's
``prefill_32k`` cell (B = 1, causal S = 32768, 32 / 8 heads x 64; phase
16's prefill step launches the forward there) in place of the MLA
shape.  With ``--variant`` the forward also runs with 1 and 2 ring
stages (in bf16 also with 64 and 128 query rows a CTA), dq with 64 and
128 query rows a CTA (f32: its ring has 2 stages up to hd 128, 1 and 2
past it; bf16: 1 and 2 stages),
and dk/dv with 64 and 128 kv rows a CTA, 1 and 2 stages, one or two heads
a CTA, and every head of a group in one CTA, each where it fits; each
variant is held to the plan's result, bitwise (two heads a dk/dv CTA: at
the gradients' 3e-5 + 1e-3 relative in f32, 2e-2 in bf16, as the pairs
are summed first).  Each time is the median device time of
15 runs between CUDA events, L2 flushed before each.  The build's
registers and spills and each flash kernel's FFMA, LDS and HMMA counts in
the mainloops of its SASS (``cuobjdump -sass``) are printed first.
One line per case; the records go to ``--out`` as JSON.  Needs a CUDA
card.
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
    _call_plan, _dkv_smem, _dkv_tc_smem, _dq_smem, _dq_tc_smem, _flash_plan,
    _fwd_smem, _MAX_SMEM, _width, flash_dkv_cuda, flash_dq_cuda,
    flash_fwd_cuda)
from repro_torch.launch.bench_gemm import timer

PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM = 3.35e12
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# name, B, S, H, KVH, hd, hd_v, causal: llama3.2-1b's attention (32 / 8
# heads x 64) at four lengths and gemma-2b's (8 / 1 x 256); in f32 also the
# expanded MLA's (128 heads, 192 / 128), in bf16 seamless-m4t-medium's
# encoder (16 x 64, bidirectional) and llama at prefill_32k's length
CASES = [("phase 7", 2, 1024, 32, 8, 64, 64, True),
         ("S 512", 2, 512, 32, 8, 64, 64, True),
         ("S 2048", 2, 2048, 32, 8, 64, 64, True),
         ("S 4096", 1, 4096, 32, 8, 64, 64, True),
         ("gemma-2b", 2, 1024, 8, 1, 256, 256, True)]
F32_CASES = [("MLA", 1, 1024, 128, 128, 192, 128, True)]
BF16_CASES = [("seamless", 1, 128, 16, 16, 64, 64, False),
              ("prefill_32k", 1, 32768, 32, 8, 64, 64, True)]


def _short(fn: str) -> str:
    """A mangled flash kernel's name and template arguments, short."""
    m = re.search(r"(flash_(?:fwd|dq|dkv_sum|dkv)(?:_wide|_tc|_pair)?_kernel)",
                  fn)
    args = ["bf16" if "bfloat16" in fn or "_tc_" in fn else "f32"]
    args += re.findall(r"Li(\d+)E", fn)
    args += ["true" if b == "1" else "false" for b in re.findall(r"Lb(\d)E", fn)]
    return f"{m.group(1) if m else fn}<{', '.join(args)}>"


def mainloops(sass: str) -> dict:
    """{function: [(FFMA, LDS, HMMA) of each loop, most HMMA, then most
    FFMA, first]} of a ``cuobjdump -sass`` listing: a loop runs from a backward
    branch's target to the branch, and counts its own instructions, not
    those of the loops inside it (the products' mainloops: an f32
    kernel's innermost FMA loop, or a tensor-core kernel's tile loop,
    whose copy loops are nested in it)."""
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

        def own(a, b):
            inner = [(c, d) for c, d in loops
                     if a <= c and d <= b and (c, d) != (a, b)]
            return [t for x, t in ins if a <= x <= b and
                    not any(c <= x <= d for c, d in inner)]
        counts = [tuple(sum(bool(re.match(rf"(@\S+ )?{op}\b", t))
                            for t in own(a, b))
                        for op in ("FFMA", "LDS", "HMMA")) for a, b in loops]
        out[fn] = sorted(counts, key=lambda c: (c[2], c[0]), reverse=True)
    return out


def build_report(paths) -> list:
    """ptxas's registers and spills of each flash kernel, and the FFMA, LDS
    and HMMA (tensor-core) instructions of the three loops of each with
    the most HMMA, then FFMA, of their own (the products' mainloops) in
    the library's SASS."""
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
                lines.append(f"{_short(fn)}: SASS mainloops (FFMA, LDS, "
                             "HMMA) " + ", ".join(
                                 f"({f}, {n}, {m})" for f, n, m in loops[:3]))
    return lines


def inputs(B, S, H, KVH, HD, HV, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + S)
    q, do = (torch.randn((B, S, H, d), generator=gen, device="cuda")
             .to(dtype) for d in (HD, HV))
    k, v = (torch.randn((B, S, KVH, d), generator=gen, device="cuda")
            .to(dtype) for d in (HD, HV))
    return q, k, v, do


def bounds(B, S, H, KVH, HD, HV, causal, dtype):
    """(fwd, dq, dkv) bound ms: chip_smoke.py's byte and flop counts."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    es = torch.finfo(dtype).bits // 8
    qb, kb, st = B * S * H * HD * es, B * S * KVH * HD * es, 4 * B * H * S
    ob, vb = qb // HD * HV, kb // HD * HV

    def b(nbytes, flops):
        return max(nbytes / HBM, flops / PEAK[dtype]) * 1e3
    return (b(qb + kb + vb + ob + st, 2 * (HD + HV) * pairs),
            b(2 * qb + ob + kb + vb + 2 * st, 2 * (2 * HD + HV) * pairs),
            b(qb + ob + 2 * kb + 2 * vb + 2 * st, 4 * (HD + HV) * pairs))


def run_case(name, B, S, H, KVH, HD, HV, causal, dtype, variants):
    import torch.nn.functional as F
    q, k, v, do = inputs(B, S, H, KVH, HD, HV, dtype)
    scale = HD ** -0.5
    kw = dict(causal=causal, scale=scale)
    plan = _call_plan(q, k, v)
    # a variant is the plan's rules under the same call, one field forced
    rule = dict(dtype=dtype, fwd_units=B * H * S, num_sms=torch.cuda
                .get_device_properties(0).multi_processor_count)
    o, lse = flash_fwd_cuda(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    st = (q, k, v, do, lse, delta)
    bf, bq, bd = bounds(B, S, H, KVH, HD, HV, causal, dtype)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    gout = do.transpose(1, 2)
    rec = {"name": name, "B": B, "S": S, "H": H, "KVH": KVH, "hd": HD,
           "hd_v": HV, "causal": causal, "dtype": str(dtype).split(".")[-1],
           "plan": plan._asdict(),
           "fwd": {"ms": timer(lambda: flash_fwd_cuda(q, k, v, **kw)),
                   "bound_ms": bf},
           "dq": {"ms": timer(lambda: flash_dq_cuda(*st, **kw)),
                  "bound_ms": bq},
           "dkv": {"ms": timer(lambda: flash_dkv_cuda(*st, **kw)),
                   "bound_ms": bd},
           "sdpa_fwd_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=True)),
           "sdpa_bwd_ms": timer(lambda: torch.autograd.grad(
               out, (qt, kt, vt), gout, retain_graph=True)),
           "variants": {}}
    if variants:
        W, G = _width(HD, HV), H // KVH
        tc = dtype == torch.bfloat16
        dkv_smem = _dkv_tc_smem if tc else _dkv_smem
        want = (o, lse)
        fwd = [dict(fwd_stages=n) for n in (1, 2)
               if _fwd_smem(W, n) <= _MAX_SMEM]
        if tc:
            fwd = [dict(fwd_stages=n, fwd_rows=r)
                   for n in (1, 2) for r in (64, 128)]
        for var in fwd:
            p = _flash_plan(H, KVH, HD, HV, **rule, **var)
            got = flash_fwd_cuda(q, k, v, plan=p, **kw)
            label = f"fwd stages {p.fwd_stages}" + (
                f" rows {p.fwd_rows}" if tc else "")
            rec["variants"][label] = {
                "ms": timer(lambda: flash_fwd_cuda(q, k, v, plan=p, **kw)),
                "is_plan": p == plan,
                "ok": all(torch.equal(x, y) for x, y in zip(got, want))}
        want = flash_dq_cuda(*st, **kw)
        dq = [dict(dq_rows=r) for r in (64, 128)
              if _dq_smem(r, W) <= _MAX_SMEM]
        if tc:
            dq = [dict(dq_rows=r, dq_stages=n) for r in (64, 128)
                  for n in (1, 2) if _dq_tc_smem(r, W, n) <= _MAX_SMEM]
        elif W > 128:                # the paired dq: 64 rows, 1 or 2 stages
            dq = [dict(dq_stages=n) for n in (1, 2)]
        for var in dq:
            p = _flash_plan(H, KVH, HD, HV, **rule, **var)
            got = flash_dq_cuda(*st, plan=p, **kw)
            label = f"dq rows {p.dq_rows}" + (
                f" stages {p.dq_stages}" if tc or W > 128 else "")
            rec["variants"][label] = {
                "ms": timer(lambda: flash_dq_cuda(*st, plan=p, **kw)),
                "is_plan": p == plan, "ok": torch.equal(got, want)}
        want = flash_dkv_cuda(*st, **kw)
        dkv = [dict(dkv_rows=r, dkv_stages=n, heads=hs) for r in (64, 128)
               for n in (1, 2) for hs in (1, 2)
               if dkv_smem(r, W, n) <= _MAX_SMEM and hs <= G]
        dkv.append(dict(heads=G))
        atol, rtol = (2e-2, 2e-2) if tc else (3e-5, 1e-3)
        for var in dkv:
            p = _flash_plan(H, KVH, HD, HV, **rule, **var)
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
                          torch.allclose(x.float(), y.float(), atol=atol,
                                         rtol=rtol)
                          for x, y in zip(got, want))}
    return rec


def _line(rec):
    def k(name):
        r = rec[name]
        return (f"{name} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, "
                f"{100 * r['bound_ms'] / r['ms']:.0f}%)")
    head = (f"{rec['name']:<8} {rec['dtype']} B={rec['B']} S={rec['S']} "
            f"H={rec['H']}/{rec['KVH']} hd={rec['hd']}/{rec['hd_v']}: " +
            "  ".join(k(n) for n in ("fwd", "dq", "dkv")) +
            f"  SDPA fwd {rec['sdpa_fwd_ms']:.4f} bwd "
            f"{rec['sdpa_bwd_ms']:.4f}")
    for name, v in rec["variants"].items():
        head += (f"\n    {name:<28} {v['ms']:.4f}{'*' if v['is_plan'] else ''}"
                 f"{'' if v['ok'] else ' (MISMATCH)'}")
    return head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--variant", action="store_true",
                    help="also time the plan's alternatives")
    ap.add_argument("--out", default="build/bench_flash.json")
    ap.add_argument("--only", nargs="+", default=None, metavar="NAME",
                    help="run only the cases of these names")
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
    dtype = DTYPES[args.dtype]
    for case in CASES + (BF16_CASES if dtype == torch.bfloat16
                         else F32_CASES):
        if args.only and case[0] not in args.only:
            continue
        rec = run_case(*case, dtype, args.variant)
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
