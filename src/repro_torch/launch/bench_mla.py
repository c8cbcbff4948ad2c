"""Time the paged MLA kernel (``csrc/paged_mla.cu``) against the plans its
rule rejected, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_mla [--out FILE]

For each case (phase 3's decode and prefill at deepseek-v3's widths: 8
lanes, 128 heads, r = 512, rd = 64, pages of 16, bf16; 8 lanes of one row,
the kernel's floor; one lane of 4096 rows; one lane's late chunk) the kernel runs under ``_mla_plan``'s plan
and under forced split counts, and once in f32 under its plan.  Each time is the median device time of 15 runs between CUDA
events, L2 flushed before each run, beside the plain version, the bound
(bytes of the live latent rows, q and o over 3.35 TB/s against the
products at the bf16 peak) and, as a yardstick,
``F.scaled_dot_product_attention`` over the latents gathered contiguous
beforehand (key [c_kv | k_rope], value c_kv, the heads over one latent
head with ``enable_gqa``, masked to the lengths and the causal offset; the
gather is not counted), with the SDPA backends that take or refuse these
widths.  Every variant is held to the plain version (bf16: 5 * 2 * 2^-8,
as ``chip_smoke.py``; f32 1e-4) and to itself run to run, bitwise; whether
its bits equal the plan's is printed (another split count merges in
another order).  The build's registers and spills of each MLA kernel come
first.  One line per variant; the records go to ``--out`` as JSON.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import re
from pathlib import Path

import torch

from repro_torch.kernels.paged_attn import paged_gather
from repro_torch.kernels.paged_mla import (
    _mla_plan, paged_mla_decode_plain, paged_mla_decode_cuda,
    paged_mla_prefill_plain, paged_mla_prefill_cuda)
from repro_torch.launch.bench_gemm import timer

H, R, RD, BS = 128, 512, 64, 16    # deepseek-v3's MLA widths, pages of 16
QK = 192                           # qk_nope + qk_rope: the softmax scale
HBM, PEAK_BF16 = 3.35e12, 989e12
TOL = {torch.bfloat16: 5 * 2 * 2.0 ** -8, torch.float32: 1e-4}
# name, lengths (decode) or (starts, chunks) (prefill)
DECODE = [("phase 3 decode", [0, 1, 15, 16, 17, 200, 400, 545]),
          ("8 lanes of one row", [1] * 8),
          ("one lane of 4096", [4096])]
PREFILL = [("phase 3 prefill", [0, 0, 64, 100, 0, 448, 0, 10],
            [64, 10, 64, 37, 0, 64, 1, 64]),
           ("one lane, late chunk", [448], [64])]
FORCED = (1, 2, 4, 8, 16, 32, 64)


def mla_inputs(lengths, dtype, seed=0):
    """Latent arenas over disjoint pages a lane (dead columns repeat the
    last live id; a lane of length 0 gets an all-zero row), from ``seed``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    S = len(lengths)
    W = max(1, max(-(-n // BS) for n in lengths))
    tables = torch.zeros((S, W), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nb = -(-n // BS)
        if nb:
            tables[i, :nb] = torch.arange(nxt, nxt + nb)
            tables[i, nb:] = nxt + nb - 1
            nxt += nb
    ckv = torch.randn((nxt + 1, BS, R), generator=gen, device="cuda")
    kr = torch.randn((nxt + 1, BS, RD), generator=gen, device="cuda")
    return (ckv.to(dtype), kr.to(dtype), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), gen)


def bound_ms(rows, pairs, io_bytes):
    """(least ms, what bounds it): each live latent row read once (bf16), q
    in and o out once, against the score and mix products at the bf16
    peak."""
    t_bytes = (rows * (R + RD) * 2 + io_bytes) / HBM * 1e3
    t_ops = 2.0 * H * (R + RD + R) * pairs / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def gathered_mla_sdpa(qa, qr, ckv, kr, tables, lengths, scale, starts=None):
    """A callable running ``F.scaled_dot_product_attention`` over latents
    gathered through the tables before the call: key [c_kv | k_rope] (S, 1,
    L, r + rd), value c_kv (S, 1, L, r), the H heads over that one latent
    head (``enable_gqa``), masked to each lane's length and, for a prefill
    chunk (q (S, C, H, .), ``starts``), to the causal offset.  The
    yardstick for the MLA kernels; the gather is not counted.  (A lane of
    length 0 is fully masked and comes back as NaN; it is only timed.)"""
    import torch.nn.functional as F
    c = paged_gather(ckv, tables)
    k = torch.cat([c, paged_gather(kr, tables)], -1)[:, None].contiguous()
    v = c[:, None].contiguous()
    q = torch.cat([qa, qr], -1)
    L, dev = k.shape[2], q.device
    col = torch.arange(L, device=dev)
    if starts is None:
        mask = (col[None, :] < lengths.long()[:, None])[:, None, None, :]
        qq = q[:, :, None, :]                                # (S, H, 1, E)
    else:
        C = q.shape[1]
        qpos = starts.long()[:, None] + torch.arange(C, device=dev)[None, :]
        m = ((col[None, None, :] < lengths.long()[:, None, None]) &
             (col[None, None, :] <= qpos[:, :, None]))       # (S, C, L)
        mask = m[:, None]                                    # (S, 1, C, L)
        qq = q.transpose(1, 2)                               # (S, H, C, E)
    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def sdpa_backends(fn) -> dict:
    """Which SDPA backends take the call: {name: "ok" or the refusal}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                fn()
            torch.cuda.synchronize()
            out[b.name] = "ok"
        except RuntimeError as e:
            out[b.name] = "refused: " + str(e).splitlines()[0][:80]
    return out


def run_case(name, dtype, lengths=None, starts=None, chunks=None,
             variants=True):
    """Every variant of one case; returns its record."""
    prefill = starts is not None
    lens_list = [s + c for s, c in zip(starts, chunks)] if prefill \
        else lengths
    ckv, kr, tables, lens, gen = mla_inputs(lens_list, dtype)
    S, W = len(lens_list), tables.shape[1]
    C = 64 if prefill else 1
    shape = (S, C, H) if prefill else (S, H)
    qa = torch.randn(shape + (R,), generator=gen, device="cuda").to(dtype)
    qr = torch.randn(shape + (RD,), generator=gen, device="cuda").to(dtype)
    scale = 1.0 / math.sqrt(QK)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if prefill:
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        a = (qa, qr, ckv, kr, tables, st, lens)
        kernel, plain_fn = paged_mla_prefill_cuda, \
            paged_mla_prefill_plain
        live = (torch.arange(C, device="cuda")[None, :] <
                torch.tensor(chunks, device="cuda")[:, None])
        pairs = sum(s + c + 1 for s, n in zip(starts, chunks)
                    for c in range(n))
    else:
        a = (qa, qr, ckv, kr, tables, lens)
        kernel, plain_fn = paged_mla_decode_cuda, paged_mla_decode_plain
        live = torch.ones(S, dtype=torch.bool, device="cuda")
        pairs = sum(lens_list)
    want = plain_fn(*a, scale=scale).float()
    esize = qa.element_size()
    plan = _mla_plan(S, C * H, W, BS, R, RD, esize, sms)
    rows = sum(-(-n // BS) * BS for n in lens_list)
    io = (qa.numel() + qr.numel() + qa.numel()) * 2
    b_ms, b_by = bound_ms(rows, pairs, io)
    rec = {"name": name, "dtype": str(dtype).split(".")[-1], "S": S, "W": W,
           "lengths": lens_list, "plan": plan._asdict(), "bound_ms": b_ms,
           "bound_by": b_by, "plain_ms": timer(lambda: plain_fn(
               *a, scale=scale)), "variants": {}}
    if dtype == torch.bfloat16:
        sd = gathered_mla_sdpa(qa, qr, ckv, kr, tables, lens, scale,
                               st if prefill else None)
        rec["sdpa_backends"] = sdpa_backends(sd)
        try:
            rec["sdpa_gathered_ms"] = timer(sd)
        except RuntimeError as e:
            rec["sdpa_gathered_ms"] = None
            rec["sdpa_error"] = str(e).splitlines()[0][:120]
    ref = kernel(*a, scale=scale, plan=plan)
    cands = {"plan": plan}
    if variants and dtype == torch.bfloat16:
        for n in FORCED:
            p = _mla_plan(S, C * H, W, BS, R, RD, esize, sms, splits=n)
            if p.splits == n and p != plan:
                cands[f"{n} splits"] = p
    for key, p in cands.items():
        got = kernel(*a, scale=scale, plan=p)
        again = kernel(*a, scale=scale, plan=p)
        torch.cuda.synchronize()
        err = (got.float() - want).abs()[live].max().item()
        rec["variants"][key] = {
            "plan": p._asdict(), "ctas": p.ctas,
            "ms": timer(lambda: kernel(*a, scale=scale, plan=p)),
            "max_abs_err": err, "ok": err <= TOL[dtype],
            "bitwise_plan": bool(torch.equal(got, ref)),
            "run_to_run": bool(torch.equal(got, again))}
    return rec


def build_report() -> list:
    """ptxas's registers, shared memory and spills of each MLA kernel."""
    from repro_torch.kernels import _build
    log = _build.build_all()["paged_mla"].with_suffix(".log")
    lines, fn = [], None
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "paged_mla" in fn and ("registers" in line or
                                            "spill" in line):
            t = ["bf16" if "bfloat16" in fn else "f32"] + \
                re.findall(r"Li(\d+)E", fn)
            lines.append(f"paged_mla_kernel<{', '.join(t)}>: {line.strip()}")
    return lines


def _line(rec, key, v):
    p = v["plan"]
    sd = rec.get("sdpa_gathered_ms")
    return (f"{rec['name']:<22} {rec['dtype']:<8} {key:<10} "
            f"{p['splits']} x {p['units']} = {v['ctas']:>4} CTAs of "
            f"{p['rows']} rows: {v['ms']:.4f} ms, err {v['max_abs_err']:.2e}"
            f" {'ok' if v['ok'] else 'FAIL'}, plan bits "
            f"{v['bitwise_plan']}, run to run {v['run_to_run']}  (plain "
            f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"{rec['bound_by']}" + (f", sdpa {sd:.4f}" if sd else "") + ")")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/bench_mla.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_mla: needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0),
              "build": build_report(), "cases": []}
    for line in report["build"]:
        print(line, flush=True)
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        for name, lengths in DECODE:
            report["cases"].append(run_case(name, dtype, lengths=lengths,
                                            variants=bf))
        for name, starts, chunks in PREFILL:
            report["cases"].append(run_case(name, dtype, starts=starts,
                                            chunks=chunks, variants=bf))
        for rec in report["cases"]:
            if rec["dtype"] != str(dtype).split(".")[-1]:
                continue
            for key, v in rec["variants"].items():
                ok &= v["ok"] and v["run_to_run"]
                print(_line(rec, key, v), flush=True)
            if rec.get("sdpa_backends"):
                print(f"{rec['name']:<22} sdpa backends: "
                      f"{rec['sdpa_backends']}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
