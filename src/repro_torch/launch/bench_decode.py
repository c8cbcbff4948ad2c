"""Time the split-KV paged attention kernels against the split counts their
plans rejected, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_decode [--out FILE]

For each decode case (phase 3's and phase 4's decode, phase 5's unique
phase, a long context, and a batch wide enough that the plan does not
split) the decode kernel runs under ``_decode_plan``'s plan and under
forced split counts; for each shared-prefix case (phase 5's cascade step,
and a 128-page prefix) and each prefill case (phase 3's chunk step, and
one lane's late chunk at phase 5's first admission) the prefill / prefix
kernel runs under ``_attn_plan``'s plan and forced split counts, and once
in f32 under its plan.  Each time is the median device time of 15 runs
between CUDA events, L2 flushed before each run, beside the plain
version and, as a yardstick,
``F.scaled_dot_product_attention`` over the same K/V already gathered
contiguous and masked to the lengths (the causal offset too, for
prefill; the gather is not counted; no PyTorch call reads K/V through a
page table).  Every variant is held to the plain version (bf16: 5 * 2 *
2^-8, as ``chip_smoke.py``) and to itself run to run, bitwise.  One line
per case; the records go to ``--out`` as JSON.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.paged_attn import (
    _attn_plan, _decode_plan, paged_decode_plain, paged_decode_cuda,
    paged_gather, paged_prefill_plain, paged_prefill_cuda,
    paged_prefix_cuda, paged_prefix_plain)
from repro_torch.launch.bench_gemm import timer

KVH, G, HD, BS = 8, 4, 64, 16      # llama3.2-1b's decode widths, pages of 16
TOL = 5 * 2 * 2.0 ** -8
# name, lengths, table width
CASES = [
    ("phase 3 decode", [0, 1, 15, 16, 17, 200, 400, 545], 35),
    ("phase 4 decode", [97, 130, 211, 288, 340, 401, 476, 512], 32),
    ("phase 5 unique", [0, 1, 15, 16, 17, 100, 128, 129], 9),
    ("long context", [8192], 512),
    ("16 lanes", [(i * 67) % 546 for i in range(16)], 35),
]
FORCED = (1, 2, 3, 4, 8, 16, 32, 64)
# name, prefix lengths of the lanes (0 = not in the group), prefix pages
PREFIX_CASES = [
    ("phase 5 prefix", [384] * 6 + [0, 384], 24),
    ("128-page prefix", [2048] * 8, 128),
]
# name, starts, chunks (a 64-row chunk a lane)
PREFILL_CASES = [
    ("phase 3 prefill", [0, 0, 64, 100, 0, 448, 0, 10],
     [64, 10, 64, 37, 0, 64, 1, 64]),
    ("one lane, late chunk", [384], [64]),
]


def decode_inputs(lengths, W, dtype=torch.bfloat16, seed=0):
    """Disjoint pages a lane (dead columns repeat the last live id), random
    K/V and queries from ``seed``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    S = len(lengths)
    tables = torch.zeros((S, W), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nb = -(-n // BS)
        if nb:
            tables[i, :nb] = torch.arange(nxt, nxt + nb)
            tables[i, nb:] = nxt + nb - 1
            nxt += nb
    k = torch.randn((nxt + 1, BS, KVH, HD), generator=gen, device="cuda")
    v = torch.randn((nxt + 1, BS, KVH, HD), generator=gen, device="cuda")
    q = torch.randn((S, KVH * G, HD), generator=gen, device="cuda")
    return (q.to(dtype), k.to(dtype), v.to(dtype), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def gathered_sdpa(q, k_arena, v_arena, tables, lengths, scale):
    """A callable running ``F.scaled_dot_product_attention`` over K/V that
    were gathered through the tables into contiguous (S, KVH, W * bs, hd)
    tensors before the call, masked to each lane's length: the yardstick
    for the paged decode kernels, with the gather not counted.  (A lane of
    length 0 is fully masked and comes back as NaN; it is only timed.)"""
    import torch.nn.functional as F
    k = paged_gather(k_arena, tables).transpose(1, 2).contiguous()
    v = paged_gather(v_arena, tables).transpose(1, 2).contiguous()
    L = k.shape[2]
    mask = (torch.arange(L, device=q.device)[None, :] <
            lengths.long()[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def gathered_sdpa_prefill(q, k_arena, v_arena, tables, starts, lengths,
                          scale):
    """:func:`gathered_sdpa` for a prefill chunk: q (S, C, H, hd), chunk
    row r of lane s masked to the columns < lengths[s] and <= starts[s] +
    r (the causal offset), K/V gathered beforehand."""
    import torch.nn.functional as F
    k = paged_gather(k_arena, tables).transpose(1, 2).contiguous()
    v = paged_gather(v_arena, tables).transpose(1, 2).contiguous()
    C, dev = q.shape[1], q.device
    col = torch.arange(k.shape[2], device=dev)
    qpos = starts.long()[:, None] + torch.arange(C, device=dev)[None, :]
    mask = ((col[None, None, :] < lengths.long()[:, None, None]) &
            (col[None, None, :] <= qpos[:, :, None]))[:, None]
    qq = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def bound_ms(lengths):
    """Bytes of the live K/V pages, q and o, over 3.35 TB/s (the flops,
    4 * H * hd a token, are far under the bf16 peak)."""
    rows = sum(-(-n // BS) * BS for n in lengths)
    nbytes = rows * KVH * 2 * HD * 2 + 2 * len(lengths) * KVH * G * HD * 2
    return nbytes / 3.35e12 * 1e3


def run_case(name, lengths, W, sms):
    q, k, v, tables, lens = decode_inputs(lengths, W)
    S, scale = len(lengths), 1.0 / math.sqrt(HD)
    a = (q, k, v, tables, lens)
    plan = _decode_plan(S, KVH, G, W, BS, HD, HD, 2, sms)
    want = paged_decode_plain(*a, scale=scale)
    rec = {"name": name, "S": S, "W": W, "lengths": lengths,
           "plan": plan._asdict(), "bound_ms": bound_ms(lengths),
           "plain_ms": timer(lambda: paged_decode_plain(*a, scale=scale)),
           "sdpa_gathered_ms": timer(gathered_sdpa(*a, scale)),
           "variants": {}}
    counts = sorted({plan.splits} | {n for n in FORCED if n <= W})
    for n in counts:
        p = _decode_plan(S, KVH, G, W, BS, HD, HD, 2, sms, splits=n)
        got = paged_decode_cuda(*a, scale=scale, plan=p)
        again = paged_decode_cuda(*a, scale=scale, plan=p)
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= TOL and torch.equal(got, again)
        rec["variants"][f"{p.splits} splits"] = {
            "ms": timer(lambda: paged_decode_cuda(*a, scale=scale, plan=p)),
            "plan": p._asdict(), "is_plan": p == plan, "max_abs_err": err,
            "ok": ok}
    return rec


def _variants(rec, plan_for, run, want, close, W):
    """Time ``run`` under the plan and each forced split count up to W;
    each held to ``want`` and to a second run, bitwise."""
    plan = rec["plan"] = plan_for(None)._asdict()
    for n in sorted({plan["splits"]} | {n for n in FORCED if n <= W}):
        p = plan_for(n)
        got, again = run(p), run(p)
        ok = close(got, want) and all(
            torch.equal(x, y) for x, y in zip(got, again))
        rec["variants"][f"{p.splits} splits"] = {
            "ms": timer(lambda: run(p)), "plan": p._asdict(),
            "is_plan": p._asdict() == plan, "ok": ok}


def run_prefix_case(name, plens, P, sms):
    """The shared-prefix phase over a P-page prefix (padded with 8 repeats
    of the last id, as the engine's page list may be)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(P)
    S = len(plens)
    pages = list(range(P)) + [P - 1] * 8
    k = torch.randn((P, BS, KVH, HD), generator=gen, device="cuda")
    v = torch.randn((P, BS, KVH, HD), generator=gen, device="cuda")
    q = torch.randn((S, KVH * G, HD), generator=gen, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    a = (q.bfloat16(), k.bfloat16(), v.bfloat16(),
         torch.tensor(pages, **i32), torch.tensor(plens, **i32))
    scale = 1.0 / math.sqrt(HD)
    W = len(pages)
    want = paged_prefix_plain(*a, scale=scale)
    rows = max(plens)
    nbytes = -(-rows // BS) * BS * KVH * 2 * HD * 2 + 2 * q.numel() * 2
    rec = {"name": name, "S": S, "W": W, "prefix_lens": plens,
           "bound_ms": nbytes / 3.35e12 * 1e3,
           "plain_ms": timer(lambda: paged_prefix_plain(
               *a, scale=scale)), "variants": {}}
    _variants(rec, lambda n: _attn_plan(1, S * G, KVH, W, BS, HD, HD, 2, sms,
                                        splits=n),
              lambda p: paged_prefix_cuda(*a, scale=scale, plan=p), want,
              lambda got, w: (got[0].float() - w[0].float()).abs().max()
              .item() <= TOL, W)
    f32 = tuple(x.float() if x.is_floating_point() else x for x in a)
    rec["f32_ms"] = timer(lambda: paged_prefix_cuda(*f32, scale=scale))
    return rec


def run_prefill_case(name, starts, chunks, sms):
    """One 64-row chunk a lane at ``starts``, ``chunks`` live rows."""
    lengths = [s + c for s, c in zip(starts, chunks)]
    W = max(1, max(-(-n // BS) for n in lengths))
    q, k, v, tables, lens = decode_inputs(lengths, W, seed=len(lengths))
    S, C = len(lengths), 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(C)
    q = torch.randn((S, C, KVH * G, HD), generator=gen,
                    device="cuda").bfloat16()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    a = (q, k, v, tables, st, lens)
    scale = 1.0 / math.sqrt(HD)
    want = paged_prefill_plain(*a, scale=scale)
    pairs = sum(min(s + r + 1, s + c) for s, c in zip(starts, chunks)
                for r in range(c))
    nbytes = (sum(-(-n // BS) * BS for n in lengths) * KVH * 2 * HD * 2 +
              2 * q.numel() * 2)
    rec = {"name": name, "S": S, "W": W, "starts": starts, "chunks": chunks,
           "bound_ms": max(nbytes / 3.35e12,
                           4.0 * KVH * G * HD * pairs / 989e12) * 1e3,
           "plain_ms": timer(lambda: paged_prefill_plain(
               *a, scale=scale)),
           "sdpa_gathered_ms": timer(gathered_sdpa_prefill(*a, scale)),
           "variants": {}}
    _variants(rec, lambda n: _attn_plan(S, C * G, KVH, W, BS, HD, HD, 2, sms,
                                        prefill=True, splits=n),
              lambda p: (paged_prefill_cuda(*a, scale=scale, plan=p),), want,
              lambda got, w: (got[0].float() - w.float()).abs().max()
              .item() <= TOL, W)
    f32 = tuple(x.float() if x.is_floating_point() else x for x in a)
    rec["f32_ms"] = timer(lambda: paged_prefill_cuda(*f32, scale=scale))
    return rec


def _line(rec):
    pl = rec["plan"]
    yard = (f"  SDPA gathered {rec['sdpa_gathered_ms']:.4f}"
            if "sdpa_gathered_ms" in rec else "")
    yard += f"  f32 {rec['f32_ms']:.4f}" if "f32_ms" in rec else ""
    return (f"{rec['name']:<20} S={rec['S']} W={rec['W']} plan "
            f"{pl['splits']} splits ({pl['splits'] * pl['units']} CTAs)  "
            f"bound {rec['bound_ms']:.5f} ms  plain {rec['plain_ms']:.4f}"
            f"{yard}  " + "  ".join(
                f"{k} {v['ms']:.4f}{'*' if v['is_plan'] else ''}"
                f"{'' if v['ok'] else ' (MISMATCH)'}"
                for k, v in rec["variants"].items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/bench_decode.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_decode: needs a CUDA card")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    recs, ok = [], True
    runs = ([lambda c=c: run_case(*c, sms) for c in CASES] +
            [lambda c=c: run_prefix_case(*c, sms) for c in PREFIX_CASES] +
            [lambda c=c: run_prefill_case(*c, sms) for c in PREFILL_CASES])
    for run in runs:
        rec = run()
        recs.append(rec)
        ok &= all(v["ok"] for v in rec["variants"].values())
        print(_line(rec), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "cases": recs}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
