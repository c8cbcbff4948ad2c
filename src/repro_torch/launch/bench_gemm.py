"""Time the RSA GEMM kernel against the plans it rejected, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_gemm [--out FILE]

For each shape the kernel runs under ``_psum_plan``'s plan in the shape's
own mode, in the other walk order (WS and IS differ only in the order CTAs
walk the tiles; OS, one chunk over the whole K, walks in ``_OS_WALK``'s
order or the other), and under the alternatives the plan's two rules
turned down: the operands swapped or not (bf16), K split or not.  Each
time is the median device time of 15 runs between CUDA events, L2 flushed
before each run, beside ``torch.matmul`` (``torch.bmm`` for a bank) on the
same inputs.  Every alternative is checked against the plan's output
(bitwise for the other walk order, within the f32 summation bound
otherwise).  One line per shape; the records go to ``--out`` as JSON.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.core.hw import IS, OS, WS
from repro_torch.kernels.rsa_gemm import _OS_WALK, _psum_plan, rsa_gemm_cuda

BF, F32 = torch.bfloat16, torch.float32
# name, E, M, K, N, block_k, dtype, mode, B^T: the main paths' shapes each
# rule decides (phases 4, 6, 7 and 8 of chip_smoke.py); the OS rows are
# kernel row 1's (llama decode k/v, a deepseek head bank, the training dx of
# gate/up and of the tied unembedding)
SHAPES = [
    ("llama decode q/o", 1, 8, 2048, 2048, 2048, BF, IS, False),
    ("llama decode down", 1, 8, 8192, 2048, 2048, BF, IS, False),
    ("deepseek decode kv_a", 1, 8, 7168, 576, 2048, BF, IS, False),
    ("rwkv prefill r", 1, 73, 2048, 2048, 2048, BF, IS, False),
    ("rwkv prefill decay_b", 1, 73, 64, 2048, 128, BF, IS, False),
    ("rwkv prefill channel_v", 1, 296, 7168, 2048, 2048, BF, WS, False),
    ("llama prefill down", 1, 512, 8192, 2048, 2048, BF, IS, False),
    ("llama prefill gate/up", 1, 512, 2048, 8192, 2048, BF, WS, False),
    ("train k/v fwd", 1, 2048, 2048, 512, 2048, F32, WS, False),
    ("train gate/up fwd", 1, 2048, 2048, 8192, 2048, F32, WS, False),
    ("OS llama decode k/v", 1, 8, 2048, 512, 2048, BF, OS, False),
    ("OS llama prefill k/v", 1, 512, 2048, 512, 2048, BF, OS, False),
    ("OS head bank q_absorb", 128, 8, 128, 512, 128, BF, OS, False),
    ("OS train gate/up dx", 1, 2048, 8192, 2048, 2048, F32, OS, True),
    ("OS train unembed dx", 1, 1024, 128256, 2048, 2048, F32, OS, False),
]


def timer(fn, reps: int = 15) -> float:
    """Median device ms of ``fn``, L2 flushed first, a spin kernel holding
    the card while the host queues the events and the launch."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run_shape(name, E, M, K, N, bk, dtype, mode, b_t, sms):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M + K + N)
    lead = (E,) if E > 1 else ()
    a = torch.randn(lead + (M, K), generator=gen, device="cuda").to(dtype)
    b = (torch.randn(lead + ((N, K) if b_t else (K, N)), generator=gen,
                     device="cuda") / math.sqrt(K)).to(dtype)
    b = b.transpose(-1, -2) if b_t else b
    pk = -(-K // 64) * 64 if mode == OS else bk    # the block_k planned
    plan = _psum_plan(E, M, K, N, pk, dtype, sms)
    walk = _OS_WALK if mode == OS else mode
    variants = {"plan": (walk, plan),
                "other walk": (WS + IS - walk, plan),
                "split" if plan.nsplit == 1 else "unsplit":
                    (walk, _psum_plan(E, M, K, N, pk, dtype, sms,
                                      split=plan.nsplit == 1))}
    if dtype == torch.bfloat16:
        variants["unswapped" if plan.swap else "swapped"] = (
            walk, _psum_plan(E, M, K, N, pk, dtype, sms,
                             swap=not plan.swap))

    def run(w, p):
        if mode == OS:
            return rsa_gemm_cuda(a, b, block_k=bk, mode=OS, plan=p, walk=w)
        return rsa_gemm_cuda(a, b, block_k=bk, mode=w, plan=p)
    want = run(walk, plan)
    mag = (torch.bmm if E > 1 else torch.matmul)(a.abs().float(),
                                                  b.abs().float())
    bound = K * 2.0 ** -24 * mag.max().item()
    if dtype == torch.bfloat16:       # one bf16 rounding a chunk, twice
        chunks = 1 if mode == OS else -(-K // bk)
        bound += 2 * (chunks + 1) * 2.0 ** -8 * want.abs().max().item()
    library = torch.bmm if E > 1 else torch.matmul
    rec = {"name": name, "E": E, "M": M, "K": K, "N": N, "block_k": pk,
           "dtype": str(dtype).split(".")[-1], "b_transposed": b_t,
           "mode": {OS: "OS", WS: "WS", IS: "IS"}[mode],
           "walk": "WS" if walk == WS else "IS",
           "matmul_ms": timer(lambda: library(a, b)), "variants": {}}
    for vname, (w, p) in variants.items():
        got = run(w, p)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.equal(got, want) if vname == "other walk" else \
            err <= bound
        rec["variants"][vname] = {
            "ms": timer(lambda: run(w, p)), "walk": "WS" if w == WS else
            "IS", "plan": p._asdict(), "max_abs_err": err, "ok": ok}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/bench_gemm.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_gemm: needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    recs, ok = [], True
    for shape in SHAPES:
        rec = run_shape(*shape, sms)
        recs.append(rec)
        ok &= all(v["ok"] for v in rec["variants"].values())
        print(f"{rec['name']:<24} "
              f"{str(rec['E']) + 'x' if rec['E'] > 1 else ''}"
              f"{rec['M']}x{rec['K']}x{rec['N']} "
              f"{rec['dtype']} {rec['mode']} (walk {rec['walk']})  library "
              f"{rec['matmul_ms']:.4f} ms  " + "  ".join(
                  f"{k} {v['ms']:.4f}"
                  f"{'' if v['ok'] else ' (MISMATCH)'}"
                  f" [tile {v['plan']['tile']} swap "
                  f"{int(v['plan']['swap'])} split {v['plan']['nsplit']}]"
                  for k, v in rec["variants"].items()), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "shapes": recs}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
