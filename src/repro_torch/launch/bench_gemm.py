"""Time the RSA GEMM's WS/IS kernel against the plans it rejected, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_gemm [--out FILE]

For each shape the kernel runs under ``_psum_plan``'s plan in the shape's
own mode, in the other mode (WS and IS differ only in the order CTAs walk
the tiles), and under the alternatives the plan's two rules turned down:
the operands swapped or not (bf16), K split or not.  Each time is the
median device time of 15 runs between CUDA events, L2 flushed before each
run, beside ``torch.matmul`` on the same inputs.  Every alternative is
checked against the plan's output (bitwise for the other mode, within
the f32 summation bound otherwise).  One line per shape; the records go
to ``--out`` as JSON.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.core.hw import IS, WS
from repro_torch.kernels.rsa_gemm import _psum_plan, rsa_gemm_cuda

# name, M, K, N, block_k, dtype, mode: the main paths' shapes each rule
# decides (phases 4, 6, 7 and 8 of chip_smoke.py)
SHAPES = [
    ("llama decode q/o", 8, 2048, 2048, 2048, torch.bfloat16, IS),
    ("llama decode down", 8, 8192, 2048, 2048, torch.bfloat16, IS),
    ("deepseek decode kv_a", 8, 7168, 576, 2048, torch.bfloat16, IS),
    ("rwkv prefill r", 73, 2048, 2048, 2048, torch.bfloat16, IS),
    ("rwkv prefill decay_b", 73, 64, 2048, 128, torch.bfloat16, IS),
    ("rwkv prefill channel_v", 296, 7168, 2048, 2048, torch.bfloat16, WS),
    ("llama prefill down", 512, 8192, 2048, 2048, torch.bfloat16, IS),
    ("llama prefill gate/up", 512, 2048, 8192, 2048, torch.bfloat16, WS),
    ("train k/v fwd", 2048, 2048, 512, 2048, torch.float32, WS),
    ("train gate/up fwd", 2048, 2048, 8192, 2048, torch.float32, WS),
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


def run_shape(name, M, K, N, bk, dtype, mode, sms):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((K, N), generator=gen, device="cuda") /
         math.sqrt(K)).to(dtype)
    plan = _psum_plan(1, M, K, N, bk, dtype, sms)
    variants = {"plan": (mode, plan),
                "other mode": (WS + IS - mode, plan),
                "split" if plan.nsplit == 1 else "unsplit":
                    (mode, _psum_plan(1, M, K, N, bk, dtype, sms,
                                      split=plan.nsplit == 1))}
    if dtype == torch.bfloat16:
        variants["unswapped" if plan.swap else "swapped"] = (
            mode, _psum_plan(1, M, K, N, bk, dtype, sms,
                             swap=not plan.swap))
    want = rsa_gemm_cuda(a, b, block_k=bk, mode=mode, plan=plan)
    bound = K * 2.0 ** -24 * (a.abs().float() @ b.abs().float()).max() \
        .item()
    if dtype == torch.bfloat16:       # one bf16 rounding a chunk, twice
        bound += 2 * (-(-K // bk) + 1) * 2.0 ** -8 * \
            want.abs().max().item()
    rec = {"name": name, "M": M, "K": K, "N": N, "block_k": bk,
           "dtype": str(dtype).split(".")[-1],
           "mode": "WS" if mode == WS else "IS",
           "matmul_ms": timer(lambda: torch.matmul(a, b)), "variants": {}}
    for vname, (m, p) in variants.items():
        got = rsa_gemm_cuda(a, b, block_k=bk, mode=m, plan=p)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.equal(got, want) if vname == "other mode" else \
            err <= bound
        rec["variants"][vname] = {
            "ms": timer(lambda: rsa_gemm_cuda(a, b, block_k=bk, mode=m,
                                              plan=p)),
            "plan": p._asdict(), "max_abs_err": err, "ok": ok}
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
        print(f"{rec['name']:<24} {rec['M']}x{rec['K']}x{rec['N']} "
              f"{rec['dtype']} {rec['mode']}  matmul "
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
