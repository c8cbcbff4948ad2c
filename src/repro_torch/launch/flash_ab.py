"""Hold two builds of the flash kernels against each other on one card:
their bits on the card tests' cases, and their times at the benchmark's
shapes.

    PYTHONPATH=src python src/repro_torch/launch/flash_ab.py [--dtype f32|bf16] [--time] [--out FILE]
    python src/repro_torch/launch/flash_ab.py --compare A B

Run as a file with ``PYTHONPATH`` at another tree's ``src/`` (the parent
commit unpacked beside this checkout, say), it drives that tree's
kernels through the wrappers every tree has (``flash_fwd_cuda``,
``flash_dq_cuda``, ``flash_dkv_cuda`` under their default plans) on the
same cases, so two runs on one card compare like with like.

Without ``--time``: every case of ``FLASH_CASES`` and
``WIDE_FLASH_CASES`` (``tests/test_torch_kernels_cuda.py`` beside this
file's checkout) runs the forward, dq and dk/dv on seeded inputs, one
line a case with the SHA-256 of the bytes of each of o, lse, dq, dk and
dv: two trees whose lines agree give the same bits.  The backward's lse
and delta come from an f64 softmax in torch, not from the kernel
forward, so a tree whose forward changes bits feeds its dq and dk/dv the
same inputs as the other tree.  With ``--time``: the three kernels at llama3.2-1b's
attention (B = 2, S = 1024, 32 / 8 heads x 64, causal), gemma-2b's (8 / 1
x 256), seamless-m4t-medium's encoder (B = 1, S = 128, 16 x 64,
bidirectional) and the expanded MLA's (B = 1, S = 1024, 128 / 128 heads,
hd 192 / hd_v 128, causal), the median device ms of 15 runs
(``bench_gemm.timer``: L2 flushed before each), one line a shape.  Needs
a CUDA card, but for ``--compare A B``, which reads two digest files and
prints, for each output, the cases whose bits agree and those that
differ.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
OUTPUTS = ("o", "lse", "dq", "dk", "dv")
# name, B, S, H, KVH, hd, hd_v, causal
SHAPES = [("llama", 2, 1024, 32, 8, 64, 64, True),
          ("gemma-2b", 2, 1024, 8, 1, 256, 256, True),
          ("seamless encoder", 1, 128, 16, 16, 64, 64, False),
          ("MLA expanded", 1, 1024, 128, 128, 192, 128, True)]


def cases():
    spec = importlib.util.spec_from_file_location(
        "card_tests", ROOT / "tests" / "test_torch_kernels_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_CASES + mod.WIDE_FLASH_CASES


def stats(q, k, v, do, causal, scale):
    """(lse, delta), both (B, H, Sq) f32, from an f64 softmax over the
    masked scores: the backward's inputs, the same bits in either tree."""
    G = q.shape[2] // k.shape[2]
    kk, vv = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) * scale
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        keep = torch.arange(Skv, device=q.device)[None, :] <= \
            torch.arange(Sq, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkhd->bhqd", torch.exp(s - lse[..., None]), vv)
    delta = (do.double().transpose(1, 2) * o).sum(-1)
    return lse.float().contiguous(), delta.float().contiguous()


def run(B, Sq, Skv, H, KVH, hd, hd_v, causal, dtype, seed):
    """The three kernels on seeded inputs: (inputs, outputs, thunks)."""
    from repro_torch.kernels.flash_attn import (flash_dkv_cuda, flash_dq_cuda,
                                                flash_fwd_cuda)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, Sq, H, hd), (B, Skv, KVH, hd),
                                 (B, Skv, KVH, hd_v), (B, Sq, H, hd_v)))
    kw = dict(causal=causal, scale=hd ** -0.5)
    o, lse_k = flash_fwd_cuda(q, k, v, **kw)
    st = (q, k, v, do, *stats(q, k, v, do, **kw))
    dq = flash_dq_cuda(*st, **kw)
    dk, dv = flash_dkv_cuda(*st, **kw)
    thunks = {"fwd": lambda: flash_fwd_cuda(q, k, v, **kw),
              "dq": lambda: flash_dq_cuda(*st, **kw),
              "dkv": lambda: flash_dkv_cuda(*st, **kw)}
    return (o, lse_k, dq, dk, dv), thunks


def digest(case, dtype) -> dict:
    """{output: SHA-256 of its bytes} of one case."""
    outs, _ = run(*case[:8], dtype, sum(case[:7]))
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                                 .numpy().tobytes()).hexdigest()
            for name, t in zip(OUTPUTS, outs)}


def compare(a: str, b: str) -> list:
    """For each output, the cases of two digest files that agree and the
    cases that differ, one line an output."""
    ra, rb = ([json.loads(x) for x in Path(f).read_text().splitlines()]
              for f in (a, b))
    lines = []
    for name in OUTPUTS:
        same = [x["case"] for x, y in zip(ra, rb)
                if x["case"] == y["case"] and x[name] == y[name]]
        diff = [x["case"] for x in ra if x["case"] not in same]
        lines.append(f"{name}: bitwise at {len(same)} of {len(ra)} cases"
                     + (f"; differ at {diff}" if diff else ""))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--time", action="store_true",
                    help="time the kernels at SHAPES instead")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two digest files instead")
    args = ap.parse_args(argv)
    if args.compare:
        print("\n".join(compare(*args.compare)))
        return 0
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card")
        return 2
    dtype = DTYPES[args.dtype]
    lines = []
    if args.time:
        from repro_torch.launch.bench_gemm import timer
        for name, B, S, H, KVH, hd, hd_v, causal in SHAPES:
            _, thunks = run(B, S, S, H, KVH, hd, hd_v, causal, dtype, S)
            lines.append(json.dumps({"shape": name, "dtype": args.dtype, **{
                f"{k}_ms": timer(f) for k, f in thunks.items()}}))
            print(lines[-1], flush=True)
    else:
        for c in cases():
            lines.append(json.dumps({"case": list(c[:8]),
                                     **digest(c, dtype)}))
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
