#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # every phase; needs one CUDA card

Phases (any failure exits non-zero):

1. environment: torch / CUDA / nvcc versions and the card's name and power
   limit (``nvidia-smi``);
2. build: every kernel in ``src/repro_torch/kernels/csrc`` compiled with
   nvcc for sm_90a;
3. kernels against their plain PyTorch versions, on the card, at the
   full-width llama3.2-1b shapes of the main path (RSA GEMM in all three
   residency modes, paged decode and paged prefill attention) plus ragged
   and f32 cases; each maximum error is held to a stated tolerance, and
   the kernel, plain-version and (where one exists) library-call times are
   device times between CUDA events, L2 flushed before every run, with a
   spin kernel holding the card until the host has queued the whole run;
4. the main path: ``serve_continuous`` serving llama3.2-1b at full width
   (16 layers, d=2048, bf16, random weights from a seed) with continuous
   batching, chunked paged prefill and paged decode; every request must
   finish, the KV pool must end leak-free, every kernel must have launched
   and no plain version may have run.  The logits of one chunk-prefill step
   and one decode step are held against the same steps under
   ``execute="torch"`` (the plain versions).

The lines before the last are the JSON kernel table, then the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  The
full report is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12            # H100 SXM HBM3 bandwidth
F32_EPS = 2.0 ** -24
BF16_EPS = 2.0 ** -8
PAGED_TPU = {"decode": "src/repro/kernels/paged_attn.py:104",
             "prefill": "src/repro/kernels/paged_attn.py:278"}
RSA_TPU = "src/repro/kernels/rsa_gemm.py:64"


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


class Timer:
    """Median device time of a callable, with the L2 cache flushed before
    every timed run (the main path meets every weight cold).

    The host stays off the clock: before each run a spin kernel
    (``torch.cuda._sleep``) holds the card while the host queues the start
    event, the callable's launches and the end event, so the events bracket
    device work only.  The spin lasts twice the callable's host time, at
    least 1 ms; a run whose queuing outlasted its spin is thrown away and
    the spin doubled."""

    def __init__(self, torch, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 100)
        a, b = self._events()
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = cycles / a.elapsed_time(b)

    def _events(self):
        return (self.torch.cuda.Event(enable_timing=True),
                self.torch.cuda.Event(enable_timing=True))

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = max(1.0, 2.0 * host_ms)
        times = []
        for _ in range(4 * self.reps):
            self.flush.zero_()
            torch.cuda._sleep(int(spin_ms * self.cycles_per_ms))
            a, b = self._events()
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            b.synchronize()
            if queued_ms >= spin_ms:
                spin_ms *= 2.0
                continue
            times.append(a.elapsed_time(b))
            if len(times) == self.reps:
                return statistics.median(times)
        raise RuntimeError(f"timer: the host never got ahead of the card "
                           f"({len(times)} of {self.reps} runs kept)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_cases(cfg):
    """(site, M, K, N, b_transposed, out_f32) of every main-path GEMM at
    decode (M = slots) and prefill (M = slots * chunk)."""
    d, q, kv, ff, V = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                       cfg.vocab_size)
    out = []
    for phase, M in (("decode", 8), ("prefill", 512)):
        out += [(f"{phase} q/o", M, d, q, False, False),
                (f"{phase} k/v", M, d, kv, False, False),
                (f"{phase} gate/up", M, d, ff, False, False),
                (f"{phase} down", M, ff, d, False, False)]
    out.append(("unembed", 8, d, V, True, True))
    return out


def gemm_tolerance(torch, a, b, plain, mode, bk, out_f32):
    """Kernel vs plain: both sum in f32 in different orders, bounded by
    K * 2^-24 * max(|a| @ |b|); a bf16 output adds one bf16 rounding per
    block_k chunk (one in OS) of max |plain|."""
    K = a.shape[1]
    mag = (a.abs().float() @ b.abs().float()).max().item()
    tol = K * F32_EPS * mag
    if not out_f32:
        chunks = 1 if mode == 0 else -(-K // bk)
        tol += (chunks + 1) * BF16_EPS * plain.abs().max().item()
    return tol


def check_gemms(torch, report, timer, cfg, dispatcher):
    from repro_torch.core.hw import DATAFLOW_NAMES
    from repro_torch.dispatch.executor import _clamped_blocks
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ok = True

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [(site, M, K, N, bt, of, torch.bfloat16, True)
             for site, M, K, N, bt, of in gemm_cases(cfg)]
    # ragged shapes, the transposed form, and f32 operands
    cases += [("ragged f32", 130, 200, 72, False, True, torch.float32, False),
              ("ragged bf16", 37, 1000, 300, False, False, torch.bfloat16,
               False),
              ("ragged bf16 B^T", 37, 1000, 300, True, False, torch.bfloat16,
               False),
              ("f32 q/o", 8, cfg.d_model, cfg.q_dim, False, True,
               torch.float32, False)]
    for site, M, K, N, bt, out_f32, dt, main in cases:
        a = rand((M, K), dt)
        stored = rand((N, K) if bt else (K, N), dt) * (1.0 / math.sqrt(K))
        b = stored.t() if bt else stored     # B^T: a view, as embed.t()
        odt = torch.float32 if out_f32 else dt
        cfg_t = dispatcher.recommend(M, K, N)
        bm, bn, bk = _clamped_blocks(cfg_t, M, K, N)
        if not main:
            bk = 256 if K > 256 else 128
        for mode in (0, 1, 2):
            def kernel():
                return ops.rsa_gemm(a, b, block_m=bm, block_n=bn, block_k=bk,
                                    mode=mode, out_dtype=odt)
            out = kernel()
            plain = rsa_gemm_plain(a, b, block_k=bk, mode=mode,
                                   out_dtype=odt)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            tol = gemm_tolerance(torch, a, b, plain, mode, bk, out_f32)
            good = err <= tol and math.isfinite(err)
            ok &= good
            rec = {"site": site, "M": M, "K": K, "N": N,
                   "dtype": str(dt).split(".")[-1],
                   "out": str(odt).split(".")[-1], "b_transposed": bt,
                   "bk": bk, "mode": DATAFLOW_NAMES[mode],
                   "recommended": main and mode == cfg_t.mode,
                   "max_abs_err": err, "tol": tol, "ok": good}
            if main:
                # every mode at every main-path shape: kernel, plain and
                # bound; the library call once per shape (mode-free)
                rec["ms"] = timer(kernel)
                rec["plain_ms"] = timer(lambda: rsa_gemm_plain(
                    a, b, block_k=bk, mode=mode, out_dtype=odt))
                if mode == 0:
                    library_ms = timer(lambda: torch.matmul(a, b))
                rec["library_ms"] = library_ms
                nbytes = (M * K + K * N) * a.element_size() + \
                    M * N * out.element_size()
                t_bytes = nbytes / PEAK_BYTES * 1e3
                t_ops = 2.0 * M * N * K / PEAK_BF16_FLOPS * 1e3
                rec["bound_ms"] = max(t_bytes, t_ops)
                rec["bound_by"] = "bytes" if t_bytes >= t_ops else \
                    "operations"
                rec["key"] = (M, K, N, mode)
            report["gemm"].append(rec)
            log(f"  rsa_gemm {site:<16} {M}x{K}x{N} {rec['mode']} bk={bk} "
                f"{rec['dtype']}->{rec['out']}{' B^T' if bt else ''}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e}) "
                f"{'ok' if good else 'FAIL'}"
                + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f}"
                   f" ms matmul {rec['library_ms']:.4f} ms bound "
                   f"{rec['bound_ms']:.4f} ms" if main else "")
                + ("  [main path]" if rec["recommended"] else ""))
    return ok


def paged_inputs(torch, gen, S, KVH, G, hd, bs, lengths, dtype):
    """Random arena + per-lane tables over disjoint pages (dead columns
    repeat the last live id; a length-0 lane gets an all-zero row)."""
    W = max(1, max(-(-n // bs) for n in lengths))
    tables = torch.zeros((S, W), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nblk = -(-n // bs)
        if nblk:
            tables[i, :nblk] = torch.arange(nxt, nxt + nblk)
            tables[i, nblk:] = nxt + nblk - 1
            nxt += nblk
    NB = nxt + 1
    ka = torch.randn((NB, bs, KVH, hd), generator=gen, device="cuda")
    va = torch.randn((NB, bs, KVH, hd), generator=gen, device="cuda")
    return (ka.to(dtype), va.to(dtype), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def attn_bound_ms(kv_rows, KVH, hd, io_bytes, flops):
    nbytes = kv_rows * KVH * 2 * hd * 2 + io_bytes
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_paged(torch, report, timer, cfg):
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attn import (
        paged_attention_plain, paged_prefill_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    KVH, H, hd, bs = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    ok = True
    # decode: ragged lengths incl. 0, page boundaries and the main path's
    # longest context (max_len 545); prefill: ragged starts/chunks incl. an
    # empty lane, chunk 64 (the main path's)
    dec_lengths = [0, 1, 15, 16, 17, 200, 400, 545]
    starts = [0, 0, 64, 100, 0, 448, 0, 10]
    chunks = [64, 10, 64, 37, 0, 64, 1, 64]
    for dt, cap, timed in ((torch.bfloat16, 0.0, True),
                           (torch.float32, 0.0, False),
                           (torch.bfloat16, 30.0, False)):
        ka, va, tables, lens = paged_inputs(torch, gen, 8, KVH, G, hd, bs,
                                            dec_lengths, dt)
        q = torch.randn((8, H, hd), generator=gen, device="cuda").to(dt)
        out = ops.paged_attention(q, ka, va, tables, lens, logit_cap=cap)
        plain = paged_attention_plain(q, ka, va, tables, lens, scale=scale,
                                      logit_cap=cap)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        # bf16: the kernel rounds p to bf16 before p @ V (as the TPU kernel
        # does), the plain version keeps f32 p: ~2^-8 relative on values of
        # size ~|v| <= 5; f32: summation order only
        tol = 5 * 2 * BF16_EPS if dt == torch.bfloat16 else 1e-5
        good = err <= tol and math.isfinite(err)
        ok &= good
        rec = {"kernel": "paged_decode", "dtype": str(dt).split(".")[-1],
               "softcap": cap, "lengths": dec_lengths, "max_abs_err": err,
               "tol": tol, "ok": good}
        if timed:
            rec["ms"] = timer(lambda: ops.paged_attention(
                q, ka, va, tables, lens))
            rec["plain_ms"] = timer(lambda: paged_attention_plain(
                q, ka, va, tables, lens, scale=scale))
            rows = sum(-(-n // bs) * bs for n in dec_lengths)
            flops = 2.0 * H * 2 * hd * sum(dec_lengths)
            rec["bound_ms"], rec["bound_by"] = attn_bound_ms(
                rows, KVH, hd, 2 * q.numel() * 2, flops)
            rec["library_ms"] = None
        report["paged"].append(rec)
        log(f"  paged_decode  {rec['dtype']} cap={cap}: max_abs_err "
            f"{err:.3e} (tol {tol:.1e}) {'ok' if good else 'FAIL'}"
            + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
               f" bound {rec['bound_ms']:.4f} ms" if timed else ""))

        lengths = [s + c for s, c in zip(starts, chunks)]
        ka, va, tables, lens = paged_inputs(torch, gen, 8, KVH, G, hd, bs,
                                            lengths, dt)
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        C = 64
        q = torch.randn((8, C, H, hd), generator=gen, device="cuda").to(dt)
        out = ops.paged_prefill_attention(q, ka, va, tables, st, lens,
                                          logit_cap=cap)
        plain = paged_prefill_attention_plain(q, ka, va, tables, st, lens,
                                              scale=scale, logit_cap=cap)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        good = err <= tol and math.isfinite(err)
        ok &= good
        rec = {"kernel": "paged_prefill", "dtype": str(dt).split(".")[-1],
               "softcap": cap, "starts": starts, "chunks": chunks,
               "max_abs_err": err, "tol": tol, "ok": good}
        if timed:
            rec["ms"] = timer(lambda: ops.paged_prefill_attention(
                q, ka, va, tables, st, lens))
            rec["plain_ms"] = timer(lambda: paged_prefill_attention_plain(
                q, ka, va, tables, st, lens, scale=scale))
            rows = sum(-(-n // bs) * bs for n in lengths)
            pairs = sum(min(s + r + 1, s + c) for s, c in zip(starts, chunks)
                        for r in range(c))
            flops = 2.0 * H * 2 * hd * pairs
            rec["bound_ms"], rec["bound_by"] = attn_bound_ms(
                rows, KVH, hd, 2 * q.numel() * 2, flops)
            rec["library_ms"] = None
        report["paged"].append(rec)
        log(f"  paged_prefill {rec['dtype']} cap={cap}: max_abs_err "
            f"{err:.3e} (tol {tol:.1e}) {'ok' if good else 'FAIL'}"
            + (f"  kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms"
               f" bound {rec['bound_ms']:.4f} ms" if timed else ""))
    return ok


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(torch, report):
    from repro_torch import dispatch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda
    from repro_torch.launch.serve import serve_continuous

    ops.reset_counts()
    t0 = time.time()
    outputs, engine = serve_continuous(
        arch="llama3.2-1b", preset="full", num_requests=16, num_slots=8,
        prompt_len=512, min_prompt_len=64, gen=32, temperature=0.0,
        top_k=0, seed=0, execute="auto", prefill_chunk=64, block_size=16,
        clock="wall", device="cuda", log=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = ops.launch_counts()
    gemm_keys = dict(rsa_gemm_cuda.launches_by_key)
    L = engine.cfg.num_layers
    s = engine.summary()
    done = [r for r in engine.requests.values() if r.outcome == "done"]
    engine.pool.check()
    ok = (len(done) == 16 and all(len(v) == 32 for v in outputs.values())
          and engine.pool.num_free == engine.pool.num_blocks
          and counts["rsa_gemm"] > 0 and counts["paged_decode"] > 0
          and counts["paged_prefill"] > 0 and counts["plain_calls"] == 0)
    prefill_steps = counts["paged_prefill"] // L
    decode_steps = counts["paged_decode"] // L
    steps = prefill_steps + decode_steps
    report["main_path"] = {
        "requests": 16, "completed": len(done), "wall_s": wall,
        "counts": counts, "gemm_launches_by_shape": {
            f"{k[0]}x{k[1]}x{k[2]}:{k[3]}": v for k, v in gemm_keys.items()},
        "prefill_steps": prefill_steps, "decode_steps": decode_steps,
        "gemm_launches_per_model_step": counts["rsa_gemm"] / max(steps, 1),
        "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"],
        "decode_tok_s": s["decode_tok_s"], "prefill_tok_s": s["prefill_tok_s"],
        "decode_wall_s": engine.metrics.decode_s,
        "prefill_wall_s": engine.metrics.prefill_s,
        "sara_cache_hit_rate": s["sara_cache_hit_rate"],
        "gemm_plan": engine.gemm_plan, "plan_changes": engine.plan_changes,
        "pool_leak_free": engine.pool.num_free == engine.pool.num_blocks}
    log(f"  served {len(done)}/16 requests in {wall:.2f} s "
        f"({engine.steps} engine steps: {prefill_steps} chunk-prefill, "
        f"{decode_steps} decode model calls)")
    log(f"  launches: {json.dumps(counts)}")
    log(f"  launches per model step: rsa_gemm "
        f"{counts['rsa_gemm'] / max(steps, 1):.1f} (16 layers x 7 + unembed "
        f"= 113), paged_prefill {counts['paged_prefill'] / max(prefill_steps, 1):.1f}"
        f" per chunk-prefill step, paged_decode "
        f"{counts['paged_decode'] / max(decode_steps, 1):.1f} per decode step"
        f" (16 each)")
    log(f"  ttft p50 {s['ttft_p50_s']:.4f} s p99 {s['ttft_p99_s']:.4f} s, "
        f"decode {s['decode_tok_s']:.1f} tok/s, prefill "
        f"{s['prefill_tok_s']:.1f} tok/s, sara_cache_hit_rate "
        f"{s['sara_cache_hit_rate']:.4f}, plan_changes {engine.plan_changes}")
    log("  executed gemm plan:")
    for site, desc in engine.gemm_plan.items():
        log(f"    {site:<16} {desc}")
    if not ok:
        log(f"  MAIN PATH FAIL: completed {len(done)}, free "
            f"{engine.pool.num_free}/{engine.pool.num_blocks}, "
            f"counts {counts}")

    # one chunk-prefill step and one decode step, kernels vs plain versions
    import numpy as np
    model, params, cfg = engine.model, engine.params, engine.cfg
    rng = np.random.default_rng(7)
    S, C, bs = 8, 64, 16
    W = -(-(C + 1) // bs)
    tables = torch.arange(S * W, dtype=torch.int32,
                          device="cuda").reshape(S, W)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (S, C)),
                           device="cuda")
    chunk = torch.as_tensor([64, 64, 40, 17, 64, 1, 33, 64],
                            dtype=torch.int32, device="cuda")
    kv0 = torch.zeros(S, dtype=torch.int32, device="cuda")
    res = {}
    nxt = None
    for mode in ("torch", "kernel"):
        arena = model.init_paged_arena(S * W + 1, bs)
        with torch.no_grad(), dispatch.use(execute=mode):
            pl, _ = model.paged_prefill_step(params, toks, arena, tables, kv0,
                                             chunk)
            if nxt is None:          # both paths decode the same tokens
                nxt = pl.argmax(-1)[:, None]
            dl, _ = model.paged_decode_step(
                params, nxt, arena, tables, chunk,
                torch.ones(S, dtype=torch.int32, device="cuda"))
        res[mode] = (pl, dl)
    torch.cuda.synchronize()
    # bf16 through 16 layers: each path rounds at different points (the
    # attention kernels round p to bf16); hold the difference to 5% of the
    # logits' largest magnitude
    good = True
    for i, name in ((0, "prefill"), (1, "decode")):
        ref = res["torch"][i]
        err = (res["kernel"][i] - ref).abs().max().item()
        tol = 0.05 * ref.abs().max().item()
        agree = (res["kernel"][i].argmax(-1) == ref.argmax(-1)).float().mean()
        g = err <= tol and math.isfinite(err)
        good &= g
        report["main_path"][f"{name}_logits_max_abs_err"] = err
        report["main_path"][f"{name}_logits_tol"] = tol
        report["main_path"][f"{name}_greedy_agreement"] = agree.item()
        log(f"  {name} step logits, kernels vs plain: max_abs_err {err:.4e} "
            f"(tol {tol:.4e}) {'ok' if g else 'FAIL'}; greedy agreement "
            f"{agree.item():.3f}")
    ok &= good
    return ok, gemm_keys, counts


def time_breakdown(report, gemm_keys, counts):
    """Kernel time the main path spent, estimated as each kernel's median
    time at its main-path shape (phase 3, L2 cold) times its launches,
    beside the wall time of the model calls (host work included)."""
    mp = report["main_path"]
    timed = {r["key"]: r["ms"] for r in report["gemm"] if r.get("recommended")}
    attn = {r["kernel"]: r["ms"] for r in report["paged"] if "ms" in r}
    unembed = [k for k in timed if k[2] > 100000]
    est = {"decode": 0.0, "prefill": 0.0}
    for key, n in gemm_keys.items():
        if key in unembed:
            continue
        est["decode" if key[0] == 8 else "prefill"] += timed.get(key, 0.0) * n
    for k in unembed:
        est["decode"] += timed[k] * mp["decode_steps"]
        est["prefill"] += timed[k] * mp["prefill_steps"]
    est["decode"] += attn["paged_decode"] * counts["paged_decode"]
    est["prefill"] += attn["paged_prefill"] * counts["paged_prefill"]
    out = {}
    for phase in ("decode", "prefill"):
        steps = mp[f"{phase}_steps"]
        wall_ms = mp[f"{phase}_wall_s"] * 1e3
        out[phase] = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
                      "kernel_ms_per_step_est": est[phase] / steps,
                      "kernel_share_est": est[phase] / wall_ms}
        log(f"  {phase}: {wall_ms / steps:.2f} ms per step (wall), "
            f"{est[phase] / steps:.2f} ms of it in kernels (estimate, "
            f"{100 * est[phase] / wall_ms:.0f}%)")
    mp["time_breakdown"] = out


def kernel_table(report, gemm_keys, counts):
    """The JSON kernel line: one entry per kernel and main-path shape."""
    out = []
    for rec in report["gemm"]:
        if not rec.get("recommended"):
            continue
        out.append({
            "name": f"rsa_gemm[{rec['site']} {rec['M']}x{rec['K']}x"
                    f"{rec['N']} {rec['mode']}]",
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/"
                                       "rsa_gemm.cu",
            "replaces": RSA_TPU,
            "launches": gemm_keys.get(rec["key"], 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    for rec in report["paged"]:
        if "ms" not in rec:
            continue
        kind = rec["kernel"].split("_")[1]
        out.append({
            "name": rec["kernel"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": PAGED_TPU[kind],
            "launches": counts[rec["kernel"]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        log("chip_smoke: src/repro_torch not found beside this script; run "
            "it from a checkout of the repository")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this smoke "
            "test needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"gemm": [], "paged": []}
    t_start = time.time()

    log("== 1. environment")
    smi = nvidia_smi_line()
    nvcc_path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_v = subprocess.run([nvcc_path, "--version"], capture_output=True,
                            text=True).stdout.strip().splitlines()
    report["env"] = {"python": sys.version.split()[0],
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "nvcc": nvcc_v[-1] if nvcc_v else "not found",
                     "device": torch.cuda.get_device_name(0),
                     "nvidia_smi": smi}
    for k, v in report["env"].items():
        log(f"  {k}: {v}")

    log("== 2. build")
    from repro_torch.kernels import _build
    paths = _build.build_all()
    report["build_s"] = _build.build_seconds
    log(f"  built in {_build.build_seconds:.1f} s: "
        f"{', '.join(p.name for p in paths.values())}")
    for p in paths.values():
        logf = p.with_suffix(".log")
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {p.stem.split('-')[0]}: {line.strip()}")

    log("== 3. kernels against their plain versions (tolerances stated)")
    from repro_torch import dispatch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.sara import SaraDispatcher
    cfg = get_arch("llama3.2-1b")
    timer = Timer(torch)
    with dispatch.use(execute="kernel"):
        ok = check_gemms(torch, report, timer, cfg, SaraDispatcher())
        ok &= check_paged(torch, report, timer, cfg)
    log(f"  kernels {'ok' if ok else 'FAIL'} "
        f"({time.time() - t_start:.1f} s so far)")

    log("== 4. main path: llama3.2-1b full width, continuous batching")
    mp_ok, gemm_keys, counts = main_path(torch, report)
    ok &= mp_ok
    time_breakdown(report, gemm_keys, counts)

    report["ok"] = bool(ok)
    report["seconds"] = time.time() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    if not ok:
        log(f"chip_smoke: FAILED after {report['seconds']:.1f} s")
        return 1
    log(f"== done in {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernel_table(report, gemm_keys, counts)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
