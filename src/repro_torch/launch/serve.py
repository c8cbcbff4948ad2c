"""Serving launcher — thin CLI over the continuous-batching ServingEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --preset full \\
      --requests 16 --slots 8 --prompt-len 512 --gen 32 --prefill-chunk 64

Runs on CUDA unless ``--device cpu`` is given (the CPU runs the kernels'
plain PyTorch versions); with no CUDA and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np


def serve_continuous(arch: str = "llama3.2-1b", preset: str = "reduced",
                     num_requests: int = 8, num_slots: int = 4,
                     prompt_len: int = 32, gen: int = 32,
                     temperature: float = 0.8, top_k: int = 40,
                     seed: int = 0, execute: str = "auto",
                     kv_layout: str = "paged", prefill_chunk: int = 64,
                     block_size: int = 16,
                     min_prompt_len: Optional[int] = None,
                     clock: str = "steps", device: Optional[str] = None,
                     override_cfg=None, log: bool = True):
    """Serve a request set through the continuous-batching engine (paged KV,
    chunked prefill).  Prompts are random tokens from ``seed``: every one
    ``prompt_len`` long, or uniform in ``[min_prompt_len, prompt_len]``
    when ``min_prompt_len`` is given, all arriving at time 0.  ``execute``
    selects how the kernels run ("auto": CUDA kernels for CUDA tensors,
    plain PyTorch on the CPU; "kernel"; "torch"); ``clock`` is the
    engine's ("steps" or "wall").  Returns ({rid: tokens}, engine)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    cfg = override_cfg if override_cfg is not None else get_arch(arch)
    if preset == "reduced":
        cfg = cfg.reduced()
    elif preset != "full":
        raise ValueError(f"preset must be 'reduced' or 'full', got {preset!r}")
    rng = np.random.default_rng(seed)
    engine = ServingEngine(cfg, EngineConfig(
        num_slots=num_slots, max_len=prompt_len + gen + 1,
        block_size=block_size, temperature=temperature, top_k=top_k,
        seed=seed, clock=clock, execute=execute, kv_layout=kv_layout,
        prefill_chunk=prefill_chunk), device=device)
    lo = prompt_len if min_prompt_len is None else min_prompt_len
    reqs = []
    for i in range(num_requests):
        n = int(rng.integers(lo, prompt_len + 1))
        p = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        reqs.append(Request(rid=f"req-{i}", prompt=p, max_new_tokens=gen))
    t0 = time.time()
    outputs = engine.run(reqs)
    if log:
        total = sum(len(v) for v in outputs.values())
        print(f"served {len(reqs)} requests / {total} tokens in "
              f"{time.time() - t0:.2f}s on {num_slots} slots "
              f"(device={engine.device}, kv_layout={engine.kv_layout})")
        print(engine.metrics.report(engine.dispatcher.cache_info(),
                                    engine.dispatch_stats()))
        print("  executed gemm plan (last step):")
        for site, desc in engine.gemm_plan.items():
            print(f"    {site:<24} {desc}")
    return outputs, engine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--min-prompt-len", type=int, default=None)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--execute", default="auto",
                    choices=["auto", "kernel", "torch"],
                    help="kernels (CUDA) or their plain PyTorch versions")
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--clock", default="wall", choices=["wall", "steps"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="fast smoke: tiny greedy trace, assert completion")
    a = ap.parse_args()
    if a.smoke:
        outputs, engine = serve_continuous(
            arch=a.arch, num_requests=3, num_slots=2, prompt_len=12, gen=6,
            temperature=0.0, execute=a.execute, prefill_chunk=8,
            device=a.device)
        if not all(len(v) == 6 for v in outputs.values()):
            raise SystemExit(f"smoke failed: {outputs}")
        engine.pool.check()
        if engine.pool.num_free != engine.pool.num_blocks:
            raise SystemExit("smoke failed: KV pages leaked")
        if "unembed" not in engine.gemm_plan:
            raise SystemExit(f"smoke failed: no unembed site in "
                             f"{engine.gemm_plan}")
        print("serving smoke OK")
        return
    serve_continuous(arch=a.arch, preset=a.preset, num_requests=a.requests,
                     num_slots=a.slots, prompt_len=a.prompt_len, gen=a.gen,
                     temperature=a.temperature, top_k=a.top_k,
                     execute=a.execute, prefill_chunk=a.prefill_chunk,
                     min_prompt_len=a.min_prompt_len, clock=a.clock,
                     device=a.device)


if __name__ == "__main__":
    main()
