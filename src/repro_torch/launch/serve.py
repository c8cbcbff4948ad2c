"""Serving launcher — thin CLI over the continuous-batching ServingEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --prefix-cache \
      --shared-prefix-decode
  PYTHONPATH=src python -m repro_torch.launch.serve --preset full \\
      --requests 16 --slots 8 --prompt-len 512 --gen 32 --prefill-chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --preset reduced --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --dispatcher adaptnet --adaptnet-ckpt build/adaptnet
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --spec-draft self

The layout follows the model's family: the attention families are served
from the paged KV arena with chunked prefill (64 tokens unless
``--prefill-chunk`` says otherwise), the recurrent ones (rwkv6-1.6b) from
the dense per-slot state with whole-prompt prefill.  ``--dispatcher
adaptnet --adaptnet-ckpt DIR`` tiles every GEMM site with a trained
ADAPTNET-TPU (``launch/train_adaptnet.py``) instead of the oracle.
``--spec-draft self|<arch> --spec-k K`` decodes speculatively (greedy
only): K draft tokens a lane and step, verified by one K+1-row target
pass; the tokens equal plain greedy decode's.  The
WKV kernel route of rwkv6-1.6b is the reference's optimized profile:
``serve_continuous(override_cfg=get_arch("rwkv6-1.6b", optimized=True))``.

Runs on CUDA unless ``--device cpu`` is given (the CPU runs the kernels'
plain PyTorch versions); with no CUDA and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np


def serve_continuous(arch: str = "llama3.2-1b", preset: str = "reduced",
                     num_requests: int = 8, num_slots: int = 4,
                     prompt_len: int = 32, gen: int = 32,
                     temperature: float = 0.8, top_k: int = 40,
                     seed: int = 0, execute: str = "auto",
                     kv_layout: str = "auto",
                     prefill_chunk: Union[int, str, None] = "auto",
                     block_size: int = 16,
                     min_prompt_len: Optional[int] = None,
                     prefix_cache: bool = False,
                     shared_prefix_decode: bool = False,
                     shared_prefix_len: int = 0,
                     clock: str = "steps", device: Optional[str] = None,
                     dispatcher: str = "oracle",
                     adaptnet_ckpt: Optional[str] = None,
                     defrag_threshold: Optional[float] = None,
                     spec_draft: Optional[str] = None, spec_k: int = 4,
                     override_cfg=None, log: bool = True):
    """Serve a request set through the continuous-batching engine.  With
    ``kv_layout`` and ``prefill_chunk`` "auto" the attention families run
    paged with chunked prefill (64 tokens, or ``prefill_chunk``) and the
    recurrent families dense with whole-prompt prefill.
    Prompts are random tokens from ``seed``: every one
    ``prompt_len`` long, or uniform in ``[min_prompt_len, prompt_len]``
    when ``min_prompt_len`` is given, all arriving at time 0.
    ``shared_prefix_len`` > 0 makes every prompt open with the same token
    run (a system prompt) so that ``prefix_cache`` has something to hit;
    ``shared_prefix_decode`` adds cascade decode over the shared pages.
    ``execute`` selects how the kernels run ("auto": CUDA kernels for CUDA
    tensors, plain PyTorch on the CPU; "kernel"; "torch"); ``clock`` is the
    engine's ("steps" or "wall").  ``dispatcher`` is the recommendation
    source: "oracle", or "adaptnet" with the net saved in
    ``adaptnet_ckpt``; ``defrag_threshold`` turns on the engine's
    auto-defrag.  ``spec_draft`` ("self" or a registry arch) turns on
    speculative decoding with ``spec_k`` draft tokens a lane and step.
    Returns ({rid: tokens}, engine)."""
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
        prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
        shared_prefix_decode=shared_prefix_decode, dispatcher_mode=dispatcher,
        adaptnet_dir=adaptnet_ckpt, defrag_threshold=defrag_threshold,
        spec_draft=spec_draft, spec_k=spec_k), device=device)
    shared = (rng.integers(0, cfg.vocab_size,
                           min(shared_prefix_len, prompt_len)).astype(np.int32)
              if shared_prefix_len > 0 else None)
    lo = prompt_len if min_prompt_len is None else min_prompt_len
    reqs = []
    for i in range(num_requests):
        n = int(rng.integers(lo, prompt_len + 1))
        p = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        if shared is not None:
            k = min(len(shared), n)
            p[:k] = shared[:k]
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
    ap.add_argument("--prefill-chunk", default="auto",
                    type=lambda v: v if v == "auto" else int(v),
                    help="chunked-prefill tokens per lane and step (paged "
                         "families; 'auto': 64); recurrent families "
                         "prefill whole prompts")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix cache: refcounted "
                         "copy-on-write KV pages shared across prompts "
                         "with a common token prefix")
    ap.add_argument("--shared-prefix-decode", action="store_true",
                    help="with --prefix-cache: cascade decode attention, "
                         "one pass over the common physical prefix pages "
                         "plus per-lane unique suffixes, merged by softmax "
                         "state")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help=">0: every prompt opens with the same token run "
                         "of this length (a system prompt)")
    ap.add_argument("--dispatcher", default="oracle",
                    choices=["oracle", "adaptnet"],
                    help="GEMM tile recommendation source")
    ap.add_argument("--adaptnet-ckpt", default=None,
                    help="trained ADAPTNET-TPU dir (launch.train_adaptnet)")
    ap.add_argument("--defrag-threshold", type=float, default=None,
                    help="auto-defragment the KV pool from the engine "
                         "whenever fragmentation exceeds this fraction")
    ap.add_argument("--spec-draft", default=None, metavar="DRAFT",
                    help="speculative decoding: 'self' or a registry arch "
                         "for the draft model (greedy only: --temperature "
                         "0; the tokens equal plain greedy decode's)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per lane and step (verified "
                         "by one K+1-row target pass)")
    ap.add_argument("--clock", default="wall", choices=["wall", "steps"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="fast smoke: tiny greedy trace, assert completion")
    a = ap.parse_args()
    picks = dict(dispatcher=a.dispatcher, adaptnet_ckpt=a.adaptnet_ckpt,
                 defrag_threshold=a.defrag_threshold)
    if a.smoke and a.prefix_cache:
        # a shared-prefix workload served twice, cache off then cache on
        # (plus cascade decode when asked): the greedy tokens must agree
        # while the cached run reuses pages
        common = dict(arch=a.arch, num_requests=4, num_slots=2,
                      prompt_len=24, gen=6, temperature=0.0,
                      execute=a.execute, prefill_chunk=8,
                      shared_prefix_len=16, device=a.device, log=False,
                      **picks)
        base, _ = serve_continuous(**common)
        outputs, engine = serve_continuous(
            **common, prefix_cache=True,
            shared_prefix_decode=a.shared_prefix_decode)
        if not all(len(v) == 6 for v in outputs.values()) or \
                set(outputs) != set(base):
            raise SystemExit(f"smoke failed: {outputs}")
        for rid in base:
            if not np.array_equal(outputs[rid], base[rid]):
                raise SystemExit(f"smoke failed: {rid} cache-on "
                                 f"{outputs[rid]} != cache-off {base[rid]}")
        stats = engine.prefix_cache.stats()
        if stats["prefix_cache_hits"] <= 0 or \
                stats["prefix_cache_reused_pages"] <= 0 or \
                engine.metrics.cache_hit_tokens <= 0:
            raise SystemExit(f"smoke failed: no cache hit {stats}")
        if a.shared_prefix_decode and engine.shared_prefix_steps <= 0:
            raise SystemExit("smoke failed: no cascade decode step")
        engine.prefix_cache.clear()
        engine.pool.check()
        if engine.pool.num_free != engine.pool.num_blocks:
            raise SystemExit("smoke failed: KV pages leaked")
        print(f"prefix-cache smoke OK (hit_rate="
              f"{stats['prefix_cache_hit_rate']:.2f}, reused_pages="
              f"{stats['prefix_cache_reused_pages']}, cascade steps "
              f"{engine.shared_prefix_steps}, greedy parity)")
        return
    if a.smoke and a.spec_draft:
        # the same greedy trace served plain, then speculatively: equal
        # tokens (every committed token is a verify argmax), accepted
        # drafts, more than one committed token a verify step for "self",
        # and both page pools whole
        common = dict(
            arch=a.arch, preset=a.preset, num_requests=4, num_slots=2,
            prompt_len=12, gen=6, temperature=0.0, execute=a.execute,
            kv_layout="paged",
            prefill_chunk=8 if a.prefill_chunk == "auto" else a.prefill_chunk,
            device=a.device, log=False, **picks)
        base, _ = serve_continuous(**common)
        outputs, engine = serve_continuous(
            **common, spec_draft=a.spec_draft, spec_k=a.spec_k)
        if not all(len(v) == 6 for v in outputs.values()) or \
                set(outputs) != set(base):
            raise SystemExit(f"smoke failed: {outputs}")
        for rid in base:
            if not np.array_equal(outputs[rid], base[rid]):
                raise SystemExit(f"smoke failed: {rid} spec {outputs[rid]} "
                                 f"!= plain {base[rid]}")
        s = engine.summary()
        if s["spec_steps"] <= 0 or s["spec_accepted_tokens"] < 1:
            raise SystemExit(f"smoke failed: no accepted draft {s}")
        if a.spec_draft == "self" and s["spec_accepted_per_step"] <= 1.0:
            raise SystemExit(f"smoke failed: self-draft committed "
                             f"{s['spec_accepted_per_step']} a step")
        engine.spec.check()
        engine.pool.check()
        if engine.spec.live_pages() != 0 or \
                engine.pool.num_free != engine.pool.num_blocks:
            raise SystemExit("smoke failed: KV pages leaked")
        print(f"spec-decode smoke OK (draft={a.spec_draft}, k={a.spec_k}: "
              f"greedy parity, {int(s['spec_accepted_tokens'])} accepted "
              f"draft tokens, {s['spec_accepted_per_step']:.2f} "
              f"committed/step over {int(s['spec_steps'])} verify steps)")
        return
    if a.smoke:
        outputs, engine = serve_continuous(
            arch=a.arch, preset=a.preset, num_requests=3, num_slots=2,
            prompt_len=12, gen=6, temperature=0.0, execute=a.execute,
            prefill_chunk=a.prefill_chunk, device=a.device, **picks)
        if not all(len(v) == 6 for v in outputs.values()):
            raise SystemExit(f"smoke failed: {outputs}")
        engine.pool.check()
        if engine.pool.num_free != engine.pool.num_blocks:
            raise SystemExit("smoke failed: KV pages leaked")
        if "unembed" not in engine.gemm_plan:
            raise SystemExit(f"smoke failed: no unembed site in "
                             f"{engine.gemm_plan}")
        if a.dispatcher == "adaptnet":
            # the learned model, not the oracle, must have driven dispatch
            src = engine.dispatcher.source_info()
            if engine.dispatcher.mode != "adaptnet" or not (
                    src["adaptnet"] > 0 or src["oracle_fallback"] > 0):
                raise SystemExit(f"smoke failed: adaptnet did not dispatch "
                                 f"({engine.dispatcher.mode}, {src})")
            print(f"serving smoke OK (adaptnet: {src})")
            return
        print("serving smoke OK")
        return
    serve_continuous(arch=a.arch, preset=a.preset, num_requests=a.requests,
                     num_slots=a.slots, prompt_len=a.prompt_len, gen=a.gen,
                     temperature=a.temperature, top_k=a.top_k,
                     execute=a.execute, prefill_chunk=a.prefill_chunk,
                     min_prompt_len=a.min_prompt_len,
                     prefix_cache=a.prefix_cache,
                     shared_prefix_decode=a.shared_prefix_decode,
                     shared_prefix_len=a.shared_prefix_len, clock=a.clock,
                     spec_draft=a.spec_draft, spec_k=a.spec_k,
                     device=a.device, **picks)


if __name__ == "__main__":
    main()
