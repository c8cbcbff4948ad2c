"""Serving launcher — thin CLI over the continuous-batching ServingEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --prefix-cache \
      --shared-prefix-decode
  PYTHONPATH=src python -m repro_torch.launch.serve --preset full \\
      --requests 16 --slots 8 --prompt-len 512 --gen 32 --prefill-chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --preset reduced --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --preset reduced --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --dispatcher adaptnet --adaptnet-ckpt build/adaptnet
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --spec-draft self
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --trace-out build/trace.json
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --sanitize
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --chaos 0
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --kv-layout dense --prefill-chunk none
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --arch seamless-m4t-medium
  PYTHONPATH=src python -m repro_torch.launch.serve --waves 2 --slots 2 \\
      --prompt-len 8 --gen 4 --device cpu

The layout follows the model's family unless ``--kv-layout`` says
otherwise: the attention families are served from the paged KV arena
with chunked prefill (64 tokens unless ``--prefill-chunk`` says
otherwise; ``--prefill-chunk none`` is the bucketed prefill, which vlm
and encdec always use), the recurrent ones (rwkv6-1.6b, and the hybrid
zamba2-7b with its shared attention block's K/V rows per slot) from the
dense per-slot state with whole-prompt prefill; ``--kv-layout dense`` serves
an attention family from stacked per-slot KV caches with bucketed
prefill.  An encdec model (seamless-m4t-medium) encodes ``--prompt-len``
random source frames a request (``src_len``); a vlm model
(internvl2-76b) prepends zero patch embeddings unless the request brings
its own, as in the reference.  ``--dispatcher
adaptnet --adaptnet-ckpt DIR`` tiles every GEMM site with a trained
ADAPTNET-TPU (``launch/train_adaptnet.py``) instead of the oracle.
``--spec-draft self|<arch> --spec-k K`` decodes speculatively (greedy
only): K draft tokens a lane and step, verified by one K+1-row target
pass; the tokens equal plain greedy decode's.  ``--trace-out PATH`` records
every span and writes a Chrome/Perfetto trace-event JSON (open it at
https://ui.perfetto.dev) and a ``.jsonl`` twin; ``--sanitize`` runs the
KV-arena sanitizer; ``--chaos SEED`` injects seeded faults that the
engine's step error boundary contains; ``--deadline`` gives each request
a deadline; ``--snapshot-dir DIR --snapshot-every N`` writes an engine
snapshot every N steps.  The
WKV kernel route of rwkv6-1.6b is the reference's optimized profile:
``serve_continuous(override_cfg=get_arch("rwkv6-1.6b", optimized=True))``.

``serve_waves`` (``--waves N``) is the wave-based baseline, the port of
the reference's: a whole batch prefills together on a fresh dense cache
and decodes until every member has its tokens; it is the baseline the
reference's serving benchmark compares continuous batching to.

Runs on CUDA unless ``--device cpu`` is given (the CPU runs the kernels'
plain PyTorch versions); with no CUDA and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np


def serve_waves(arch: str = "llama3.2-1b", preset: str = "reduced",
                batch: int = 4, prompt_len: int = 32, gen: int = 32,
                waves: int = 2, temperature: float = 0.8, top_k: int = 40,
                seed: int = 0, override_cfg=None, log: bool = True,
                device: Optional[str] = None, execute: str = "auto",
                params=None):
    """Wave-based batched serving (the compatibility / baseline path; the
    reference's ``serve_waves``): ``waves`` waves of ``batch`` random
    prompts of ``prompt_len`` tokens from ``seed``, one ``prefill`` a wave
    on a fresh ``init_cache``, then ``gen - 1`` ``decode_step`` calls.  A vlm
    model gets zero patch embeddings, an encdec model ``prompt_len``
    random source frames a prompt.  Tokens are sampled by
    ``sample_logits`` from a generator seeded with ``seed + 1``
    (temperature <= 0 is greedy).  ``params`` replaces the weights drawn
    from ``seed``; ``execute`` is the dispatch mode.  Returns (one (batch,
    gen) int64 array a wave, stats): the stats' keys are the reference's,
    prefill and decode tokens and seconds (host clock to a device
    synchronisation)."""
    import torch

    from repro_torch import dispatch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.api import build_model
    from repro_torch.models.modules import dtype_of
    from repro_torch.serving.engine import sample_logits

    cfg = override_cfg if override_cfg is not None else get_arch(arch)
    if preset == "reduced":
        cfg = cfg.reduced()
    elif preset != "full":
        raise ValueError(f"preset must be 'reduced' or 'full', got {preset!r}")
    model = build_model(cfg, device)
    dev = model.device
    if params is None:
        params = model.init(seed)
    max_len = prompt_len + gen + 1
    cdt = dtype_of(cfg.compute_dtype)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(seed)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(seed + 1)
    stats = {"prefill_tokens": 0, "prefill_s": 0.0,
             "decode_tokens": 0, "decode_s": 0.0}
    outputs = []
    with torch.no_grad(), dispatch.use(execute=execute):
        for w in range(waves):
            prompts = rng.integers(0, cfg.vocab_size,
                                   (batch, prompt_len)).astype(np.int32)
            batch_in = {"tokens": torch.from_numpy(prompts).to(dev)}
            n_img = 0
            if cfg.family == "vlm":
                n_img = cfg.frontend.num_tokens
                batch_in["patch_embeds"] = torch.zeros(
                    (batch, n_img, cfg.frontend.feature_dim), dtype=cdt,
                    device=dev)
            src_len = 0
            if cfg.family == "encdec":
                src_len = prompt_len
                batch_in["src_features"] = torch.from_numpy(
                    rng.standard_normal((batch, src_len,
                                         cfg.frontend.feature_dim))).to(
                    device=dev, dtype=cdt)
            cache = model.init_cache(batch, max_len + n_img, src_len=src_len)
            sync()
            t0 = time.time()
            logits, cache = model.prefill(params, batch_in, cache)
            sync()
            stats["prefill_s"] += time.time() - t0
            stats["prefill_tokens"] += batch * prompt_len

            tok = sample_logits(sampler, logits, temperature, top_k)[:, None]
            generated = [tok.cpu().numpy()]
            t0 = time.time()
            for _ in range(gen - 1):
                logits, cache = model.decode_step(params, tok, cache)
                tok = sample_logits(sampler, logits, temperature,
                                    top_k)[:, None]
                generated.append(tok.cpu().numpy())
            sync()
            stats["decode_s"] += time.time() - t0
            stats["decode_tokens"] += batch * (gen - 1)
            outputs.append(np.concatenate(generated, axis=1))
            if log:
                print(f"  wave {w}: generated {outputs[-1].shape} tokens")

    if log:
        print(f"serve: prefill {stats['prefill_tokens']/max(stats['prefill_s'],1e-9):,.0f} tok/s, "
              f"decode {stats['decode_tokens']/max(stats['decode_s'],1e-9):,.0f} tok/s")
    return outputs, stats


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
                     trace_out: Optional[str] = None, sanitize: bool = False,
                     chaos=None, deadline_s: Optional[float] = None,
                     snapshot_dir: Optional[str] = None,
                     snapshot_every: int = 0,
                     stop_after: Optional[int] = None,
                     override_cfg=None, log: bool = True):
    """Serve a request set through the continuous-batching engine.  With
    ``kv_layout`` and ``prefill_chunk`` "auto" the dense and moe families
    run paged with chunked prefill (64 tokens, or ``prefill_chunk``), vlm
    and encdec paged with bucketed prefill, and the recurrent families
    dense with whole-prompt prefill; ``kv_layout="dense"`` and
    ``prefill_chunk=None`` select the other layouts.  An encdec model gets
    ``src_len = prompt_len`` random source frames a request.
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
    ``trace_out`` records every span (``EngineConfig.trace``) and writes a
    Chrome/Perfetto trace-event JSON there after the run, plus a ``.jsonl``
    event stream.  ``sanitize`` runs the KV-arena sanitizer; ``chaos`` (a
    :class:`repro_torch.serving.faults.ChaosConfig`) injects seeded faults
    that the step error boundary contains; ``deadline_s`` is each
    request's deadline (engine steps under the step clock);
    ``snapshot_dir`` / ``snapshot_every`` write engine snapshots;
    ``stop_after`` submits the requests and takes only that many engine
    steps (a simulated crash: the tokens are those generated so far, and a
    fresh engine resumes from the last snapshot with ``restore()``).
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
        src_len=prompt_len if cfg.family == "encdec" else 0,
        prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
        shared_prefix_decode=shared_prefix_decode, dispatcher_mode=dispatcher,
        adaptnet_dir=adaptnet_ckpt, defrag_threshold=defrag_threshold,
        spec_draft=spec_draft, spec_k=spec_k, trace=trace_out is not None,
        sanitize=sanitize, chaos=chaos, snapshot_dir=snapshot_dir,
        snapshot_every=snapshot_every), device=device)
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
        extras = None
        if cfg.family == "encdec":
            extras = {"src_features": rng.standard_normal(
                (1, prompt_len, cfg.frontend.feature_dim)).astype(np.float32)}
        reqs.append(Request(rid=f"req-{i}", prompt=p, max_new_tokens=gen,
                            extras=extras, deadline_s=deadline_s))
    if stop_after is not None:
        for r in reqs:
            engine.submit(r)
        for _ in range(stop_after):
            if not engine.step():
                break
        return ({r.rid: np.asarray(r.generated, np.int32) for r in reqs},
                engine)
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
    if trace_out is not None:
        jsonl = engine.export_trace(trace_out)
        if log:
            print(f"  trace: {trace_out} (+ {jsonl}), {len(engine.obs)} "
                  f"events; open it at https://ui.perfetto.dev")
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
    ap.add_argument("--kv-layout", default="auto",
                    choices=["auto", "paged", "dense"],
                    help="decode KV storage: the paged arena or stacked "
                         "per-slot caches ('auto': paged for the attention "
                         "families, dense for the recurrent ones)")
    ap.add_argument("--prefill-chunk", default="auto",
                    type=lambda v: (v if v == "auto" else None
                                    if v == "none" else int(v)),
                    help="chunked-prefill tokens per lane and step (paged "
                         "dense / moe; 'auto': 64 there), or 'none': the "
                         "bucketed prefill (vlm, encdec and the dense "
                         "layout always; the recurrent families prefill "
                         "whole prompts)")
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
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record every span and write a Chrome/Perfetto "
                         "trace-event JSON here after the run")
    ap.add_argument("--sanitize", action="store_true",
                    help="KV-arena sanitizer: poison freed pages, "
                         "generation-check decode tables, per-step pool "
                         "invariants, leak audit at drain")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="seeded fault injection (pool OOM, poisoned "
                         "pages, stalls, forced preemption); faults are "
                         "contained by the step error boundary")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline (engine steps under the "
                         "step clock): queued requests past it expire, "
                         "hopeless admissions are shed")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="engine snapshots go here (ServingEngine."
                         "snapshot / restore)")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help=">0: snapshot the engine every N steps (needs "
                         "--snapshot-dir)")
    ap.add_argument("--clock", default="wall", choices=["wall", "steps"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="fast smoke: tiny greedy trace, assert completion")
    ap.add_argument("--waves", type=int, default=0,
                    help=">0: run the wave-based baseline instead (--slots "
                         "prompts a wave)")
    a = ap.parse_args()
    picks = dict(dispatcher=a.dispatcher, adaptnet_ckpt=a.adaptnet_ckpt,
                 defrag_threshold=a.defrag_threshold)
    if a.smoke and a.chaos is not None:
        # the same greedy trace served twice, fault-free and then with
        # every injector armed: the chaotic run must end every request,
        # contain at least one injected fault inside the step boundary and
        # leave every request that finished with the fault-free tokens
        from repro_torch.serving import ChaosConfig
        common = dict(
            arch=a.arch, preset=a.preset, num_requests=4, num_slots=2,
            prompt_len=12, gen=6, temperature=0.0, execute=a.execute,
            kv_layout="paged",
            prefill_chunk=8 if a.prefill_chunk == "auto" else a.prefill_chunk,
            sanitize=True, device=a.device, log=False, **picks)
        base, _ = serve_continuous(**common)
        chaos = ChaosConfig(seed=a.chaos, pool_oom_p=0.15, poison_p=0.15,
                            stall_p=0.1, preempt_p=0.1)
        outputs, engine = serve_continuous(
            **common, chaos=chaos, deadline_s=a.deadline,
            snapshot_dir=a.snapshot_dir, snapshot_every=a.snapshot_every,
            trace_out=a.trace_out)
        s = engine.summary()
        if s["faults_injected"] < 1 or s["faults_contained"] < 1:
            raise SystemExit(f"smoke failed: no fault injected and "
                             f"contained {s}")
        outcomes = {r.rid: r.outcome for r in engine.requests.values()}
        if not all(outcomes.values()):
            raise SystemExit(f"smoke failed: a request never ended "
                             f"{outcomes}")
        done = [rid for rid, o in outcomes.items() if o == "done"]
        for rid in done:
            if not np.array_equal(outputs[rid], base[rid]):
                raise SystemExit(f"smoke failed: {rid} chaos "
                                 f"{outputs[rid]} != fault-free {base[rid]}")
        if s["kv_leaked_tables"] or s["kv_leaked_refs"] or \
                engine.pool.num_free != engine.pool.num_blocks:
            raise SystemExit(f"smoke failed: KV pages leaked {s}")
        print(f"chaos smoke OK (seed={a.chaos}: "
              f"{int(s['faults_injected'])} injected, "
              f"{int(s['faults_contained'])} contained, outcomes="
              f"{sorted(outcomes.values())}, greedy parity for "
              f"{len(done)} survivors)")
        return
    if a.smoke and a.prefix_cache:
        # a shared-prefix workload served twice, cache off then cache on
        # (plus cascade decode when asked): the greedy tokens must agree
        # while the cached run reuses pages
        common = dict(arch=a.arch, num_requests=4, num_slots=2,
                      prompt_len=24, gen=6, temperature=0.0,
                      execute=a.execute, prefill_chunk=8,
                      shared_prefix_len=16, device=a.device, log=False,
                      sanitize=a.sanitize, **picks)
        base, _ = serve_continuous(**common)
        outputs, engine = serve_continuous(
            **common, prefix_cache=True,
            shared_prefix_decode=a.shared_prefix_decode,
            trace_out=a.trace_out)
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
            sanitize=a.sanitize, device=a.device, log=False, **picks)
        base, _ = serve_continuous(**common)
        outputs, engine = serve_continuous(
            **common, spec_draft=a.spec_draft, spec_k=a.spec_k,
            trace_out=a.trace_out)
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
            kv_layout=a.kv_layout, prefill_chunk=a.prefill_chunk,
            device=a.device,
            trace_out=a.trace_out, sanitize=a.sanitize,
            snapshot_dir=a.snapshot_dir, snapshot_every=a.snapshot_every,
            **picks)
        if not all(len(v) == 6 for v in outputs.values()):
            raise SystemExit(f"smoke failed: {outputs}")
        engine.pool.check()
        if engine.pool.num_free != engine.pool.num_blocks:
            raise SystemExit("smoke failed: KV pages leaked")
        if a.sanitize:
            s = engine.summary()
            if s["kv_sanitize_checks"] <= 0 or s["kv_poison_hits"] or \
                    s["kv_generation_faults"] or s["kv_leaked_tables"] or \
                    s["kv_leaked_refs"]:
                raise SystemExit(f"smoke failed: sanitizer {s}")
            print(f"sanitizer clean ({int(s['kv_sanitize_checks'])} checks, "
                  f"{int(s['kv_poison_fills'])} pages poisoned on free)")
        if a.snapshot_dir and a.snapshot_every > 0:
            print(f"snapshots: {engine.summary()['engine_snapshots']} "
                  f"written to {a.snapshot_dir}")
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
    if a.waves > 0:
        serve_waves(arch=a.arch, preset=a.preset, batch=a.slots,
                    prompt_len=a.prompt_len, gen=a.gen, waves=a.waves,
                    temperature=a.temperature, top_k=a.top_k,
                    device=a.device, execute=a.execute)
        return
    chaos = None
    if a.chaos is not None:
        from repro_torch.serving import ChaosConfig
        chaos = ChaosConfig(seed=a.chaos, pool_oom_p=0.05,
                            poison_p=0.05 if a.sanitize else 0.0,
                            stall_p=0.05, preempt_p=0.05)
    serve_continuous(arch=a.arch, preset=a.preset, num_requests=a.requests,
                     num_slots=a.slots, prompt_len=a.prompt_len, gen=a.gen,
                     temperature=a.temperature, top_k=a.top_k,
                     execute=a.execute, kv_layout=a.kv_layout,
                     prefill_chunk=a.prefill_chunk,
                     min_prompt_len=a.min_prompt_len,
                     prefix_cache=a.prefix_cache,
                     shared_prefix_decode=a.shared_prefix_decode,
                     shared_prefix_len=a.shared_prefix_len, clock=a.clock,
                     spec_draft=a.spec_draft, spec_k=a.spec_k,
                     trace_out=a.trace_out, sanitize=a.sanitize,
                     chaos=chaos, deadline_s=a.deadline,
                     snapshot_dir=a.snapshot_dir,
                     snapshot_every=a.snapshot_every,
                     device=a.device, **picks)


if __name__ == "__main__":
    main()
