"""END-TO-END DRIVER on the port (the paper is a GEMM-inference
accelerator, so the e2e deliverable is serving): serve a mixed-length
request trace through the continuous-batching engine — per-step admission,
paged KV pool, SARA-routed GEMM dispatch on the RSA kernel, paged decode
and chunked prefill on the paged-attention kernels, TTFT / latency /
throughput telemetry.

  PYTHONPATH=src python examples/torch/serve_requests.py [--requests 12 --slots 4]
  PYTHONPATH=src python examples/torch/serve_requests.py --device cpu \\
      --requests 6 --slots 3 --d-model 64 --layers 2

The port's counterpart of ``examples/serve_requests.py``, with its flags,
defaults, trace and report.  Runs on CUDA unless ``--device cpu`` is
given; without CUDA it raises.  ``main`` returns the config, the trace,
the engine and its outputs.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--max-gen", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=256,
                    help="width of the served model (reduced family)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    a = ap.parse_args(argv)

    cfg = get_arch(a.arch).reduced().replace(
        d_model=a.d_model, head_dim=a.d_model // 4,
        d_ff=4 * a.d_model, num_layers=a.layers, vocab_size=4096)
    from repro_torch.models.api import build_model
    n_params = build_model(cfg, a.device).num_params()

    rng = np.random.default_rng(a.seed)
    reqs = []
    for i in range(a.requests):
        plen = int(rng.integers(8, a.max_prompt + 1))
        gen = int(rng.integers(4, a.max_gen + 1))
        reqs.append(Request(
            rid=f"req-{i}",
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=gen,
            arrival_time=float(i // 2)))      # two arrivals per step
    print(f"serving {cfg.name} (~{n_params/1e6:.1f}M params): "
          f"{a.requests} mixed-length requests "
          f"(prompts 8-{a.max_prompt}, gens 4-{a.max_gen}) "
          f"on {a.slots} slots")

    engine = ServingEngine(cfg, EngineConfig(
        num_slots=a.slots, max_len=a.max_prompt + a.max_gen + 1,
        temperature=a.temperature, top_k=40, seed=a.seed,
        max_prefills_per_step=2), device=a.device)
    outputs = engine.run(reqs)
    total = sum(len(v) for v in outputs.values())
    print(f"served {total} tokens total")
    print(engine.metrics.report(engine.dispatcher.cache_info(),
                                engine.dispatch_stats()))
    print("  executed gemm plan (registry-backed, last step):")
    for site, desc in engine.gemm_plan.items():
        print(f"    {site:<24} {desc}")
    return {"cfg": cfg, "requests": reqs, "engine": engine,
            "outputs": outputs}


if __name__ == "__main__":
    main()
