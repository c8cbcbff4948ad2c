"""Step profiler: build one (arch x shape) cell — with optional config
overrides — run its step on the card, and print its roofline terms and
the kernels that took its device time.  The port of
``repro/launch/profile.py`` (``parse_override`` and ``apply_overrides``
copied as they are).

Where the reference lowers and compiles the cell for a 256-chip pod and
reads the HLO, the port runs ``batch`` sequences of the shape's length
on one card: one warm-up call, ``steps`` timed calls (host clock, a
device synchronisation around each), then one call under
``torch.profiler``, whose kernel events give the device time and whose
own wall the idle share sets it against.  Train cells run in f32 (as the
port's training paths do: the f32 CUDA-core peak), prefill and decode
cells in the registry's dtypes (bf16: the tensor-core peak).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile --arch llama3.2-1b \\
      --shape decode_32k [--optimized] [--batch 1] [--top 30] \\
      [--set attn_chunk=256 --set moe.capacity_factor=1.0 ...]
  PYTHONPATH=src python -m repro_torch.launch.profile --arch llama3.2-1b \\
      --shape train_4k --preset reduced --device cpu

Runs on CUDA unless ``--device cpu`` is given; the CPU run times the
plain PyTorch versions and measures no device time.  ``--multi-pod``
has no counterpart on one card and raises.
"""

from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import replace
from typing import Optional

import torch


def parse_override(kv: str):
    key, _, val = kv.partition("=")
    try:
        import ast
        pval = ast.literal_eval(val)
    except (ValueError, SyntaxError):
        pval = val
    return key, pval


def apply_overrides(cfg, overrides):
    """Apply {possibly.dotted.key: value} overrides to an ArchConfig."""
    import dataclasses
    nested = {}
    flat = {}
    for k, v in overrides.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
        else:
            flat[k] = v
    for head, sub in nested.items():
        child = getattr(cfg, head)
        flat[head] = dataclasses.replace(child, **sub)
    return cfg.replace(**flat)


def cell_config(arch: str, shape_name: str, overrides: dict,
                batch: int = 1, optimized: bool = False,
                preset: str = "full"):
    """(cfg, shape) of a cell as it runs on one card: the registry's arch
    (its optimized profile if asked, shape-aware for one device) at the
    preset, with the overrides, in f32 for a train cell."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES, shape_applicable, \
        skip_reason
    cfg = get_arch(arch, optimized=optimized, global_batch=batch, devices=1)
    if preset == "reduced":
        cfg = cfg.reduced()
    elif preset != "full":
        raise ValueError(f"preset must be 'reduced' or 'full', got {preset!r}")
    cfg = apply_overrides(cfg, overrides)
    if not shape_applicable(cfg, shape_name):
        raise ValueError(skip_reason(arch))
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                          opt_state_dtype="float32")
    return cfg, shape


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _first_output(out) -> torch.Tensor:
    """The step's headline output: a train step's loss, a serve step's
    logits."""
    if isinstance(out, tuple) and len(out) == 3:       # params, opt, metrics
        return out[2]["loss"]
    return out[0]


def profile_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
                 top: int = 25, batch: int = 1, device: Optional[str] = None,
                 optimized: bool = False, steps: int = 3,
                 preset: str = "full", seq_len: Optional[int] = None,
                 seed: int = 0) -> dict:
    """Build and run one cell: ``batch`` sequences of the shape's length
    (``seq_len`` cuts it), weights and inputs from ``seed``.  Returns the
    roofline ``terms`` (a :class:`RooflineTerms`), the top kernel
    ``rows`` and the rows ``by_kernel`` family, ``build_s`` (init plus the
    first call: the counterpart of the reference's ``compile_s``), the
    timed walls, the peak device memory, the launches of the profiled
    step and the cell's dtypes and peak.  On CUDA a profiler run that
    records no kernel raises."""
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import (RooflineTerms, kernel_events,
                                             profile_by_kernel,
                                             profile_kernels)
    from repro_torch.launch.steps import (build_cell, model_flops_estimate,
                                          model_min_bytes_estimate)
    from repro_torch.models.api import resolve_device

    overrides = dict(overrides or {})
    cfg, shape = cell_config(arch, shape_name, overrides, batch, optimized,
                             preset)
    run_shape = replace(shape, global_batch=int(batch),
                        seq_len=int(seq_len or shape.seq_len))
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cell = build_cell(cfg, run_shape, batch, str(dev), seed)
    out = _first_output(cell.fn())
    _sync(dev)
    build_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(out.float()).all())
    out_shape = list(out.shape)
    del out
    cell.fn()                                        # warm-up
    walls = []
    for _ in range(steps):
        _sync(dev)
        t1 = time.perf_counter()
        cell.fn()
        _sync(dev)
        walls.append(time.perf_counter() - t1)

    from torch.profiler import ProfilerActivity, profile
    # the card's activity alone: tracing every host op as well would
    # slow a host-bound step's profiled wall
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    ops.reset_counts()
    with profile(activities=acts) as prof:
        _sync(dev)
        t1 = time.perf_counter()
        cell.fn()
        _sync(dev)
        profiled_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    busy_s = rows = by_kernel = None
    if cuda:
        events = kernel_events(prof)
        if not events:
            raise RuntimeError("torch.profiler recorded no CUDA kernel event "
                               "for the step: its device time is not "
                               "measured")
        busy_s = sum(us for _, us in events) / 1e6
        rows = profile_kernels(prof, top)
        by_kernel = profile_by_kernel(prof)
    peak_mem = torch.cuda.max_memory_allocated(dev) if cuda else None

    mf = model_flops_estimate(cfg, cell.params, run_shape)
    mb = model_min_bytes_estimate(cfg, cell.params, run_shape)
    terms = RooflineTerms(model_flops=mf, model_min_bytes=mb,
                          step_s=statistics.median(walls) if walls else 0.0,
                          busy_s=busy_s, profiled_s=profiled_s,
                          dtype=cfg.compute_dtype)
    return {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "seq_len": run_shape.seq_len, "batch": int(batch),
        "preset": preset, "optimized": optimized,
        "overrides": {k: repr(v) for k, v in overrides.items()},
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "peak_flops": terms.peak_flops,
        "num_params": cell.model.num_params(cell.params),
        "terms": terms, "rows": rows, "by_kernel": by_kernel,
        "build_s": build_s, "step_walls_s": walls,
        "peak_memory_bytes": peak_mem, "launches": launches,
        "finite": finite, "out_shape": out_shape,
    }


def print_profile(out: dict, top: int) -> None:
    t = out["terms"]
    d = t.to_dict()
    print(f"\n== {out['arch']} x {out['shape']} (batch {out['batch']} x "
          f"{out['seq_len']}, {out['kind']}) on {out['device_name']}  "
          f"overrides={out['overrides']}")
    print(f"dtypes: params {out['param_dtype']}, compute "
          f"{out['compute_dtype']}; peak {out['peak_flops'] / 1e12:.0f} "
          f"TFLOP/s, {t.chip.hbm_bw / 1e12:.2f} TB/s")
    print(f"build {out['build_s']:.2f}s  step {1e3 * t.step_s:.3f} ms (median "
          f"of {len(out['step_walls_s'])})  busy "
          + ("not measured" if t.busy_s is None else
             f"{1e3 * t.busy_s:.3f} ms of a profiled step of "
             f"{1e3 * t.profiled_s:.3f} ms, idle {100 * t.idle_share:.1f}%")
          + ("" if out["peak_memory_bytes"] is None else
             f"  peak memory {out['peak_memory_bytes'] / 1e9:.2f} GB"))
    print(f"model_flops={t.model_flops:.4e}  model_min_bytes="
          f"{t.model_min_bytes:.4e}  ideal compute {1e3 * t.ideal_compute_s:.3f}"
          f" ms, memory {1e3 * t.ideal_memory_s:.3f} ms  dominant="
          f"{d['dominant']}")
    print(f"roofline_frac={t.roofline_fraction:.4f}  "
          f"mem_attain={t.memory_attainment:.4f}  "
          f"bound_attain={t.bound_attainment:.4f}")
    print(f"launches (profiled step): {out['launches']}")
    if out["rows"] is None:
        print("kernels: not measured (no device)")
        return
    print(f"\ntop-{top} kernels by device time:")
    print(f"{'device ms':>10} {'share':>6} {'launches':>8}  kernel")
    for r in out["rows"]:
        print(f"{r['device_ms']:10.4f} {r['share']:6.3f} {r['launches']:8d}"
              f"  {r['kernel'][:110]}")
    print("\nby kernel family:")
    for r in out["by_kernel"][:top]:
        print(f"{r['device_ms']:10.4f} {r['share']:6.3f} {r['launches']:8d}"
              f"  {r['kernel'][:110]}")


def add_cell_args(ap: argparse.ArgumentParser,
                  device_help: str = "torch device (default cuda; 'cpu' "
                                     "runs the plain versions)") -> None:
    """The arguments of every launcher that runs a cell on one card."""
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 512-chip mesh: no counterpart on "
                         "one card (raises)")
    ap.add_argument("--batch", type=int, default=1,
                    help="sequences of the shape's length run on the card "
                         "(the shape's global batch is a pod's)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="cut the shape's length to this")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--optimized", action="store_true",
                    help="the registry's optimized profile (flash attention, "
                         "the WKV kernel)")
    ap.add_argument("--preset", default="full", choices=["full", "reduced"])
    ap.add_argument("--device", default=None, help=device_help)


def start(args) -> None:
    """Refuse ``--multi-pod`` (one card is no 512-rank mesh) and keep f32
    in f32: TF32 off, as the f32 peak assumes."""
    if args.multi_pod:
        raise SystemExit("--multi-pod: a cell's step runs on one card, which "
                         "has no mesh of the reference's 512 ranks")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable; dotted keys "
                         "reach nested configs, e.g. moe.capacity_factor=1.0)")
    add_cell_args(ap)
    args = ap.parse_args(argv)
    start(args)
    overrides = dict(parse_override(kv) for kv in args.set)
    out = profile_cell(args.arch, args.shape, overrides, args.top,
                       batch=args.batch, device=args.device,
                       optimized=args.optimized, steps=args.steps,
                       preset=args.preset, seq_len=args.seq_len)
    print_profile(out, args.top)


if __name__ == "__main__":
    main()
