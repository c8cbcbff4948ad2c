"""How far an f32 training step's gradient can be trusted, on the card.

    PYTHONPATH=src python -m repro_torch.launch.probe_grad \
        [--arch rwkv6-1.6b] [--layers N] [--batch 2] [--seq 1024] \
        [--lrs 1e-3,1e-4] [--runs kernel,plain,ulp_a,ulp_b,f64] \
        [--out FILE] [--device cuda] [--preset full]

At the arch's published widths (f32, the optimized profile, ``--layers``
slots when given), step 1's loss and gradient from ``model.init(0)`` on
``chip_smoke.py``'s batch (the loader's step 0), in each of ``--runs``
(``plain`` and ``f64`` always):

- ``kernel``: every kernel on (as ``chip_smoke.py`` phase 14 trains);
- ``plain``: the plain PyTorch versions;
- ``ulp_a`` / ``ulp_b``: the plain versions at the same weights with every
  element moved one f32 rounding unit up or down (two draws of the signs);
- ``f64``: the plain versions in f64.  This process then rebinds
  ``torch.float32`` and ``Tensor.float`` to f64, so that every f32 island of
  the model is f64 too (the run checks that every gradient comes back
  f64); it runs last, after every f32 run.

Per leaf, and per layer of the stacked leaves, each f32 run's distance
from the f64 run (``|x - f64| / |f64|``, norms over the leaf or the
layer), and the kernel run's from the plain run.  Before the f64 run, the
plain and the kernel versions train 4 steps at each lr in ``--lrs``
(``train_main``, as phase 14), and their losses are printed.  The records
go to ``--out`` as JSON.  Runs on the card unless ``--device cpu`` is
given (with ``--preset reduced``, a quick check of the script itself).
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
DEV = "cuda"


def _paths(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _execute(name: str) -> str:
    """The dispatch mode of a run: on the CPU, kernels take their plain
    versions ("auto")."""
    return "auto" if name == "kernel" and DEV == "cpu" else name


PEAK_GB = {}


def step_grads(model, params, batch, execute: str, name: str):
    """(loss, {leaf path: gradient on the host}) of one step; its peak
    device memory goes to ``PEAK_GB[name]``."""
    from repro_torch.launch.steps import _dispatch_ctx
    execute = _execute(execute)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    leaves = _map(params, lambda p: p.detach().requires_grad_(True))
    with torch.enable_grad(), _dispatch_ctx("train_step", execute):
        loss, _ = model.loss(leaves, batch)
        loss.backward()
    out = {k: v.grad.detach().cpu() for k, v in _paths(leaves)}
    if DEV == "cuda":
        PEAK_GB[name] = torch.cuda.max_memory_allocated() / 1e9
    del leaves
    _empty()
    return float(loss.detach()), out


def _empty() -> None:
    if DEV == "cuda":
        torch.cuda.empty_cache()


def ulp_moved(params, seed: int):
    """Every element one f32 rounding unit up or down, the sign drawn."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)

    def move(p):
        up = torch.rand(p.shape, generator=gen, device=p.device) < 0.5
        inf = torch.full_like(p, math.inf)
        return torch.nextafter(p, torch.where(up, inf, -inf))
    return _map(params, move)


def compare(runs, ref: str, names):
    """Whole-gradient, per-leaf and per-layer relative distances
    (``|x - ref| / |ref|``, f64 on the device) of each run in ``names``
    from run ``ref``."""
    g_ref = runs[ref][1]
    out = {"whole": {}, "leaf": {}, "layer": {}}
    for name in names:
        g = runs[name][1]
        num = den = 0.0
        per_layer = None
        for k in g_ref:
            a, b = (t.to(DEV, torch.float64) for t in (g[k], g_ref[k]))
            d2, b2 = (a - b).square(), b.square()
            n, d = float(d2.sum()), float(b2.sum())
            num, den = num + n, den + d
            out["leaf"].setdefault(k, {})[name] = math.sqrt(n / d) if d else 0.0
            if k.startswith("layers/"):
                nl, dl = d2.flatten(1).sum(1), b2.flatten(1).sum(1)
                per_layer = (nl, dl) if per_layer is None else \
                    (per_layer[0] + nl, per_layer[1] + dl)
        out["whole"][name] = math.sqrt(num / den)
        out["layer"][name] = (per_layer[0] / per_layer[1]).sqrt().tolist() \
            if per_layer is not None else []
    return out


def grad_norm(g) -> float:
    return math.sqrt(sum(float(v.double().square().sum()) for v in g.values()))


def to_f64_process() -> None:
    """Rebind the f32 dtype and ``Tensor.float`` to f64 in this process."""
    from repro_torch.models import modules
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    modules.DTYPES["float32"] = torch.float64


def train_losses(cfg, lr: float, execute: str, steps: int, batch: int,
                 seq: int):
    """The losses of ``train_main``'s first ``steps`` steps."""
    from repro_torch.launch.train import train_main
    ckpt = ROOT / "build" / "probe_grad_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    _, history, _ = train_main(
        override_cfg=cfg, preset="full", steps=steps, global_batch=batch,
        seq_len=seq, checkpoint_dir=str(ckpt), checkpoint_every=10 * steps,
        lr=lr, log_every=1, seed=0, execute=_execute(execute), device=DEV)
    shutil.rmtree(ckpt, ignore_errors=True)
    _empty()
    return [h["loss"] for h in history]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lrs", default="1e-3,1e-4")
    ap.add_argument("--runs", default="kernel,plain,ulp_a,ulp_b,f64")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--preset", default="full", choices=("full", "reduced"))
    args = ap.parse_args()
    global DEV
    DEV = args.device
    if DEV == "cuda" and not torch.cuda.is_available():
        print("probe_grad: needs a CUDA card (or --device cpu)")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, _batch
    from repro_torch.models.api import build_model

    t0 = time.time()
    cfg = get_arch(args.arch, optimized=True)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    cfg32 = cfg.replace(num_layers=args.layers or cfg.num_layers,
                        param_dtype="float32", compute_dtype="float32",
                        opt_state_dtype="float32")
    print(f"{cfg.name}: {cfg32.num_layers} layers, d_model {cfg.d_model}, "
          f"f32, batch {args.batch} x {args.seq}")
    rec = {"arch": cfg.name, "num_layers": cfg32.num_layers,
           "batch": args.batch, "seq": args.seq, "train": {}}
    steps = 4
    for lr in (float(x) for x in args.lrs.split(",") if x):
        for execute in ("torch", "kernel"):
            losses = train_losses(cfg32, lr, execute, steps, args.batch,
                                  args.seq)
            rec["train"][f"{execute} lr {lr:g}"] = losses
            print(f"  trained {steps} steps, {execute:>6}, lr {lr:g}: "
                  "losses " + " ".join(f"{x:.4f}" for x in losses))

    tokens = torch.from_numpy(_batch(DataConfig(
        cfg32.vocab_size, args.seq, args.batch, seed=0), 0)["tokens"])
    batch = {"tokens": tokens.to(DEV)}
    model = build_model(cfg32, DEV)
    params = model.init(0)
    want = set(args.runs.split(",")) | {"plain", "f64"}
    runs = {}
    if "kernel" in want:
        runs["kernel"] = step_grads(model, params, batch, "kernel",
                                    "kernel")
    runs["plain"] = step_grads(model, params, batch, "torch", "plain")
    for name, seed in (("ulp_a", 1), ("ulp_b", 2)):
        if name in want:
            moved = ulp_moved(params, seed)
            runs[name] = step_grads(model, moved, batch, "torch", name)
            del moved
    host = _map(params, lambda p: p.detach().cpu())
    del params, model
    _empty()

    to_f64_process()
    model = build_model(cfg32, DEV)
    p64 = _map(host, lambda p: p.to(DEV, torch.float64))
    try:
        runs["f64"] = step_grads(model, p64, batch, "torch", "f64")
        rec["f64_batch"] = "whole"
    except torch.cuda.OutOfMemoryError:
        # the loss is the mean over B equal rows: the gradient is the mean
        # of the rows' gradients
        _empty()
        parts = [step_grads(model, p64, {"tokens": batch["tokens"][b:b + 1]},
                            "torch", "f64") for b in range(args.batch)]
        runs["f64"] = (sum(p[0] for p in parts) / len(parts),
                       {k: sum(p[1][k] for p in parts) / len(parts)
                        for k in parts[0][1]})
        rec["f64_batch"] = "row by row"
    del p64
    _empty()
    bad = [k for k, v in runs["f64"][1].items() if v.dtype != torch.float64]
    if bad:
        print(f"probe_grad: f64 run returned other dtypes at {bad[:5]}")
        return 1

    f32_runs = tuple(n for n in ("plain", "kernel", "ulp_a", "ulp_b")
                     if n in runs)
    vs64 = compare(runs, "f64", f32_runs)
    vsplain = compare(runs, "plain", f32_runs[1:])
    rec.update({
        "loss": {k: v[0] for k, v in runs.items()},
        "grad_norm": {k: grad_norm(v[1]) for k, v in runs.items()},
        "vs_f64": vs64, "vs_plain": vsplain, "peak_gb": PEAK_GB,
        "seconds": time.time() - t0})
    gn64 = rec["grad_norm"]["f64"]
    print(f"  step 1 (f64 run {rec['f64_batch']}): loss, grad norm, and the "
          f"relative distance of the whole gradient from the f64 run's")
    for name in ("f64",) + f32_runs:
        l, gn = rec["loss"][name], rec["grad_norm"][name]
        extra = "" if name == "f64" else (
            f"  loss rel {abs(l - rec['loss']['f64']) / abs(rec['loss']['f64']):.2e}"
            f"  grad_norm rel {abs(gn - gn64) / gn64:.2e}"
            f"  gradient rel {vs64['whole'][name]:.2e}")
        print(f"    {name:>6}: loss {l:.7f} grad_norm {gn:.6f}{extra}")
    gp = rec["grad_norm"]["plain"]
    print("  from the plain f32 run: " + ", ".join(
        f"{n} grad_norm rel {abs(rec['grad_norm'][n] - gp) / gp:.2e} "
        f"gradient rel {vsplain['whole'][n]:.2e}" for n in f32_runs[1:]))
    worst = sorted(vs64["leaf"], key=lambda k: -vs64["leaf"][k]["plain"])[:8]
    print(f"  leaves furthest from f64 ({', '.join(f32_runs)}; rel):")
    for k in worst:
        print(f"    {k:<24} " + " ".join(f"{vs64['leaf'][k][n]:.2e}"
                                         for n in f32_runs))
    print(f"  per layer, stacked leaves' gradient rel to f64 "
          f"({' / '.join(f32_runs)}):")
    for i, row in enumerate(zip(*(vs64["layer"][n] for n in f32_runs))):
        print(f"    layer {i:>2}: " + " / ".join(f"{x:.2e}" for x in row))
    if PEAK_GB:
        print("  peak device memory a step: " + ", ".join(
            f"{k} {v:.1f} GB" for k, v in PEAK_GB.items()))
    print(f"  done in {rec['seconds']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
