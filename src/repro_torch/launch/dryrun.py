"""Dry-run sweep: every (arch x shape) cell on one card — the port of
``repro/launch/dryrun.py``.

Per cell it records one JSON, ``build/dryrun/<arch>__<shape>__h100.json``
(``__cpu.json`` for a ``--device cpu`` run):

- a cell that ``shape_applicable`` rejects is skipped with the
  reference's reason;
- before anything is allocated, the cell's estimates come from the
  abstract trees (``Model.init_abstract``, ``cache_specs`` on the meta
  device): parameter count and bytes, model FLOPs, compulsory bytes and
  the ideal roofline terms on the H100.  A cell whose memory estimate
  (:func:`memory_estimate`) passes the H100's 80 GB is skipped with the
  estimate;
- ``--device meta`` stops there and records the estimates;
- otherwise the cell runs through ``launch/profile.py::profile_cell``
  (its step's wall, its kernels' device time, the peak memory).

Errors are recorded and the sweep goes on; it exits 1 if any cell failed,
as the reference does.  The reference's cells are a 256-chip pod's
global batches; the port runs ``--batch`` sequences (1 unless given) of
each shape's length on one card: the port's mesh (``launch/mesh.py``)
and sharding (``parallel/``) train over the ranks a process group has,
and no 256- or 512-rank group exists here, so ``--multi-pod`` is refused.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
      --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape decode_32k --optimized
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --preset reduced --seq-len 64 --device cpu
"""

from __future__ import annotations

import argparse
import json
import traceback
from dataclasses import replace
from pathlib import Path
from typing import Optional, Tuple


def memory_estimate(cfg, shape, params, cache=None) -> Tuple[float, str]:
    """(bytes, what they count) that a cell's step holds at its peak, from
    its abstract trees.

    A serve step holds its parameters, its cache and one layer's
    activations for the step's tokens: the residual stream four times
    (x, the normed x, the attention's output, the sum) and the MLP's
    hidden rows three times (gate, up, their product), in the compute
    dtype.  A train step holds the larger of two sets: in the backward,
    the parameters, their gradients, AdamW's m and v, one residual
    checkpoint a layer and one loss chunk's f32 logits three times (the
    logits, their log-softmax, its gradient); in the update, which
    returns new tensors, the parameters, the gradients, m and v, and the
    new m, v, updates and parameters.  Allocator slack and the
    initialisation's f32 draws are not counted."""
    from repro_torch.models.modules import dtype_of, param_bytes, \
        param_count
    p = float(param_bytes(params))
    B, S = shape.global_batch, shape.seq_len
    act_b = dtype_of(cfg.compute_dtype).itemsize
    if shape.kind != "train":
        tokens = B * (1 if shape.kind == "decode" else S)
        ff = cfg.d_ff
        if cfg.moe is not None:
            ff = max(ff, cfg.moe.d_ff_expert * (
                cfg.moe.experts_per_token + cfg.moe.num_shared_experts))
        act = tokens * (4 * cfg.d_model + 3 * ff) * act_b
        return (p + param_bytes(cache) + act,
                "parameters, cache and one layer's activations")
    o = param_count(params) * dtype_of(cfg.opt_state_dtype).itemsize
    act = (B * S * cfg.d_model * (cfg.num_layers + cfg.encoder_layers)
           * act_b + 3 * B * min(S, cfg.loss_chunk) * cfg.vocab_size * 4)
    return (max(2 * p + 2 * o + act, 4 * p + 4 * o),
            "parameters, gradients, AdamW state, activations and the "
            "update's new copies")


def estimates(cfg, shape) -> dict:
    """A cell's numbers from its abstract trees (nothing allocated)."""
    from repro_torch.core.hw import H100
    from repro_torch.launch.roofline import RooflineTerms
    from repro_torch.launch.steps import (build_serve_parts,
                                          model_flops_estimate,
                                          model_min_bytes_estimate)
    from repro_torch.models.api import build_model
    from repro_torch.models.modules import param_bytes

    if shape.kind == "train":
        model, cache = build_model(cfg, "meta"), None
        params = model.init_abstract()
    else:
        model, params, cache = build_serve_parts(cfg, shape, "meta")
    mem, what = memory_estimate(cfg, shape, params, cache)
    terms = RooflineTerms(model_flops=model_flops_estimate(cfg, params, shape),
                          model_min_bytes=model_min_bytes_estimate(
                              cfg, params, shape),
                          dtype=cfg.compute_dtype, chip=H100)
    return {"num_params": model.num_params(params),
            "param_bytes": param_bytes(params),
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype,
            "memory_estimate_bytes": mem, "memory_estimate_of": what,
            "model_flops": terms.model_flops,
            "model_min_bytes": terms.model_min_bytes,
            "ideal": {k: terms.to_dict()[k] for k in (
                "chip", "peak_flops", "hbm_bw", "ideal_compute_s",
                "ideal_memory_s", "dominant", "bound_s")}}


def run_cell(arch: str, shape_name: str, out_dir: Path, force: bool = False,
             optimized: bool = False, device: Optional[str] = None,
             batch: int = 1, preset: str = "full",
             seq_len: Optional[int] = None, steps: int = 3,
             top: int = 10) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import SHAPES, shape_applicable, \
        skip_reason
    from repro_torch.core.hw import H100
    from repro_torch.launch.profile import cell_config, profile_cell

    tag = "cpu" if device == "cpu" else "h100"
    out_path = Path(out_dir) / f"{arch}__{shape_name}__{tag}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        if rec.get("status") in ("ok", "skipped"):
            print(f"[cached] {arch} x {shape_name} x {tag}: {rec['status']}")
            return rec

    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": tag,
           "kind": shape.kind, "device": device or "cuda",
           "batch": int(batch), "seq_len": int(seq_len or shape.seq_len),
           "preset": preset, "optimized": optimized}
    if not shape_applicable(get_arch(arch), shape_name):
        rec["status"] = "skipped"
        rec["reason"] = skip_reason(arch)
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[skip]   {arch} x {shape_name}: N/A")
        return rec

    try:
        cfg, shape = cell_config(arch, shape_name, {}, batch, optimized,
                                 preset)
        run_shape = replace(shape, global_batch=rec["batch"],
                            seq_len=rec["seq_len"])
        rec.update(estimates(cfg, run_shape))
        gb = rec["memory_estimate_bytes"] / 1e9
        if rec["memory_estimate_bytes"] > H100.hbm_bytes:
            rec["status"] = "skipped"
            rec["reason"] = (f"memory estimate {gb:.2f} GB "
                             f"({rec['memory_estimate_of']}) exceeds the "
                             f"{H100.hbm_bytes / 1e9:.0f} GB of one H100")
            print(f"[skip]   {arch} x {shape_name}: {rec['reason']}")
        elif device == "meta":
            rec["status"] = "ok"
            print(f"[ok]     {arch} x {shape_name}: {rec['num_params']:,} "
                  f"params, {gb:.2f} GB, model_flops "
                  f"{rec['model_flops']:.3e}, min bytes "
                  f"{rec['model_min_bytes']:.3e}, dominant "
                  f"{rec['ideal']['dominant']} (estimates only)")
        else:
            out = profile_cell(arch, shape_name, {}, top, batch=batch,
                               device=device, optimized=optimized,
                               steps=steps, preset=preset, seq_len=seq_len)
            terms = out["terms"]
            rec.update({
                "status": "ok", "device_name": out["device_name"],
                "build_s": round(out["build_s"], 2),
                "step_walls_s": out["step_walls_s"],
                "peak_memory_bytes": out["peak_memory_bytes"],
                "roofline": terms.to_dict(), "rows": out["rows"],
                "by_kernel": out["by_kernel"], "launches": out["launches"],
                "finite": out["finite"]})
            print(f"[ok]     {arch} x {shape_name} x {tag}: step "
                  f"{1e3 * terms.step_s:.2f} ms  dominant={terms.dominant}"
                  f"  roofline_frac={terms.roofline_fraction:.3f}  "
                  f"bound_attain={terms.bound_attainment:.3f}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL]   {arch} x {shape_name} x {tag}: {rec['error']}")

    out_path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None) -> int:
    from repro_torch.launch.profile import add_cell_args, start
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    add_cell_args(ap, "'meta': the estimates only; 'cpu': run the plain "
                      "versions; default cuda")
    args = ap.parse_args(argv)
    start(args)

    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.configs.shapes import SHAPES

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, out_dir, force=args.force,
                           optimized=args.optimized, device=args.device,
                           batch=args.batch, preset=args.preset,
                           seq_len=args.seq_len, steps=args.steps)
            if rec["status"] == "error":
                n_fail += 1
            else:
                n_ok += 1
    print(f"\ndry-run sweep done: {n_ok} ok/skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
