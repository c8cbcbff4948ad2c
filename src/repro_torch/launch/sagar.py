"""SAGAR — the paper's own model end to end, the port of the reference's
``examples/quickstart.py`` parts 1-3 and of the ADAPTNET runs of
``benchmarks/fig8_adaptnet.py``, ``fig7_classifiers.py`` and
``fig9_adaptnetx.py`` (their computations, not their result files):

  PYTHONPATH=src python -m repro_torch.launch.sagar
  PYTHONPATH=src python -m repro_torch.launch.sagar --device cpu \\
      --samples 6000 --epochs 2

In order:

  a) Fig. 3: the motivating 256x64x256 GEMM on a monolithic 128x128
     array, a distributed 16 x 32x32 one and the best RSA configuration;
  b) the SAGAR-labelled datasets (``core/dataset.py::generate``, EDP
     oracle over the RSA configuration space) of the 2^12, 2^13 and 2^14
     MAC instances (75, 90 and 108 classes);
  c) the raw-encoding ADAPTNET (E = 16, H = 128) trained on each;
  d) each net's test accuracy, geomean and median relative EDP (Fig. 8);
  e) the four Fig. 7e baselines on the 2^14 split (``core/baselines.py``);
  f) the Fig. 9a cycle model, then each Table-IV workload's layers
     (``core/workloads.py::WORKLOADS``, 197 layers) through ONE batched
     ADAPTNETX query per workload (``kernels.ops.adaptnetx_recommend``)
     with the 2^14 net, dims clamped to 10^4 as the raw net requires; the
     picks are scored on the true dims (``relative_performance``);
  g) quickstart part 3's GEMMs (512x512x512 and 128x8000x128, f32)
     through ``SaraDispatcher.gemm``.

Rows carry the reference's names (``fig8.adaptnet_108cls_2^14macs.accuracy``,
``fig7e.<name>.accuracy``, ``fig9a.*``, ``fig9c.relative_performance_geomean``)
as ``name,value,derived`` lines, so the two can be read side by side.

The SAGAR classes describe the paper's 28 nm array, which no kernel here
executes: every cycle count, relative EDP and "% of oracle" printed is
the cost model's (labelled "model"), not a measurement.  What runs on the
card is the ADAPTNET training (PyTorch), the ADAPTNETX kernel and the RSA
GEMM kernel on the TPU tile space (through ``SaraDispatcher.gemm``).
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import adaptnet as A
from repro_torch.core import baselines as B
from repro_torch.core import costmodel as cm
from repro_torch.core import dataset as D
from repro_torch.core.adaptnetx_model import (AdaptNetXDesign,
                                              sweep_multipliers)
from repro_torch.core.hw import OS
from repro_torch.core.rsa import SAGAR_INSTANCE, make_instance
from repro_torch.core.workloads import WORKLOADS
from repro_torch.kernels import ops

QUICKSTART_GEMMS = ((512, 512, 512), (128, 8000, 128))
PAPER_CLASSES = 858          # the paper's raw configuration count, Fig. 9a


def emit(rows: List[Dict], log: bool = True) -> List[Dict]:
    """Print rows as the reference's ``benchmarks/common.emit`` does."""
    if log:
        for r in rows:
            print(f"{r['name']},{r['value']},{r.get('derived', '')}")
    return rows


def fig3(log: bool = True) -> Dict[str, float]:
    """Quickstart part 1: the 256x64x256 GEMM (OS) in cycles and SRAM
    reads of the cost model."""
    M, K, N = 256, 64, 256
    mono = cm.monolithic_cost(M, K, N, 128, 128, OS)
    dist = cm.distributed_cost(M, K, N, 32, 32, 16, OS)
    rsa = float(cm.oracle_runtime(SAGAR_INSTANCE, [M], [K], [N])[0])
    out = {"monolithic_cycles": float(mono.runtime),
           "monolithic_reads": float(mono.sram_reads),
           "distributed_cycles": float(dist.runtime),
           "distributed_reads": float(dist.sram_reads),
           "rsa_best_cycles": rsa}
    if log:
        print("=== Fig. 3: RSA cost model (model cycles, not measured) ===")
        print(f"monolithic 128x128 : {out['monolithic_cycles']:6.0f} cycles, "
              f"{out['monolithic_reads']:8.0f} reads")
        print(f"distributed 16x32x32: {out['distributed_cycles']:6.0f} cycles "
              f"({out['monolithic_cycles'] / out['distributed_cycles']:.2f}x),"
              f" {out['distributed_reads']:8.0f} reads "
              f"({out['distributed_reads'] / out['monolithic_reads']:.1f}x)")
        print(f"RSA best config    : {rsa:6.0f} cycles "
              f"({out['monolithic_cycles'] / rsa:.2f}x) at monolithic-level "
              f"reads")
    return out


def adaptnet_on(p: int, n_samples: int, epochs: int, seed: int,
                device: torch.device) -> Dict:
    """Fig. 8 at 2^p MACs: generate the SAGAR dataset (host numpy), train
    the raw ADAPTNET on ``device``, score its test picks with the cost
    model's EDP.  Returns the instance, split, train result, picks and
    scores, and the seconds of each half."""
    inst = make_instance(2 ** p)
    t0 = time.time()
    ds = D.generate(n_samples, inst=inst, seed=seed)
    gen_s = time.time() - t0
    tr, te = ds.split()
    res = A.train(tr, te, epochs=epochs, log=False, device=str(device))
    pred = A.predict(res.params, te.features)
    rel = D.relative_performance(inst, te.features, pred, "edp")
    return {"p": p, "inst": inst, "train": tr, "test": te, "result": res,
            "pred": pred, "num_classes": ds.num_classes,
            "distinct_labels": int(len(np.unique(ds.labels))),
            "accuracy": res.test_accuracy,
            "geomean_rel_edp": float(np.exp(np.mean(np.log(rel)))),
            "median_rel_edp": float(np.percentile(rel, 50)),
            "generate_s": gen_s, "train_s": res.train_seconds}


def fig8_row(r: Dict) -> Dict:
    geo = r["geomean_rel_edp"]
    return {"name": f"fig8.adaptnet_{r['num_classes']}cls_2^{r['p']}macs"
                    f".accuracy",
            "value": round(r["accuracy"], 4),
            "derived": (f"geomean_rel_edp={geo:.5f} median_rel_edp="
                        f"{r['median_rel_edp']:.5f} ({100 / geo:.2f}% of "
                        f"oracle, model; paper: >90% acc, 99.93% of "
                        f"oracle)")}


def fig7e(tr: D.Dataset, te: D.Dataset, adaptnet: Dict,
          device: torch.device, **forest) -> List[Dict]:
    """The four baselines (the torch ones on ``device``, the random
    forest on the host; ``forest`` overrides its size) and ADAPTNET."""
    rows = []
    for fn in (B.logistic_regression, B.knn, B.plain_mlp):
        r = fn(tr, te, device=str(device))
        rows.append({"name": f"fig7e.{r.name}.accuracy",
                     "value": round(r.accuracy, 4), "accuracy": r.accuracy,
                     "train_s": r.train_seconds,
                     "derived": f"train_s={r.train_seconds:.1f}"})
    r = B.random_forest(tr, te, **forest)
    rows.append({"name": f"fig7e.{r.name}.accuracy",
                 "value": round(r.accuracy, 4), "accuracy": r.accuracy,
                 "train_s": r.train_seconds,
                 "derived": f"train_s={r.train_seconds:.1f} (host numpy)"})
    res = adaptnet["result"]
    rows.append({"name": "fig7e.ADAPTNET.accuracy",
                 "value": round(res.test_accuracy, 4),
                 "accuracy": res.test_accuracy,
                 "train_s": res.train_seconds,
                 "derived": f"train_s={res.train_seconds:.1f} "
                            f"(paper: 95% vs XGB 87%)"})
    return rows


def fig9a_rows(num_classes: int) -> List[Dict]:
    """The ADAPTNETX cycle model (``core/adaptnetx_model.py``), as
    ``benchmarks/fig9_adaptnetx.py`` prints it: model cycles."""
    rows = []
    for classes in (num_classes, PAPER_CLASSES):
        sw = sweep_multipliers(classes)
        best_sc = min(sw["systolic_cells"].items(), key=lambda kv: kv[1])
        best_ax = min(sw["adaptnetx"].items(), key=lambda kv: kv[1])
        rows.append({"name": f"fig9a.systolic_cells_{classes}cls.best_cycles",
                     "value": best_sc[1],
                     "derived": f"at {best_sc[0]} multipliers, model "
                                f"(paper @858cls: 1134@1024)"})
        rows.append({"name": f"fig9a.adaptnetx_{classes}cls.best_cycles",
                     "value": best_ax[1],
                     "derived": f"at {best_ax[0]} multipliers, model "
                                f"(paper @858cls: 576@512)"})
    d = AdaptNetXDesign()
    rows.append({"name": "fig9.adaptnetx.model_bytes",
                 "value": d.model_bytes(num_classes),
                 "derived": "fits the 512KB ADAPTNETX SRAM (paper §IV-B)"})
    rows.append({"name": "fig9.adaptnetx.latency_us",
                 "value": round(d.cycles(num_classes) / 1000.0, 3),
                 "derived": "@1GHz, model; ~6 orders below software search"})
    return rows


def adaptnetx_workloads(params: Dict, inst, device: torch.device
                        ) -> List[Dict]:
    """One batched ADAPTNETX query per Table-IV workload with a raw net on
    ``device``: the logits, the picks (argmax), the host twin's picks
    (``logits_np``), and the picks' cost-model EDP on the true dims over
    the oracle's (model numbers)."""
    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    out = []
    for name, fn in WORKLOADS.items():
        true = np.array([[l.M, l.K, l.N] for l in fn()], np.int64)
        # the raw net's table ends at 10^4: larger dims query its last row
        ids_np = np.minimum(true, D.MAX_DIM).astype(np.int32)
        ids = torch.as_tensor(ids_np, device=device)
        logits = ops.adaptnetx_recommend(ids, params)     # one batched query
        picks = logits.argmax(-1).cpu().numpy()
        host_picks = np.argmax(A.logits_np(host, ids_np), -1)
        rel = D.relative_performance(inst, true, picks, "edp")
        oracle = cm.best_config(inst, true[:, 0], true[:, 1], true[:, 2],
                                objective="edp")
        out.append({"name": name, "B": len(true), "ids": ids,
                    "logits": logits, "picks": picks,
                    "host_picks": host_picks,
                    "oracle_share": float(np.mean(picks == oracle)),
                    "geomean_rel_edp": float(np.exp(np.mean(np.log(rel))))})
    return out


def sara_gemms(device: torch.device, shapes=QUICKSTART_GEMMS,
               dtype=torch.float32, dispatcher=None) -> List[Dict]:
    """Quickstart part 3: each (M, K, N) through ``SaraDispatcher.gemm``
    (the RSA kernel on CUDA tensors, the plain version on CPU tensors),
    on inputs drawn from a generator seeded 0.  Returns per shape the
    recommendation, the inputs and the output."""
    from repro_torch.core.sara import SaraDispatcher
    d = dispatcher if dispatcher is not None else SaraDispatcher()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = []
    for M, K, N in shapes:
        x = torch.randn((M, K), generator=gen, device=device).to(dtype)
        w = torch.randn((K, N), generator=gen, device=device).to(dtype)
        out.append({"M": M, "K": K, "N": N, "cfg": d.recommend(M, K, N),
                    "x": x, "w": w, "out": d.gemm(x, w)})
    return out


def run(n_samples: int = 400_000, epochs: int = 20,
        instances: Sequence[int] = (12, 13, 14), seed: int = 42,
        device: Optional[str] = None, log: bool = True) -> Dict:
    """a)-g) above.  Returns {"fig3", "fig8" (per instance: adaptnet_on's
    dict), "fig7e", "fig9a", "adaptnetx" (per workload), "gemms",
    "rows"}; the 2^14 instance, where it is among ``instances``, carries
    e) and f)."""
    from repro_torch.models.api import resolve_device
    dev = resolve_device(device)
    out = {"fig3": fig3(log), "fig8": {}, "rows": []}
    for p in instances:
        r = adaptnet_on(p, n_samples, epochs, seed, dev)
        out["fig8"][p] = r
        out["rows"] += emit([fig8_row(r)], log)
        if log:
            print(f"  2^{p}: {n_samples} samples labelled in "
                  f"{r['generate_s']:.1f} s ({r['distinct_labels']} distinct "
                  f"labels of {r['num_classes']}), trained "
                  f"{r['train_s']:.1f} s on {dev}")
    big = out["fig8"].get(14)
    if big is not None:
        out["fig7e"] = emit(fig7e(big["train"], big["test"], big, dev), log)
        out["rows"] += out["fig7e"]
        out["fig9a"] = emit(fig9a_rows(big["num_classes"]), log)
        out["rows"] += out["fig9a"]
        out["adaptnetx"] = adaptnetx_workloads(big["result"].params,
                                               big["inst"], dev)
        rows = [{"name": "fig9c.relative_performance_geomean",
                 "value": round(100.0 / big["geomean_rel_edp"], 3),
                 "derived": "% of oracle EDP, model (paper: 99.93% "
                            "runtime)"}]
        for w in out["adaptnetx"]:
            same = int(np.sum(w["picks"] == w["host_picks"]))
            rows.append({"name": f"adaptnetx.{w['name']}.oracle_share",
                         "value": round(w["oracle_share"], 4),
                         "derived": f"one query of {w['B']} layers; "
                                    f"geomean_rel_edp="
                                    f"{w['geomean_rel_edp']:.5f} (model); "
                                    f"host twin equal at {same} of "
                                    f"{w['B']}"})
        out["rows"] += emit(rows, log)
    from repro_torch.core.sara import SaraDispatcher
    out["gemms"] = sara_gemms(dev)
    plain = SaraDispatcher(execute="torch")
    for g in out["gemms"]:
        want = plain.gemm(g["x"], g["w"], site="sara.gemm.plain")
        g["max_abs_err"] = (g["out"] - want).abs().max().item()
    if log:
        print("=== self-adaptive GEMM dispatch ===")
        route = "kernel" if dev.type == "cuda" else "plain"
        for g in out["gemms"]:
            print(f"GEMM {g['M']}x{g['K']}x{g['N']}: SARA chose "
                  f"[{g['cfg'].describe()}], {route}-vs-plain max err "
                  f"{g['max_abs_err']:.1e}")
    return out


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=400_000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--instances", default="12,13,14",
                    help="comma-separated log2 MAC budgets")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    a = ap.parse_args(argv)
    run(a.samples, a.epochs, [int(p) for p in a.instances.split(",")],
        a.seed, a.device)


if __name__ == "__main__":
    main()
