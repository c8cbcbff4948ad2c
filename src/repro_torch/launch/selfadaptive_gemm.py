"""Self-adaptive GEMM — the paper's loop end to end, the port of the
reference's ``examples/selfadaptive_gemm.py``:

  PYTHONPATH=src python -m repro_torch.launch.selfadaptive_gemm
  PYTHONPATH=src python -m repro_torch.launch.selfadaptive_gemm \\
      --device cpu --samples 6000 --epochs 2 --layers 3

For the first layers of the paper's synthetic Table-IV set:

  1. a raw-encoding ADAPTNET-TPU is trained on the tile-config space
     (``core.sara.train_adaptnet_tpu``);
  2. each GEMM's (M, K, N), clamped to 10^4, goes through one ADAPTNETX
     query (``kernels.ops.adaptnetx_recommend``: the hand-written kernel
     on the card, its plain version on the CPU) and the argmax picks the
     tile;
  3. the GEMM runs through the RSA GEMM (``kernels.ops.rsa_gemm``) with
     that tile on f32 inputs;
  4. each layer's tile, the executed GEMM's time on the card (CUDA
     events; not measured on the CPU) and the pick of the host twin
     ``logits_np`` for the same ids are printed.

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import tpu_costmodel as tcm
from repro_torch.core import workloads as W
from repro_torch.core.adaptnet import MAX_DIM, logits_np
from repro_torch.core.sara import train_adaptnet_tpu
from repro_torch.kernels import ops


def _gemm_ms(fn, dev: torch.device, reps: int = 5) -> Optional[float]:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    between CUDA events; None off the card."""
    if dev.type != "cuda":
        return None
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def run(n_samples: int = 60_000, epochs: int = 8, layers: int = 10,
        seed: int = 0, device: Optional[str] = None,
        log: bool = True) -> Dict:
    """Train, then recommend and run each layer's GEMM.  Returns {"params",
    "accuracy", "geomean_rel_time" (the TPU cost model's, not a
    measurement), "layers": [per layer: name, M, K, N, ids, logits, cid,
    host_cid, cfg, a, b, out, ms]}."""
    from repro_torch.models.api import resolve_device
    dev = resolve_device(device)
    if log:
        print("training ADAPTNET-TPU on the tile-config space ...")
    params, acc, geo = train_adaptnet_tpu(n_samples=n_samples, epochs=epochs,
                                          seed=seed, device=str(dev))
    if log:
        print(f"  accuracy={acc:.1%}  geomean rel-time={geo:.4f} (TPU cost "
              f"model)\n")
        print(f"{'GEMM':>18} {'ADAPTNETX choice':>28} {'class':>5} "
              f"{'host twin':>9} {'gemm ms':>12}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for layer in W.synthetic_g()[:layers]:
        key = [min(layer.M, MAX_DIM), min(layer.K, MAX_DIM),
               min(layer.N, MAX_DIM)]
        ids = torch.tensor(key, dtype=torch.int32, device=dev)
        logits = ops.adaptnetx_recommend(ids, params)   # one fused query
        cid = int(torch.argmax(logits))
        host_cid = int(np.argmax(logits_np(params, np.array([key])), -1)[0])
        cfg = tcm.TILE_CONFIGS[cid]
        a = torch.randn((layer.M, layer.K), generator=gen, device=dev)
        b = torch.randn((layer.K, layer.N), generator=gen, device=dev)

        def gemm():
            return ops.rsa_gemm(a, b, block_m=cfg.block_m,
                                block_n=cfg.block_n, block_k=cfg.block_k,
                                mode=cfg.mode)
        out = gemm()
        if out.shape != (layer.M, layer.N):
            raise RuntimeError(f"{layer.name}: GEMM gave {tuple(out.shape)}")
        ms = _gemm_ms(gemm, dev)
        rows.append({"name": layer.name, "M": layer.M, "K": layer.K,
                     "N": layer.N, "ids": ids, "logits": logits, "cid": cid,
                     "host_cid": host_cid, "cfg": cfg, "a": a, "b": b,
                     "out": out, "ms": ms})
        if log:
            t = "not measured" if ms is None else f"{ms:.4f}"
            print(f"{layer.name:>6} {layer.M:>4}x{layer.K:>4}x{layer.N:>4} "
                  f"{cfg.describe():>28} {cid:>5} {host_cid:>9} {t:>12}")
    return {"params": params, "accuracy": acc, "geomean_rel_time": geo,
            "layers": rows}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=60_000)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    a = ap.parse_args(argv)
    res = run(a.samples, a.epochs, a.layers, a.seed, a.device)
    same = sum(r["cid"] == r["host_cid"] for r in res["layers"])
    print(f"\nADAPTNETX and the host twin pick the same tile on {same} of "
          f"{len(res['layers'])} layers")
    return res


if __name__ == "__main__":
    main()
