"""Quickstart — a five-minute tour of the SARA framework on the port.

  PYTHONPATH=src python examples/torch/quickstart.py               # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu

The port's counterpart of ``examples/quickstart.py``:

1. The RSA cost model reproduces the paper's motivating trade-off (Fig. 3).
2. ADAPTNET learns the configuration space in seconds.
3. The SARA dispatcher picks a tile config per GEMM and runs it through
   the RSA GEMM kernel (``SaraDispatcher.gemm``; the plain version on the
   CPU).
4. A reduced LM trains a few steps through the full training substrate
   (``launch.train.train_main``).

Runs on CUDA unless ``--device cpu`` is given; without CUDA it raises.
``--ckpt`` places part 4's checkpoints.  ``main`` returns each part's
results.
"""
import argparse
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402


def part1_cost_model():
    print("\n=== 1. RSA cost model (paper Fig. 3) ===")
    from repro_torch.core import costmodel as cm
    from repro_torch.core.hw import OS
    from repro_torch.core.rsa import SAGAR_INSTANCE
    M, K, N = 256, 64, 256
    mono = cm.monolithic_cost(M, K, N, 128, 128, OS)
    dist = cm.distributed_cost(M, K, N, 32, 32, 16, OS)
    rsa = cm.oracle_runtime(SAGAR_INSTANCE, [M], [K], [N])[0]
    print(f"monolithic 128x128 : {float(mono.runtime):6.0f} cycles, "
          f"{float(mono.sram_reads):8.0f} reads")
    print(f"distributed 16x32x32: {float(dist.runtime):6.0f} cycles "
          f"({float(mono.runtime/dist.runtime):.2f}x), "
          f"{float(dist.sram_reads):8.0f} reads "
          f"({float(dist.sram_reads/mono.sram_reads):.1f}x)")
    print(f"RSA best config    : {rsa:6.0f} cycles "
          f"({float(mono.runtime)/rsa:.2f}x) at monolithic-level reads")
    return {"monolithic_cycles": float(mono.runtime),
            "monolithic_reads": float(mono.sram_reads),
            "distributed_cycles": float(dist.runtime),
            "distributed_reads": float(dist.sram_reads),
            "rsa_best_cycles": float(rsa)}


def part2_adaptnet(samples=30_000, epochs=4, device=None):
    print("\n=== 2. ADAPTNET learns the config space ===")
    from repro_torch.core import adaptnet as A, dataset as D
    ds = D.generate(samples, seed=0)
    tr, te = ds.split()
    res = A.train(tr, te, epochs=epochs, log=False, device=device)
    print(f"test accuracy after {epochs} epochs on {len(tr.labels) // 1000}k "
          f"samples: {res.test_accuracy:.1%} (paper-scale training reaches "
          f"~90%+)")
    return res


def part3_sara_gemm(device=None):
    print("\n=== 3. Self-adaptive GEMM dispatch ===")
    from repro_torch.core.sara import SaraDispatcher
    from repro_torch.models.api import resolve_device
    dev = resolve_device(device)
    d = SaraDispatcher()
    rows = []
    for i, (M, K, N) in enumerate([(512, 512, 512), (128, 8000, 128)]):
        cfg = d.recommend(M, K, N)
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev)
        out = d.gemm(x, w)
        err = float((out - torch.matmul(x, w)).abs().max())
        print(f"GEMM {M}x{K}x{N}: SARA chose [{cfg.describe()}], "
              f"{'kernel' if dev.type == 'cuda' else 'plain'}-vs-matmul max "
              f"err {err:.1e}")
        rows.append({"M": M, "K": K, "N": N, "cfg": cfg, "max_abs_err": err})
    return rows


def part4_train(steps=15, checkpoint_dir=None, device=None):
    print("\n=== 4. Reduced LM through the full training substrate ===")
    from repro_torch.launch.train import train_main
    return train_main(arch="llama3.2-1b", steps=steps, global_batch=8,
                      seq_len=64, checkpoint_dir=checkpoint_dir or
                      os.path.join(tempfile.gettempdir(), "quickstart_ckpt"),
                      log_every=5, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="part 4's checkpoint directory (default: "
                         "quickstart_ckpt in the temp directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    a = ap.parse_args(argv)
    from repro_torch.models.api import resolve_device
    resolve_device(a.device)          # no CUDA and no --device cpu: raise
    return {"part1": part1_cost_model(),
            "part2": part2_adaptnet(device=a.device),
            "part3": part3_sara_gemm(a.device),
            "part4": part4_train(checkpoint_dir=a.ckpt, device=a.device)}


if __name__ == "__main__":
    main()
