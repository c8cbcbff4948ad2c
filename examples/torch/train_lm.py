"""Training example on the port: LM through the fault-tolerant substrate.

  PYTHONPATH=src python examples/torch/train_lm.py                 # ~8M
  PYTHONPATH=src python examples/torch/train_lm.py --preset 100m \\
      --steps 300                         # 131M params, on the card
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 6

The port's counterpart of ``examples/train_lm.py``, with its presets and
flags: every GEMM and its dx / dw on the RSA kernel, attention on the
blockwise route, f32.  ``--inject-failure`` raises a simulated preemption
at step ``steps // 2``; ``TrainDriver`` restores its latest checkpoint and
carries on.  Runs on CUDA unless ``--device cpu`` is given; without CUDA
it raises.  ``main`` returns the config, the final params, the loss
history, the ``TrainDriver`` (its ``restarts``) and the steps a failure
fired at.
"""
import argparse
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch.train import train_main  # noqa: E402

PRESETS = {
    # name: (d_model, layers, vocab, seq, batch)
    "8m":   (256, 6, 8192, 128, 8),
    "25m":  (512, 8, 8192, 128, 8),
    "100m": (768, 12, 32000, 256, 8),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="8m", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(),
                                         "train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    a = ap.parse_args(argv)

    d, L, V, S, B = PRESETS[a.preset]
    cfg = get_arch("llama3.2-1b").reduced().replace(
        d_model=d, num_layers=L, vocab_size=V,
        num_heads=8, num_kv_heads=4, head_dim=d // 8, d_ff=4 * d,
        attn_chunk=128, loss_chunk=128)

    fired = []
    injector = None
    if a.inject_failure:
        def injector(step):
            if step == a.steps // 2 and not fired:
                fired.append(step)
                raise RuntimeError("simulated preemption")

    from repro_torch.models.api import build_model
    print(f"training ~{build_model(cfg, a.device).num_params()/1e6:.0f}M-"
          f"param LM for {a.steps} steps (seq={S}, batch={B})")
    params, history, driver = train_main(
        override_cfg=cfg, preset="as-is", steps=a.steps,
        global_batch=B, seq_len=S, checkpoint_dir=a.ckpt,
        checkpoint_every=max(10, a.steps // 6),
        log_every=max(1, a.steps // 10),
        fail_injector=injector, device=a.device)
    return {"cfg": cfg, "params": params, "history": history,
            "driver": driver, "fired": fired}


if __name__ == "__main__":
    main()
