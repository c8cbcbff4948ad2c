"""Training launcher — the port of ``repro/launch/train.py`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --optimized --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --optimized --device cpu --steps 3

Trains every served family but vlm and encdec, whose batches carry frontend
features the token loader does not make (they raise before the driver
starts; ``launch.steps.build_train_step`` trains them on such batches).
Uses the full substrate: synthetic pipeline, AdamW, the train step (every
GEMM and its dx/dw through the RSA kernel, attention through the
flash-attention kernels or the blockwise route; rwkv6-1.6b's WKV scan
through its kernel or the plain scan, zamba2-7b's Mamba2 blocks in plain
torch), the fault-tolerant driver with periodic async checkpoints +
restart, straggler monitor.
Over a mesh (a process group is up, the process runs under ``torchrun
--nproc-per-node N``, or ``data_axis`` x ``model_axis`` > 1): a
``(data, model)`` ``DeviceMesh`` over the group (NCCL on CUDA, gloo on
the CPU), the sharded step of ``launch/steps.py`` (FSDP / ZeRO-3 over
``data``, Megatron tensor parallelism over a ``model`` axis > 1 under
the config's ``tp_strategy="tp"``), each rank its rows of the same global
batch (``data/pipeline.py``'s pure ``_batch``), saves gathered to rank
0's files and collective restarts.  Under ``tp`` the recurrent families
(rwkv6, zamba2) compute on a rank's heads, as the attention families do.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --data-axis 2 --model-axis 2 --device cpu --steps 3
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --data-axis 2 --model-axis 2 --device cpu --steps 3 --optimized

The first runs llama's default ``tp``; ``--optimized`` gives llama the
reference's ``dp_all`` where the batch divides the ranks.

``--optimized`` applies the reference's optimized profile
(``attn_impl="pallas"``, the flash kernels; ``ssm_impl="pallas"`` for
rwkv6-1.6b, the WKV kernel); without it the config's
``attn_impl="xla"`` runs attention through the blockwise route (plain
PyTorch, differentiated by autograd), as the reference's does.  The entry
point runs on CUDA unless ``device`` names another device, and raises
where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train_main(arch: str = "llama3.2-1b", preset: str = "reduced",
               steps: int = 50, global_batch: int = 8, seq_len: int = 128,
               data_axis: int = 1, model_axis: int = 1,
               checkpoint_dir: str = DEFAULT_CKPT,
               checkpoint_every: int = 25, lr: float = 1e-3,
               log_every: int = 10, seed: int = 0,
               execute: str = "auto",
               override_cfg=None, fail_injector=None,
               d_model: Optional[int] = None,
               num_layers: Optional[int] = None,
               device: Optional[str] = None):
    import torch.distributed as dist

    from repro_torch import dispatch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import _batch, make_loader
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.steps import _dispatch_ctx, build_train_step
    from repro_torch.models.api import resolve_device
    from repro_torch.models.transformer import check_trained_family
    from repro_torch.runtime.driver import DriverConfig, TrainDriver

    dev = resolve_device(device)
    sharded = dist.is_available() and dist.is_initialized()
    launched = "WORLD_SIZE" in os.environ          # under torchrun
    if not (sharded or launched) and data_axis * model_axis > 1:
        raise ValueError(
            f"a ({data_axis}, {model_axis}) mesh needs "
            f"{data_axis * model_axis} ranks: launch under torchrun "
            f"--nproc-per-node {data_axis * model_axis}")
    cfg = override_cfg if override_cfg is not None else get_arch(arch)
    if preset == "reduced":
        cfg = cfg.reduced()
    if d_model:
        cfg = cfg.replace(d_model=d_model,
                          head_dim=d_model // cfg.num_heads,
                          d_ff=4 * d_model)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                      opt_state_dtype="float32")
    check_trained_family(cfg)     # before the driver, which retries errors
    feats = {"vlm": "patch_embeds", "encdec": "src_features"}.get(cfg.family)
    if feats:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family trains on batches that "
            f"carry {feats!r} beside the tokens, and this launcher's loader "
            f"feeds tokens only, as the reference's does (whose step fails "
            f"on the missing key); build the step with "
            f"launch.steps.build_train_step and pass {feats!r} in its batch")

    own_group = False
    mesh = specs = None
    if sharded or launched or data_axis * model_axis > 1:
        from repro_torch.launch.mesh import init_distributed, make_host_mesh
        from repro_torch.parallel.sharding import local_batch_rows
        if not sharded:
            dev = init_distributed(dev)
            own_group = True
        try:
            mesh = make_host_mesh(data_axis, model_axis, dev.type)
            model, step_fn, opt, (p_specs, o_specs) = build_train_step(
                cfg, lr=lr, device=str(dev), mesh=mesh,
                global_batch=global_batch)
        except Exception:
            if own_group:
                dist.destroy_process_group()
            raise
        specs = {"params": p_specs, "opt": o_specs}
        row_start, rows, _ = local_batch_rows(global_batch, cfg, mesh)
    else:
        model, step_fn, opt = build_train_step(cfg, lr=lr, device=str(dev))
        row_start, rows = 0, None
    params = model.init(seed)
    if mesh is not None:
        from repro_torch.parallel.sharding import shard_tree
        params = shard_tree(params, specs["params"], mesh)
    opt_state = opt.init(params)
    lead = mesh is None or dist.get_rank() == 0

    # each rank its rows of the pure global batch of (seed, step, row)
    loader = make_loader(cfg.vocab_size, seq_len, global_batch, seed=seed,
                         row_start=row_start, rows=rows)

    def make_batch(step: int):
        # the prefetching loader in order; a restart replays the steps
        # since its checkpoint from the pure function of (cfg, step)
        arr = next(loader) if step == loader.step else _batch(loader.cfg,
                                                               step)
        return {"tokens": torch.from_numpy(arr["tokens"]).to(dev)}

    registry = dispatch.SiteRegistry()

    def wrapped_step(params, opt_state, batch):
        # the sharded step sets the ambient mesh itself
        with _dispatch_ctx("train_step", execute, registry):
            return step_fn(params, opt_state, batch)

    driver = TrainDriver(
        DriverConfig(checkpoint_dir=checkpoint_dir,
                     checkpoint_every=checkpoint_every),
        train_step=wrapped_step, make_batch=make_batch,
        fail_injector=fail_injector, mesh=mesh, specs=specs)

    t0 = time.time()
    try:
        params, opt_state, history = driver.run(params, opt_state,
                                                start_step=0,
                                                num_steps=steps)
        if mesh is not None:
            from repro_torch.parallel.sharding import gather_tree
            params = gather_tree(params, specs["params"], mesh)
    finally:
        loader.close()
        if own_group:
            dist.destroy_process_group()
    dt = time.time() - t0
    losses = [h["loss"] for h in history]
    if not lead:
        log_every = 0
    if log_every:
        for h in history[::log_every] + history[-1:]:
            print(f"  step {h['step']:5d} loss {h['loss']:.4f} "
                  f"grad_norm {h.get('grad_norm', 0):.3f}")
    tok_s = steps * global_batch * seq_len / dt
    if not lead:
        driver.opt_state = opt_state
        return params, history, driver
    where = dev if mesh is None else \
        f"{dict(mesh_axis_sizes(mesh))} ranks of {dev.type}"
    print(f"train done: {steps} steps in {dt:.1f}s ({tok_s:,.0f} tok/s on "
          f"{where}), loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"{driver.straggler_report()}")
    plan = registry.plan("train_step")
    if plan:
        print(f"  dispatch: {len(plan)} GEMM sites executed "
              f"({dict(registry.backends('train_step'))})")
    driver.opt_state = opt_state       # the final state rides on the driver
    return params, history, driver


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--optimized", action="store_true",
                    help="apply the arch's optimized profile (the flash-"
                         "attention kernels)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--execute", default="auto",
                    choices=["auto", "kernel", "torch"],
                    help="kernel or plain PyTorch versions (auto: kernels "
                         "for CUDA tensors)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    a = ap.parse_args()
    override = None
    if a.optimized:
        # the reference's rule: a dp_all layout applies where the global
        # batch divides the ranks
        from repro_torch.configs.registry import get_arch
        world = int(os.environ.get("WORLD_SIZE",
                                   a.data_axis * a.model_axis))
        override = get_arch(a.arch, optimized=True, global_batch=a.batch,
                            devices=world)
    train_main(arch=a.arch, preset=a.preset, steps=a.steps,
               global_batch=a.batch, seq_len=a.seq, data_axis=a.data_axis,
               model_axis=a.model_axis, lr=a.lr, checkpoint_dir=a.ckpt,
               execute=a.execute, override_cfg=override, device=a.device)


if __name__ == "__main__":
    main()
