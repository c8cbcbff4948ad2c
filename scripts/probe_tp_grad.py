"""How far the Megatron ``tp`` step's gradient lies from the one-device
step's, beside how far f32 itself lies from f64, on the card.

  python scripts/probe_tp_grad.py [--arch rwkv6-1.6b] [--layers 4] \
      [--out build/probe_tp_grad.json]

Step 1's gradient of ``chip_smoke.py``'s 18g config of ``--arch`` (full
width cut to ``--layers`` slots, f32, the optimized profile) from
``init(0)`` on phase 18's batch, four ways, each in a process of its own:
the one-device step on the kernels (``kernel``), on the plain versions
(``plain``), on the plain versions in f64 (``f64``: the process rebinds
f32 as ``launch/probe_grad.py`` does), and the ``tp`` step on a (1, 2)
mesh of two gloo ranks on the card (``tp``: the reduced gradient blocks
the step hands ``AdamW.update_``, gathered back to full).  Prints each
run's grad norm and, per leaf, ``|a - b| / |f64|`` for tp and plain
against the kernel run and for each run against f64, and the leaf's
share of the f64 norm; writes them as JSON.  The gradients go through
``build/`` and are deleted.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "probe_tp_grad"
RUNS = ("kernel", "plain", "f64", "tp")


def _setup(arch: str, layers: int):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    cfg = chip_smoke.p18g_cfg(arch, layers)
    toks = torch.from_numpy(chip_smoke.p18_tokens(cfg, 0)).cuda()
    return torch, cfg, {"tokens": toks}


def _save(torch, tree, name: str) -> None:
    from repro_torch.parallel.sharding import _flat_with_path
    torch.save({k: v.double().cpu() for k, v in _flat_with_path(tree)},
               WORK / f"{name}.pt")


def one_device(run: str, arch: str, layers: int) -> None:
    f64 = run == "f64"
    if f64:
        from repro_torch.launch.probe_grad import to_f64_process
        to_f64_process()
    torch, cfg, batch = _setup(arch, layers)
    from repro_torch import dispatch
    from repro_torch.launch.probe_grad import _map
    from repro_torch.models.api import build_model
    model = build_model(cfg, "cuda")
    params = model.init(0)
    if f64:
        params = _map(params, lambda t: t.to(torch.float64))
    leaves = _map(params, lambda t: t.detach().requires_grad_(True))
    with torch.enable_grad(), dispatch.use(
            execute="kernel" if run == "kernel" else "torch"):
        loss, _ = model.loss(leaves, batch)
        loss.backward()
    _save(torch, _map(leaves, lambda t: t.grad), run)


def tp_rank(rank: int, arch: str, layers: int) -> None:
    torch, cfg, batch = _setup(arch, layers)
    import torch.distributed as dist

    from repro_torch import dispatch
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as sh
    init_distributed("cuda", rank=rank, world_size=2,
                     store_path=str(WORK / "store"), backend="gloo",
                     timeout_s=300)
    mesh = make_host_mesh(1, 2, "cuda")
    model, step, opt, (ps, _) = build_train_step(
        cfg, 1e-3, "cuda", mesh=mesh, global_batch=batch["tokens"].shape[0])
    seen = {}
    update_ = opt.update_

    def keep(grads, *args, **kwargs):
        # update_ drops each gradient from the list as it goes
        seen["grads"] = list(grads)
        return update_(grads, *args, **kwargs)
    opt.update_ = keep
    params = sh.shard_tree(model.init(0), ps, mesh)
    paths = tree_leaves(sh._map_with_path(lambda p, _: p, params))
    with dispatch.use(execute="kernel"):
        step(params, opt.init(params), batch)
    grads = dict(zip(paths, seen["grads"]))
    full = sh.gather_tree(sh._map_with_path(lambda p, _: grads[p], params),
                          ps, mesh)
    if rank == 0:
        _save(torch, full, "tp")
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "probe_tp_grad.json"))
    ap.add_argument("--run", choices=RUNS, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run == "tp":
        tp_rank(a.rank, a.arch, a.layers)
        return 0
    if a.run:
        one_device(a.run, a.arch, a.layers)
        return 0
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    from repro_torch.kernels import _build
    _build.build_all()
    me = [sys.executable, __file__, "--arch", a.arch, "--layers",
          str(a.layers)]
    for run in RUNS[:3]:
        subprocess.run(me + ["--run", run], check=True)
    ranks = [subprocess.Popen(me + ["--run", "tp", "--rank", str(r)])
             for r in range(2)]
    if any(p.wait() for p in ranks):
        return 1
    import torch
    g = {run: torch.load(WORK / f"{run}.pt") for run in RUNS}
    shutil.rmtree(WORK)

    def norm(tree):
        return float(sum((v ** 2).sum() for v in tree.values()) ** 0.5)
    whole = norm(g["f64"])
    rec = {"arch": a.arch, "layers": a.layers,
           "grad_norm": {run: norm(g[run]) for run in RUNS}, "leaves": {}}
    pairs = (("tp", "kernel"), ("plain", "kernel"), ("kernel", "f64"),
             ("plain", "f64"), ("tp", "f64"))
    print("grad norms: " + ", ".join(f"{k} {v:.6f}"
                                     for k, v in rec["grad_norm"].items()))
    print(f"{'leaf':28s}" + "".join(f" {x + '-' + y:>12s}" for x, y in pairs)
          + "  share of |f64|")
    for k, ref in g["f64"].items():
        n = float(ref.norm())
        d = {f"{x}-{y}": float((g[x][k] - g[y][k]).norm()) / n
             for x, y in pairs}
        rec["leaves"][k] = dict(d, share=n / whole)
        print(f"{k:28s}" + "".join(f" {v:12.2e}" for v in d.values())
              + f"  {n / whole:.4f}")
    import chip_smoke
    rec["device"] = chip_smoke.nvidia_smi_line()
    print(rec["device"])
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
