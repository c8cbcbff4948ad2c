"""Megatron tensor parallelism over the ``model`` axis (``parallel/tp.py``)
and MoE on a batch-sharded mesh, held to the port's one-device step on the
CPU over gloo.

The reference's own ``tp`` step does not run on this JAX (ROADMAP §3: its
``model.loss`` under ``use_mesh(make_host_mesh(d, m), "tp")`` raises
``ShardingTypeError`` at ``_embed``'s gather), so, as for FSDP in
``test_torch_train_sharded.py``, the chain is: the ``tp`` step equals the
port's one-device step, which ``test_torch_train*.py`` hold against the
reference.  The attention half has a module-level reference that runs:
the reference's per-shard flash (``_flash_pallas_sharded``, the Pallas
kernel in interpret mode under ``shard_map`` over heads on ``model``).

Setup: each arch's reduced preset in f32 with the flash route
(``attn_impl="pallas"``; 4 heads, 2 kv heads but gemma-2b's 1, d 64, hd
16, vocab 512, 8 experts padded to 16), a seeded global batch of 8 x 33
tokens (and 8 patch rows or 8 source frames of 24 features for vlm /
encdec), 3 steps at lr 1e-3 from ``init(0)``.  One spawn of 4 gloo
ranks (a ``FileStore``, a 60 s group timeout, joined by a deadline and
killed past it) runs every case: first over a group of 4, then as two
groups of 2 (ranks 0-1 and 2-3, each on a store of its own) for the
(1, 2) meshes.

- ``tp`` steps: llama3.2-1b on (1, 2), (2, 2) and (1, 4) (on (1, 4) its
  2 kv heads do not divide the axis, so K/V are gathered and each rank
  keeps the kv head its query head uses); gemma-2b on (1, 2) (one kv
  head, tied embeddings); internvl2-76b and seamless-m4t-medium on (1, 2);
  qwen2-moe-a2.7b (``tp``) and deepseek-v3-671b on (1, 2) and (2, 2).
  MoE on a batch-sharded mesh: qwen2-moe ``dp_all_noep`` on (2, 2),
  deepseek-v3 ``tp`` on (4, 1).  Each step's loss within rtol 2e-4 of
  the one-device step's; each gathered leaf within
  ``test_torch_train_sharded.py``'s rule (the larger of 1e-4 of its
  largest magnitude and 2e-3 of the largest travel from the init) at
  99.9% of its elements at least, and every element within 2 lr a step:
  AdamW's first update is about lr times the sign of each gradient entry,
  so an entry whose terms cancel can move by up to 2 lr the other way when
  the ranks sum it in another order (gemma-2b's ``layers/mlp/w_gate`` has
  one such element of 16384 on (1, 2)), and qwen2-moe's key bias, whose
  gradient is zero but for rounding (``test_torch_train_moe.py``'s
  ``NOISE_LEAVES``), walks by the sign of rounding noise on every element.
  Step 1's ``moe_lb_loss`` and ``moe_z_loss`` within rtol 1e-5 of the
  one-device step's and ``moe_drop_frac`` within 1e-7; step 1's grad norm
  within rtol 1e-4 (a leaf's gradient at a wrong scale moves it, where
  AdamW's first step moves the weights by the gradient's sign alone).
- Every attention and MoE arch of the registry builds and runs one step
  on (1, 2), (2, 2) and (4, 1) at its reduced preset (the registry's
  ``tp``): step 1's loss within rtol 2e-4 of the one-device step's.
- The flash output on each rank's heads equals the head slice of the
  reference's ``_flash_pallas_sharded`` on a (1, 2) host mesh within
  1e-5, with 2 kv heads (cut over ``model``) and with 1 (gathered; the
  reference replicates the heads).  The reference's side runs in a
  subprocess of the test (the host device count is set before JAX
  loads) and is handed to the ranks as arrays.
- ``sharding.tp_use`` on (1, 2) and (1, 4) without ranks: which leaves a
  rank computes on its block of, which it uses in part, which whole (the
  recurrent families' rows too; their steps are
  ``test_torch_train_tp_ssm.py``'s).
- ``train_main`` on (2, 2) under ``tp`` for llama against ``train_main``
  on one process; its step-3 checkpoint (``tp`` blocks, gathered by
  ``save_sharded``) restored onto (4, 1) ``dp_all`` on the ranks and onto
  (1, 1) here, bit for bit.

The one-rank ``tp`` step's bit-for-bit equality with the unsharded step is
``test_torch_train_sharded.py::test_one_rank_sharded_step_is_the_unsharded
_step[tp]``.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
B, S, STEPS, LR = 8, 32, 3, 1e-3
N_FRONT = 8                     # patch rows (vlm) / source frames (encdec)

# name: (arch, tp_strategy, data, model)
STEP_CASES = {
    "llama-tp-1x2": ("llama3.2-1b", "tp", 1, 2),
    "llama-tp-2x2": ("llama3.2-1b", "tp", 2, 2),
    "llama-tp-1x4": ("llama3.2-1b", "tp", 1, 4),
    "gemma-tp-1x2": ("gemma-2b", "tp", 1, 2),
    "internvl2-tp-1x2": ("internvl2-76b", "tp", 1, 2),
    "seamless-tp-1x2": ("seamless-m4t-medium", "tp", 1, 2),
    "qwen2-tp-1x2": ("qwen2-moe-a2.7b", "tp", 1, 2),
    "qwen2-tp-2x2": ("qwen2-moe-a2.7b", "tp", 2, 2),
    "deepseek-tp-1x2": ("deepseek-v3-671b", "tp", 1, 2),
    "deepseek-tp-2x2": ("deepseek-v3-671b", "tp", 2, 2),
    "qwen2-noep-2x2": ("qwen2-moe-a2.7b", "dp_all_noep", 2, 2),
    "deepseek-tp-4x1": ("deepseek-v3-671b", "tp", 4, 1),
}
ARCHS = ("llama3.2-1b", "gemma-2b", "deepseek-coder-33b",
         "command-r-plus-104b", "internvl2-76b", "seamless-m4t-medium",
         "qwen2-moe-a2.7b", "deepseek-v3-671b")
MESHES = ((1, 2), (2, 2), (4, 1))
AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
# (num_heads, num_kv_heads) of the flash cases
FLASH = ((4, 2), (4, 1))
FLASH_B, FLASH_S, FLASH_HD = 2, 40, 16

WORKER = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], Path(sys.argv[4])
    sys.path.insert(0, sys.argv[5])
    import test_torch_train_tp as T
    from repro_torch.checkpoint import load_checkpoint, restore_resharded
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.train import train_main
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import sharding as sh
    res = {}

    def run_steps(names, meshes):
        for name in names:
            arch, strategy, d, m = T.STEP_CASES[name]
            cfg = T.tiny(arch, strategy)
            params, specs, losses, aux = T.sharded_run(cfg, meshes(d, m),
                                                       STEPS)
            res[name] = {"losses": losses, "aux": aux}
            full = sh.gather_tree(params, specs, meshes(d, m))
            if sh.coordinate(meshes(d, m)) == {"data": 0, "model": 0}:
                np.savez(out / f"{name}.npz", **T.flat_np(full))

    def run_registry(archs, d, m, meshes):
        for arch in archs:
            _, _, losses, _ = T.sharded_run(T.tiny(arch, "tp"),
                                            meshes(d, m), 1)
            res[f"registry-{arch}-{d}x{m}"] = losses

    STEPS = T.STEPS
    init_distributed("cpu", rank=rank, world_size=world, store_path=store,
                     timeout_s=60)
    made = {}

    def mesh(d, m):
        if (d, m) not in made:
            made[(d, m)] = make_host_mesh(d, m)
        return made[(d, m)]

    run_steps([n for n, c in T.STEP_CASES.items() if c[2] * c[3] == 4],
              mesh)
    for d, m in ((2, 2), (4, 1)):
        run_registry(T.ARCHS, d, m, mesh)
    # train_main under tp on (2, 2); its step-3 checkpoint onto (4, 1)
    # dp_all
    ck = out / "ckpt-main-tp"
    params, history, driver = train_main(
        override_cfg=T.tiny("llama3.2-1b", "tp"), preset="full",
        steps=T.STEPS, global_batch=T.B, seq_len=T.S, data_axis=2,
        model_axis=2, checkpoint_dir=str(ck), checkpoint_every=1, lr=T.LR,
        log_every=0, seed=0, device="cpu")
    res["main-tp"] = {"losses": [h["loss"] for h in history],
                      "steps": [h["step"] for h in history],
                      "restarts": driver.restarts}
    if rank == 0:
        np.savez(out / "main-tp.npz", **T.flat_np(params))
    cfg41 = T.tiny("llama3.2-1b", "dp_all")
    ps = sh.param_specs(T.model_of(cfg41).init_abstract(), cfg41,
                        mesh(4, 1))
    specs41 = {"params": ps, "opt": AdamWState(step=sh.P(), m=ps, v=ps)}
    tgt = {"params": params, "opt": driver.opt_state}
    step, local, _ = restore_resharded(ck, tgt, mesh(4, 1), specs41)
    got = T.flat_np(sh.gather_tree(local, specs41, mesh(4, 1)))
    _, flat, _ = load_checkpoint(ck)
    res["reshard-4x1"] = {
        "step": step, "keys": sorted(got) == sorted(flat),
        "bitwise": all(np.array_equal(got[k], flat[k]) for k in flat)}
    dist.barrier()
    dist.destroy_process_group()

    # two groups of 2 for the (1, 2) meshes, each on a store of its own
    half, pair = rank // 2, rank % 2
    init_distributed("cpu", rank=pair, world_size=2,
                     store_path=f"{store}-pair{half}", timeout_s=60)
    made.clear()
    names = [n for n, c in T.STEP_CASES.items() if c[2] * c[3] == 2]
    run_steps(names[half::2], mesh)
    run_registry(T.ARCHS[half::2], 1, 2, mesh)
    res["flash"] = T.flash_on_ranks(mesh(1, 2), out / "flash_ref.npz")
    dist.barrier()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
""")

REF_FLASH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_host_mesh
    from repro.models.attention import _flash_pallas_sharded
    from repro.parallel.hints import use_mesh
    inp = dict(np.load(sys.argv[2]))
    out = {}
    with use_mesh(make_host_mesh(1, 2), "tp"):
        for h, kvh in ((4, 2), (4, 1)):
            q, k, v = (jnp.asarray(inp[f"{n}-{h}-{kvh}"]) for n in "qkv")
            out[f"o-{h}-{kvh}"] = np.asarray(_flash_pallas_sharded(
                q, k, v, causal=True, chunk=16))
    np.savez(sys.argv[3], **out)
""")


def tiny(arch, strategy):
    from repro_torch.configs.registry import get_arch
    return get_arch(arch).reduced().replace(
        param_dtype="float32", compute_dtype="float32",
        opt_state_dtype="float32", tp_strategy=strategy, attn_impl="pallas")


def model_of(cfg):
    from repro_torch.models.api import build_model
    return build_model(cfg, "cpu")


def batch_np(cfg, step):
    """Step ``step``'s seeded global batch: tokens and the family's
    frontend features."""
    rng = np.random.default_rng(100 + step)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1))
           .astype(np.int32)}
    key = {"vlm": "patch_embeds", "encdec": "src_features"}.get(cfg.family)
    if key:
        out[key] = rng.standard_normal(
            (B, N_FRONT, cfg.frontend.feature_dim)).astype(np.float32)
    return out


def flat_np(tree):
    from repro_torch.parallel.sharding import _flat_with_path
    return {p: t.detach().cpu().numpy() for p, t in _flat_with_path(tree)}


def _aux(m):
    """Step 1's aux metrics and grad norm (the norm shows a gradient's
    scale, which AdamW's normalised first step hides from the weights)."""
    return {k: float(m[k]) for k in AUX + ("grad_norm",)}


def sharded_run(cfg, mesh, steps):
    """``steps`` steps of the sharded step on this rank's rows; (local
    params, param specs, losses, step 1's aux metrics)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.parallel import sharding as sh
    model, step, opt, (ps, _) = build_train_step(
        cfg, LR, "cpu", mesh=mesh, global_batch=B)
    params = sh.shard_tree(model.init(0), ps, mesh)
    opt_state = opt.init(params)
    r0, rows, _ = sh.local_batch_rows(B, cfg, mesh)
    losses, aux = [], None
    for s in range(steps):
        batch = {k: torch.from_numpy(v[r0:r0 + rows])
                 for k, v in batch_np(cfg, s).items()}
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        aux = aux or _aux(m)
    return params, ps, losses, aux


def unsharded_run(cfg, steps):
    from repro_torch.launch.steps import build_train_step
    model, step, opt = build_train_step(cfg, LR, "cpu")
    init = model.init(0)
    params, opt_state = init, opt.init(init)
    losses, aux = [], None
    for s in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, s).items()}
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        aux = aux or _aux(m)
    return flat_np(init), flat_np(params), losses, aux


def flash_inputs():
    rng = np.random.default_rng(7)
    out = {}
    for h, kvh in FLASH:
        for n, heads in (("q", h), ("k", kvh), ("v", kvh)):
            out[f"{n}-{h}-{kvh}"] = rng.standard_normal(
                (FLASH_B, FLASH_S, heads, FLASH_HD)).astype(np.float32)
    return out


def flash_on_ranks(mesh, ref_path):
    """Each case's largest difference between this rank's flash output on
    its heads and the reference's head slice: q's block of heads, K/V's
    block where the kv heads divide the axis, else the whole K/V (as a
    gathered leaf gives them) with ``kv_for_heads`` keeping this rank's."""
    from repro_torch.models.attention import multihead_attention
    from repro_torch.parallel import tp as tp_mod
    from repro_torch.parallel.hints import use_mesh
    inp, ref = flash_inputs(), dict(np.load(ref_path))
    out = {}
    with use_mesh(mesh):
        tp = tp_mod.context(tiny("llama3.2-1b", "tp"))
        for h, kvh in FLASH:
            q, k, v = (torch.from_numpy(inp[f"{n}-{h}-{kvh}"])
                       for n in "qkv")
            hl = h // tp.size
            q = q[:, :, tp.rank * hl:(tp.rank + 1) * hl]
            if kvh % tp.size == 0:
                kl = kvh // tp.size
                k, v = (t[:, :, tp.rank * kl:(tp.rank + 1) * kl]
                        for t in (k, v))
            k, v = (tp_mod.kv_for_heads(t, h, kvh, tp) for t in (k, v))
            o = multihead_attention(q, k, v, causal=True, chunk=16,
                                    impl="pallas")
            want = ref[f"o-{h}-{kvh}"][:, :, tp.rank * hl:(tp.rank + 1) * hl]
            out[f"{h}-{kvh}"] = {
                "shape": list(o.shape),
                "max_err": float(np.abs(o.numpy() - want).max())}
    return out


def _spawn(code, world, tmp, *args, deadline=400.0):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    store = str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), store, *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    t0, logs = time.time(), []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - (time.time() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        lg[-3000:] for lg in logs)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    np.savez(out / "flash_in.npz", **flash_inputs())
    proc = subprocess.run(
        [sys.executable, "-c", REF_FLASH, str(SRC), str(out / "flash_in.npz"),
         str(out / "flash_ref.npz")], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    _spawn(WORKER, 4, out, str(out), str(Path(__file__).resolve().parent))
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    return out, res


_UNSHARDED = {}


def unsharded(arch, strategy, steps=STEPS):
    key = (arch, strategy, steps)
    if key not in _UNSHARDED:
        _UNSHARDED[key] = unsharded_run(tiny(arch, strategy), steps)
    return _UNSHARDED[key]


def assert_close_to(got: dict, init: dict, want: dict):
    """Every leaf within the rule of the module docstring."""
    assert sorted(got) == sorted(want)
    travel = max(np.abs(want[k] - init[k]).max() for k in want)
    assert travel > 0
    for k in want:
        assert got[k].shape == want[k].shape, k
        diff = np.abs(got[k] - want[k])
        tol = max(1e-4 * np.abs(want[k]).max(), 2e-3 * travel)
        if k != "layers/attn/bk":
            assert (diff <= tol).mean() >= 0.999, (k, diff.max(), tol)
        assert diff.max() <= 2 * LR * STEPS, k


def _ranks(case):
    """The ranks that ran ``case``: all 4, or the group of 2 whose half of
    the (1, 2) cases holds it."""
    d, m = STEP_CASES[case][2:]
    if d * m == 4:
        return [0, 1, 2, 3]
    names = [n for n, c in STEP_CASES.items() if c[2] * c[3] == 2]
    return [0, 1] if names.index(case) % 2 == 0 else [2, 3]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tp_step_is_the_one_device_step(spawned, case):
    out, res = spawned
    arch, strategy, d, m = STEP_CASES[case]
    ranks = _ranks(case)
    init, want, want_losses, want_aux = unsharded(arch, strategy)
    for r in ranks:                      # every rank reports the same loss
        assert res[r][case]["losses"] == res[ranks[0]][case]["losses"]
    np.testing.assert_allclose(res[ranks[0]][case]["losses"], want_losses,
                               rtol=2e-4)
    assert res[ranks[0]][case]["aux"]["grad_norm"] == pytest.approx(
        want_aux["grad_norm"], rel=1e-4)
    assert_close_to(dict(np.load(out / f"{case}.npz")), init, want)
    if arch in ("qwen2-moe-a2.7b", "deepseek-v3-671b"):
        got = res[ranks[0]][case]["aux"]
        for k in ("moe_lb_loss", "moe_z_loss"):
            assert got[k] == pytest.approx(want_aux[k], rel=1e-5), k
        assert abs(got["moe_drop_frac"] - want_aux["moe_drop_frac"]) <= 1e-7


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_every_attention_arch_steps_on_the_mesh(spawned, arch, mesh):
    _, res = spawned
    d, m = mesh
    key = f"registry-{arch}-{d}x{m}"
    if d * m == 4:
        ranks = range(4)
    else:
        ranks = range(2) if ARCHS.index(arch) % 2 == 0 else range(2, 4)
    _, _, want, _ = unsharded(arch, "tp", 1)
    for r in ranks:
        assert res[r][key] == res[ranks[0]][key]
        assert np.isfinite(res[r][key]).all()
    np.testing.assert_allclose(res[ranks[0]][key], want, rtol=2e-4)


@pytest.mark.parametrize("heads", FLASH, ids=lambda h: f"{h[0]}-{h[1]}")
def test_flash_on_local_heads_is_the_reference_shard(spawned, heads):
    _, res = spawned
    h, kvh = heads
    for r in range(4):
        got = res[r]["flash"][f"{h}-{kvh}"]
        assert got["shape"] == [FLASH_B, FLASH_S, h // 2, FLASH_HD]
        assert got["max_err"] <= 1e-5, (r, got)


def test_train_main_under_tp(spawned, tmp_path):
    from repro_torch.launch.train import train_main
    out, res = spawned
    cfg = tiny("llama3.2-1b", "tp")
    init = flat_np(model_of(cfg).init(0))
    params, history, driver = train_main(
        override_cfg=cfg, preset="full", steps=STEPS, global_batch=B,
        seq_len=S, checkpoint_dir=str(tmp_path), checkpoint_every=10,
        lr=LR, log_every=0, seed=0, device="cpu")
    assert driver.restarts == 0
    for r in range(4):
        assert res[r]["main-tp"]["steps"] == list(range(STEPS))
        assert res[r]["main-tp"]["restarts"] == 0
    np.testing.assert_allclose(res[0]["main-tp"]["losses"],
                               [h["loss"] for h in history], rtol=2e-4)
    assert_close_to(dict(np.load(out / "main-tp.npz")), init,
                    flat_np(params))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    tmp = tmp_path_factory.mktemp("world1")
    init_distributed("cpu", rank=0, world_size=1,
                     store_path=str(tmp / "store"), timeout_s=30)
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_tp_checkpoint_restores_on_other_meshes(spawned, world1):
    """(2, 2) tp -> (4, 1) dp_all on the ranks, -> (1, 1) here, bit for
    bit; the file holds the (2, 2) run's gathered parameters."""
    from repro_torch.checkpoint import load_checkpoint, restore_resharded
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import sharding as sh
    out, res = spawned
    for r in range(4):
        r41 = res[r]["reshard-4x1"]
        assert r41["step"] == STEPS and r41["keys"] and r41["bitwise"], r
    cfg = tiny("llama3.2-1b", "tp")
    model = model_of(cfg)
    params = model.init(1)
    ps = sh.param_specs(model.init_abstract(), cfg, world1)
    tgt = {"params": params,
           "opt": AdamWState(step=torch.zeros((), dtype=torch.int32),
                             m=params, v=params)}
    specs = {"params": ps, "opt": AdamWState(step=sh.P(), m=ps, v=ps)}
    ck = out / "ckpt-main-tp"
    step, tree, _ = restore_resharded(ck, tgt, world1, specs)
    _, flat, _ = load_checkpoint(ck)
    got = flat_np(tree)
    assert step == STEPS and sorted(got) == sorted(flat)
    for k in flat:
        assert np.array_equal(got[k], flat[k]), k
    for k, v in np.load(out / "main-tp.npz").items():
        assert np.array_equal(flat[f"params/{k}"], v), k


class FakeMesh:
    axis_names = ("data", "model")

    def __init__(self, d, m):
        self.devices = np.empty((d, m), dtype=object)


# arch, model axis, {leaf: use}
USES = [
    ("llama3.2-1b", 2, {"embed": "local", "layers/attn/wq": "local",
                        "layers/attn/wk": "local", "layers/attn/wo": "local",
                        "layers/mlp/w_down": "local", "layers/ln1": "whole",
                        "ln_f": "whole"}),
    ("llama3.2-1b", 4, {"layers/attn/wq": "local", "layers/attn/wk": "part",
                        "layers/attn/wv": "part"}),
    ("gemma-2b", 2, {"layers/attn/wk": "part", "layers/attn/wq": "local"}),
    ("qwen2-moe-a2.7b", 2, {"layers/attn/bq": "part", "unembed": "part",
                            "layers/moe/router": "whole",
                            "layers/moe/w_gate": "local",
                            "layers/moe/shared/w_down": "local"}),
    ("deepseek-v3-671b", 2, {"layers/attn/w_dq": "whole",
                             "layers/attn/w_dkv": "whole",
                             "layers/attn/kv_norm": "whole",
                             "layers/attn/w_uq": "local",
                             "layers/attn/w_uv": "local",
                             "layers/attn/wo": "local",
                             "dense_layers/mlp/w_up": "local"}),
    ("internvl2-76b", 2, {"frontend/proj1": "local",
                          "frontend/proj2": "local"}),
    ("seamless-m4t-medium", 2, {"frontend/proj": "whole",
                                "layers/cross/wq": "local",
                                "enc_layers/attn/wk": "local"}),
] + [
    # the recurrent blocks (4 RWKV6 heads, 8 Mamba2 heads): every blk
    # leaf pinned; x enters RWKV6's time mix through one copy-in, so its
    # mixes and decay LoRA-in are used in part
    ("rwkv6-1.6b", m, {
        **{f"layers/blk/{k}": "local" for k in (
            "w_r", "w_k", "w_v", "w_g", "w_o", "w_decay_b", "w_ck", "w_cv")},
        **{f"layers/blk/{k}": "part" for k in (
            "mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w_decay_a",
            "decay_base", "bonus_u", "ln_scale", "ln_bias")},
        **{f"layers/blk/{k}": "whole" for k in ("mu_ck", "mu_cr", "w_cr")},
        "layers/ln1": "whole", "embed": "local", "unembed": "part"})
    for m in (2, 4)
] + [
    ("zamba2-7b", m, {
        "layers/blk/w_out": "local",
        **{f"layers/blk/{k}": "part" for k in (
            "w_in", "conv_w", "conv_b", "A_log", "dt_bias", "D",
            "norm_scale")},
        "layers/ln1": "whole", "embed": "local",
        "shared_attn/attn/wq": "local", "shared_attn/attn/wo": "local",
        "shared_attn/attn/wk": "local" if m == 2 else "part",
        "shared_attn/mlp/w_down": "local", "shared_attn/ln1": "whole"})
    for m in (2, 4)
]


@pytest.mark.parametrize("arch,m,want", USES,
                         ids=[f"{a}-{m}" for a, m, _ in USES])
def test_tp_use(arch, m, want):
    from repro_torch.parallel import sharding as sh
    cfg = tiny(arch, "tp")
    abstract = model_of(cfg).init_abstract()
    use = dict(sh._flat_with_path(sh.tp_use(abstract, cfg, FakeMesh(1, m))))
    for k, v in want.items():
        assert use[k] == v, k
    # a block is local only where the spec cuts it over model
    specs = dict(sh._flat_with_path(sh.param_specs(abstract, cfg,
                                                   FakeMesh(1, m))))
    for k, v in use.items():
        if v == "local":
            assert "model" in sh.spec_axes(specs[k], FakeMesh(1, m)), k
    # outside tp, and on a model axis of one rank, every leaf is whole
    for c, mesh in ((tiny(arch, "dp_all"), FakeMesh(1, m)),
                    (cfg, FakeMesh(m, 1))):
        assert set(dict(sh._flat_with_path(
            sh.tp_use(abstract, c, mesh))).values()) == {"whole"}
