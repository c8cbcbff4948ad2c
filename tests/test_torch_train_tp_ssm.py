"""Megatron tensor parallelism over the ``model`` axis for the recurrent
families (``rwkv6-1.6b``'s RWKV6 blocks, ``zamba2-7b``'s Mamba2 blocks and
shared attention block), held to the port's one-device step on the CPU
over gloo, and module by module to the JAX reference.

As for the attention families (``test_torch_train_tp.py``), the
reference's whole ``tp`` step does not run on this JAX (ROADMAP §3), so
the chain is: the ``tp`` step equals the port's one-device step, which
``test_torch_train_ssm.py`` holds against the reference.  The modules have
references that run:

- the WKV scan on each rank's heads against the head slice of the
  reference's per-shard ``_wkv_pallas_sharded`` (the Pallas kernel in
  interpret mode under ``shard_map`` over heads on ``model``) on (1, 2)
  and (1, 4) host meshes: output and final state within the reference's
  2e-5;
- ``rwkv_block_apply`` and ``mamba_block_apply`` on 2 ranks, each with
  its blocks (``sharding.tp_use``'s local leaves cut by
  ``shard_leaf``) of the same seeded numpy parameters, from a nonzero
  state: the output after ``reduce_out`` and the rank's slice of the new
  state against the reference's blocks on one device, within 2e-5
  (RWKV6, as ``test_torch_ssm.py``) and 5e-5 (Mamba2, the gated norm's
  sum over ranks);
- the blocks' gradients on 2 ranks (of the block input, after
  ``copy_in``'s all-reduce, and of every leaf: a block leaf's against its
  block of the one-device gradient, a leaf used in part summed over the
  ranks) against the port's one-device block's, within 1e-4 of each
  leaf's largest magnitude: Mamba2's gated RMSNorm takes its mean of
  squares over every rank's columns, and without the ``copy_in`` after
  its ``reduce_out`` each rank would keep only its columns' share of
  the gradient through it (``norm_scale`` and x move).

The reference's side runs in a subprocess of the test that sets the host
device count before JAX loads, and is handed to the ranks as arrays.

Step cases (``test_torch_train_tp.py``'s setup: each arch's reduced
preset in f32, a seeded global batch of 8 x 33 tokens, 3 steps at lr 1e-3
from ``init(0)``): rwkv6 (4 heads of 16, the WKV route
``ssm_impl="pallas"`` on the kernel's plain version) on (1, 2), (2, 2)
and (1, 4), and on ``"xla"`` on (1, 2); zamba2 (7 slots, 8 Mamba heads,
the shared block at 4 / 2 heads on the flash route) on (1, 2), (2, 2) and
(1, 4); recurrent heads that do not divide the axis: rwkv6 at d 48 (3
heads; its time mix runs whole on every rank, its channel mix over d_ff
still cut) and zamba2 at d 40 (5 Mamba heads; every ``blk`` leaf runs
whole) on (1, 2).  Each step's loss within rtol 2e-4 of the one-device
step's, step 1's grad norm within 1e-4 (a leaf's gradient at a wrong
scale moves it, where AdamW's first step moves the weights by the
gradient's sign alone); each leaf by ``test_torch_train_tp.py``'s rule (zamba2:
``test_torch_train_sharded.py``'s ssm trajectory rule).  ``train_main``
for rwkv6 on (2, 2) under ``tp`` against ``train_main`` in one process;
its step-3 checkpoint restored onto (1, 1) here bit for bit.  The
all-reduces of a (B, S, d) activation in one step at ``chip_smoke.py``'s
18g layouts (rwkv6 at 4 layers, zamba2's six Mamba2 blocks and one
shared pass), counted on the ranks.

One spawn of 4 gloo ranks (a ``FileStore``, a 60 s group timeout,
joined by a deadline and killed past it) runs every case: first over a
group of 4, then as two groups of 2 (ranks 0-1 and 2-3) for the (1, 2)
meshes.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_train_sharded as TS
import test_torch_train_tp as TP

SRC = TP.SRC
B, S, STEPS, LR = TP.B, TP.S, TP.STEPS, TP.LR
ARCHS = ("rwkv6-1.6b", "zamba2-7b")

# name: (arch, ssm_impl, d_model override or None, data, model)
STEP_CASES = {
    "rwkv6-tp-1x2": ("rwkv6-1.6b", "pallas", None, 1, 2),
    "rwkv6-xla-1x2": ("rwkv6-1.6b", "xla", None, 1, 2),
    "rwkv6-tp-2x2": ("rwkv6-1.6b", "pallas", None, 2, 2),
    "rwkv6-tp-1x4": ("rwkv6-1.6b", "pallas", None, 1, 4),
    "zamba2-tp-1x2": ("zamba2-7b", "xla", None, 1, 2),
    "zamba2-tp-2x2": ("zamba2-7b", "xla", None, 2, 2),
    "zamba2-tp-1x4": ("zamba2-7b", "xla", None, 1, 4),
    "rwkv6-3heads-1x2": ("rwkv6-1.6b", "pallas", 48, 1, 2),
    "zamba2-5heads-1x2": ("zamba2-7b", "xla", 40, 1, 2),
}
# the WKV cases: the reference's own inputs (B, S, H, K) and model axes
WKV_B, WKV_S, WKV_H, WKV_K = 2, 40, 4, 16
WKV_AXES = (2, 4)
# the blocks' inputs: (batch, rows) from a nonzero state
BLK_B, BLK_S = 2, 40

WORKER = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], Path(sys.argv[4])
    sys.path.insert(0, sys.argv[5])
    import test_torch_train_tp_ssm as T
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.train import train_main
    from repro_torch.parallel import sharding as sh
    res = {}
    made = {}

    def mesh(d, m):
        if (d, m) not in made:
            made[(d, m)] = make_host_mesh(d, m)
        return made[(d, m)]

    def run_steps(names):
        for name in names:
            d, m = T.STEP_CASES[name][3:]
            cfg = T.case_cfg(name)
            params, specs, losses, step1 = T.TP.sharded_run(
                cfg, mesh(d, m), T.STEPS)
            res[name] = {"losses": losses,
                         "grad_norm": step1["grad_norm"],
                         "uses": T.blk_uses(cfg, mesh(d, m))}
            full = sh.gather_tree(params, specs, mesh(d, m))
            if sh.coordinate(mesh(d, m)) == {"data": 0, "model": 0}:
                np.savez(out / f"{name}.npz", **T.TP.flat_np(full))

    ref = dict(np.load(out / "ref.npz"))
    inp = dict(np.load(out / "inputs.npz"))
    init_distributed("cpu", rank=rank, world_size=world, store_path=store,
                     timeout_s=60)
    run_steps([n for n, c in T.STEP_CASES.items() if c[3] * c[4] == 4])
    res["wkv-4"] = T.wkv_on_ranks(mesh(1, 4), inp, ref)
    ck = out / "ckpt-main-tp"
    params, history, driver = train_main(
        override_cfg=T.case_cfg("rwkv6-tp-2x2"), preset="full",
        steps=T.STEPS, global_batch=T.B, seq_len=T.S, data_axis=2,
        model_axis=2, checkpoint_dir=str(ck), checkpoint_every=1, lr=T.LR,
        log_every=0, seed=0, device="cpu")
    res["main-tp"] = {"losses": [h["loss"] for h in history],
                      "steps": [h["step"] for h in history],
                      "restarts": driver.restarts}
    if rank == 0:
        np.savez(out / "main-tp.npz", **T.TP.flat_np(params))
    dist.barrier()
    dist.destroy_process_group()

    half, pair = rank // 2, rank % 2
    init_distributed("cpu", rank=pair, world_size=2,
                     store_path=f"{store}-pair{half}", timeout_s=60)
    made.clear()
    names = [n for n, c in T.STEP_CASES.items() if c[3] * c[4] == 2]
    run_steps(names[half::2])
    res["wkv-2"] = T.wkv_on_ranks(mesh(1, 2), inp, ref)
    res["all-reduces"] = T.activation_all_reduces(mesh(1, 2))
    for arch in T.ARCHS:
        res[f"block-{arch}"] = T.block_on_ranks(arch, mesh(1, 2), inp, ref)
        res[f"grad-{arch}"] = T.block_grads_on_ranks(arch, mesh(1, 2), inp)
    dist.barrier()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
""")

REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from repro import dispatch
    from repro.configs.registry import get_arch
    from repro.launch.mesh import make_host_mesh
    from repro.models import ssm
    from repro.parallel.hints import use_mesh
    inp = dict(np.load(sys.argv[2]))
    out = {}
    wkv = [jnp.asarray(inp[f"wkv-{n}"]) for n in
           ("r", "k", "v", "logw", "u", "state")]
    for m in (2, 4):
        with use_mesh(make_host_mesh(1, m), "tp"):
            o, st = ssm._wkv_pallas_sharded(*wkv, get_arch("rwkv6-1.6b"))
        out[f"wkv-{m}-o"], out[f"wkv-{m}-state"] = np.asarray(o), \\
            np.asarray(st)
    for arch, fn, state in (("rwkv6-1.6b", ssm.rwkv_block_apply,
                             ssm.RWKVState),
                            ("zamba2-7b", ssm.mamba_block_apply,
                             ssm.MambaState)):
        pre = f"{arch}/"
        blk = {k[len(pre) + 4:]: jnp.asarray(v) for k, v in inp.items()
               if k.startswith(pre + "blk/")}
        st = state(*(jnp.asarray(inp[pre + "state/" + f])
                     for f in state._fields))
        with dispatch.use(execute="xla"):
            y, new = fn(blk, jnp.asarray(inp[pre + "x"]),
                        get_arch(arch).reduced(), st)
        out[pre + "y"] = np.asarray(y)
        for f, t in zip(state._fields, new):
            out[pre + "state/" + f] = np.asarray(t)
    np.savez(sys.argv[3], **out)
""")


def case_cfg(name):
    arch, impl, d, _, _ = STEP_CASES[name]
    cfg = TP.tiny(arch, "tp").replace(ssm_impl=impl)
    return cfg if d is None else cfg.replace(d_model=d)


def blk_uses(cfg, mesh):
    """``tp_use`` of the recurrent blocks' leaves, as the step reads it."""
    from repro_torch.parallel import sharding as sh
    use = sh.tp_use(TP.model_of(cfg).init_abstract(), cfg, mesh)
    return {p: u for p, u in sh._flat_with_path(use) if "/blk/" in p}


# the layouts of chip_smoke.py's 18g at the reduced widths: rwkv6 at 4
# layers, zamba2 at 7 slots with the shared block every 6th (six Mamba2
# blocks, one shared pass)
COUNTED = {"rwkv6-1.6b": dict(num_layers=4),
           "zamba2-7b": dict(num_layers=7, shared_attn_every=6)}


def activation_all_reduces(mesh):
    """Each arch's count of all-reduces of a (rows, S, d) activation in one
    ``tp`` step at ``COUNTED``'s layout (every rank runs the same)."""
    import torch.distributed as dist
    out = {}
    for arch, layout in COUNTED.items():
        cfg = TP.tiny(arch, "tp").replace(ssm_impl="pallas", **layout)
        shapes = []
        all_reduce = dist.all_reduce

        def counted(t, *args, **kwargs):
            shapes.append(tuple(t.shape))
            return all_reduce(t, *args, **kwargs)
        dist.all_reduce = counted
        try:
            TP.sharded_run(cfg, mesh, 1)
        finally:
            dist.all_reduce = all_reduce
        out[arch] = shapes.count((B, S, cfg.d_model))
    return out


def wkv_inputs():
    rng = np.random.default_rng(11)
    shp = (WKV_B, WKV_S, WKV_H, WKV_K)
    return {
        "wkv-r": rng.standard_normal(shp), "wkv-k": rng.standard_normal(shp),
        "wkv-v": rng.standard_normal(shp),
        "wkv-logw": -np.exp(rng.standard_normal(shp) * 0.5 - 1.5),
        "wkv-u": rng.standard_normal((WKV_H, WKV_K)) * 0.5,
        "wkv-state": rng.standard_normal((WKV_B, WKV_H, WKV_K, WKV_K)) * 0.3}


def block_cfg(arch):
    return TP.tiny(arch, "tp").replace(ssm_impl="pallas")


def block_inputs(arch):
    """Seeded numpy leaves of one block of ``arch``'s reduced preset (the
    port's shapes; values away from the init's constants, so that every
    per-head leaf is distinct), an input and a nonzero state."""
    from repro_torch.models import ssm
    cfg = block_cfg(arch)
    rng = np.random.default_rng(12 if arch == "rwkv6-1.6b" else 13)
    gen = torch.Generator().manual_seed(0)
    if arch == "rwkv6-1.6b":
        shapes = {k: tuple(v.shape)
                  for k, v in ssm.init_rwkv_block(gen, cfg).items()}
    else:
        shapes = {k: tuple(v.shape)
                  for k, v in ssm.init_mamba_block(gen, cfg).items()}

    def leaf(k, shp):
        if k.startswith("mu_"):
            return rng.uniform(0.0, 1.0, shp)
        if k.startswith("w_"):
            return rng.standard_normal(shp) / np.sqrt(shp[0])
        return {"decay_base": lambda: rng.uniform(-7.0, -3.0, shp),
                "bonus_u": lambda: rng.standard_normal(shp) * 0.5,
                "ln_scale": lambda: 1.0 + 0.2 * rng.standard_normal(shp),
                "ln_bias": lambda: 0.2 * rng.standard_normal(shp),
                "conv_w": lambda: 0.3 * rng.standard_normal(shp),
                "conv_b": lambda: 0.1 * rng.standard_normal(shp),
                "A_log": lambda: np.log(rng.uniform(1.0, 16.0, shp)),
                "dt_bias": lambda: rng.standard_normal(shp) * 0.5 - 2.0,
                "D": lambda: 1.0 + 0.5 * rng.standard_normal(shp),
                "norm_scale": lambda: 0.2 * rng.standard_normal(shp)}[k]()
    pre = f"{arch}/"
    out = {pre + "blk/" + k: leaf(k, shp) for k, shp in shapes.items()}
    out[pre + "x"] = rng.standard_normal((BLK_B, BLK_S, cfg.d_model))
    if arch == "rwkv6-1.6b":
        H, K = ssm.rwkv_num_heads(cfg), cfg.ssm.head_dim
        st = {"wkv": rng.standard_normal((BLK_B, H, K, K)) * 0.3,
              "shift_t": rng.standard_normal((BLK_B, cfg.d_model)),
              "shift_c": rng.standard_normal((BLK_B, cfg.d_model))}
    else:
        d_inner, H, P, N = ssm.mamba_dims(cfg)
        st = {"ssm": rng.standard_normal((BLK_B, H, P, N)) * 0.3,
              "conv": rng.standard_normal(
                  (BLK_B, cfg.ssm.conv_width - 1, d_inner + 2 * N))}
    out.update({pre + "state/" + k: v for k, v in st.items()})
    return out


def all_inputs():
    out = wkv_inputs()
    for arch in ARCHS:
        out.update(block_inputs(arch))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _heads(t, rank, n, dim):
    return t.narrow(dim, rank * n, n)


def wkv_on_ranks(mesh, inp, ref):
    """The largest differences of this rank's WKV output and final state
    on its heads from the reference's head slices on a (1, m) mesh."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import tp as tp_mod
    from repro_torch.parallel.hints import use_mesh
    with use_mesh(mesh):
        tp = tp_mod.context(TP.tiny("rwkv6-1.6b", "tp"))
    h = WKV_H // tp.size
    r, k, v, logw = (_heads(torch.from_numpy(inp[f"wkv-{n}"]), tp.rank, h,
                            2) for n in ("r", "k", "v", "logw"))
    u = _heads(torch.from_numpy(inp["wkv-u"]), tp.rank, h, 0)
    s0 = _heads(torch.from_numpy(inp["wkv-state"]), tp.rank, h, 1)
    o, st = ops.wkv_attention(r, k, v, logw, u, s0,
                              chunk=min(64, WKV_S))
    want_o = ref[f"wkv-{tp.size}-o"][:, :, tp.rank * h:(tp.rank + 1) * h]
    want_s = ref[f"wkv-{tp.size}-state"][:, tp.rank * h:(tp.rank + 1) * h]
    return {"shape": list(o.shape), "state_shape": list(st.shape),
            "o_err": float(np.abs(o.numpy() - want_o).max()),
            "state_err": float(np.abs(st.numpy() - want_s).max())}


def _block_tree(arch, inp):
    pre = f"{arch}/blk/"
    return {"layers": {"blk": {k[len(pre):]: torch.from_numpy(v)
                               for k, v in inp.items()
                               if k.startswith(pre)}}}


def _local_block(arch, mesh, inp):
    """(the rank's block leaves, their uses, the specs): ``tp_use``'s
    local leaves cut to the rank's block by ``shard_leaf``, the others
    whole."""
    from repro_torch.parallel import sharding as sh
    cfg = block_cfg(arch)
    tree = _block_tree(arch, inp)
    use = dict(sh._flat_with_path(sh.tp_use(tree, cfg, mesh)))
    specs = dict(sh._flat_with_path(sh.param_specs(tree, cfg, mesh)))
    blk = {p.split("/")[-1]: sh.shard_leaf(t, specs[p], mesh)
           if use[p] == "local" else t.clone()
           for p, t in sh._flat_with_path(tree)}
    return blk, {p.split("/")[-1]: u for p, u in use.items()}, \
        {p.split("/")[-1]: s for p, s in specs.items()}


def _rank_state(arch, cfg, tp, inp):
    """The rank's slice of the block's input state (its heads; Mamba2's
    conv rows: its x channels and all of B / C)."""
    from repro_torch.models import ssm
    pre = f"{arch}/state/"
    st = {k[len(pre):]: torch.from_numpy(v) for k, v in inp.items()
          if k.startswith(pre)}
    if arch == "rwkv6-1.6b":
        h = ssm.rwkv_num_heads(cfg) // tp.size
        return ssm.RWKVState(_heads(st["wkv"], tp.rank, h, 1),
                             st["shift_t"], st["shift_c"])
    d_inner, H, P, N = ssm.mamba_dims(cfg)
    h = H // tp.size
    conv = torch.cat([_heads(st["conv"], tp.rank, h * P, 2),
                      st["conv"][..., d_inner:]], dim=-1)
    return ssm.MambaState(_heads(st["ssm"], tp.rank, h, 1), conv)


def block_on_ranks(arch, mesh, inp, ref):
    """The largest differences of the block's output (after
    ``reduce_out``) and of the rank's slice of its new state from the
    reference's one-device block."""
    from repro_torch.models import ssm
    from repro_torch.parallel import tp as tp_mod
    from repro_torch.parallel.hints import use_mesh
    cfg = block_cfg(arch)
    blk, _, _ = _local_block(arch, mesh, inp)
    pre = f"{arch}/"
    fn = ssm.rwkv_block_apply if arch == "rwkv6-1.6b" else \
        ssm.mamba_block_apply
    with use_mesh(mesh), torch.no_grad():
        tp = tp_mod.context(cfg)
        want_state = _rank_state(arch, cfg, tp, ref)
        y, new = fn(blk, torch.from_numpy(inp[pre + "x"]), cfg,
                    _rank_state(arch, cfg, tp, inp))
    return {"y_err": float(np.abs(y.numpy() - ref[pre + "y"]).max()),
            "state_err": {f: float((a - b).abs().max()) for f, a, b in
                          zip(new._fields, new, want_state)},
            "state_shapes": {f: list(a.shape)
                             for f, a in zip(new._fields, new)}}


def block_grads_on_ranks(arch, mesh, inp):
    """Each gradient's largest difference from the one-device block's,
    over 1e-4 of the one-device gradient's largest magnitude: the block
    input's (after ``copy_in``'s all-reduce) and every leaf's (a local
    leaf against its block of the one-device gradient, a leaf used in
    part summed over the ranks, a whole leaf as it is).  The loss is a
    seeded weighting of the output, from a zero state as in training."""
    import torch.distributed as dist
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import tp as tp_mod
    from repro_torch.parallel.hints import use_mesh
    cfg = block_cfg(arch)
    full = _block_tree(arch, inp)["layers"]["blk"]
    local, use, specs = _local_block(arch, mesh, inp)
    x0 = torch.from_numpy(inp[f"{arch}/x"])
    wgt = torch.from_numpy(np.random.default_rng(14).standard_normal(
        tuple(x0.shape)).astype(np.float32))
    rw = arch == "rwkv6-1.6b"
    fn = ssm.rwkv_block_apply if rw else ssm.mamba_block_apply

    def grads(blk, heads):
        leaves = {k: v.detach().requires_grad_(True) for k, v in blk.items()}
        x = x0.clone().requires_grad_(True)
        zero = (ssm.init_rwkv_state if rw else ssm.init_mamba_state)(
            cfg, BLK_B, torch.float32, "cpu", heads=heads)
        with torch.enable_grad():
            y, _ = fn(leaves, x, cfg, zero)
            (y * wgt).sum().backward()
        return x.grad, {k: v.grad for k, v in leaves.items()}

    with use_mesh(mesh):
        heads = (ssm.rwkv_heads if rw else ssm.mamba_heads)(local, cfg)
        want_x, want = grads(full, None)
        got_x, got = grads(local, heads)
    out = {"x": float((got_x - want_x).abs().max()
                      / want_x.abs().max())}
    for k, g in got.items():
        if use[k] == "part":
            g = g.clone()
            dist.all_reduce(g)
        w = want[k]
        if use[k] == "local":
            w = sh.shard_leaf(w, specs[k], mesh)
        out[k] = float((g - w).abs().max() / max(float(w.abs().max()),
                                                 1e-30))
    return {"rel_err": out, "uses": use}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ssm")
    np.savez(out / "inputs.npz", **all_inputs())
    proc = subprocess.run(
        [sys.executable, "-c", REF, str(SRC), str(out / "inputs.npz"),
         str(out / "ref.npz")], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    TP._spawn(WORKER, 4, out, str(out), str(Path(__file__).resolve().parent))
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    return out, res


_UNSHARDED = {}


def unsharded(name):
    cfg = case_cfg(name)
    if cfg not in _UNSHARDED:
        _UNSHARDED[cfg] = TP.unsharded_run(cfg, STEPS)
    return _UNSHARDED[cfg]


def _ranks(case):
    d, m = STEP_CASES[case][3:]
    if d * m == 4:
        return [0, 1, 2, 3]
    names = [n for n, c in STEP_CASES.items() if c[3] * c[4] == 2]
    return [0, 1] if names.index(case) % 2 == 0 else [2, 3]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tp_step_is_the_one_device_step(spawned, case):
    out, res = spawned
    arch, _, d_model, _, m = STEP_CASES[case]
    ranks = _ranks(case)
    init, want, want_losses, want_step1 = unsharded(case)
    for r in ranks:                      # every rank reports the same loss
        assert res[r][case]["losses"] == res[ranks[0]][case]["losses"]
    np.testing.assert_allclose(res[ranks[0]][case]["losses"], want_losses,
                               rtol=2e-4)
    # step 1's grad norm: a leaf's gradient at a wrong scale moves it,
    # though AdamW's first step moves the weights by its sign alone
    assert res[ranks[0]][case]["grad_norm"] == pytest.approx(
        want_step1["grad_norm"], rel=1e-4)
    got = dict(np.load(out / f"{case}.npz"))
    if arch == "zamba2-7b":
        TS.assert_close_to(got, init, want, hybrid=True)
    else:
        TP.assert_close_to(got, init, want)
    # the blocks the ranks computed on: a rank's heads, or all of them
    uses = res[ranks[0]][case]["uses"]
    cut = d_model is None
    if arch == "rwkv6-1.6b":
        assert uses["layers/blk/w_r"] == ("local" if cut else "whole")
        assert uses["layers/blk/w_ck"] == "local"
    else:
        assert uses["layers/blk/w_out"] == ("local" if cut else "whole")
        assert uses["layers/blk/w_in"] == ("part" if cut else "whole")


def test_activation_all_reduces_a_step(spawned):
    """RWKV6: 6 a layer (the time mix's and channel mix's reduce-outs,
    their copy-ins' backward, and remat's recompute of the two
    reduce-outs), plus the vocab-parallel embedding's and the
    cross-entropy's copy-in of the hidden state; zamba2: 3 a Mamba2 block
    (its reduce-out, its copy-in's backward, the recompute), the shared
    pass's and the same two, where remat's recompute stops at the last
    tensor the backward needs."""
    _, res = spawned
    want = {"rwkv6-1.6b": 6 * COUNTED["rwkv6-1.6b"]["num_layers"] + 2,
            "zamba2-7b": 24}
    for r in range(4):
        assert res[r]["all-reduces"] == want, (r, res[r]["all-reduces"])


@pytest.mark.parametrize("m", WKV_AXES)
def test_wkv_on_local_heads_is_the_reference_shard(spawned, m):
    _, res = spawned
    for r in range(4):
        got = res[r][f"wkv-{m}"]
        assert got["shape"] == [WKV_B, WKV_S, WKV_H // m, WKV_K]
        assert got["state_shape"] == [WKV_B, WKV_H // m, WKV_K, WKV_K]
        assert got["o_err"] <= 2e-5 and got["state_err"] <= 2e-5, (r, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_on_two_ranks_is_the_reference_block(spawned, arch):
    _, res = spawned
    atol = 2e-5 if arch == "rwkv6-1.6b" else 5e-5
    cfg = block_cfg(arch)
    for r in range(4):
        got = res[r][f"block-{arch}"]
        assert got["y_err"] <= atol, (r, got)
        assert max(got["state_err"].values()) <= atol, (r, got)
        if arch == "rwkv6-1.6b":
            H = cfg.d_model // cfg.ssm.head_dim
            assert got["state_shapes"]["wkv"][1] == H // 2
        else:
            d_inner = cfg.ssm.expand * cfg.d_model
            assert got["state_shapes"]["ssm"][1] == \
                d_inner // cfg.ssm.head_dim // 2
            assert got["state_shapes"]["conv"][-1] == \
                d_inner // 2 + 2 * cfg.ssm.state_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_block_gradients_on_two_ranks(spawned, arch):
    """Mamba2's gated norm (``norm_scale``, the block input) among them:
    ``reduce_out`` without ``copy_in`` would leave each rank its columns'
    share of the gradient through the mean of squares."""
    _, res = spawned
    for r in range(4):
        got = res[r][f"grad-{arch}"]
        assert "part" in got["uses"].values() and \
            "local" in got["uses"].values()
        for k, err in got["rel_err"].items():
            assert err <= 1e-4, (r, k, err)
    if arch == "zamba2-7b":
        assert res[0][f"grad-{arch}"]["uses"]["norm_scale"] == "part"


def test_train_main_under_tp(spawned, tmp_path):
    from repro_torch.launch.train import train_main
    out, res = spawned
    cfg = case_cfg("rwkv6-tp-2x2")
    init = TP.flat_np(TP.model_of(cfg).init(0))
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
    TP.assert_close_to(dict(np.load(out / "main-tp.npz")), init,
                       TP.flat_np(params))


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


def test_tp_checkpoint_restores_on_one_rank(spawned, world1):
    """(2, 2) tp -> (1, 1) here, bit for bit; the file holds the (2, 2)
    run's gathered parameters."""
    from repro_torch.checkpoint import load_checkpoint, restore_resharded
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import sharding as sh
    out, _ = spawned
    cfg = case_cfg("rwkv6-tp-2x2")
    model = TP.model_of(cfg)
    params = model.init(1)
    ps = sh.param_specs(model.init_abstract(), cfg, world1)
    tgt = {"params": params,
           "opt": AdamWState(step=torch.zeros((), dtype=torch.int32),
                             m=params, v=params)}
    specs = {"params": ps, "opt": AdamWState(step=sh.P(), m=ps, v=ps)}
    ck = out / "ckpt-main-tp"
    step, tree, _ = restore_resharded(ck, tgt, world1, specs)
    _, flat, _ = load_checkpoint(ck)
    got = TP.flat_np(tree)
    assert step == STEPS and sorted(got) == sorted(flat)
    for k in flat:
        assert np.array_equal(got[k], flat[k]), k
    for k, v in np.load(out / "main-tp.npz").items():
        assert np.array_equal(flat[f"params/{k}"], v), k


# (arch, d_model override, model axis, {leaf: use}) where the recurrent
# heads do not divide the axis
ODD_USES = [
    ("rwkv6-1.6b", 48, 2, {"layers/blk/w_r": "whole",
                           "layers/blk/w_o": "whole",
                           "layers/blk/mu_r": "whole",
                           "layers/blk/bonus_u": "whole",
                           "layers/blk/w_decay_a": "whole",
                           "layers/blk/w_ck": "local",
                           "layers/blk/w_cv": "local",
                           "layers/blk/w_cr": "whole"}),
    ("zamba2-7b", 40, 2, {}),
    ("zamba2-7b", 48, 4, {}),
]


@pytest.mark.parametrize("arch,d,m,want", ODD_USES,
                         ids=[f"{a}-d{d}-{m}" for a, d, m, _ in ODD_USES])
def test_tp_use_where_heads_do_not_divide(arch, d, m, want):
    """RWKV6's time mix, and every Mamba2 ``blk`` leaf, whole."""
    from repro_torch.parallel import sharding as sh
    cfg = TP.tiny(arch, "tp").replace(d_model=d)
    abstract = TP.model_of(cfg).init_abstract()
    use = dict(sh._flat_with_path(sh.tp_use(abstract, cfg,
                                            TP.FakeMesh(1, m))))
    for k, v in want.items():
        assert use[k] == v, k
    if arch == "zamba2-7b":
        assert {v for k, v in use.items() if "/blk/" in k} == {"whole"}
