"""The sharded train step (FSDP / ZeRO-3 over a ``DeviceMesh``) held to the
port's one-device step, on the CPU over gloo.

The reference's own sharded step does not run on this JAX (ROADMAP §3:
a ``hint`` raises ``DuplicateSpecError``), so the chain is: the sharded
step equals the port's one-device step, which ``test_torch_train*.py``
hold against the reference.

Setup, the reference test's: ``llama3.2-1b`` reduced with 4 heads, 2 kv
heads, d 64, hd 16, f32; a seeded global batch of 8 x 33 tokens; 3 steps
at lr 1e-3 from ``init(0)``.  One spawn of 4 gloo ranks (a ``FileStore``
in a temporary directory, a 60 s group timeout, joined by a deadline and
killed past it) runs every multi-rank case:

- ``dp_all`` on (2, 2), (4, 1) and (1, 4), and ``tp`` on (4, 1) (FSDP over
  data): each step's loss within rtol 2e-4 of the one-device step's, each
  gathered leaf within the larger of 1e-4 of its largest magnitude and
  2e-3 of the largest travel from the init (``test_torch_adaptnet.py``'s
  AdamW-noise rule: a gradient entry whose terms cancel moves by the
  learning rate times the sums' relative difference);
- the replicated batch: B = 2 on (4, 1), which ``batch_specs`` does not
  shard, so every rank computes every row and counts it once;
- ``train_main`` on (2, 2) ``dp_all`` for reduced ``llama3.2-1b``,
  ``rwkv6-1.6b`` and ``zamba2-7b`` against ``train_main`` on one process
  (zamba2's weights by ``test_torch_train_ssm.py``'s rule for its
  trajectories: 1e-4 of each leaf's largest magnitude plus 1e-6 at 99.9%
  of its elements, every element within 2 lr a step; its shared block's
  gradients sum the groups' contributions, and an entry whose terms
  cancel moved 2.9e-5, 3% of a step, on (2, 2));
- resharding: the (2, 2) state saved (gathered, rank 0 writes), restored
  onto (4, 1) bit for bit; onto (1, 1) in this process bit for bit; the
  reference's ``CheckpointManager`` reads the files;
- ``train_main`` with a failure injected on rank 1 alone at step 2: every
  rank restores step 2 once, and the run ends on the unfailed run's
  parameters bit for bit;
- the blocks: ``shard_leaf`` of 6 specs (a dim over ("data", "model"),
  over one axis each, replicated) on (2, 2) and (4, 1) is each rank's
  block as the reference places it (a dim over two axes cut first-axis
  major), ``gather_leaf`` puts the blocks back, and ``reduce_leaf`` over
  each set of batch axes (none, data, model, both) is the block of the
  sum of the ranks' terms, as is ``sum_over`` of a scalar;
- the recurrent families under ``tp`` over a model axis of 2
  (``rwkv6-1.6b`` and ``zamba2-7b`` on (2, 2)), the layouts the sharded
  step once refused, run on a rank's heads and equal the one-device step
  (losses within rtol 2e-4, weights by the rule above; zamba2's by the
  ssm trajectory rule); Megatron ``tp`` for the attention families and
  MoE on a batch-sharded mesh are ``test_torch_train_tp.py``'s, the
  recurrent families' own cases ``test_torch_train_tp_ssm.py``'s.

In this process, on a gloo group of one rank: the sharded (1, 1) step is
bit for bit the unsharded step (losses, every parameter), under ``tp``
and ``dp_all``.
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

WORKER = textwrap.dedent("""
    import json, sys, traceback
    from pathlib import Path
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), \\
        sys.argv[3], Path(sys.argv[4])
    sys.path.insert(0, sys.argv[5])
    import test_torch_train_sharded as T
    from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                        restore_resharded, save_sharded)
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.train import train_main
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import sharding as sh
    init_distributed("cpu", rank=rank, world_size=world, store_path=store,
                     timeout_s=60)
    meshes, res = {}, {}

    def mesh(d, m):
        if (d, m) not in meshes:
            meshes[(d, m)] = make_host_mesh(d, m)
        return meshes[(d, m)]

    def save(name, tree):
        if rank == 0:
            np.savez(out / f"{name}.npz", **T.flat_np(tree))

    for name, (arch, strategy, d, m, batch) in T.STEP_CASES.items():
        cfg = T.tiny(arch, strategy)
        params, opt_state, specs, losses = T.sharded_run(cfg, mesh(d, m),
                                                         batch)
        res[name] = {"losses": losses}
        save(name, sh.gather_tree(params, specs["params"], mesh(d, m)))
        if name == "dp_all-2x2":
            mgr = CheckpointManager(out / "reshard")
            save_sharded(mgr, T.STEPS, {"params": params, "opt": opt_state},
                         specs, mesh(2, 2))
            tgt = {"params": params, "opt": opt_state}
            m41 = mesh(4, 1)
            ps = sh.param_specs(T.model_of(cfg).init_abstract(), cfg, m41)
            specs41 = {"params": ps,
                       "opt": AdamWState(step=sh.P(), m=ps, v=ps)}
            step, local, _ = restore_resharded(out / "reshard", tgt, m41,
                                               specs41)
            full = sh.gather_tree(local, specs41, m41)
            _, flat, _ = load_checkpoint(out / "reshard")
            got = T.flat_np(full)
            res["reshard-4x1"] = {
                "step": step, "keys": sorted(got) == sorted(flat),
                "bitwise": all(np.array_equal(got[k], flat[k])
                               for k in flat),
                "local_shapes": {k: list(v.shape) for k, v in
                                 sh._flat_with_path(local["params"])}}

    for name, (arch, fail) in T.MAIN_CASES.items():
        fired = []

        def inject(step, fail=fail):
            if fail and rank == 1 and step == 2 and not fired:
                fired.append(step)
                raise RuntimeError("injected failure at step 2")
        params, history, driver = train_main(
            override_cfg=T.tiny(arch, "dp_all"), preset="full", steps=T.STEPS,
            global_batch=T.B, seq_len=T.S, data_axis=2, model_axis=2,
            checkpoint_dir=str(out / f"ckpt-{name}"), checkpoint_every=1,
            lr=T.LR, log_every=0, seed=0, device="cpu", fail_injector=inject)
        res[name] = {"losses": [h["loss"] for h in history],
                     "steps": [h["step"] for h in history],
                     "restarts": driver.restarts, "fired": fired}
        save(name, params)

    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    res["blocks"] = {}
    for d, m in ((2, 2), (4, 1)):
        msh = mesh(d, m)
        coords = sh.coordinate(msh)
        for spec in T.SPECS:
            want = full[T.block_slices(full.shape, spec, msh, coords)]
            local = sh.shard_leaf(full, spec, msh)
            ok = bool(torch.equal(local, want) and local.is_contiguous()
                      and torch.equal(sh.gather_leaf(local, spec, msh),
                                      full))
            for over in T.OVERS:
                # a term of the sum on each rank over `over`, the same
                # across the other axes; integers, so every order is exact
                i, n = T.mixed_radix(over, msh, coords)
                got = sh.reduce_leaf(full * (1 + i), spec, msh, over)
                ok &= bool(torch.equal(got, want * (n * (n + 1) // 2)))
                ok &= float(sh.sum_over(torch.tensor(1.0 + i), msh,
                                        over)) == n * (n + 1) // 2
            res["blocks"][f"{d}x{m} {spec!r}"] = ok

    for name, (arch, strategy, d, m) in T.REFUSED.items():
        params, _, specs, losses = T.sharded_run(T.tiny(arch, strategy),
                                                 mesh(d, m), T.B)
        res[name] = {"losses": losses}
        save(name, sh.gather_tree(params, specs["params"], mesh(d, m)))

    res["whole"] = {}

    def whole(name):
        # a case that fails fails its own tests only
        try:
            res["whole"][name] = T.against_whole_tree(name, mesh, out)
        except Exception:
            res["whole"][name] = {"error": traceback.format_exc()}

    for name in T.WHOLE_CASES:
        if T.WHOLE_CASES[name][2] * T.WHOLE_CASES[name][3] == 4:
            whole(name)
    dist.barrier()
    dist.destroy_process_group()

    # two groups of 2 for the (2, 1) and (1, 2) meshes, each on a store of
    # its own
    half, pair = rank // 2, rank % 2
    init_distributed("cpu", rank=pair, world_size=2,
                     store_path=f"{store}-pair{half}", timeout_s=60)
    meshes.clear()
    for name, (_, _, d, m, _) in T.WHOLE_CASES.items():
        if (d, m) == ((2, 1), (1, 2))[half]:
            whole(name)
    dist.barrier()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
""")

# name: (arch, tp_strategy, data, model, global batch)
STEP_CASES = {"dp_all-2x2": ("llama3.2-1b", "dp_all", 2, 2, B),
              "dp_all-4x1": ("llama3.2-1b", "dp_all", 4, 1, B),
              "dp_all-1x4": ("llama3.2-1b", "dp_all", 1, 4, B),
              "tp-4x1": ("llama3.2-1b", "tp", 4, 1, B),
              "tp-4x1-B2": ("llama3.2-1b", "tp", 4, 1, 2)}
# name: (arch, inject a failure)
MAIN_CASES = {"main-llama": ("llama3.2-1b", False),
              "main-llama-failed": ("llama3.2-1b", True),
              "main-rwkv6": ("rwkv6-1.6b", False),
              "main-zamba2": ("zamba2-7b", False)}
# the layouts the sharded step refused before the recurrent families ran
# under Megatron tp: name: (arch, tp_strategy, data, model)
REFUSED = {"rwkv6-tp-2x2": ("rwkv6-1.6b", "tp", 2, 2),
           "zamba2-tp-2x2": ("zamba2-7b", "tp", 2, 2)}
# step 1 against the whole-tree step written out below: name: (arch,
# tp_strategy, data, model, layer slots).  Four layers (zamba2: 14 slots,
# ten Mamba2 layers in groups of two) so that two of them are less than
# the stack; zamba2's per-head leaves (10, 8) then cut their stack axis
# under dp_all on two ranks, and are gathered whole
WHOLE_ARCHS = (("llama", "llama3.2-1b", 4), ("rwkv6", "rwkv6-1.6b", 4),
               ("zamba2", "zamba2-7b", 14))
WHOLE_CASES = {f"{key}-{strategy}-{d}x{m}": (arch, strategy, d, m, layers)
               for key, arch, layers in WHOLE_ARCHS
               for strategy in ("dp_all", "tp")
               for d, m in ((2, 1), (1, 2), (2, 2), (4, 1), (1, 4))}


def _specs():
    from repro_torch.parallel.sharding import P
    return (P(("data", "model"), None), P(None, ("data", "model")),
            P("model", "data"), P("data"), P(None, "model"), P())


SPECS = _specs()
OVERS = ((), ("data",), ("model",), ("data", "model"))


def mixed_radix(axes, mesh, coords):
    """(index, count) of a rank's place over ``axes``, the first the
    major: the block of a dim sharded over them, as the reference's
    ``NamedSharding`` places it."""
    from repro_torch.parallel.sharding import axis_sizes
    sizes = axis_sizes(mesh)
    i, n = 0, 1
    for a in axes:
        i, n = i * sizes[a] + coords[a], n * sizes[a]
    return i, n


def block_slices(shape, spec, mesh, coords):
    out = []
    for k, dim in enumerate(shape):
        entry = spec[k] if k < len(spec) else None
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        i, n = mixed_radix(axes, mesh, coords)
        out.append(slice(i * dim // n, (i + 1) * dim // n))
    return tuple(out)


def tiny(arch, strategy):
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch).reduced()
    if arch == "llama3.2-1b":
        cfg = cfg.replace(num_heads=4, num_kv_heads=2, d_model=64,
                          head_dim=16)
    return cfg.replace(param_dtype="float32", compute_dtype="float32",
                       opt_state_dtype="float32", tp_strategy=strategy)


def model_of(cfg):
    from repro_torch.models.api import build_model
    return build_model(cfg, "cpu")


def tokens(cfg, batch, step):
    return np.random.default_rng(100 + step).integers(
        0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)


def flat_np(tree):
    from repro_torch.parallel.sharding import _flat_with_path
    return {p: t.detach().cpu().numpy() for p, t in _flat_with_path(tree)}


def sharded_run(cfg, mesh, batch):
    """3 steps of the sharded step on this rank's rows; (local params,
    local optimizer state, specs, losses)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.hints import use_mesh
    model, step, opt, (ps, os_) = build_train_step(
        cfg, LR, "cpu", mesh=mesh, global_batch=batch)
    params = sh.shard_tree(model.init(0), ps, mesh)
    opt_state = opt.init(params)
    r0, rows, _ = sh.local_batch_rows(batch, cfg, mesh)
    losses = []
    for s in range(STEPS):
        toks = torch.from_numpy(tokens(cfg, batch, s)[r0:r0 + rows])
        with use_mesh(mesh):
            params, opt_state, m = step(params, opt_state, {"tokens": toks})
        losses.append(float(m["loss"]))
    return params, opt_state, {"params": ps, "opt": os_}, losses


def whole_tree_step(model, opt, mesh, params, opt_state, batch):
    """Step 1 as the sharded step ran it before it gathered a layer at a
    time: the whole tree gathered (``gather_tree``), the loss and its
    backward on full leaves, each full gradient reduced after the
    backward in sorted order (``reduce_leaf``), the clip's norm over every
    rank's distinct blocks, and the functional ``AdamW.update``.  Returns
    (new params, new optimizer state, loss, grad norm); its arguments are
    left as they were."""
    import torch.distributed as dist

    from repro_torch.optim.adamw import apply_updates, tree_leaves, tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.hints import use_mesh
    cfg = model.cfg
    abstract = model.init_abstract()
    ps = sh.param_specs(abstract, cfg, mesh)
    use = dict(sh._flat_with_path(sh.tp_use(abstract, cfg, mesh)))
    gs = sh._map_with_path(
        lambda p, s: sh.without_model(s) if use[p] == "local" else s, ps)
    flat_g = dict(sh._flat_with_path(gs))
    _, _, over = sh.local_batch_rows(B, cfg, mesh)
    over_of = {"local": over, "whole": over, "part": over + ("model",)}
    count_fn = (lambda cnt: sh.sum_over(cnt, mesh, over)) if over else None
    full = sh.gather_tree(params, gs, mesh)
    with torch.enable_grad(), use_mesh(mesh):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), full)
        del full
        loss, _ = model.loss(leaves, batch, count_fn=count_fn)
        loss.backward()
    flat = dict(sh._flat_with_path(leaves))
    grads = {p: sh.reduce_leaf(flat[p].grad, flat_g[p], mesh,
                               over_of[use[p]]) for p in sorted(flat)}
    grads = sh._map_with_path(lambda p, _: grads[p], params)
    sq = sum(torch.sum(torch.square(g.float())) if sh.counted_here(s, mesh)
             else torch.zeros(()) for g, s in zip(tree_leaves(grads),
                                                   tree_leaves(ps)))
    dist.all_reduce(sq)
    updates, state, om = opt.update(grads, opt_state, params,
                                    norm=torch.sqrt(sq))
    return (apply_updates(params, updates), state,
            float(sh.sum_over(loss.detach(), mesh, over)),
            float(om["grad_norm"]))


def gathered_bytes(cfg, mesh):
    """(bytes of the leaves the sharded step gathers whole, bytes of its
    largest remat'd region's gathered layers: one layer, a zamba2 group's
    Mamba2 layers, the stacked leaves gathered whole), counting only the
    leaves some axis of more than one rank gathers, each at its gathered
    size (a block that stays cut over ``model`` its block's)."""
    from repro_torch.models.transformer import hybrid_layout
    from repro_torch.parallel import fsdp
    from repro_torch.parallel import sharding as sh
    abstract = model_of(cfg).init_abstract()
    ps = sh.param_specs(abstract, cfg, mesh)
    use = dict(sh._flat_with_path(sh.tp_use(abstract, cfg, mesh)))
    gs = sh._map_with_path(
        lambda p, s: sh.without_model(s) if use[p] == "local" else s, ps)
    flat_g = dict(sh._flat_with_path(gs))
    plan = fsdp.plan(gs, {p: () for p in use}, mesh)
    flat_p, sizes = dict(sh._flat_with_path(ps)), sh.axis_sizes(mesh)
    whole = layer = 0
    stacked = []
    for path, t in sh._flat_with_path(abstract):
        if not any(d is not None
                   for *_, d in sh._sharded_axes(flat_g[path], mesh)):
            continue
        n = t.numel() * t.element_size()
        for a in set(sh.spec_axes(flat_p[path], mesh)) - \
                set(sh.spec_axes(flat_g[path], mesh)):
            n //= sizes[a]
        if path in plan.specs:
            layer += n // t.shape[0]
        else:
            whole += n
            if path.split("/")[0] in fsdp.STACKS:
                stacked.append(path)
    unit = hybrid_layout(cfg)[2] if cfg.family == "hybrid" else 1
    return whole, unit * layer, stacked


def against_whole_tree(name, mesh_of, out):
    """One ``WHOLE_CASES`` case on this rank: the sharded step's step 1
    and ``whole_tree_step``'s from the same blocks, and on two ranks each
    one's step 2 from its own step 1 (``second``); a record of the
    comparison, and both step-1 gathered trees saved by the rank at
    coordinate 0 (``{name}-step.npz``, ``{name}-whole.npz``)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.modules import tensors
    from repro_torch.parallel import sharding as sh
    arch, strategy, d, m, layers = WHOLE_CASES[name]
    cfg = tiny(arch, strategy).replace(num_layers=layers)
    assert cfg.remat
    mesh = mesh_of(d, m)
    model, step, opt, (ps, _) = build_train_step(cfg, LR, "cpu", mesh=mesh,
                                                 global_batch=B)
    params = sh.shard_tree(model.init(0), ps, mesh)
    opt_state = opt.init(params)
    r0, rows, _ = sh.local_batch_rows(B, cfg, mesh)
    batch = {"tokens": torch.from_numpy(tokens(cfg, B, 0)[r0:r0 + rows])}
    sh.METER.reset()
    want, want_state, want_loss, want_gn = whole_tree_step(
        model, opt, mesh, params, opt_state, batch)
    whole_high = sh.METER.high
    given = tensors((params, opt_state))
    ptrs = [t.data_ptr() for t in given]
    sh.METER.reset()
    got, got_state, metrics = step(params, opt_state, batch)
    high, moved = sh.METER.high, sh.METER.moved
    returned = tensors((got, got_state))
    a = flat_np({"params": got, "opt": got_state})
    b = flat_np({"params": want, "opt": want_state})
    differ = sorted(k for k in b if not np.array_equal(a[k], b[k]))
    whole, unit, stacked = gathered_bytes(cfg, mesh)
    full = sh.gather_tree(got, ps, mesh), sh.gather_tree(want, ps, mesh)
    if sh.coordinate(mesh) == {"data": 0, "model": 0}:
        np.savez(out / f"{name}-step.npz", **flat_np(full[0]))
        np.savez(out / f"{name}-whole.npz", **flat_np(full[1]))
    rec = {"loss": [float(metrics["loss"]), want_loss],
           "grad_norm": [float(metrics["grad_norm"]), want_gn],
           "differ": differ, "leaves": len(b),
           "high": high, "whole_high": whole_high, "moved": moved,
           "whole_bytes": whole, "unit_bytes": unit,
           "stacked_whole": stacked,
           "same_tensors": len(returned) == len(given) and all(
               x is y for x, y in zip(returned, given)),
           "same_ptrs": [t.data_ptr() for t in returned] == ptrs}
    if d * m == 2:
        batch = {"tokens": torch.from_numpy(
            tokens(cfg, B, 1)[r0:r0 + rows])}
        want, want_state, want_loss, want_gn = whole_tree_step(
            model, opt, mesh, want, want_state, batch)
        got, got_state, metrics = step(got, got_state, batch)
        a = flat_np({"params": got, "opt": got_state})
        b = flat_np({"params": want, "opt": want_state})
        rec["second"] = {
            "loss": [float(metrics["loss"]), want_loss],
            "grad_norm": [float(metrics["grad_norm"]), want_gn],
            "differ": sorted(k for k in b if not np.array_equal(a[k], b[k])),
            "step": [int(got_state.step), int(want_state.step)]}
    return rec


def unsharded_run(cfg, batch):
    from repro_torch.launch.steps import build_train_step
    model, step, opt = build_train_step(cfg, LR, "cpu")
    init = model.init(0)
    params, opt_state = init, opt.init(init)
    losses = []
    for s in range(STEPS):
        toks = torch.from_numpy(tokens(cfg, batch, s))
        params, opt_state, m = step(params, opt_state, {"tokens": toks})
        losses.append(float(m["loss"]))
    return init, params, losses


def assert_close_to(got: dict, init: dict, want: dict, hybrid=False):
    """Every leaf within the AdamW-noise rule of the module docstring;
    ``hybrid``: the rule ``test_torch_train_ssm.py`` holds zamba2's
    trajectories to, as the module docstring says."""
    assert sorted(got) == sorted(want)
    travel = max(np.abs(want[k] - init[k]).max() for k in want)
    assert travel > 0
    for k in want:
        assert got[k].shape == want[k].shape, k
        diff = np.abs(got[k] - want[k])
        if hybrid:
            tol = 1e-4 * np.abs(want[k]).max() + 1e-6
            assert (diff <= tol).mean() >= 0.999, k
            assert diff.max() <= 2 * LR * STEPS, k
            continue
        tol = max(1e-4 * np.abs(want[k]).max(), 2e-3 * travel)
        assert diff.max() <= tol, k


def _spawn(code, world, tmp, *args, deadline=300.0):
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
    out = tmp_path_factory.mktemp("sharded")
    _spawn(WORKER, 4, out, str(out), str(Path(__file__).resolve().parent))
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    return out, res


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


_UNSHARDED = {}


def unsharded(arch, strategy, batch):
    key = (arch, strategy, batch)
    if key not in _UNSHARDED:
        init, params, losses = unsharded_run(tiny(arch, strategy), batch)
        _UNSHARDED[key] = (flat_np(init), flat_np(params), losses)
    return _UNSHARDED[key]


@pytest.mark.parametrize("strategy", ["dp_all", "tp"])
def test_one_rank_sharded_step_is_the_unsharded_step(world1, strategy):
    cfg = tiny("llama3.2-1b", strategy)
    from repro_torch.parallel.sharding import gather_tree
    params, _, specs, losses = sharded_run(cfg, world1, B)
    _, want, want_losses = unsharded("llama3.2-1b", strategy, B)
    assert losses == want_losses
    got = flat_np(gather_tree(params, specs["params"], world1))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_mesh_invariance(spawned, case):
    out, res = spawned
    arch, strategy, d, m, batch = STEP_CASES[case]
    init, want, want_losses = unsharded(arch, strategy, batch)
    for r in range(4):                   # every rank reports the same loss
        assert res[r][case]["losses"] == res[0][case]["losses"]
    np.testing.assert_allclose(res[0][case]["losses"], want_losses,
                               rtol=2e-4)
    got = dict(np.load(out / f"{case}.npz"))
    assert_close_to(got, init, want)


def test_replicated_batch_counts_its_rows_once():
    """B = 2 does not divide (4, 1): no rank shards the batch."""
    from repro_torch.parallel import sharding as sh

    class FakeMesh:
        axis_names = ("data", "model")
        devices = np.empty((4, 1), dtype=object)

        def get_coordinate(self):
            return [3, 0]
    cfg = tiny("llama3.2-1b", "tp")
    assert sh.local_batch_rows(2, cfg, FakeMesh()) == (0, 2, ())
    assert sh.local_batch_rows(8, cfg, FakeMesh()) == (6, 2, ("data",))
    # dp_all shards over data x model; (4, 1) gives the same rows
    assert sh.local_batch_rows(8, tiny("llama3.2-1b", "dp_all"),
                               FakeMesh()) == (6, 2, ("data", "model"))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b",
                                  "zamba2-7b"])
def test_train_main_on_four_ranks(spawned, arch, tmp_path):
    from repro_torch.launch.train import train_main
    out, res = spawned
    name = {"llama3.2-1b": "main-llama", "rwkv6-1.6b": "main-rwkv6",
            "zamba2-7b": "main-zamba2"}[arch]
    cfg = tiny(arch, "dp_all")
    init = flat_np(model_of(cfg).init(0))
    params, history, driver = train_main(
        override_cfg=cfg, preset="full", steps=STEPS, global_batch=B,
        seq_len=S, checkpoint_dir=str(tmp_path), checkpoint_every=10,
        lr=LR, log_every=0, seed=0, device="cpu")
    assert driver.restarts == 0
    for r in range(4):
        assert res[r][name]["steps"] == list(range(STEPS))
        assert res[r][name]["restarts"] == 0
    np.testing.assert_allclose(res[0][name]["losses"],
                               [h["loss"] for h in history], rtol=2e-4)
    assert_close_to(dict(np.load(out / f"{name}.npz")), init,
                    flat_np(params), hybrid=arch == "zamba2-7b")


def test_injected_failure_restores_every_rank(spawned):
    out, res = spawned
    for r in range(4):
        got = res[r]["main-llama-failed"]
        assert got["restarts"] == 1, r
        assert got["steps"] == list(range(STEPS)), r
        assert got["fired"] == ([2] if r == 1 else []), r
        assert got["losses"] == res[r]["main-llama"]["losses"]
    a = np.load(out / "main-llama.npz")
    b = np.load(out / "main-llama-failed.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_resharded_restore(spawned, world1):
    """(2, 2) -> (4, 1) on the ranks, (2, 2) -> (1, 1) here, bit for bit;
    the reference's manager reads the files."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro_torch.checkpoint import load_checkpoint, restore_resharded
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import sharding as sh
    out, res = spawned
    r41 = res[0]["reshard-4x1"]
    assert r41["step"] == STEPS and r41["keys"] and r41["bitwise"]
    # the (4, 1) blocks are a quarter of the sharded dim
    assert any(v != list(t.shape) for (k, v), t in zip(
        sorted(r41["local_shapes"].items()),
        [t for _, t in sorted(sh._flat_with_path(
            model_of(tiny("llama3.2-1b", "dp_all")).init_abstract()))]))
    cfg = tiny("llama3.2-1b", "dp_all")
    model = model_of(cfg)
    params = model.init(1)
    ps = sh.param_specs(model.init_abstract(), cfg, world1)
    tgt = {"params": params,
           "opt": AdamWState(step=torch.zeros((), dtype=torch.int32),
                             m=params, v=params)}
    specs = {"params": ps, "opt": AdamWState(step=sh.P(), m=ps, v=ps)}
    step, tree, _ = restore_resharded(out / "reshard", tgt, world1, specs)
    _, flat, _ = load_checkpoint(out / "reshard")
    got = flat_np(tree)
    assert step == STEPS and sorted(got) == sorted(flat)
    for k in flat:
        assert np.array_equal(got[k], flat[k]), k
    jstep, jflat, _ = JManager(str(out / "reshard")).restore_flat()
    assert jstep == STEPS and sorted(jflat) == sorted(flat)
    for k in flat:
        assert np.array_equal(np.asarray(jflat[k]), flat[k]), k
    # the saved parameters are the (2, 2) run's gathered ones
    saved = dict(np.load(out / "dp_all-2x2.npz"))
    for k, v in saved.items():
        assert np.array_equal(flat[f"params/{k}"], v), k


def test_leaf_blocks_on_ranks(spawned):
    _, res = spawned
    for r in range(4):
        assert len(res[r]["blocks"]) == 2 * len(SPECS)
        assert all(res[r]["blocks"].values()), res[r]["blocks"]


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_layouts_raise(spawned, case):
    """The layouts this test once held to a refusal (the recurrent
    families under ``tp`` over a model axis > 1) no longer raise: they
    run on every rank and equal the one-device step."""
    out, res = spawned
    arch, strategy, _, _ = REFUSED[case]
    init, want, want_losses = unsharded(arch, strategy, B)
    for r in range(4):
        assert res[r][case]["losses"] == res[0][case]["losses"]
    np.testing.assert_allclose(res[0][case]["losses"], want_losses,
                               rtol=2e-4)
    assert_close_to(dict(np.load(out / f"{case}.npz")), init, want,
                    hybrid=arch == "zamba2-7b")


def _whole(res, name):
    for r in range(4):
        if name in res[r]["whole"]:
            rec = res[r]["whole"][name]
            assert "error" not in rec, (r, rec.get("error"))
            yield r, rec


@pytest.mark.parametrize("case", [c for c, v in WHOLE_CASES.items()
                                  if v[2] * v[3] == 2])
def test_step_is_the_whole_tree_step(spawned, case):
    """On (2, 1) and (1, 2), where each summed axis has two ranks, step 1
    gives the whole-tree step's weights, moments, loss and grad norm bit
    for bit on every rank."""
    _, res = spawned
    recs = list(_whole(res, case))
    assert len(recs) == 2
    for r, rec in recs:
        assert rec["differ"] == [], (r, rec["differ"])
        assert rec["leaves"] > 3
        assert rec["loss"][0] == rec["loss"][1], r
        assert rec["grad_norm"][0] == rec["grad_norm"][1], r


@pytest.mark.parametrize("case", [c for c, v in WHOLE_CASES.items()
                                  if v[2] * v[3] == 2])
def test_second_step_is_the_whole_tree_step(spawned, case):
    """Step 2, each step from its own step 1 on a second batch, is the
    whole-tree step's bit for bit on (2, 1) and (1, 2): the step counter
    written in place, and the bias corrections past step 1."""
    _, res = spawned
    recs = list(_whole(res, case))
    assert len(recs) == 2
    for r, rec in recs:
        two = rec["second"]
        assert two["differ"] == [], (r, two["differ"])
        assert two["step"] == [2, 2], r
        assert two["loss"][0] == two["loss"][1], r
        assert two["grad_norm"][0] == two["grad_norm"][1], r


@pytest.mark.parametrize("case", [c for c, v in WHOLE_CASES.items()
                                  if v[2] * v[3] == 4])
def test_step_near_the_whole_tree_step(spawned, case):
    """On (2, 2), (4, 1) and (1, 4), where four ranks sum an axis in
    another order, step 1's gathered weights hold the whole-tree step's
    by the module's rule; its loss and grad norm within rtol 2e-4 and
    1e-4."""
    out, res = spawned
    arch, strategy, _, _, layers = WHOLE_CASES[case]
    recs = list(_whole(res, case))
    assert len(recs) == 4
    for _, rec in recs:
        np.testing.assert_allclose(rec["loss"][0], rec["loss"][1],
                                   rtol=2e-4)
        np.testing.assert_allclose(rec["grad_norm"][0], rec["grad_norm"][1],
                                   rtol=1e-4)
    cfg = tiny(arch, strategy).replace(num_layers=layers)
    assert_close_to(dict(np.load(out / f"{case}-step.npz")),
                    flat_np(model_of(cfg).init(0)),
                    dict(np.load(out / f"{case}-whole.npz")),
                    hybrid=arch == "zamba2-7b")


@pytest.mark.parametrize("case", sorted(WHOLE_CASES))
def test_gathered_layers_high_water(spawned, case):
    """The bytes of gathered leaves alive at once in a step (``gather_leaf``'s
    meter) never exceed the leaves gathered whole and two remat'd
    regions' layers (one layer; a zamba2 group's two Mamba2 layers),
    where the whole-tree step's reach every gathered leaf of the tree."""
    _, res = spawned
    arch, strategy, d, m, layers = WHOLE_CASES[case]
    cfg = tiny(arch, strategy).replace(num_layers=layers)
    for r, rec in _whole(res, case):
        bound = rec["whole_bytes"] + 2 * rec["unit_bytes"]
        assert rec["high"] <= bound, (r, rec["high"], bound)
        if rec["unit_bytes"]:
            assert rec["whole_high"] > bound, (r, rec["whole_high"], bound)
            assert rec["moved"] > 0
    if arch == "zamba2-7b" and strategy == "dp_all" and d * m == 2:
        # the per-head leaves (10 Mamba2 layers, 8 heads) cut their stack
        # axis over both ranks, and are gathered whole
        assert {"layers/blk/A_log", "layers/blk/dt_bias", "layers/blk/D"} \
            <= set(rec["stacked_whole"])
        assert cfg.num_layers == 14


@pytest.mark.parametrize("case", sorted(WHOLE_CASES))
def test_sharded_step_returns_its_arguments(spawned, case):
    """The sharded step writes its update into the tensors it was given
    and returns them, as the reference's donated step does."""
    _, res = spawned
    for r, rec in _whole(res, case):
        assert rec["same_tensors"] and rec["same_ptrs"], r


def test_one_device_step_leaves_its_arguments():
    """The one-device step returns new tensors and leaves its arguments as
    they were (``build_cell`` calls it again on the same inputs)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.modules import tensors
    cfg = tiny("llama3.2-1b", "dp_all")
    model, step, opt = build_train_step(cfg, LR, "cpu")
    params = model.init(0)
    opt_state = opt.init(params)
    before = [t.clone() for t in tensors((params, opt_state))]
    new, new_state, _ = step(params, opt_state, {"tokens": torch.from_numpy(
        tokens(cfg, B, 0))})
    for t, b in zip(tensors((params, opt_state)), before):
        assert torch.equal(t, b)
    ptrs = {t.data_ptr() for t in tensors((params, opt_state))}
    assert not ptrs & {t.data_ptr() for t in tensors((new, new_state))}


def test_train_main_needs_its_ranks(tmp_path):
    """A (2, 2) mesh without 4 ranks raises before anything runs: with no
    process group (nor torchrun's environment), or with a group of one
    rank (this module's, if it is up)."""
    from repro_torch.launch.train import train_main
    with pytest.raises(ValueError, match="ranks"):
        train_main(data_axis=2, model_axis=2, steps=1, log_every=0,
                   device="cpu", checkpoint_dir=str(tmp_path))
    assert not any(tmp_path.iterdir())
