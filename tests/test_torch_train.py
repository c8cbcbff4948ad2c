"""Training parity: the port's train path against the reference's pieces on
the reduced llama3.2-1b (optimized profile: ``attn_impl="pallas"``, the
flash-attention kernels), from the same weights (JAX-initialised, carried
across with ``params_from_numpy``) and the same batches.

The reference's own ``train_main`` does not run on this JAX (its
``_embed`` hint asks for a ``data`` mesh axis that a meshless run lacks,
and its driver retries the error until ``max_restarts``), so the
trajectory is held against a manual loop of its pieces:
``jax.value_and_grad(model.loss)``, ``AdamW.update``, ``apply_updates``.

Tolerances (f32 throughout): the loss to 1e-5 relative and every gradient
leaf to 1e-4 of its largest magnitude plus 1e-6 — two layers of f32 GEMMs,
attention and softmax summed in another order on each side, through a
backward pass that sums over all 2 x 48 tokens.  The data pipeline is
bitwise the reference's; a saved checkpoint restores bitwise in the other
package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import _batch as j_batch
from repro.launch.steps import make_optimizer as j_make_optimizer
from repro.models.api import build_model as jbuild
from repro.optim.adamw import apply_updates as j_apply_updates
from repro_torch import dispatch
from repro_torch.checkpoint import CheckpointManager, params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.data.pipeline import DataConfig, _batch
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train_step, make_optimizer
from repro_torch.models.api import Model, build_model as tbuild
from repro_torch.optim.adamw import apply_updates, tree_map

B, S = 2, 48          # S > loss_chunk/attn_chunk (32): ragged last chunk


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def setup():
    jcfg = get_arch("llama3.2-1b", optimized=True).reduced()
    tcfg = tget_arch("llama3.2-1b", optimized=True).reduced()
    assert jcfg.attn_impl == tcfg.attn_impl == "pallas"
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    tokens = j_batch(JDataConfig(jcfg.vocab_size, S, B, seed=3), 0)["tokens"]
    return jm, jparams, tcfg, tparams, tokens


def _jax_loss_and_grads(jm, jparams, tokens, execute, registry=None):
    kw = dict(interpret=True) if execute == "pallas" else {}
    reg = registry if registry is not None else jdispatch.SiteRegistry()
    with jdispatch.use(execute=execute, registry=reg, **kw), \
            reg.scope("train_step"):
        (loss, metrics), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            jparams, {"tokens": jnp.asarray(tokens)})
    return loss, metrics, grads


def _assert_grads_close(tgrads, jgrads):
    want = _flatten(jgrads)
    got = dict(_leaves(tgrads))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("rows", [(0, None), (1, 2)])
def test_batches_are_the_reference_bitwise(rows):
    start, n = rows
    for step in (0, 5):
        cfg = dict(vocab_size=512, seq_len=40, global_batch=3, seed=11,
                   row_start=start, rows=n)
        want = j_batch(JDataConfig(**cfg), step)["tokens"]
        got = _batch(DataConfig(**cfg), step)["tokens"]
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("execute", ["xla", "pallas"])
def test_loss_and_every_grad_leaf_match(setup, execute):
    """The reference with its GEMMs as einsum (``xla``) or through the RSA
    Pallas kernel in interpret mode (``pallas``, the custom-VJP dx/dw);
    attention through the Pallas flash kernel in both."""
    jm, jparams, tcfg, tparams, tokens = setup
    jloss, jmet, jgrads = _jax_loss_and_grads(jm, jparams, tokens, execute)
    model = tbuild(tcfg, device="cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    loss, met = model.loss(leaves, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(met) == set(jmet)
    _assert_grads_close(tree_map(lambda p: p.grad, leaves), jgrads)


@pytest.mark.parametrize("causal_skip", [False, True])
def test_loss_and_grads_on_the_blockwise_route(causal_skip):
    """``attn_impl="xla"`` (the config's default): attention through the
    blockwise route, which autograd differentiates as ``jax.grad`` does
    the reference's scan; S = 48 over chunks of 32 (one full, one ragged
    chunk), with the triangular walk too.  Tolerances as above."""
    jcfg = get_arch("llama3.2-1b").reduced().replace(
        flash_causal_skip=causal_skip)
    tcfg = tget_arch("llama3.2-1b").reduced().replace(
        flash_causal_skip=causal_skip)
    assert jcfg.attn_impl == tcfg.attn_impl == "xla"
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    tokens = j_batch(JDataConfig(jcfg.vocab_size, S, B, seed=3), 0)["tokens"]
    jloss, _, jgrads = _jax_loss_and_grads(jm, jparams, tokens, "xla")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    loss, _ = tbuild(tcfg, device="cpu").loss(
        leaves, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_grads_close(tree_map(lambda p: p.grad, leaves), jgrads)


def test_logits_match(setup):
    jm, jparams, tcfg, tparams, tokens = setup
    with jdispatch.use(execute="xla"):
        want = np.asarray(jm.logits(jparams, {"tokens": jnp.asarray(tokens)}))
    with torch.no_grad():
        got = tbuild(tcfg, device="cpu").logits(
            tparams, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert got.shape == want.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_adamw_update_matches(setup):
    """One AdamW step (clipping, f32 moments, bias correction, decoupled
    weight decay on every leaf of rank >= 2) on the reference's gradients,
    fed to both optimizers."""
    jm, jparams, tcfg, tparams, tokens = setup
    _, _, jgrads = _jax_loss_and_grads(jm, jparams, tokens, "xla")
    jopt = j_make_optimizer(tcfg, 1e-3)
    topt = make_optimizer(tcfg, 1e-3)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    tgrads = params_from_numpy(_flatten(jgrads), tcfg, "cpu")
    for _ in range(2):        # the second step sees non-zero moments
        jup, jstate, jmet = jopt.update(jgrads, jstate, jparams)
        tup, tstate, tmet = topt.update(tgrads, tstate, tparams)
        jnew = j_apply_updates(jparams, jup)
        tnew = apply_updates(tparams, tup)
        assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
            1e-6 * float(jmet["grad_norm"])
        assert int(tstate.step) == int(jstate.step)
        for name, j, t in (("params", jnew, tnew), ("m", jstate.m, tstate.m),
                           ("v", jstate.v, tstate.v)):
            want = _flatten(j)
            for key, tv in _leaves(t):
                np.testing.assert_allclose(
                    tv.numpy(), want[key], rtol=1e-6,
                    atol=1e-6 * np.abs(want[key]).max() + 1e-12,
                    err_msg=f"{name}/{key}")


def test_train_step_registry_matches(setup):
    """One train step's executed GEMM plan (site, M, K, N and tile) is the
    reference's under ``reg.scope("train_step")``: the forward sites only
    (the gradient GEMMs and the recomputation record nothing new)."""
    jm, jparams, tcfg, tparams, tokens = setup
    jreg = jdispatch.SiteRegistry()
    _jax_loss_and_grads(jm, jparams, tokens, "xla", jreg)
    treg = dispatch.SiteRegistry()
    _, step_fn, opt = build_train_step(tcfg, lr=1e-3, device="cpu")
    with dispatch.use(registry=treg), treg.scope("train_step"):
        step_fn(tparams, opt.init(tparams),
                {"tokens": torch.from_numpy(tokens)})

    def plan(reg):
        return {name: (r.m, r.k, r.n, r.executed())
                for name, r in reg.sites("train_step").items()}

    assert plan(treg) == plan(jreg)
    assert set(plan(treg)) == {"layer.attn.q", "layer.attn.k",
                               "layer.attn.v", "layer.attn.out",
                               "layer.mlp.gate", "layer.mlp.up",
                               "layer.mlp.down", "loss.unembed"}


def _port_train(monkeypatch, tparams, tmp_path, steps, **kw):
    monkeypatch.setattr(Model, "init", lambda self, seed=0: {
        k: v for k, v in tparams.items()})
    return ttrain.train_main(
        preset="reduced", steps=steps, global_batch=B, seq_len=S,
        checkpoint_dir=str(tmp_path), lr=1e-3, log_every=0, seed=3,
        override_cfg=tget_arch("llama3.2-1b", optimized=True),
        device="cpu", **kw)


def test_three_step_trajectory_matches_reference_pieces(setup, monkeypatch,
                                                        tmp_path):
    jm, jparams, tcfg, tparams, _ = setup
    params, history, driver = _port_train(monkeypatch, tparams, tmp_path, 3)
    assert driver.restarts == 0
    opt = j_make_optimizer(tcfg, 1e-3)
    jstate = opt.init(jparams)
    p = jparams
    dcfg = JDataConfig(tcfg.vocab_size, S, B, seed=3)
    for step in range(3):
        batch = {"tokens": jnp.asarray(j_batch(dcfg, step)["tokens"])}
        with jdispatch.use(execute="xla"):
            (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(p, batch)
        up, jstate, met = opt.update(g, jstate, p)
        p = j_apply_updates(p, up)
        h = history[step]
        assert h["step"] == step
        assert abs(h["loss"] - float(loss)) <= 1e-5 * float(loss)
        assert abs(h["grad_norm"] - float(met["grad_norm"])) <= \
            1e-4 * float(met["grad_norm"])
    assert history[-1]["loss"] < history[0]["loss"]
    want = _flatten(p)
    for key, t in _leaves(params):
        np.testing.assert_allclose(t.numpy(), want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max(),
                                   err_msg=key)


def test_injected_failure_restores_and_replays(setup, monkeypatch, tmp_path):
    """A step that raises restores the latest checkpoint and replays from
    it: one restart, and the same losses and final weights as a run with
    no failure, bit for bit."""
    *_, tparams, _ = setup
    clean, hist0, _ = _port_train(monkeypatch, tparams, tmp_path / "a", 3,
                                  checkpoint_every=2)
    fired = []

    def injector(step):
        if step == 1 and not fired:
            fired.append(step)
            raise RuntimeError("simulated preemption")

    params, hist, driver = _port_train(monkeypatch, tparams, tmp_path / "b",
                                       3, checkpoint_every=2,
                                       fail_injector=injector)
    assert driver.restarts == 1
    # step 0 ran twice (before the failure and after the restore)
    assert [h["step"] for h in hist] == [0, 0, 1, 2]
    assert [h["loss"] for h in hist[1:]] == [h["loss"] for h in hist0]
    for (key, a), (_, b) in zip(_leaves(params), _leaves(clean)):
        assert torch.equal(a, b), key


def test_checkpoints_cross_between_packages(setup, tmp_path):
    """A training state saved by the port restores through the reference's
    ``CheckpointManager.restore`` bit for bit, and the reverse."""
    jm, jparams, tcfg, tparams, _ = setup
    jopt, topt = j_make_optimizer(tcfg, 1e-3), make_optimizer(tcfg, 1e-3)
    tstate = topt.init(tparams)
    tstate = tstate._replace(step=tstate.step + 5,
                             m={k: v for k, v in tparams.items()})
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(5, {"params": tparams, "opt": tstate}, metadata={"step": 5},
             blocking=False)
    mgr.wait()
    jtarget = {"params": jparams, "opt": jopt.init(jparams)}
    step, jtree, meta = JManager(str(tmp_path / "port")).restore(jtarget)
    assert step == 5 and meta == {"step": 5}
    assert int(jtree["opt"].step) == 5
    want = dict(_leaves({"params": tparams, "opt": {"m": tstate.m,
                                                    "v": tstate.v}}))
    got = _flatten({"params": jtree["params"],
                    "opt": {"m": jtree["opt"].m, "v": jtree["opt"].v}})
    assert set(got) == set(want)
    for key, t in want.items():
        assert np.array_equal(got[key], t.numpy()), key

    jstate = jopt.init(jparams)._replace(step=jnp.int32(7), v=jparams)
    JManager(str(tmp_path / "ref")).save(7, {"params": jparams,
                                             "opt": jstate})
    step, ttree, _ = CheckpointManager(tmp_path / "ref").restore(
        {"params": tparams, "opt": topt.init(tparams)})
    assert step == 7 and int(ttree["opt"].step) == 7
    want = _flatten({"params": jparams, "opt": {"v": jstate.v}})
    got = dict(_leaves({"params": ttree["params"],
                        "opt": {"v": ttree["opt"].v}}))
    for key, w in want.items():
        assert np.array_equal(got[key].numpy(), w), key


def test_schedule_and_clipping_match():
    """``cosine_schedule`` (warmup, cosine, floor) and global-norm clipping
    against the reference's, in f32."""
    from repro.optim.adamw import clip_by_global_norm as j_clip
    from repro.optim.adamw import cosine_schedule as j_cosine
    from repro_torch.optim.adamw import clip_by_global_norm, cosine_schedule
    jl, tl = j_cosine(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert abs(float(tl(step)) - float(jl(step))) <= 1e-6 * 1e-3, step
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):              # clipped, and left alone
        jt, jn = j_clip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
        tt, tn = clip_by_global_norm(tree_map(torch.from_numpy, tree),
                                     max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for key, t in _leaves(tt):
            np.testing.assert_allclose(t.numpy(), _flatten(jt)[key],
                                       rtol=1e-6, atol=1e-7)
