"""Training parity of the MoE families: qwen2-moe-a2.7b (GQA with q/k/v
biases, shared experts) and deepseek-v3-671b (MLA through its expanded
full-sequence path; one dense and one MoE layer) at their reduced presets,
against the reference on the CPU in f32 from JAX-initialised weights.

- The expert-bank GEMM's gradient: dx and dw of a bank through the port's
  ``dispatch.gemm`` against ``jax.grad`` through the reference's
  ``_gemm_experts`` (the RSA Pallas kernel in interpret mode, vmapped
  custom VJP), each within the f32 summation bound of an f64 product;
  each gradient is one bank product, run with the reference's own
  recommended tile (dx as (M, N, K), dw as (K, M, N)), and both
  registries record the same forward site.
- ``moe_apply``'s aux metrics (load-balance loss, z-loss, drop fraction)
  against the reference's, with no drop and with the capacity factor
  lowered until the stable sort drops claims; the output too.
- The loss and every gradient leaf against ``jax.value_and_grad(model.
  loss)`` on both attention routes (``attn_impl`` "xla", the blockwise
  route, and "pallas", the flash kernels' plain versions against the
  reference's Pallas kernels in interpret mode), with every aux metric:
  the loss to 1e-5 relative, every gradient leaf to 1e-4 of its largest
  magnitude plus 1e-6, as ``test_torch_train.py``; the aux metrics to
  1e-5 of their size (the drop fraction's f32 ``1 - mean`` is -3e-8 on
  the reference's side where the port's is 0).
- qwen2-moe's ``train_main``: three steps from the JAX weights against
  the reference's manual loop (``jax.value_and_grad``, AdamW,
  ``apply_updates``): each step's loss to 1e-5 relative, its grad norm to
  1e-4 relative, the final weights to 1e-4 of each leaf's largest
  magnitude plus 1e-6 at 99.9% of its elements and every element within
  the 2 lr a step two Adam runs can part by (as
  ``test_torch_train_ssm.py``); the key bias, whose gradient is zero but
  for rounding (the softmax takes away what it adds to a row), is held
  to the 2 lr bound alone; the driver never restarts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.core.sara import SaraDispatcher as JDispatcher
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import _batch as j_batch
from repro.dispatch.executor import _clamped_blocks as j_clamped
from repro.launch.steps import make_optimizer as j_make_optimizer
from repro.models import moe as jmoe
from repro.models.api import build_model as jbuild
from repro.optim.adamw import apply_updates as j_apply_updates
from repro_torch import dispatch
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core.sara import SaraDispatcher
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models.api import Model, build_model as tbuild
from repro_torch.optim.adamw import tree_map

B, S = 2, 48          # S > loss_chunk and attn_chunk (32): a ragged chunk
ARCHS = ["qwen2-moe-a2.7b", "deepseek-v3-671b"]
AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
# leaves whose gradient is zero but for rounding: a key bias adds the same
# q . b_k to every score of a row, which the softmax takes away, so Adam's
# normalised step walks each element by the sign of rounding noise
NOISE_LEAVES = ("layers/attn/bk",)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


_PAIRS = {}


def _pair(arch, impl="xla"):
    """(jm, jparams, tcfg, tparams) of the reduced ``arch`` with
    ``attn_impl=impl``; the JAX weights are drawn once an arch."""
    if arch not in _PAIRS:
        jp = jbuild(get_arch(arch).reduced()).init(jax.random.PRNGKey(0))
        _PAIRS[arch] = (jp, params_from_numpy(
            _flatten(jp), tget_arch(arch).reduced(), "cpu"))
    jp, tp = _PAIRS[arch]
    return (jbuild(get_arch(arch).reduced().replace(attn_impl=impl)), jp,
            tget_arch(arch).reduced().replace(attn_impl=impl), tp)


def _tokens(vocab, step=0):
    return j_batch(JDataConfig(vocab, S, B, seed=3), step)["tokens"]


def test_bank_gradient_matches_pallas_vjp(monkeypatch):
    from repro_torch.dispatch import executor
    rng = np.random.default_rng(11)
    Bn, E, C, K, N = 2, 4, 6, 40, 24
    M = Bn * C
    x = rng.standard_normal((Bn, E, C, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    dy = np.cos(np.einsum("beck,ekn->becn", x.astype(np.float64), w))

    def f(x, w):
        return jnp.sum(jnp.sin(jdispatch.gemm(x, w,
                                              site="moe.expert.gate")))

    jreg = jdispatch.SiteRegistry()
    with jdispatch.use(JDispatcher(), execute="pallas", interpret=True,
                       registry=jreg), jreg.scope("train"):
        jx, jw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    ran = []
    real = executor._run
    monkeypatch.setattr(executor, "_run", lambda a, b, tile, *r:
                        ran.append((tuple(a.shape), tile)) or
                        real(a, b, tile, *r))
    treg = dispatch.SiteRegistry()
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    with dispatch.use(SaraDispatcher(), registry=treg), treg.scope("train"):
        torch.sin(dispatch.gemm(tx, tw, site="moe.expert.gate")).sum() \
            .backward()
    # the f32 summation bound of each gradient against the f64 product,
    # doubled: each package's dy = cos(y) carries its own rounding of y
    xe = np.abs(x).transpose(1, 0, 2, 3).reshape(E, M, K).astype(np.float64)
    dye = dy.transpose(1, 0, 2, 3).reshape(E, M, N)
    bx = N * 2.0 ** -24 * (np.abs(dye) @ np.abs(w).transpose(0, 2, 1))
    bw = M * 2.0 ** -24 * (xe.transpose(0, 2, 1) @ np.abs(dye))
    dx64 = dye @ w.transpose(0, 2, 1).astype(np.float64)
    dw64 = x.transpose(1, 0, 2, 3).reshape(E, M, K).transpose(0, 2, 1) \
        .astype(np.float64) @ dye
    tdx = tx.grad.numpy().transpose(1, 0, 2, 3).reshape(E, M, K)
    jdx = np.asarray(jx).transpose(1, 0, 2, 3).reshape(E, M, K)
    for got, want, ref, bound in ((tdx, jdx, dx64, bx),
                                  (tw.grad.numpy(), np.asarray(jw), dw64,
                                   bw)):
        assert (np.abs(got - ref) <= 2 * bound + 1e-30).all()
        assert (np.abs(want - ref) <= 2 * bound + 1e-30).all()
    # forward, dx and dw: one bank product each, the reference's tiles
    disp = JDispatcher()
    tiles = {shape: tile for shape, tile in ran}
    for shape, (m, k, n) in (((E, M, K), (M, K, N)), ((E, M, N), (M, N, K)),
                             ((E, K, M), (K, M, N))):
        c = disp.recommend(m, k, n)
        assert tiles[shape] == j_clamped(c, m, k, n) + (c.mode,), shape
    assert len(ran) == 3

    def plan(reg):
        return {name: (r.m, r.k, r.n, r.executed())
                for name, r in reg.sites("train").items()}

    assert plan(treg) == plan(jreg) == {
        "moe.expert.gate": (M, K, N, plan(jreg)["moe.expert.gate"][3])}


@pytest.mark.parametrize("capacity_factor,Bn,Sn", [(None, 3, 5),
                                                   (0.5, 2, 24)])
def test_moe_aux_matches_reference(capacity_factor, Bn, Sn):
    arch = "deepseek-v3-671b"
    jcfg, tcfg = get_arch(arch).reduced(), tget_arch(arch).reduced()
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jp.items()}
    x = np.random.default_rng(Sn).standard_normal(
        (Bn, Sn, jcfg.d_model)).astype(np.float32)
    with jdispatch.use(execute="xla"):
        jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                                  with_aux=True)
        plain = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(ty, plain)          # the same decision either way
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < 1e-5
    assert set(taux) == set(jaux) == set(AUX)
    for k in AUX:
        want = float(jaux[k])
        assert abs(float(taux[k]) - want) <= 1e-5 * max(1.0, abs(want)), k
    drop = float(taux["moe_drop_frac"])
    assert drop > 0.1 if capacity_factor else drop == 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_every_grad_leaf_match(arch, impl):
    jm, jparams, tcfg, tparams = _pair(arch, impl)
    tokens = _tokens(tcfg.vocab_size)
    kw = dict(interpret=True) if impl == "pallas" else {}
    with jdispatch.use(execute="xla", **kw):
        (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
            jparams, {"tokens": jnp.asarray(tokens)})
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    loss, met = tbuild(tcfg, device="cpu").loss(
        leaves, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(met) == set(jmet)
    for k in ("ce_loss",) + AUX:
        want = float(jmet[k])
        got = float(met[k].detach())
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), k
    assert float(met["moe_lb_loss"].detach()) > 0 and \
        float(met["moe_z_loss"].detach()) > 0
    want = _flatten(jgrads)
    got = dict(_leaves(tree_map(lambda p: p.grad, leaves)))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6,
                                   err_msg=key)


def test_three_step_trajectory_matches_reference_pieces(monkeypatch,
                                                        tmp_path):
    arch = "qwen2-moe-a2.7b"
    jm, jparams, tcfg, tparams = _pair(arch)
    monkeypatch.setattr(Model, "init", lambda self, seed=0: {
        k: v for k, v in tparams.items()})
    params, history, driver = ttrain.train_main(
        arch=arch, preset="reduced", steps=3, global_batch=B, seq_len=S,
        checkpoint_dir=str(tmp_path), lr=1e-3, log_every=0, seed=3,
        device="cpu")
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
        assert abs(h["loss"] - float(loss)) <= 1e-5 * float(loss)
        assert abs(h["grad_norm"] - float(met["grad_norm"])) <= \
            1e-4 * float(met["grad_norm"])
    want = _flatten(p)
    for key, t in _leaves(params):
        diff = np.abs(t.numpy() - want[key])
        tol = 1e-4 * np.abs(want[key]).max() + 1e-6
        if key not in NOISE_LEAVES:
            assert (diff <= tol).mean() >= 0.999, key
        assert diff.max() <= 2 * 1e-3 * 3, key      # 2 lr a step, 3 steps
