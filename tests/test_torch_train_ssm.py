"""Training parity of the recurrent families: rwkv6-1.6b (the ssm family,
RWKV6) and zamba2-7b (the hybrid: Mamba2 blocks and a weight-shared
attention block) at their reduced presets, against the reference's
pieces on the CPU in f32, from the same weights (JAX-initialised, carried
across with ``params_from_numpy``) and the same batches.

- The WKV gradient: ``ops.wkv_attention`` forwards through the kernel's
  plain version and differentiates the plain chunked scan, as the
  reference's ``custom_vjp`` does; every input's gradient against
  ``jax.grad`` of the reference's ``wkv_attention`` (its Pallas kernel in
  interpret mode, its backward through ``_wkv_chunked``) at 1e-4 of the
  largest magnitude, and bitwise against autograd through the plain scan.
- The loss and every gradient leaf against ``jax.value_and_grad(model.
  loss)`` on both routes of each family (rwkv6: ``ssm_impl`` "pallas",
  the WKV kernel, and "xla", the einsum scan; zamba2: ``attn_impl``
  "pallas", the flash kernels, and "xla", the blockwise route): the loss
  to 1e-5 relative and every gradient leaf to 1e-4 of its largest
  magnitude plus 1e-6, as ``test_torch_train.py`` (f32, summed in another
  order through two layers or two groups and a remainder).
- The training forward's logits (5e-5, logits ~4).
- ``train_main`` for both archs: three steps from the JAX weights equal
  the reference's manual loop (``jax.value_and_grad``, AdamW,
  ``apply_updates``): each step's loss to 1e-5 relative, grad norm to
  1e-4 relative; the final weights to 1e-4 of each leaf's largest
  magnitude plus 1e-6 at 99.9% of each leaf's elements, and every element
  within the 2 lr a step that two Adam runs can part by (Adam's
  normalised step turns the summation-order difference of a gradient
  element near zero into a step of its own: one w_out element of zamba2
  in 40960 lands 4e-5 off); the loss falls and the driver never
  restarts.  Its final
  checkpoint restores in the reference's manager bit for bit.
- Every family is admitted; ``train_main`` refuses vlm and encdec (its
  loader feeds tokens only) before the driver.
- ``launch/probe_grad.py`` (the card's f64 witness for phase 14c) on the
  CPU: its f64 step comes back f64 and within f32 rounding of the f32
  steps.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro.kernels import ops as jops
from repro.launch.steps import make_optimizer as j_make_optimizer
from repro.models.api import build_model as jbuild
from repro.optim.adamw import apply_updates as j_apply_updates
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models.api import Model, build_model as tbuild
from repro_torch.optim.adamw import tree_map

B, S = 2, 48          # S > loss_chunk (32) and > the ssm chunk (16)
ROUTES = [("rwkv6-1.6b", "ssm_impl", "pallas"),
          ("rwkv6-1.6b", "ssm_impl", "xla"),
          ("zamba2-7b", "attn_impl", "pallas"),
          ("zamba2-7b", "attn_impl", "xla")]


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


def _pair(arch, field=None, impl=None):
    """(jm, jparams, tcfg, tparams) of the reduced ``arch`` with ``field``
    set to ``impl``; the JAX weights are drawn once an arch."""
    if arch not in _PAIRS:
        jp = jbuild(get_arch(arch).reduced()).init(jax.random.PRNGKey(0))
        _PAIRS[arch] = (jp, params_from_numpy(
            _flatten(jp), tget_arch(arch).reduced(), "cpu"))
    jp, tp = _PAIRS[arch]
    kw = {field: impl} if field else {}
    return (jbuild(get_arch(arch).reduced().replace(**kw)), jp,
            tget_arch(arch).reduced().replace(**kw), tp)


def _tokens(vocab, step=0):
    return j_batch(JDataConfig(vocab, S, B, seed=3), step)["tokens"]


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


@pytest.mark.parametrize("Bn,Sn,H,K,chunk", [(2, 100, 3, 16, 32),
                                             (1, 64, 2, 8, 64),
                                             (3, 1, 4, 16, 1)])
def test_wkv_gradient_matches_reference_vjp(Bn, Sn, H, K, chunk):
    rng = np.random.default_rng(Sn)
    r, k, v = (rng.standard_normal((Bn, Sn, H, K)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((Bn, Sn, H, K)) * 0.5 - 2.0).astype(
        np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((Bn, H, K, K)) * 0.3).astype(np.float32)
    w_o = rng.standard_normal((Bn, Sn, H, K)).astype(np.float32)
    w_s = rng.standard_normal((Bn, H, K, K)).astype(np.float32)

    def jloss(*a):
        o, sf = jops.wkv_attention(*a, chunk=chunk, interpret=True)
        return jnp.sum(o * w_o) + jnp.sum(sf * w_s)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (r, k, v, lw, u, s0)))
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (r, k, v, lw, u, s0)]
    o, sf = ops.wkv_attention(*ins, chunk=chunk)
    ((o * torch.from_numpy(w_o)).sum() +
     (sf * torch.from_numpy(w_s)).sum()).backward()
    got = [t.grad.clone() for t in ins]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6)
    for t in ins:
        t.grad = None
    o, sf = ops._wkv_scan_padded(*ins, chunk)
    ((o * torch.from_numpy(w_o)).sum() +
     (sf * torch.from_numpy(w_s)).sum()).backward()
    for g, t in zip(got, ins):
        assert torch.equal(g, t.grad)


@pytest.mark.parametrize("arch,field,impl", ROUTES,
                         ids=[f"{a}-{i}" for a, _, i in ROUTES])
def test_loss_and_every_grad_leaf_match(arch, field, impl):
    jm, jparams, tcfg, tparams = _pair(arch, field, impl)
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
    _assert_grads_close(tree_map(lambda p: p.grad, leaves), jgrads)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_training_logits_match(arch):
    jm, jparams, tcfg, tparams = _pair(arch)
    tokens = _tokens(tcfg.vocab_size, step=1)
    with jdispatch.use(execute="xla"):
        want = np.asarray(jm.logits(jparams,
                                    {"tokens": jnp.asarray(tokens)}))
    with torch.no_grad():
        got = tbuild(tcfg, device="cpu").logits(
            tparams, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert got.shape == want.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_three_step_trajectory_matches_reference_pieces(arch, monkeypatch,
                                                        tmp_path):
    """``train_main`` (optimized profile) from the JAX weights against the
    reference's manual loop on its optimized profile's config; the final
    checkpoint restores in the reference's manager bit for bit."""
    jm, jparams, tcfg, tparams = _pair(arch)
    monkeypatch.setattr(Model, "init", lambda self, seed=0: {
        k: v for k, v in tparams.items()})
    params, history, driver = ttrain.train_main(
        preset="reduced", steps=3, global_batch=B, seq_len=S,
        checkpoint_dir=str(tmp_path), checkpoint_every=3, lr=1e-3,
        log_every=0, seed=3, override_cfg=tget_arch(arch, optimized=True),
        device="cpu")
    assert driver.restarts == 0
    jm = jbuild(get_arch(arch, optimized=True).reduced())
    opt = j_make_optimizer(tcfg, 1e-3)
    jstate, p = opt.init(jparams), jparams
    dcfg = JDataConfig(tcfg.vocab_size, S, B, seed=3)
    for step in range(3):
        batch = {"tokens": jnp.asarray(j_batch(dcfg, step)["tokens"])}
        with jdispatch.use(execute="xla", interpret=True):
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
        diff = np.abs(t.numpy() - want[key])
        tol = 1e-4 * np.abs(want[key]).max() + 1e-6
        assert (diff <= tol).mean() >= 0.999, key
        assert diff.max() <= 2 * 1e-3 * 3, key      # 2 lr a step, 3 steps
    step, tree, _ = JManager(str(tmp_path)).restore(
        {"params": jparams, "opt": opt.init(jparams)})
    assert step == 3
    for key, a in _flatten(tree["params"]).items():
        assert np.array_equal(a, dict(_leaves(params))[key].numpy()), key


def test_untrained_families_still_raise(tmp_path):
    """Every served family trains now; ``train_main`` still refuses the
    frontend families, whose batches need features its token loader does
    not make, before the driver writes anything."""
    from repro_torch.models.transformer import check_trained_family
    for arch in ("rwkv6-1.6b", "zamba2-7b", "llama3.2-1b",
                 "deepseek-v3-671b", "qwen2-moe-a2.7b",
                 "seamless-m4t-medium", "internvl2-76b"):
        check_trained_family(tget_arch(arch))
    for arch in ("seamless-m4t-medium", "internvl2-76b"):
        with pytest.raises(ValueError, match="feeds tokens only"):
            ttrain.train_main(arch=arch, steps=1, log_every=0,
                              device="cpu", checkpoint_dir=str(tmp_path))
    assert not any(tmp_path.iterdir())


def test_grad_norm_grows_with_depth_in_both_packages():
    """rwkv6's random-init gradient grows with depth in the reference as in
    the port (reduced widths, 2 and 24 layers, printed with ``-s``): the
    grad norm of both packages within 1e-4 relative of each other at
    both depths, and at 24 layers more than 3x its 2-layer value.  The
    growth is why the card's 24-layer step 1 is also held against an f64
    step (chip_smoke.py phase 14c, ``launch/probe_grad.py``)."""
    norms = {}
    for L in (2, 24):
        jcfg = get_arch("rwkv6-1.6b").reduced().replace(num_layers=L)
        tcfg = tget_arch("rwkv6-1.6b").reduced().replace(num_layers=L)
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tokens = _tokens(tcfg.vocab_size)
        with jdispatch.use(execute="xla"):
            _, g = jax.value_and_grad(jm.loss, has_aux=True)(
                jp, {"tokens": jnp.asarray(tokens)})
        jn = float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                               for x in jax.tree_util.tree_leaves(g))))
        leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                          params_from_numpy(_flatten(jp), tcfg, "cpu"))
        loss, _ = tbuild(tcfg, device="cpu").loss(
            leaves, {"tokens": torch.from_numpy(tokens)})
        loss.backward()
        tn = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                  for _, p in _leaves(leaves))))
        print(f"rwkv6 reduced, {L} layers: grad norm reference {jn:.6f}, "
              f"port {tn:.6f}")
        assert abs(tn - jn) <= 1e-4 * jn
        norms[L] = jn
    assert norms[24] > 3 * norms[2]


def test_probe_grad_holds_f32_steps_against_an_f64_step(tmp_path):
    """``launch/probe_grad.py`` on the CPU (reduced rwkv6, 2 layers, in a
    process of its own: it rebinds f32 to f64): the f64 step's gradient
    comes back f64 (the script fails otherwise) and differs from the f32
    steps' by f32 rounding only (above 0, within 1e-5 of its norm); the
    kernel run is the plain run here; a one-ulp move of the weights moves
    the gradient; every layer of the stacked leaves has its distance."""
    out = tmp_path / "probe.json"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.probe_grad", "--device",
         "cpu", "--preset", "reduced", "--layers", "2", "--seq", "32",
         "--lrs", "", "--runs", "kernel,plain,ulp_a,f64", "--out", str(out)],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    rec = json.loads(out.read_text())
    vs64 = rec["vs_f64"]
    assert set(vs64["whole"]) == {"plain", "kernel", "ulp_a"}
    assert 0 < vs64["whole"]["plain"] <= 1e-5
    assert vs64["whole"]["kernel"] == vs64["whole"]["plain"]
    assert rec["vs_plain"]["whole"]["kernel"] == 0
    assert rec["vs_plain"]["whole"]["ulp_a"] > 0
    assert len(vs64["layer"]["plain"]) == 2
    gn = rec["grad_norm"]
    assert abs(gn["plain"] - gn["f64"]) <= 1e-5 * gn["f64"]
    assert abs(rec["loss"]["plain"] - rec["loss"]["f64"]) <= \
        1e-6 * rec["loss"]["f64"]
