"""Training parity of the families the port served but did not train:
gemma-2b (dense MQA, hd 256 at its published widths), internvl2-76b (vlm:
the vision projector's rows prepended to the text, predictions over the
text only) and seamless-m4t-medium (encdec: the bidirectional encoder
and each decoder layer's cross attention over its output), at their
reduced presets, against the reference on the CPU in f32 from
JAX-initialised weights and the same numpy inputs (seeded patch
embeddings and source features).

- The loss and every gradient leaf against ``jax.value_and_grad(model.
  loss)`` on both attention routes (``attn_impl`` "xla", the blockwise
  route, and "pallas", the flash kernels' plain versions against the
  reference's Pallas kernels in interpret mode): the loss to 1e-5
  relative, every gradient leaf to 1e-4 of its largest magnitude plus
  1e-6, as ``test_torch_train.py``.
- ``build_train_step`` carries a batch's ``patch_embeds`` /
  ``src_features`` to the loss: one step from the JAX weights against the
  reference's pieces (``jax.value_and_grad``, AdamW, ``apply_updates``):
  the loss to 1e-5 relative, the grad norm to 1e-4 relative, the new
  weights to 1e-4 of each leaf's largest magnitude plus 1e-6 at 99.9% of
  each leaf's elements and every element within the 2 lr that two Adam
  steps can part by (Adam's normalised step turns the summation-order
  difference of a gradient element near zero into a step of its own: one
  element of seamless's cross ``wk`` in 4096 lands 2.8e-5 off), as
  ``test_torch_train_ssm.py``.
- ``model_flops_estimate``: the reference's count where the frontend's
  rows are the reference's assumed ``seq_len``, and the frontend's own
  row count where ``src_len`` gives it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.launch.steps import make_optimizer as j_make_optimizer
from repro.launch.steps import model_flops_estimate as j_flops
from repro.models.api import build_model as jbuild
from repro.optim.adamw import apply_updates as j_apply_updates
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.launch.steps import (ShapeSpec, build_train_step,
                                      model_flops_estimate)
from repro_torch.models.api import build_model as tbuild
from repro_torch.optim.adamw import tree_map

B, S = 2, 48          # S > loss_chunk and attn_chunk (32): a ragged chunk
N_IMG, SRC = 6, 10    # image rows (vlm), source frames (encdec)
ARCHS = ["gemma-2b", "internvl2-76b", "seamless-m4t-medium"]


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


def _batch(cfg, seed=0):
    """numpy tokens (B, S + 1) and the family's frontend features."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, N_IMG, cfg.frontend.feature_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_features"] = rng.standard_normal(
            (B, SRC, cfg.frontend.feature_dim)).astype(np.float32)
    return batch


def _grads_close(tgrads, jgrads, scale=1e-4):
    want = _flatten(jgrads)
    got = dict(_leaves(tgrads))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=scale * np.abs(w).max() + 1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_every_grad_leaf_match(arch, impl):
    jm, jparams, tcfg, tparams = _pair(arch, impl)
    batch = _batch(tcfg)
    kw = dict(interpret=True) if impl == "pallas" else {}
    with jdispatch.use(execute="xla", **kw):
        (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    loss, met = tbuild(tcfg, device="cpu").loss(
        leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(met) == set(jmet)
    _grads_close(tree_map(lambda p: p.grad, leaves), jgrads)
    if tcfg.family in ("vlm", "encdec"):     # the frontend is trained
        assert float(np.abs(_flatten(jgrads)["frontend/" + (
            "proj" if tcfg.family == "encdec" else "proj1")]).max()) > 0


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-medium"])
def test_train_step_carries_the_frontend_features(arch):
    jm, jparams, tcfg, tparams = _pair(arch)
    batch = _batch(tcfg, seed=1)
    with jdispatch.use(execute="xla"):
        (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jopt = j_make_optimizer(tcfg, 1e-3)
    up, _, jmet = jopt.update(jgrads, jopt.init(jparams), jparams)
    jnew = j_apply_updates(jparams, up)
    _, step_fn, opt = build_train_step(tcfg, lr=1e-3, device="cpu")
    params, _, met = step_fn(tparams, opt.init(tparams),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert abs(float(met["loss"]) - float(jloss)) <= 1e-5 * float(jloss)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
        1e-4 * float(jmet["grad_norm"])
    want = _flatten(jnew)
    for key, t in _leaves(params):
        diff = np.abs(t.numpy() - want[key])
        tol = 1e-4 * np.abs(want[key]).max() + 1e-6
        assert (diff <= tol).mean() >= 0.999, key
        assert diff.max() <= 2 * 1e-3, key          # 2 lr a step


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-76b",
                                  "deepseek-v3-671b"])
def test_model_flops_count_the_frontend_rows(arch):
    _, jparams, tcfg, tparams = _pair(arch)
    shape = ShapeSpec("train", S, B, "train")
    want = float(j_flops(get_arch(arch).reduced(), jparams, shape))
    assert model_flops_estimate(tcfg, tparams, shape) == pytest.approx(
        want, rel=1e-9)
    if tcfg.family == "encdec":      # S source frames: the reference's
        assert model_flops_estimate(tcfg, tparams, shape, src_len=S) == \
            pytest.approx(want, rel=1e-9)
    if tcfg.family in ("encdec", "vlm"):
        few = model_flops_estimate(tcfg, tparams, shape, src_len=SRC)
        more = model_flops_estimate(tcfg, tparams, shape, src_len=2 * SRC)
        assert 0 < few < more
