"""Weights cross over: a parameter tree saved by the reference's
``checkpoint/manager.py`` loads through ``repro_torch.checkpoint`` with
numpy alone and becomes the port's parameters unchanged (bit for bit, in
f32 and in bf16)."""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager, _flatten
from repro.configs.registry import get_arch
from repro.models.api import build_model
from repro_torch.checkpoint import load_checkpoint, params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saved_tree_loads_unchanged(tmp_path, dtype):
    jcfg = get_arch("llama3.2-1b").reduced().replace(param_dtype=dtype)
    tcfg = tget_arch("llama3.2-1b").reduced().replace(param_dtype=dtype)
    params = build_model(jcfg).init(jax.random.PRNGKey(1))
    CheckpointManager(str(tmp_path)).save(7, params, metadata={"arch": "x"})
    step, flat, meta = load_checkpoint(tmp_path)
    assert step == 7 and meta == {"arch": "x"}
    ours = params_from_numpy(flat, tcfg, "cpu")
    want = _flatten(params)
    got = dict(_leaves(ours))
    assert set(got) == set(want)
    for key, arr in want.items():
        t = got[key]
        assert t.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
        assert tuple(t.shape) == arr.shape
        if dtype == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  arr.view(np.int16)), key
        else:
            assert np.array_equal(t.numpy(), arr), key


def test_mismatched_leaves_raise(tmp_path):
    tcfg = tget_arch("llama3.2-1b").reduced()
    params = build_model(get_arch("llama3.2-1b").reduced()).init(
        jax.random.PRNGKey(0))
    flat = _flatten(params)
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in flat.items() if k != "embed"},
                          tcfg, "cpu")
    bad = dict(flat)
    bad["ln_f"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError):
        params_from_numpy(bad, tcfg, "cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path)
