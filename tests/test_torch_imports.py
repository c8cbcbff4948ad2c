"""The port stands alone and never hides the device: every ``repro_torch``
module imports without loading JAX or the ``repro`` package, no source
imports ``repro``, the entry points default to CUDA and raise where there
is none, and the serving engine refuses every feature it has not ported
instead of ignoring it."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    mods = list(_modules())
    assert "repro_torch.serving.engine" in mods
    assert {"repro_torch.kernels.flash_attn", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline", "repro_torch.runtime.driver",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.kernels.linear_attn", "repro_torch.models.ssm",
            "repro_torch.configs.rwkv6_1_6b", "repro_torch.core.adaptnet",
            "repro_torch.core.dataset", "repro_torch.core.workloads",
            "repro_torch.kernels.adaptnetx",
            "repro_torch.launch.train_adaptnet",
            "repro_torch.launch.selfadaptive_gemm"} <= set(mods)
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(SRC),
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_repro_or_jax():
    for p in PKG.rglob("*.py"):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("repro", "jax"), (p, n)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models.api import build_model
    from repro_torch.serving import EngineConfig, ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_continuous(num_requests=1, log=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_continuous(arch="rwkv6-1.6b", num_requests=1, log=False)
    from repro_torch.core import adaptnet as A
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.sara import train_adaptnet_tpu
    from repro_torch.launch.selfadaptive_gemm import run
    from repro_torch.launch.train_adaptnet import train_serving_adaptnet
    ds = Dataset(np.ones((8, 3), np.int32), np.zeros(8, np.int32), 135)
    with pytest.raises(RuntimeError, match="CUDA"):
        A.train(ds, ds, epochs=1, batch=4, log=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_adaptnet_tpu(n_samples=64, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_serving_adaptnet(64, 1, shapes=[(8, 8, 8)], log=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(n_samples=64, epochs=1, layers=1, log=False)
    # an explicit CPU device runs the plain versions
    assert ServingEngine(cfg, EngineConfig(), device="cpu").device.type == \
        "cpu"


@pytest.mark.parametrize("field,value", [
    ("shared_prefix_decode", True),        # needs prefix_cache
    ("spec_draft", "rwkv6-1.6b"),          # a draft outside the paged families
    ("chaos", object()), ("sanitize", True),
    ("snapshot_dir", "/nonexistent"), ("trace", True),
    ("kv_layout", "dense"), ("prefill_chunk", None), ("buckets", (16,)),
    ("dispatcher_mode", "adaptnet"), ("execute", "pallas")])
def test_engine_refuses_unported_features(field, value):
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving import EngineConfig, ServingEngine
    with pytest.raises(ValueError):
        ServingEngine(get_arch("llama3.2-1b").reduced(),
                      EngineConfig(**{field: value}), device="cpu")


def test_train_entry_point_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch.launch.train import train_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(steps=1, log_every=0, checkpoint_dir=str(tmp_path))


def test_unported_training_routes_raise(tmp_path):
    """Training refuses what it has not ported, before the driver (which
    would retry the error): the blockwise XLA attention route, a mesh,
    and every family but dense GQA; a bank GEMM under autograd raises."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train_main
    from repro_torch.models import transformer
    from repro_torch.models.attention import multihead_attention
    kw = dict(steps=1, log_every=0, device="cpu",
              checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        train_main(**kw)                     # llama's attn_impl is "xla"
    with pytest.raises(NotImplementedError, match="mesh"):
        train_main(data_axis=2, **kw)
    with pytest.raises(NotImplementedError, match="trains"):
        train_main(override_cfg=get_arch("deepseek-v3-671b",
                                         optimized=True), **kw)
    assert not any(tmp_path.iterdir())       # no checkpoint was written
    q = torch.zeros(1, 4, 2, 8)
    for args in (dict(impl="xla"), dict(impl="pallas", q_offset=2),
                 dict(impl="pallas", logit_cap=30.0),
                 dict(impl="pallas", kv_len=3)):
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            multihead_attention(q, q, q, causal=True, **args)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        multihead_attention(q[:, :1], q, q, causal=True, impl="pallas")
    with pytest.raises(NotImplementedError):
        transformer.check_trained_family(get_arch("deepseek-v3-671b"))
