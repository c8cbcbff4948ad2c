"""The port stands alone and never hides the device: every ``repro_torch``
module imports without loading JAX or the ``repro`` package, no source
imports ``repro``, the entry points default to CUDA and raise where there
is none, and the serving engine refuses every feature it has not ported,
and every combination the reference refuses, instead of ignoring it."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"
# the port's files outside its package: the example drivers and the CPU
# gate's trace check
EXTRA = sorted((SRC.parent / "examples" / "torch").glob("*.py")) + \
    [SRC.parent / "scripts" / "check_trace_torch.py"]


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
            "repro_torch.configs.rwkv6_1_6b",
            "repro_torch.configs.zamba2_7b", "repro_torch.core.adaptnet",
            "repro_torch.core.dataset", "repro_torch.core.workloads",
            "repro_torch.kernels.adaptnetx",
            "repro_torch.launch.train_adaptnet",
            "repro_torch.launch.selfadaptive_gemm",
            "repro_torch.core.rsa", "repro_torch.core.costmodel",
            "repro_torch.core.sigma", "repro_torch.core.ppa",
            "repro_torch.core.adaptnetx_model",
            "repro_torch.core.baselines",
            "repro_torch.launch.sagar", "repro_torch.obs",
            "repro_torch.obs.trace", "repro_torch.obs.spans",
            "repro_torch.obs.export", "repro_torch.runtime.failplan",
            "repro_torch.serving.faults",
            "repro_torch.serving.snapshot",
            "repro_torch.parallel.sharding", "repro_torch.parallel.hints",
            "repro_torch.parallel.collectives",
            "repro_torch.parallel.tp", "repro_torch.parallel.fsdp",
            "repro_torch.launch.mesh"} <= set(mods)
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            # the distribution layer runs on torch.distributed
            "assert 'torch.distributed' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(SRC),
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_repro_or_jax():
    assert len(EXTRA) == 5 and all(p.exists() for p in EXTRA)
    for p in list(PKG.rglob("*.py")) + EXTRA:
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


def test_examples_and_gate_script_import_without_jax_or_repro(tmp_path):
    """Each example driver loads (its imports run, ``main`` does not) and
    the trace check runs its import path without loading JAX or the
    ``repro`` package."""
    code = ("import importlib.util, sys\n"
            f"paths = {[str(p) for p in EXTRA]!r}\n"
            "for i, p in enumerate(paths):\n"
            "    spec = importlib.util.spec_from_file_location(f'm{i}', p)\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            f"assert mod.main([{str(tmp_path / 'none.json')!r}]) == 1\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


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
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_continuous(arch="zamba2-7b", num_requests=1, log=False)
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
    from repro_torch.core import baselines as B
    from repro_torch.core.sara import SaraDispatcher
    from repro_torch.launch import sagar
    for fn in (B.knn, B.logistic_regression, B.plain_mlp, B.run_all):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(ds, ds)
    with pytest.raises(RuntimeError, match="CUDA"):
        sagar.run(n_samples=64, epochs=1, instances=(12,), log=False)
    with pytest.raises(ValueError, match="CUDA"):
        SaraDispatcher(execute="kernel").gemm(torch.ones(2, 3),
                                              torch.ones(3, 4))
    # an explicit CPU device runs the plain versions
    assert ServingEngine(cfg, EngineConfig(), device="cpu").device.type == \
        "cpu"


def _poison_without_sanitize():
    from repro_torch.serving import ChaosConfig
    return ChaosConfig(poison_p=0.5)


# the dense layout, bucketed prefill and buckets are ported: each is set
# here beside a setting the reference refuses with it (a prefix cache
# needs chunked prefill; so does speculative decoding)
_REFUSED_WITH = {"kv_layout": dict(prefix_cache=True),
                 "prefill_chunk": dict(prefix_cache=True),
                 "buckets": dict(prefill_chunk=None, spec_draft="self",
                                 temperature=0.0)}


@pytest.mark.parametrize("field,value", [
    ("shared_prefix_decode", True),        # needs prefix_cache
    ("spec_draft", "rwkv6-1.6b"),          # a draft outside the paged families
    ("chaos", object()),                   # not a ChaosConfig
    ("chaos", _poison_without_sanitize()),  # poison needs the sanitizer
    ("trace_capacity", 0),
    ("kv_layout", "dense"), ("prefill_chunk", None), ("buckets", (16,)),
    ("dispatcher_mode", "adaptnet"), ("execute", "pallas")])
def test_engine_refuses_unported_features(field, value):
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving import EngineConfig, ServingEngine
    extra = _REFUSED_WITH.get(field, {})
    if extra:
        # alone, the setting builds an engine
        ServingEngine(get_arch("llama3.2-1b").reduced(),
                      EngineConfig(**{field: value}), device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(get_arch("llama3.2-1b").reduced(),
                      EngineConfig(**{field: value}, **extra), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("trace", True), ("sanitize", True), ("snapshot_dir", "/nonexistent"),
    ("chaos", None)])
def test_engine_takes_ported_features(field, value):
    """Tracing, the sanitizer, snapshots and the chaos harness are ported:
    setting them builds an engine (a snapshot directory is only touched
    by ``snapshot()``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving import ChaosConfig, EngineConfig, ServingEngine
    if field == "chaos":
        value = ChaosConfig(seed=1, pool_oom_p=0.5, stall_p=0.5)
    eng = ServingEngine(get_arch("llama3.2-1b").reduced(),
                        EngineConfig(**{field: value}), device="cpu")
    assert getattr(eng.ecfg, field) == value


def test_train_entry_point_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch.launch.train import train_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(steps=1, log_every=0, checkpoint_dir=str(tmp_path))


def test_unported_training_routes_raise(tmp_path):
    """Training refuses what it cannot run, before the driver (which
    would retry the error): a mesh without its ranks (no process group,
    no torchrun; the sharded step's own refusals are in
    test_torch_train_sharded.py), a (family, attention) pair the port
    does not serve, and in ``train_main`` the vlm and encdec families,
    whose batches need features its token loader does not make.  The
    blockwise attention route (``attn_impl="xla"``) is ported: those
    calls now compute, their parity is in test_torch_dense_cache.py and
    test_torch_train.py."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import train_main
    from repro_torch.models import transformer
    from repro_torch.models.attention import multihead_attention
    kw = dict(steps=1, log_every=0, device="cpu",
              checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="mesh needs 2 ranks"):
        train_main(data_axis=2, **kw)
    with pytest.raises(ValueError, match="feeds tokens only"):
        train_main(override_cfg=get_arch("internvl2-76b",
                                         optimized=True), **kw)
    assert not any(tmp_path.iterdir())       # no checkpoint was written
    transformer.check_trained_family(get_arch("llama3.2-1b"))  # "xla"
    for arch in ("rwkv6-1.6b", "zamba2-7b"):
        transformer.check_trained_family(get_arch(arch, optimized=True))
    q = torch.ones(1, 4, 2, 8)
    for args in (dict(impl="xla"), dict(impl="pallas", q_offset=2),
                 dict(impl="pallas", logit_cap=30.0),
                 dict(impl="pallas", kv_len=3)):
        out = multihead_attention(q, q, q, causal=True, **args)
        assert out.shape == (1, 4, 2, 8) and torch.isfinite(out).all()
    out = multihead_attention(q[:, :1], q, q, causal=True, impl="pallas")
    assert out.shape == (1, 1, 2, 8)
    transformer.check_trained_family(get_arch("deepseek-v3-671b"))
    with pytest.raises(NotImplementedError, match="trains"):
        transformer.check_trained_family(
            get_arch("llama3.2-1b").replace(attention_type="mla"))
