"""The port stands alone and never hides the device: every ``repro_torch``
module imports without loading JAX or the ``repro`` package, no source
imports ``repro``, the entry points default to CUDA and raise where there
is none, and the serving engine refuses every feature it has not ported
instead of ignoring it."""

import ast
import subprocess
import sys
from pathlib import Path

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
    # an explicit CPU device runs the plain versions
    assert ServingEngine(cfg, EngineConfig(), device="cpu").device.type == \
        "cpu"


@pytest.mark.parametrize("field,value", [
    ("prefix_cache", True), ("shared_prefix_decode", True),
    ("spec_draft", "self"), ("chaos", object()), ("sanitize", True),
    ("snapshot_dir", "/nonexistent"), ("trace", True),
    ("kv_layout", "dense"), ("prefill_chunk", None), ("buckets", (16,)),
    ("dispatcher_mode", "adaptnet"), ("execute", "pallas")])
def test_engine_refuses_unported_features(field, value):
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving import EngineConfig, ServingEngine
    with pytest.raises(ValueError):
        ServingEngine(get_arch("llama3.2-1b").reduced(),
                      EngineConfig(**{field: value}), device="cpu")
