"""The wave baseline against the reference's: ``serve_waves`` at
temperature 0 emits the reference's greedy tokens for reduced
``llama3.2-1b``, ``internvl2-76b`` (vlm: zero patch embeddings),
``seamless-m4t-medium`` (encdec: random source frames from the prompts'
generator) and ``rwkv6-1.6b`` (the recurrent state), from the same
weights (the reference's init carried across with
``params_from_numpy``) and the same seeded prompts; its stats carry the
reference's keys and counts.  The reference runs its XLA paths (its
"auto" off-TPU), the port its plain versions, as on any CPU tensor.  The
``--waves`` CLI runs the port's path.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch as jget_arch
from repro.launch.serve import serve_waves as jserve_waves
from repro.models.api import build_model as jbuild
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.launch.serve import serve_waves

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-76b",
                                  "seamless-m4t-medium", "rwkv6-1.6b"])
def test_greedy_waves_match_reference(arch):
    kw = dict(batch=2, prompt_len=6, gen=5, waves=2, temperature=0.0,
              seed=3, log=False)
    jout, jstats = jserve_waves(arch, preset="reduced", **kw)
    tcfg = tget_arch(arch).reduced()
    jparams = jbuild(jget_arch(arch).reduced()).init(jax.random.PRNGKey(3))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    tout, tstats = serve_waves(arch, preset="reduced", device="cpu",
                               params=tparams, **kw)
    assert len(tout) == len(jout) == 2
    for t, j in zip(tout, jout):
        assert t.shape == j.shape == (2, 5)
        assert np.array_equal(t, np.asarray(j)), (t, j)
    assert set(tstats) == set(jstats)
    for k in ("prefill_tokens", "decode_tokens"):
        assert tstats[k] == jstats[k]
    assert tstats["prefill_s"] > 0 and tstats["decode_s"] > 0


def test_sampled_waves_are_seeded():
    """Temperature > 0 samples from a generator seeded with seed + 1: the
    same seed gives the same tokens, another seed other ones."""
    kw = dict(batch=2, prompt_len=4, gen=6, waves=1, temperature=0.8,
              top_k=40, device="cpu", log=False)
    a, _ = serve_waves(seed=0, **kw)
    b, _ = serve_waves(seed=0, **kw)
    c, _ = serve_waves(seed=1, **kw)
    assert np.array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


def test_waves_cli():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--waves", "2",
         "--slots", "2", "--prompt-len", "4", "--gen", "3", "--device",
         "cpu"], cwd=str(SRC), env={"PYTHONPATH": str(SRC),
                                     "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("generated (2, 3) tokens") == 2
    assert "decode" in r.stdout and "tok/s" in r.stdout
