"""The port's int8 error-feedback all-reduce (``parallel/collectives.py``)
against the reference's, on the CPU.

- 4 gloo ranks, each holding 2 rows of a seeded normal(8, 1024) x 3,
  against the reference's ``quantized_psum`` under ``jax.shard_map`` over
  4 host devices (in a subprocess: the device count is set before JAX
  loads), each result converted with ``np.asarray`` before it is indexed.
  Elementwise the sums agree to one step of the second quantisation
  (``scale2``: the two packages may sum the dequantised shards in another
  order, and a sum on a rounding boundary re-quantises one code away) and
  the residuals to 1e-6; against the exact sum the relative error is
  below the reference test's 0.02.
- One rank: the sum is the int8 round trip of the input (its codes the
  input's, each scaled by the second scale) and the residual is the
  input less its first round trip, exactly.
- ``quantized_psum_tree`` keeps each leaf's dtype and shape, an odd size
  padded and cut back, and sums as the leaves' own calls do.
"""

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

REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.parallel.collectives import quantized_psum
    x = np.load(sys.argv[2])
    mesh = jax.make_mesh((4,), ("data",))
    f = jax.shard_map(lambda xs: quantized_psum(xs, "data", 4), mesh=mesh,
                      in_specs=P("data", None),
                      out_specs=(P("data", None), P("data", None)))
    out, err = f(jnp.asarray(x))
    np.savez(sys.argv[3], out=np.asarray(out), err=np.asarray(err))
""")

PORT = textwrap.dedent("""
    import sys
    import numpy as np, torch
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.parallel.collectives import quantized_psum
    import torch.distributed as dist
    rank, world, store, inp, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    init_distributed("cpu", rank=rank, world_size=world, store_path=store,
                     timeout_s=60)
    x = torch.from_numpy(np.load(inp)[2 * rank:2 * rank + 2])
    s, e = quantized_psum(x, None, world)
    np.savez(out + f"_{rank}.npz", out=s.numpy(), err=e.numpy())
    dist.destroy_process_group()
""")


def _spawn(code, world, tmp, *args, deadline=120.0):
    """``world`` ranks of ``code`` (argv: rank, world, a FileStore path in
    ``tmp``, ``args``), joined by a deadline and killed past it."""
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
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qpsum")
    x = (np.random.default_rng(0).standard_normal((8, 1024)) * 3.0
         ).astype(np.float32)
    np.save(tmp / "x.npy", x)
    ref = subprocess.run(
        [sys.executable, "-c", REF, str(SRC), str(tmp / "x.npy"),
         str(tmp / "ref.npz")], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-3000:]
    _spawn(PORT, 4, tmp, str(tmp / "x.npy"), str(tmp / "port"))
    r = np.load(tmp / "ref.npz")
    port = [np.load(tmp / f"port_{k}.npz") for k in range(4)]
    return x, r["out"], r["err"], port


def test_quantized_psum_matches_reference_on_four_ranks(runs):
    x, ref_out, ref_err, port = runs
    exact = x.reshape(4, 2, 1024).sum(0)
    for k in range(4):
        out, err = port[k]["out"], port[k]["err"]
        ref = ref_out[2 * k:2 * k + 2]
        assert out.dtype == np.float32 and out.shape == (2, 1024)
        scale2 = np.abs(ref).max() / 127.0
        assert np.abs(out - ref).max() <= scale2, k
        np.testing.assert_allclose(err, ref_err[2 * k:2 * k + 2], rtol=0,
                                   atol=1e-6)
        # every rank holds the same sum
        np.testing.assert_array_equal(out, port[0]["out"])
        rel = np.linalg.norm(out - exact) / np.linalg.norm(exact)
        rel_ref = np.linalg.norm(ref - exact) / np.linalg.norm(exact)
        assert rel < 0.02 and rel_ref < 0.02, (rel, rel_ref)
        # the residual is the first quantisation's error: x less its
        # round trip, so |err| <= half a step of the first scale
        scale = np.abs(x).max() / 127.0
        assert np.abs(err).max() <= 0.5 * scale * (1 + 1e-6)


@pytest.fixture
def world1(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", rank=0, world_size=1,
                     store_path=str(tmp_path / "store"), timeout_s=30)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_one_is_the_int8_round_trip(world1):
    from repro_torch.parallel.collectives import (_dequant, _quant,
                                                  quantized_psum)
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (3, 7, 5)) * 2.0).astype(np.float32))
    out, err = quantized_psum(x, None, 1)
    s1 = torch.clamp(x.abs().max(), min=1e-20) / 127.0
    q = _quant(x, s1)
    assert torch.equal(err, x - _dequant(q, s1))
    s2 = torch.clamp(_dequant(q, s1).abs().max(), min=1e-20) / 127.0
    assert torch.equal(out, _dequant(q, s2))
    assert torch.equal(torch.round(out / s2).to(torch.int8), q)
    assert (out - (x - err)).abs().max() <= 1e-6 * x.abs().max()


def test_quantized_psum_tree_keeps_leaves(world1):
    from repro_torch.parallel.collectives import (quantized_psum,
                                                  quantized_psum_tree)
    g = torch.Generator().manual_seed(2)
    tree = {"b": {"w": torch.randn(5, 3, generator=g)},
            "a": torch.randn(7, generator=g).to(torch.bfloat16)}
    out, err = quantized_psum_tree(tree, None, 1)
    assert list(out) == ["b", "a"] and list(err) == ["b", "a"]
    for (o, e, t) in ((out["a"], err["a"], tree["a"]),
                      (out["b"]["w"], err["b"]["w"], tree["b"]["w"])):
        assert o.dtype == t.dtype and o.shape == t.shape
        assert e.dtype == t.dtype and e.shape == t.shape
        want, want_e = quantized_psum(t, None, 1)
        assert torch.equal(o, want.to(t.dtype))
        assert torch.equal(e, want_e.to(t.dtype))
