"""The shape set, the abstract trees and the step estimates against the
JAX reference, on the CPU:

- ``SHAPES``, ``LONG_CONTEXT_OK``, ``shape_applicable`` (every arch x
  shape, plain and optimized at the reference's pod batch) and the
  dry-run's skip reason equal the reference's;
- ``input_specs`` and ``cache_specs`` have the reference's leaves, shapes
  and dtypes on the meta device, but for the leaves the port widens by
  design, each sequence keeping its own position and lengths: the
  cache's ``pos``, (B,) int64 where the reference keeps one int32
  scalar, and every KV stack's ``length``, (L, B) int32 where the
  reference keeps (L,);
- ``Model.init_abstract`` has the reference's leaf paths, shapes and
  dtypes at published widths for all 10 archs, deepseek-v3-671b cut in
  depth to 4 layers (its 3 dense layers, then 1 MoE layer: the reference
  takes ~60 s on the full 61), and allocates nothing;
- ``model_flops_estimate`` and ``model_min_bytes_estimate`` equal the
  reference's to 1e-12 relative on every applicable cell, the widened
  leaves' bytes accounted for exactly (deepseek at the same cut);
- ``param_bytes`` is the reference's.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.configs.registry import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models.api import build_model as jbuild
from repro.models.modules import param_bytes as jparam_bytes
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.launch import steps as tsteps
from repro_torch.models.api import build_model as tbuild
from repro_torch.models.modules import param_bytes

# deepseek-v3-671b's cut: its 3 dense layers, then 1 MoE layer
CUT = {"deepseek-v3-671b": 4}


def _cfgs(arch):
    j, t = jget_arch(arch), tget_arch(arch)
    if arch in CUT:
        j, t = (c.replace(num_layers=CUT[arch]) for c in (j, t))
    return j, t


def _key(p):
    for attr in ("key", "name", "idx"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _jleaves(tree):
    """{path: (shape, dtype name)} of a JAX tree."""
    return {"/".join(_key(p) for p in path): (tuple(l.shape),
                                              jnp.dtype(l.dtype).name)
            for path, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree, prefix=""):
    """{path: (shape, dtype name)} of a port tree of dicts and
    NamedTuples, every tensor on the meta device."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else tree._asdict().items())
    for k, v in items:
        if isinstance(v, torch.Tensor):
            assert v.is_meta, f"{prefix}{k} allocated on {v.device}"
            out[f"{prefix}{k}"] = (tuple(v.shape),
                                   str(v.dtype).replace("torch.", ""))
        else:
            out.update(_tleaves(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def abstract():
    """Both packages' abstract parameter trees of every arch (the cut
    deepseek), built once."""
    out = {}
    for arch in ARCH_IDS:
        jc, tc = _cfgs(arch)
        out[arch] = (jbuild(jc).init_abstract(),
                     tbuild(tc, "cpu").init_abstract())
    return out


def test_shapes_and_long_context_archs_are_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.LONG_CONTEXT_OK == jshapes.LONG_CONTEXT_OK
    # the step builders' ShapeSpec is the shape set's
    assert tsteps.ShapeSpec is tshapes.ShapeSpec


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_matches_reference(arch, optimized):
    for name, shape in jshapes.SHAPES.items():
        kw = dict(optimized=optimized, global_batch=shape.global_batch,
                  devices=256)
        assert tshapes.shape_applicable(tget_arch(arch, **kw), name) == \
            jshapes.shape_applicable(jget_arch(arch, **kw), name), name


def test_skip_reason_is_the_reference_dryrun_text():
    # read, not imported: importing the reference's dry-run sets XLA_FLAGS
    # for the rest of the process
    src = (Path(jshapes.__file__).parents[1] / "launch" /
           "dryrun.py").read_text()
    assert '"long_500k needs sub-quadratic attention; "' in src
    assert 'f"{arch} is full-attention (DESIGN.md §4)"' in src
    assert tshapes.skip_reason("llama3.2-1b") == (
        "long_500k needs sub-quadratic attention; llama3.2-1b is "
        "full-attention (DESIGN.md §4)")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    jc, tc = _cfgs(arch)
    for name, shape in jshapes.SHAPES.items():
        want = {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
                for k, v in jshapes.input_specs(jc, shape).items()}
        got = tshapes.input_specs(tc, tshapes.SHAPES[name])
        assert all(v.is_meta for v in got.values())
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == want, name
        # at a batch of one card's
        one = tshapes.input_specs(tc, tshapes.SHAPES[name], batch=1)
        assert {k: v.shape[1:] for k, v in one.items()} == \
            {k: v.shape[1:] for k, v in got.items()}
        assert all(v.shape[0] == 1 for v in one.values())


def _widened(jcache, tcache):
    """Split both caches' leaves into the common ones and the leaves the
    port widens: ``pos`` and each KV stack's ``length``.  Returns (common
    reference leaves, common port leaves, the port's extra bytes in the
    widened leaves)."""
    want, got = _jleaves(jcache), _tleaves(tcache)
    extra = 0
    for k in [k for k in got if k == "pos" or k.endswith("/length")]:
        (js, jd), (ts, td) = want.pop(k), got.pop(k)
        if k == "pos":
            assert (js, jd, td) == ((), "int32", "int64"), k
        else:
            assert jd == td == "int32" and ts[:-1] == js, k
        extra += (int(np.prod(ts)) * torch.empty((), dtype=getattr(
            torch, td)).element_size() - int(np.prod(js)) * 4)
    return want, got, extra


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    """Every leaf of the reference's decode cache; the port's widened
    leaves hold one position, and one KV length a layer, a sequence."""
    jc, tc = _cfgs(arch)
    B = 4
    jshape = dataclasses.replace(jshapes.SHAPES["decode_32k"],
                                 global_batch=B)
    jcache = jshapes.cache_specs(jc, jshape)
    tcache = tshapes.cache_specs(tc, tshapes.SHAPES["decode_32k"], batch=B)
    want, got, _ = _widened(jcache, tcache)
    assert got == want
    full = _tleaves(tcache)
    assert full["pos"] == ((B,), "int64")
    assert all(v[0][-1] == B for k, v in full.items()
               if k.endswith("/length"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_abstract_matches_reference(arch, abstract):
    jtree, ttree = abstract[arch]
    got = _tleaves(ttree)
    assert got == _jleaves(jtree)
    assert tbuild(_cfgs(arch)[1], "cpu").num_params() == \
        sum(int(np.prod(s)) for s, _ in got.values())
    assert param_bytes(ttree) == jparam_bytes(jtree)


def test_init_abstract_draws_nothing():
    """The abstract route leaves ``init``'s draws as they were: a seeded
    init after it equals one before it bitwise."""
    cfg = tget_arch("zamba2-7b").reduced()
    model = tbuild(cfg, "cpu")
    before = model.init(3)
    model.init_abstract()
    after = model.init(3)
    flat_b, flat_a = _flat(before), _flat(after)
    assert flat_b.keys() == flat_a.keys()
    assert all(torch.equal(flat_b[k], flat_a[k]) for k in flat_b)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimates_match_reference(arch, abstract):
    """Both estimates on every applicable cell at the reference's pod
    batches, to 1e-12 relative; a serve cell's compulsory bytes count the
    port's widened cache leaves, whose extra bytes are taken off
    exactly."""
    jc, tc = _cfgs(arch)
    jtree, ttree = abstract[arch]
    for name, shape in jshapes.SHAPES.items():
        if not jshapes.shape_applicable(jc, name):
            continue
        tshape = tshapes.SHAPES[name]
        jf = jsteps.model_flops_estimate(jc, jtree, shape)
        tf = tsteps.model_flops_estimate(tc, ttree, tshape)
        assert tf == pytest.approx(jf, rel=1e-12, abs=0), name
        jb = jsteps.model_min_bytes_estimate(jc, jtree, shape)
        tb = tsteps.model_min_bytes_estimate(tc, ttree, tshape)
        extra = 0 if shape.kind == "train" else _widened(
            jshapes.cache_specs(jc, shape),
            tshapes.cache_specs(tc, tshape))[2]
        assert tb - extra == pytest.approx(jb, rel=1e-12, abs=0), name


def test_min_bytes_raises_where_the_cache_cannot_be_built():
    """The reference passes over a cache it cannot build; the port's
    estimate raises (an attention family needs rows)."""
    cfg = tget_arch("llama3.2-1b").reduced()
    params = tbuild(cfg, "cpu").init_abstract()
    bad = tshapes.ShapeSpec("empty", 0, 1, "decode")
    with pytest.raises(ValueError, match="max_len"):
        tsteps.model_min_bytes_estimate(cfg, params, bad)
