"""The port's sharding rules and SARA sharding planner against the JAX
reference, on shapes alone (no process group):

- ``param_specs`` of all 10 archs at their full configs (the port's meta
  init against the reference's ``init_abstract``), under every
  ``tp_strategy``, on the reference tests' ``FakeMesh`` shapes (16, 16),
  (2, 16, 16) and (2, 2): the same entries leaf for leaf, exact.
  deepseek-v3's ``init_abstract`` traces one expert at a time (over a
  minute for 58 MoE layers), so its reference tree is traced with one MoE layer and its
  MoE stack's leading dim set to the full config's layer count (the
  other dims are the traced ones).
- ``batch_specs`` of every shape's inputs (train, prefill, decode,
  long_500k's batch of 1) and ``cache_specs_tree`` of the decode cache,
  the same way.  Two cache leaves differ in shape by design
  (``configs/shapes.py``: ``pos`` a position a sequence, ``length`` one a
  layer and lane); both replicate, as the reference's do.
- ``plan_gemm_sharding`` on a seeded grid of 200 (M, K, N, data, model):
  name, specs, ``comm_bytes`` and ``time_s`` (rtol 1e-12), and
  ``SaraDispatcher.recommend_sharding`` with it.
- Under a (2, 2) mesh the registry's ``shard_plan`` of every site of a
  reduced llama forward is the reference planner's name for its
  (M, K, N), and ``describe`` says so as the reference's does; meshless
  the field stays empty.
- ``to_placements`` (the reference's ``to_named``): each spec's
  ``DeviceMesh`` placements, a dim over two axes ``Shard`` on both (the
  blocks DTensor places from them are held in
  ``test_torch_train_sharded.py``, on gloo ranks).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core import tpu_costmodel as jtcm
from repro.launch.steps import cache_specs as jcache_specs
from repro.launch.steps import input_specs as jinput_specs
from repro.models.api import build_model as jbuild
from repro.parallel import sharding as jsh
from repro_torch import dispatch
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.configs.shapes import SHAPES, cache_specs, input_specs
from repro_torch.core import tpu_costmodel as tcm
from repro_torch.core.sara import SaraDispatcher
from repro_torch.models.api import build_model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.hints import use_mesh

STRATEGIES = ("tp", "dp_all", "dp_all_noep")
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2))}


def fake_mesh(name):
    names, shape = MESHES[name]

    class FakeMesh:
        axis_names = names
        devices = np.empty(shape, dtype=object)
    return FakeMesh()


def _jflat(tree, specs):
    """{path: shape} and {path: entries} of a reference tree and its
    spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_s = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat) == len(flat_s)
    return ({jsh._path_str(p): tuple(l.shape) for p, l in flat},
            {jsh._path_str(p): tuple(s) for (p, _), s in zip(flat, flat_s)})


def _tflat(tree, specs):
    shapes = {p: tuple(t.shape) for p, t in sh._flat_with_path(tree)}
    entries = {p: tuple(s) for p, s in sh._flat_with_path(specs)}
    assert shapes.keys() == entries.keys()
    return shapes, entries


_JTREES = {}


def _jparams(arch):
    """The reference's abstract parameters of the full config (deepseek-v3:
    traced at one MoE layer, the MoE stack's leading dim set to the full
    count, as the module docstring says)."""
    if arch not in _JTREES:
        cfg = jget_arch(arch)
        if arch != "deepseek-v3-671b":
            _JTREES[arch] = jbuild(cfg).init_abstract()
        else:
            k = cfg.first_dense_layers
            cut = jbuild(cfg.replace(num_layers=k + 1)).init_abstract()
            n_moe = cfg.num_layers - k

            def grow(path, leaf):
                ps = jsh._path_str(path)
                if ps.startswith("layers/"):
                    assert leaf.shape[0] == 1, ps
                    return jax.ShapeDtypeStruct((n_moe,) + leaf.shape[1:],
                                                leaf.dtype)
                return leaf
            _JTREES[arch] = jax.tree_util.tree_map_with_path(grow, cut)
    return _JTREES[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    """3 strategies x 3 meshes, every leaf's entries equal; the big
    matrices shard."""
    jparams = _jparams(arch)
    tparams = build_model(get_arch(arch), "meta").init_abstract()
    for strategy in STRATEGIES:
        for mesh in MESHES:
            jspecs = jsh.param_specs(
                jparams, jget_arch(arch).replace(tp_strategy=strategy),
                fake_mesh(mesh))
            tspecs = sh.param_specs(
                tparams, get_arch(arch).replace(tp_strategy=strategy),
                fake_mesh(mesh))
            jshapes, jentries = _jflat(jparams, jspecs)
            tshapes, tentries = _tflat(tparams, tspecs)
            assert tshapes == jshapes, (arch, strategy, mesh)
            assert tentries == jentries, (arch, strategy, mesh)
            assert all(isinstance(s, sh.P) for _, s in
                       sh._flat_with_path(tspecs))
            sharded = sum(any(e is not None for e in v)
                          for v in tentries.values())
            assert sharded > 3, (arch, strategy, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch):
    for strategy in STRATEGIES:
        jcfg = jget_arch(arch).replace(tp_strategy=strategy)
        tcfg = get_arch(arch).replace(tp_strategy=strategy)
        for mesh in MESHES:
            fm = fake_mesh(mesh)
            for name in SHAPES:
                jin = jinput_specs(jcfg, JSHAPES[name])
                tin = input_specs(tcfg, SHAPES[name])
                for use_cfg in (False, True):
                    jspecs = jsh.batch_specs(jin, fm,
                                             jcfg if use_cfg else None)
                    tspecs = sh.batch_specs(tin, fm,
                                            tcfg if use_cfg else None)
                    assert _tflat(tin, tspecs) == _jflat(jin, jspecs), \
                        (arch, strategy, mesh, name)
            shape = JSHAPES["decode_32k"]
            jc = jcache_specs(jcfg, shape)
            tc = cache_specs(tcfg, SHAPES["decode_32k"])
            jshapes, jentries = _jflat(jc, jsh.cache_specs_tree(jc, jcfg,
                                                                fm))
            tshapes, tentries = _tflat(tc, sh.cache_specs_tree(tc, tcfg,
                                                              fm))
            assert tshapes.keys() == jshapes.keys()
            for p in jshapes:
                if p.endswith(("pos", "length")):
                    # shaped per sequence in the port (configs/shapes.py)
                    assert all(e is None for e in tentries[p])
                    assert all(e is None for e in jentries[p])
                    continue
                assert tshapes[p] == jshapes[p], (arch, p)
                assert tentries[p] == jentries[p], (arch, strategy, mesh, p)


def test_batch_of_one_replicates():
    """The reference's long_500k case: an indivisible batch replicates."""
    fm = fake_mesh("16x16")
    specs = sh.batch_specs({"tokens": torch.empty(1, 8, device="meta"),
                            "big": torch.empty(32, 8, device="meta")}, fm)
    assert tuple(specs["tokens"]) == (None, None)
    assert tuple(specs["big"])[0] == "data"


def test_plan_gemm_sharding_matches_reference():
    rng = np.random.default_rng(36)
    disp = SaraDispatcher()
    names = set()
    for _ in range(200):
        M, K, N = (int(x) for x in np.exp(rng.uniform(0, np.log(65536),
                                                      3)).round() + 1)
        data, model = (int(2 ** rng.integers(0, 6)) for _ in range(2))
        if rng.random() < 0.25:          # shapes the axes divide
            M, K, N = M * data, K * model, N * model
        want = jtcm.plan_gemm_sharding(M, K, N, data=data, model=model)
        got = tcm.plan_gemm_sharding(M, K, N, data=data, model=model)
        assert got.name == want.name
        assert (got.x_spec, got.w_spec, got.out_spec) == \
            (want.x_spec, want.w_spec, want.out_spec)
        np.testing.assert_allclose(got.comm_bytes, want.comm_bytes,
                                   rtol=1e-12)
        np.testing.assert_allclose(got.time_s, want.time_s, rtol=1e-12)
        assert disp.recommend_sharding(M, K, N, data=data, model=model) \
            == got
        names.add(got.name)
    assert len(names) >= 4, names


def test_registry_records_the_reference_plan_under_a_mesh():
    cfg = get_arch("llama3.2-1b").reduced()
    model = build_model(cfg, "cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    reg = dispatch.SiteRegistry()
    with torch.no_grad(), dispatch.use(registry=reg), reg.scope("mesh"), \
            use_mesh(fake_mesh("2x2")):
        model.logits(params, {"tokens": toks})
    sites = reg.sites("mesh")
    assert len(sites) >= 5
    for name, rec in sites.items():
        want = jtcm.plan_gemm_sharding(rec.m, rec.k, rec.n, data=2,
                                       model=2).name
        assert rec.shard_plan == want, name
        assert rec.describe().split(" ran[")[0].endswith(f" shard={want}")
    # meshless: no plan
    reg2 = dispatch.SiteRegistry()
    with torch.no_grad(), dispatch.use(registry=reg2), reg2.scope("none"):
        model.logits(params, {"tokens": toks})
    assert all(r.shard_plan == "" and "shard=" not in r.describe()
               for r in reg2.sites("none").values())


def _placements():
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    # spec: its placements on (data, model) and on (pod, data, model)
    return {sh.P(("data", "model"), None): ((Shard(0), Shard(0)),
                                            (R, Shard(0), Shard(0))),
            sh.P(None, ("data", "model")): ((Shard(1), Shard(1)),
                                            (R, Shard(1), Shard(1))),
            sh.P("model", "data"): ((Shard(1), Shard(0)),
                                    (R, Shard(1), Shard(0))),
            sh.P("data"): ((Shard(0), R), (R, Shard(0), R)),
            sh.P(None, "model"): ((R, Shard(1)), (R, R, Shard(1))),
            sh.P(): ((R, R), (R, R, R))}


PLACEMENTS = _placements()


@pytest.mark.parametrize("spec", list(PLACEMENTS))
def test_to_placements(spec):
    two, three = PLACEMENTS[spec]
    assert sh.to_placements(spec, fake_mesh("2x2")) == two
    assert sh.to_placements(spec, fake_mesh("16x16")) == two
    assert sh.to_placements(spec, fake_mesh("2x16x16")) == three
    # over a tree, leaf for leaf
    tree = {"a": spec, "b": {"c": sh.P()}}
    assert sh.to_placements(tree, fake_mesh("2x2")) == {
        "a": two, "b": {"c": PLACEMENTS[sh.P()][0]}}
