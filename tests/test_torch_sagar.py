"""SAGAR parity: the port's copies of the paper's model (``core/{hw, rsa,
costmodel, dataset, sigma, ppa, adaptnetx_model}.py``) against the JAX
package's on the same numpy inputs, and ``SaraDispatcher.gemm`` against
the reference's.

The numpy modules are copied line for line, so every output is held
bitwise (``np.array_equal`` on equal dtypes, ``==`` on floats): a
reordered float expression would move a label.  ``SaraDispatcher.gemm``
runs the plain RSA GEMM on the CPU where the reference runs XLA's
product: its output is held to the f32 summation bound K * 2^-24 *
(|x| @ |w|), its registry record equal to the reference's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.core import adaptnetx_model as JX
from repro.core import costmodel as JCM
from repro.core import dataset as JD
from repro.core import hw as JHW
from repro.core import ppa as JPPA
from repro.core import rsa as JRSA
from repro.core import sigma as JSIG
from repro.core.sara import SaraDispatcher as JDispatcher
from repro_torch import dispatch
from repro_torch.core import adaptnetx_model as X
from repro_torch.core import costmodel as CM
from repro_torch.core import dataset as D
from repro_torch.core import hw as HW
from repro_torch.core import ppa as PPA
from repro_torch.core import rsa as RSA
from repro_torch.core import sigma as SIG
from repro_torch.core.sara import SaraDispatcher

DIMS = (1, 4, 127, 128, 10_000, 50_176)
SYSTEMS = (CM.MONOLITHIC, CM.RSA, CM.DISTRIBUTED)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _grid():
    """Every (M, K, N) over DIMS, then 200 seeded log-uniform workloads."""
    g = np.array(np.meshgrid(DIMS, DIMS, DIMS, indexing="ij")).reshape(3, -1)
    rng = np.random.default_rng(7)
    r = np.exp(rng.uniform(0, np.log(60_000), (3, 200))).astype(np.int64) + 1
    return np.concatenate([g, r], axis=1)


# ---------------------------------------------------------------------------
# the configuration space
# ---------------------------------------------------------------------------

def test_hw_constants_are_the_reference_copy():
    assert dataclasses.asdict(HW.TECH_28NM) == \
        dataclasses.asdict(JHW.TECH_28NM)
    assert dataclasses.asdict(HW.TPU_V5E) == dataclasses.asdict(JHW.TPU_V5E)
    assert (HW.OS, HW.WS, HW.IS) == (JHW.OS, JHW.WS, JHW.IS)
    assert HW.DATAFLOW_NAMES == JHW.DATAFLOW_NAMES


@pytest.mark.parametrize("log2_macs", range(10, 17))
def test_rsa_space_bitwise(log2_macs):
    ours = RSA.make_instance(2 ** log2_macs)
    theirs = JRSA.make_instance(2 ** log2_macs)
    assert (ours.grid_rows, ours.grid_cols, ours.num_macs) == \
        (theirs.grid_rows, theirs.grid_cols, theirs.num_macs)
    a, b = RSA.enumerate_configs(ours), JRSA.enumerate_configs(theirs)
    assert [dataclasses.astuple(c) for c in a] == \
        [dataclasses.astuple(c) for c in b]
    assert [c.describe() for c in a] == [c.describe() for c in b]
    ta, tb = RSA.config_table(ours), JRSA.config_table(theirs)
    for k in ("R", "C", "p", "q", "df"):
        assert _same(ta[k], tb[k]), k
    want = {12: 75, 13: 90, 14: 108}.get(log2_macs)
    if want is not None:
        assert len(a) == want
    assert RSA.SAGAR_INSTANCE == RSA.make_instance(2 ** 14)
    assert RSA.CELL == JRSA.CELL


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("system", SYSTEMS)
def test_gemm_cost_bitwise(system):
    M, K, N = (v[:, None] for v in _grid())
    for log2_macs in (12, 14):
        inst = RSA.make_instance(2 ** log2_macs)
        tab = RSA.config_table(inst)
        args = [tab[k] for k in ("R", "C", "p", "q", "df")]
        for total in (None, inst.num_macs):
            a = CM.gemm_cost(M, K, N, *args, system=system,
                             num_macs_total=total)
            b = JCM.gemm_cost(M, K, N, *args, system=system,
                              num_macs_total=total)
            for f in dataclasses.fields(JCM.GEMMCost):
                assert _same(getattr(a, f.name), getattr(b, f.name)), f.name
    assert (CM.HOP_CYCLES, CM.RSA_STAGE_CYCLES, CM.BYTES_PER_ELEM) == \
        (JCM.HOP_CYCLES, JCM.RSA_STAGE_CYCLES, JCM.BYTES_PER_ELEM)


@pytest.mark.parametrize("objective", ["runtime", "edp"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_oracle_labels_bitwise(system, objective):
    M, K, N = _grid()
    for log2_macs in (12, 13, 14):
        a = CM.best_config(RSA.make_instance(2 ** log2_macs), M, K, N,
                           system=system, objective=objective)
        b = JCM.best_config(JRSA.make_instance(2 ** log2_macs), M, K, N,
                            system=system, objective=objective)
        assert _same(a, b)
        sa = CM.sweep_configs(RSA.make_instance(2 ** log2_macs), M, K, N,
                              system=system)
        sb = JCM.sweep_configs(JRSA.make_instance(2 ** log2_macs), M, K, N,
                               system=system)
        assert _same(sa.edp, sb.edp) and _same(sa.runtime, sb.runtime)


def test_oracle_runtime_and_fixed_systems_bitwise():
    M, K, N = _grid()
    inst, jinst = RSA.SAGAR_INSTANCE, JRSA.SAGAR_INSTANCE
    for system in SYSTEMS:
        assert _same(CM.oracle_runtime(inst, M, K, N, system=system),
                     JCM.oracle_runtime(jinst, M, K, N, system=system))
    cls = np.random.default_rng(3).integers(0, 108, len(M))
    assert _same(CM.runtime_of_class(inst, M, K, N, cls),
                 JCM.runtime_of_class(jinst, M, K, N, cls))
    for df in (HW.OS, HW.WS, HW.IS):
        for a, b in ((CM.monolithic_cost(M, K, N, 128, 128, df),
                      JCM.monolithic_cost(M, K, N, 128, 128, df)),
                     (CM.distributed_cost(M, K, N, 32, 32, 16, df),
                      JCM.distributed_cost(M, K, N, 32, 32, 16, df))):
            for f in dataclasses.fields(JCM.GEMMCost):
                assert _same(getattr(a, f.name), getattr(b, f.name)), f.name
    for ours, theirs, args in (
            (CM.monolithic_cost, JCM.monolithic_cost, (128, 128)),
            (CM.distributed_cost, JCM.distributed_cost, (4, 4, 1024))):
        a = CM.best_dataflow_cost(ours, M, K, N, *args)
        b = JCM.best_dataflow_cost(theirs, M, K, N, *args)
        assert a.keys() == b.keys()
        for k in b:
            assert _same(a[k], b[k]), k


# ---------------------------------------------------------------------------
# datasets and scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["loguniform", "uniform"])
@pytest.mark.parametrize("log2_macs", [12, 13, 14])
def test_generate_bitwise(log2_macs, dist):
    a = D.generate(5_000, inst=RSA.make_instance(2 ** log2_macs), dist=dist,
                   seed=log2_macs, chunk=1_999)
    b = JD.generate(5_000, inst=JRSA.make_instance(2 ** log2_macs),
                    dist=dist, seed=log2_macs, chunk=1_999)
    assert _same(a.features, b.features) and _same(a.labels, b.labels)
    assert a.num_classes == b.num_classes == \
        {12: 75, 13: 90, 14: 108}[log2_macs]


def test_generate_defaults_match_reference():
    import inspect
    sig = {k: v.default for k, v in
           inspect.signature(D.generate).parameters.items()}
    jsig = {k: v.default for k, v in
            inspect.signature(JD.generate).parameters.items()}
    assert sig["chunk"] == jsig["chunk"] == 100_000
    assert {k: v for k, v in sig.items() if k != "inst"} == \
        {k: v for k, v in jsig.items() if k != "inst"}
    assert sig["inst"] == RSA.SAGAR_INSTANCE


@pytest.mark.parametrize("metric", ["edp", "runtime"])
def test_relative_scores_bitwise(metric):
    M, K, N = _grid()
    feats = np.stack([M, K, N], 1)
    pred = np.random.default_rng(1).integers(0, 108, len(M))
    inst, jinst = RSA.SAGAR_INSTANCE, JRSA.SAGAR_INSTANCE
    assert _same(D.relative_performance(inst, feats, pred, metric),
                 JD.relative_performance(jinst, feats, pred, metric))
    a = D.geomean_relative(inst, feats, pred, metric)
    assert a == JD.geomean_relative(jinst, feats, pred, metric) and a > 1.0
    oracle = CM.best_config(inst, M, K, N, objective=metric)
    if metric == "edp":
        assert D.geomean_relative(inst, feats, oracle, metric) == 1.0


# ---------------------------------------------------------------------------
# SIGMA, PPA, the ADAPTNETX cycle model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [1.0, 0.5, 0.3, 0.15, 0.05])
def test_sigma_bitwise(density):
    M, K, N = _grid()
    for ours, theirs in ((SIG.sigma_c_runtime, JSIG.sigma_c_runtime),
                         (SIG.sigma_a_runtime, JSIG.sigma_a_runtime)):
        assert _same(ours(M, K, N, density), theirs(M, K, N, density))
    assert _same(SIG.sigma_runtime(M, K, N, num_macs=1000, density=density),
                 JSIG.sigma_runtime(M, K, N, num_macs=1000, density=density))


def test_ppa_bitwise():
    assert PPA.headline_ratios() == JPPA.headline_ratios()
    for name in ("SAGAR", "MONOLITHIC", "DISTRIBUTED_4x4",
                 "SIGMA_COMPUTE_EQ"):
        a, b = getattr(PPA, name), getattr(JPPA, name)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert (a.compute_density, a.power_efficiency) == \
            (b.compute_density, b.power_efficiency)
    assert (PPA.ADAPTNETX_AREA_MM2, PPA.ADAPTNETX_POWER_W) == \
        (JPPA.ADAPTNETX_AREA_MM2, JPPA.ADAPTNETX_POWER_W)


@pytest.mark.parametrize("num_classes", [108, 858])
def test_adaptnetx_cycle_model_bitwise(num_classes):
    assert X.sweep_multipliers(num_classes) == \
        JX.sweep_multipliers(num_classes)
    assert X.adaptnet_layer_dims(num_classes) == \
        JX.adaptnet_layer_dims(num_classes)
    d, jd = X.AdaptNetXDesign(), JX.AdaptNetXDesign()
    assert (d.cycles(num_classes), d.model_bytes(num_classes)) == \
        (jd.cycles(num_classes), jd.model_bytes(num_classes))
    for m in (64, 100, 512, 4096):
        for units in (1, 2, 4):
            assert X.cycles_on_adaptnetx(m, num_classes, units) == \
                JX.cycles_on_adaptnetx(m, num_classes, units)
        assert X.cycles_on_systolic_cells(m, num_classes) == \
            JX.cycles_on_systolic_cells(m, num_classes)


# ---------------------------------------------------------------------------
# SaraDispatcher.gemm
# ---------------------------------------------------------------------------

def _record(r):
    return (r.site, r.m, r.k, r.n, r.cfg.class_id, r.cfg.block_m,
            r.cfg.block_n, r.cfg.block_k, r.cfg.mode, r.block_m, r.block_n,
            r.block_k, r.mode, r.source)


@pytest.mark.parametrize("shape", [(512, 512, 512), (128, 8000, 128),
                                   ((2, 3), 200, 72)])
def test_sara_gemm_matches_reference(shape):
    """Quickstart part 3's GEMMs and a 3-D input: the output at the f32
    summation bound of the reference's (XLA) output, and the registry
    record equal (backend aside: "torch" here, "xla" there)."""
    lead, K, N = shape
    lead = lead if isinstance(lead, tuple) else (lead,)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jreg, reg = jdispatch.SiteRegistry(), dispatch.SiteRegistry()
    jd, d = JDispatcher(), SaraDispatcher()
    with jdispatch.use(registry=jreg):
        want = np.asarray(jd.gemm(jax.numpy.asarray(x),
                                  jax.numpy.asarray(w)))
    with dispatch.use(registry=reg):
        got = d.gemm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape
    bound = K * 2.0 ** -24 * (np.abs(x).astype(np.float64) @
                              np.abs(w).astype(np.float64))
    assert np.all(np.abs(got - want) <= 2 * bound + 1e-30)
    (jr,), (tr,) = jreg.sites("_").values(), reg.sites("_").values()
    assert _record(tr) == _record(jr)
    assert tr.site == "sara.gemm" and tr.backend == "torch"
    M = int(np.prod(lead))
    assert tr.cfg == d.recommend(M, K, N)


def test_sara_gemm_execute_modes():
    """The reference's ``use_pallas`` is the port's ``execute``: "auto"
    runs the plain version on CPU tensors, "torch" pins it, "kernel"
    raises on them (no fallback), and an unknown mode is refused."""
    x, w = torch.randn(8, 64), torch.randn(64, 32)
    reg = dispatch.SiteRegistry()
    with dispatch.use(registry=reg):
        a = SaraDispatcher().gemm(x, w, site="s.auto")
        b = SaraDispatcher(execute="torch").gemm(x, w, site="s.torch")
    assert torch.equal(a, b)
    assert {r.backend for r in reg.sites("_").values()} == {"torch"}
    with pytest.raises(ValueError, match="CUDA"):
        SaraDispatcher(execute="kernel").gemm(x, w)
    with pytest.raises(ValueError, match="execute"):
        SaraDispatcher(execute="pallas")
