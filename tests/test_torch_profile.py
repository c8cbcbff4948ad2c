"""The step tooling: roofline terms, config overrides, the kernel rows of
a profiler run, and the profile / hill-climb / dry-run launchers.

- ``RooflineTerms`` built with ``chip=TPU_V5E`` gives the reference's
  ideal terms, and with the measured step in place of the reference's
  modelled bound, its roofline fraction and bound attainment;
- ``parse_override`` and ``apply_overrides`` agree with the reference's,
  a dotted key (``moe.capacity_factor``) included;
- ``profile_kernels`` and ``profile_by_kernel`` read the kernel events of
  a profiler run only (a CPU op's device time would count its kernels
  twice) and group the port's kernels by family;
- ``profile_cell``, ``run_variant`` and the dry-run run on the CPU at the
  reduced preset with their lengths cut, and write their JSON into
  ``tmp_path``; the meta sweep records all 40 cells;
- ``sgd_momentum`` matches the reference's over 3 steps;
- on the card (marked ``cuda``), ``profile_cell`` on a reduced model
  finds kernel events.

The reference's launchers set ``XLA_FLAGS`` when imported; this file
imports them only inside the tests that compare with them, with JAX's
backend already up and the variable put back, so that a run of the card
tests here (``-m cuda``) never loads JAX.
"""

import dataclasses
import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core.hw import H100, TPU_V5E
from repro_torch.launch import dryrun, hillclimb, profile, roofline
from repro_torch.optim.adamw import sgd_momentum


def _reference(name):
    import jax
    old = os.environ.get("XLA_FLAGS")
    try:
        jax.devices()
        return importlib.import_module(name)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("mf,mb,chips", [(3.4e13, 4.6e10, 1),
                                         (8.62e15, 1.7e11, 256),
                                         (2.64e9, 3.18e9, 256)])
def test_roofline_terms_on_tpu_are_the_reference(mf, mb, chips):
    ha = _reference("repro.launch.hlo_analysis")
    ref = ha.RooflineTerms(compute_s=0.2, memory_s=0.05, collective_s=0.01,
                           hlo_flops_global=0.0, hlo_bytes_global=0.0,
                           collective_bytes_global=0.0, chips=chips,
                           model_flops=mf, model_min_bytes=mb)
    got = roofline.RooflineTerms(model_flops=mf, model_min_bytes=mb,
                                 step_s=ref.bound_s, chips=chips,
                                 chip=TPU_V5E, dtype="float32")
    assert got.ideal_compute_s == ref.ideal_compute_s
    assert got.ideal_memory_s == ref.ideal_memory_s
    assert got.roofline_fraction == ref.roofline_fraction
    assert got.bound_attainment == ref.bound_attainment
    d = got.to_dict()
    assert d["roofline_fraction"] == ref.to_dict()["roofline_fraction"]
    assert d["idle_share"] is None and d["busy_s"] is None


def test_roofline_terms_on_the_h100():
    t = roofline.RooflineTerms(model_flops=67e12, model_min_bytes=3.35e12,
                               step_s=2.0, busy_s=1.5, profiled_s=2.0,
                               dtype="float32")
    assert t.peak_flops == H100.peak_f32_flops == 67e12
    assert t.ideal_compute_s == 1.0 and t.ideal_memory_s == 1.0
    assert t.roofline_fraction == 0.5 and t.bound_attainment == 0.5
    assert t.idle_share == 0.25
    # against the profiled step's own wall, not the median of the others
    assert dataclasses.replace(t, step_s=1.4).idle_share == 0.25
    assert dataclasses.replace(t, profiled_s=None).idle_share is None
    bf16 = dataclasses.replace(t, dtype="bfloat16")
    assert bf16.peak_flops == 989e12 and bf16.dominant == "memory"
    assert H100.hbm_bw == 3.35e12 and H100.hbm_bytes == 80e9


@pytest.mark.parametrize("kv", ["attn_chunk=256", "flash_causal_skip=True",
                                "name=plain-text", "moe.capacity_factor=1.5",
                                "rope_theta=1e4", "skip_shapes=('a', 'b')"])
def test_parse_override_matches_reference(kv):
    jp = _reference("repro.launch.profile")
    assert profile.parse_override(kv) == jp.parse_override(kv)


def test_apply_overrides_matches_reference():
    from repro.configs.registry import get_arch as jget_arch
    jp = _reference("repro.launch.profile")
    ov = dict(profile.parse_override(kv) for kv in (
        "moe.capacity_factor=1.0", "moe.experts_per_token=2",
        "attn_chunk=256", "attn_impl=pallas"))
    got = profile.apply_overrides(tget_arch("qwen2-moe-a2.7b"), ov)
    want = jp.apply_overrides(jget_arch("qwen2-moe-a2.7b"), ov)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.moe.capacity_factor == 1.0 and got.attn_chunk == 256


def _event(name, us, cuda=True, annotation=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, self_device_time_total=us, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_kernel_rows_read_kernel_events_only():
    events = [
        _event("void psum_wgmma<128, __nv_bfloat16>(CUtensorMap, ...)", 300.0),
        _event("void psum_f32<64, false, true>(Params32)", 100.0),
        _event("void flash_fwd_tc_kernel<64>(...)", 150.0),
        _event("void flash_dkv_pair_kernel<4, 2>(...)", 50.0),
        _event("void at::native::elementwise_kernel<...>", 25.0),
        _event("void at::native::elementwise_kernel<...>", 25.0),
        # a CPU op's own device time (the kernels it launched), a user
        # range: neither is a kernel
        _event("aten::mm", 400.0, cuda=False),
        _event("my_range", 700.0, annotation=True),
    ]
    prof = SimpleNamespace(events=lambda: events)
    assert sum(us for _, us in roofline.kernel_events(prof)) == 650.0
    rows = roofline.profile_kernels(prof, top=3)
    assert [r["kernel"].split("<")[0] for r in rows] == [
        "void psum_wgmma", "void flash_fwd_tc_kernel", "void psum_f32"]
    assert rows[0]["launches"] == 1 and rows[0]["device_ms"] == 0.3
    assert rows[0]["share"] == pytest.approx(300 / 650)
    fam = roofline.profile_by_kernel(prof)
    by = {r["kernel"]: r for r in fam}
    assert by["rsa_gemm"]["launches"] == 2
    assert by["rsa_gemm"]["device_ms"] == pytest.approx(0.4)
    assert by["rsa_gemm"]["family"] == "rsa_gemm"
    assert by["flash_dkv"]["family"] == "flash_dkv"
    torch_row = by["void at::native::elementwise_kernel<...>"]
    assert torch_row["launches"] == 2 and torch_row["family"] is None
    assert sum(r["share"] for r in fam) == pytest.approx(1.0)
    assert fam[0]["kernel"] == "rsa_gemm"


@pytest.mark.parametrize("optimized", [True, False])
def test_fresh_prefill_matches_reference(optimized):
    """The prefill's route: a prefill into a fresh cache attends over the
    prompt's own rows (the flash forward's plain version under the
    optimized profile, the blockwise route over those rows under the
    default) and gives the reference's prefill, blockwise over the whole
    cache: logits to 1e-4 (as test_torch_model.py), the written K/V rows
    to 1e-5, the same lengths and positions; a right-padded bucket
    too."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.manager import _flatten
    from repro.configs.registry import get_arch as jget_arch
    from repro.models.api import build_model as jbuild
    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.models.api import build_model as tbuild
    jcfg = jget_arch("llama3.2-1b", optimized=optimized).reduced()
    tcfg = tget_arch("llama3.2-1b", optimized=optimized).reduced()
    assert tcfg.attn_impl == ("pallas" if optimized else "xla")
    jm, tm = jbuild(jcfg), tbuild(tcfg, "cpu")
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    rng = np.random.default_rng(0)
    B, n, cap = 2, 24, 40
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, n)).astype(
        np.int32)}
    for length in (None, 19):
        jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(
            batch["tokens"])}, jm.init_cache(B, cap), length)
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(
            batch["tokens"])}, tm.init_cache(B, cap), length)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        rows = length or n
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tc["layers"], name)[:, :, :rows].numpy(),
                np.asarray(getattr(jc["layers"], name))[:, :, :rows],
                rtol=0, atol=1e-5)
        assert (tc["layers"].length.numpy() ==
                np.asarray(jc["layers"].length)[:, None]).all()
        assert (tc["pos"].numpy() == int(jc["pos"])).all()


@pytest.mark.parametrize("shape,seq", [("train_4k", 64),
                                       ("prefill_32k", 64),
                                       ("decode_32k", 96)])
def test_profile_cell_on_the_cpu(shape, seq):
    out = profile.profile_cell("llama3.2-1b", shape, {"attn_chunk": 16},
                               top=5, batch=2, device="cpu",
                               preset="reduced", seq_len=seq, steps=2)
    t = out["terms"]
    assert out["device"] == "cpu" and out["device_name"] == "cpu"
    assert out["batch"] == 2 and out["seq_len"] == seq and out["finite"]
    assert len(out["step_walls_s"]) == 2 and t.step_s > 0
    # no device time is measured on the CPU
    assert t.busy_s is None and t.idle_share is None
    assert out["rows"] is None and out["peak_memory_bytes"] is None
    assert out["launches"]["plain_calls"] > 0
    assert out["launches"]["rsa_gemm"] == 0
    train = shape == "train_4k"
    assert out["compute_dtype"] == "float32"
    assert t.peak_flops == 67e12
    assert out["overrides"] == {"attn_chunk": "16"}
    assert out["out_shape"] == ([] if train else [2, 512])
    assert t.model_flops > 0 and t.model_min_bytes > 0


def test_profile_cell_refuses_a_skipped_cell_and_no_device():
    with pytest.raises(ValueError, match="sub-quadratic"):
        profile.profile_cell("llama3.2-1b", "long_500k", device="cpu",
                             preset="reduced")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profile.profile_cell("llama3.2-1b", "decode_32k",
                                 preset="reduced", seq_len=8)


def test_run_variant_logs_and_caches(tmp_path, capsys):
    kw = dict(out_dir=tmp_path, device="cpu", preset="reduced", seq_len=32,
              steps=1)
    base = hillclimb.run_variant("llama3.2-1b", "decode_32k", "baseline",
                                 {}, "", **kw)
    var = hillclimb.run_variant("llama3.2-1b", "decode_32k", "chunk16",
                                {"attn_chunk": 16}, "smaller chunks", **kw)
    out = capsys.readouterr().out
    assert "% vs baseline" in out and "not measured" in out
    log = json.loads((tmp_path / "llama3.2-1b__decode_32k.json").read_text())
    assert [e["variant"] for e in log] == ["baseline", "chunk16"]
    assert log[1]["overrides"] == {"attn_chunk": "16"}
    assert log[1]["per_device_hbm_bytes"] is None
    assert var["roofline"]["step_s"] > 0 and base["device"] == "cpu"
    # cached unless forced
    again = hillclimb.run_variant("llama3.2-1b", "decode_32k", "chunk16",
                                  {"attn_chunk": 16}, "", **kw)
    assert again == log[1] and "[cached] chunk16" in capsys.readouterr().out
    forced = hillclimb.run_variant("llama3.2-1b", "decode_32k", "chunk16",
                                   {"attn_chunk": 16}, "rerun", force=True,
                                   **kw)
    assert forced["hypothesis"] == "rerun"
    log = json.loads((tmp_path / "llama3.2-1b__decode_32k.json").read_text())
    assert [e["variant"] for e in log] == ["baseline", "chunk16"]


def test_dryrun_on_the_cpu(tmp_path):
    rc = dryrun.main(["--device", "cpu", "--preset", "reduced", "--seq-len",
                      "48", "--steps", "1", "--arch",
                      "llama3.2-1b,rwkv6-1.6b", "--shape",
                      "train_4k,long_500k", "--out", str(tmp_path)])
    assert rc == 0
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert set(recs) == {f"{a}__{s}__cpu.json" for a in (
        "llama3.2-1b", "rwkv6-1.6b") for s in ("train_4k", "long_500k")}
    skip = recs["llama3.2-1b__long_500k__cpu.json"]
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]
    for name in ("llama3.2-1b__train_4k__cpu.json",
                 "rwkv6-1.6b__train_4k__cpu.json",
                 "rwkv6-1.6b__long_500k__cpu.json"):
        r = recs[name]
        assert r["status"] == "ok" and r["finite"], name
        assert r["roofline"]["busy_s"] is None and r["seq_len"] == 48
        assert r["num_params"] > 0 and r["model_flops"] > 0


def test_dryrun_meta_sweep_records_every_cell(tmp_path):
    rc = dryrun.main(["--device", "meta", "--out", str(tmp_path)])
    assert rc == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*__h100.json")]
    assert len(recs) == 40
    by = {(r["arch"], r["shape"]): r for r in recs}
    assert all(r["status"] in ("ok", "skipped") for r in recs)
    assert sum(r["status"] == "skipped" and "sub-quadratic" in r["reason"]
               for r in recs) == 8
    ok = by[("llama3.2-1b", "decode_32k")]
    assert ok["status"] == "ok" and ok["num_params"] == 1235814400
    assert ok["ideal"]["dominant"] == "memory"
    big = by[("deepseek-v3-671b", "train_4k")]
    assert big["status"] == "skipped" and "exceeds the 80 GB" in big["reason"]
    assert big["memory_estimate_bytes"] > 80e9
    fits = [r for r in recs if r["status"] == "ok"]
    assert all(r["memory_estimate_bytes"] <= 80e9 for r in fits)
    # cached: the second sweep rebuilds nothing
    assert dryrun.main(["--device", "meta", "--arch", "llama3.2-1b",
                        "--out", str(tmp_path)]) == 0


def test_multi_pod_has_no_counterpart():
    with pytest.raises(SystemExit, match="no mesh"):
        dryrun.main(["--multi-pod", "--device", "meta"])


@pytest.mark.parametrize("launcher,argv", [
    (profile, ["--arch", "llama3.2-1b", "--shape", "decode_32k"]),
    (hillclimb, ["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--variant", "baseline"])])
def test_every_launcher_refuses_multi_pod(launcher, argv):
    with pytest.raises(SystemExit, match="no mesh"):
        launcher.main(argv + ["--multi-pod", "--device", "cpu"])


def test_memory_estimate_arithmetic():
    """The dry-run's fit estimate at published widths, term by term:
    llama3.2-1b's f32 train step is bound by the update (parameters,
    gradients, m, v and the new m, v, updates and parameters: 8 x 4 bytes
    a parameter), gemma-2b's just passes 80 GB, and a serve cell
    (``build_serve_parts``: its trees on the meta device) holds its
    parameters, its cache and one layer's activations."""
    from repro_torch.configs.shapes import cache_specs
    from repro_torch.launch.steps import build_serve_parts
    from repro_torch.models.api import build_model
    from repro_torch.models.modules import param_bytes, tensors
    def one(name):          # batch 1 of the shape's length, as the sweep
        cfg, shape = profile.cell_config("llama3.2-1b", name, {})
        return cfg, dataclasses.replace(shape, global_batch=1)
    cfg, shape = one("train_4k")
    params = build_model(cfg, "meta").init_abstract()
    n = 1235814400
    mem, what = dryrun.memory_estimate(cfg, shape, params)
    assert mem == 8 * 4 * n and "update" in what
    backward = (4 * 4 * n + 4096 * 2048 * 16 * 4
                + 3 * 512 * cfg.vocab_size * 4)
    assert backward < mem
    g_cfg, _ = profile.cell_config("gemma-2b", "train_4k", {})
    g_model = build_model(g_cfg, "meta")
    g_mem, _ = dryrun.memory_estimate(g_cfg, shape, g_model.init_abstract())
    assert 80e9 < g_mem == 8 * 4 * g_model.num_params()
    for name, tokens in (("prefill_32k", 32768), ("decode_32k", 1)):
        cfg, shape = one(name)
        model, params, cache = build_serve_parts(cfg, shape, "meta")
        assert model.num_params(params) == n
        assert all(t.is_meta for t in tensors(params) + tensors(cache))
        assert param_bytes(cache) == param_bytes(cache_specs(cfg, shape))
        mem, what = dryrun.memory_estimate(cfg, shape, params, cache)
        assert mem == (param_bytes(params) + param_bytes(cache)
                       + tokens * (4 * 2048 + 3 * 8192) * 2)
        assert what == "parameters, cache and one layer's activations"


def test_sgd_momentum_matches_reference():
    import jax
    import jax.numpy as jnp
    ja = _reference("repro.optim.adamw")
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32),
         "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), p)
        for _ in range(3)]
    jopt, topt = ja.sgd_momentum(0.05, 0.8), sgd_momentum(0.05, 0.8)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.v is None and int(ts.step) == 0
    for g in grads:
        ju, js, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                                jp)
        tu, ts, _ = topt.update(jax.tree_util.tree_map(torch.from_numpy, g),
                                ts, tp)
        jp = ja.apply_updates(jp, ju)
        tp = {"w": tp["w"] + tu["w"], "b": {"c": tp["b"]["c"] + tu["b"]["c"]}}
    assert int(ts.step) == int(js.step) == 3
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(jp["b"]["c"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.m["w"].numpy(), np.asarray(js.m["w"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_profile_cell_finds_kernel_events_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    out = profile.profile_cell("llama3.2-1b", "decode_32k", top=5,
                               preset="reduced", seq_len=256, steps=2,
                               optimized=True)
    t = out["terms"]
    assert out["device"].startswith("cuda") and t.busy_s > 0
    assert 0.0 <= t.idle_share <= 1.0
    assert out["launches"]["rsa_gemm"] > 0
    assert out["launches"]["plain_calls"] == 0
    assert sum(r["device_ms"] for r in out["by_kernel"]) <= \
        1e3 * t.busy_s * (1 + 1e-9)
    assert any(r["family"] == "rsa_gemm" for r in out["by_kernel"])
