"""The port's example drivers (``examples/torch/*.py``) against the
reference's (``examples/*.py``, loaded from their files): each port
driver's ``main([..., "--device", "cpu"])`` runs at tiny settings, and
builds the reference's request trace, reduced configs and engine config
from the same flags and seed; quickstart's part 1 prints and returns the
reference's cycles and reads bitwise, and part 3 picks the reference's
tiles.  The reference drivers are stopped at their engine / trainer
(their arguments are captured), so no JAX model runs here."""

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name: str):
    return load(REPO / "examples" / "torch" / f"{name}.py",
                f"port_example_{name}")


def ref(name: str):
    return load(REPO / "examples" / f"{name}.py", f"ref_example_{name}")


class _Stop(Exception):
    pass


class _Model:
    def num_params(self, params=None):
        return 0


def _fields(cfg):
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# serve_requests: the trace, the served config and the engine config
# ---------------------------------------------------------------------------

def _capture_serve(mod, monkeypatch, argv, api):
    """Run ``mod.main`` on ``argv`` up to the engine: {cfg, ecfg,
    requests}."""
    got = {}

    class Engine:
        def __init__(self, cfg, ecfg, *a, **kw):
            got["cfg"], got["ecfg"] = cfg, ecfg

        def run(self, reqs):
            got["requests"] = list(reqs)
            raise _Stop

    monkeypatch.setattr(mod, "ServingEngine", Engine)
    monkeypatch.setattr(api, "build_model", lambda *a, **kw: _Model())
    monkeypatch.setattr(sys, "argv", ["serve_requests.py", *argv])
    with pytest.raises(_Stop):
        mod.main()
    return got


@pytest.mark.parametrize("argv", [
    [],
    ["--requests", "6", "--slots", "3", "--d-model", "64", "--layers", "2",
     "--seed", "3", "--max-prompt", "20", "--max-gen", "9",
     "--temperature", "0.0"],
])
def test_serve_requests_matches_the_reference(monkeypatch, argv):
    import repro.models.api as ref_api
    import repro_torch.models.api as port_api
    want = _capture_serve(ref("serve_requests"), monkeypatch, argv, ref_api)
    got = _capture_serve(port("serve_requests"), monkeypatch,
                         argv + ["--device", "cpu"], port_api)
    assert _fields(got["cfg"]) == _fields(want["cfg"])
    g, w = _fields(got["ecfg"]), _fields(want["ecfg"])
    # one default differs between the packages' EngineConfig: the port's
    # prefill_chunk "auto" (64-token chunks on the paged layout), the
    # reference's None (bucketed prefill)
    assert (g.pop("prefill_chunk"), w.pop("prefill_chunk")) == ("auto", None)
    assert g == w
    assert len(got["requests"]) == len(want["requests"]) > 0
    for g, w in zip(got["requests"], want["requests"]):
        assert (g.rid, g.max_new_tokens, g.arrival_time) == \
            (w.rid, w.max_new_tokens, w.arrival_time)
        assert g.prompt.dtype == w.prompt.dtype
        np.testing.assert_array_equal(g.prompt, w.prompt)


def test_serve_requests_runs_on_the_cpu():
    out = port("serve_requests").main([
        "--requests", "4", "--slots", "2", "--d-model", "64", "--layers",
        "2", "--max-prompt", "16", "--max-gen", "6", "--device", "cpu"])
    eng = out["engine"]
    assert sorted(out["outputs"]) == [r.rid for r in out["requests"]]
    assert all(r.outcome == "done" for r in eng.requests.values())
    assert all(len(out["outputs"][r.rid]) == r.max_new_tokens
               for r in out["requests"])
    eng.pool.check()
    assert eng.pool.num_free == eng.pool.num_blocks
    assert eng.kv_layout == "paged" and eng.gemm_plan


# ---------------------------------------------------------------------------
# train_lm: presets, configs and the trainer's arguments
# ---------------------------------------------------------------------------

def _capture_train(mod, monkeypatch, argv, api):
    got = {}

    def train_main(**kw):
        got.update(kw)
        raise _Stop

    monkeypatch.setattr(mod, "train_main", train_main)
    monkeypatch.setattr(api, "build_model", lambda *a, **kw: _Model())
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    with pytest.raises(_Stop):
        mod.main()
    return got


@pytest.mark.parametrize("preset", ["8m", "25m", "100m"])
def test_train_lm_matches_the_reference(monkeypatch, preset):
    import repro.models.api as ref_api
    import repro_torch.models.api as port_api
    rmod, pmod = ref("train_lm"), port("train_lm")
    assert pmod.PRESETS == rmod.PRESETS
    argv = ["--preset", preset, "--steps", "24", "--inject-failure"]
    want = _capture_train(rmod, monkeypatch, argv, ref_api)
    got = _capture_train(pmod, monkeypatch, argv + ["--device", "cpu"],
                         port_api)
    assert _fields(got.pop("override_cfg")) == \
        _fields(want.pop("override_cfg"))
    assert callable(got.pop("fail_injector"))
    assert callable(want.pop("fail_injector"))
    # both default to train_lm_ckpt, the port's in the temp directory
    assert Path(got.pop("checkpoint_dir")).name == \
        Path(want.pop("checkpoint_dir")).name == "train_lm_ckpt"
    assert got.pop("device") == "cpu"
    assert got == want


def test_train_lm_restarts_once_from_its_checkpoint(monkeypatch, tmp_path):
    """A tiny preset (the test's own), 20 steps, a preemption at step 10:
    one restart, from the step-10 checkpoint (no step runs twice)."""
    mod = port("train_lm")
    monkeypatch.setitem(mod.PRESETS, "tiny", (64, 2, 512, 32, 4))
    out = mod.main(["--preset", "tiny", "--steps", "20", "--inject-failure",
                    "--ckpt", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert out["fired"] == [10] and out["driver"].restarts == 1
    assert [h["step"] for h in out["history"]] == list(range(20))
    losses = [h["loss"] for h in out["history"]]
    # each step draws a new batch: the last 5 steps against the first 5
    assert np.isfinite(losses).all() and \
        np.mean(losses[-5:]) < np.mean(losses[:5])
    assert out["cfg"].d_model == 64 and out["cfg"].head_dim == 8


# ---------------------------------------------------------------------------
# quickstart and selfadaptive_gemm
# ---------------------------------------------------------------------------

def test_quickstart_part1_is_the_reference_bitwise(capsys):
    from repro.core import costmodel as cm
    from repro.core.hw import OS
    from repro.core.rsa import SAGAR_INSTANCE
    ref("quickstart").part1_cost_model()
    want_text = capsys.readouterr().out
    got = port("quickstart").part1_cost_model()
    assert capsys.readouterr().out == want_text
    M, K, N = 256, 64, 256
    mono = cm.monolithic_cost(M, K, N, 128, 128, OS)
    dist = cm.distributed_cost(M, K, N, 32, 32, 16, OS)
    assert got == {
        "monolithic_cycles": float(mono.runtime),
        "monolithic_reads": float(mono.sram_reads),
        "distributed_cycles": float(dist.runtime),
        "distributed_reads": float(dist.sram_reads),
        "rsa_best_cycles": float(cm.oracle_runtime(SAGAR_INSTANCE, [M],
                                                   [K], [N])[0])}


def test_quickstart_runs_and_picks_the_reference_tiles(tmp_path,
                                                       monkeypatch):
    """``main`` on the CPU with parts 2 and 4 cut to 2000 samples, one
    epoch and two steps (the driver takes no flag for these: its parts
    do)."""
    from repro.core.sara import SaraDispatcher
    qs = port("quickstart")
    monkeypatch.setattr(qs, "part2_adaptnet",
                        functools.partial(qs.part2_adaptnet, 2000, 1))
    monkeypatch.setattr(qs, "part4_train",
                        functools.partial(qs.part4_train, 2))
    out = qs.main(["--ckpt", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert set(out) == {"part1", "part2", "part3", "part4"}
    assert 0.0 <= out["part2"].test_accuracy <= 1.0
    d = SaraDispatcher()
    for row in out["part3"]:
        want = d.recommend(row["M"], row["K"], row["N"])
        got = row["cfg"]
        assert (got.block_m, got.block_n, got.block_k, got.mode,
                got.class_id) == (want.block_m, want.block_n, want.block_k,
                                  want.mode, want.class_id)
        assert got.describe() == want.describe()
        assert row["max_abs_err"] <= 1e-5 * row["K"] ** 0.5
    [(M, K, N), (M2, K2, N2)] = [(r["M"], r["K"], r["N"])
                                 for r in out["part3"]]
    assert (M, K, N, M2, K2, N2) == (512, 512, 512, 128, 8000, 128)
    _, history, driver = out["part4"]
    assert len(history) == 2 and driver.restarts == 0


def test_selfadaptive_gemm_front_runs():
    res = port("selfadaptive_gemm").main([
        "--samples", "2000", "--epochs", "1", "--layers", "2",
        "--device", "cpu"])
    assert len(res["layers"]) == 2
    assert all(r["out"].shape == (r["M"], r["N"]) for r in res["layers"])


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("serve_requests", []), ("train_lm", []),
    ("selfadaptive_gemm", ["--samples", "64", "--epochs", "1"])])
def test_drivers_raise_without_cuda(monkeypatch, name, argv):
    """The default device is CUDA; where there is none a driver raises
    before any work instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port(name).main(argv)
