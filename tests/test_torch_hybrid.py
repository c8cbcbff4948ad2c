"""The hybrid family (zamba2-7b: Mamba2 blocks and one weight-shared
attention + MLP block every ``shared_attn_every`` slots) against the JAX
reference, on the CPU in f32 at the reduced preset (7 slots, a shared
block every 3rd: 2 groups of 2 Mamba layers and a remainder of 1), from
JAX-initialised weights carried across with ``params_from_numpy``.

- ``_ssd_chunked`` (the SSD scan) at S = 1, 5, 16 and 37 over chunks of
  16 from a carried state (one 1-row chunk, one ragged chunk, one whole
  chunk, three chunks with a ragged last): y and the final state at 2e-5
  (f32 einsums summed in another order).
- ``mamba_block_apply`` from a nonzero state: output, SSM state and conv
  rows at 2e-5; a prefill then decode steps equal one long prefill (the
  1-row chunk against the chunked scan, and the conv's carried rows), at
  2e-5.
- The model's ``forward`` logits, ``prefill`` and ``decode_step``: logits
  at 5e-5 (two groups of f32 GEMMs, attention and SSD scans, logits ~4),
  every Mamba state, conv row and K/V row of the cache at 2e-5, the KV
  lengths and positions exactly; ``init_cache``'s shapes are the
  reference's per sequence.
- The dense engine against the JAX engine on a trace that stalls and
  preempts: greedy tokens, stalls, preemptions and every registry scope's
  sites and tiles exactly (decode at M = num_slots in the port's one
  batched call, M = 1 in the reference's vmapped trace); a free slot's
  state does not advance; the paged layout and chunked prefill are
  refused with the reference's reasons.
- A port-saved zamba2 tree restores in the reference's manager leaf for
  leaf; the serving CLI's smoke runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.models import ssm as jssm
from repro.models.api import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.checkpoint import CheckpointManager, params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.models import ssm
from repro_torch.models.api import build_model as tbuild
from repro_torch.models.transformer import hybrid_layout
from repro_torch.serving import EngineConfig, Request, ServingEngine

ARCH = "zamba2-7b"
ATOL_STATE, ATOL_LOGITS = 2e-5, 5e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def zamba():
    jcfg, tcfg = get_arch(ARCH).reduced(), tget_arch(ARCH).reduced()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tbuild(tcfg, device="cpu"), \
        params_from_numpy(_flatten(jp), tcfg, "cpu")


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def test_reduced_preset_is_the_reference_hybrid_layout():
    cfg = tget_arch(ARCH).reduced()
    assert (cfg.num_layers, cfg.shared_attn_every) == (7, 3)
    assert hybrid_layout(cfg) == (5, 2, 2, 1)
    assert hybrid_layout(tget_arch(ARCH)) == (68, 13, 5, 3)
    assert ssm.mamba_dims(tget_arch(ARCH)) == jssm.mamba_dims(get_arch(ARCH))


@pytest.mark.parametrize("S", [1, 5, 16, 37])
def test_ssd_chunked_matches_reference(S):
    rng = np.random.default_rng(S)
    B, H, P, N, lc = 2, 3, 8, 16, 16
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    loga = -np.exp(rng.standard_normal((B, S, H)) * 0.5 - 1.0).astype(
        np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, (xh, Bm, Cm, loga, h0)), lc)
    ty, th = ssm._ssd_chunked(*map(torch.from_numpy, (xh, Bm, Cm, loga, h0)),
                              lc)
    assert ty.shape == (B, S, H, P) and th.shape == (B, H, P, N)
    _close(ty, jy, ATOL_STATE)
    _close(th, jh, ATOL_STATE)


def _block(params, i):
    return {k: v[i] for k, v in params["layers"]["blk"].items()}


def _state(rng, cfg, B):
    d_inner, H, P, N = ssm.mamba_dims(cfg)
    return ((rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32),
            rng.standard_normal((B, cfg.ssm.conv_width - 1,
                                 d_inner + 2 * N)).astype(np.float32))


def test_mamba_block_matches_reference(zamba):
    """One block from a nonzero state: its output and both state leaves."""
    jm, jp, tm, tp = zamba
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    st = _state(rng, cfg, 2)
    jblk = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["blk"])
    with jdispatch.use(execute="xla"):
        jy, jst = jssm.mamba_block_apply(
            jblk, jnp.asarray(x), jm.cfg,
            jssm.MambaState(*map(jnp.asarray, st)))
    with torch.no_grad():
        ty, tst = ssm.mamba_block_apply(
            _block(tp, 1), torch.from_numpy(x), cfg,
            ssm.MambaState(*map(torch.from_numpy, st)))
    _close(ty, jy, ATOL_STATE)
    for a, b in zip(tst, jst):
        _close(a, b, ATOL_STATE)


def test_mamba_prefill_then_decode_equals_one_prefill(zamba):
    """A 12-token prefill, then 5 one-token steps, against one prefill of
    all 17 tokens (a chunk of 16 and a ragged one), which is the
    reference's."""
    jm, jp, tm, tp = zamba
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 17, cfg.d_model)).astype(np.float32)
    st0 = ssm.MambaState(*map(torch.from_numpy, _state(rng, cfg, 2)))
    blk = _block(tp, 0)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["blk"])
    with torch.no_grad():
        whole, st_whole = ssm.mamba_block_apply(blk, torch.from_numpy(x),
                                                cfg, st0)
        outs, st = [], st0
        y, st = ssm.mamba_block_apply(blk, torch.from_numpy(x[:, :12]), cfg,
                                      st)
        outs.append(y)
        for t in range(12, 17):
            y, st = ssm.mamba_block_apply(
                blk, torch.from_numpy(x[:, t:t + 1]), cfg, st)
            outs.append(y)
    _close(torch.cat(outs, 1), whole, ATOL_STATE)
    for a, b in zip(st, st_whole):
        _close(a, b, ATOL_STATE)
    with jdispatch.use(execute="xla"):
        jy, _ = jssm.mamba_block_apply(
            jblk, jnp.asarray(x), jm.cfg,
            jssm.MambaState(*(jnp.asarray(_np(t)) for t in st0)))
    _close(whole, jy, ATOL_STATE)


def _cache_close(tc, jc):
    """The port's cache (layer-major, a batch axis) against the
    reference's, field by field; KV lengths and positions exactly."""
    for a, b in zip(tc["layers"], jc["layers"]):
        _close(a, b, ATOL_STATE)
    _close(tc["attn"].k, jc["attn"].k, ATOL_STATE)
    _close(tc["attn"].v, jc["attn"].v, ATOL_STATE)
    B = tc["pos"].shape[0]
    jlen = np.broadcast_to(_np(jc["attn"].length)[:, None],
                           tc["attn"].length.shape)
    assert np.array_equal(_np(tc["attn"].length), jlen)
    assert np.array_equal(_np(tc["pos"]),
                          np.broadcast_to(_np(jc["pos"]), (B,)))


def test_init_cache_matches_reference(zamba):
    jm, _, tm, _ = zamba
    jc, tc = jm.init_cache(3, 10), tm.init_cache(3, 10)
    assert set(tc) == set(jc) == {"pos", "layers", "attn"}
    for a, b in zip(tc["layers"], jc["layers"]):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    for f in ("k", "v"):
        assert tuple(getattr(tc["attn"], f).shape) == \
            getattr(jc["attn"], f).shape
    assert tuple(tc["attn"].length.shape) == (2, 3)
    with pytest.raises(ValueError, match="max_len"):
        tm.init_cache(1, 0)


def test_forward_logits_match_reference(zamba):
    jm, jp, tm, tp = zamba
    toks = np.random.default_rng(0).integers(0, 512, (2, 22)).astype(
        np.int32)
    with jdispatch.use(execute="xla"):
        want = jm.logits(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = tm.logits(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == (2, 21, 512)
    _close(got, want, ATOL_LOGITS)


def test_prefill_and_decode_match_reference(zamba):
    """Prefill 21 tokens, then 3 greedy decode steps: logits and the whole
    cache after each call."""
    jm, jp, tm, tp = zamba
    toks = np.random.default_rng(4).integers(0, 512, (2, 21)).astype(
        np.int32)
    with jdispatch.use(execute="xla"):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(2, 32))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2, 32))
    _close(tl, jl, ATOL_LOGITS)
    _cache_close(tc, jc)
    nxt = _np(jl).argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        with jdispatch.use(execute="xla"):
            jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        _close(tl, jl, ATOL_LOGITS)
        _cache_close(tc, jc)
        nxt = _np(jl).argmax(-1)[:, None].astype(np.int32)
    assert tc["pos"].tolist() == [24, 24]
    with pytest.raises(ValueError, match="exact-length"):
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                   tm.init_cache(2, 32), length=20)


def _prompts(lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lengths]


# a pool too small for all three under incremental reservation: the
# dense layout stalls (rolling a lane back to its snapshot) and preempts
STALLING = dict(num_slots=2, max_len=24, block_size=4, temperature=0.0,
                clock="steps", prefill_chunk=None, reserve="incremental",
                num_blocks=7)


def test_engine_matches_reference_with_stalls_and_preemption(zamba):
    jm, jp, tm, tp = zamba
    prompts = _prompts((9, 10, 6))
    jeng = JServingEngine(jm.cfg, JEngineConfig(**STALLING, execute="xla"),
                          params=jp)
    jout = jeng.run([JRequest(f"r{i}", p, 10)
                     for i, p in enumerate(prompts)])
    teng = ServingEngine(tm.cfg, EngineConfig(**STALLING), params=tp,
                         device="cpu")
    tout = teng.run([Request(f"r{i}", p, 10)
                     for i, p in enumerate(prompts)])
    assert teng.kv_layout == jeng.kv_layout == "dense"
    assert set(tout) == set(jout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert len(tout[rid]) == 10
    assert teng.metrics.stalls == jeng.metrics.stalls > 0
    assert teng.metrics.preemptions == jeng.metrics.preemptions > 0
    assert teng.metrics.completed == jeng.metrics.completed == 3
    teng.pool.check()
    assert teng.pool.num_free == teng.pool.num_blocks

    def key(rec):
        return (rec.m, rec.k, rec.n, rec.block_m, rec.block_n, rec.block_k,
                rec.mode)

    sites = {"ssm.in_proj", "ssm.out_proj", "unembed"} | {
        f"layer.attn.{s}" for s in ("q", "k", "v", "out")} | {
        f"layer.mlp.{s}" for s in ("gate", "up", "down")}
    assert set(teng.registry.scopes()) == set(jeng.registry.scopes())
    for scope in teng.registry.scopes():
        ours, theirs = (teng.registry.sites(scope),
                        jeng.registry.sites(scope))
        assert set(ours) == set(theirs) == sites, scope
        if scope == "decode":
            assert {s: (r.k, r.n) for s, r in ours.items()} == \
                {s: (r.k, r.n) for s, r in theirs.items()}
            assert {r.m for r in ours.values()} == {2}
            assert {r.m for r in theirs.values()} == {1}
        else:
            assert {s: key(r) for s, r in ours.items()} == \
                {s: key(r) for s, r in theirs.items()}, scope


def test_free_slot_state_does_not_advance(zamba):
    """One request on two slots: the idle slot's Mamba states, KV lengths
    and position stay zero through every batched decode.  Its lane writes
    only the K/V row at its position (0), past its length, where attention
    masks it until an admission overwrites the slot."""
    _, _, tm, tp = zamba
    eng = ServingEngine(tm.cfg, EngineConfig(
        num_slots=2, max_len=24, temperature=0.0, clock="steps",
        prefill_chunk=None), params=tp, device="cpu")
    eng.submit(Request("r0", _prompts((7,))[0], 6))
    while eng.step():
        c = eng._cache
        assert int(c["pos"][1]) == 0
        assert not c["attn"].length[:, 1].any()
        assert not c["attn"].k[:, 1, 1:].any()
        assert not c["attn"].v[:, 1, 1:].any()
        for t in c["layers"]:
            assert not t[:, 1].any()
    assert eng.metrics.decode_steps == 5
    assert int(eng._cache["pos"][0]) == 7 + 5


@pytest.mark.parametrize("kw", [dict(kv_layout="paged"),
                                dict(prefill_chunk=8),
                                dict(kv_layout="paged", prefill_chunk=8)])
def test_paged_layout_and_chunked_prefill_refused_as_reference(zamba, kw):
    jm, _, tm, _ = zamba
    with pytest.raises(ValueError) as want:
        JServingEngine(jm.cfg, JEngineConfig(**kw))
    with pytest.raises(ValueError) as got:
        ServingEngine(tm.cfg, EngineConfig(**kw), device="cpu")
    reason = str(want.value).split(";")[0].split(" (")[0]
    assert reason in str(got.value)


def test_port_saved_tree_restores_in_reference(zamba, tmp_path):
    jm, jp, tm, _ = zamba
    own = tm.init(7)
    CheckpointManager(str(tmp_path)).save(3, own)
    step, tree, _ = JManager(str(tmp_path)).restore(jp)
    assert step == 3
    got, mine = _flatten(tree), _flatten(jax.tree_util.tree_map(
        np.asarray, _torch_tree(own)))
    assert set(got) == set(_flatten(jp)) == set(mine)
    for k, a in got.items():
        assert np.array_equal(np.asarray(a), mine[k]), k


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def test_serve_cli_smoke(capsys):
    import sys
    from repro_torch.launch.serve import main
    argv = sys.argv
    sys.argv = ["serve", "--arch", ARCH, "--preset", "reduced", "--smoke",
                "--device", "cpu"]
    try:
        main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "serving smoke OK" in out and "ssm.in_proj" in out


def test_bf16_engine_serves(zamba):
    """bf16 params and compute (the card's dtype) on the dense layout:
    every request finishes with its budget and the pool ends whole."""
    _, _, tm, _ = zamba
    cfg = dataclasses.replace(tm.cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    eng = ServingEngine(cfg, EngineConfig(num_slots=2, max_len=32,
                                          temperature=0.0, clock="steps",
                                          prefill_chunk=None),
                        device="cpu")
    out = eng.run([Request(f"r{i}", p, 5)
                   for i, p in enumerate(_prompts((3, 17, 9)))])
    assert sorted(out) == ["r0", "r1", "r2"]
    assert all(len(t) == 5 for t in out.values())
    assert eng._cache["layers"].ssm.dtype == torch.float32
    assert eng._cache["attn"].k.dtype == torch.bfloat16
    assert eng.pool.num_free == eng.pool.num_blocks
