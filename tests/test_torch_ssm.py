"""RWKV6 parity: the port's WKV scans, block, model steps and the dense
engine's registry against the JAX reference on the same numpy inputs.

* The plain WKV version (``ops.wkv_attention`` on CPU tensors) against the
  reference's Pallas kernel in interpret mode and its ``_wkv_chunked``, on
  the reference's three ``tests/test_wkv_kernel.py`` shapes plus a
  one-token decode (chunk 1), at the reference's own 2e-5; state carry
  across two calls at its 3e-5.
* The plain linear attention against ``ops.linear_attn`` (Pallas,
  interpret) and the sequential ``ref.linear_attn_ref`` at the reference's
  2e-4.
* The plain twin of the CUDA kernel's chunk-parallel decomposition
  (``wkv_scan_parallel``: every chunk's intra part at once, the chain in
  chunk order, then the inter part; A factorised across 16-row
  sub-chunks) against ``wkv_scan``, the reference's Pallas
  ``linear_attn_bshk_pallas`` / ``linear_attn_pallas`` (interpret) and its
  ``_wkv_chunked``, on ``WKV_CASES``, chunk 64 at S = 64, 100 and 512 and
  chunks 24 and 40 (sub-chunk boundaries that do not divide them) with
  decays down to -e, and chunk 1 over 5 rows: 2e-5 absolute, and 1e-5 of
  the largest magnitude for the strong decays (their cumsums reach ~ -174,
  where summation order moves cs by ~1e-5).  Its final state is bitwise
  ``wkv_scan``'s: the chain rounds as the scan does.
* ``rwkv_block_apply``, model prefill and decode logits of the reduced
  rwkv6 (JAX-initialised weights carried across) for both ``ssm_impl``
  routes: 2e-5 (f32 summation order through two layers; logits ~3).
* The same in bf16 params and compute, from the same bf16 weights: the
  block's WKV state (everything before the scan in bf16) at 2e-5, its
  output and shift state within 4 bf16 ulps of their largest magnitude;
  prefill and decode logits within 5% of the largest logit.  The bf16 vs
  f32 logit gap of both packages at 2 and 24 layers is printed (``-s``):
  it grows with depth in the reference as in the port.
* Streaming equals batch: decode logits at step t equal one prefill of
  prompt + t tokens (the chunk-1 state carry against the chunked one),
  1e-5.
* The dense engine's site registry: every ``prefill:m{n}`` scope records
  the reference's sites and tiles; the ``decode`` scope the same sites and
  (K, N), at M = num_slots where the reference's vmapped trace records
  M = 1 (the port batches the lanes into one call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.registry import get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models.api import build_model as jbuild
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models.api import build_model as tbuild

WKV_CASES = [
    # B, S, H, K, V, chunk: tests/test_wkv_kernel.py's, then a decode step
    (2, 100, 3, 16, 16, 32),     # ragged S
    (1, 64, 1, 8, 24, 64),       # single chunk, V != K
    (2, 96, 4, 32, 32, 16),      # many chunks
    (3, 1, 4, 16, 16, 1),        # one token from a carried state
]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _wkv_inputs(case, seed=0, strong=False):
    """Random WKV operands; ``strong`` draws log decays over the model's
    whole clip range, -exp(U(-12, 1)) (down to -e)."""
    B, S, H, K, V, _ = case
    rng = np.random.default_rng(seed)
    f = np.float32
    r = rng.standard_normal((B, S, H, K)).astype(f)
    k = rng.standard_normal((B, S, H, K)).astype(f)
    v = rng.standard_normal((B, S, H, V)).astype(f)
    lw = -np.exp(rng.uniform(-12.0, 1.0, (B, S, H, K))) if strong else \
        -np.exp(rng.standard_normal((B, S, H, K)) * 0.5 - 2.0)
    return (r, k, v, lw.astype(f),
            (rng.standard_normal((H, K)) * 0.1).astype(f),
            (rng.standard_normal((B, H, K, V)) * 0.3).astype(f))


@pytest.mark.parametrize("case", WKV_CASES, ids=[str(c) for c in WKV_CASES])
def test_wkv_plain_matches_reference(case):
    args = _wkv_inputs(case)
    chunk = case[-1]
    o, sf = ops.wkv_attention(*map(torch.from_numpy, args), chunk=chunk)
    jargs = [jnp.asarray(a) for a in args]
    for jo, jsf in (jops.wkv_attention(*jargs, chunk, True),
                    jssm._wkv_chunked(*jargs, chunk)):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
        np.testing.assert_allclose(sf.numpy(), np.asarray(jsf), atol=2e-5)
    # the port's xla route is the same scan
    po, psf = ssm._wkv_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(po.numpy(), o.numpy(), atol=2e-5)
    np.testing.assert_allclose(psf.numpy(), sf.numpy(), atol=2e-5)


TWIN_CASES = [(c, False) for c in WKV_CASES] + [
    # chunk 64 at one, two (ragged) and eight chunks, sub-chunk boundaries
    # that do not divide the chunk, and chunk 1 over 5 rows; decays to -e
    ((1, 64, 2, 16, 16, 64), True),
    ((1, 100, 2, 16, 16, 64), True),
    ((1, 512, 2, 16, 16, 64), True),
    ((2, 96, 2, 16, 8, 24), True),
    ((1, 120, 2, 8, 16, 40), True),
    ((2, 5, 3, 16, 16, 1), True),
]


@pytest.mark.parametrize("case,strong", TWIN_CASES,
                         ids=[f"{c}{'-strong' if s else ''}"
                              for c, s in TWIN_CASES])
def test_wkv_parallel_twin_matches_reference(case, strong):
    """``wkv_scan_parallel`` (the CUDA kernel's decomposition) against the
    sequential plain scan, the reference's Pallas kernel in interpret mode
    and its ``_wkv_chunked``."""
    from repro_torch.kernels.linear_attn import wkv_scan, wkv_scan_parallel
    args = _wkv_inputs(case, 3, strong)
    S, chunk = case[1], case[-1]
    r, k, v, lw, u, s0 = map(torch.from_numpy, args)
    rr, kk, vv, ww = ops._pad_rows(chunk, r, k, v, lw)
    o, sf = wkv_scan_parallel(rr, kk, vv, ww, u[None], s0, chunk)
    po, psf = wkv_scan(rr, kk, vv, ww, u[None], s0, chunk)
    assert torch.equal(sf, psf)          # the chain rounds as the scan does
    o = o[:, :S].numpy()
    jargs = [jnp.asarray(a) for a in args]
    wants = [(po[:, :S].numpy(), psf.numpy())]
    wants += [tuple(map(np.asarray, w)) for w in (
        jops.wkv_attention(*jargs, chunk, True),
        jssm._wkv_chunked(*jargs, chunk))]
    for wo, wsf in wants:
        tol = 1e-5 * max(1.0, np.abs(wo).max(), np.abs(wsf).max()) \
            if strong else 2e-5
        np.testing.assert_allclose(o, wo, atol=tol, rtol=0)
        np.testing.assert_allclose(sf.numpy(), wsf, atol=tol, rtol=0)


@pytest.mark.parametrize("shape,chunk", [((2, 64, 16, 16), 16),
                                         ((4, 100, 16, 32), 32),
                                         ((1, 257, 32, 32), 64)])
def test_linear_attn_parallel_twin_matches_reference(shape, chunk):
    """The twin on ``linear_attn``'s layout (one head a row, u a row, zero
    state) against ``ops.linear_attn`` (Pallas, interpret) and the
    sequential ``ref.linear_attn_ref`` at the reference's 2e-4."""
    from repro_torch.kernels.linear_attn import wkv_scan_parallel
    BH, S, K, V = shape
    rng = np.random.default_rng(1)
    f = np.float32
    args = ((rng.standard_normal((BH, S, K)) * 0.5).astype(f),
            (rng.standard_normal((BH, S, K)) * 0.5).astype(f),
            rng.standard_normal((BH, S, V)).astype(f),
            (-np.exp(rng.standard_normal((BH, S, K)) * 0.5 - 3.0)).astype(f),
            (rng.standard_normal((BH, K)) * 0.1).astype(f))
    t = [torch.from_numpy(a) for a in args]
    padded = ops._pad_rows(chunk, *t[:4])
    o, _ = wkv_scan_parallel(*(x[:, :, None] for x in padded), t[4][:, None],
                             torch.zeros(BH, 1, K, V), chunk)
    out = o[:, :S, 0].numpy()
    jargs = [jnp.asarray(a) for a in args]
    for want in (jops.linear_attn(*jargs, chunk=chunk, interpret=True),
                 jref.linear_attn_ref(*jargs)):
        np.testing.assert_allclose(out, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_wkv_state_carry_composes():
    """[0:S/2] then [S/2:S] with the carried state equals one pass."""
    r, k, v, lw, u, s0 = map(torch.from_numpy, _wkv_inputs(WKV_CASES[2], 2))
    h = r.shape[1] // 2
    o, sf = ops.wkv_attention(r, k, v, lw, u, s0, chunk=16)
    oa, sa = ops.wkv_attention(r[:, :h], k[:, :h], v[:, :h], lw[:, :h], u,
                               s0, chunk=16)
    ob, sb = ops.wkv_attention(r[:, h:], k[:, h:], v[:, h:], lw[:, h:], u,
                               sa, chunk=16)
    np.testing.assert_allclose(torch.cat([oa, ob], 1).numpy(), o.numpy(),
                               atol=3e-5)
    np.testing.assert_allclose(sb.numpy(), sf.numpy(), atol=3e-5)


def test_wkv_is_forward_only():
    """The WKV wrapper now takes a gradient (the reference's custom VJP:
    the backward recomputes through the plain scan; its parity is in
    test_torch_train_ssm.py), and the same forward under no_grad; linear
    attention, which no model path differentiates, stays forward only."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(WKV_CASES[3])]
    args[0].requires_grad_(True)
    o, sf = ops.wkv_attention(*args, chunk=1)
    (o.sum() + sf.sum()).backward()
    assert args[0].grad is not None and torch.isfinite(args[0].grad).all()
    with torch.no_grad():
        o2, sf2 = ops.wkv_attention(*args, chunk=1)
    assert torch.equal(o.detach(), o2) and torch.equal(sf.detach(), sf2)
    r, k, v, lw = (t.detach()[:, :, 0] for t in args[:4])   # (BH, S, K)
    r.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.linear_attn(r, k, v, lw, args[4][:1].expand(r.shape[0], -1),
                        chunk=1)


@pytest.mark.parametrize("shape,chunk", [((2, 64, 16, 16), 16),
                                         ((4, 100, 16, 32), 32),
                                         ((1, 257, 32, 32), 64)])
def test_linear_attn_plain_matches_reference(shape, chunk):
    BH, S, K, V = shape
    rng = np.random.default_rng(1)
    f = np.float32
    args = ((rng.standard_normal((BH, S, K)) * 0.5).astype(f),
            (rng.standard_normal((BH, S, K)) * 0.5).astype(f),
            rng.standard_normal((BH, S, V)).astype(f),
            (-np.exp(rng.standard_normal((BH, S, K)) * 0.5 - 3.0)).astype(f),
            (rng.standard_normal((BH, K)) * 0.1).astype(f))
    out = ops.linear_attn(*map(torch.from_numpy, args), chunk=chunk)
    assert out.shape == (BH, S, V)
    jargs = [jnp.asarray(a) for a in args]
    for want in (jops.linear_attn(*jargs, chunk=chunk, interpret=True),
                 jref.linear_attn_ref(*jargs)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def rwkv():
    """Reduced rwkv6 (2 layers, d = 64, 4 heads of 16, f32), JAX-initialised,
    in both packages."""
    jcfg = get_arch("rwkv6-1.6b").reduced()
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(_flatten(jparams),
                                tget_arch("rwkv6-1.6b").reduced(), "cpu")
    return jparams, tparams


def _cfgs(impl):
    return (get_arch("rwkv6-1.6b").reduced().replace(ssm_impl=impl),
            tget_arch("rwkv6-1.6b").reduced().replace(ssm_impl=impl))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_rwkv_block_matches_reference(rwkv, impl):
    """One block from a nonzero state: output and all three new state
    leaves."""
    jparams, tparams = rwkv
    jcfg, tcfg = _cfgs(impl)
    rng = np.random.default_rng(3)
    B, S, d, H, K = 2, 21, 64, 4, 16
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    st = (rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.3,
          rng.standard_normal((B, d)).astype(np.float32),
          rng.standard_normal((B, d)).astype(np.float32))
    jblk = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["blk"])
    tblk = {k: v[0] for k, v in tparams["layers"]["blk"].items()}
    jy, jst = jssm.rwkv_block_apply(
        jblk, jnp.asarray(x), jcfg,
        jssm.RWKVState(*(jnp.asarray(a) for a in st)))
    with torch.no_grad():
        ty, tst = ssm.rwkv_block_apply(
            tblk, torch.from_numpy(x), tcfg,
            ssm.RWKVState(*(torch.from_numpy(a) for a in st)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_model_prefill_decode_match_reference(rwkv, impl):
    jparams, tparams = rwkv
    jcfg, tcfg = _cfgs(impl)
    jm, tm = jbuild(jcfg), tbuild(tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, 512, (2, 21)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, 32))
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jparams, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    assert tc["pos"].tolist() == [24, 24]


def _bf16_models(impl, num_layers=None):
    """Reduced rwkv6 with bf16 params and compute, JAX-initialised, in
    both packages, and the same weights in f32: ((jcfg, jparams, tcfg,
    tparams) in bf16, the same in f32)."""
    kw = dict(ssm_impl=impl)
    if num_layers is not None:
        kw["num_layers"] = num_layers
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    j32 = get_arch("rwkv6-1.6b").reduced().replace(**kw)
    t32 = tget_arch("rwkv6-1.6b").reduced().replace(**kw)
    j16, t16 = j32.replace(**bf), t32.replace(**bf)
    jp16 = jbuild(j16).init(jax.random.PRNGKey(0))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp16)
    return ((j16, jp16, t16, params_from_numpy(_flatten(jp16), t16, "cpu")),
            (j32, jp32, t32, params_from_numpy(_flatten(jp32), t32, "cpu")))


def _bf16_ulp(a) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of a."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _np32(a) -> np.ndarray:
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_rwkv_block_bf16_matches_reference(impl):
    """One bf16 block from a nonzero state.  The mixes, projections and
    decay run in bf16 in both packages, so the WKV scan sees the same
    inputs: its f32 state agrees at 2e-5, where the reference's own bf16
    and f32 runs differ by more than 1e-3.  After the scan, f32 summation
    noise flips a bf16 rounding here and there: the output and the
    channel-mix shift state agree within 4 bf16 ulps of their largest
    magnitude; the time-mix shift state (the input's last row) exactly."""
    (jc16, jp16, tc16, tp16), (jc32, jp32, _, _) = _bf16_models(impl)
    rng = np.random.default_rng(3)
    B, S, d, H, K = 2, 21, 64, 4, 16
    x = jnp.asarray(rng.standard_normal((B, S, d)), jnp.bfloat16)
    wkv = rng.standard_normal((B, H, K, K)).astype(np.float32) * 0.3
    shifts = [jnp.asarray(rng.standard_normal((B, d)), jnp.bfloat16)
              for _ in range(2)]

    def layer0(tree):
        return jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["blk"])
    jy, jst = jssm.rwkv_block_apply(
        layer0(jp16), x, jc16, jssm.RWKVState(jnp.asarray(wkv), *shifts))
    _, jst32 = jssm.rwkv_block_apply(
        layer0(jp32), x.astype(jnp.float32), jc32,
        jssm.RWKVState(jnp.asarray(wkv),
                       *(a.astype(jnp.float32) for a in shifts)))
    with torch.no_grad():
        ty, tst = ssm.rwkv_block_apply(
            {k: v[0] for k, v in tp16["layers"]["blk"].items()},
            torch.from_numpy(_np32(x)).bfloat16(), tc16,
            ssm.RWKVState(torch.from_numpy(wkv),
                          *(torch.from_numpy(_np32(a)).bfloat16()
                            for a in shifts)))
    assert ty.dtype == torch.bfloat16
    assert [t.dtype for t in tst] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    np.testing.assert_allclose(tst.wkv.numpy(), np.asarray(jst.wkv),
                               atol=2e-5)
    assert np.abs(np.asarray(jst.wkv) - np.asarray(jst32.wkv)).max() > 1e-3
    np.testing.assert_array_equal(_np32(tst.shift_t), _np32(jst.shift_t))
    for ours, theirs in ((ty, jy), (tst.shift_c, jst.shift_c)):
        want = _np32(theirs)
        np.testing.assert_allclose(_np32(ours), want,
                                   atol=4 * _bf16_ulp(want))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_model_bf16_logits_match_reference(impl):
    """Prefill and two decode steps of the 2-layer model in bf16: f32
    logits within 5% of the largest logit (the serving path's bf16
    tolerance on the card)."""
    (jc, jp, tc, tp), _ = _bf16_models(impl)
    jm, tm = jbuild(jc), tbuild(tc, device="cpu")
    toks = np.random.default_rng(4).integers(0, 512, (2, 21)).astype(np.int32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(2, 32))
    with torch.no_grad():
        tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                tm.init_cache(2))
    for step in range(3):
        want = np.asarray(jl)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), want,
                                   atol=0.05 * np.abs(want).max())
        if step == 2:
            break
        nxt = want.argmax(-1)[:, None].astype(np.int32)
        jl, jcache = jm.decode_step(jp, jnp.asarray(nxt), jcache)
        with torch.no_grad():
            tl, tcache = tm.decode_step(tp, torch.from_numpy(nxt), tcache)


def test_bf16_gap_grows_with_depth_in_both_packages():
    """The logits of bf16 params and compute against the same weights in
    f32, prefill of 2 x 21 tokens, at 2 and at 24 layers of the reduced
    width: the gap grows with depth in the reference as in the port (by
    more than 3x from 2 to 24 layers in each), and at each depth the
    port's gap is within 3x of the reference's.  Printed as a share of
    the largest f32 logit."""
    toks = np.random.default_rng(4).integers(0, 512, (2, 21)).astype(np.int32)
    gaps = {}
    for L in (2, 24):
        logits = {}
        for dt, (jc, jp, tc, tp) in zip(("bf16", "f32"),
                                        _bf16_models("pallas", L)):
            jm, tm = jbuild(jc), tbuild(tc, device="cpu")
            logits["ref", dt] = np.asarray(jm.prefill(
                jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 32))[0])
            with torch.no_grad():
                logits["port", dt] = tm.prefill(
                    tp, {"tokens": torch.from_numpy(toks)},
                    tm.init_cache(2))[0].numpy()
        top = np.abs(logits["ref", "f32"]).max()
        for pkg in ("ref", "port"):
            gaps[pkg, L] = np.abs(logits[pkg, "bf16"]
                                  - logits[pkg, "f32"]).max() / top
        print(f"{L} layers: bf16 vs f32 logits, share of the largest: "
              f"reference {gaps['ref', L]:.4f}, port {gaps['port', L]:.4f}")
    for pkg in ("ref", "port"):
        assert gaps[pkg, 24] > 3 * gaps[pkg, 2]
    for L in (2, 24):
        assert gaps["ref", L] / 3 < gaps["port", L] < 3 * gaps["ref", L]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_streaming_equals_batch(rwkv, impl):
    """Decode logits after t streamed tokens equal one prefill of the
    prompt plus those t tokens (chunk 16 over 20-23 rows against chunk 1
    steps)."""
    _, tparams = rwkv
    tm = tbuild(_cfgs(impl)[1], device="cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(5).integers(0, 512, (1, 20)).astype(np.int32))
    with torch.no_grad():
        logits, cache = tm.prefill(tparams, {"tokens": prompt},
                                   tm.init_cache(1))
        seq = prompt
        for _ in range(3):
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            seq = torch.cat([seq, nxt], 1)
            logits, cache = tm.decode_step(tparams, nxt, cache)
            batch, _ = tm.prefill(tparams, {"tokens": seq}, tm.init_cache(1))
            np.testing.assert_allclose(logits.numpy(), batch.numpy(),
                                       atol=1e-5)


def test_engine_registry_matches_reference(rwkv):
    """Both dense engines serve the same 3 requests on 2 slots: the prefill
    scopes hold the same sites and tiles; decode the same sites and
    (K, N), at M = num_slots in the port (one batched call) and M = 1 in
    the reference (its vmapped trace sees one lane)."""
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    jparams, tparams = rwkv
    jcfg, tcfg = _cfgs("pallas")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 21)]
    common = dict(num_slots=2, max_len=32, block_size=4, temperature=0.0,
                  clock="steps", kv_layout="auto", prefill_chunk=None)
    jeng = JServingEngine(jcfg, JEngineConfig(**common, execute="xla"),
                          params=jparams)
    jeng.run([JRequest(f"r{i}", p, 4) for i, p in enumerate(prompts)])
    teng = ServingEngine(tcfg, EngineConfig(**common), params=tparams,
                         device="cpu")
    teng.run([Request(f"r{i}", p, 4) for i, p in enumerate(prompts)])
    assert teng.kv_layout == jeng.kv_layout == "dense"
    assert set(teng.registry.scopes()) == set(jeng.registry.scopes()) == {
        "prefill:m5", "prefill:m13", "prefill:m21", "decode"}

    def key(rec):
        return (rec.m, rec.k, rec.n, rec.block_m, rec.block_n, rec.block_k,
                rec.mode)

    sites = {f"ssm.{s}" for s in ("r", "k", "v", "g", "decay_a", "decay_b",
                                  "out", "channel_k", "channel_v",
                                  "channel_r")} | {"unembed"}
    for scope in teng.registry.scopes():
        ours = teng.registry.sites(scope)
        theirs = jeng.registry.sites(scope)
        assert set(ours) == set(theirs) == sites
        if scope == "decode":
            assert {s: (r.k, r.n) for s, r in ours.items()} == \
                {s: (r.k, r.n) for s, r in theirs.items()}
            assert {r.m for r in ours.values()} == {2}
            assert {r.m for r in theirs.values()} == {1}
        else:
            assert {s: key(r) for s, r in ours.items()} == \
                {s: key(r) for s, r in theirs.items()}
