"""RSA GEMM parity: the port's plain version (what runs on CPU tensors, and
what the CUDA kernel is held against on the card) against the reference's
Pallas kernel in interpret mode (``repro.kernels.ops.rsa_gemm``).

Tolerances.  In f32 both sides are held against an f64 product with the
worst-case bound of an f32 sum of K products, ``K * 2^-24 * (|a| @ |b|)``
elementwise: the two implementations add in different orders, so neither
can be held to the other bitwise, and a fixed atol (1e-5) is tighter than
that noise already at K = 200.  In bf16 the WS/IS modes round every
block_k chunk to bf16 before adding (OS rounds once); the plain version
must reproduce that, so it is held to the reference within one bf16 ulp
per chunk, and shown to differ from the single-rounding result.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import dispatch
from repro_torch.core.hw import IS, OS, WS
from repro_torch.kernels import ops
from repro_torch.kernels.rsa_gemm import (_FIXUP_CAP, _psum_plan,
                                         rsa_gemm_plain)

MODES = [OS, WS, IS]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _bound(a, b):
    K = a.shape[1]
    return K * 2.0 ** -24 * (np.abs(a).astype(np.float64)
                             @ np.abs(b).astype(np.float64)) + 1e-30


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M,K,N,bk", [(128, 256, 128, 128),
                                      (130, 200, 72, 128),
                                      (1, 384, 256, 128)])
def test_plain_matches_pallas_f32(mode, M, K, N, bk):
    rng = np.random.default_rng(M * 7 + K + N + mode)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    ours = rsa_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                          block_k=bk, mode=mode).numpy()
    theirs = np.asarray(jops.rsa_gemm(jnp.asarray(a), jnp.asarray(b),
                                      block_m=128, block_n=128, block_k=bk,
                                      mode=mode, interpret=True))
    assert ours.shape == theirs.shape == (M, N)
    bound = _bound(a, b)
    assert (np.abs(ours - ref64) <= bound).all()
    assert (np.abs(theirs - ref64) <= bound).all()


def test_bf16_chunk_rounding_matches_reference():
    """K = 3 * block_k in bf16: WS/IS round each chunk, OS once."""
    rng = np.random.default_rng(3)
    M, K, N, bk = 16, 384, 128, 128
    a = rng.standard_normal((M, K)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal((K, N)).astype(ml_dtypes.bfloat16)
    ta = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    tb = torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)
    os_plain = rsa_gemm_plain(ta, tb, block_k=bk, mode=OS).float().numpy()
    for mode in (WS, IS):
        theirs = np.asarray(jops.rsa_gemm(
            jnp.asarray(a), jnp.asarray(b), block_m=128, block_n=128,
            block_k=bk, mode=mode, interpret=True)).astype(np.float32)
        ours = rsa_gemm_plain(ta, tb, block_k=bk, mode=mode)
        assert ours.dtype == torch.bfloat16
        ours = ours.float().numpy()
        # one bf16 ulp per chunk of the partial sums' magnitude
        ulp = 2.0 ** -7 * np.abs(theirs).max()
        assert np.abs(ours - theirs).max() <= 3 * ulp
        # the per-chunk rounding is visible: the single-rounding result
        # is further from the reference than the chunked plain version
        assert np.abs(os_plain - theirs).max() > np.abs(ours - theirs).max()


@pytest.mark.parametrize("mode", MODES)
def test_transposed_b_view(mode):
    """B given as the transpose of a row-major (N, K) matrix (the tied
    unembedding's ``embed.t()``) computes the same product."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((9, 200)).astype(np.float32))
    bt = torch.from_numpy(rng.standard_normal((72, 200)).astype(np.float32))
    view = bt.t()
    assert not view.is_contiguous()
    got = rsa_gemm_plain(a, view, block_k=128, mode=mode)
    want = rsa_gemm_plain(a, view.contiguous(), block_k=128, mode=mode)
    assert torch.equal(got, want)
    ref = np.asarray(jops.rsa_gemm(jnp.asarray(a.numpy()),
                                   jnp.asarray(bt.numpy()).T, block_m=128,
                                   block_n=128, block_k=128, mode=mode,
                                   interpret=True))
    bound = _bound(a.numpy(), view.numpy())
    assert (np.abs(got.numpy() - ref) <= 2 * bound).all()


def test_bf16_operands_f32_output_equal_f32_gemm():
    """The LM head's form: bf16 operands with f32 output is the f32 GEMM of
    the bf16 values (a bf16 product is exact in f32)."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    ab, bb = a.bfloat16(), b.bfloat16()
    for mode in MODES:
        got = rsa_gemm_plain(ab, bb, block_k=128, mode=mode,
                             out_dtype=torch.float32)
        want = rsa_gemm_plain(ab.float(), bb.float(), block_k=128, mode=mode)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    ops.reset_counts()
    a, b = torch.randn(4, 32), torch.randn(32, 8)
    out = ops.rsa_gemm(a, b, block_k=128, mode=IS)
    assert torch.allclose(out, a @ b, atol=1e-5)
    assert ops.launch_counts()["rsa_gemm"] == 0
    assert rsa_gemm_plain.calls == 1
    with pytest.raises(ValueError), dispatch.use(execute="kernel"):
        ops.rsa_gemm(a, b, block_k=128, mode=IS)


# ---------------------------------------------------------------------------
# OS as the WS/IS function with one chunk: the premise of running OS on the
# psum kernel (block_k >= K)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["plain", "A^T", "B^T", "bank"])
@pytest.mark.parametrize("dtype,out", [("f32", "f32"), ("bf16", "bf16"),
                                       ("bf16", "f32")])
@pytest.mark.parametrize("K", [20, 64, 200, 1000])
def test_os_is_one_chunk_of_ws_and_is(K, dtype, out, layout):
    """With block_k >= K the chunked rounding closes one chunk, T(acc): OS,
    WS and IS are bitwise the same function, for f32, bf16 -> bf16 and
    bf16 -> f32, a bank, A^T and B^T."""
    rng = np.random.default_rng(K + len(layout))
    E = 3 if layout == "bank" else 1
    M, N = 9, 40
    a = torch.from_numpy(rng.standard_normal((E, M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32))
    if dtype == "bf16":
        a, b = a.bfloat16(), b.bfloat16()
    if layout == "A^T":
        a = a[0].t().contiguous().t()
    elif layout == "B^T":
        b = b[0].t().contiguous().t()
    elif layout == "plain":
        a, b = a[0], b[0]
    odt = torch.float32 if out == "f32" else torch.bfloat16
    want = rsa_gemm_plain(a, b, block_k=128, mode=OS, out_dtype=odt)
    for bk in (-(-K // 64) * 64, 2048):
        for mode in (WS, IS):
            got = rsa_gemm_plain(a, b, block_k=bk, mode=mode, out_dtype=odt)
            assert got.dtype == odt and torch.equal(got, want), (bk, mode)


def _os_shapes():
    """(E, M, K, N, dtype, a_trans) of the OS launches on the main paths:
    llama decode k/v and prefill, the deepseek head banks, the training
    dx (up to the unembedding's K = 128256) and dw."""
    bf, f32 = torch.bfloat16, torch.float32
    return [(1, 8, 2048, 512, bf, False), (1, 512, 2048, 512, bf, False),
            (128, 8, 128, 512, bf, False), (128, 8, 512, 128, bf, False),
            (128, 512, 128, 512, bf, False),
            (1, 2048, 8192, 2048, f32, False),
            (1, 2048, 2048, 8192, f32, False),
            (1, 1024, 128256, 2048, f32, False),
            (1, 8, 128256, 2048, bf, False),
            (1, 2048, 2048, 512, f32, True),
            (1, 2048, 1024, 128256, f32, True),
            (1, 8, 2048, 128256, bf, False)]


@pytest.mark.parametrize("shape", _os_shapes(),
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_psum_plan_of_os_shapes(shape):
    """The OS block_k (K rounded up to 64) makes one chunk: the splits cover
    K exactly once, in pieces of whole 64-deep stages, and the workspace
    and fix-up caps hold, up to K = 128256."""
    E, M, K, N, dt, a_trans = shape
    bk = -(-K // 64) * 64
    plan = _psum_plan(E, M, K, N, bk, dt, 132, a_trans)
    spl = _splits(plan, K, bk)
    covered = []
    for k0, k1 in spl:
        assert 0 <= k0 <= k1 <= K
        covered += range(k0, k1)
    assert covered == list(range(K))
    assert plan.nsplit in (1, plan.pieces)        # the one chunk's pieces
    size = 2 if dt == torch.bfloat16 else 4
    assert plan.ws_elems * 4 <= min(PLAN_CAP_BYTES,
                                    0.5 * E * (M * K + K * N) * size)
    if plan.nsplit > 1:
        assert plan.piece % 64 == 0
        assert plan.nsplit * plan.tile_elems * 4 <= _FIXUP_CAP
        assert 2 * plan.tiles <= 132


# ---------------------------------------------------------------------------
# WS and IS as one function: the premise of the port's single WS/IS kernel
# ---------------------------------------------------------------------------

def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)


def _torch_bf16(x):
    return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("K", [4 * 128, 3 * 128 + 96], ids=["4bk", "ragged"])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_reference_ws_and_is_bitwise_equal(K, out):
    """The reference's WS and IS (Pallas, interpret mode) give the same bits:
    both add the same block_k chunk products in the same order, so one port
    kernel can serve both.  bf16 -> f32 is the reference run on the f32
    values of the bf16 operands (the port's LM-head form)."""
    rng = np.random.default_rng(K)
    a, b = _bf16(rng, (40, K)), _bf16(rng, (K, 136))
    if out == "f32":
        a, b = a.astype(np.float32), b.astype(np.float32)
    got = {mode: np.asarray(jops.rsa_gemm(
        jnp.asarray(a), jnp.asarray(b), block_m=128, block_n=128,
        block_k=128, mode=mode, interpret=True)) for mode in (WS, IS)}
    assert np.array_equal(got[WS].view(np.uint8), got[IS].view(np.uint8))
    # and the port's plain version is that function (one ulp per chunk)
    ta, tb = _torch_bf16(a.astype(ml_dtypes.bfloat16)), \
        _torch_bf16(b.astype(ml_dtypes.bfloat16))
    odt = torch.float32 if out == "f32" else None
    ours = rsa_gemm_plain(ta, tb, block_k=128, mode=WS, out_dtype=odt)
    want = got[WS].astype(np.float32)
    if out == "f32":
        bound = _bound(a, b)
        assert (np.abs(ours.numpy() - want) <= 2 * bound).all()
    else:
        ulp = 2.0 ** -7 * np.abs(want).max()
        assert np.abs(ours.float().numpy() - want).max() <= \
            (-(-K // 128) + 1) * ulp


@pytest.mark.parametrize("mode", [WS, IS])
@pytest.mark.parametrize("M,K", [(1, 384), (8, 384), (32, 384), (8, 20),
                                 (32, 24)])
def test_plain_matches_pallas_skinny(mode, M, K):
    """The skinny shapes the swapped-operand, split-K path takes (decode M
    = 1 and 8, expert banks at M = 32), and K below 32, in f32 against an
    f64 product with the file's bound."""
    rng = np.random.default_rng(M * 1000 + K)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, 200)).astype(np.float32)
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    ours = rsa_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                          block_k=128, mode=mode).numpy()
    theirs = np.asarray(jops.rsa_gemm(jnp.asarray(a), jnp.asarray(b),
                                      block_m=128, block_n=128, block_k=128,
                                      mode=mode, interpret=True))
    bound = _bound(a, b)
    assert (np.abs(ours - ref64) <= bound).all()
    assert (np.abs(theirs - ref64) <= bound).all()


@pytest.mark.parametrize("mode", [WS, IS])
def test_plain_bank_matches_pallas_members(mode):
    """A bank of E = 4 at M = 32: the plain bank product is, member by
    member, the reference's 2-D kernel (its vmap over the bank)."""
    rng = np.random.default_rng(17)
    E, M, K, N = 4, 32, 300, 96
    a = rng.standard_normal((E, M, K)).astype(np.float32)
    b = rng.standard_normal((E, K, N)).astype(np.float32)
    ours = rsa_gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                          block_k=128, mode=mode).numpy()
    for e in range(E):
        theirs = np.asarray(jops.rsa_gemm(
            jnp.asarray(a[e]), jnp.asarray(b[e]), block_m=128, block_n=128,
            block_k=128, mode=mode, interpret=True))
        ref64 = a[e].astype(np.float64) @ b[e].astype(np.float64)
        bound = _bound(a[e], b[e])
        assert (np.abs(ours[e] - ref64) <= bound).all()
        assert (np.abs(theirs - ref64) <= bound).all()


# ---------------------------------------------------------------------------
# the split plan of the WS/IS kernel (kernels/rsa_gemm.py::_psum_plan)
# ---------------------------------------------------------------------------

def _splits(plan, K, bk):
    """The (k0, k1) of every split, as the kernel derives them."""
    if plan.nsplit == 1:
        return [(0, K)]
    out = []
    for s in range(plan.nsplit):
        c, j = divmod(s, plan.pieces)
        cb, ce = c * bk, min(K, c * bk + bk)
        k0 = min(ce, cb + j * plan.piece)
        out.append((k0, min(ce, k0 + plan.piece)))
    return out


PLAN_GRID = [(E, M, K, N, bk, dt)
             for E in (1, 4, 256)
             for M in (1, 8, 32, 73, 300, 2048)
             for K in (20, 64, 1000, 2048, 7168)
             for N in (64, 576, 2048, 7168)
             for bk in (32, 256, 2048)
             for dt in (torch.bfloat16, torch.float32)]
PLAN_CAP_BYTES = 64 * 2 ** 20      # the workspace never exceeds 64 MiB


@pytest.mark.parametrize("chunk", range(8))
def test_psum_plan_splits_cover_k_inside_chunks(chunk):
    """On a grid of shapes: the splits cover K exactly once, each lies
    inside one block_k chunk and is a whole number of 16-deep k-steps up to
    K, the plan does not depend on the mode (it is not an input) and is a
    pure function of its inputs, and the workspace stays under the cap and
    under half the operands' bytes."""
    grid = PLAN_GRID[chunk::8]
    for E, M, K, N, bk, dt in grid:
        for a_trans in (False, True):
            plan = _psum_plan(E, M, K, N, bk, dt, 132, a_trans)
            assert plan == _psum_plan(E, M, K, N, bk, dt, 132, a_trans)
            spl = _splits(plan, K, bk)
            covered = []
            for k0, k1 in spl:
                assert 0 <= k0 <= k1 <= K
                if k1 > k0:
                    assert k0 // bk == (k1 - 1) // bk or plan.nsplit == 1
                    assert (k1 - k0) % 16 == 0 or k1 == K
                covered += range(k0, k1)
            assert covered == list(range(K)), (E, M, K, N, bk, dt)
            size = 2 if dt == torch.bfloat16 else 4
            assert plan.ws_elems * 4 <= min(
                PLAN_CAP_BYTES, 0.5 * E * (M * K + K * N) * size)
            if plan.nsplit > 1:
                assert plan.nsplit == -(-K // bk) * plan.pieces
                assert plan.piece % 64 == 0


def _main_path_shapes():
    """(M, K, N, block_k) of the WS/IS GEMMs of phase 4 (llama3.2-1b decode
    and prefill at its widths, block_k 2048) and phase 6 (deepseek-v3
    decode at its widths, block_k 2048)."""
    llama = [(M, K, N) for M in (8, 512) for K, N in
             ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))]
    llama.append((8, 2048, 128256))
    deepseek = [(8, 1536, 24576), (8, 2048, 7168), (8, 7168, 576),
                (8, 7168, 1536), (8, 7168, 2048), (8, 7168, 18432),
                (8, 7168, 129280), (8, 16384, 7168), (8, 18432, 7168)]
    return [(M, K, N, 2048) for M, K, N in llama + deepseek]


@pytest.mark.parametrize("shape", _main_path_shapes(),
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_psum_plan_covers_the_card(shape):
    """At phase 4's and phase 6's shapes, with 132 SMs, the grid reaches
    132 CTAs, or the plan already has as many splits as it allows: none
    where the tiles alone fill over half the card, else down to the
    smallest piece or up to the workspace and fix-up caps."""
    M, K, N, bk = shape
    plan = _psum_plan(1, M, K, N, bk, torch.bfloat16, 132)
    if plan.ctas >= 132:
        return
    if 2 * plan.tiles > 132:
        assert plan.nsplit == 1
        return
    most = -(-min(bk, K) // 256) * -(-K // bk)       # the smallest pieces
    finer = plan._replace(nsplit=most)
    assert plan.nsplit == most or finer.ws_elems * 4 > min(
        PLAN_CAP_BYTES, 0.5 * (M * K + K * N) * 2) or \
        most * plan.tile_elems * 4 > 512 * 2 ** 10, plan


def test_psum_plan_swaps_skinny_bf16_only():
    """bf16 at M <= 32 puts the weight on wgmma's 64-row side (n = 8 or 32,
    the smallest that holds M; 64 for an A^T n side, a whole panel);
    larger M and every f32 GEMM keep A's rows on the tile's M side."""
    for M, tile in ((1, 8), (8, 8), (9, 32), (32, 32)):
        plan = _psum_plan(1, M, 2048, 2048, 2048, torch.bfloat16, 132)
        assert plan.swap and plan.tile == tile
        assert _psum_plan(1, M, 2048, 2048, 2048, torch.bfloat16, 132,
                          True).tile == 64
    for M in (33, 73, 129, 512):
        assert not _psum_plan(1, M, 2048, 2048, 2048, torch.bfloat16,
                              132).swap
    for M in (1, 32, 2048):
        plan = _psum_plan(1, M, 2048, 2048, 2048, torch.float32, 132)
        assert not plan.swap and plan.tile == (32 if M <= 32 else 128)
