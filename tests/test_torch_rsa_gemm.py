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
from repro_torch.kernels.rsa_gemm import rsa_gemm_plain

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
