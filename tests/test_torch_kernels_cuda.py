"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (marked ``cuda``: each test skips where there is no CUDA device;
there is no interpret mode for a CUDA kernel).  Run on a machine with the
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 kernels sum in another order than the plain versions
(bounded by K * 2^-24 * max(|a| @ |b|) for the GEMM, 1e-5 for attention);
bf16 outputs add one bf16 rounding (2^-8 relative) per block_k chunk of
the GEMM, and the attention kernels round p to bf16 before p @ V.
"""

import math

import pytest
import torch

from repro_torch import dispatch
from repro_torch.core.hw import IS, OS, WS
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attn import (paged_attention_plain,
                                            paged_prefill_attention_plain)
from repro_torch.kernels.rsa_gemm import rsa_gemm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.parametrize("mode", [OS, WS, IS])
@pytest.mark.parametrize("dtype,out", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.bfloat16),
                                       (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("transposed", [False, True])
def test_rsa_gemm_kernel_matches_plain(cuda, mode, dtype, out, transposed):
    M, K, N, bk = 70, 600, 136, 256
    a = torch.randn((M, K), generator=cuda, device="cuda").to(dtype)
    stored = torch.randn((N, K) if transposed else (K, N), generator=cuda,
                         device="cuda").to(dtype)
    b = stored.t() if transposed else stored
    n0 = ops.launch_counts()["rsa_gemm"]
    got = ops.rsa_gemm(a, b, block_k=bk, mode=mode, out_dtype=out)
    assert ops.launch_counts()["rsa_gemm"] == n0 + 1
    want = rsa_gemm_plain(a, b, block_k=bk, mode=mode, out_dtype=out)
    tol = K * 2.0 ** -24 * (a.abs().float() @ b.abs().float()).max().item()
    if out == torch.bfloat16:
        chunks = 1 if mode == OS else math.ceil(K / bk)
        tol += (chunks + 1) * 2.0 ** -8 * want.abs().max().item()
    assert got.dtype == out
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
def test_paged_kernels_match_plain(cuda, dtype, tol):
    S, KVH, G, hd, bs = 4, 2, 4, 64, 16
    starts = torch.tensor([0, 5, 16, 0], dtype=torch.int32, device="cuda")
    chunks = torch.tensor([16, 7, 3, 0], dtype=torch.int32, device="cuda")
    lengths = starts + chunks
    W = 3
    tables = torch.arange(S * W, dtype=torch.int32,
                          device="cuda").reshape(S, W)
    k = torch.randn((S * W + 1, bs, KVH, hd), generator=cuda,
                    device="cuda").to(dtype)
    v = torch.randn_like(k)
    q = torch.randn((S, 16, KVH * G, hd), generator=cuda,
                    device="cuda").to(dtype)
    scale = hd ** -0.5
    with dispatch.use(execute="kernel"):
        got = ops.paged_prefill_attention(q, k, v, tables, starts, lengths)
    want = paged_prefill_attention_plain(q, k, v, tables, starts, lengths,
                                         scale=scale)
    assert (got.float() - want.float()).abs().max().item() <= tol
    with dispatch.use(execute="kernel"):
        got = ops.paged_attention(q[:, 0], k, v, tables, lengths)
    want = paged_attention_plain(q[:, 0], k, v, tables, lengths,
                                 scale=scale)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert got[3].abs().max().item() == 0.0      # the length-0 lane
