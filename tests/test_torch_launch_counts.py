"""The kernel functions count a launch only where the kernel was launched
and its launch returned no error: never on the early returns of an empty
problem, never on a failed launch.  No card is needed: CPU tensors pose as
CUDA ones and a stand-in library takes the launch calls, returning the
error code each test sets.  Nothing reads or writes the outputs' data.
"""

from types import SimpleNamespace

import pytest
import torch

from repro_torch.core.hw import IS, OS
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attn import (flash_dkv_cuda, flash_dq_cuda,
                                            flash_fwd_cuda)
from repro_torch.kernels.linear_attn import linear_attn_cuda, wkv_bshk_cuda
from repro_torch.kernels.paged_attn import (NEG, paged_decode_cuda,
                                            paged_decode_lse_cuda,
                                            paged_prefill_cuda,
                                            paged_prefix_cuda)
from repro_torch.kernels.paged_mla import (paged_mla_decode_cuda,
                                           paged_mla_prefill_cuda)
from repro_torch.kernels.rsa_gemm import rsa_gemm_cuda


class _Library:
    """Stands in for a built kernel library: records each launch call and
    returns ``err`` (0 = cudaSuccess)."""

    def __init__(self):
        self.calls = []
        self.err = 0

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            return self.err
        return launch


@pytest.fixture
def card(monkeypatch):
    torch.set_num_threads(2)
    lib = _Library()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "library", lambda name: lib)
    ops.reset_counts()
    yield lib
    ops.reset_counts()


@pytest.mark.parametrize("M,K,N", [(0, 64, 32), (8, 64, 0), (8, 0, 32)])
def test_empty_gemm_counts_no_launch(card, M, K, N):
    out = rsa_gemm_cuda(torch.zeros(M, K), torch.zeros(K, N), block_k=64,
                        mode=IS)
    assert out.shape == (M, N)
    assert card.calls == []
    assert ops.launch_counts()["rsa_gemm"] == 0
    assert rsa_gemm_cuda.launches_by_key == {}


def test_gemm_counts_each_launch_by_shape(card):
    a, b = torch.zeros(8, 64), torch.zeros(64, 32)
    rsa_gemm_cuda(a, b, block_k=64, mode=IS)
    rsa_gemm_cuda(a, b, block_k=64, mode=IS)
    rsa_gemm_cuda(a, b.t().contiguous().t(), block_k=64, mode=OS)
    # WS/IS launch the psum kernel's library, OS the OS kernel's
    assert card.calls == ["rsa_psum_launch"] * 2 + ["rsa_gemm_launch"]
    assert ops.launch_counts()["rsa_gemm"] == 3
    assert rsa_gemm_cuda.launches_by_key == {(8, 64, 32, IS): 2,
                                             (8, 64, 32, OS): 1}


def test_failed_gemm_launch_raises_and_counts_nothing(card):
    card.err = 9                       # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        rsa_gemm_cuda(torch.zeros(8, 64), torch.zeros(64, 32), block_k=64,
                      mode=IS)
    assert card.calls == ["rsa_psum_launch"]
    assert ops.launch_counts()["rsa_gemm"] == 0


def _paged(S, C, err, card):
    KVH, G, hd, bs, W = 2, 2, 8, 4, 3
    k = torch.zeros(S * W + 1, bs, KVH, hd)
    tables = torch.zeros(S, W, dtype=torch.int32)
    lengths = torch.ones(S, dtype=torch.int32)
    card.err = err
    paged_decode_cuda(torch.zeros(S, KVH * G, hd), k, k, tables, lengths,
                      scale=0.5)
    paged_prefill_cuda(torch.zeros(S, C, KVH * G, hd), k, k, tables,
                       torch.zeros(S, dtype=torch.int32), lengths, scale=0.5)


@pytest.mark.parametrize("S,C", [(0, 4), (3, 0)])
def test_empty_paged_batch_counts_no_launch(card, S, C):
    if S == 0:
        _paged(S, C, 0, card)
        assert card.calls == []
    else:                              # decode launches; the empty chunk not
        _paged(S, C, 0, card)
        assert card.calls == ["paged_decode_launch"]
    counts = ops.launch_counts()
    assert counts["paged_decode"] == (S > 0)
    assert counts["paged_prefill"] == 0


def test_paged_counts_each_launch_and_no_failed_one(card):
    _paged(3, 4, 0, card)
    assert card.calls == ["paged_decode_launch", "paged_prefill_launch"]
    with pytest.raises(RuntimeError, match="paged decode attention"):
        _paged(3, 4, 700, card)        # cudaErrorIllegalAddress
    counts = ops.launch_counts()
    assert (counts["paged_decode"], counts["paged_prefill"]) == (1, 1)
    assert counts["plain_calls"] == 0


def _cascade(S, P, err, card):
    """One launch of each cascade kernel: the unique phase over (S, 2)
    tables, the shared-prefix phase over P prefix pages."""
    KVH, G, hd, bs = 2, 2, 8, 4
    k = torch.zeros(8, bs, KVH, hd)
    q = torch.zeros(S, KVH * G, hd)
    card.err = err
    lse = paged_decode_lse_cuda(q, k, k, torch.zeros(S, 2, dtype=torch.int32),
                                torch.ones(S, dtype=torch.int32), scale=0.5)
    pre = paged_prefix_cuda(q, k, k, torch.zeros(P, dtype=torch.int32),
                            torch.full((S,), 4, dtype=torch.int32),
                            scale=0.5)
    return lse, pre


@pytest.mark.parametrize("S,P", [(0, 2), (3, 0)])
def test_empty_cascade_problem_counts_no_launch(card, S, P):
    lse, (o, m, l) = _cascade(S, P, 0, card)
    # no prefix page: every row comes back as the empty state
    assert o.shape == (S, 4, 8) and m.shape == l.shape == (S, 4)
    assert torch.all(o == 0) and torch.all(m == NEG) and torch.all(l == 0)
    assert card.calls == (["paged_decode_lse_launch"] if S else [])
    counts = ops.launch_counts()
    assert counts["paged_decode_lse"] == (S > 0)
    assert counts["paged_prefix"] == 0


def test_cascade_counts_each_launch_and_no_failed_one(card):
    _cascade(3, 2, 0, card)
    assert card.calls == ["paged_decode_lse_launch", "paged_prefix_launch"]
    with pytest.raises(RuntimeError, match="paged decode-lse attention"):
        _cascade(3, 2, 700, card)      # cudaErrorIllegalAddress
    card.err = 9                       # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="shared-prefix attention"):
        paged_prefix_cuda(torch.zeros(3, 4, 8), torch.zeros(8, 4, 2, 8),
                          torch.zeros(8, 4, 2, 8),
                          torch.zeros(2, dtype=torch.int32),
                          torch.ones(3, dtype=torch.int32), scale=0.5)
    counts = ops.launch_counts()
    assert (counts["paged_decode_lse"], counts["paged_prefix"]) == (1, 1)
    assert counts["plain_calls"] == 0


def test_shared_attention_launches_both_phases_once(card):
    """On (posed) CUDA tensors ``ops.shared_paged_attention`` runs the two
    kernels and merges their states: no plain call, no plain decode."""
    k = torch.zeros(8, 4, 2, 8)
    out = ops.shared_paged_attention(
        torch.zeros(3, 4, 8), k, k, torch.zeros(3, 2, dtype=torch.int32),
        torch.ones(3, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
        torch.full((3,), 4, dtype=torch.int32))
    assert out.shape == (3, 4, 8) and out.dtype == torch.float32
    assert card.calls == ["paged_prefix_launch", "paged_decode_lse_launch"]
    counts = ops.launch_counts()
    assert (counts["paged_prefix"], counts["paged_decode_lse"],
            counts["paged_decode"], counts["plain_calls"]) == (1, 1, 0, 0)


def test_bank_gemm_counts_one_launch_per_bank(card):
    """A whole expert bank is ONE launch, counted under its (E, M, K, N,
    mode); an empty bank launches nothing; a failed one counts nothing."""
    a, b = torch.zeros(16, 8, 64), torch.zeros(16, 64, 32)
    out = rsa_gemm_cuda(a, b, block_k=64, mode=IS)
    assert out.shape == (16, 8, 32)
    assert card.calls == ["rsa_psum_launch"]
    assert ops.launch_counts()["rsa_gemm"] == 1
    assert rsa_gemm_cuda.launches_by_key == {(16, 8, 64, 32, IS): 1}
    # a head bank read as a strided view of one (r, H*d) weight
    w = torch.zeros(32, 4 * 64)
    rsa_gemm_cuda(torch.zeros(4, 8, 64), w.reshape(32, 4, 64).permute(1, 2, 0),
                  block_k=64, mode=OS)
    assert ops.launch_counts()["rsa_gemm"] == 2
    rsa_gemm_cuda(torch.zeros(0, 8, 64), torch.zeros(0, 64, 32), block_k=64,
                  mode=IS)
    card.err = 9
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        rsa_gemm_cuda(a, b, block_k=64, mode=IS)
    assert card.calls == ["rsa_psum_launch", "rsa_gemm_launch",
                          "rsa_psum_launch"]
    assert ops.launch_counts()["rsa_gemm"] == 2
    with pytest.raises(ValueError, match="shape mismatch"):
        rsa_gemm_cuda(a, torch.zeros(15, 64, 32), block_k=64, mode=IS)


def _mla(S, C, err, card, H=4):
    r, rd, bs, W = 16, 8, 4, 3
    ckv, kr = torch.zeros(S * W + 1, bs, r), torch.zeros(S * W + 1, bs, rd)
    tables = torch.zeros(S, W, dtype=torch.int32)
    lengths = torch.ones(S, dtype=torch.int32)
    card.err = err
    paged_mla_decode_cuda(torch.zeros(S, H, r), torch.zeros(S, H, rd), ckv,
                          kr, tables, lengths, scale=0.2)
    paged_mla_prefill_cuda(torch.zeros(S, C, H, r), torch.zeros(S, C, H, rd),
                           ckv, kr, tables, torch.zeros(S, dtype=torch.int32),
                           lengths, scale=0.2)


@pytest.mark.parametrize("S,C,H", [(0, 4, 4), (3, 0, 4), (3, 4, 0)])
def test_empty_mla_batch_counts_no_launch(card, S, C, H):
    _mla(S, C, 0, card, H=H)
    decode = S > 0 and H > 0            # the empty chunk launches nothing
    assert card.calls == (["paged_mla_decode_launch"] if decode else [])
    counts = ops.launch_counts()
    assert counts["paged_mla_decode"] == int(decode)
    assert counts["paged_mla_prefill"] == 0


def test_mla_counts_each_launch_and_no_failed_one(card):
    _mla(3, 4, 0, card)
    assert card.calls == ["paged_mla_decode_launch",
                          "paged_mla_prefill_launch"]
    with pytest.raises(RuntimeError, match="paged MLA decode attention"):
        _mla(3, 4, 1, card)            # cudaErrorInvalidValue
    counts = ops.launch_counts()
    assert (counts["paged_mla_decode"], counts["paged_mla_prefill"]) == (1, 1)
    assert counts["plain_calls"] == 0


def test_mla_kernels_refuse_what_they_do_not_take(card):
    S, H, bs = 2, 4, 4
    tables = torch.zeros(S, 2, dtype=torch.int32)
    lengths = torch.ones(S, dtype=torch.int32)
    with pytest.raises(ValueError, match="r <= 512"):
        paged_mla_decode_cuda(torch.zeros(S, H, 1024), torch.zeros(S, H, 8),
                              torch.zeros(5, bs, 1024), torch.zeros(5, bs, 8),
                              tables, lengths, scale=0.1)
    with pytest.raises(ValueError, match="int32"):
        paged_mla_decode_cuda(torch.zeros(S, H, 16), torch.zeros(S, H, 8),
                              torch.zeros(5, bs, 16), torch.zeros(5, bs, 8),
                              tables.long(), lengths, scale=0.1)
    with pytest.raises(ValueError, match="shape mismatch"):
        paged_mla_decode_cuda(torch.zeros(S, H, 16), torch.zeros(S, H, 4),
                              torch.zeros(5, bs, 16), torch.zeros(5, bs, 8),
                              tables, lengths, scale=0.1)
    assert card.calls == []
    assert ops.launch_counts()["paged_mla_decode"] == 0


def test_transposed_a_gemm_counts_one_launch(card):
    """The weight gradient's x^T (a column-major view) is read in place:
    one launch, counted under its shape; a layout with no unit stride
    raises before any launch."""
    x = torch.zeros(8, 64)
    out = rsa_gemm_cuda(x.t(), torch.zeros(8, 32), block_k=64, mode=OS)
    assert out.shape == (64, 32)
    assert card.calls == ["rsa_gemm_launch"]
    assert rsa_gemm_cuda.launches_by_key == {(64, 8, 32, OS): 1}
    with pytest.raises(ValueError, match="A must be row-major"):
        rsa_gemm_cuda(torch.zeros(8, 128)[:, ::2], torch.zeros(64, 32),
                      block_k=64, mode=OS)
    assert card.calls == ["rsa_gemm_launch"]


def _flash(B, Sq, Skv, err, card, G=2):
    """One launch of each flash kernel (forward, dq, dk/dv)."""
    KVH, hd = 2, 16
    q, do = torch.zeros(B, Sq, KVH * G, hd), torch.zeros(B, Sq, KVH * G, hd)
    k = torch.zeros(B, Skv, KVH, hd)
    lse = torch.zeros(B, KVH * G, Sq)
    card.err = err
    o, _ = flash_fwd_cuda(q, k, k, causal=True, scale=0.25)
    dq = flash_dq_cuda(q, k, k, do, lse, lse, causal=True, scale=0.25)
    dk, dv = flash_dkv_cuda(q, k, k, do, lse, lse, causal=True, scale=0.25)
    return o, dq, dk, dv


@pytest.mark.parametrize("B,Sq,Skv", [(0, 8, 8), (2, 0, 8)])
def test_empty_flash_problem_counts_no_launch(card, B, Sq, Skv):
    o, dq, dk, dv = _flash(B, Sq, Skv, 0, card)
    assert o.shape == (B, Sq, 4, 16) and dk.shape == (B, Skv, 2, 16)
    assert card.calls == []
    if B:                     # no query: every key's gradient is zero
        assert torch.all(dk == 0) and torch.all(dv == 0)
    counts = ops.launch_counts()
    assert counts["flash_fwd"] == counts["flash_dq"] == \
        counts["flash_dkv"] == 0


def test_flash_counts_each_launch_and_no_failed_one(card):
    _flash(2, 8, 8, 0, card)
    assert card.calls == ["flash_fwd_launch", "flash_dq_launch",
                          "flash_dkv_launch"]
    with pytest.raises(RuntimeError, match="flash attention forward"):
        _flash(2, 8, 8, 1, card)       # cudaErrorInvalidValue
    card.err = 700                     # cudaErrorIllegalAddress
    q, k = torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(RuntimeError, match="flash attention dq"):
        flash_dq_cuda(q, k, k, q, lse, lse, causal=False, scale=0.25)
    with pytest.raises(RuntimeError, match="flash attention dk/dv"):
        flash_dkv_cuda(q, k, k, q, lse, lse, causal=False, scale=0.25)
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_dq"],
            counts["flash_dkv"]) == (1, 1, 1)
    assert counts["plain_calls"] == 0


def test_flash_autograd_launches_each_kernel_once(card):
    """On (posed) CUDA tensors ``ops.flash_attention`` and its backward run
    the three kernels once each and no plain version."""
    q = torch.zeros(1, 8, 4, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16, requires_grad=True)
    v = torch.zeros(1, 8, 2, 16, requires_grad=True)
    ops.flash_attention(q, k, v, causal=True).sum().backward()
    assert card.calls == ["flash_fwd_launch", "flash_dq_launch",
                          "flash_dkv_launch"]
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_dq"], counts["flash_dkv"],
            counts["plain_calls"]) == (1, 1, 1, 0)


def test_flash_kernels_refuse_what_they_do_not_take(card):
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="hd, hd_v <= 128"):
        flash_fwd_cuda(torch.zeros(1, 8, 4, 256), torch.zeros(1, 8, 2, 256),
                       k, causal=True, scale=0.1)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_fwd_cuda(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16),
                       causal=True, scale=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_cuda(q.transpose(1, 2), k, k, causal=True, scale=0.1)
    with pytest.raises(ValueError, match="lse must be f32"):
        flash_dq_cuda(q, k, k, q, torch.zeros(1, 4, 7), torch.zeros(1, 4, 8),
                      causal=True, scale=0.1)
    assert card.calls == []


def _wkv(B, S, err, card, chunk=1):
    H, K, V = 2, 8, 4
    card.err = err
    r = torch.zeros(B, S, H, K)
    return wkv_bshk_cuda(r, r, torch.zeros(B, S, H, V), r, torch.zeros(H, K),
                         torch.ones(B, H, K, V), chunk=chunk)


@pytest.mark.parametrize("B,S", [(0, 4), (2, 0)])
def test_empty_wkv_problem_counts_no_launch(card, B, S):
    o, sf = _wkv(B, S, 0, card)
    assert o.shape == (B, S, 2, 4) and sf.shape == (B, 2, 8, 4)
    assert torch.all(sf == 1)          # no token: the state passes through
    la = linear_attn_cuda(torch.zeros(B, S, 8), torch.zeros(B, S, 8),
                          torch.zeros(B, S, 4), torch.zeros(B, S, 8),
                          torch.zeros(B, 8), chunk=1)
    assert la.shape == (B, S, 4)
    assert card.calls == []
    counts = ops.launch_counts()
    assert counts["wkv_bshk"] == counts["linear_attn"] == 0
    assert wkv_bshk_cuda.launches_by_chunk == {}


def test_wkv_counts_each_launch_and_no_failed_one(card):
    _wkv(2, 4, 0, card, chunk=2)
    _wkv(3, 1, 0, card)                # a decode step: chunk 1
    with pytest.raises(RuntimeError, match="WKV scan"):
        _wkv(2, 4, 700, card)          # cudaErrorIllegalAddress
    t = torch.zeros(3, 8, 8)
    card.err = 0
    linear_attn_cuda(t, t, torch.zeros(3, 8, 4), t, torch.zeros(3, 8),
                     chunk=4)
    card.err = 700
    with pytest.raises(RuntimeError, match="linear attention"):
        linear_attn_cuda(t, t, torch.zeros(3, 8, 4), t, torch.zeros(3, 8),
                         chunk=4)
    assert card.calls == ["wkv_bshk_launch"] * 3 + ["linear_attn_launch"] * 2
    counts = ops.launch_counts()
    assert (counts["wkv_bshk"], counts["linear_attn"],
            counts["plain_calls"]) == (2, 1, 0)
    assert wkv_bshk_cuda.launches_by_chunk == {2: 1, 1: 1}
    ops.reset_counts()
    assert wkv_bshk_cuda.launches_by_chunk == {}


def test_wkv_ops_pad_and_launch_once(card):
    """``ops.wkv_attention`` pads a ragged S to the chunk and launches the
    kernel once; ``ops.linear_attn`` likewise."""
    r = torch.zeros(1, 5, 2, 8)
    o, sf = ops.wkv_attention(r, r, torch.zeros(1, 5, 2, 4), r,
                              torch.zeros(2, 8), torch.zeros(1, 2, 8, 4),
                              chunk=4)
    assert o.shape == (1, 5, 2, 4)
    t = torch.zeros(2, 5, 8)
    assert ops.linear_attn(t, t, torch.zeros(2, 5, 4), t, torch.zeros(2, 8),
                           chunk=4).shape == (2, 5, 4)
    assert card.calls == ["wkv_bshk_launch", "linear_attn_launch"]
    counts = ops.launch_counts()
    assert (counts["wkv_bshk"], counts["linear_attn"],
            counts["plain_calls"]) == (1, 1, 0)


def test_wkv_kernels_refuse_what_they_do_not_take(card):
    r, v = torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 4)
    u, s0 = torch.zeros(2, 8), torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="chunk must be in"):
        wkv_bshk_cuda(r, r, v, r, u, s0, chunk=3)        # 4 % 3
    with pytest.raises(ValueError, match="chunk must be in"):
        wkv_bshk_cuda(torch.zeros(1, 128, 2, 8), torch.zeros(1, 128, 2, 8),
                      torch.zeros(1, 128, 2, 4), torch.zeros(1, 128, 2, 8),
                      u, s0, chunk=128)
    big = torch.zeros(1, 4, 2, 128)
    with pytest.raises(ValueError, match="K, V <= 64"):
        wkv_bshk_cuda(big, big, v, big, torch.zeros(2, 128),
                      torch.zeros(1, 2, 128, 4), chunk=4)
    with pytest.raises(ValueError, match="state0 must be float32"):
        wkv_bshk_cuda(r, r, v, r, u, s0.double(), chunk=4)
    with pytest.raises(ValueError, match="unsupported dtypes"):
        wkv_bshk_cuda(r, r.double(), v, r, u, s0, chunk=4)
    with pytest.raises(ValueError, match="do not match"):
        wkv_bshk_cuda(r, r, v, r, torch.zeros(3, 8), s0, chunk=4)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_bshk_cuda(r.transpose(1, 2), r, v, r, u, s0, chunk=4)
    assert card.calls == []


def _adaptnetx_params(C=135, E=16, H=128, rows=50):
    return {"emb_m": torch.zeros(rows, E), "emb_k": torch.zeros(rows, E),
            "emb_n": torch.zeros(rows, E), "w1": torch.zeros(3 * E, H),
            "b1": torch.zeros(H), "w2": torch.zeros(H, C),
            "b2": torch.zeros(C)}


def test_empty_adaptnetx_batch_counts_no_launch(card):
    out = ops.adaptnetx_recommend(torch.zeros(0, 3, dtype=torch.int32),
                                  _adaptnetx_params())
    assert out.shape == (0, 135)
    assert card.calls == []
    counts = ops.launch_counts()
    assert counts["adaptnetx"] == 0 and counts["plain_calls"] == 0


def test_adaptnetx_counts_each_launch_and_no_failed_one(card):
    p = _adaptnetx_params()
    one = ops.adaptnetx_recommend(torch.tensor([1, 2, 3]), p)
    many = ops.adaptnetx_recommend(torch.ones(64, 3, dtype=torch.int64), p)
    assert one.shape == (135,) and many.shape == (64, 135)
    assert card.calls == ["adaptnetx_launch"] * 2
    card.err = 9                       # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="ADAPTNETX"):
        ops.adaptnetx_recommend(torch.tensor([1, 2, 3]), p)
    counts = ops.launch_counts()
    assert counts["adaptnetx"] == 2 and counts["plain_calls"] == 0


def test_adaptnetx_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.adaptnetx import adaptnetx_cuda
    p = _adaptnetx_params()
    leaves = [p[k] for k in ("emb_m", "emb_k", "emb_n", "w1", "b1", "w2",
                             "b2")]
    ids = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        adaptnetx_cuda(ids.long(), *leaves)
    with pytest.raises(ValueError, match="f32"):
        adaptnetx_cuda(ids, *leaves[:3], leaves[3].double(), *leaves[4:])
    with pytest.raises(ValueError, match="shape mismatch"):
        adaptnetx_cuda(ids, *leaves[:3], torch.zeros(47, 128), *leaves[4:])
    with pytest.raises(ValueError, match=r"\(B, 3\)"):
        adaptnetx_cuda(torch.zeros(2, 4, dtype=torch.int32), *leaves)
    big = _adaptnetx_params(E=65)
    with pytest.raises(ValueError, match="E <= 64"):
        adaptnetx_cuda(ids, *(big[k] for k in ("emb_m", "emb_k", "emb_n",
                                                "w1", "b1", "w2", "b2")))
    with pytest.raises(ValueError, match="ids"):
        ops.adaptnetx_recommend(torch.zeros(2, 2, 3), p)
    assert card.calls == []
    assert ops.launch_counts()["adaptnetx"] == 0
