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
from repro_torch.kernels.paged_attn import (paged_decode_cuda,
                                            paged_prefill_cuda)
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
    assert card.calls == ["rsa_gemm_launch"] * 3
    assert ops.launch_counts()["rsa_gemm"] == 3
    assert rsa_gemm_cuda.launches_by_key == {(8, 64, 32, IS): 2,
                                             (8, 64, 32, OS): 1}


def test_failed_gemm_launch_raises_and_counts_nothing(card):
    card.err = 9                       # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        rsa_gemm_cuda(torch.zeros(8, 64), torch.zeros(64, 32), block_k=64,
                      mode=IS)
    assert card.calls == ["rsa_gemm_launch"]
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
