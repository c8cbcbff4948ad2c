"""The kernel functions count a launch only where the kernel was launched
and its launch returned no error: never on the early returns of an empty
problem, never on a failed launch.  No card is needed: CPU tensors pose as
CUDA ones and a stand-in library takes the launch calls, returning the
error code each test sets.  Nothing reads or writes the outputs' data.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from repro.core.sara import SaraDispatcher as JDispatcher
from repro.dispatch.executor import _clamped_blocks as j_clamped
from repro_torch import dispatch
from repro_torch.core.hw import IS, OS, WS
from repro_torch.core.sara import SaraDispatcher
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attn import (_dkv_ctas, _dkv_smem,
                                            _flash_plan, _fwd_ctas,
                                            _fwd_smem, _width,
                                            flash_dkv_cuda, flash_dq_cuda,
                                            flash_fwd_cuda)
from repro_torch.kernels.linear_attn import linear_attn_cuda, wkv_bshk_cuda
from repro_torch.kernels.paged_attn import (NEG, paged_decode_cuda,
                                            paged_decode_lse_cuda,
                                            paged_prefill_cuda,
                                            paged_prefix_cuda)
from repro_torch.kernels.paged_mla import (_mla_plan, paged_mla_decode_cuda,
                                           paged_mla_prefill_cuda)
from repro_torch.kernels.rsa_gemm import (_OS_WALK, RanPlan, _launch_plan,
                                          rsa_gemm_cuda)


class _Library:
    """Stands in for a built kernel library: records each launch call (its
    name in ``calls``, its arguments in ``args``) and returns ``err`` (0 =
    cudaSuccess)."""

    def __init__(self):
        self.calls = []
        self.args = []
        self.err = 0

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            self.args.append(args)
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
    # every mode launches the psum kernel's library (OS as one chunk)
    assert card.calls == ["rsa_psum_launch"] * 3
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


@pytest.mark.parametrize("E,M,K,N,dtype,a_t,b_t", [
    (1, 8, 2048, 512, torch.bfloat16, False, False),     # decode k/v: split
    (1, 2048, 8192, 2048, torch.float32, False, True),   # train dx (w^T)
    (1, 2048, 128256, 2048, torch.float32, False, False),  # unembed dx
    (128, 8, 128, 512, torch.bfloat16, False, False),    # an MLA head bank
    (1, 64, 8, 32, torch.float32, True, False),          # dw: x^T, K < 64
    (1, 37, 1000, 300, torch.bfloat16, False, True)])    # ragged, B^T
@pytest.mark.parametrize("block_k", [32, 256, 2048])
def test_os_launches_the_psum_kernel_as_one_chunk(card, E, M, K, N, dtype,
                                                   a_t, b_t, block_k):
    """OS is one ``rsa_psum_launch`` whose block_k covers K in a single
    chunk (K rounded up to 64, whatever the caller's block_k), walking the
    tiles in a WS (1) or IS (2) order; its splits, if any, are the pieces of
    that one chunk.  Counted once, under mode OS."""
    a = torch.zeros((K, M) if a_t else (M, K), dtype=dtype)
    a = a.t() if a_t else a
    b = torch.zeros((N, K) if b_t else (K, N), dtype=dtype)
    b = b.t() if b_t else b
    if E > 1:
        a, b = a.expand(E, M, K), b.expand(E, K, N)
    rsa_gemm_cuda(a, b, block_k=block_k, mode=OS)
    assert card.calls == ["rsa_psum_launch"]
    args = card.args[0]
    walk, k, bk, nsplit, pieces = (args[0], args[16], args[17], args[20],
                                   args[21])
    assert walk in (1, 2)
    assert k == K and bk >= K and bk % 64 == 0 and bk - K < 64
    assert -(-K // bk) == 1 and nsplit in (1, pieces)
    assert (args[23] is not None) == (nsplit > 1)     # the workspace
    assert ops.launch_counts()["rsa_gemm"] == 1
    key = ((E,) if E > 1 else ()) + (M, K, N, OS)
    assert rsa_gemm_cuda.launches_by_key == {key: 1}


# ---------------------------------------------------------------------------
# the site registry: the recommendation (the reference's executed tile)
# beside the plan the kernel ran, taken from the launch
# ---------------------------------------------------------------------------

def _ran_args(args):
    """The plan one ``rsa_psum_launch`` call's arguments carry."""
    return RanPlan(tile=args[18], swap=bool(args[19]), nsplit=args[20],
                   pieces=args[21], piece=args[22], walk=args[0],
                   block_k=args[17])


class _Forced:
    """The oracle's recommendation with the residency mode forced."""

    def __init__(self, mode):
        self.inner, self.mode = SaraDispatcher(), mode

    def recommend(self, m, k, n):
        return dataclasses.replace(self.inner.recommend(m, k, n),
                                   mode=self.mode)


@pytest.mark.parametrize("mode", [OS, WS, IS])
@pytest.mark.parametrize("M,K,N,dtype", [
    (8, 2048, 512, torch.bfloat16),      # decode k/v: swapped, split
    (512, 2048, 2048, torch.bfloat16),   # prefill q/o
    (40, 200, 72, torch.float32)])       # ragged, f32
def test_registry_records_the_plan_the_launch_ran(card, mode, M, K, N,
                                                  dtype):
    """A kernel site's record holds the plan of its ``rsa_psum_launch``,
    argument for argument (OS: block_k is K rounded up to 64 and the walk
    ``_OS_WALK``; WS / IS: the recommended block_k, walked in their own
    order), which is also ``_launch_plan``'s; beside it the recommendation
    stays the reference's clamped tile."""
    reg = dispatch.SiteRegistry()
    with dispatch.use(_Forced(mode), registry=reg):
        dispatch.gemm(torch.zeros(M, K, dtype=dtype),
                      torch.zeros(K, N, dtype=dtype), site="layer.attn.q")
    assert card.calls == ["rsa_psum_launch"]
    rec = reg.sites()["layer.attn.q"]
    ran = rec.ran_plan()
    assert ran == _ran_args(card.args[0]) and set(rec.ran) == {"fwd"}
    assert ran == _launch_plan(1, M, K, N, rec.block_k, mode, dtype, 132)[1]
    assert ran.walk == (_OS_WALK if mode == OS else mode)
    assert ran.block_k == (-(-K // 64) * 64 if mode == OS else rec.block_k)
    c = JDispatcher().recommend(M, K, N)
    assert rec.executed() == j_clamped(c, M, K, N) + (mode,)
    assert rec.backend == "kernel"
    assert rec.describe() == f"{rec.recommendation()} ran[{ran.describe()}]"
    assert reg.plan()["layer.attn.q"] == rec.describe()


def test_registry_records_a_bank_launch(card):
    """An expert bank's one launch is recorded in its site's record; the
    recommendation is at M = rows per bank GEMM."""
    reg = dispatch.SiteRegistry()
    with dispatch.use(_Forced(IS), registry=reg):
        dispatch.gemm(torch.zeros(2, 4, 3, 64), torch.zeros(4, 64, 32),
                      site="moe.expert.gate")
    assert card.calls == ["rsa_psum_launch"] and card.args[0][13] == 4
    rec = reg.sites()["moe.expert.gate"]
    assert (rec.m, rec.k, rec.n) == (6, 64, 32)
    assert rec.ran_plan() == _ran_args(card.args[0])
    c = JDispatcher().recommend(6, 64, 32)
    assert rec.executed() == j_clamped(c, 6, 64, 32) + (IS,)


@pytest.mark.parametrize("tied", [False, True])
def test_registry_records_the_backward_launches(card, tied):
    """A differentiable 2-D GEMM records its forward launch as "fwd" and
    its backward's two as "dx" (dy @ w^T: M x N x K) and "dw" (x^T @ dy: K
    x M x N), each with its own recommendation's block_k; the registry
    holds the forward site only."""
    M, K, N = 40, 200, 72
    x = torch.zeros(M, K, requires_grad=True)
    stored = torch.zeros((N, K) if tied else (K, N), requires_grad=True)
    w = stored.t() if tied else stored
    reg = dispatch.SiteRegistry()
    disp = SaraDispatcher()
    with dispatch.use(disp, registry=reg):
        y = dispatch.gemm(x, w, site="loss.unembed")
    y.sum().backward()
    assert card.calls == ["rsa_psum_launch"] * 3
    assert list(reg.sites()) == ["loss.unembed"]
    rec = reg.sites()["loss.unembed"]
    assert [rec.ran[r] for r in ("fwd", "dx", "dw")] == \
        [_ran_args(a) for a in card.args]
    for args, (m, k, n) in zip(card.args, ((M, K, N), (M, N, K),
                                           (K, M, N))):
        assert (args[14], args[16], args[15]) == (m, k, n)
        c = disp.recommend(m, k, n)
        bk = -(-k // 64) * 64 if c.mode == OS else \
            min(c.block_k, -(-k // 128) * 128)
        assert args[17] == bk


def test_torch_backend_records_no_ran_plan():
    """On the plain version nothing is launched: the record's ran plan is
    None and its description the recommendation alone."""
    reg = dispatch.SiteRegistry()
    with dispatch.use(SaraDispatcher(), registry=reg):
        dispatch.gemm(torch.zeros(6, 64), torch.zeros(64, 96), site="q")
    rec = reg.sites()["q"]
    assert rec.ran_plan() is None and rec.ran == {}
    assert rec.describe() == rec.recommendation()
    assert rec.describe().endswith("@torch")


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


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("S,W,split", [(1, 512, True), (8, 64, True),
                                       (64, 64, False), (3, 3, False)])
def test_decode_is_one_launch_whatever_the_plan(card, lse, S, W, split):
    """A decode call is ONE launch, split or not: the plan's rows, warps,
    splits and pages go to the kernel, a split plan with its workspace and
    tickets, an unsplit one with neither."""
    KVH, G, hd, bs = 8, 4, 64, 16
    k = torch.zeros(4, bs, KVH, hd, dtype=torch.bfloat16)
    q = torch.zeros(S, KVH * G, hd, dtype=torch.bfloat16)
    tables = torch.zeros(S, W, dtype=torch.int32)
    lengths = torch.full((S,), W * bs, dtype=torch.int32)
    fn = paged_decode_lse_cuda if lse else paged_decode_cuda
    fn(q, k, k, tables, lengths, scale=0.125)
    name = "paged_decode_lse_launch" if lse else "paged_decode_launch"
    assert card.calls == [name]
    args = card.args[0][2:] if lse else card.args[0]  # past m, l
    rows, warps, nsplit, pages, ws, tickets = args[17:23]
    assert (rows, warps) == (4, 4)
    assert (nsplit > 1) == split and nsplit * pages >= W
    assert (ws is not None) == split and (tickets is not None) == split
    counts = ops.launch_counts()
    assert counts["paged_decode_lse" if lse else "paged_decode"] == 1
    assert counts["plain_calls"] == 0


def test_decode_refuses_what_it_does_not_take(card):
    """hd_v past 256 raises before any launch, and counts nothing."""
    k = torch.zeros(4, 4, 2, 8)
    v = torch.zeros(4, 4, 2, 512)
    for fn in (paged_decode_cuda, paged_decode_lse_cuda):
        with pytest.raises(ValueError, match="hd_v <= 256"):
            fn(torch.zeros(3, 4, 8), k, v, torch.zeros(3, 2,
                                                       dtype=torch.int32),
               torch.ones(3, dtype=torch.int32), scale=0.5)
    assert card.calls == []
    counts = ops.launch_counts()
    assert counts["paged_decode"] == counts["paged_decode_lse"] == 0


@pytest.mark.parametrize("S,W,split", [(1, 28, True), (8, 32, True),
                                       (8, 4, False), (3, 3, False)])
def test_prefill_is_one_launch_whatever_the_plan(card, S, W, split):
    """A prefill call is ONE launch, split or not: the plan's width, splits
    and pages go to the kernel, a split plan with its workspace and
    tickets, an unsplit one with neither."""
    KVH, G, hd, bs, C = 8, 4, 64, 16, 64
    k = torch.zeros(4, bs, KVH, hd, dtype=torch.bfloat16)
    q = torch.zeros(S, C, KVH * G, hd, dtype=torch.bfloat16)
    paged_prefill_cuda(q, k, k, torch.zeros(S, W, dtype=torch.int32),
                       torch.zeros(S, dtype=torch.int32),
                       torch.full((S,), W * bs, dtype=torch.int32),
                       scale=0.125)
    assert card.calls == ["paged_prefill_launch"]
    width, nsplit, pages, ws, tickets = card.args[0][19:24]
    assert width == 64
    assert (nsplit > 1) == split and nsplit * pages >= W
    assert (ws is not None) == split and (tickets is not None) == split
    counts = ops.launch_counts()
    assert counts["paged_prefill"] == 1 and counts["plain_calls"] == 0


@pytest.mark.parametrize("S,G,P,hd,split", [(8, 4, 32, 64, True),
                                            (8, 8, 48, 128, True),
                                            (1, 4, 2, 256, False),
                                            (256, 4, 32, 64, False)])
def test_prefix_is_one_launch_whatever_the_plan(card, S, G, P, hd, split):
    """A shared-prefix call is ONE launch whatever its plan: the width
    rounded up from hd, a split plan (phase 5's: 8 kv heads, 32 rows, 32
    page columns) with its workspace and tickets."""
    KVH, bs = 8, 16
    k = torch.zeros(4, bs, KVH, hd, dtype=torch.bfloat16)
    paged_prefix_cuda(torch.zeros(S, KVH * G, hd, dtype=torch.bfloat16), k,
                      k, torch.zeros(P, dtype=torch.int32),
                      torch.full((S,), P * bs, dtype=torch.int32),
                      scale=0.125)
    assert card.calls == ["paged_prefix_launch"]
    width, nsplit, pages, ws, tickets = card.args[0][19:24]
    assert width == max(64, hd)
    assert (nsplit > 1) == split and nsplit * pages >= P
    assert (ws is not None) == split and (tickets is not None) == split
    counts = ops.launch_counts()
    assert counts["paged_prefix"] == 1 and counts["plain_calls"] == 0


def test_prefill_and_prefix_refuse_what_they_do_not_take(card):
    """hd or hd_v past 256 raises before any launch, and counts nothing;
    hd_v up to 256 launches."""
    k = torch.zeros(4, 4, 2, 8)
    tables = torch.zeros(3, 2, dtype=torch.int32)
    ones = torch.ones(3, dtype=torch.int32)
    for wide in (torch.zeros(4, 4, 2, 512), torch.zeros(4, 4, 2, 257)):
        with pytest.raises(ValueError, match="hd, hd_v <= 256"):
            paged_prefill_cuda(torch.zeros(3, 2, 4, 8), k, wide, tables,
                               ones, ones, scale=0.5)
        with pytest.raises(ValueError, match="hd, hd_v <= 256"):
            paged_prefix_cuda(torch.zeros(3, 4, 8), k, wide,
                              torch.zeros(2, dtype=torch.int32), ones,
                              scale=0.5)
    assert card.calls == []
    paged_prefix_cuda(torch.zeros(3, 4, 8), k, torch.zeros(4, 4, 2, 256),
                      torch.zeros(2, dtype=torch.int32), ones, scale=0.5)
    assert card.calls == ["paged_prefix_launch"]
    assert card.args[0][19] == 256
    counts = ops.launch_counts()
    assert counts["paged_prefill"] == 0 and counts["paged_prefix"] == 1


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
    assert card.calls == ["rsa_psum_launch"] * 3
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


@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("S,W,split", [(8, 35, True), (1, 256, True),
                                       (64, 35, False), (3, 3, False)])
def test_mla_is_one_launch_whatever_the_plan(card, prefill, S, W, split):
    """An MLA call is ONE launch, split or not: ``_mla_plan``'s rows, dv,
    splits and pages go to the kernel, a split plan with its workspace and
    tickets, an unsplit one with neither (phase 3's decode: 5 splits of 8
    pages; a prefill chunk of 64 rows x 128 heads is not split)."""
    H, r, rd, bs, C = 128, 512, 64, 16, 64
    bf = torch.bfloat16
    ckv, kr = torch.zeros(4, bs, r, dtype=bf), torch.zeros(4, bs, rd, dtype=bf)
    tables = torch.zeros(S, W, dtype=torch.int32)
    lengths = torch.full((S,), W * bs, dtype=torch.int32)
    lead = (S, C, H) if prefill else (S, H)
    qa, qr = torch.zeros(lead + (r,), dtype=bf), torch.zeros(lead + (rd,),
                                                              dtype=bf)
    if prefill:
        paged_mla_prefill_cuda(qa, qr, ckv, kr, tables,
                               torch.zeros(S, dtype=torch.int32), lengths,
                               scale=0.07)
        args = card.args[0][18:24]
    else:
        paged_mla_decode_cuda(qa, qr, ckv, kr, tables, lengths, scale=0.07)
        args = card.args[0][16:22]
    name = "paged_mla_prefill_launch" if prefill else \
        "paged_mla_decode_launch"
    assert card.calls == [name]
    rows, dv, nsplit, pages, ws, tickets = args
    plan = _mla_plan(S, (C if prefill else 1) * H, W, bs, r, rd, 2, 132)
    assert (rows, dv, nsplit, pages) == (plan.rows, plan.dv, plan.splits,
                                         plan.pages)
    assert (rows, dv) == (64, 512)
    split = split and not prefill
    assert (nsplit > 1) == split and nsplit * pages >= W
    assert (ws is not None) == split and (tickets is not None) == split
    counts = ops.launch_counts()
    assert counts["paged_mla_prefill" if prefill else
                  "paged_mla_decode"] == 1
    assert counts["plain_calls"] == 0


def test_mla_plan_override_reaches_the_launch(card):
    """A plan given by the caller (a forced split count) is what the launch
    gets, and each call counts once."""
    H, r, rd, bs, S, W = 128, 512, 64, 16, 8, 35
    bf = torch.bfloat16
    ckv, kr = torch.zeros(4, bs, r, dtype=bf), torch.zeros(4, bs, rd, dtype=bf)
    a = (torch.zeros(S, H, r, dtype=bf), torch.zeros(S, H, rd, dtype=bf), ckv,
         kr, torch.zeros(S, W, dtype=torch.int32),
         torch.full((S,), 545, dtype=torch.int32))
    for kw in ({"splits": 7}, {"splits": 1}, {"splits": 35}):
        plan = _mla_plan(S, H, W, bs, r, rd, 2, 132, **kw)
        paged_mla_decode_cuda(*a, scale=0.07, plan=plan)
        assert card.args[-1][16:20] == (plan.rows, plan.dv, plan.splits,
                                        plan.pages)
        assert (card.args[-1][20] is not None) == (plan.splits > 1)
    assert ops.launch_counts()["paged_mla_decode"] == 3


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
    with pytest.raises(ValueError, match="rd <= 64"):
        paged_mla_prefill_cuda(torch.zeros(S, 3, H, 16),
                               torch.zeros(S, 3, H, 80),
                               torch.zeros(5, bs, 16), torch.zeros(5, bs, 80),
                               tables, lengths, lengths, scale=0.1)
    assert card.calls == []
    counts = ops.launch_counts()
    assert counts["paged_mla_decode"] == counts["paged_mla_prefill"] == 0


def test_transposed_a_gemm_counts_one_launch(card):
    """The weight gradient's x^T (a column-major view) is read in place:
    one launch, counted under its shape; a layout with no unit stride
    raises before any launch."""
    x = torch.zeros(8, 64)
    out = rsa_gemm_cuda(x.t(), torch.zeros(8, 32), block_k=64, mode=OS)
    assert out.shape == (64, 32)
    assert card.calls == ["rsa_psum_launch"]
    assert rsa_gemm_cuda.launches_by_key == {(64, 8, 32, OS): 1}
    with pytest.raises(ValueError, match="A must be row-major"):
        rsa_gemm_cuda(torch.zeros(8, 128)[:, ::2], torch.zeros(64, 32),
                      block_k=64, mode=OS)
    assert card.calls == ["rsa_psum_launch"]


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


_FLASH_GRID = [
    # B, Sq, Skv, H, KVH, hd, hd_v, causal
    (2, 1024, 1024, 32, 8, 64, 64, True),      # phase 7
    (1, 1, 1, 4, 4, 64, 64, True),
    (1, 63, 200, 8, 1, 32, 48, True),
    (2, 129, 65, 24, 2, 100, 50, False),
    (1, 1000, 1000, 96, 8, 128, 128, True),    # G = 12
    (3, 65, 129, 32, 1, 128, 64, True),        # G = 32 (MQA)
    (1, 300, 100, 9, 1, 16, 16, False),        # G = 9: a ragged last rank
]


@pytest.mark.parametrize("case", _FLASH_GRID, ids=str)
def test_flash_plan_covers_every_tile_and_head_once(case):
    """The forward's CTAs cover every (query tile, head, batch) once, the
    heaviest causal tile of every head first; dk/dv's cover every (kv
    tile, kv head, batch) once with the ``parts`` CTAs of a group side by
    side, whose ranks walk the group's G query heads in g order, kv tile
    0 (the longest causal walk) first.  The forward's ring: one stage at
    W = 64 (three CTAs an SM), two at W = 128; dk/dv's: 128 kv rows a CTA
    and 2 stages where they fit; at most 8 partials a group."""
    B, Sq, Skv, H, KVH, hd, hd_v, causal = case
    G, W = H // KVH, _width(hd, hd_v)
    plan = _flash_plan(H, KVH, hd, hd_v)
    assert plan.fwd_stages == (1 if W == 64 else 2)
    assert 3 * (_fwd_smem(64, 1) + 1024) <= 233472 < \
        3 * (_fwd_smem(64, 2) + 1024)
    assert plan.dkv_rows == (128 if _dkv_smem(128, W, 2) <= 232448 else 64)
    assert plan.dkv_stages == (
        2 if _dkv_smem(plan.dkv_rows, W, 2) <= 232448 else 1)
    assert plan.heads == -(-G // 8) and plan.parts == -(-G // plan.heads)
    assert plan.parts <= 8
    ctas = _fwd_ctas(B, Sq, H)
    nqt = -(-Sq // 64)
    assert sorted(ctas) == [(t, h, b) for t in range(nqt)
                            for h in range(H) for b in range(B)]
    assert [t for t, _, _ in ctas] == sorted((t for t, _, _ in ctas),
                                             reverse=True)
    for heads in sorted({plan.heads, 1, 2, G} - {0}):
        if heads > G:
            continue
        for dkv_rows in (64, 128):
            cs = -(-G // heads)
            p = plan._replace(heads=heads, parts=cs, dkv_rows=dkv_rows)
            ctas = _dkv_ctas(p, B, Skv, KVH, G)
            nkt = -(-Skv // dkv_rows)
            assert len(ctas) == nkt * B * KVH * cs
            assert [j for j, _, _, _ in ctas] == sorted(
                j for j, _, _, _ in ctas)
            groups = []
            for i in range(0, len(ctas), cs):
                part = ctas[i:i + cs]
                assert len({(j, kvh, b) for j, kvh, b, _ in part}) == 1
                assert [g for _, _, _, gs in part for g in gs] == \
                    list(range(G))
                groups.append(part[0][:3])
            assert sorted(groups) == [(j, kvh, b) for j in range(nkt)
                                      for kvh in range(KVH)
                                      for b in range(B)]


def test_flash_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="hd, hd_v <= 128"):
        _flash_plan(4, 2, 256, 64)
    with pytest.raises(ValueError, match="64 or 128 kv rows"):
        _flash_plan(4, 2, 64, 64, dkv_rows=256)
    with pytest.raises(ValueError, match="ring stages do not fit"):
        _flash_plan(4, 2, 128, 128, fwd_stages=3)
    with pytest.raises(ValueError, match="ring stages do not fit"):
        _flash_plan(4, 2, 128, 128, dkv_rows=128, dkv_stages=1)
    with pytest.raises(ValueError, match="ring stages do not fit"):
        _flash_plan(4, 2, 64, 64, fwd_stages=4)
    with pytest.raises(ValueError, match="1 to G = 16 heads"):
        _flash_plan(32, 2, 64, 64, heads=17)
    assert _flash_plan(32, 1, 64, 64).parts == 8
    assert _flash_plan(32, 1, 64, 64, heads=32).parts == 1


@pytest.mark.parametrize("H,KVH,hd,stages,dkv_rows", [
    (32, 8, 64, 2, 128), (32, 8, 128, 1, 64), (96, 8, 64, 1, 64),
    (4, 4, 100, 2, 64), (16, 2, 32, 2, 128)])
def test_flash_launches_carry_the_plan(card, H, KVH, hd, stages, dkv_rows):
    """The forward's launch gets the plan's stages, dk/dv's its rows,
    stages, heads and parts, and (G > 1) an f32 scratch of parts x (hd +
    hd_v) floats a kv row and head for the group's partials; each call is
    one counted launch, the summing kernel included."""
    B, S, hd_v = 2, 70, 48
    plan = _flash_plan(H, KVH, hd, hd_v, fwd_stages=stages,
                       dkv_rows=dkv_rows, dkv_stages=stages)
    q, do = torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hd_v)
    k, v = torch.zeros(B, S, KVH, hd), torch.zeros(B, S, KVH, hd_v)
    lse = torch.zeros(B, H, S)
    flash_fwd_cuda(q, k, v, causal=True, scale=0.1, plan=plan)
    flash_dkv_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1, plan=plan)
    assert card.calls == ["flash_fwd_launch", "flash_dkv_launch"]
    assert card.args[0][15] == stages
    assert card.args[1][18:22] == (dkv_rows, plan.dkv_stages, plan.heads,
                                   plan.parts)
    assert (card.args[1][22] is not None) == (H > KVH)
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_dkv"],
            counts["plain_calls"]) == (1, 1, 0)


def test_flash_default_plan_reaches_the_launch(card):
    """Without a plan the wrappers launch under ``_flash_plan``'s: phase
    7's heads give the forward one ring stage (three CTAs an SM), dk/dv
    128 kv rows a CTA, 2 stages, one head a CTA, and groups of 4 partials
    in a scratch."""
    q, k = torch.zeros(2, 8, 32, 64), torch.zeros(2, 8, 8, 64)
    lse = torch.zeros(2, 32, 8)
    flash_fwd_cuda(q, k, k, causal=True, scale=0.125)
    flash_dkv_cuda(q, k, k, q, lse, lse, causal=True, scale=0.125)
    assert card.args[0][15] == 1
    assert card.args[1][18:22] == (128, 2, 1, 4) and card.args[1][22]


def test_flash_dkv_refuses_wide_heads_before_a_launch(card):
    """hd or hd_v past 128 raises before any launch of dk/dv or dq, and
    counts nothing."""
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 4, 8)
    for v in (torch.zeros(1, 8, 2, 160),):
        do = torch.zeros(1, 8, 4, 160)
        with pytest.raises(ValueError, match="hd, hd_v <= 128"):
            flash_dkv_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1)
        with pytest.raises(ValueError, match="hd, hd_v <= 128"):
            flash_dq_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1)
    assert card.calls == []
    counts = ops.launch_counts()
    assert counts["flash_dkv"] == counts["flash_dq"] == 0


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


def _c_params(source: str, fn: str):
    """The C parameter types of ``extern "C" int fn(...)`` in a source."""
    import re
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", source,
                  re.S)
    assert m, fn
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_declarations(lib):
    """Every bound launch function's argtypes follow its C declaration:
    one per parameter, a pointer for each pointer (ctypes would otherwise
    pass a Python int as a 32-bit int), a 64-bit int for each long long
    and a float for each float; every library has a source."""
    import ctypes
    source = (_build.CSRC / f"{lib}.cu").read_text()
    for fn, argtypes in _build.SIGNATURES[lib].items():
        params = _c_params(source, fn)
        assert len(params) == len(argtypes), fn
        for c, t in zip(params, argtypes):
            want = (ctypes.c_void_p if "*" in c else ctypes.c_longlong
                    if "long long" in c else ctypes.c_float if c == "float"
                    else ctypes.c_int)
            assert t is want, (fn, c, t)
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == \
        sorted(_build.SIGNATURES)
