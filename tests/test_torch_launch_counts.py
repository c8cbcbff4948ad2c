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
from repro_torch.kernels.flash_attn import (FlashPlan, _dkv_ctas,
                                            _dkv_smem, _dkv_tc_smem,
                                            _dq_smem, _dq_tc_smem,
                                            _flash_plan, _fwd_ctas,
                                            _half_cols,
                                            _fwd_smem, _fwd_tc_smem, _width,
                                            flash_dkv_cuda, flash_dq_cuda,
                                            flash_fwd_cuda)
from repro_torch.kernels.linear_attn import (_wkv_plan, linear_attn_cuda,
                                             wkv_bshk_cuda)
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
    with pytest.raises(ValueError, match="hd, hd_v <= 256"):
        flash_fwd_cuda(torch.zeros(1, 8, 4, 264), torch.zeros(1, 8, 2, 264),
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
    (2, 1024, 1024, 8, 1, 256, 256, True),     # gemma-2b: W = 256, 2 slices
    (1, 1024, 1024, 128, 128, 192, 128, True),  # MLA expanded: 192 / 128
    (1, 70, 90, 6, 2, 64, 200, False),         # hd_v > hd past 128
]


@pytest.mark.parametrize("case", _FLASH_GRID, ids=str)
def test_flash_plan_covers_every_tile_and_head_once(case):
    """The forward's CTAs cover every (query tile, head, batch) once, the
    heaviest causal tile of every head first; dk/dv's cover every (kv
    tile, kv head, batch) once with the ``parts`` CTAs of a group side by
    side, whose ranks walk the group's G query heads in g order, kv tile
    0 (the longest causal walk) first.  The forward's ring: one stage at
    W = 64 (three CTAs an SM), two at W = 128 and past it (the paired
    kernel, 128 query rows a CTA); dk/dv's: 128 kv rows a CTA and 2 stages
    where they fit; at most 8 partials a group."""
    B, Sq, Skv, H, KVH, hd, hd_v, causal = case
    G, W = H // KVH, _width(hd, hd_v)
    plan = _flash_plan(H, KVH, hd, hd_v)
    assert plan.fwd_stages == (1 if W == 64 else 2)
    assert plan.fwd_rows == (128 if W > 128 else 64)
    assert 3 * (_fwd_smem(64, 1) + 1024) <= 233472 < \
        3 * (_fwd_smem(64, 2) + 1024)
    assert plan.dkv_rows == (128 if _dkv_smem(128, W, 2) <= 232448 else 64)
    assert plan.dkv_stages == (
        2 if _dkv_smem(plan.dkv_rows, W, 2) <= 232448 else 1)
    assert plan.heads == -(-G // 8) and plan.parts == -(-G // plan.heads)
    assert plan.parts <= 8
    ctas = _fwd_ctas(B, Sq, H, plan.fwd_rows)
    nqt = -(-Sq // plan.fwd_rows)
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


@pytest.mark.parametrize("case", _FLASH_GRID, ids=str)
@pytest.mark.parametrize("rows", [64, 128])
def test_dq_ctas_cover_every_tile_and_head_once(case, rows):
    """dq's CTAs cover every (query tile, head, batch) once, the heaviest
    causal tile of every head first, and the heads of one kv group (and
    then the whole batch) side by side, so their K/V tiles meet in L2:
    ``_fwd_ctas`` at the plan's rows, as dq decodes ``blockIdx.x`` the
    way the forward does.  The plan: 128 query rows a CTA where they fit
    with the 2-stage ring (W = 64), else 64 (W = 128)."""
    B, Sq, Skv, H, KVH, hd, hd_v, causal = case
    G, W = H // KVH, _width(hd, hd_v)
    plan = _flash_plan(H, KVH, hd, hd_v)
    assert plan.dq_rows == (128 if W == 64 else 64)
    assert _dq_smem(128, 64) <= 232448 < _dq_smem(128, 128)
    assert _dq_smem(64, 256) <= 232448 < _dq_smem(128, 256)
    assert _dq_smem(64, 128) <= 232448
    ctas = _fwd_ctas(B, Sq, H, rows)
    nqt = -(-Sq // rows)
    assert len(ctas) == nqt * H * B
    assert sorted(ctas) == [(t, h, b) for t in range(nqt)
                            for h in range(H) for b in range(B)]
    assert [t for t, _, _ in ctas] == sorted((t for t, _, _ in ctas),
                                             reverse=True)
    assert ctas[0][0] == nqt - 1
    for i in range(0, len(ctas), H):     # one (tile, batch): heads 0..H-1
        part = ctas[i:i + H]
        assert [h for _, h, _ in part] == list(range(H))
        assert len({(t, b) for t, _, b in part}) == 1
        for g in range(KVH):             # a kv group: G adjacent CTAs
            assert {h // G for _, h, _ in part[g * G:(g + 1) * G]} == {g}


@pytest.mark.parametrize("hd,hd_v", [(256, 256), (192, 128), (192, 192),
                                     (160, 96), (64, 200), (129, 129)])
def test_wide_flash_plan_covers_every_column_slice_once(hd, hd_v):
    """Past W = 128 (hd or hd_v up to 256; 192 runs the 256-wide tiles)
    each f32 kernel runs a cluster of two CTAs (``slices`` = 2), each
    owning half of hd and of hd_v: every (query tile, head, batch) of the
    forward (128 rows) and dq (64 rows) and every (kv tile, kv head,
    batch) of dk/dv is a CTA once a half, and the halves cover each
    output's columns once.  The forward 2 ring stages, dq 64 rows and 2
    stages, dk/dv 64 kv rows a CTA and 2 stages of 32-query tiles; each
    CTA's shared bytes (the source's ``*_smem``) within the 227 KB of a
    CTA, at the bytes the source's header states."""
    H, KVH, B, S = 8, 2, 2, 300
    plan = _flash_plan(H, KVH, hd, hd_v)
    W = _width(hd, hd_v)
    assert W == 256
    assert plan.slices == -(-max(hd, hd_v) // 128) == 2
    assert (plan.fwd_stages, plan.fwd_rows, plan.dq_rows, plan.dq_stages,
            plan.dkv_rows, plan.dkv_stages) == (2, 128, 64, 2, 64, 2)
    assert (_fwd_smem(W, 2), _fwd_smem(W, 1), _dq_smem(64, W, 2),
            _dq_smem(64, W, 1), _dkv_smem(64, W, 2),
            _dkv_smem(64, W, 1)) == (188576, 154784, 211104, 177312,
                                     221728, 187680)
    assert max(_fwd_smem(W, 2), _dq_smem(64, W), _dkv_smem(64, W, 2)) <= \
        232448
    assert min(_dq_smem(128, W, 1), _dkv_smem(128, W, 1)) > 232448
    for d in (hd, hd_v):            # the halves of a pair
        h = _half_cols(d)
        assert h % 8 == 0 and h <= 128 and 0 <= d - h <= h
        cols = [c for sl in range(2) for c in range(sl * h,
                                                     min(d, (sl + 1) * h))]
        assert cols == list(range(d))
    for rows in (plan.fwd_rows, plan.dq_rows):   # forward, dq
        ctas = [(c, sl) for c in _fwd_ctas(B, S, H, rows)
                for sl in range(plan.slices)]
        assert len(set(ctas)) == len(ctas) == \
            -(-S // rows) * H * B * plan.slices
    dkv = [(c[:3], tuple(c[3]), sl)
           for c in _dkv_ctas(plan, B, S, KVH, H // KVH)
           for sl in range(plan.slices)]
    assert len(set(dkv)) == len(dkv) == \
        -(-S // 64) * KVH * B * plan.parts * plan.slices


@pytest.mark.parametrize("hd,hd_v", [(256, 256), (192, 128)])
def test_wide_flash_calls_are_one_launch_each(card, hd, hd_v):
    """A call at hd or hd_v past 128 launches each kernel once with the
    launch signature of every other width (the source derives the CTA
    pairs from hd and hd_v; the forward's 2 stages and 128 rows, dq's 64
    rows and 2 stages) and counts one launch; dk/dv's scratch holds parts
    x (hd + hd_v) floats a kv row and head."""
    B, S, H, KVH = 1, 70, 8, 1
    q, do = torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hd_v)
    k, v = torch.zeros(B, S, KVH, hd), torch.zeros(B, S, KVH, hd_v)
    lse = torch.zeros(B, H, S)
    flash_fwd_cuda(q, k, v, causal=True, scale=0.1)
    flash_dq_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1)
    flash_dkv_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1)
    assert card.calls == ["flash_fwd_launch", "flash_dq_launch",
                          "flash_dkv_launch"]
    plan = _flash_plan(H, KVH, hd, hd_v)
    assert card.args[0][11:13] == (hd, hd_v)
    assert card.args[0][15:17] == (2, 128)
    assert card.args[1][17:19] == (64, 2)
    assert card.args[2][18:22] == (64, 2, plan.heads, plan.parts)
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_dq"], counts["flash_dkv"],
            counts["plain_calls"]) == (1, 1, 1, 0)


# hd, hd_v of the paired f32 kernels: gemma-2b's, MLA's, ragged widths,
# one of them at or below 128, and tiny halves
_PAIR_WIDTHS = [(256, 256), (192, 128), (192, 192), (160, 96), (64, 200),
                (129, 129), (150, 130), (200, 200), (256, 8), (1, 129)]


def _quarter_groups(width: int):
    """(32-column accumulator groups, 16-column tails) a paired dq warp's
    quarter of ``width`` columns runs under, as the source's ``launch_dq``
    picks them."""
    return (1, 0) if width <= 32 else (1, 1) if width <= 48 else (2, 0)


@pytest.mark.parametrize("hd,hd_v", _PAIR_WIDTHS)
@pytest.mark.parametrize("B,S,H", [(2, 300, 8), (1, 1024, 128), (3, 65, 4)])
def test_wide_forward_and_dq_pairs_cover_every_unit_and_column_once(
        B, S, H, hd, hd_v):
    """Past W = 128 the forward's and dq's CTA pairs, as the kernels
    decode ``blockIdx``: every (query tile, head, batch) is one cluster
    (128 query rows a forward CTA, 64 a dq CTA), heaviest tile first, its
    two CTAs the halves of hd and hd_v.  The forward's CTA owns its half
    of o's columns (accumulator groups that reach past it), dq's warps
    the quarters of their CTA's half of dq's (groups and tails that reach
    past each), so the pair writes each column of o and dq once; the
    forward sums each score over the same quarters as dq (and dk/dv)."""
    plan = _flash_plan(H, H, hd, hd_v)
    assert plan.slices == 2
    for rows in (plan.fwd_rows, plan.dq_rows):
        units = _fwd_ctas(B, S, H, rows)
        nqt = -(-S // rows)
        assert sorted(units) == [(t, h, b) for t in range(nqt)
                                 for h in range(H) for b in range(B)]
        assert [t for t, _, _ in units] == sorted(
            (t for t, _, _ in units), reverse=True)
    hk, hv = _half_cols(hd), _half_cols(hd_v)
    o_cols, dq_cols = [], []
    for half in range(2):
        dvw = max(0, min(hv, hd_v - half * hv))
        assert 32 * (2 if hv <= 64 else 4) >= dvw    # the forward's NV
        o_cols += range(half * hv, half * hv + dvw)
        dkw = max(0, min(hk, hd - half * hk))
        fwd_quarters = [(0, min(hk // 2, dkw)),
                        (hk // 2, max(0, dkw - hk // 2))]
        for cg in range(2):                          # dq's column groups
            qk0 = cg * (hk // 2)
            dkq = max(0, min(hk // 2, dkw - qk0))
            assert fwd_quarters[cg] == (qk0, dkq)
            nk, nt = _quarter_groups(hk // 2)
            assert 32 * nk + 16 * nt >= dkq
            dq_cols += range(half * hk + qk0, half * hk + qk0 + dkq)
    assert o_cols == list(range(hd_v)) and dq_cols == list(range(hd))


def test_wide_pair_tiles_are_the_sources_bytes():
    """The paired kernels' shared bytes (``_fwd_smem``, ``_dq_smem``,
    ``_dkv_smem`` at W = 256) are the bytes the source's header states for
    a forward / dq / dk/dv CTA with 2 stages, each within the 227 KB of a
    CTA: four mbarriers and alignment slack, the resident rows' halves
    (132 floats a row), p or ds (40 floats a row), the exchanged scores
    and the 32-row tiles of the ring."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attn.cu").read_text()
    got = (_fwd_smem(256, 2), _dq_smem(64, 256, 2), _dkv_smem(64, 256, 2))
    assert got == (188576, 211104, 221728)
    assert max(got) <= 232448
    head = " ".join(line.lstrip("/ ") for line in src.splitlines()[:200])
    assert "188,576 / 211,104 / 221,728 bytes" in head
    assert _fwd_smem(256, 2) == 4 * (40 + 128 * 132 + 128 * 40 +
                                     2 * 32 * 128 + 2 * 2 * 32 * 132)
    assert _dq_smem(64, 256, 2) == 4 * (40 + 2 * 64 * 132 + 64 * 40 +
                                        2 * 128 * 64 + 2 * 2 * 32 * 132)


@pytest.mark.parametrize("hd,hd_v,kw,match", [
    (256, 256, dict(fwd_stages=3), "ring stages do not fit"),
    (256, 256, dict(fwd_rows=64), "holds 128 query rows"),
    (192, 128, dict(fwd_rows=256), "holds 128 query rows"),
    (256, 256, dict(dq_rows=128), "does not fit at width 256"),
    (192, 128, dict(dq_stages=3), "ring stages do not fit"),
    (256, 256, dict(dq_stages=0), "ring stages do not fit"),
    (192, 128, dict(dkv_rows=128), "ring stages do not fit"),
])
def test_wide_pair_plan_that_does_not_fit_is_refused_before_a_launch(
        card, hd, hd_v, kw, match):
    """A paired f32 plan past the kernels' tiles (128 dq rows: 354,464
    bytes; 3 or 0 ring stages; a forward CTA of other than 128 rows; 128
    dk/dv rows) raises while it is made, before any launch, and counts
    nothing."""
    B, S, H, KVH = 1, 40, 4, 2
    q, do = torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hd_v)
    k, v = torch.zeros(B, S, KVH, hd), torch.zeros(B, S, KVH, hd_v)
    lse = torch.zeros(B, H, S)
    with pytest.raises(ValueError, match=match):
        plan = _flash_plan(H, KVH, hd, hd_v, **kw)
        flash_fwd_cuda(q, k, v, causal=True, scale=0.1, plan=plan)
        flash_dq_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1,
                      plan=plan)
    assert card.calls == []
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_dq"], counts["flash_dkv"],
            counts["plain_calls"]) == (0, 0, 0, 0)


@pytest.mark.parametrize("stages", [1, 2])
def test_wide_pair_ring_stages_reach_the_launch(card, stages):
    """Either ring stage count of the paired forward and dq reaches their
    launches (the forward's with its 128 rows, dq's with its 64), one
    counted launch a call; up to W = 128 dq keeps its 2 stages."""
    B, S, H, KVH, hd, hd_v = 1, 70, 8, 1, 256, 256
    plan = _flash_plan(H, KVH, hd, hd_v, fwd_stages=stages,
                       dq_stages=stages)
    q, k = torch.zeros(B, S, H, hd), torch.zeros(B, S, KVH, hd)
    lse = torch.zeros(B, H, S)
    flash_fwd_cuda(q, k, k, causal=True, scale=0.1, plan=plan)
    flash_dq_cuda(q, k, k, q, lse, lse, causal=True, scale=0.1, plan=plan)
    assert card.calls == ["flash_fwd_launch", "flash_dq_launch"]
    assert card.args[0][15:17] == (stages, 128)
    assert card.args[1][17:19] == (64, stages)
    counts = ops.launch_counts()
    assert (counts["flash_fwd"], counts["flash_dq"],
            counts["plain_calls"]) == (1, 1, 0)
    with pytest.raises(ValueError, match="2 stages up to width 128"):
        _flash_plan(H, KVH, 128, 128, dq_stages=1)


def test_flash_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="hd, hd_v <= 256"):
        _flash_plan(4, 2, 320, 64)
    with pytest.raises(ValueError, match="hd, hd_v <= 256"):
        _flash_plan(4, 2, 64, 257)
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


@pytest.mark.parametrize("hd,kw,match", [
    (64, dict(dq_rows=32), "64 or 128 query rows"),
    (64, dict(dq_rows=256), "64 or 128 query rows"),
    (128, dict(dq_rows=96), "64 or 128 query rows"),
    (128, dict(dq_rows=128), "128 query rows does not fit at width 128"),
    (100, dict(dq_rows=128), "128 query rows does not fit at width 128"),
    (128, dict(dkv_rows=128), "ring stages do not fit"),
])
def test_flash_plan_refuses_dq_plans_the_kernel_does_not_take(hd, kw, match):
    """dq's rows are 64 or 128, within the 227 KB of a CTA with its
    2-stage ring: 128 rows do not fit at W = 128 (nor do 128 dk/dv rows
    with any ring)."""
    with pytest.raises(ValueError, match=match):
        _flash_plan(4, 2, hd, hd, **kw)


@pytest.mark.parametrize("hd,rows", [
    (64, 64), (64, 128), (128, 64), (100, 64), (32, 128), (50, 64),
    (16, 128)])
def test_flash_plan_takes_every_dq_plan_that_fits(hd, rows):
    """Every forced dq plan that fits is kept as given, and the forward's
    and dk/dv's fields stay the rule's."""
    W = _width(hd, hd)
    assert _dq_smem(rows, W) <= 232448
    p = _flash_plan(32, 8, hd, hd, dq_rows=rows)
    assert p.dq_rows == rows
    rule = _flash_plan(32, 8, hd, hd)
    assert p._replace(dq_rows=rule.dq_rows) == rule


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


@pytest.mark.parametrize("hd,rows", [
    (64, 64), (64, 128), (128, 64), (100, 64), (32, 128), (50, 64)])
def test_flash_dq_launch_carries_the_plan(card, hd, rows):
    """A forced dq plan reaches ``flash_dq_launch``'s rows, and each call
    is one counted launch."""
    B, S, H, KVH, hd_v = 2, 70, 8, 2, 48
    plan = _flash_plan(H, KVH, hd, hd_v, dq_rows=rows)
    q, do = torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hd_v)
    k, v = torch.zeros(B, S, KVH, hd), torch.zeros(B, S, KVH, hd_v)
    lse = torch.zeros(B, H, S)
    for n in (1, 2):
        flash_dq_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1,
                      plan=plan)
        assert card.calls == ["flash_dq_launch"] * n
        assert card.args[-1][8:18] == (B, S, S, H, KVH, hd, hd_v, 1,
                                       pytest.approx(0.1), rows)
        counts = ops.launch_counts()
        assert (counts["flash_dq"], counts["plain_calls"]) == (n, 0)


def test_flash_default_plan_reaches_the_launch(card):
    """Without a plan the wrappers launch under ``_flash_plan``'s: phase
    7's heads give the forward one ring stage (three CTAs an SM), dq 128
    query rows a CTA, dk/dv 128 kv rows a CTA, 2 stages, one
    head a CTA, and groups of 4 partials in a scratch."""
    q, k = torch.zeros(2, 8, 32, 64), torch.zeros(2, 8, 8, 64)
    lse = torch.zeros(2, 32, 8)
    flash_fwd_cuda(q, k, k, causal=True, scale=0.125)
    flash_dkv_cuda(q, k, k, q, lse, lse, causal=True, scale=0.125)
    flash_dq_cuda(q, k, k, q, lse, lse, causal=True, scale=0.125)
    assert card.args[0][15] == 1
    assert card.args[1][18:22] == (128, 2, 1, 4) and card.args[1][22]
    assert card.args[2][17:19] == (128, 2) and len(card.args[2]) == 20


# _FLASH_GRID's f32 plans as the rules gave them before bf16 had plans of
# its own: (fwd_stages, dkv_rows, dkv_stages, heads, parts, dq_rows, slices),
# but at W = 256, where all three run in CTA pairs: dk/dv's 2 ring stages,
# and the forward's 2 stages and (an eighth field) 128 rows a CTA
_F32_PLANS = {
    (32, 8, 64, 64): (1, 128, 2, 1, 4, 128, 1),
    (4, 4, 64, 64): (1, 128, 2, 1, 1, 128, 1),
    (8, 1, 32, 48): (1, 128, 2, 1, 8, 128, 1),
    (24, 2, 100, 50): (2, 64, 2, 2, 6, 64, 1),
    (96, 8, 128, 128): (2, 64, 2, 2, 6, 64, 1),
    (32, 1, 128, 64): (2, 64, 2, 4, 8, 64, 1),
    (9, 1, 16, 16): (1, 128, 2, 2, 5, 128, 1),
    (8, 1, 256, 256): (2, 64, 2, 1, 8, 64, 2, 128),
    (128, 128, 192, 128): (2, 64, 2, 1, 1, 64, 2, 128),
    (6, 2, 64, 200): (2, 64, 2, 1, 3, 64, 2, 128),
}


@pytest.mark.parametrize("case", _FLASH_GRID, ids=str)
def test_f32_flash_plans_are_the_rules_before_bf16_plans(case):
    """The f32 plan is the same with ``dtype`` given or not, and equals
    the plan the rules gave before bf16 had plans of its own (W = 256
    aside: 2 stages of the paired kernels, 128 rows a forward CTA); dq's
    ring 2 stages."""
    H, KVH, hd, hd_v = case[3:7]
    plan = _flash_plan(H, KVH, hd, hd_v, dtype=torch.float32)
    assert plan == _flash_plan(H, KVH, hd, hd_v) == \
        FlashPlan(*_F32_PLANS[(H, KVH, hd, hd_v)])
    assert plan.dq_stages == 2


def test_bf16_flash_tiles_are_the_sources_bytes():
    """The tensor-core kernels' shared bytes (bf16 rows of 2 W + 16
    bytes): the forward's 64 or 128 q rows and 2 K/V stages, dk/dv's K and
    V rows and q / do / lse / delta stages — what the source's
    ``fwd_tc_smem`` and ``dkv_tc_smem`` give.  Two forward stages fit at
    every width and row count; 128 dk/dv rows with 2 stages up to W = 128,
    only 64 rows (or one stage) at 256."""
    assert [_fwd_tc_smem(W, 2) for W in (64, 128, 256)] == \
        [46080, 87040, 168960]
    assert [_fwd_tc_smem(W, 2, rows=128) for W in (64, 128, 256)] == \
        [55296, 104448, 202752]
    assert [_dkv_tc_smem(128, W, 2) for W in (64, 128)] == [74752, 140288]
    assert (_dkv_tc_smem(64, 256, 2), _dkv_tc_smem(128, 256, 1)) == \
        (203776, 203264)
    assert _dkv_tc_smem(128, 256, 2) > 232448


@pytest.mark.parametrize("case", _FLASH_GRID + [
    (2, 300, 300, 8, 2, 256, 256, True),
    (1, 200, 130, 16, 16, 192, 128, False)], ids=str)
def test_bf16_flash_plan_fits_and_covers_every_tile_head_and_slice_once(
        case):
    """bf16's plan (the tensor-core forward, dq and dk/dv): every kernel's
    CTA within the 227 KB of a CTA; the forward's and dq's CTAs cover
    every (query tile, head, batch) once and own all of o's / dq's columns
    (no slices); dk/dv's cover every (kv tile, kv head, batch) once a
    128-column slice past W = 128, the ``parts`` CTAs of a group walking
    its G heads once in g order, and the slices cover dk's and dv's
    columns once.  The rules: forward CTAs of 128 query rows with 2
    stages; dq CTAs of 128 query rows with 2 stages where they fit, else 1
    (W = 256); dk/dv CTAs of 64 kv rows with 2 stages up to W = 128, 128
    rows with 1 stage at 256."""
    B, Sq, Skv, H, KVH, hd, hd_v, causal = case
    G, W = H // KVH, _width(hd, hd_v)
    plan = _flash_plan(H, KVH, hd, hd_v, dtype=torch.bfloat16)
    assert (plan.fwd_stages, plan.fwd_rows) == (2, 128)
    assert (plan.dq_rows, plan.dq_stages) == ((128, 2) if W <= 128
                                              else (128, 1))
    assert (plan.dkv_rows, plan.dkv_stages) == \
        ((64, 2) if W <= 128 else (128, 1))
    assert max(_fwd_tc_smem(W, plan.fwd_stages, rows=plan.fwd_rows),
               _dkv_tc_smem(plan.dkv_rows, W, plan.dkv_stages),
               _dq_tc_smem(plan.dq_rows, W, plan.dq_stages)) <= 232448
    assert sorted(_fwd_ctas(B, Sq, H, plan.dq_rows)) == [
        (t, h, b) for t in range(-(-Sq // plan.dq_rows)) for h in range(H)
        for b in range(B)]
    assert plan.slices == (-(-max(hd, hd_v) // 128) if W > 128 else 1)
    assert plan._replace(fwd_stages=1, dkv_rows=64, dkv_stages=1) == \
        _flash_plan(H, KVH, hd, hd_v, dtype=torch.bfloat16, fwd_stages=1,
                    dkv_rows=64, dkv_stages=1)
    nqt = -(-Sq // plan.fwd_rows)
    assert sorted(_fwd_ctas(B, Sq, H, plan.fwd_rows)) == [
        (t, h, b) for t in range(nqt) for h in range(H) for b in range(B)]
    nkt = -(-Skv // plan.dkv_rows)
    dkv = [(c[:3], tuple(c[3]), sl)
           for c in _dkv_ctas(plan, B, Skv, KVH, G)
           for sl in range(plan.slices)]
    assert len(set(dkv)) == len(dkv) == \
        nkt * KVH * B * plan.parts * plan.slices
    for sl in range(plan.slices):
        heads = {}
        for unit, gs, s in dkv:
            if s == sl:
                heads.setdefault(unit, []).extend(gs)
        assert sorted(heads) == [(j, kvh, b) for j in range(nkt)
                                 for kvh in range(KVH) for b in range(B)]
        assert all(g == list(range(G)) for g in heads.values())
    width = min(W, 128)
    for d in (hd, hd_v):
        cols = [c for sl in range(plan.slices)
                for c in range(sl * width, min(d, (sl + 1) * width))]
        assert cols == list(range(d))


@pytest.mark.parametrize("H,KVH,hd,hd_v", [
    (32, 8, 64, 64), (8, 1, 256, 256), (16, 16, 64, 64),
    (128, 128, 192, 128), (24, 2, 100, 50)])
def test_bf16_flash_plan_reaches_the_launch(card, H, KVH, hd, hd_v):
    """bf16 calls launch under the bf16 plan, not the f32 one: dtype code
    1, the forward's stages and rows, dq's rows and stages, dk/dv's rows,
    stages, heads and parts and (G > 1) its scratch; each call is one
    counted launch (the group sum included) and no plain call."""
    B, S, bf = 2, 70, torch.bfloat16
    plan = _flash_plan(H, KVH, hd, hd_v, dtype=bf, fwd_units=B * H * S,
                       num_sms=132)
    q, do = torch.zeros(B, S, H, hd, dtype=bf), torch.zeros(B, S, H, hd_v,
                                                            dtype=bf)
    k = torch.zeros(B, S, KVH, hd, dtype=bf)
    v = torch.zeros(B, S, KVH, hd_v, dtype=bf)
    lse = torch.zeros(B, H, S)
    for n in (1, 2):
        flash_fwd_cuda(q, k, v, causal=True, scale=0.1)
        flash_dq_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1)
        flash_dkv_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1)
        assert card.calls == ["flash_fwd_launch", "flash_dq_launch",
                              "flash_dkv_launch"] * n
        fwd, dq, dkv = card.args[-3:]
        assert fwd[0] == dq[0] == dkv[0] == 1
        assert fwd[15:17] == (plan.fwd_stages, plan.fwd_rows)
        assert dq[17:19] == (plan.dq_rows, plan.dq_stages)
        assert dkv[18:22] == (plan.dkv_rows, plan.dkv_stages, plan.heads,
                              plan.parts)
        assert (dkv[22] is not None) == (H > KVH)
        counts = ops.launch_counts()
        assert (counts["flash_fwd"], counts["flash_dq"], counts["flash_dkv"],
                counts["plain_calls"]) == (n, n, n, 0)


@pytest.mark.parametrize("hd,kw", [
    (256, dict(dkv_rows=128, dkv_stages=2)), (64, dict(fwd_stages=3)),
    (128, dict(dkv_stages=3)), (256, dict(dkv_rows=96)),
    (64, dict(fwd_rows=256)), (128, dict(fwd_rows=32))])
def test_bf16_flash_plan_that_does_not_fit_is_refused_before_a_launch(
        card, hd, kw):
    """A bf16 plan past the tensor-core kernels' tiles (128 dk/dv rows
    with 2 stages at W = 256: 271,360 bytes; 3 stages; rows not 64 or
    128) raises while it is made, before any launch."""
    q, k = (torch.zeros(1, 8, h, hd, dtype=torch.bfloat16) for h in (4, 2))
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="do not fit|64 or 128"):
        plan = _flash_plan(4, 2, hd, hd, dtype=torch.bfloat16, **kw)
        flash_fwd_cuda(q, k, k, causal=True, scale=0.1, plan=plan)
        flash_dkv_cuda(q, k, k, q, lse, lse, causal=True, scale=0.1,
                       plan=plan)
    assert card.calls == []
    counts = ops.launch_counts()
    assert counts["flash_fwd"] == counts["flash_dkv"] == 0


def test_bf16_dq_tiles_are_the_sources_bytes():
    """The tensor-core dq's shared bytes (bf16 rows of 2 W + 16 bytes): its
    64 or 128 q and do rows and 1 or 2 stages of K / V tiles — what the
    source's ``dq_tc_smem`` gives.  128 rows with 2 stages fit up to W =
    128; at W = 256 128 rows take 1 stage and 64 rows 2."""
    assert [_dq_tc_smem(r, W, st) for r in (64, 128) for W in (64, 128, 256)
            for st in (1, 2)] == [36864, 55296, 69632, 104448, 135168,
                                  202752, 55296, 73728, 104448, 139264,
                                  202752, 270336]
    assert _dq_tc_smem(128, 256, 2) > 232448 >= _dq_tc_smem(128, 256, 1)


_BF16_DQ_PLANS = [(r, st) for r in (64, 128) for st in (1, 2)]


@pytest.mark.parametrize("case", _FLASH_GRID, ids=str)
@pytest.mark.parametrize("rows,stages", _BF16_DQ_PLANS)
def test_bf16_dq_plans_fit_and_cover_every_tile_and_head_once(case, rows,
                                                              stages):
    """Every bf16 dq plan (64 or 128 query rows, 1 or 2 ring stages) that
    fits the 227 KB of a CTA is kept as given, with every other field the
    rule's, and its CTAs (``_fwd_ctas`` at its rows, one CTA owning all
    of dq's columns) cover every (query tile, head, batch) once, the
    heaviest causal tile first; a plan that does not fit raises."""
    B, Sq, Skv, H, KVH, hd, hd_v, causal = case
    W, bf = _width(hd, hd_v), torch.bfloat16
    if _dq_tc_smem(rows, W, stages) > 232448:
        with pytest.raises(ValueError, match="ring stages do not fit"):
            _flash_plan(H, KVH, hd, hd_v, dtype=bf, dq_rows=rows,
                        dq_stages=stages)
        return
    plan = _flash_plan(H, KVH, hd, hd_v, dtype=bf, dq_rows=rows,
                       dq_stages=stages)
    rule = _flash_plan(H, KVH, hd, hd_v, dtype=bf)
    assert (plan.dq_rows, plan.dq_stages) == (rows, stages)
    assert plan._replace(dq_rows=rule.dq_rows,
                         dq_stages=rule.dq_stages) == rule
    ctas = _fwd_ctas(B, Sq, H, rows)
    nqt = -(-Sq // rows)
    assert sorted(ctas) == [(t, h, b) for t in range(nqt) for h in range(H)
                            for b in range(B)]
    assert [t for t, _, _ in ctas] == sorted((t for t, _, _ in ctas),
                                             reverse=True)


def test_bf16_dq_rows_follow_the_call_size():
    """The bf16 dq takes the forward's rows (128 where the call has at
    least one 128-row CTA an SM, else 64: seamless's encoder and
    gemma-2b's 8 heads of 1024 take 64) and 2 ring stages where they fit:
    every such plan at hd 256 too (64 rows); f32 dq plans ignore the call
    size and keep their 2 stages."""
    bf = torch.bfloat16

    def dq(H, KVH, hd, units):
        p = _flash_plan(H, KVH, hd, hd, dtype=bf, fwd_units=units)
        return p.dq_rows, p.dq_stages
    assert dq(32, 8, 64, 2 * 32 * 1024) == (128, 2)
    assert dq(16, 16, 64, 16 * 128) == (64, 2)
    assert dq(8, 1, 256, 2 * 8 * 1024) == (64, 2)
    assert dq(4, 4, 256, 132 * 128) == (128, 1)
    assert _flash_plan(8, 1, 256, 256, fwd_units=1).dq_stages == 2
    with pytest.raises(ValueError, match="f32 dq ring has 2 stages"):
        _flash_plan(4, 2, 64, 64, dq_stages=1)


@pytest.mark.parametrize("hd,hd_v", [(64, 64), (128, 128), (256, 256),
                                     (192, 128), (100, 50)])
@pytest.mark.parametrize("rows,stages", _BF16_DQ_PLANS)
def test_bf16_dq_plan_reaches_the_launch(card, hd, hd_v, rows, stages):
    """A bf16 dq plan that fits reaches ``flash_dq_launch``'s rows and
    stages (dtype code 1), each call one counted launch and no plain call;
    one that does not fit raises before any launch and counts nothing."""
    B, S, H, KVH, bf = 2, 70, 8, 2, torch.bfloat16
    q, do = torch.zeros(B, S, H, hd, dtype=bf), torch.zeros(B, S, H, hd_v,
                                                            dtype=bf)
    k = torch.zeros(B, S, KVH, hd, dtype=bf)
    v = torch.zeros(B, S, KVH, hd_v, dtype=bf)
    lse = torch.zeros(B, H, S)
    if _dq_tc_smem(rows, _width(hd, hd_v), stages) > 232448:
        with pytest.raises(ValueError, match="do not fit"):
            plan = _flash_plan(H, KVH, hd, hd_v, dtype=bf, dq_rows=rows,
                               dq_stages=stages)
            flash_dq_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1,
                          plan=plan)
        assert card.calls == [] and ops.launch_counts()["flash_dq"] == 0
        return
    plan = _flash_plan(H, KVH, hd, hd_v, dtype=bf, dq_rows=rows,
                       dq_stages=stages)
    for n in (1, 2):
        flash_dq_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1,
                      plan=plan)
        assert card.calls == ["flash_dq_launch"] * n
        args = card.args[-1]
        assert args[0] == 1 and len(args) == 20
        assert args[8:19] == (B, S, S, H, KVH, hd, hd_v, 1,
                              pytest.approx(0.1), rows, stages)
        counts = ops.launch_counts()
        assert (counts["flash_dq"], counts["plain_calls"]) == (n, 0)


@pytest.mark.parametrize("hd,kw", [
    (256, dict(dq_rows=128, dq_stages=2)), (64, dict(dq_stages=3)),
    (128, dict(dq_rows=96)), (64, dict(dq_rows=256)),
    (256, dict(dq_stages=0))])
def test_bf16_dq_plan_that_does_not_fit_is_refused_before_a_launch(
        card, hd, kw):
    """A bf16 dq plan past the tensor-core dq's tiles (128 rows with 2
    stages at W = 256: 270,336 bytes; 3 or 0 stages; rows not 64 or 128)
    raises while it is made, before any launch."""
    bf = torch.bfloat16
    q, k = (torch.zeros(1, 8, h, hd, dtype=bf) for h in (4, 2))
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="do not fit|64 or 128"):
        plan = _flash_plan(4, 2, hd, hd, dtype=bf, **kw)
        flash_dq_cuda(q, k, k, q, lse, lse, causal=True, scale=0.1,
                      plan=plan)
    assert card.calls == []
    assert ops.launch_counts()["flash_dq"] == 0


def test_bf16_forward_rows_follow_the_call_size():
    """The bf16 forward takes 128-row CTAs where the call has at least one
    such CTA an SM, else 64-row CTAs: phase 7's llama attention and S =
    512 run the first, seamless's encoder (16 heads of 128 rows) and
    gemma-2b's 8 heads of 1024 (128 CTAs) the second.  Without a call
    size the rule takes 128; f32 plans ignore the call size."""
    bf = torch.bfloat16

    def rows(H, KVH, hd, units, **kw):
        return _flash_plan(H, KVH, hd, hd, dtype=bf, fwd_units=units,
                           **kw).fwd_rows
    assert rows(32, 8, 64, 2 * 32 * 1024) == rows(32, 8, 64,
                                                  2 * 32 * 512) == 128
    assert rows(16, 16, 64, 16 * 128) == rows(8, 1, 256, 2 * 8 * 1024) == 64
    edge = 132 * 128
    assert rows(4, 4, 128, edge - 1) == 64
    assert rows(4, 4, 128, edge) == 128
    assert rows(4, 4, 128, edge, num_sms=133) == 64
    assert _flash_plan(4, 4, 128, 128, dtype=bf).fwd_rows == 128
    assert _flash_plan(4, 4, 128, 128, fwd_units=1) == \
        _flash_plan(4, 4, 128, 128)


def test_f32_flash_forward_takes_no_bf16_rows():
    """The f32 forward's CTAs hold 64 query rows: a plan asking for 128
    raises."""
    with pytest.raises(ValueError, match="f32 forward CTA holds 64"):
        _flash_plan(4, 2, 64, 64, fwd_rows=128)


def test_flash_dkv_refuses_wide_heads_before_a_launch(card):
    """hd or hd_v past 256 raises before any launch of dk/dv or dq, and
    counts nothing."""
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 4, 8)
    for v in (torch.zeros(1, 8, 2, 288),):
        do = torch.zeros(1, 8, 4, 288)
        with pytest.raises(ValueError, match="hd, hd_v <= 256"):
            flash_dkv_cuda(q, k, v, do, lse, lse, causal=True, scale=0.1)
        with pytest.raises(ValueError, match="hd, hd_v <= 256"):
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


WKV_GRID = [(B, S, H, K, V, chunk)
            for B, H in ((1, 32), (8, 32), (2, 3), (64, 1), (1, 1))
            for S, chunk in ((1, 1), (5, 1), (64, 64), (128, 64), (512, 64),
                             (1024, 64), (96, 24), (120, 40), (96, 16))
            for K, V in ((64, 64), (8, 24), (16, 16), (5, 7))]


def _covered(plan, B, S, H, V, chunk):
    """How many times each (b, h, chunk, state column) is in a CTA of the
    plan's widest kernel (the decode kernel, or the inter kernel: one CTA
    per (b, h, chunk, V tile), a tile of vt columns from tile * vt)."""
    n = S // chunk
    seen = {}
    for bc in range(B * H * n):
        for tile in range(plan.vsplit):
            for col in range(tile * plan.vt, min(V, (tile + 1) * plan.vt)):
                seen[(bc, col)] = seen.get((bc, col), 0) + 1
    return seen


@pytest.mark.parametrize("B,S,H,K,V,chunk", WKV_GRID)
def test_wkv_plan_on_a_grid(B, S, H, K, V, chunk):
    """Chunk 1 plans the decode kernel (32 columns a CTA), a longer chunk
    the chunked variant; every (b, h, chunk) and every state column in one
    CTA exactly once; V whole, or halved where the B * H * n CTAs of whole
    tiles fill at most half the 132 SMs; the chain folded while n <= 5; the
    workspace exactly o_intra, r_hat, dS, the decays and (launched chain)
    every h_{c-1}."""
    plan = _wkv_plan(B, S, H, K, V, chunk, 132)
    n = S // chunk
    assert plan.n == n
    seen = _covered(plan, B, S, H, V, chunk)
    assert len(seen) == B * H * n * V and set(seen.values()) == {1}
    assert plan.vsplit == -(-V // plan.vt)
    if chunk == 1:
        assert plan.variant == "decode" and plan.ws_elems == 0
        assert plan.vt == 32 and plan.ctas == B * H * plan.vsplit
        return
    V4 = -(-V // 4) * 4
    assert plan.variant == "chunked"
    split = V4 % 8 == 0 and 2 * B * H * n <= 132
    assert plan.vt == (V4 // 2 if split else V4)
    assert plan.ctas == B * H * n * plan.vsplit
    assert plan.chain == ("fold" if n <= 5 else "launch")
    bhn = B * H * n
    assert plan.ws_elems == B * S * H * V + bhn * (chunk * K + K * V + K) + \
        (bhn * K * V if plan.chain == "launch" else 0)


def test_wkv_plan_refuses_what_the_kernel_does_not_take():
    """K, V or the chunk past 64, a chunk that does not divide S, a decode
    plan at a chunk > 1 or of another tile, an unknown chain, a V tile off
    the grid of 4."""
    for args in ((1, 64, 2, 65, 64, 64), (1, 64, 2, 64, 65, 64),
                 (1, 128, 2, 64, 64, 128), (1, 100, 2, 64, 64, 64)):
        with pytest.raises(ValueError):
            _wkv_plan(*args)
    with pytest.raises(ValueError, match="chunk 1 alone"):
        _wkv_plan(1, 64, 2, 64, 64, 64, variant="decode")
    with pytest.raises(ValueError, match="folded or launched"):
        _wkv_plan(1, 64, 2, 64, 64, 64, chain="ring")
    with pytest.raises(ValueError, match="multiple of 4"):
        _wkv_plan(1, 64, 2, 64, 64, 64, vt=18)
    with pytest.raises(ValueError, match="32 columns a CTA"):
        _wkv_plan(8, 1, 2, 64, 64, 1, vt=64)


def _wkv_args(B, S, H, K, V):
    r = torch.zeros(B, S, H, K)
    return (r, r, torch.zeros(B, S, H, V), r, torch.zeros(H, K),
            torch.zeros(B, H, K, V))


def _launch_plan_args(args):
    """(variant, chain, vt, workspace given) of a recorded launch."""
    return args[-5:-2] + (args[-2] is not None,)


@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (1, 512, 32, 64, 64, 64), (8, 1, 32, 64, 64, 1), (1, 64, 32, 64, 64, 64),
    (2, 5, 4, 16, 16, 1), (1, 1024, 32, 64, 64, 64)])
def test_wkv_plan_reaches_the_launch(card, B, S, H, K, V, chunk):
    """Without a plan the wrapper launches under ``_wkv_plan``'s; a forced
    plan reaches the launch's arguments as given; every plan counts one
    launch a call, however many kernels it runs."""
    args = _wkv_args(B, S, H, K, V)
    plan = _wkv_plan(B, S, H, K, V, chunk, 132)
    wkv_bshk_cuda(*args, chunk=chunk)
    forced = [_wkv_plan(B, S, H, K, V, chunk, 132, variant="chunked",
                        chain=c, vt=vt)
              for c in ("fold", "launch") for vt in (16, V)]
    if chunk == 1:
        forced += [_wkv_plan(B, S, H, K, V, 1, 132, variant="decode")]
    for p in forced:
        wkv_bshk_cuda(*args, chunk=chunk, plan=p)
    assert card.calls == ["wkv_bshk_launch"] * (1 + len(forced))
    for got, p in zip(card.args, [plan] + forced):
        assert _launch_plan_args(got) == (
            int(p.variant == "decode"), int(p.chain == "launch"), p.vt,
            p.ws_elems > 0)
        assert got[9:15] == (B, S, H, K, V, chunk)
    counts = ops.launch_counts()
    assert counts["wkv_bshk"] == 1 + len(forced)
    assert wkv_bshk_cuda.launches_by_chunk == {chunk: 1 + len(forced)}


def test_linear_attn_plan_reaches_the_launch(card):
    """``linear_attn_cuda`` plans with H = 1 over its BH rows: sixteen
    chunks launch the chain; a forced plan reaches the launch; one count a
    call."""
    t = torch.zeros(64, 1024, 64)
    linear_attn_cuda(t, t, t, t, torch.zeros(64, 64), chunk=64)
    p = _wkv_plan(64, 1024, 1, 64, 64, 64, 132, chain="fold", vt=32)
    linear_attn_cuda(t, t, t, t, torch.zeros(64, 64), chunk=64, plan=p)
    assert card.calls == ["linear_attn_launch"] * 2
    assert _launch_plan_args(card.args[0]) == (0, 1, 64, True)
    assert _launch_plan_args(card.args[1]) == (0, 0, 32, True)
    assert card.args[0][7:12] == (64, 1024, 64, 64, 64)
    assert ops.launch_counts()["linear_attn"] == 2


def test_wkv_plan_of_another_shape_is_refused_before_a_launch(card):
    """A plan made for another chunk count, other heads or widths (whose
    workspace would not fit), or a decode plan at a chunk > 1, raises
    before any launch and counts nothing."""
    args = _wkv_args(1, 128, 2, 16, 16)
    for other in (_wkv_plan(1, 64, 2, 16, 16, 64, 132),
                  _wkv_plan(1, 128, 4, 16, 16, 64, 132),
                  _wkv_plan(1, 128, 2, 32, 16, 64, 132),
                  _wkv_plan(1, 128, 2, 16, 16, 1, 132)):
        with pytest.raises(ValueError, match="not one for"):
            wkv_bshk_cuda(*args, chunk=64, plan=other)
    assert card.calls == [] and ops.launch_counts()["wkv_bshk"] == 0


def test_wkv_kernels_refuse_wide_or_long_chunks_before_a_launch(card):
    """K, V or the chunk past 64 raise before any launch of either entry
    point, and count nothing."""
    for K, V, chunk in ((65, 8, 4), (8, 65, 4), (8, 8, 65)):
        S = 2 * chunk
        with pytest.raises(ValueError, match="K, V <= 64|chunk must be in"):
            wkv_bshk_cuda(*_wkv_args(1, S, 2, K, V), chunk=chunk)
        t = torch.zeros(2, S, K)
        with pytest.raises(ValueError, match="K, V <= 64|chunk must be in"):
            linear_attn_cuda(t, t, torch.zeros(2, S, V), t,
                             torch.zeros(2, K), chunk=chunk)
    assert card.calls == []
    counts = ops.launch_counts()
    assert counts["wkv_bshk"] == counts["linear_attn"] == 0


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


def _adaptnetx_plans(B, E, H, C):
    """The plan and every forced variant the shape takes."""
    from repro_torch.kernels.adaptnetx import VARIANTS, _adaptnetx_plan
    plans = [_adaptnetx_plan(B, E, H, C)]
    for _, kw in VARIANTS:
        try:
            plans.append(_adaptnetx_plan(B, E, H, C, **kw))
        except ValueError:
            pass
    return plans


@pytest.mark.parametrize("B", [1, 33, 64])
@pytest.mark.parametrize("E", [1, 16, 64])
@pytest.mark.parametrize("H", [1, 31, 128, 130, 1024])
@pytest.mark.parametrize("C", [1, 3, 75, 135, 300, 2000])
def test_adaptnetx_plan_on_a_grid(B, E, H, C):
    """Under the plan and every forced variant the shape takes, through a
    model of the kernel's index arithmetic (``csrc/adaptnetx.cu``: CTA x =
    tile * groups + g holds chunks g * chunks on, nk of them; entry e = q *
    nc + c of a tile is summed by CTA e // per, which expects 4 * nchunk *
    (hi - lo) bytes; chunk kk's partial lands at kk * step + q * ct + c):
    every (query, hidden chunk, class) is computed once; each summing CTA
    receives the partials it waits for, one into each slot, and its sum,
    reading slot k * step + off for ascending k, meets chunk k at step k;
    a CTA's shared memory is the kernel's layout and fits 227 KB; a
    cluster is at most 8 CTAs (portable)."""
    import numpy as np
    from repro_torch.kernels.adaptnetx import (MAX_CLUSTER, SMEM_MAX,
                                               _adaptnetx_smem)
    nchunk = -(-H // 32)
    for plan in _adaptnetx_plans(B, E, H, C):
        qt, ct, groups = plan.qt, plan.ct, plan.groups
        nqs = [min(qt, B - t * qt) for t in range(plan.tiles)]
        ncs = [min(ct, C - t * ct) for t in range(plan.ctiles)]
        assert min(nqs) >= 1 and sum(nqs) == B
        assert min(ncs) >= 1 and sum(ncs) == C
        assert plan.ctas == groups * plan.tiles * plan.ctiles
        assert 1 <= groups <= MAX_CLUSTER
        assert plan.combine == ("none" if groups == 1 else "cluster")
        seen = {}
        for x in range(groups * plan.tiles):
            g, tile = x % groups, x // groups
            nk = min(plan.chunks, nchunk - g * plan.chunks)
            assert nk >= 1
            for ctile in range(plan.ctiles):
                for k in range(g * plan.chunks, g * plan.chunks + nk):
                    key = (tile, ctile, k)
                    seen[key] = seen.get(key, 0) + 1
        assert seen == {(t, c, k): 1 for t in range(plan.tiles)
                        for c in range(plan.ctiles) for k in range(nchunk)}
        step = qt * ct
        for nq in set(nqs):
            for nc in set(ncs):
                e = np.arange(nq * nc)
                per = -(-(nq * nc) // groups)
                owner = e // per
                assert owner.max() < groups
                for r in range(groups):
                    lo = min(nq * nc, r * per)
                    hi = min(nq * nc, lo + per)
                    # every chunk's CTA stores each entry once: the
                    # stores into r are the bytes its mbarrier expects
                    assert nchunk * int((owner == r).sum()) == \
                        nchunk * (hi - lo)
                    assert np.array_equal(e[owner == r], np.arange(lo, hi))
                off = (e // nc) * ct + e % nc
                assert len(np.unique(off)) == len(off) and off.max() < step
        assert 1 <= plan.stages <= plan.chunks
        assert plan.smem == _adaptnetx_smem(E, H, qt, ct,
                                            plan.stages) <= SMEM_MAX


def test_adaptnetx_plan_rule():
    """The rule's choices at path A's widths: one query over a cluster of
    4 CTAs, one 32-unit chunk each, every weight byte in flight at once;
    a batch of 64 in tiles of 4; more than 8 chunks in a cluster of 8,
    several chunks a CTA, with the ring cut to fit; classes past 256 in
    tiles of 256."""
    from repro_torch.kernels.adaptnetx import _adaptnetx_plan
    p = _adaptnetx_plan(1, 16, 128, 135)
    assert (p.qt, p.ct, p.groups, p.chunks, p.combine, p.stages, p.ctas) \
        == (1, 135, 4, 1, "cluster", 1, 4)
    p = _adaptnetx_plan(64, 16, 128, 135)
    assert (p.qt, p.tiles, p.groups, p.ctas) == (4, 16, 4, 64)
    p = _adaptnetx_plan(64, 64, 1024, 2000)
    assert (p.groups, p.chunks, p.combine, p.ct, p.ctiles) == \
        (8, 4, "cluster", 256, 8)
    assert p.stages < p.chunks
    p = _adaptnetx_plan(1, 64, 1024, 3)
    assert (p.groups, p.chunks, p.combine, p.stages, p.ctas) == \
        (8, 4, "cluster", 4, 8)
    p = _adaptnetx_plan(33, 64, 1024, 3)
    assert (p.groups, p.chunks, p.combine, p.tiles) == (8, 4, "cluster", 9)
    p = _adaptnetx_plan(1, 16, 288, 3)
    assert (p.groups, p.chunks) == (5, 2)
    assert _adaptnetx_plan(5, 1, 1, 1).combine == "none"


@pytest.mark.parametrize("B,E,H,C", [(1, 16, 128, 135), (64, 16, 128, 135),
                                     (33, 64, 1024, 3), (33, 5, 130, 7)])
def test_adaptnetx_plan_reaches_the_launch(card, B, E, H, C):
    """Without a plan the wrapper launches under ``_adaptnetx_plan``'s; a
    forced plan reaches ``adaptnetx_launch``'s arguments (query and class
    tiles, CTAs a tile, chunks a CTA, stages); one count a call."""
    from repro_torch.kernels.adaptnetx import (OPERANDS, _adaptnetx_plan,
                                               adaptnetx_cuda)
    p = _adaptnetx_params(C=C, E=E, H=H)
    t = [p[k] for k in OPERANDS]
    ids = torch.zeros(B, 3, dtype=torch.int32)
    plans = _adaptnetx_plans(B, E, H, C)
    adaptnetx_cuda(ids, *t)
    for plan in plans:
        adaptnetx_cuda(ids, *t, plan=plan)
    assert card.calls == ["adaptnetx_launch"] * (len(plans) + 1)
    assert ops.launch_counts()["adaptnetx"] == len(plans) + 1
    for plan, args in zip([_adaptnetx_plan(B, E, H, C)] + plans, card.args):
        assert args[15] == B
        assert args[16:21] == (plan.qt, plan.ct, plan.groups, plan.chunks,
                               plan.stages)
    assert any(pl.combine == "cluster" for pl in plans) == (H > 32)


def test_adaptnetx_unfit_plan_is_refused_before_a_launch(card):
    """A plan of another shape, one edited past its own rule and forced
    choices the shape cannot take raise before any launch."""
    from repro_torch.kernels.adaptnetx import (OPERANDS, _adaptnetx_plan,
                                               adaptnetx_cuda)
    p = _adaptnetx_params()
    t = [p[k] for k in OPERANDS]
    ids = torch.zeros(2, 3, dtype=torch.int32)
    plan = _adaptnetx_plan(2, 16, 128, 135)
    for other in (_adaptnetx_plan(2, 16, 128, 75),
                  _adaptnetx_plan(3, 16, 128, 135),
                  _adaptnetx_plan(2, 16, 256, 135),
                  plan._replace(stages=2), plan._replace(groups=2),
                  plan._replace(chunks=2), plan._replace(tiles=2),
                  plan._replace(smem=plan.smem - 4)):
        with pytest.raises(ValueError, match="is not one for"):
            adaptnetx_cuda(ids, *t, plan=other)
    for kw in ({"chunks": 0}, {"chunks": 5}, {"qt": 3}, {"ct": 101},
               {"ct": 0}, {"stages": 2}, {"chunks": 2, "stages": 3}):
        with pytest.raises(ValueError):
            _adaptnetx_plan(2, 16, 128, 135, **kw)
    with pytest.raises(ValueError, match="cluster of up to 8"):
        _adaptnetx_plan(2, 16, 1024, 135, chunks=3)
    with pytest.raises(ValueError, match="shared memory"):
        _adaptnetx_plan(64, 64, 1024, 2000, qt=64, chunks=32)
    with pytest.raises(ValueError, match="E <= 64"):
        _adaptnetx_plan(1, 65, 128, 135)
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
