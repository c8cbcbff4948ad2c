"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (marked ``cuda``: each test skips where there is no CUDA device;
there is no interpret mode for a CUDA kernel).  Run on a machine with the
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 kernels sum in another order than the plain versions
(bounded by K * 2^-24 * max(|a| @ |b|) for the GEMM, 1e-5 for attention);
bf16 outputs add one bf16 rounding (2^-8 relative) per block_k chunk of
the GEMM, and the attention kernels round p to bf16 before p @ V.  The
cascade kernels' f32 softmax states (m, l) differ from the plain versions'
by summation order only (1e-4 relative), and their empty rows (a lane of
length 0, a lane outside the sharing group) are exactly (0, -1e30, 0).
OS runs on the WS/IS kernel as one chunk over K: one bf16 rounding, and
two runs bitwise equal (its split-K fix-up is ordered).  The split-KV
decode kernel is held to the attention tolerances at every split count,
and to itself run to run, bitwise.
The bank GEMM is held to the 2-D GEMM's bound and, member by member, to
the 2-D kernel bitwise; the WS/IS kernel's two modes, and two runs of it,
are held to each other bitwise (one kernel computes both); the MLA kernels to the attention tolerances.  The
flash kernels are held to the reference's own tolerances for its kernel
(``tests/test_flash_attn.py``): 2e-6 f32 and 2e-2 bf16 on the forward,
3e-5 absolute + 1e-3 relative on the gradients.  The WKV and linear
attention kernels sum their f32 dot products in another order than the
plain versions: 1e-5 of the output's largest magnitude (at least 1e-5),
plus one bf16 rounding (2^-8 of it) for bf16 outputs.  ADAPTNETX is
held to the reference's rtol = atol = 1e-5 (f32 sums of 48 and 128 terms
in another order).
"""

import math

import pytest
import torch

from repro_torch import dispatch
from repro_torch.core.hw import IS, OS, WS
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attn import (NEG, paged_attention_lse_plain,
                                            paged_attention_plain,
                                            paged_decode_cuda,
                                            paged_decode_lse_cuda,
                                            paged_prefill_attention_plain,
                                            paged_prefill_cuda,
                                            paged_prefix_cuda,
                                            shared_prefix_attention_plain)
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


def _cascade(gen, dtype):
    """Full width: 8 lanes, 8 kv heads, G = 4, hd = 64, pages of 16; a
    24-page shared prefix padded to 32 with the last id; lane 6 is outside
    the group, lane 5 takes only 20 pages of the run; unique lengths are
    ragged and include 0."""
    S, KVH, G, hd, bs, P = 8, 8, 4, 64, 16, 24
    prefix_lens = [P * bs] * 8
    prefix_lens[5], prefix_lens[6] = 20 * bs, 0
    ulens = [0, 1, 15, 16, 17, 100, 128, 129]
    uw = max(-(-n // bs) for n in ulens)
    nxt, utables, full = P, [], []
    for s in range(S):
        n = -(-ulens[s] // bs)
        own = list(range(nxt, nxt + n))
        nxt += n
        row = own or [0]
        utables.append(row + [row[-1]] * (uw - len(row)))
        full.append(list(range(prefix_lens[s] // bs)) + own)
    W = max(len(r) for r in full)
    full = [(r or [0]) + [(r or [0])[-1]] * (W - len(r or [0])) for r in full]
    i32 = dict(dtype=torch.int32, device="cuda")
    k = torch.randn((nxt + 1, bs, KVH, hd), generator=gen,
                    device="cuda").to(dtype)
    return dict(
        q=torch.randn((S, KVH * G, hd), generator=gen,
                      device="cuda").to(dtype),
        k=k, v=torch.randn_like(k),
        prefix_pages=torch.tensor(list(range(P)) + [P - 1] * 8, **i32),
        prefix_lens=torch.tensor(prefix_lens, **i32),
        utables=torch.tensor(utables, **i32),
        ulens=torch.tensor(ulens, **i32),
        full=torch.tensor(full, **i32),
        lens=torch.tensor([a + b for a, b in zip(prefix_lens, ulens)],
                          **i32))


def _states_close(got, want, tol):
    (go, gm, gl), (wo, wm, wl) = got, want
    assert (go.float() - wo.float()).abs().max().item() <= tol
    assert ((gm - wm).abs() <= 1e-4 * (1 + wm.abs())).all()
    assert ((gl - wl).abs() <= 1e-4 * (1 + wl)).all()


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
def test_cascade_kernels_match_plain(cuda, dtype, tol, cap):
    x = _cascade(cuda, dtype)
    scale = 64 ** -0.5
    a = (x["q"], x["k"], x["v"])
    got = paged_prefix_cuda(*a, x["prefix_pages"], x["prefix_lens"],
                            scale=scale, logit_cap=cap)
    want = shared_prefix_attention_plain(*a, x["prefix_pages"],
                                         x["prefix_lens"], scale=scale,
                                         logit_cap=cap)
    _states_close(got, want, tol)
    # the lane outside the group: exactly the empty state
    assert (got[0][6] == 0).all() and (got[1][6] == NEG).all() and \
        (got[2][6] == 0).all()
    got = paged_decode_lse_cuda(*a, x["utables"], x["ulens"], scale=scale,
                                logit_cap=cap)
    want = paged_attention_lse_plain(*a, x["utables"], x["ulens"],
                                     scale=scale, logit_cap=cap)
    _states_close(got, want, tol)
    # the lane of unique length 0: exactly the empty state
    assert (got[0][0] == 0).all() and (got[1][0] == NEG).all() and \
        (got[2][0] == 0).all()
    # the two phases merged equal one paged decode over the full tables
    n0 = ops.launch_counts()
    with dispatch.use(execute="kernel"):
        cascade = ops.shared_paged_attention(
            *a, x["utables"], x["ulens"], x["prefix_pages"],
            x["prefix_lens"], logit_cap=cap)
        whole = ops.paged_attention(*a, x["full"], x["lens"], logit_cap=cap)
    n1 = ops.launch_counts()
    assert (n1["paged_prefix"] - n0["paged_prefix"],
            n1["paged_decode_lse"] - n0["paged_decode_lse"]) == (1, 1)
    assert n1["plain_calls"] == n0["plain_calls"]
    assert cascade.dtype == dtype
    assert (cascade.float() - whole.float()).abs().max().item() <= tol


@pytest.mark.parametrize("mode", [OS, WS, IS])
@pytest.mark.parametrize("dtype,out", [(torch.float32, torch.float32),
                                       (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("bank", ["experts", "head views"])
def test_bank_gemm_kernel_matches_plain(cuda, mode, dtype, out, bank):
    """One launch for a whole bank, each member bitwise the 2-D kernel; the
    head bank is a strided view of one (N, E*K) weight (as the MLA banks
    view W_UK), read in place."""
    E, M, K, N, bk = 5, 40, 300, 96, 128
    a = torch.randn((E, M, K), generator=cuda, device="cuda").to(dtype)
    if bank == "experts":
        b = torch.randn((E, K, N), generator=cuda, device="cuda").to(dtype)
    else:                                   # W_UK (N, E*K) as (E, K, N)
        w = torch.randn((N, E * K), generator=cuda, device="cuda").to(dtype)
        b = w.reshape(N, E, K).permute(1, 2, 0)
    n0 = ops.launch_counts()["rsa_gemm"]
    got = ops.rsa_gemm(a, b, block_k=bk, mode=mode, out_dtype=out)
    assert ops.launch_counts()["rsa_gemm"] == n0 + 1
    want = rsa_gemm_plain(a, b, block_k=bk, mode=mode, out_dtype=out)
    for e in range(E):                      # the bank is E 2-D products
        one = ops.rsa_gemm(a[e], b[e], block_k=bk, mode=mode, out_dtype=out)
        assert torch.equal(one, got[e])
    tol = K * 2.0 ** -24 * torch.bmm(a.abs().float(),
                                     b.abs().float()).max().item()
    if out == torch.bfloat16:
        chunks = 1 if mode == OS else math.ceil(K / bk)
        tol += (chunks + 1) * 2.0 ** -8 * want.abs().max().item()
    assert got.shape == (E, M, N)
    assert (got.float() - want.float()).abs().max().item() <= tol


def _mla_inputs(gen, dtype, lengths, H, r, rd, bs):
    S = len(lengths)
    W = max(1, max(-(-n // bs) for n in lengths))
    tables = torch.zeros((S, W), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nb = -(-n // bs)
        if nb:
            tables[i, :nb] = torch.arange(nxt, nxt + nb)
            tables[i, nb:] = nxt + nb - 1
            nxt += nb
    ckv = torch.randn((nxt + 1, bs, r), generator=gen, device="cuda")
    kr = torch.randn((nxt + 1, bs, rd), generator=gen, device="cuda")
    return ckv.to(dtype), kr.to(dtype), tables.cuda(), \
        torch.tensor(lengths, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("bs", [4, 16, 64])
@pytest.mark.parametrize("r,rd", [(16, 8), (512, 64)])
@pytest.mark.parametrize("H", [4, 16, 128])
def test_mla_kernels_match_plain(cuda, dtype, tol, H, r, rd, bs):
    """Both MLA kernels against their plain versions: ragged lengths with a
    length-0 lane and a page boundary, ragged prefill starts with an empty
    lane; the full-width latent (512 + 64) and the reduced one, 4 to 128
    heads (a 64-row CTA spanning chunk rows, or heads of one), at pages
    of 4 (the CPU tests'), 16 (the paths') and 64."""
    from repro_torch.kernels.paged_mla import (
        paged_mla_attention_plain, paged_mla_prefill_attention_plain)
    qk = 192
    scale = 1.0 / math.sqrt(qk)
    lengths = [0, 1, 16, 17, 70]
    ckv, kr, tables, lens = _mla_inputs(cuda, dtype, lengths, H, r, rd, bs)
    S = len(lengths)
    qa = torch.randn((S, H, r), generator=cuda, device="cuda").to(dtype)
    qr = torch.randn((S, H, rd), generator=cuda, device="cuda").to(dtype)
    with dispatch.use(execute="kernel"):
        got = ops.mla_paged_attention(qa, qr, ckv, kr, tables, lens,
                                      qk_dim=qk)
    want = paged_mla_attention_plain(qa, qr, ckv, kr, tables, lens,
                                     scale=scale)
    assert (got[0] == 0).all()
    assert (got.float() - want.float()).abs().max().item() <= tol

    C = 8
    starts = [0, 5, 16, 0, 60]
    chunks = [8, 7, 3, 0, 8]
    ckv, kr, tables, lens = _mla_inputs(
        cuda, dtype, [s + c for s, c in zip(starts, chunks)], H, r, rd, bs)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    qa = torch.randn((S, C, H, r), generator=cuda, device="cuda").to(dtype)
    qr = torch.randn((S, C, H, rd), generator=cuda, device="cuda").to(dtype)
    with dispatch.use(execute="kernel"):
        got = ops.mla_paged_prefill_attention(qa, qr, ckv, kr, tables, st,
                                              lens, qk_dim=qk)
    want = paged_mla_prefill_attention_plain(qa, qr, ckv, kr, tables, st,
                                             lens, scale=scale)
    live = torch.arange(C, device="cuda")[None, :] < \
        torch.tensor(chunks, device="cuda")[:, None]
    assert (got[3] == 0).all()
    assert (got.float() - want.float()).abs()[live].max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("r,rd", [(16, 8), (512, 64)])
@pytest.mark.parametrize("H", [4, 128])
def test_mla_prefill_chunks_off_page_boundaries(cuda, dtype, tol, H, r, rd):
    """Prefill chunks of 0, 1, 10, 37 and 64 rows at starts off the page
    boundaries (pages of 16), C = 64: at H = 4 a 64-row CTA spans 16 chunk
    rows and masks each row at its own limit, at H = 128 it holds 64 heads
    of one chunk row and masks only its last tile.  Every row of the chunk
    is compared, those past a lane's length too (they attend to every live
    column, as the reference's); the empty lane is exactly zero."""
    from repro_torch.kernels.paged_mla import (
        paged_mla_prefill_attention_plain, paged_mla_prefill_cuda)
    starts, chunks, C = PREFILL_STARTS, PREFILL_CHUNKS, 64
    ckv, kr, tables, lens = _mla_inputs(
        cuda, dtype, [s + c for s, c in zip(starts, chunks)], H, r, rd, 16)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    S = len(starts)
    qa = torch.randn((S, C, H, r), generator=cuda, device="cuda").to(dtype)
    qr = torch.randn((S, C, H, rd), generator=cuda, device="cuda").to(dtype)
    got = paged_mla_prefill_cuda(qa, qr, ckv, kr, tables, st, lens,
                                 scale=0.07)
    want = paged_mla_prefill_attention_plain(qa, qr, ckv, kr, tables, st,
                                             lens, scale=0.07)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, paged_mla_prefill_cuda(qa, qr, ckv, kr, tables,
                                                   st, lens, scale=0.07))


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16, 64, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 4e-2),
                                       (torch.float32, 1e-5)])
def test_mla_split_decode_any_split_count_is_right_and_bitwise(
        cuda, dtype, tol, splits):
    """Forced split counts from 1 to a split a page column (256 pages of
    16: lengths up to 4096, one lane inside the first split, a lane of
    length 0): each within the tolerance, bitwise equal run to run (the
    merge is ordered), one launch a call, the tickets left zero and the
    empty lane exactly zero."""
    from repro_torch.kernels.paged_mla import (_TICKETS, _mla_plan,
                                               paged_mla_attention_plain,
                                               paged_mla_decode_cuda)
    H, r, rd, bs = 128, 512, 64, 16
    lengths = [3, 1, 16, 17, 545, 2000, 0, 4096]
    ckv, kr, tables, lens = _mla_inputs(cuda, dtype, lengths, H, r, rd, bs)
    S = len(lengths)
    qa = torch.randn((S, H, r), generator=cuda, device="cuda").to(dtype)
    qr = torch.randn((S, H, rd), generator=cuda, device="cuda").to(dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = _mla_plan(S, H, tables.shape[1], bs, r, rd, qa.element_size(),
                     sms, splits=splits)
    assert plan.splits == splits
    a = (qa, qr, ckv, kr, tables, lens)
    n0 = ops.launch_counts()["paged_mla_decode"]
    got = paged_mla_decode_cuda(*a, scale=0.07, plan=plan)
    again = paged_mla_decode_cuda(*a, scale=0.07, plan=plan)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_mla_decode"] == n0 + 2
    assert torch.equal(got, again)
    assert (got[6] == 0).all()
    want = paged_mla_attention_plain(*a, scale=0.07)
    assert (got.float() - want.float()).abs().max().item() <= tol
    if splits > 1:
        assert not _TICKETS[qa.device].any()


def test_mla_kernels_refuse_before_or_at_launch(cuda):
    """Widths past the kernel's (r > 512, rd > 64) raise before any launch;
    a plan the kernel does not take (another accumulator width, or rows a
    CTA its type does not run) is refused at launch and raises; neither is
    counted."""
    from repro_torch.kernels.paged_mla import (_mla_plan,
                                               paged_mla_decode_cuda,
                                               paged_mla_prefill_cuda)
    n0 = ops.launch_counts()
    ckv, kr, tables, lens = _mla_inputs(cuda, torch.bfloat16, [5, 40], 4,
                                        16, 8, 16)
    qa = torch.randn((2, 4, 16), generator=cuda, device="cuda") \
        .to(torch.bfloat16)
    qr = torch.randn((2, 4, 8), generator=cuda, device="cuda") \
        .to(torch.bfloat16)
    wide = torch.zeros((2, 4, 600), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="r <= 512"):
        paged_mla_decode_cuda(wide, qr, torch.zeros(
            ckv.shape[:2] + (600,), dtype=torch.bfloat16, device="cuda"), kr,
            tables, lens, scale=0.1)
    with pytest.raises(ValueError, match="rd <= 64"):
        paged_mla_prefill_cuda(
            qa[:, None], torch.zeros((2, 1, 4, 72), dtype=torch.bfloat16,
                                     device="cuda"), ckv,
            torch.zeros(ckv.shape[:2] + (72,), dtype=torch.bfloat16,
                        device="cuda"), tables, lens - 1, lens, scale=0.1)
    plan = _mla_plan(2, 4, tables.shape[1], 16, 16, 8, 2, 132)
    for wrong in (plan._replace(dv=256), plan._replace(rows=32)):
        with pytest.raises(RuntimeError, match="paged MLA decode attention"):
            paged_mla_decode_cuda(qa, qr, ckv, kr, tables, lens, scale=0.1,
                                  plan=wrong)
    n1 = ops.launch_counts()
    assert n1["paged_mla_decode"] == n0["paged_mla_decode"]
    assert n1["paged_mla_prefill"] == n0["paged_mla_prefill"]


def test_reduced_deepseek_steps_match_plain(cuda):
    """The reduced deepseek-v3 model (one dense MLA layer, one MoE layer;
    head banks with K = 16 below the kernel's 32-deep k tile) in f32: one
    chunk-prefill and one decode step on the kernels against the same
    steps on the plain versions on the CPU, from the same weights; every
    GEMM and both MLA kernels launched, 1e-4 on logits (f32 summation
    order through two layers, as the CPU parity tests)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.api import build_model
    cfg = get_arch("deepseek-v3-671b").reduced()
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    dev = build_model(cfg, device="cuda")
    dparams = _to(params, "cuda")
    S, C, W, bs = 3, 5, 4, 4
    tables = torch.arange(S * W, dtype=torch.int32).reshape(S, W)
    kv0 = torch.zeros(S, dtype=torch.int32)
    chunk = torch.tensor([5, 3, 0], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (S, C),
                         generator=torch.Generator().manual_seed(0))
    wm = torch.tensor([1, 1, 0], dtype=torch.int32)
    ops.reset_counts()
    res = {}
    for name, model, p, d in (("cpu", cpu, params, "cpu"),
                              ("cuda", dev, dparams, "cuda")):
        arena = model.init_paged_arena(S * W + 1, bs)
        a = [t.to(d) for t in (toks, tables, kv0, chunk)]
        with torch.no_grad():
            pl, _ = model.paged_prefill_step(p, a[0], arena, *a[1:])
            nxt = res["cpu"][0].argmax(-1)[:, None].to(d) if res else \
                pl.argmax(-1)[:, None]
            dl, _ = model.paged_decode_step(p, nxt, arena, a[1], a[3],
                                            wm.to(d))
        res[name] = (pl.cpu(), dl.cpu())
    counts = ops.launch_counts()
    assert counts["paged_mla_prefill"] == counts["paged_mla_decode"] == 2
    assert counts["rsa_gemm"] > 0
    for i in (0, 1):
        diff = (res["cuda"][i] - res["cpu"][i])[:2].abs().max().item()
        assert diff < 1e-4


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("mode", [OS, WS, IS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_trans", [False, True])
def test_transposed_a_gemm_matches_plain(cuda, mode, dtype, b_trans):
    """The weight gradient x^T @ dy reads x (row-major (M, K)) in place as
    the transposed A, with B row-major or itself transposed."""
    M, K, N, bk = 300, 70, 136, 128      # the GEMM is (K, M) @ (M, N)
    x = torch.randn((M, K), generator=cuda, device="cuda").to(dtype)
    stored = torch.randn((N, M) if b_trans else (M, N), generator=cuda,
                         device="cuda").to(dtype)
    dy = stored.t() if b_trans else stored
    n0 = ops.launch_counts()["rsa_gemm"]
    got = ops.rsa_gemm(x.t(), dy, block_k=bk, mode=mode)
    assert ops.launch_counts()["rsa_gemm"] == n0 + 1
    want = rsa_gemm_plain(x.t(), dy, block_k=bk, mode=mode)
    tol = M * 2.0 ** -24 * (x.t().abs().float() @ dy.abs().float()
                            ).max().item()
    if dtype == torch.bfloat16:
        chunks = 1 if mode == OS else math.ceil(M / bk)
        tol += (chunks + 1) * 2.0 ** -8 * want.abs().max().item()
    assert got.shape == (K, N)
    assert (got.float() - want.float()).abs().max().item() <= tol


FLASH_CASES = [
    # B, Sq, Skv, H, KVH, hd, hd_v, causal, bq, bk (the reference's cases,
    # and the training shape's heads at a short length)
    (2, 256, 256, 4, 2, 64, 64, True, 128, 128),
    (1, 200, 200, 4, 1, 32, 48, True, 128, 64),
    (2, 128, 256, 4, 4, 64, 64, False, 64, 128),
    (1, 300, 300, 2, 2, 64, 64, True, 64, 128),
    (1, 64, 64, 8, 2, 128, 128, True, 64, 64),
    (1, 64, 256, 4, 2, 64, 64, True, 64, 64),      # kv past every query
    (2, 100, 100, 32, 8, 64, 64, True, 512, 512),
    # the redesigned kernels' cases: G 1 / 4 / 8 / 12 (12: two heads a
    # dk/dv CTA), hd / hd_v 32/48, 64/64, 128/128, 100/50 (rows whose width
    # is not a multiple of 4 take 4-byte copies), lengths 1, 63, 65, 129
    # and 1000, Sq < Skv causal, Sq > Skv bidirectional, phase 7's heads
    (1, 1, 1, 4, 4, 64, 64, True, 64, 64),
    (1, 63, 63, 8, 1, 64, 64, True, 64, 64),
    (1, 65, 65, 12, 1, 128, 128, True, 64, 64),
    (2, 129, 129, 24, 2, 100, 50, True, 64, 64),
    (1, 129, 129, 8, 2, 32, 48, True, 64, 64),
    (1, 1000, 1000, 8, 2, 64, 64, True, 512, 512),
    (1, 100, 300, 8, 1, 32, 48, True, 64, 64),     # kv past every query
    (1, 300, 100, 4, 1, 64, 64, False, 64, 64),    # Sq > Skv
    (1, 65, 129, 12, 1, 100, 50, False, 64, 64),
    (2, 1024, 1024, 32, 8, 64, 64, True, 512, 512),
]


def _flash_run(gen, case, dtype, execute):
    B, Sq, Skv, H, KVH, hd, hd_v, causal, bq, bk = case
    g = torch.Generator(device="cuda")
    g.manual_seed(sum(case[:7]))
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               .requires_grad_(True)
               for shape in ((B, Sq, H, hd), (B, Skv, KVH, hd),
                             (B, Skv, KVH, hd_v)))
    with dispatch.use(execute=execute):
        o = ops.flash_attention(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)
        torch.sin(o.float()).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c[:8]) for c in FLASH_CASES])
def test_flash_kernels_match_plain(cuda, case):
    """Forward, dq and dk/dv (through autograd, delta as a torch op) on the
    kernels against the plain versions, f32; a kv block past every query
    row gets exactly zero dk/dv."""
    n0 = ops.launch_counts()
    got = _flash_run(cuda, case, torch.float32, "kernel")
    n1 = ops.launch_counts()
    assert [n1[k] - n0[k] for k in ("flash_fwd", "flash_dq",
                                    "flash_dkv")] == [1, 1, 1]
    want = _flash_run(cuda, case, torch.float32, "torch")
    assert (got[0] - want[0]).abs().max().item() <= \
        2e-6 + 2e-6 * want[0].abs().max().item()
    for g, w in zip(got[1:], want[1:]):
        assert torch.allclose(g, w, atol=3e-5, rtol=1e-3)
    Sq, Skv = case[1], case[2]
    if case[7] and Skv > Sq:
        assert not got[2][:, Sq:].any() and not got[3][:, Sq:].any()


def _flash_inputs(case, dtype, seed=0):
    """q, k, v, do, and the plain forward's lse and delta, of a case."""
    from repro_torch.kernels.flash_attn import flash_fwd_plain
    B, Sq, Skv, H, KVH, hd, hd_v, causal, bq, bk = case
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + sum(case[:7]))
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, Sq, H, hd), (B, Skv, KVH, hd),
                                 (B, Skv, KVH, hd_v), (B, Sq, H, hd_v)))
    o, lse = flash_fwd_plain(q, k, v, causal=causal, scale=hd ** -0.5,
                             bq=bq, bk=bk)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c[:8]) for c in FLASH_CASES])
def test_flash_kernels_are_bitwise_run_to_run(cuda, case):
    """Two launches on the same inputs give the same bits: o and lse of
    the forward, dq (each row's kv tiles summed in order), dk and dv of
    dk/dv (its group sum is ordered, no atomics)."""
    from repro_torch.kernels.flash_attn import (flash_dkv_cuda, flash_dq_cuda,
                                                flash_fwd_cuda)
    q, k, v, do, lse, delta = _flash_inputs(case, torch.float32)
    kw = dict(causal=case[7], scale=case[5] ** -0.5)
    o1, l1 = flash_fwd_cuda(q, k, v, **kw)
    o2, l2 = flash_fwd_cuda(q, k, v, **kw)
    dq1 = flash_dq_cuda(q, k, v, do, lse, delta, **kw)
    dq2 = flash_dq_cuda(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dq1, dq2)
    dk1, dv1 = flash_dkv_cuda(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = flash_dkv_cuda(q, k, v, do, lse, delta, **kw)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c[:8]) for c in FLASH_CASES])
def test_flash_plan_variants_give_the_same_bits(cuda, case):
    """Every plan the kernels take gives the plan's bits: the forward with
    1 or 2 ring stages (a row's tiles and their order do not change), dq
    with 64 or 128 query rows a CTA (the same, and a warp skips only
    tiles with nothing live for its rows), dk/dv with 64
    or 128 kv rows a CTA and 1 or 2 stages, and, where the plan walks one
    head a CTA, every head of a group in one CTA (the same f32 adds of the
    rounded heads, in g order)."""
    from repro_torch.kernels.flash_attn import (
        _dkv_smem, _dq_smem, _flash_plan, _width, flash_dkv_cuda,
        flash_dq_cuda, flash_fwd_cuda)
    B, Sq, Skv, H, KVH, hd, hd_v, causal = case[:8]
    q, k, v, do, lse, delta = _flash_inputs(case, torch.float32)
    kw = dict(causal=causal, scale=hd ** -0.5)
    plan = _flash_plan(H, KVH, hd, hd_v)
    W, G = _width(hd, hd_v), H // KVH
    want = flash_fwd_cuda(q, k, v, **kw)
    for st in (1, 2):
        p = _flash_plan(H, KVH, hd, hd_v, fwd_stages=st)
        got = flash_fwd_cuda(q, k, v, plan=p, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), p
    want = flash_dq_cuda(q, k, v, do, lse, delta, **kw)
    for r in (64, 128):
        if _dq_smem(r, W) > 232448:
            continue
        p = _flash_plan(H, KVH, hd, hd_v, dq_rows=r)
        got = flash_dq_cuda(q, k, v, do, lse, delta, plan=p, **kw)
        assert torch.equal(got, want), p
    want = flash_dkv_cuda(q, k, v, do, lse, delta, **kw)
    variants = [dict(dkv_rows=r, dkv_stages=st) for r in (64, 128)
                for st in (1, 2) if _dkv_smem(r, W, st) <= 232448]
    if plan.heads == 1 and G > 1:
        variants.append(dict(heads=G))
    for var in variants:
        p = _flash_plan(H, KVH, hd, hd_v, **var)
        got = flash_dkv_cuda(q, k, v, do, lse, delta, plan=p, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), p


@pytest.mark.parametrize("case", FLASH_CASES[:-1],
                         ids=[str(c[:8]) for c in FLASH_CASES[:-1]])
def test_flash_dkv_bf16_matches_plain(cuda, case):
    """The bf16 dk/dv kernel (operands widened to f32 as they land, ds and
    each head's dk/dv rounded to bf16) against the plain version at the
    reference's bf16 tolerance."""
    from repro_torch.kernels.flash_attn import flash_dkv_cuda, flash_dkv_plain
    q, k, v, do, lse, delta = _flash_inputs(case, torch.bfloat16)
    kw = dict(causal=case[7], scale=case[5] ** -0.5)
    got = flash_dkv_cuda(q, k, v, do, lse, delta, **kw)
    want = flash_dkv_plain(q, k, v, do, lse, delta, bq=case[8], bk=case[9],
                           **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.allclose(g.float(), w.float(), atol=2e-2, rtol=2e-2)
    if case[7] and case[2] > case[1]:
        assert not got[0][:, case[1]:].any() and \
            not got[1][:, case[1]:].any()


@pytest.mark.parametrize("case", FLASH_CASES[:-1],
                         ids=[str(c[:8]) for c in FLASH_CASES[:-1]])
def test_flash_dq_bf16_matches_plain(cuda, case):
    """The bf16 dq kernel (operands widened to f32 as they land, ds and dq
    rounded to bf16) against the plain version at the reference's bf16
    tolerance, under the plan and under 64-row CTAs."""
    from repro_torch.kernels.flash_attn import (_flash_plan, flash_dq_cuda,
                                                flash_dq_plain)
    B, Sq, Skv, H, KVH, hd, hd_v = case[:7]
    q, k, v, do, lse, delta = _flash_inputs(case, torch.bfloat16)
    kw = dict(causal=case[7], scale=hd ** -0.5)
    want = flash_dq_plain(q, k, v, do, lse, delta, bq=case[8], bk=case[9],
                          **kw)
    for plan in (None, _flash_plan(H, KVH, hd, hd_v, dq_rows=64)):
        got = flash_dq_cuda(q, k, v, do, lse, delta, plan=plan, **kw)
        assert got.dtype == torch.bfloat16
        assert torch.allclose(got.float(), want.float(), atol=2e-2,
                              rtol=2e-2), plan


@pytest.mark.parametrize("case", FLASH_CASES[:-1],
                         ids=[str(c[:8]) for c in FLASH_CASES[:-1]])
def test_flash_forward_bf16_matches_plain(cuda, case):
    B, Sq, Skv, H, KVH, hd, hd_v, causal, bq, bk = case
    q = torch.randn((B, Sq, H, hd), generator=cuda, device="cuda")
    k = torch.randn((B, Skv, KVH, hd), generator=cuda, device="cuda")
    v = torch.randn((B, Skv, KVH, hd_v), generator=cuda, device="cuda")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    with torch.no_grad():
        with dispatch.use(execute="kernel"):
            got = ops.flash_attention(q, k, v, causal=causal, block_q=bq,
                                      block_k=bk)
        with dispatch.use(execute="torch"):
            want = ops.flash_attention(q, k, v, causal=causal, block_q=bq,
                                       block_k=bk)
    assert got.dtype == torch.bfloat16
    assert torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_reduced_train_step_matches_cpu(cuda):
    """One train step of the reduced llama3.2-1b (optimized profile, f32)
    on the kernels against the same step on the CPU's plain versions, from
    the same weights and batch: the loss to 1e-5 relative, the grad norm
    to 1e-4 relative, every new weight within 1e-4 of its leaf's largest
    magnitude; every flash kernel and the GEMM launched."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, _batch
    from repro_torch.launch.steps import build_train_step
    cfg = get_arch("llama3.2-1b", optimized=True).reduced()
    tokens = torch.from_numpy(_batch(DataConfig(cfg.vocab_size, 48, 2,
                                                seed=1), 0)["tokens"])
    init = build_train_step(cfg, device="cpu")[0].init(0)
    res = {}
    ops.reset_counts()
    for dev in ("cpu", "cuda"):
        _, step, opt = build_train_step(cfg, lr=1e-3, device=dev)
        params = _to(init, dev)
        new, _, met = step(params, opt.init(params),
                           {"tokens": tokens.to(dev)})
        res[dev] = (_to(new, "cpu"), float(met["loss"]),
                    float(met["grad_norm"]))
    counts = ops.launch_counts()
    assert counts["flash_fwd"] == 4 and counts["flash_dq"] == 2 and \
        counts["flash_dkv"] == 2          # 2 layers, remat recomputes
    assert counts["rsa_gemm"] > 0
    (pc, lc, gc), (pg, lg, gg) = res["cpu"], res["cuda"]
    assert abs(lg - lc) <= 1e-5 * lc and abs(gg - gc) <= 1e-4 * gc

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    want = dict(leaves(pc))
    for key, got in leaves(pg):
        assert (got - want[key]).abs().max().item() <= \
            1e-4 * want[key].abs().max().item() + 1e-6, key


WKV_CASES = [
    # name, B, S, H, K, V, chunk (the phase-3 cases of chip_smoke.py, and
    # the reference's tests/test_wkv_kernel.py shapes)
    ("prefill", 1, 512, 32, 64, 64, 64),
    ("ragged", 1, 100, 32, 64, 64, 64),
    ("decode", 8, 1, 32, 64, 64, 1),
    ("ref ragged", 2, 100, 3, 16, 16, 32),
    ("ref V != K", 1, 64, 1, 8, 24, 64),
    ("ref many chunks", 2, 96, 4, 32, 32, 16),
    ("chunk 1 over 5 rows", 2, 5, 4, 16, 16, 1),
    # one chunk (V in tiles), sixteen (the chain's own kernel), and chunks
    # whose 16-row sub-chunks do not divide them
    ("one chunk", 1, 64, 32, 64, 64, 64),
    ("sixteen chunks", 1, 1024, 32, 64, 64, 64),
    ("chunk 24", 2, 96, 4, 32, 32, 24),
    ("chunk 40", 1, 120, 4, 64, 64, 40),
    # K and V not multiples of 4: every row loads element by element
    ("odd widths", 2, 40, 3, 10, 6, 16),
    ("odd widths decode", 3, 2, 2, 10, 6, 1),
]


def _wkv_inputs(gen, B, S, H, K, V, strong, dtype=torch.float32):
    """Random WKV operands.  ``strong`` draws log decays over the model's
    whole clip range, -exp(U(-12, 1)) (down to -e), so a 64-row chunk's
    cumsum reaches ~ -174: exp of its negation would overflow."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if strong:
        lw = -torch.exp(torch.rand((B, S, H, K), generator=gen,
                                   device="cuda") * 13.0 - 12.0)
    else:
        lw = -torch.exp(rn(B, S, H, K) * 0.5 - 2.0)
    ts = (rn(B, S, H, K), rn(B, S, H, K), rn(B, S, H, V), lw,
          rn(H, K) * 0.1)
    return [t.to(dtype) for t in ts] + [rn(B, H, K, V) * 0.3]


def _close(got, want, bf16=False):
    assert torch.isfinite(got).all()
    mag = max(1.0, want.float().abs().max().item())
    tol = 1e-5 * mag + (2.0 ** -8 * mag if bf16 else 0.0)
    return (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("case", WKV_CASES, ids=[c[0] for c in WKV_CASES])
def test_wkv_kernel_matches_plain(cuda, case, strong):
    _, B, S, H, K, V, chunk = case
    args = _wkv_inputs(cuda, B, S, H, K, V, strong)
    ops.reset_counts()
    with dispatch.use(execute="kernel"):
        o, sf = ops.wkv_attention(*args, chunk=chunk)
    with dispatch.use(execute="torch"):
        po, psf = ops.wkv_attention(*args, chunk=chunk)
    assert ops.launch_counts()["wkv_bshk"] == 1
    assert o.shape == (B, S, H, V) and sf.shape == (B, H, K, V)
    assert _close(o, po) and _close(sf, psf)


def _wkv_forced(B, S, H, K, V, chunk):
    """Every plan the kernel takes for one shape: decode (chunk 1), and the
    chunked variant with the chain folded and launched, V whole and in
    tiles of 16."""
    from repro_torch.kernels.linear_attn import _wkv_plan
    plans = []
    if chunk == 1:
        plans.append(_wkv_plan(B, S, H, K, V, 1, variant="decode"))
    V4 = -(-V // 4) * 4
    for chain in ("fold", "launch"):
        for vt in sorted({V4, min(V4, 16)}):
            plans.append(_wkv_plan(B, S, H, K, V, chunk, variant="chunked",
                                   chain=chain, vt=vt))
    return plans


WKV_FORCED = [c for c in WKV_CASES if c[0] in (
    "prefill", "sixteen chunks", "chunk 40", "ref V != K",
    "chunk 1 over 5 rows", "decode", "odd widths", "odd widths decode")]


@pytest.mark.parametrize("case", WKV_FORCED, ids=[c[0] for c in WKV_FORCED])
def test_wkv_kernel_forced_plans_run_to_run_bitwise(cuda, case):
    """Every forced plan is within tolerance of the plain version (decays
    down to -e) and bitwise equal to itself run to run; the two chain
    placements give the same bits, as the chain rounds alike in both."""
    from repro_torch.kernels.linear_attn import wkv_bshk_cuda
    _, B, S, H, K, V, chunk = case
    r, k, v, lw, u, s0 = _wkv_inputs(cuda, B, S, H, K, V, True)
    r, k, v, lw = ops._pad_rows(chunk, r, k, v, lw)   # as ops pads
    S = r.shape[1]
    with dispatch.use(execute="torch"):
        po, psf = ops.wkv_attention(r, k, v, lw, u, s0, chunk=chunk)
    by_chain = {}
    for plan in _wkv_forced(B, S, H, K, V, chunk):
        ops.reset_counts()
        o, sf = wkv_bshk_cuda(r, k, v, lw, u, s0, chunk=chunk, plan=plan)
        o2, sf2 = wkv_bshk_cuda(r, k, v, lw, u, s0, chunk=chunk, plan=plan)
        assert ops.launch_counts()["wkv_bshk"] == 2, plan
        assert torch.equal(o, o2) and torch.equal(sf, sf2), plan
        assert _close(o, po) and _close(sf, psf), plan
        key = (plan.variant, plan.vt)
        if key in by_chain:
            assert torch.equal(o, by_chain[key][0]), plan
            assert torch.equal(sf, by_chain[key][1]), plan
        by_chain[key] = (o, sf)


@pytest.mark.parametrize("chunk", [1, 32, 64])
def test_wkv_kernel_bf16_plans_match_plain(cuda, chunk):
    """bf16 operands widen to f32 as they land and o rounds once: every
    plan within one bf16 rounding of the plain version."""
    from repro_torch.kernels.linear_attn import wkv_bshk_cuda
    B, S = (8, 3) if chunk == 1 else (2, 128)
    args = _wkv_inputs(cuda, B, S, 4, 64, 64, True, torch.bfloat16)
    with dispatch.use(execute="torch"):
        po, psf = ops.wkv_attention(*args, chunk=chunk)
    for plan in _wkv_forced(B, S, 4, 64, 64, chunk):
        o, sf = wkv_bshk_cuda(*args, chunk=chunk, plan=plan)
        assert o.dtype == torch.bfloat16, plan
        assert _close(o, po, bf16=True) and _close(sf, psf), plan


@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_linear_attn_kernel_forced_plans(cuda, chunk):
    """Row 14's entry point under every forced plan (BH = 64, S = 1024 at
    chunk 64: sixteen chunks), run to run bitwise, within tolerance."""
    from repro_torch.kernels.linear_attn import linear_attn_cuda
    BH, S, K, V = (64, 1024, 64, 64) if chunk == 64 else (6, 80, 32, 24)

    def rn(*sh):
        return torch.randn(sh, generator=cuda, device="cuda")
    args = (rn(BH, S, K) * 0.5, rn(BH, S, K) * 0.5, rn(BH, S, V),
            -torch.exp(rn(BH, S, K) * 0.5 - 3.0), rn(BH, K) * 0.1)
    with dispatch.use(execute="torch"):
        want = ops.linear_attn(*args, chunk=chunk)
    for plan in _wkv_forced(BH, S, 1, K, V, chunk):
        o = linear_attn_cuda(*args, chunk=chunk, plan=plan)
        assert torch.equal(o, linear_attn_cuda(*args, chunk=chunk,
                                               plan=plan)), plan
        assert _close(o, want), plan


def test_wkv_kernel_state_carry_composes(cuda):
    """[0:S/2] then [S/2:S] with the carried state equals one pass."""
    args = _wkv_inputs(cuda, 1, 512, 32, 64, 64, False)
    r, k, v, lw, u, s0 = args
    with dispatch.use(execute="kernel"):
        o, sf = ops.wkv_attention(*args, chunk=64)
        oa, sa = ops.wkv_attention(r[:, :256], k[:, :256], v[:, :256],
                                   lw[:, :256], u, s0, chunk=64)
        ob, sb = ops.wkv_attention(r[:, 256:], k[:, 256:], v[:, 256:],
                                   lw[:, 256:], u, sa, chunk=64)
    assert _close(torch.cat([oa, ob], 1), o) and _close(sb, sf)


def test_wkv_kernel_bf16_matches_plain(cuda):
    args = _wkv_inputs(cuda, 2, 100, 4, 32, 32, False, torch.bfloat16)
    with dispatch.use(execute="kernel"):
        o, sf = ops.wkv_attention(*args, chunk=32)
    with dispatch.use(execute="torch"):
        po, psf = ops.wkv_attention(*args, chunk=32)
    assert o.dtype == torch.bfloat16 and sf.dtype == torch.float32
    assert _close(o, po, bf16=True) and _close(sf, psf)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("shape", [(64, 1024, 64, 64), (2, 64, 16, 16),
                                   (4, 100, 16, 32), (1, 257, 32, 32)])
def test_linear_attn_kernel_matches_plain(cuda, shape, chunk):
    BH, S, K, V = shape

    def rn(*sh):
        return torch.randn(sh, generator=cuda, device="cuda")
    args = (rn(BH, S, K) * 0.5, rn(BH, S, K) * 0.5, rn(BH, S, V),
            -torch.exp(rn(BH, S, K) * 0.5 - 3.0), rn(BH, K) * 0.1)
    ops.reset_counts()
    with dispatch.use(execute="kernel"):
        o = ops.linear_attn(*args, chunk=chunk)
    with dispatch.use(execute="torch"):
        want = ops.linear_attn(*args, chunk=chunk)
    assert ops.launch_counts()["linear_attn"] == 1
    assert o.shape == (BH, S, V) and _close(o, want)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_reduced_rwkv_serve_matches_cpu(cuda, impl):
    """The reduced rwkv6 model (2 layers, d = 64, f32) served on the card
    and on the CPU from the same weights (dense slot layout, 3 requests on
    2 slots): the same greedy tokens, and on the kernel route 2 WKV
    launches per model call (one per layer)."""
    import numpy as np
    from repro_torch.configs.registry import get_arch
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_arch("rwkv6-1.6b").reduced().replace(ssm_impl=impl)
    ecfg = EngineConfig(num_slots=2, max_len=32, temperature=0.0,
                        kv_layout="auto", prefill_chunk=None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 21)]
    params = None
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, ecfg, device=dev,
                            params=None if params is None else
                            _to(params, dev))
        params = eng.params
        ops.reset_counts()
        outs[dev] = eng.run([Request(f"r{i}", p, 6)
                             for i, p in enumerate(prompts)])
        calls = eng.metrics.decode_steps + len(prompts)
        counts = ops.launch_counts()
    assert counts["wkv_bshk"] == (2 * calls if impl == "pallas" else 0)
    assert counts["plain_calls"] == 0 and counts["rsa_gemm"] > 0
    for rid, toks in outs["cpu"].items():
        assert list(outs["cuda"][rid]) == list(toks), rid


def _adaptnetx_params(gen, C, E=16, H=128, rows=10_001):
    def rn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
    return {"emb_m": rn(rows, E) * 0.02, "emb_k": rn(rows, E) * 0.02,
            "emb_n": rn(rows, E) * 0.02, "w1": rn(3 * E, H) / (3 * E) ** 0.5,
            "b1": rn(H) * 0.1, "w2": rn(H, C) / H ** 0.5, "b2": rn(C) * 0.1}


@pytest.mark.parametrize("num_classes", [75, 108, 135])
def test_adaptnetx_kernel_matches_plain(cuda, num_classes):
    """The reference's kernel-test ids, ids past the table and negative
    (clamped), and a batch of 64 queries: rtol = atol = 1e-5, the
    reference's own tolerance (f32 sums of 48 and 128 terms in another
    order)."""
    p = _adaptnetx_params(cuda, num_classes)
    singles = ([1, 1, 1], [9999, 5000, 1], [123, 4567, 8910],
               [20000, -3, 10001])
    batch = torch.randint(-10, 12_000, (64, 3), generator=cuda,
                          device="cuda", dtype=torch.int32)
    ops.reset_counts()
    for ids in list(singles) + [batch]:
        ids = torch.as_tensor(ids, device="cuda")
        with dispatch.use(execute="kernel"):
            got = ops.adaptnetx_recommend(ids, p)
        with dispatch.use(execute="torch"):
            want = ops.adaptnetx_recommend(ids, p)
        assert got.shape == want.shape == ids.shape[:-1] + (num_classes,)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    counts = ops.launch_counts()
    assert counts["adaptnetx"] == len(singles) + 1
    assert counts["plain_calls"] == len(singles) + 1


@pytest.mark.parametrize("E,H,C,rows", [(8, 256, 300, 7), (64, 1024, 3, 1),
                                        (1, 1, 1, 2), (5, 130, 7, 3)])
def test_adaptnetx_kernel_other_widths(cuda, E, H, C, rows):
    """Several hidden chunks and class tiles, wide and narrow class
    counts, the largest embedding width, one-row tables, H and C not
    multiples of 4 (the 4-byte copies)."""
    p = _adaptnetx_params(cuda, C, E=E, H=H, rows=rows)
    ids = torch.randint(-2, rows + 3, (33, 3), generator=cuda, device="cuda")
    with dispatch.use(execute="kernel"):
        got = ops.adaptnetx_recommend(ids, p)
    with dispatch.use(execute="torch"):
        want = ops.adaptnetx_recommend(ids, p)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


ADAPTNETX_SHAPES = [(16, 128, 135, 10_001), (16, 128, 75, 10_001),
                    (8, 256, 300, 7), (64, 1024, 3, 1), (5, 130, 7, 3),
                    (1, 1, 1, 2)]


@pytest.mark.parametrize("B", [1, 33, 64])
@pytest.mark.parametrize("E,H,C,rows", ADAPTNETX_SHAPES)
def test_adaptnetx_forced_plans_bitwise(cuda, E, H, C, rows, B):
    """Every forced plan (``VARIANTS``: 1 to 32 chunks a CTA, so one CTA
    and clusters of 2-8, query tiles of 1-64, class tiles of 64, one ring
    stage)
    gives bitwise the chosen plan's logits, and each repeats bitwise run
    to run: the kernel sums in one fixed order whatever the plan."""
    from repro_torch.kernels.adaptnetx import (OPERANDS, VARIANTS,
                                               _adaptnetx_plan,
                                               adaptnetx_cuda)
    p = _adaptnetx_params(cuda, C, E=E, H=H, rows=rows)
    t = [p[k] for k in OPERANDS]
    ids = torch.randint(-2, rows + 3, (B, 3), generator=cuda, device="cuda",
                        dtype=torch.int32)
    want = adaptnetx_cuda(ids, *t)
    ops.reset_counts()
    ran = 0
    for _, kw in VARIANTS:
        try:
            plan = _adaptnetx_plan(B, E, H, C, **kw)
        except ValueError:
            continue
        got, again = (adaptnetx_cuda(ids, *t, plan=plan) for _ in range(2))
        ran += 2
        assert torch.equal(got, want), plan
        assert torch.equal(got, again), plan
    assert ops.launch_counts()["adaptnetx"] == ran
    with dispatch.use(execute="torch"):
        plain = ops.adaptnetx_recommend(ids, p)
    torch.testing.assert_close(want, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("E,H,C,rows", ADAPTNETX_SHAPES)
def test_adaptnetx_query_alone_equals_batch(cuda, E, H, C, rows):
    """A query alone gives bitwise its row in batches of 33 and 64."""
    p = _adaptnetx_params(cuda, C, E=E, H=H, rows=rows)
    batch = torch.randint(-2, rows + 3, (64, 3), generator=cuda,
                          device="cuda", dtype=torch.int32)
    with dispatch.use(execute="kernel"):
        rows64 = ops.adaptnetx_recommend(batch, p)
        rows33 = ops.adaptnetx_recommend(batch[:33], p)
        for b in range(64):
            alone = ops.adaptnetx_recommend(batch[b], p)
            assert torch.equal(alone, rows64[b]), b
            if b < 33:
                assert torch.equal(alone, rows33[b]), b


def test_reduced_adaptnet_serve_matches_cpu(cuda, tmp_path):
    """A logbucket net trained by the port on the CPU drives the reduced
    llama3.2-1b (paged, chunk 8, f32) on the card and on the CPU from the
    same weights: the same greedy tokens, the same executed tile and
    source at every site, no plain version on the card."""
    import numpy as np
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train_adaptnet import (save_adaptnet,
                                                   serving_gemm_shapes,
                                                   train_serving_adaptnet)
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_arch("llama3.2-1b").reduced()
    params, info = train_serving_adaptnet(
        6000, 2, shapes=serving_gemm_shapes(("llama3.2-1b",), reduced=True),
        max_dim=256, num_buckets=64, seed=0, log=False, device="cpu")
    save_adaptnet(str(tmp_path), params, info)
    ecfg = EngineConfig(num_slots=2, max_len=32, block_size=4,
                        prefill_chunk=8, temperature=0.0, kv_layout="paged",
                        dispatcher_mode="adaptnet", adaptnet_dir=str(tmp_path))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 13, 21)]
    weights = None
    outs, plans = {}, {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, ecfg, device=dev,
                            params=None if weights is None else
                            _to(weights, dev))
        weights = eng.params
        ops.reset_counts()
        outs[dev] = eng.run([Request(f"r{i}", p, 6)
                             for i, p in enumerate(prompts)])
        plans[dev] = {(s, n): (r.executed(), r.source)
                      for s in eng.registry.scopes()
                      for n, r in eng.registry.sites(s).items()}
        counts = ops.launch_counts()
        s = eng.summary()
        assert s["rec_adaptnet_sites"] > 0 and s["rec_fallback_sites"] > 0
    assert counts["plain_calls"] == 0 and counts["rsa_gemm"] > 0
    assert plans["cuda"] == plans["cpu"]
    for rid, toks in outs["cpu"].items():
        assert list(outs["cuda"][rid]) == list(toks), rid


# --------------------------------------------------------------------------
# the WS/IS kernel (csrc/rsa_psum.cu): one kernel for both modes
# --------------------------------------------------------------------------

def _gemm_tol(a, b, want, bk, out):
    """The file's GEMM bound: K * 2^-24 * max(|a| @ |b|), plus one bf16
    rounding per block_k chunk (and one more) of max |plain| for a bf16
    output."""
    K = a.shape[-1]
    tol = K * 2.0 ** -24 * torch.matmul(a.abs().float(),
                                        b.abs().float()).max().item()
    if out == torch.bfloat16:
        tol += (math.ceil(K / bk) + 1) * 2.0 ** -8 * want.abs().max().item()
    return tol


def _psum_check(a, b, bk, out):
    """WS and IS each one launch, bitwise equal to each other and to a
    second run, and within the bound of the plain version."""
    got = {}
    for mode in (WS, IS):
        n0 = ops.launch_counts()["rsa_gemm"]
        got[mode] = ops.rsa_gemm(a, b, block_k=bk, mode=mode, out_dtype=out)
        assert ops.launch_counts()["rsa_gemm"] == n0 + 1
    again = ops.rsa_gemm(a, b, block_k=bk, mode=WS, out_dtype=out)
    torch.cuda.synchronize()
    assert got[WS].dtype == out
    assert torch.equal(got[WS], got[IS])
    assert torch.equal(got[WS], again)
    want = rsa_gemm_plain(a, b, block_k=bk, mode=WS, out_dtype=out)
    err = (got[WS].float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= _gemm_tol(a, b, want, bk, out)
    return got[WS]


PSUM_DTYPES = [(torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float32, torch.float32)]


@pytest.mark.parametrize("dtype,out", PSUM_DTYPES,
                         ids=["bf16", "bf16-f32", "f32"])
@pytest.mark.parametrize("bk", [32, 256, 2048])
@pytest.mark.parametrize("K", [64, 200, 1000, 8192])
@pytest.mark.parametrize("M", [1, 8, 32, 65, 300])
def test_psum_gemm_matches_plain(cuda, M, K, bk, dtype, out):
    """Skinny and wide M (the swapped operands and split-K at M <= 128),
    K below, around and far above block_k, every input/output type."""
    N = 392 if M <= 32 else 136
    a = torch.randn((M, K), generator=cuda, device="cuda").to(dtype)
    b = (torch.randn((K, N), generator=cuda, device="cuda") /
         math.sqrt(K)).to(dtype)
    _psum_check(a, b, bk, out)


@pytest.mark.parametrize("dtype,out", PSUM_DTYPES,
                         ids=["bf16", "bf16-f32", "f32"])
@pytest.mark.parametrize("a_t,b_t", [(False, True), (True, False),
                                     (True, True)], ids=["BT", "AT", "ATBT"])
@pytest.mark.parametrize("M", [8, 300])
@pytest.mark.parametrize("aligned", [True, False])
def test_psum_transposed_operands(cuda, aligned, M, a_t, b_t, dtype, out):
    """A^T and B^T read in place, through TMA where base and row stride are
    16-byte aligned and through the producer's own loads where not (a view
    one column narrower than its storage)."""
    K, N, bk = 520, 264, 256
    pad = 0 if aligned else 1

    def operand(rows, cols, transposed):
        shape = (cols, rows + pad) if transposed else (rows, cols + pad)
        x = torch.randn(shape, generator=cuda, device="cuda") / \
            math.sqrt(K)
        x = x.to(dtype)
        return x[:, :rows].t() if transposed else x[:, :cols]

    a = operand(M, K, a_t)
    b = operand(K, N, b_t)
    _psum_check(a, b, bk, out)


@pytest.mark.parametrize("dtype,out", PSUM_DTYPES[:1] + PSUM_DTYPES[2:],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M", [8, 32, 300])
@pytest.mark.parametrize("bank", ["experts", "head views"])
def test_psum_bank_gemm(cuda, bank, M, dtype, out):
    """A bank in one launch, WS = IS bitwise, each member bitwise the 2-D
    kernel; head banks are strided views of one (N, E*K) weight."""
    E, K, N, bk = 4, 256, 192, 128
    a = torch.randn((E, M, K), generator=cuda, device="cuda").to(dtype)
    if bank == "experts":
        b = torch.randn((E, K, N), generator=cuda, device="cuda").to(dtype)
    else:
        w = torch.randn((N, E * K), generator=cuda, device="cuda").to(dtype)
        b = w.reshape(N, E, K).permute(1, 2, 0)
    got = _psum_check(a, b, bk, out)
    for e in range(E):
        one = ops.rsa_gemm(a[e], b[e], block_k=bk, mode=IS, out_dtype=out)
        assert torch.equal(one, got[e])


def test_psum_split_plan_and_refused_launch(cuda):
    """A decode GEMM that splits K (one launch, deterministic), then a
    launch the kernel refuses and one with mismatched devices: neither
    leaves a ticket set, so the next split launch is right again."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rsa_gemm import _psum_plan, _tickets
    M, K, N, bk = 8, 2048, 2048, 256
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = _psum_plan(1, M, K, N, bk, torch.bfloat16, sms)
    assert plan.nsplit > 1
    a = torch.randn((M, K), generator=cuda, device="cuda").bfloat16()
    b = (torch.randn((K, N), generator=cuda, device="cuda") /
         math.sqrt(K)).bfloat16()
    first = _psum_check(a, b, bk, torch.bfloat16)
    lib = _build.library("rsa_psum")
    tickets = _tickets(a.device, plan.tiles)
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    err = lib.rsa_psum_launch(              # nsplit inconsistent with K/bk
        WS, 1, 1, 0, 0, a.data_ptr(), K, 0, b.data_ptr(), N, 0,
        out.data_ptr(), M * N, 1, M, N, K, bk, plan.tile, int(plan.swap),
        plan.nsplit + 1, plan.pieces, plan.piece, None, tickets.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(ValueError):
        ops.rsa_gemm(a, b.cpu(), block_k=bk, mode=WS)
    torch.cuda.synchronize()
    assert not tickets.any()
    assert torch.equal(_psum_check(a, b, bk, torch.bfloat16), first)
    assert not tickets.any()


# ---------------------------------------------------------------------------
# OS on the psum kernel: one chunk over the whole K
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,out", PSUM_DTYPES,
                         ids=["bf16", "bf16-f32", "f32"])
@pytest.mark.parametrize("K", [64, 200, 1000, 8192])
@pytest.mark.parametrize("M", [1, 8, 32, 65, 300])
def test_os_gemm_matches_plain(cuda, M, K, dtype, out):
    """OS runs the psum kernel with one chunk (block_k >= K): one launch a
    call, run to run bitwise (a split's fix-up is ordered), within the OS
    bound of the plain version (one bf16 rounding), whatever block_k the
    caller passes."""
    N = 392 if M <= 32 else 136
    a = torch.randn((M, K), generator=cuda, device="cuda").to(dtype)
    b = (torch.randn((K, N), generator=cuda, device="cuda") /
         math.sqrt(K)).to(dtype)
    n0 = ops.launch_counts()["rsa_gemm"]
    got = ops.rsa_gemm(a, b, block_k=32, mode=OS, out_dtype=out)
    again = ops.rsa_gemm(a, b, block_k=2048, mode=OS, out_dtype=out)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rsa_gemm"] == n0 + 2
    assert got.dtype == out and torch.equal(got, again)
    want = rsa_gemm_plain(a, b, block_k=32, mode=OS, out_dtype=out)
    tol = K * 2.0 ** -24 * (a.abs().float() @ b.abs().float()).max().item()
    if out == torch.bfloat16:
        tol += 2 * 2.0 ** -8 * want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert math.isfinite(err) and err <= tol


def test_os_gemm_at_the_unembedding_depth(cuda):
    """K = 128256 (the tied unembedding's dx, here at decode M): one chunk
    the whole vocabulary deep, split across the card, bitwise twice."""
    M, K, N = 8, 128256, 2048
    a = torch.randn((M, K), generator=cuda, device="cuda")
    b = torch.randn((N, K), generator=cuda, device="cuda") / math.sqrt(K)
    got = ops.rsa_gemm(a, b.t(), block_k=256, mode=OS)
    again = ops.rsa_gemm(a, b.t(), block_k=256, mode=OS)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = rsa_gemm_plain(a, b.t(), block_k=256, mode=OS)
    tol = K * 2.0 ** -24 * (a.abs() @ b.t().abs()).max().item()
    assert (got - want).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# the split-KV paged decode kernel (decode and decode-lse)
# ---------------------------------------------------------------------------

def _decode_inputs(gen, S, KVH, G, hd, dtype, lengths, bs=16):
    """Disjoint pages a lane, in shuffled arena order; dead columns repeat
    the last live id; the table is as wide as the longest lane."""
    W = max(1, max(-(-n // bs) for n in lengths))
    NB = sum(-(-n // bs) for n in lengths) + 1
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(S))
    tables = torch.zeros((S, W), dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(lengths):
        nb = -(-n // bs)
        if nb:
            tables[i, :nb] = perm[nxt:nxt + nb].int()
            tables[i, nb:] = tables[i, nb - 1]
            nxt += nb
    k = torch.randn((NB, bs, KVH, hd), generator=gen, device="cuda")
    v = torch.randn((NB, bs, KVH, hd), generator=gen, device="cuda")
    q = torch.randn((S, KVH * G, hd), generator=gen, device="cuda")
    return (q.to(dtype), k.to(dtype), v.to(dtype), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


DECODE_LENGTHS = {
    1: [8192],
    8: [0, 1, 16, 17, 545, 2000, 4097, 8192],
    64: [(i * 37) % 600 for i in range(63)] + [8192],
}


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S", [1, 8, 64])
def test_split_decode_kernels_match_plain(cuda, S, G, hd, dtype, tol, cap):
    """Decode and decode-lse at S in {1, 8, 64} (split and unsplit plans),
    G in {1, 4, 8}, hd = hd_v in {64, 128, 256}, lengths 0 ... 8192 with
    the soft cap on and off, against the plain versions: o within today's
    tolerances, (m, l) within 1e-4 relative, the empty lane exactly (0,
    -1e30, 0); one launch a call."""
    lengths = DECODE_LENGTHS[S]
    q, k, v, tables, lens = _decode_inputs(cuda, S, 2, G, hd, dtype,
                                           lengths)
    scale = hd ** -0.5
    n0 = ops.launch_counts()
    got = paged_decode_cuda(q, k, v, tables, lens, scale=scale,
                            logit_cap=cap)
    lse = paged_decode_lse_cuda(q, k, v, tables, lens, scale=scale,
                                logit_cap=cap)
    n1 = ops.launch_counts()
    assert (n1["paged_decode"] - n0["paged_decode"],
            n1["paged_decode_lse"] - n0["paged_decode_lse"]) == (1, 1)
    want = paged_attention_plain(q, k, v, tables, lens, scale=scale,
                                 logit_cap=cap)
    assert (got.float() - want.float()).abs().max().item() <= tol
    _states_close(lse, paged_attention_lse_plain(
        q, k, v, tables, lens, scale=scale, logit_cap=cap), tol)
    assert torch.equal(lse[0], got)
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all() and (lse[1][i] == NEG).all() and \
                (lse[2][i] == 0).all()


@pytest.mark.parametrize("splits", [1, 2, 3, 16, 64, 512])
def test_split_decode_any_split_count_is_right_and_bitwise(cuda, splits):
    """Forced split counts at phase 3's widths (8 lanes, 8 kv heads, G = 4,
    hd 64, bf16, lengths 0 ... 8192), one lane ending inside the first
    split: each within the tolerance, and bitwise equal run to run (the
    merge is ordered); the tickets are left zero."""
    from repro_torch.kernels.paged_attn import DecodePlan, _decode_plan
    lengths = [3, 1, 16, 17, 545, 2000, 0, 8192]
    q, k, v, tables, lens = _decode_inputs(cuda, 8, 8, 4, 64,
                                           torch.bfloat16, lengths)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = _decode_plan(8, 8, 4, tables.shape[1], 16, 64, 64, 2, sms,
                        splits=splits)
    assert isinstance(plan, DecodePlan)
    a = (q, k, v, tables, lens)
    got = paged_decode_lse_cuda(*a, scale=0.125, plan=plan)
    again = paged_decode_lse_cuda(*a, scale=0.125, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _states_close(got, paged_attention_lse_plain(*a, scale=0.125), 4e-2)
    from repro_torch.kernels.paged_attn import _TICKETS
    assert not _TICKETS[q.device].any()


def test_split_decode_refuses_over_limit_before_launch(cuda):
    """hd_v past 256 raises before any launch; nothing is counted."""
    q, k, v, tables, lens = _decode_inputs(cuda, 2, 1, 4, 512,
                                           torch.bfloat16, [5, 40])
    n0 = ops.launch_counts()
    for fn in (paged_decode_cuda, paged_decode_lse_cuda):
        with pytest.raises(ValueError, match="hd_v <= 256"):
            fn(q, k, v, tables, lens, scale=0.1)
    n1 = ops.launch_counts()
    assert n1["paged_decode"] == n0["paged_decode"]
    assert n1["paged_decode_lse"] == n0["paged_decode_lse"]


# ---------------------------------------------------------------------------
# the tensor-core prefill / shared-prefix kernel
# ---------------------------------------------------------------------------

PREFILL_STARTS = [0, 3, 100, 17, 250]      # none on a page boundary but 0
PREFILL_CHUNKS = [0, 1, 10, 37, 64]


def _prefill_inputs(gen, KVH, G, hd, dtype, starts=PREFILL_STARTS,
                    chunks=PREFILL_CHUNKS, C=64):
    """Shuffled disjoint pages a lane over lengths starts + chunks, and a
    64-row chunk of queries a lane (rows past a lane's chunk included)."""
    lengths = [s + c for s, c in zip(starts, chunks)]
    S = len(lengths)
    _, k, v, tables, lens = _decode_inputs(gen, S, KVH, G, hd, dtype,
                                           lengths)
    q = torch.randn((S, C, KVH * G, hd), generator=gen, device="cuda")
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    return q.to(dtype), k, v, tables, st, lens


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_prefill_kernel_matches_plain(cuda, G, hd, dtype, tol, cap):
    """Prefill at hd = hd_v in {64, 128, 256}, G in {1, 4, 8}, chunks 0, 1,
    10, 37 and 64 at starts off the page boundaries, every row of the
    64-row chunk (rows past a lane's chunk too), against the plain version;
    one launch a call; the lane of length 0 is zeros; the plan splits the
    20 page columns 3 ways (10, 40 and 80 units)."""
    q, k, v, tables, st, lens = _prefill_inputs(cuda, 2, G, hd, dtype)
    scale = hd ** -0.5
    n0 = ops.launch_counts()["paged_prefill"]
    got = paged_prefill_cuda(q, k, v, tables, st, lens, scale=scale,
                             logit_cap=cap)
    assert ops.launch_counts()["paged_prefill"] == n0 + 1
    want = paged_prefill_attention_plain(q, k, v, tables, st, lens,
                                         scale=scale, logit_cap=cap)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got[0] == 0).all()


PREFIX_LENS = [640, 640, 3, 0, 64, 65, 300, 639]   # lane 3 is not a member


def _prefix_inputs(gen, KVH, G, hd, dtype, plens=PREFIX_LENS, P=40, pad=3,
                   hd_v=None):
    """A P-page shared prefix on shuffled arena pages, padded with ``pad``
    repeats of the last id; lanes attend their ``plens`` first rows."""
    bs, S = 16, len(plens)
    NB = P + 5
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(P))
    pages = perm[:P].int().tolist()
    k = torch.randn((NB, bs, KVH, hd), generator=gen, device="cuda")
    v = torch.randn((NB, bs, KVH, hd_v or hd), generator=gen, device="cuda")
    q = torch.randn((S, KVH * G, hd), generator=gen, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            torch.tensor(pages + [pages[-1]] * pad, **i32),
            torch.tensor(plens, **i32))


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_prefix_kernel_matches_plain(cuda, G, hd, dtype, tol, cap):
    """The shared-prefix phase at hd in {64, 128, 256}, G in {1, 4, 8} (8,
    32 and 64 rows a kv head: 1, 2 and 4 of the 4 warps hold rows), prefix
    lengths inside the first split, on and across split boundaries (the
    plan splits the 43 columns 11 ways), against the plain version: o
    within the attention tolerance, (m, l) within 1e-4 relative, the
    non-member lane exactly (0, -1e30, 0); one launch a call."""
    q, k, v, pages, plens = _prefix_inputs(cuda, 2, G, hd, dtype)
    scale = hd ** -0.5
    n0 = ops.launch_counts()["paged_prefix"]
    got = paged_prefix_cuda(q, k, v, pages, plens, scale=scale,
                            logit_cap=cap)
    assert ops.launch_counts()["paged_prefix"] == n0 + 1
    _states_close(got, shared_prefix_attention_plain(
        q, k, v, pages, plens, scale=scale, logit_cap=cap), tol)
    assert (got[0][3] == 0).all() and (got[1][3] == NEG).all() and \
        (got[2][3] == 0).all()


# speculative decoding's verify: C = spec_k + 1 rows a lane, ragged chunks
# 0, 1, ..., C at kv offsets off the page and 64-row tile boundaries
VERIFY_STARTS = [0, 3, 67, 130, 541, 250]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("C", [2, 5, 9])
def test_prefill_kernel_at_verify_shapes(cuda, C, G, hd, dtype, tol):
    """The prefill kernel at the verify shapes (C in {2, 5, 9} rows a
    lane, chunks 0, 1, C - 1 and C, G in {1, 4}, hd 16 (rounded up to the
    64-wide tile) and 64) against the plain version at every row; two runs
    bitwise equal, one launch each; the lane of length 0 is zeros."""
    chunks = [0, 1, C, C - 1, C, 2]
    q, k, v, tables, st, lens = _prefill_inputs(
        cuda, 2, G, hd, dtype, starts=VERIFY_STARTS, chunks=chunks, C=C)
    scale = hd ** -0.5
    n0 = ops.launch_counts()["paged_prefill"]
    got = paged_prefill_cuda(q, k, v, tables, st, lens, scale=scale)
    again = paged_prefill_cuda(q, k, v, tables, st, lens, scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_prefill"] == n0 + 2
    assert torch.equal(got, again)
    want = paged_prefill_attention_plain(q, k, v, tables, st, lens,
                                         scale=scale)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got[0] == 0).all()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma-2b"])
def test_reduced_verify_step_matches_cpu(cuda, arch):
    """``paged_verify_step`` of the reduced model (f32, hd 16; llama G = 2,
    gemma G = 4) on the kernels against the same step on the plain
    versions on the CPU, from the same weights and arena: every row up to
    each lane's chunk length within 1e-4, the written arena rows within
    1e-5 (f32 summation order, as the CPU parity tests); the prefill
    kernel once a layer and the RSA GEMM 7 times a layer plus the
    unembedding."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.api import build_model
    cfg = get_arch(arch).reduced()
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    dev = build_model(cfg, device="cuda")
    dparams = _to(params, "cuda")
    S, C, W, bs = 4, 4, 4, 4
    g = torch.Generator().manual_seed(1)
    tables = torch.randperm(S * W, generator=g).int().reshape(S, W)
    kv = torch.tensor([0, 5, 7, 8], dtype=torch.int32)
    clens = torch.tensor([0, 1, 4, 4], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (S, C), generator=g)
    arena0 = {n: torch.randn(a.shape, generator=g)
              for n, a in cpu.init_paged_arena(S * W + 1, bs).items()}
    res = {}
    ops.reset_counts()
    for name, model, p, d in (("cpu", cpu, params, "cpu"),
                              ("cuda", dev, dparams, "cuda")):
        arena = {n: a.to(d).clone() for n, a in arena0.items()}
        with torch.no_grad():
            logits, arena = model.paged_verify_step(
                p, toks.to(d), arena, *(t.to(d) for t in (tables, kv,
                                                            clens)))
        res[name] = (logits.cpu(), {n: a.cpu() for n, a in arena.items()})
    counts = ops.launch_counts()
    assert counts["paged_prefill"] == cfg.num_layers
    assert counts["rsa_gemm"] == 7 * cfg.num_layers + 1
    valid = torch.arange(C)[None] < clens[:, None]
    diff = (res["cuda"][0][valid] - res["cpu"][0][valid]).abs().max()
    assert diff.item() < 1e-4
    for n in ("k", "v"):
        d = (res["cuda"][1][n][:, :-1] - res["cpu"][1][n][:, :-1]).abs()
        assert d.max().item() < 1e-5


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_and_prefix_any_split_count_are_right_and_bitwise(
        cuda, dtype, splits):
    """Forced split counts, from 1 to a split a page column: each call
    within the tolerance and bitwise equal to a second run (the merge is
    ordered); one launch a call; the tickets are left zero."""
    from repro_torch.kernels.paged_attn import _TICKETS, _attn_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tol = 1e-5 if dtype == torch.float32 else 4e-2
    q, k, v, tables, st, lens = _prefill_inputs(
        cuda, 2, 4, 64, dtype, starts=[700, 13, 0], chunks=[64, 37, 0])
    plan = _attn_plan(3, 64 * 4, 2, tables.shape[1], 16, 64, 64,
                      q.element_size(), sms, prefill=True, splits=splits)
    n0 = ops.launch_counts()["paged_prefill"]
    a = (q, k, v, tables, st, lens)
    got = paged_prefill_cuda(*a, scale=0.125, plan=plan)
    again = paged_prefill_cuda(*a, scale=0.125, plan=plan)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_prefill"] == n0 + 2
    assert torch.equal(got, again)
    want = paged_prefill_attention_plain(*a, scale=0.125)
    assert (got.float() - want.float()).abs().max().item() <= tol

    q, k, v, pages, plens = _prefix_inputs(cuda, 2, 4, 64, dtype, P=45)
    plan = _attn_plan(1, 8 * 4, 2, pages.shape[0], 16, 64, 64,
                      q.element_size(), sms, splits=splits)
    a = (q, k, v, pages, plens)
    got = paged_prefix_cuda(*a, scale=0.125, plan=plan)
    again = paged_prefix_cuda(*a, scale=0.125, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _states_close(got, shared_prefix_attention_plain(*a, scale=0.125), tol)
    assert (got[1][3] == NEG).all() and (got[2][3] == 0).all()
    assert not _TICKETS[q.device].any()


def _unaligned(x):
    """The same values in storage one element off a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 != 0
    return y


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("hd", [64, 66])
def test_prefill_and_prefix_on_unaligned_arenas(cuda, hd, dtype, tol):
    """Arenas and queries off the 16-byte boundary (and hd = 66, whose rows
    are no 16-byte multiple in either type) take the element copies: the
    same results as the plain versions."""
    q, k, v, tables, st, lens = _prefill_inputs(cuda, 2, 4, hd, dtype)
    q, k, v = _unaligned(q), _unaligned(k), _unaligned(v)
    scale = hd ** -0.5
    got = paged_prefill_cuda(q, k, v, tables, st, lens, scale=scale)
    want = paged_prefill_attention_plain(q, k, v, tables, st, lens,
                                         scale=scale)
    assert (got.float() - want.float()).abs().max().item() <= tol
    q, k, v, pages, plens = _prefix_inputs(cuda, 2, 4, hd, dtype)
    k, v = _unaligned(k), _unaligned(v)
    _states_close(paged_prefix_cuda(q, k, v, pages, plens, scale=scale),
                  shared_prefix_attention_plain(q, k, v, pages, plens,
                                                scale=scale), tol)


def test_prefill_and_prefix_take_unequal_hd_and_hd_v(cuda):
    """hd = 64 with hd_v = 256, and hd = 200 with hd_v = 40: the kernel's
    width is the larger, rounded up; the rest zero-padded."""
    for hd, hd_v in ((64, 256), (200, 40)):
        q, k, v, pages, plens = _prefix_inputs(cuda, 2, 4, hd,
                                               torch.bfloat16, hd_v=hd_v)
        got = paged_prefix_cuda(q, k, v, pages, plens, scale=0.1)
        assert got[0].shape == (8, 8, hd_v)
        _states_close(got, shared_prefix_attention_plain(
            q, k, v, pages, plens, scale=0.1), 4e-2)
        lengths = [s + c for s, c in zip(PREFILL_STARTS, PREFILL_CHUNKS)]
        tables = torch.zeros((5, 3), dtype=torch.int32, device="cuda")
        tables[:] = pages[:3]
        lens = torch.tensor([min(n, 48) for n in lengths], dtype=torch.int32,
                            device="cuda")
        st = torch.clamp(lens - torch.tensor(PREFILL_CHUNKS, device="cuda"),
                         min=0).int()
        qp = torch.randn((5, 16, 8, hd), generator=cuda, device="cuda") \
            .to(torch.bfloat16)
        got = paged_prefill_cuda(qp, k, v, tables, st, lens, scale=0.1)
        want = paged_prefill_attention_plain(qp, k, v, tables, st, lens,
                                             scale=0.1)
        assert (got.float() - want.float()).abs().max().item() <= 4e-2


def test_prefill_and_prefix_refuse_before_or_at_launch(cuda):
    """hd_v past 256 raises before any launch; a plan the kernel does not
    take (a width other than its own) is refused at launch and raises;
    neither is counted."""
    from repro_torch.kernels.paged_attn import _attn_plan
    n0 = ops.launch_counts()
    q, k, v, pages, plens = _prefix_inputs(cuda, 1, 4, 64, torch.bfloat16,
                                           hd_v=512)
    with pytest.raises(ValueError, match="hd, hd_v <= 256"):
        paged_prefix_cuda(q, k, v, pages, plens, scale=0.1)
    q, k, v, tables, st, lens = _prefill_inputs(cuda, 2, 4, 64,
                                                torch.bfloat16)
    wide = torch.zeros(k.shape[:3] + (300,), dtype=k.dtype, device="cuda")
    with pytest.raises(ValueError, match="hd, hd_v <= 256"):
        paged_prefill_cuda(q, k, wide, tables, st, lens, scale=0.1)
    wrong = _attn_plan(5, 256, 2, tables.shape[1], 16, 128, 128, 2, 132,
                       prefill=True)
    with pytest.raises(RuntimeError, match="paged prefill attention"):
        paged_prefill_cuda(q, k, v, tables, st, lens, scale=0.1, plan=wrong)
    n1 = ops.launch_counts()
    assert n1["paged_prefill"] == n0["paged_prefill"]
    assert n1["paged_prefix"] == n0["paged_prefix"]
