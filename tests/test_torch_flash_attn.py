"""Flash attention: the port's plain forward and backward against the
reference's Pallas kernels (interpret mode) and its oracle
(``kernels/ref.py::flash_attention_ref``), on the reference's own cases
(``tests/test_flash_attn.py``: ragged lengths, MQA and GQA groups,
hd_v != hd, bidirectional, bq != bk, a single block) and at the widths
past 128 that the port trains (MLA's 192 / 128, gemma-2b's 256), the same
numpy inputs into both packages.

Tolerances are the reference's own for its kernel against its oracle:
2e-6 (f32) and 2e-2 (bf16) on the forward, 3e-5 absolute + 1e-3 relative
on the gradients.  The plain version repeats the Pallas kernels' block
arithmetic, so it meets them against the kernels too; what differs is
the CPU's summation order inside each block product.  The kv blocks past
every query row get exactly zero dk/dv, and a causal output does not
depend on later keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import _flash_fwd
from repro.kernels.flash_attn import _pairs as j_pairs
from repro.kernels.ops import flash_attention as j_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch import dispatch
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import (_pairs, _split_bf16,
                                            flash_fwd_plain)

CASES = [
    # B, Sq, Skv, H, KVH, hd, hd_v, causal, bq, bk
    (2, 256, 256, 4, 2, 64, 64, True, 128, 128),
    (1, 200, 200, 4, 1, 32, 48, True, 128, 64),    # ragged + MQA + hd_v!=hd
    (2, 128, 256, 4, 4, 64, 64, False, 64, 128),   # cross-attn
    (1, 300, 300, 2, 2, 64, 64, True, 64, 128),    # bq != bk, ragged
    (1, 64, 64, 8, 2, 128, 128, True, 64, 64),     # single block
]
# the widths past 128 that the kernels split into 128-column slices:
# MLA's expanded heads (192 / 128) and gemma-2b's (256, MQA)
WIDE = [
    (1, 96, 96, 4, 4, 192, 128, True, 64, 64),
    (1, 80, 80, 4, 1, 256, 256, True, 64, 32),
]
IDS = [str(c[:8]) for c in CASES]
WIDE_IDS = [str(c[:8]) for c in WIDE]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(case, seed, dtype=np.float32):
    B, Sq, Skv, H, KVH, hd, hd_v = case[:7]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KVH, hd_v)).astype(np.float32))


def _pad(x, n):
    return jnp.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0), (0, 0)))


@pytest.mark.parametrize("n_q,n_k,bq,bk,causal", [
    (1, 1, 64, 64, True), (4, 4, 64, 64, True), (3, 5, 128, 64, True),
    (2, 4, 64, 64, True), (5, 3, 64, 128, False), (3, 2, 256, 64, True)])
@pytest.mark.parametrize("order", ["i", "j"])
def test_pair_order_is_the_reference(n_q, n_k, bq, bk, causal, order):
    i, j, start, emit = j_pairs(n_q, n_k, bq, bk, causal, order)
    want = list(zip(i.tolist(), j.tolist(), start.astype(bool).tolist(),
                    emit.astype(bool).tolist()))
    assert _pairs(n_q, n_k, bq, bk, causal, order) == want


@pytest.mark.parametrize("case", CASES + WIDE, ids=IDS + WIDE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_and_oracle(case, dtype):
    B, Sq, Skv, H, KVH, hd, hd_v, causal, bq, bk = case
    q, k, v = _inputs(case, 0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    scale = 1.0 / hd ** 0.5
    n_q, n_k = -(-Sq // bq), -(-Skv // bk)
    jo, jlse = _flash_fwd(_pad(jq, n_q * bq), _pad(jk, n_k * bk),
                          _pad(jv, n_k * bk), causal=causal, scale=scale,
                          kv_len=Skv, bq=bq, bk=bk, interpret=True)
    to, tlse = flash_fwd_plain(tq, tk, tv, causal=causal, scale=scale,
                               bq=bq, bk=bk)
    assert to.dtype == tdt and tuple(to.shape) == (B, Sq, H, hd_v)
    tol = 2e-6 if dtype == "float32" else 2e-2
    ref = np.asarray(flash_attention_ref(jq, jk, jv, causal=causal),
                     np.float32)
    got = to.float().numpy()
    np.testing.assert_allclose(got, np.asarray(jo, np.float32)[:, :Sq],
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    # lse is f32 in both packages whatever the operand type
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :, :Sq],
                               atol=2e-6, rtol=2e-6)
    # the public wrapper clamps the blocks and scales by hd**-0.5
    with torch.no_grad():
        wo = ops.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                                 block_k=bk)
    assert torch.equal(wo, to)


def _loss_grads_torch(q, k, v, causal, bq, bk):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    torch.sin(ops.flash_attention(*ts, causal=causal, block_q=bq,
                                  block_k=bk)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", CASES[:4] + WIDE, ids=IDS[:4] + WIDE_IDS)
def test_grads_match_pallas_vjp(case):
    *_, causal, bq, bk = case
    q, k, v = _inputs(case, 1)

    def f(q, k, v):
        return jnp.sum(jnp.sin(j_flash(q, k, v, causal=causal, block_q=bq,
                                       block_k=bk, interpret=True)))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                             for a in (q, k, v)))
    got = _loss_grads_torch(q, k, v, causal, bq, bk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=3e-5, rtol=1e-3)


def test_kv_blocks_past_every_query_get_zero_grads():
    """Causal, Skv > Sq: kv rows past the last query are attended by no
    row; their dk/dv are exactly zero, as the reference's j-order visit of
    an empty kv block writes them."""
    case = (1, 64, 256, 4, 2, 32, 32, True, 64, 64)
    q, k, v = _inputs(case, 2)
    got = _loss_grads_torch(q, k, v, True, 64, 64)

    def f(q, k, v):
        return jnp.sum(jnp.sin(j_flash(q, k, v, causal=True, block_q=64,
                                       block_k=64, interpret=True)))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                             for a in (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=3e-5, rtol=1e-3)
    assert not np.any(got[1][:, 64:]) and not np.any(got[2][:, 64:])
    assert np.abs(got[1][:, :64]).max() > 0


def test_causal_ignores_future_tokens():
    """Perturbing k/v beyond position t does not change the output at t."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 32))
                                .astype(np.float32)) for _ in range(3))
    noise = torch.from_numpy(rng.standard_normal((1, 64, 2, 32))
                             .astype(np.float32))
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:] += noise
    v2[:, 64:] += 10 * noise
    with torch.no_grad():
        o1 = ops.flash_attention(q, k, v, causal=True, block_q=64,
                                 block_k=64)
        o2 = ops.flash_attention(q, k2, v2, causal=True, block_q=64,
                                 block_k=64)
    assert torch.equal(o1[:, :64], o2[:, :64])
    assert (o1[:, 64:] - o2[:, 64:]).abs().max().item() > 1e-3


def test_cpu_runs_the_plain_versions_only():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(CASES[4], 4))
    ops.reset_counts()
    ops.flash_attention(q, k, v, causal=True, block_q=64,
                        block_k=64).sum().backward()
    counts = ops.launch_counts()
    assert counts["flash_fwd"] == counts["flash_dq"] == \
        counts["flash_dkv"] == 0
    assert counts["plain_calls"] == 3            # forward, dq, dk/dv
    with dispatch.use(execute="kernel"), pytest.raises(ValueError):
        ops.flash_attention(q, k, v)
    ops.reset_counts()


def test_bf16_split_keeps_p_within_2e_minus_17():
    """The bf16 dk/dv kernel multiplies do by p as hi + lo, two bf16
    operands: on seeded p over [2^-60, 1] (and 0 and 1 exactly) hi + lo
    is p to within 2^-17 of |p|, hi is bf16(p), and dv = hi^T do + lo^T
    do (f32, as the tensor cores sum exact bf16 products) is the f32
    p^T do of the reference's dv to within 2^-17 of |p|^T |do| and an
    f32 summation's error."""
    rng = np.random.default_rng(6)
    p = np.exp2(-rng.uniform(0, 60, (64, 64))).astype(np.float32)
    p[0, :2] = (0.0, 1.0)
    tp = torch.from_numpy(p)
    hi, lo = _split_bf16(tp)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, tp.to(torch.bfloat16))
    back = hi.double() + lo.double()
    assert bool(((back - tp.double()).abs() <=
                 2.0 ** -17 * tp.double().abs()).all())
    assert (back[0, :2] == torch.tensor([0.0, 1.0], dtype=torch.float64)).all()
    do = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)) \
        .to(torch.bfloat16).float()
    dv = hi.float().t() @ do + lo.float().t() @ do
    exact = tp.double().t() @ do.double()
    bound = (2.0 ** -17 + 64 * 2.0 ** -24) * (tp.double().t().abs() @
                                              do.double().abs())
    assert bool(((dv.double() - exact).abs() <= bound).all())
    # rounding p alone to bf16 (the forward's p @ v) would miss by ~2^-9
    one = hi.float().t() @ do
    assert bool(((one.double() - exact).abs() > bound).any())
