// Flash attention for Hopper (sm_90a): the forward pass and the two
// backward kernels, full-sequence causal or bidirectional GQA attention.
//
// Replaces, in kernels/flash_attn.py of the JAX package:
//   _flash_fwd (_fwd_kernel)                      -> flash_fwd_launch
//   _flash_bwd, the dq pallas_call (_dq_kernel)    -> flash_dq_launch
//   _flash_bwd, the dk/dv pallas_call (_dkv_kernel) -> flash_dkv_launch
//
// Layouts (the reference's): q (B, Sq, H, hd), k (B, Skv, KVH, hd), v (B,
// Skv, KVH, hd_v), o and do (B, Sq, H, hd_v), lse and delta (B, H, Sq) f32,
// dq like q, dk like k, dv like v.  Query head h reads kv head h / G, G = H
// / KVH.  A causal mask compares absolute positions (column <= row); every
// column at or past Skv is masked.  Nothing is padded: each kernel masks
// its ragged tiles itself.
//
// Arithmetic, as the reference's: scores q.k * scale in f32; masked scores
// give p = 0; p is rounded to v's type before p @ v while l sums the f32 p;
// l is clamped at 1e-30; lse = m + log(l); ds = p (dp - delta) * scale is
// rounded to the operand type before ds @ k and ds^T @ q, and dv = p^T @ do
// in f32; each query head's dk/dv is rounded to the output type before the
// group sum, so a kv row past every query gets exact zeros.  Every kernel
// takes exp as exp2 of log2(e)-scaled scores (the f32 forward keeps m in
// log2 units and returns lse = m ln 2 + log l; the bf16 one keeps the raw
// scores' max and returns m scale + log l).  Only the summation order and
// that rounding differ from the reference's (past W = 128 the f32 kernels
// sum each score as four quarters, (q0 + q1) + (q2 + q3), the forward, dq
// and dk/dv alike, so their scores agree bit for bit).
//
// What bounds it on the H100: operations.  At training shapes (S = 1024,
// hd = 64) every q row meets up to 1024 keys, about 4 hd flops a pair each
// way, far above the bytes of q, k, v and o.  f32 runs full-f32 CUDA-core
// FMAs (67 TFLOP/s peak), never TF32.  bf16 runs on the tensor cores (989
// TFLOP/s dense), in kernels of its own below (flash_fwd_tc_kernel,
// flash_dq_tc_kernel, flash_dkv_tc_kernel).
//
// The bf16 kernels (mma.sync.m16n8k16, bf16 in, f32 accumulate,
// mma_bf16.cuh's register layout; wgmma is not used):
//  * Tiles stay bf16 in shared memory (half the bytes of a widened tile):
//    rows 2 W + 16 bytes apart, so ldmatrix reads no bank twice; 16-byte
//    cp.async copies where a row is a multiple of 16 bytes on a 16-byte
//    boundary, else 2-byte loads; columns past hd / hd_v are zero, so any
//    hd (32/48, 100/50, 112, 160/96, 200) runs the W = 64, 128 or 256 tile.
//  * The forward: a CTA of 64 or 128 query rows, 4 or 8 warps; a warp's
//    16 rows compute S = Q K^T (K through ldmatrix), the online softmax in
//    registers (exp2 of log2(e)-scaled scores, one FFMA and an exp2 a
//    score, each thread's share of l summed over its quad at the end), and
//    P, rounded to bf16 in registers, is the A operand of O += P V (V
//    through ldmatrix.trans).  Q's fragments stay in registers up to W =
//    128 and are re-read from shared memory each tile at 256, where the
//    128 f32 accumulators a lane of a 256-wide O take those registers: a
//    CTA owns all of o's columns, no slices.  A 2-stage ring: 46,080 /
//    87,040 / 168,960 bytes with 64 rows (W = 64 / 128 / 256), 55,296 /
//    104,448 / 202,752 with 128.  The plan takes 128 rows where the call
//    has at least one such CTA an SM, else 64.  (Warps of 32 rows, two
//    m-tiles sharing each K / V fragment, measured 2-3% faster in 128-row
//    CTAs at llama's heads and slower in 64-row ones, for a second
//    template: not kept.)
//  * Branch-free inner loops: every k-tile and n-tile of the W-wide tiles
//    runs (the zero columns past hd cost products, not branches), and a
//    masked tile compares each column with its row's limit, computed once.
//    launch/bench_flash.py measured both worth 10-25% (PERF.md §6).
//  * dk/dv: a warp's 16 kv rows compute S^T = K q^T and dP^T = V do^T, so
//    p^T and ds^T land in accumulator layout and become, in registers, the
//    A operands of dv += p^T do and dk += ds^T q (do and q through
//    ldmatrix.trans).  The reference's dv takes p in f32: p^T runs as hi +
//    lo, two bf16 operands and two products, which keeps p within 2^-17 of
//    itself; ds is rounded to bf16 as the reference rounds it.  Queries
//    come in passes of 64 (W = 64) or 32, so the score tiles take 32 or 16
//    registers beside the 64 / 128 of dk and dv.  At W = 256 dk + dv would
//    need 256 f32 a lane: each CTA owns a 128-column slice (blockIdx.y),
//    and each slice recomputes S^T and dP^T over the whole head dim, so two
//    slices do 1.5x the products of one unsliced pass (3072 against 2048
//    flops a (query, key) pair at hd 256).  The plan takes 64 kv rows and
//    2 stages up to W = 128, 128 rows and 1 stage at 256 (8 warps an SM
//    either way).
//  * dq: the dk/dv design transposed.  A warp's 16 query rows compute S =
//    q K^T and dP = do V^T in passes of 64 keys (W = 64) or 32, so p and
//    ds land in accumulator layout and ds, rounded to bf16 as the
//    reference rounds it (no hi + lo: the reference's dq takes ds in
//    bf16), is the A operand of dq += ds K (K through ldmatrix.trans).  q
//    and do are re-read from shared memory each pass; at W = 256 dq's 128
//    f32 accumulators a lane take the registers (as the forward's o): a
//    CTA owns every column, nothing is recomputed.  64 or 128 query rows
//    a CTA (the forward's rule) and 1 or 2 K/V stages (2 where they fit:
//    55,296 / 104,448 / 202,752 bytes with 64 rows, 73,728 / 139,264 with
//    128 up to W = 128, 202,752 with 1 stage at 256).
//  * What bounds them: operations, as in f32, now at the tensor cores'
//    rate.  What holds them below it is latency: mma.sync, the softmax
//    and the ldmatrix loads of a tile follow one another in each warp,
//    and 8-16 warps an SM hide only part of it (no warp specialisation,
//    no wgmma).
//
// The design of the f32 kernels (kernels/flash_attn.py::_flash_plan picks
// the forward's and dk/dv's ring stages, the rows of a dq or dk/dv CTA and
// the heads a dk/dv CTA walks; a forward CTA holds 64 query rows, three
// CTAs an SM at W = 64; dq's ring has 2 stages up to W = 128):
//  * Register-blocked products.  A warp owns 16 rows of a tile; lane (ly,
//    lx) = (lane / 8, lane % 8) owns rows ly + 4i (i < 4) and columns lx +
//    8j (j < 8) of a 64-column score tile, and columns 32c + 4lx .. +3 (c <
//    NCV) of an output tile.  A score tile is the product of two row-major
//    tiles read as float4 along the head dim (12 LDS.128 for 128 FFMA); an
//    output tile reads p as float4 along its columns against float4 rows of
//    V (4 + 4 NCV loads for 32 NCV FFMA a column step).  Row strides W + 4
//    (W = 32 NCV) and 72 keep every read and p's stores conflict-free.
//  * A warp's rows never leave it: the 8 lanes of a row reduce its max and
//    sum with __shfl_xor_sync and keep m, l and the rescale (or dq's lse
//    and delta) in registers, and p (and in dq and dk/dv ds) passes through
//    the warp's own rows of a shared tile, so a tile costs one barrier, the
//    ring's.
//  * A cp.async ring (1 or 2 stages) brings K/V tiles (forward, dq) or q,
//    do, lse and delta tiles (dk/dv) ahead of the products: 16-byte copies
//    for rows on 16-byte boundaries, 4-byte ones for other rows.
//  * Masks only where a warp's part of a tile needs them (the causal
//    diagonal, the ragged edges); a dq or dk/dv warp with nothing live
//    (causally, or all its rows past the end) skips the tile.
//  * Heaviest first: a 1-D grid whose leading CTAs walk the most tiles.
//  * dq: one CTA per (64 or 128 query rows, head, batch) holds its q and
//    do tiles and computes s = q K^T -> p, dp = do V^T -> ds, dq += ds K,
//    the kv tiles in order (no atomics, no split of the walk).
//  * dk/dv: one CTA per (64 or 128 kv rows, `heads` query heads, batch)
//    holds its K and V tiles and computes s = K q^T -> p, dv += p^T do,
//    dp = V do^T -> ds, dk += ds^T q.  Each head's dk/dv is rounded to the
//    output type; a kv head's G heads are summed in g order in f32, within
//    a CTA and then over the group's CTAs by a second kernel reading their
//    partials from an f32 scratch (summing across a thread-block cluster
//    through distributed shared memory measured slower: PERF.md).
//  * hd or hd_v past 128 (up to WIDE = 256; hd 192 runs the 256-wide
//    tiles): a 4 x 4 NCV accumulator a thread per output would pass the
//    register file (dk + dv at W = 256: 256 registers) and the tiles the
//    227 KB of a CTA.  The first design (each CTA one 128-column
//    slice of its output, rebuilding the scores over the whole head dim,
//    K / V chunks through one unoverlapped slot) spent 21-38% of its cycles
//    waiting on its copies and rebuilt S (and dP) once a slice: 1.5x the
//    forward's products at hd 256, 1.67x dq's (launch/probe_flash.py).  Now
//    all three (flash_fwd_pair_kernel, flash_dq_pair_kernel,
//    flash_dkv_pair_kernel) run on the two CTAs of a thread-block cluster,
//    each owning half of hd and of hd_v (half_cols: MLA's 192 / 128 splits
//    96 + 96 and 64 + 64, so the pair's work is even), 8 warps a CTA, one
//    CTA an SM (4 warps, one a scheduler, ran the dk/dv's products at ~45%
//    of the FFMA rate).  A CTA keeps those columns of its resident rows
//    (the forward's 128 q rows, dq's 64 q and do rows, dk/dv's 64 K and V
//    rows) and streams the same columns of the other operands in 32-row
//    tiles through a 2-stage ring: the forward's and dq's K and V by two
//    tensor copies (TMA) a tile, issued by one thread, dk/dv's q and do by
//    a bulk copy a row (cp.async where a row is not a 16-byte multiple on
//    a 16-byte boundary).  Each sums a tile's scores over the quarters of
//    its half of the head dim, quarter + quarter, and sends the half into
//    its partner's shared memory (st.async on the partner's mbarrier, two
//    buffers by parity), where it is added to the partner's half: an IEEE
//    add commutes, so both CTAs hold the same S (and dP), and the three
//    kernels' scores agree bit for bit.  The forward's warps each own 16
//    query rows and all of their CTA's columns (the o accumulators fit),
//    summing the quarters themselves; dq's and dk/dv's warps come in pairs
//    over 16 rows, a quarter each, whose quarters meet in shared memory.
//    Each warp then forms p (and ds: dq's pair splits the tile's keys
//    between its two warps) and adds P V, ds K or p^T do and ds^T q into
//    its columns of o, dq or dk and dv.  Every product runs once.
//    188,576 / 211,104 / 221,728 bytes a forward / dq / dk/dv CTA with 2
//    stages.  Up to W = 128 nothing of this runs: blockIdx.y is 0 and the
//    tiles are the ones above.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr int KT = 64;         // kv rows (forward, dq) / query rows (dk/dv) a tile
constexpr int FWD_THREADS = 128;  // 64 query rows of a forward CTA
constexpr int LDP = KT + 8;    // row stride of a p / ds tile
constexpr int DQ_STAGES = 2;   // K/V tiles in dq's cp.async ring up to W = 128
constexpr int MAX_SMEM = 232448;
constexpr int CW = 128;        // a column slice / chunk of the head dim past W = 128
constexpr int WIDE = 256;      // the tile width of every call with hd or hd_v > 128
constexpr int WQT = 32;        // query rows of a ring tile of the paired f32 dk/dv
constexpr int WKT = 32;        // kv rows of a ring tile of the paired f32 forward and dq
constexpr int PAIR_HEAD = 40;  // floats before the paired forward's / dq's tiles: four
                               // mbarriers, and slack to align the tiles to 128 bytes
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the reference's casts to the operand type
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every committed group landed: with 1 or 2 ring stages, the tile about to
// be used is the last one committed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// `n` rows of d <= W f32 elements (row r at src + (row0 + r) * stride)
// into dst (row stride W + 4 floats); rows at or past `rows` and the
// columns from d to d rounded up to 4 are zero: 16-byte cp.async copies
// (vec: d % 4 == 0 and 16-byte aligned rows) or 4-byte ones.  (bf16 tiles
// stay bf16: copy_tc.)
template <typename T, int W>
__device__ __forceinline__ void copy_rows(float* dst, const T* __restrict__ src, long long stride,
                                          int row0, int n, int rows, int d, bool vec, int tid,
                                          int nthr) {
  constexpr int W4 = W / 4;
  const int d4 = (d + 3) >> 2;
  for (int idx = tid; idx < n * W4; idx += nthr) {
    const int r = idx / W4, c = (idx % W4) * 4;
    if (c >= 4 * d4) continue;
    const int gr = row0 + r;
    float* s = dst + r * (W + 4) + c;
    const bool row_ok = gr < rows;
    const T* g = src + (row_ok ? (long long)gr * stride + c : 0);
    static_assert(sizeof(T) == 4, "the CUDA-core kernels run f32");
    if (vec) {
      cp_async16(s, g, row_ok ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = row_ok && c + u < d;
        cp_async4(s + u, ok ? g + u : src, ok ? 4 : 0);
      }
    }
  }
}

// KT f32 values (lse or delta of a query tile) from src + row0; zero past
// `rows`.
__device__ __forceinline__ void copy_vec(float* dst, const float* __restrict__ src, int row0,
                                         int rows, int tid, int nthr) {
  for (int i = tid; i < KT; i += nthr) {
    const bool ok = row0 + i < rows;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

// a thread-block cluster's CTAs (the paired f32 dk/dv): the cluster barrier
// in halves, a shared-memory address as the same address in another CTA,
// and mbarriers that count the bytes another CTA stores here
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16, 16-byte aligned both sides) from global
// memory into this CTA's shared memory by the bulk-copy (TMA) engine,
// completing them on mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// a box of a 4-D tensor map (TMA) at coordinates (c0, c1, c2, c3) into
// this CTA's shared memory (128-byte aligned), completing on mbarrier
// `bar`; elements past the tensor's edges land as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// this thread's earlier shared-memory stores ordered before its later
// bulk copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 16 bytes into another CTA's shared memory (`addr`, from map_rank),
// completing them on its mbarrier `bar`
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// register-blocked products (lane (ly, lx) of a warp owning 16 rows)
// ---------------------------------------------------------------------------

// acc[i][j] = sum_{k < k4} A[4i * lda + k] * Bm[8j * ldb + k] from zero, k
// ascending: A points at the lane's first row (row ly of the warp's 16),
// Bm at its first column (row lx of the other operand); both row-major
// along k, k4 a multiple of 4.  NJ columns a lane: a 64-column score tile
// (8) or a 32-column one (4).
template <int NJ>
__device__ __forceinline__ void nt_product(float (&acc)[4][NJ], const float* A, int lda,
                                           const float* Bm, int ldb, int k4) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < k4; k += 4) {
    float4 a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + 4 * i * lda + k);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = *reinterpret_cast<const float4*>(Bm + 8 * j * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4c + e] += sum_{k < KN} P[4i * ldp + k] * V[k * ldv + 32c + e]:
// P points at the lane's first row of a p / ds tile, V at column 4lx of
// the B operand (KN rows, row-major along the output columns).  NT = 1
// adds a 16-column tail, columns 32 NCV + 2lx and + 1 in acc[i][4 NCV +
// e] from V2 (column 32 NCV + 2lx): a 48-column quarter without 16
// columns of waste.  Each column's sum runs k ascending whatever its lane.
template <int NCV, int KN = KT, int NT = 0>
__device__ __forceinline__ void nn_product(float (&acc)[4][4 * NCV + 2 * NT], const float* P,
                                           int ldp, const float* V, int ldv,
                                           const float* V2 = nullptr) {
#pragma unroll 2
  for (int k = 0; k < KN; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(P + 4 * i * ldp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 v[NCV];
#pragma unroll
      for (int c = 0; c < NCV; ++c)
        v[c] = *reinterpret_cast<const float4*>(V + (k + kk) * ldv + 32 * c);
      float2 w;
      if constexpr (NT > 0) w = *reinterpret_cast<const float2*>(V2 + (k + kk) * ldv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = kk == 0 ? p[i].x : kk == 1 ? p[i].y : kk == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int c = 0; c < NCV; ++c) {
          acc[i][4 * c + 0] = fmaf(a, v[c].x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(a, v[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(a, v[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(a, v[c].w, acc[i][4 * c + 3]);
        }
        if constexpr (NT > 0) {
          acc[i][4 * NCV + 0] = fmaf(a, w.x, acc[i][4 * NCV + 0]);
          acc[i][4 * NCV + 1] = fmaf(a, w.y, acc[i][4 * NCV + 1]);
        }
      }
    }
  }
}

// 2^x, flushing results below 2^-126 to 0: what p needs (exp2f adds
// denormal handling around the same MUFU.EX2)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a launch: shapes, plan and which rows may take 16-byte copies
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o1, *o2;     // o (forward), dq, or dk, dv
  float* lse_out;
  float* ws;         // dk/dv: the f32 partials of a kv head's group, or null
  int B, Sq, Skv, H, KVH, hd, hdv, causal;
  float scale;
  int rows, stages, heads, parts;  // rows: the query / kv rows of a CTA
  int slices;        // past W = 128 2: an f32 CTA pair, or bf16 dk/dv's CW-column slices
                     // (blockIdx.y); 1 up to W = 128
  int vec_q, vec_k, vec_v, vec_o;
  int tma;           // the paired forward's / dq's K / V tiles by tensor maps
};

__host__ __device__ constexpr int cdiv_c(int a, int b) { return (a + b - 1) / b; }

// the columns of k / q / dk (of v / do / dv) each CTA of a paired f32
// dk/dv owns: half of d rounded up to 8, so each half and quarter starts
// on a 16-byte boundary (at most CW: d <= WIDE)
__host__ __device__ constexpr int half_cols(int d) { return ((d + 1) / 2 + 7) & ~7; }

// shared memory (bytes) of a forward CTA (64 query rows), of a dq CTA of
// `rows` query rows and of a dk/dv CTA of `rows` kv rows, at tile width W
// and `stages` ring stages (dq: DQ_STAGES up to W = 128).  At W = WIDE
// each is a CTA of a pair (CW + 4 floats a row of its columns) with its
// four mbarriers (forward and dq: PAIR_HEAD floats with the slack that
// aligns their tiles to 128 bytes).  The forward holds its 128 q rows, their p (WKT + 8
// floats a row), two buffers of the partner's halves of S (WKT floats a
// row each) and `stages` WKT-key K / V tiles (flash_fwd_pair_kernel); dq
// its `rows` q and do rows, their ds tile, its warps' quarters and two buffers of the partner's halves of S and dP (128 floats
// a row each) and `stages` K / V tiles (flash_dq_pair_kernel); dk/dv its K
// / V rows, p^T / ds^T of each column group (WQT + 8), quarters and halves
// of S^T and dP^T and `stages` WQT-query q / do / lse / delta tiles
// (flash_dkv_pair_kernel)
__host__ __device__ constexpr int fwd_smem(int W, int stages) {
  return W > CW ? 4 * (PAIR_HEAD + 128 * (CW + 4) + 128 * (WKT + 8) + 2 * WKT * 128 +
                       stages * 2 * WKT * (CW + 4))
                : 4 * (64 * (W + 4) + stages * KT * 2 * (W + 4) + 64 * LDP);
}
__host__ __device__ constexpr int dq_smem(int rows, int W, int stages) {
  return W > CW ? 4 * (PAIR_HEAD + 2 * rows * (CW + 4) + rows * (WKT + 8) + 2 * 128 * rows +
                       stages * 2 * WKT * (CW + 4))
                : 4 * (2 * rows * (W + 4) + rows * LDP + DQ_STAGES * 2 * KT * (W + 4));
}
__host__ __device__ constexpr int dkv_smem(int rows, int W, int stages) {
  return W > CW ? 4 * (8 + 2 * rows * (CW + 4) + 2 * rows * (WQT + 8) + 2 * 128 * rows +
                       stages * (2 * WQT * (CW + 4) + 2 * WQT))
                : 4 * (2 * rows * (W + 4) + rows * LDP + stages * (2 * KT * (W + 4) + 2 * KT));
}

// bf16 tiles on the tensor cores stay bf16 in shared memory: a row of a
// D-wide tile takes 2 D bytes and 16 of padding, so the 8 rows an ldmatrix
// reads fall on distinct banks.  A forward CTA holds its `rows` query rows
// and `stages` K/V tiles; a dk/dv CTA its `rows` K and V rows and `stages`
// q / do tiles with their lse and delta; a dq CTA its `rows` q and do rows
// and `stages` K/V tiles.
__host__ __device__ constexpr int tc_stride(int D) { return 2 * D + 16; }
__host__ __device__ constexpr int fwd_tc_smem(int D, int rows, int stages) {
  return tc_stride(D) * (rows + stages * 2 * KT);
}
__host__ __device__ constexpr int dkv_tc_smem(int rows, int D, int stages) {
  return 2 * rows * tc_stride(D) + stages * (2 * KT * tc_stride(D) + 2 * KT * 4);
}
__host__ __device__ constexpr int dq_tc_smem(int rows, int D, int stages) {
  return tc_stride(D) * (2 * rows + stages * 2 * KT);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// One CTA of 4 warps holds BQ = 64 query rows of one (head, batch): CTA x
// = (tile t from the last, head h, batch b) = ((nqt - 1 - t) * B + b) * H
// + h, so every head's heaviest causal tile starts first.  At W = 64 three
// CTAs fit an SM with one ring stage (168 registers).  Tiles and the
// output are 32 NCV = W <= 128 wide (wider heads: flash_fwd_pair_kernel).
template <typename T, int NCV>
__global__ void __launch_bounds__(FWD_THREADS, NCV == 2 ? 3 : 1)
    flash_fwd_kernel(const Args a) {
  constexpr int W = 32 * NCV, LQ = W + 4, LV = W + 4, BQ = 64, nthr = FWD_THREADS;
  const int HB = a.H * a.B, nqt = cdiv_c(a.Sq, BQ);
  const int lin = blockIdx.x;
  const int q0 = (nqt - 1 - lin / HB) * BQ;
  const int h = lin % a.H, b = (lin / a.H) % a.B;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ly = lane >> 3, lx = lane & 7;
  const int r0 = warp * 16 + ly;  // the lane's rows: r0 + 4i
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                  // BQ x LQ
  float* Ps = Qs + BQ * LQ;        // BQ x LDP
  float* ring = Ps + BQ * LDP;     // stages x (K: KT x LQ, V: KT x LV)
  constexpr int slot = KT * (LQ + LV);

  const T* qg = static_cast<const T*>(a.q);
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const T* qb = qg + (long long)b * a.Sq * qstride + (long long)h * a.hd;
  const T* kb = kg + (long long)b * a.Skv * kstride + (long long)kvh * a.hd;
  const T* vb = vg + (long long)b * a.Skv * vstride + (long long)kvh * a.hdv;
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  const int n = cdiv_c(kv_end, KT), stages = a.stages;
  auto load = [&](int t) {
    float* st = ring + (t % stages) * slot;
    copy_rows<T, W>(st, kb, kstride, t * KT, KT, a.Skv, a.hd, a.vec_k, tid, nthr);
    copy_rows<T, W>(st + KT * LQ, vb, vstride, t * KT, KT, a.Skv, a.hdv, a.vec_v, tid, nthr);
  };
  copy_rows<T, W>(Qs, qb, qstride, q0, BQ, a.Sq, a.hd, a.vec_q, tid, nthr);
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  float o[4][4 * NCV], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NCV; ++c) o[i][c] = 0.f;
  }
  const int hd4 = (a.hd + 3) & ~3;
  const float sl2 = a.scale * LOG2E;  // scores in log2 units: p = 2^(x - m)
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const float* Ks = ring + (t % stages) * slot;
    const float* Vs = Ks + KT * LQ;
    const int j0 = t * KT;
    float s[4][8];
    nt_product(s, Qs + r0 * LQ, LQ, Ks + lx * LQ, LQ, hd4);
    const bool edge = j0 + KT > a.Skv || (a.causal && j0 + KT - 1 > q0 + warp * 16);
    // the four rows' max and sum reduced together over their 8 lanes
    float mx[4], corr[4], m_ref[4], sum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + 4 * i;
      mx[i] = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[i][j] * sl2;
        if (edge) {
          const int col = j0 + lx + 8 * j;
          if (!(col < a.Skv && (!a.causal || col <= row))) x = NEG;
        }
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      // a row with no live column yet subtracts 0: its masked p are 0
      m_ref[i] = m_new > 0.5f * NEG ? m_new : 0.f;
      corr[i] = exp2_ftz(m[i] - m_ref[i]);
      m[i] = m_new;
      sum[i] = 0.f;
      float* prow = Ps + (r0 + 4 * i) * LDP + lx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2_ftz(s[i][j] - m_ref[i]);
        sum[i] += p;
        prow[8 * j] = round_to<T>(p);  // p in v's type for p @ v
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int c = 0; c < 4 * NCV; ++c) o[i][c] *= corr[i];
    }
    __syncwarp();  // a row's p comes from the 8 lanes of its own warp
    nn_product<NCV>(o, Ps + r0 * LDP, LDP, Vs + 4 * lx, LV);
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }

  T* og = static_cast<T*>(a.o1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 4 * i;
    if (row >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = og + ((long long)b * a.Sq + row) * ostride + (long long)h * a.hdv;
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * c + 4 * lx + e;
        if (col < a.hdv) orow[col] = from_f<T>(o[i][4 * c + e] / lc);
      }
    if (lx == 0) a.lse_out[((long long)b * a.H + h) * a.Sq + row] = m[i] * LN2 + logf(lc);
  }
}

// Whether row group g (16 query rows from q0) of a paired f32 forward or
// dq CTA has something live in the kv tile from j0: its rows not all past
// Sq and, causally, not all left of the tile's first key.  The pair agrees
// on it, and a group dead at one tile stays dead, so the partner's halves
// of a group are sent, and expected, exactly where it is live.
__device__ __forceinline__ bool pair_live(const Args& a, int q0, int g, int j0) {
  const int w = q0 + 16 * g;
  return w < a.Sq && !(a.causal && j0 > w + 15);
}

// The kv tiles of a paired f32 forward or dq CTA: tile t of WKT keys into
// ring slot `st` (128-byte aligned), K's columns from ck and V's from cv of
// kv head kvh, batch b.  With tensor maps (a.tma: rows of 16-byte multiples
// on 16-byte boundaries; `mk`, `mv` from kv_map) thread 0 issues one tensor
// copy (TMA) of each, hk + 4 and hv + 4 columns by WKT rows, so the rows
// land hk + 4 and hv + 4 floats apart (4 mod 8: the 8 rows a lane group
// reads fall on distinct banks), completing on the slot's mbarrier `full`;
// the hardware zero-fills rows past Skv (a masked key's p is 0, and 0
// times stale bits could be NaN) and columns past hd / hd_v.  Else every
// thread issues its share of cp.async copies (rows CW + 4 floats apart) and
// thread 0 arrives on `full` with no bytes.
__device__ __forceinline__ void pair_load_kv(const Args& a, const CUtensorMap* mk,
                                             const CUtensorMap* mv, float* st, uint64_t* full,
                                             const float* kh, const float* vh,
                                             long long kstride, long long vstride, int j0, int b,
                                             int kvh, int ck, int cv, int hk, int hv, int dkw,
                                             int dvw, int tid) {
  float* vt = st + WKT * (CW + 4);
  if (a.tma) {
    if (tid == 0) {
      mbar_expect(full, 4u * WKT * (hk + hv + 8));
      tma_load_4d(st, mk, full, ck, kvh, j0, b);
      tma_load_4d(vt, mv, full, cv, kvh, j0, b);
    }
  } else {
    copy_rows<float, CW>(st, kh, kstride, j0, WKT, a.Skv, dkw, a.vec_k, tid, 256);
    copy_rows<float, CW>(vt, vh, vstride, j0, WKT, a.Skv, dvw, a.vec_v, tid, 256);
    if (tid == 0) mbar_expect(full, 0u);
  }
}

// A paired f32 forward's or dq's four mbarriers at `bars` (the partner's
// halves of even and odd tiles, then the ring's two slots, one arrival
// each) set in both CTAs before either stores into the other.
__device__ __forceinline__ void pair_start(uint64_t* bars, int tid) {
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();
  cluster_wait();
}

// The shared tiles of a paired f32 forward or dq CTA start 128 bytes
// aligned after its four mbarriers at `sm` (PAIR_HEAD floats in all).
__device__ __forceinline__ float* pair_tiles(float* sm) {
  return sm + 8 + ((128u - (smem_addr(sm + 8) & 127u)) & 127u) / 4;
}

// f32 forward at hd or hd_v > 128.  A thread-block cluster of two CTAs of 8
// warps per (128 query rows, head, batch); CTA x and the order of the
// tiles are flash_fwd_kernel's at 128 rows.  The CTA of cluster rank
// `half` (blockIdx.y) owns columns [half hk, (half + 1) hk) of q and k and
// [half hv, (half + 1) hv) of v and o (hk = half_cols(hd), hv =
// half_cols(hd_v)): it keeps those columns of its q rows resident and
// streams the same columns of K and V in tiles of WKT = 32 keys through a
// ring of 1 or 2 stages (pair_load_kv).  Warp w owns query rows 16w .. 16w
// + 15 and all of its CTA's columns.  It sums a tile's S = q K^T over each
// quarter of the head dim that dq's and dk/dv's warps own (columns [0,
// hk / 2) and [hk / 2, hk) of its half) apart and adds the two (quarter +
// quarter, the CTA's half), stores the half into the partner CTA's shared
// memory (st.async on the partner's mbarrier of the tile's parity: two
// buffers) and adds the partner's half: the same adds as dq's and dk/dv's,
// and an IEEE add commutes, so both CTAs hold the same S and the three
// kernels' scores agree bit for bit.  Each warp runs the online softmax of
// its rows (m and p: the same bits in both CTAs; each lane keeps its share
// of l, summed over the row's 8 lanes at the end) and adds P V into its
// CTA's columns of o, NV 32-column groups of accumulators a lane (2 at
// MLA's half of 64, 4 at gemma-2b's 128).  Every product runs once.  Rank 0
// writes lse.  (Two warps a row group, each owning a quarter, as dk/dv's,
// ran the softmax four times a row and took MLA's forward from 2.02 to 2.39
// ms: PERF.md.)
template <int NV>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(256, 1)
    flash_fwd_pair_kernel(const Args a, const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv) {
  constexpr int LC = CW + 4, LP = WKT + 8, BQ = 128;
  constexpr int SLOT = 2 * WKT * LC;
  const int HB = a.H * a.B, nqt = cdiv_c(a.Sq, BQ);
  const int lin = blockIdx.x;
  const int q0 = (nqt - 1 - lin / HB) * BQ;
  const int h = lin % a.H, b = (lin / a.H) % a.B;
  const int kvh = h / (a.H / a.KVH);
  const uint32_t half = cluster_rank(), other = half ^ 1u;
  const int hk = half_cols(a.hd), hv = half_cols(a.hdv);
  const int ck = half * hk, cv = half * hv;  // the CTA's first column of each
  const int dkw = max(0, min(hk, a.hd - ck)), dvw = max(0, min(hv, a.hdv - cv));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ly = lane >> 3, lx = lane & 7;
  const int r0 = warp * 16 + ly;  // the lane's rows: r0 + 4i
  // the quarters' widths, rounded up to 4 (the columns past dkw are zero)
  const int k4a = (min(hk / 2, dkw) + 3) & ~3, k4b = (max(0, dkw - hk / 2) + 3) & ~3;
  extern __shared__ __align__(16) float sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);  // the partner's halves of even / odd tiles
  uint64_t* full = bars + 2;        // K and V of the ring's slot landed
  float* Qs = pair_tiles(sm);       // BQ x LC: the CTA's columns of its q rows
  float* Ps = Qs + BQ * LC;         // p: BQ x LP, each warp its own rows
  float4* X = reinterpret_cast<float4*>(Ps + BQ * LP);  // [parity][warp][4][32]: the partner's halves
  float* ring = reinterpret_cast<float*>(X + 2 * 8 * 4 * 32);  // stages x (K, V)

  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const float* qh = static_cast<const float*>(a.q) + (long long)b * a.Sq * qstride +
                    (long long)h * a.hd + ck;
  const float* kh = static_cast<const float*>(a.k) + (long long)b * a.Skv * kstride +
                    (long long)kvh * a.hd + ck;
  const float* vh = static_cast<const float*>(a.v) + (long long)b * a.Skv * vstride +
                    (long long)kvh * a.hdv + cv;
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  const int n = cdiv_c(kv_end, WKT), stages = a.stages;
  // the K / V rows' strides in the ring: hk + 4 and hv + 4 by tensor
  // copies, CW + 4 by cp.async
  const int ldk = a.tma ? hk + 4 : LC, ldv = a.tma ? hv + 4 : LC;
  auto load = [&](int t) {
    pair_load_kv(a, &mk, &mv, ring + (t % stages) * SLOT, &full[t % stages], kh, vh, kstride,
                 vstride, t * WKT, b, kvh, ck, cv, hk, hv, dkw, dvw, tid);
  };
  pair_start(bars, tid);
  copy_rows<float, CW>(Qs, qh, qstride, q0, BQ, a.Sq, dkw, a.vec_q, tid, 256);
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);  // n >= 1: Skv > 0, and a causal CTA sees key 0
    cp_async_commit();
  }

  float o[4][4 * NV], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;  // the lane's share: its columns' p
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) o[i][c] = 0.f;
  }
  const float sl2 = a.scale * LOG2E;  // scores in log2 units: p = 2^(x - m)
  float* Pw = Ps + r0 * LP;           // the lane's first row of p
  const float* Qw = Qs + r0 * LC;
  const int wq = q0 + 16 * warp;      // the warp's first row
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    mbar_wait(&full[t % stages], (t / stages) & 1);
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const float* Kt = ring + (t % stages) * SLOT;
    const float* Vt = Kt + WKT * LC;
    const int j0 = t * WKT, par = t & 1;
    if (tid == 0) {  // the partner's live warps send 32 x 64 bytes each
      int live = 0;
#pragma unroll
      for (int g = 0; g < 8; ++g) live += pair_live(a, q0, g, j0);
      mbar_expect(&bars[par], 2048u * live);
    }
    if (pair_live(a, q0, warp, j0)) {
      const bool edge = j0 + WKT > a.Skv || (a.causal && j0 + WKT - 1 > wq);
      // S over each quarter of the CTA's half, then quarter + quarter
      float s[4][4], sb[4][4];
      nt_product(s, Qw, LC, Kt + lx * ldk, ldk, k4a);
      nt_product(sb, Qw + hk / 2, LC, Kt + lx * ldk + hk / 2, ldk, k4b);
      float4* rx = X + (par * 8 + warp) * 4 * 32 + lane;  // where the partner's half lands
      const uint32_t bar = map_rank(&bars[par], other);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += sb[i][j];
        st_async4(map_rank(rx + i * 32, other), make_float4(s[i][0], s[i][1], s[i][2], s[i][3]),
                  bar);
      }
      mbar_wait(&bars[par], (t >> 1) & 1);
      // half + half, then the four rows' max reduced together over their
      // 8 lanes
      float mx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 rs = rx[i * 32];
        const float os[4] = {rs.x, rs.y, rs.z, rs.w};
        const int row = wq + ly + 4 * i;
        mx[i] = NEG;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = (s[i][j] + os[j]) * sl2;
          if (edge) {
            const int col = j0 + lx + 8 * j;
            if (!(col < a.Skv && (!a.causal || col <= row))) x = NEG;
          }
          s[i][j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      // no row's max moved: every rescale would be by 1 (or, before a
      // row's first live column, of zeros), so o keeps its bits untouched
      bool same = true;
      float corr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m_new = fmaxf(m[i], mx[i]);
        // a row with no live column yet subtracts 0: its masked p are 0
        const float m_ref = m_new > 0.5f * NEG ? m_new : 0.f;
        corr[i] = exp2_ftz(m[i] - m_ref);
        same &= m_new == m[i];
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2_ftz(s[i][j] - m_ref);
          sum += p;
          Pw[4 * i * LP + lx + 8 * j] = p;
        }
        l[i] = l[i] * corr[i] + sum;
      }
      if (!__all_sync(0xffffffffu, same)) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4 * NV; ++c) o[i][c] *= corr[i];
      }
      __syncwarp();  // a row's p comes from the 8 lanes of its own warp
      nn_product<NV, WKT>(o, Pw, LP, Vt + 4 * lx, ldv);
    }
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }

  float* og = static_cast<float*>(a.o1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + r0 + 4 * i;
    if (row >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = og + ((long long)b * a.Sq + row) * ostride + (long long)h * a.hdv + cv;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * c + 4 * lx + e;
        if (col < dvw) orow[col] = o[i][4 * c + e] / lc;
      }
    if (lx == 0 && half == 0)
      a.lse_out[((long long)b * a.H + h) * a.Sq + row] = m[i] * LN2 + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

// One CTA of a.rows / 16 warps (64 or 128 query rows) of one (head,
// batch): CTA x = ((nqt - 1 - t) * B + b) * H + h, so the heaviest causal
// tile of every head starts first and a kv group's heads, which read the
// same K/V tiles, run side by side.  Its q and do tiles stay resident; K/V
// tiles come through a 2-stage ring.  A warp's 16 rows compute s = q K^T and dp
// = do V^T, form ds = round_T(p (dp - delta) scale) in registers, store it
// to their own rows of a ds tile and add ds K into dq: each row's sum runs
// over the kv tiles in order, k = 0 .. 63 within a tile, under every plan.
template <typename T, int NCV>
__global__ void __launch_bounds__(256) flash_dq_kernel(const Args a) {
  constexpr int W = 32 * NCV, LD = W + 4;
  const int BQ = a.rows, nthr = blockDim.x;
  const int HB = a.H * a.B, nqt = cdiv_c(a.Sq, BQ);
  const int lin = blockIdx.x;
  const int q0 = (nqt - 1 - lin / HB) * BQ;
  const int h = lin % a.H, b = (lin / a.H) % a.B;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ly = lane >> 3, lx = lane & 7;
  const int r0 = warp * 16 + ly;  // the lane's rows: r0 + 4i
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                  // BQ x LD
  float* Os = Qs + BQ * LD;        // do, BQ x LD
  float* Ds = Os + BQ * LD;        // ds, BQ x LDP
  float* ring = Ds + BQ * LDP;     // DQ_STAGES x (K, V), KT x LD each

  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const T* qb = static_cast<const T*>(a.q) + (long long)b * a.Sq * qstride + (long long)h * a.hd;
  const T* ob = static_cast<const T*>(a.dout) + (long long)b * a.Sq * ostride + (long long)h * a.hdv;
  const T* kb = static_cast<const T*>(a.k) + (long long)b * a.Skv * kstride + (long long)kvh * a.hd;
  const T* vb = static_cast<const T*>(a.v) + (long long)b * a.Skv * vstride + (long long)kvh * a.hdv;
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  const int n = cdiv_c(kv_end, KT);
  auto load = [&](int t) {
    float* st = ring + (t % DQ_STAGES) * 2 * KT * LD;
    copy_rows<T, W>(st, kb, kstride, t * KT, KT, a.Skv, a.hd, a.vec_k, tid, nthr);
    copy_rows<T, W>(st + KT * LD, vb, vstride, t * KT, KT, a.Skv, a.hdv, a.vec_v, tid, nthr);
  };
  copy_rows<T, W>(Qs, qb, qstride, q0, BQ, a.Sq, a.hd, a.vec_q, tid, nthr);
  copy_rows<T, W>(Os, ob, ostride, q0, BQ, a.Sq, a.hdv, a.vec_o, tid, nthr);
  load(0);  // n >= 1: Skv > 0, and a causal CTA sees key 0
  cp_async_commit();

  // -lse log2(e) and delta of the lane's rows (0 past Sq, where q and do
  // are zero rows, so ds is 0)
  const long long srow = ((long long)b * a.H + h) * a.Sq;
  float nl[4], dl[4], dq[4][4 * NCV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 4 * i;
    nl[i] = row < a.Sq ? -a.lse_in[srow + row] * LOG2E : 0.f;
    dl[i] = row < a.Sq ? a.delta[srow + row] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NCV; ++c) dq[i][c] = 0.f;
  }
  const int hd4 = (a.hd + 3) & ~3, hdv4 = (a.hdv + 3) & ~3;
  const float sl2 = a.scale * LOG2E;  // p = 2^(s * scale * log2 e - lse * log2 e)
  const int wq = q0 + warp * 16;      // the warp's first row
  for (int t = 0; t < n; ++t) {
    cp_async_wait_ring();
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (t + 1 < n) load(t + 1);
    cp_async_commit();
    const float* Ks = ring + (t % DQ_STAGES) * 2 * KT * LD;
    const float* Vs = Ks + KT * LD;
    const int j0 = t * KT;
    // nothing live for the warp: all its rows past Sq, or (causal) the
    // tile wholly right of its last row (128-row CTAs: the low half's
    // warps on the last tile)
    if (wq < a.Sq && !(a.causal && j0 > wq + 15)) {
      const bool edge = j0 + KT > a.Skv || (a.causal && j0 + KT - 1 > wq);
      float s[4][8], dp[4][8];
      nt_product(s, Qs + r0 * LD, LD, Ks + lx * LD, LD, hd4);
      nt_product(dp, Os + r0 * LD, LD, Vs + lx * LD, LD, hdv4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p = exp2_ftz(fmaf(s[i][j], sl2, nl[i]));
          if (edge) {
            const int row = q0 + r0 + 4 * i, col = j0 + lx + 8 * j;
            if (!(col < a.Skv && (!a.causal || col <= row))) p = 0.f;
          }
          Ds[(r0 + 4 * i) * LDP + lx + 8 * j] = round_to<T>(p * (dp[i][j] - dl[i]) * a.scale);
        }
      __syncwarp();  // a row's ds comes from the 8 lanes of its own warp
      nn_product<NCV>(dq, Ds + r0 * LDP, LDP, Ks + 4 * lx, LD);
    }
  }

  T* dqg = static_cast<T*>(a.o1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 4 * i;
    if (row >= a.Sq) continue;
    T* drow = dqg + ((long long)b * a.Sq + row) * qstride + (long long)h * a.hd;
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * c + 4 * lx + e;
        if (col < a.hd) drow[col] = from_f<T>(dq[i][4 * c + e]);
      }
  }
}

// f32 dq at hd or hd_v > 128: the paired forward's design with dq's
// products.  A cluster of two CTAs of 8 warps per (64 query rows, head,
// batch), CTA x as flash_dq_kernel's; the CTA of rank `half` owns the
// forward's columns of q, k and dq and of do and v, keeps its columns of
// its q and do rows resident and streams K and V through the same ring.
// A tile's quarters of S = q K^T and dP = do V^T go to the sibling warp,
// warp rg sends the half of S and warp rg + 4 the half of dP into the
// partner CTA (two buffers by parity), and all four warps of a row group
// add the halves: S bitwise the forward's, and p and ds = round_T(p (dp -
// delta) scale) the same bits wherever they are formed.  Each warp of the
// pair forms ds for half of the tile's keys into the row group's ds tile
// (ds four times a row, once in every warp, took 7-8% of the cycles), and
// each adds ds K into its own quarter of dq: NK 32-column groups a lane
// and, NT = 1, a 16-column tail (MLA's quarters of 48).  Each row's sum runs
// over the kv tiles in order, k ascending within a tile, under either ring.
template <int NK, int NT>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(256, 1)
    flash_dq_pair_kernel(const Args a, const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv) {
  constexpr int LC = CW + 4, LP = WKT + 8, BQ = 64;
  constexpr int SLOT = 2 * WKT * LC;
  const int HB = a.H * a.B, nqt = cdiv_c(a.Sq, BQ);
  const int lin = blockIdx.x;
  const int q0 = (nqt - 1 - lin / HB) * BQ;
  const int h = lin % a.H, b = (lin / a.H) % a.B;
  const int kvh = h / (a.H / a.KVH);
  const uint32_t half = cluster_rank(), other = half ^ 1u;
  const int hk = half_cols(a.hd), hv = half_cols(a.hdv);
  const int ck = half * hk, cv = half * hv;
  const int dkw = max(0, min(hk, a.hd - ck)), dvw = max(0, min(hv, a.hdv - cv));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ly = lane >> 3, lx = lane & 7;
  const int rg = warp & 3, cg = warp >> 2;
  const int r0 = rg * 16 + ly;
  const int qk0 = cg * (hk / 2), qv0 = cg * (hv / 2);
  const int dkq = max(0, min(hk / 2, dkw - qk0)), dvq = max(0, min(hv / 2, dvw - qv0));
  extern __shared__ __align__(16) float sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  uint64_t* full = bars + 2;
  float* Qs = pair_tiles(sm);       // BQ x LC: the CTA's columns of its q rows
  float* Os = Qs + BQ * LC;         // and of its do rows
  float* Ps = Os + BQ * LC;         // ds: BQ x LP, each row group its own rows
  float4* Y = reinterpret_cast<float4*>(Ps + BQ * LP);  // [cg][rg][8][32]: quarters
  float4* X = Y + 2 * 4 * 8 * 32;   // [parity][rg][8][32]: the partner's halves
  float* ring = reinterpret_cast<float*>(X + 2 * 4 * 8 * 32);  // stages x (K, V)

  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const float* qh = static_cast<const float*>(a.q) + (long long)b * a.Sq * qstride +
                    (long long)h * a.hd + ck;
  const float* oh = static_cast<const float*>(a.dout) + (long long)b * a.Sq * ostride +
                    (long long)h * a.hdv + cv;
  const float* kh = static_cast<const float*>(a.k) + (long long)b * a.Skv * kstride +
                    (long long)kvh * a.hd + ck;
  const float* vh = static_cast<const float*>(a.v) + (long long)b * a.Skv * vstride +
                    (long long)kvh * a.hdv + cv;
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  const int n = cdiv_c(kv_end, WKT), stages = a.stages;
  // the K / V rows' strides in the ring: hk + 4 and hv + 4 by tensor
  // copies, CW + 4 by cp.async
  const int ldk = a.tma ? hk + 4 : LC, ldv = a.tma ? hv + 4 : LC;
  auto load = [&](int t) {
    pair_load_kv(a, &mk, &mv, ring + (t % stages) * SLOT, &full[t % stages], kh, vh, kstride,
                 vstride, t * WKT, b, kvh, ck, cv, hk, hv, dkw, dvw, tid);
  };
  pair_start(bars, tid);
  copy_rows<float, CW>(Qs, qh, qstride, q0, BQ, a.Sq, dkw, a.vec_q, tid, 256);
  copy_rows<float, CW>(Os, oh, ostride, q0, BQ, a.Sq, dvw, a.vec_o, tid, 256);
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  // -lse log2(e) and delta of the lane's rows (0 past Sq, where q and do
  // are zero rows, so ds is 0)
  const long long srow = ((long long)b * a.H + h) * a.Sq;
  float nl[4], dl[4], dq[4][4 * NK + 2 * NT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 4 * i;
    nl[i] = row < a.Sq ? -a.lse_in[srow + row] * LOG2E : 0.f;
    dl[i] = row < a.Sq ? a.delta[srow + row] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NK + 2 * NT; ++c) dq[i][c] = 0.f;
  }
  const int k4 = (dkq + 3) & ~3, v4 = (dvq + 3) & ~3;
  const float sl2 = a.scale * LOG2E;  // p = 2^(s * scale * log2 e - lse * log2 e)
  float* Pw = Ps + r0 * LP;  // the lane's first row of its group's ds
  float4* mine = Y + (cg * 4 + rg) * 8 * 32 + lane;
  const float4* sib = Y + ((cg ^ 1) * 4 + rg) * 8 * 32 + lane;
  const int wq = q0 + 16 * rg;
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    mbar_wait(&full[t % stages], (t / stages) & 1);
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const float* Kt = ring + (t % stages) * SLOT;
    const float* Vt = Kt + WKT * LC;
    const int j0 = t * WKT, par = t & 1;
    if (tid == 0)  // the partner's live row groups send 2 x 32 x 64 bytes each
      mbar_expect(&bars[par], 4096u * (pair_live(a, q0, 0, j0) + pair_live(a, q0, 1, j0) +
                                       pair_live(a, q0, 2, j0) + pair_live(a, q0, 3, j0)));
    if (pair_live(a, q0, rg, j0)) {
      const bool edge = j0 + WKT > a.Skv || (a.causal && j0 + WKT - 1 > wq);
      float s[4][4], dp[4][4];
      // this warp's quarter of S = q K^T and of dP = do V^T
      nt_product(s, Qs + r0 * LC + qk0, LC, Kt + lx * ldk + qk0, ldk, k4);
      nt_product(dp, Os + r0 * LC + qv0, LC, Vt + lx * ldv + qv0, ldv, v4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mine[i * 32] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        mine[(4 + i) * 32] = make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      }
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");  // the two quarters written
      // the CTA's half: quarter + quarter; warp rg stores the half of S
      // into the partner, warp rg + 4 the half of dP
      float4* rx = X + (par * 4 + rg) * 8 * 32 + lane;
      const uint32_t bar = map_rank(&bars[par], other);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 os = sib[i * 32], od = sib[(4 + i) * 32];
        s[i][0] += os.x, s[i][1] += os.y, s[i][2] += os.z, s[i][3] += os.w;
        dp[i][0] += od.x, dp[i][1] += od.y, dp[i][2] += od.z, dp[i][3] += od.w;
        const float4 x = cg == 0 ? make_float4(s[i][0], s[i][1], s[i][2], s[i][3])
                                 : make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
        st_async4(map_rank(rx + (4 * cg + i) * 32, other), x, bar);
      }
      mbar_wait(&bars[par], (t >> 1) & 1);
      // ds of the warp's half of the tile's keys, columns lx + 8j for j =
      // 2 cg and 2 cg + 1, into the row group's ds tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 rs = rx[i * 32], rd = rx[(4 + i) * 32];
        const float os[4] = {rs.x, rs.y, rs.z, rs.w}, od[4] = {rd.x, rd.y, rd.z, rd.w};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * cg + jj;
          const float sv = cg ? s[i][2 + jj] + os[2 + jj] : s[i][jj] + os[jj];
          const float dv = cg ? dp[i][2 + jj] + od[2 + jj] : dp[i][jj] + od[jj];
          float p = exp2_ftz(fmaf(sv, sl2, nl[i]));
          if (edge) {
            const int row = wq + ly + 4 * i, col = j0 + lx + 8 * j;
            if (!(col < a.Skv && (!a.causal || col <= row))) p = 0.f;
          }
          Pw[4 * i * LP + lx + 8 * j] = p * (dv - dl[i]) * a.scale;
        }
      }
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");  // both halves of ds written
      if (dkq > 0)
        nn_product<NK, WKT, NT>(dq, Pw, LP, Kt + qk0 + 4 * lx, ldk, Kt + qk0 + 32 * NK + 2 * lx);
    }
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }

  float* dqg = static_cast<float*>(a.o1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 4 * i;
    if (row >= a.Sq) continue;
    float* drow = dqg + ((long long)b * a.Sq + row) * qstride + (long long)h * a.hd + ck + qk0;
#pragma unroll
    for (int c = 0; c < NK; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * c + 4 * lx + e;
        if (col < dkq) drow[col] = dq[i][4 * c + e];
      }
#pragma unroll
    for (int e = 0; e < 2 * NT; ++e) {
      const int col = 32 * NK + 2 * lx + e;
      if (col < dkq) drow[col] = dq[i][4 * NK + e];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

// adds (first: sets) the f32 value of acc rounded to T into the partial w
// (row stride `stride`): rows j0 + r0 + 4i < Skv, columns 32c + 4lx + e < d
template <typename T, int NC>
__device__ __forceinline__ void add_part_rows(float* w, const float (&acc)[4][4 * NC],
                                              long long stride, int d, bool first, int row0,
                                              int rows, int lx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * c + 4 * lx + e;
        if (col < d) {
          float* x = w + row * stride + col;
          *x = (first ? 0.f : *x) + round_to<T>(acc[i][4 * c + e]);
        }
      }
  }
}
// acc rounded to T into out (the same rows and columns)
template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][4 * NC], long long stride,
                                           int d, int row0, int rows, int lx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * c + 4 * lx + e;
        if (col < d) out[row * stride + col] = from_f<T>(acc[i][4 * c + e]);
      }
  }
}

// One CTA of 2 x a.rows threads per (a.rows kv rows, `a.heads` query heads
// of a kv head's group, batch): CTA x = ((kv tile * B + b) * KVH + kvh) *
// parts + rank, so kv tile 0 (the longest causal walk) starts first.  Rank
// r walks heads [r * heads, min(G, (r + 1) * heads)), each from the
// diagonal query tile on; its warps each own 16 kv rows and compute all
// four products for them: s = K q^T -> p, dv += p^T do, dp = V do^T -> ds,
// dk += ds^T q, p and then ds passing through the warp's own rows of one
// shared tile (no barrier but the ring's).  Each head's dk/dv is rounded
// to T and the heads are summed in g order in f32: a rank's heads into
// its partial (ws, dk's layout, then dv's), the ranks' partials by
// flash_dkv_sum_kernel.  With G = 1 the CTA writes dk/dv itself.
template <typename T, int NCV>
__global__ void __launch_bounds__(256) flash_dkv_kernel(const Args a) {
  constexpr int W = 32 * NCV, LD = W + 4;
  const int BK = a.rows, nthr = blockDim.x;
  const int cs = a.parts, G = a.H / a.KVH;
  const int lin = blockIdx.x, per = a.B * a.KVH * cs;
  const int j0 = lin / per * BK, rank = lin % cs;
  const int kvh = (lin / cs) % a.KVH, b = (lin / (cs * a.KVH)) % a.B;
  const int g0 = rank * a.heads, g1 = min(G, g0 + a.heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ly = lane >> 3, lx = lane & 7;
  const int r0 = warp * 16 + ly;  // the lane's kv rows: r0 + 4i
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                  // BK x LD, this CTA's kv rows
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;        // p^T, then ds^T: BK (kv) x LDP (q)
  float* ring = Ps + BK * LDP;     // stages x (q, do: KT x LD; lse, delta: KT)
  const int slot = 2 * KT * LD + 2 * KT;

  const T* qg = static_cast<const T*>(a.q);
  const T* og = static_cast<const T*>(a.dout);
  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const T* kb = static_cast<const T*>(a.k) + (long long)b * a.Skv * kstride + (long long)kvh * a.hd;
  const T* vb = static_cast<const T*>(a.v) + (long long)b * a.Skv * vstride + (long long)kvh * a.hdv;
  // causal: query tiles wholly above this kv tile see none of it
  const int q_begin = a.causal ? j0 : 0;
  const int nqt = q_begin < a.Sq ? cdiv_c(a.Sq - q_begin, KT) : 0;
  const int n = (g1 - g0) * nqt, stages = a.stages;
  auto load = [&](int t) {
    float* st = ring + (t % stages) * slot;
    const int h = kvh * G + g0 + t / nqt, i0 = q_begin + (t % nqt) * KT;
    const long long srow = ((long long)b * a.H + h) * a.Sq;
    copy_rows<T, W>(st, qg + (long long)b * a.Sq * qstride + (long long)h * a.hd, qstride, i0, KT,
                    a.Sq, a.hd, a.vec_q, tid, nthr);
    copy_rows<T, W>(st + KT * LD, og + (long long)b * a.Sq * ostride + (long long)h * a.hdv,
                    ostride, i0, KT, a.Sq, a.hdv, a.vec_o, tid, nthr);
    copy_vec(st + 2 * KT * LD, a.lse_in + srow, i0, a.Sq, tid, nthr);
    copy_vec(st + 2 * KT * LD + KT, a.delta + srow, i0, a.Sq, tid, nthr);
  };
  if (n > 0) {
    copy_rows<T, W>(Ks, kb, kstride, j0, BK, a.Skv, a.hd, a.vec_k, tid, nthr);
    copy_rows<T, W>(Vs, vb, vstride, j0, BK, a.Skv, a.hdv, a.vec_v, tid, nthr);
  }
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  // where this CTA's part goes: the partial of its rank, or dk/dv (G = 1)
  const long long ndk = (long long)a.B * a.Skv * a.KVH * a.hd;
  const long long ndv = (long long)a.B * a.Skv * a.KVH * a.hdv;
  const long long kbase = (long long)b * a.Skv * kstride + (long long)kvh * a.hd;
  const long long vbase = (long long)b * a.Skv * vstride + (long long)kvh * a.hdv;
  float* wk = a.ws ? a.ws + rank * ndk + kbase : nullptr;
  float* wv = a.ws ? a.ws + cs * ndk + rank * ndv + vbase : nullptr;

  float dk[4][4 * NCV], dv[4][4 * NCV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NCV; ++c) dk[i][c] = dv[i][c] = 0.f;
  const int hd4 = (a.hd + 3) & ~3, hdv4 = (a.hdv + 3) & ~3;
  const float sl2 = a.scale * LOG2E;  // p = 2^(s * scale * log2 e - lse * log2 e)
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const float* Qt = ring + (t % stages) * slot;
    const float* Ot = Qt + KT * LD;
    const float* Lt = Ot + KT * LD;
    const float* Dl = Lt + KT;
    const int i0 = q_begin + (t % nqt) * KT, kw = j0 + warp * 16;
    // causal: a warp whose kv rows all follow the tile's last query row
    // has nothing live in it (128-row CTAs: half the warps on tile 0)
    if (!(a.causal && kw > i0 + KT - 1)) {
      const bool edge = (a.causal && kw + 15 > i0) || i0 + KT > a.Sq || kw + 16 > a.Skv;
      float x[4][8];
      nt_product(x, Ks + r0 * LD, LD, Qt + lx * LD, LD, hd4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p = exp2_ftz(fmaf(x[i][j], sl2, -Lt[lx + 8 * j] * LOG2E));
          if (edge) {
            const int kr = j0 + r0 + 4 * i, qc = i0 + lx + 8 * j;
            if (!(qc < a.Sq && kr < a.Skv && (!a.causal || kr <= qc))) p = 0.f;
          }
          Ps[(r0 + 4 * i) * LDP + lx + 8 * j] = p;
        }
      __syncwarp();  // a kv row's p comes from the 8 lanes of its own warp
      nn_product<NCV>(dv, Ps + r0 * LDP, LDP, Ot + 4 * lx, LD);
      nt_product(x, Vs + r0 * LD, LD, Ot + lx * LD, LD, hdv4);
      __syncwarp();  // every lane is past p^T before ds^T replaces it
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* e = Ps + (r0 + 4 * i) * LDP + lx + 8 * j;
          *e = round_to<T>(*e * (x[i][j] - Dl[lx + 8 * j]) * a.scale);
        }
      __syncwarp();
      nn_product<NCV>(dk, Ps + r0 * LDP, LDP, Qt + 4 * lx, LD);
    }
    if (g1 - g0 > 1 && t % nqt == nqt - 1) {  // a head done: into the partial
      add_part_rows<T, NCV>(wk, dk, kstride, a.hd, t < nqt, j0 + r0, a.Skv, lx);
      add_part_rows<T, NCV>(wv, dv, vstride, a.hdv, t < nqt, j0 + r0, a.Skv, lx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NCV; ++c) dk[i][c] = dv[i][c] = 0.f;
    }
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }
  if (g1 - g0 > 1 && n > 0) return;  // the partial holds the rank's heads
  if (wk) {
    add_part_rows<T, NCV>(wk, dk, kstride, a.hd, true, j0 + r0, a.Skv, lx);
    add_part_rows<T, NCV>(wv, dv, vstride, a.hdv, true, j0 + r0, a.Skv, lx);
    return;
  }
  store_rows<T, NCV>(static_cast<T*>(a.o1) + kbase, dk, kstride, a.hd, j0 + r0, a.Skv, lx);
  store_rows<T, NCV>(static_cast<T*>(a.o2) + vbase, dv, vstride, a.hdv, j0 + r0, a.Skv, lx);
}

// f32 dk/dv at hd or hd_v > 128.  A thread-block cluster of two CTAs of 8
// warps per (64 kv rows, `heads` query heads of a kv head's group, batch);
// CTA x, the ranks' heads, the partials, the group sum and the zeros past
// every query are flash_dkv_kernel's.  The CTA of cluster rank `half`
// (blockIdx.y) owns columns [half hk, (half + 1) hk) of k, q and dk and
// [half hv, (half + 1) hv) of v, do and dv (hk = half_cols(hd), hv =
// half_cols(hd_v): MLA's 192 / 128 splits 96 + 96 and 64 + 64): it keeps
// those columns of its K and V rows resident and streams the same columns
// of q and do, with lse and delta, in tiles of WQT = 32 queries through a
// ring of 1 or 2 stages: each q / do row by a bulk copy (TMA) that one lane
// issues, 8 a warp, completing on the slot's mbarrier (rows past Sq are
// zeroed instead; cp.async copies where a row is not a 16-byte multiple on
// a 16-byte boundary), lse and delta by cp.async.  Warps w and w + 4 own
// kv rows 16w .. 16w + 15, each a quarter of the CTA's columns (column
// group cg = warp / 4): a tile's partial S^T = K q^T and dP^T = V do^T over
// its quarter go through shared memory to its sibling, both add the
// quarters (the CTA's half), warp w stores the half of S^T and warp w + 4
// the half of dP^T into the partner CTA's shared memory (st.async,
// completing on the partner's mbarrier of the tile's parity: two buffers,
// so a CTA sends tile t + 1 while its partner still reads tile t), and
// both wait for the partner's.  Each sum is quarter + quarter, then half +
// half: an IEEE add commutes, so all four warps of a row group hold the
// same S^T and dP^T, so the same p and ds bits.  Each warp then adds p^T
// do into dv and ds^T q into dk for its own quarter.  Every product runs
// once, and NK / NV 32-column groups of accumulators a lane (2 / 1 at
// MLA's quarters of 48 / 32) cover a warp's columns.  (One warp a row
// group, 4 a CTA, ran its products at ~45% of the FFMA rate: one warp a
// scheduler hides no latency; launch/probe_flash.py.)
template <int NK, int NV>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(256)
    flash_dkv_pair_kernel(const Args a) {
  constexpr int LC = CW + 4, LQ = WQT + 8, BK = 64, nthr = 256;
  constexpr int SLOT = 2 * WQT * LC + 2 * WQT;
  const int cs = a.parts, G = a.H / a.KVH;
  const int lin = blockIdx.x, per = a.B * a.KVH * cs;
  const int j0 = lin / per * BK, rank = lin % cs;
  const int kvh = (lin / cs) % a.KVH, b = (lin / (cs * a.KVH)) % a.B;
  const int g0 = rank * a.heads, g1 = min(G, g0 + a.heads);
  const uint32_t half = cluster_rank(), other = half ^ 1u;
  const int hk = half_cols(a.hd), hv = half_cols(a.hdv);
  const int ck = half * hk, cv = half * hv;  // the CTA's first column of each
  const int dkw = max(0, min(hk, a.hd - ck)), dvw = max(0, min(hv, a.hdv - cv));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ly = lane >> 3, lx = lane & 7;
  const int rg = warp & 3, cg = warp >> 2;  // row group, column group
  const int r0 = rg * 16 + ly;              // the lane's kv rows: r0 + 4i
  // the warp's quarter: columns [qk0, qk0 + dkq) of the CTA's k columns
  // and [qv0, qv0 + dvq) of its v columns
  const int qk0 = cg * (hk / 2), qv0 = cg * (hv / 2);
  const int dkq = max(0, min(hk / 2, dkw - qk0)), dvq = max(0, min(hv / 2, dvw - qv0));
  extern __shared__ __align__(16) float sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);  // the partner's halves of even / odd tiles
  uint64_t* full = bars + 2;        // q and do of the ring's slot landed
  float* Ks = sm + 8;               // BK x LC: the CTA's columns of its kv rows
  float* Vs = Ks + BK * LC;
  float* Ps = Vs + BK * LC;         // per column group, p^T then ds^T: BK (kv) x LQ (q)
  float4* Y = reinterpret_cast<float4*>(Ps + 2 * BK * LQ);  // [cg][rg][8][32]: quarters
  float4* X = Y + 2 * 4 * 8 * 32;   // [parity][rg][8][32]: the partner's halves
  float* ring = reinterpret_cast<float*>(X + 2 * 4 * 8 * 32);  // stages x (q, do, lse, delta)

  const float* qg = static_cast<const float*>(a.q);
  const float* og = static_cast<const float*>(a.dout);
  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const long long kbase = (long long)b * a.Skv * kstride + (long long)kvh * a.hd + ck;
  const long long vbase = (long long)b * a.Skv * vstride + (long long)kvh * a.hdv + cv;
  // causal: query tiles wholly above this kv tile see none of it
  const int q_begin = a.causal ? j0 : 0;
  const int nqt = q_begin < a.Sq ? cdiv_c(a.Sq - q_begin, WQT) : 0;
  const int n = (g1 - g0) * nqt, stages = a.stages;
  const bool bulk = a.vec_q && a.vec_o;  // rows of 16-byte multiples on 16-byte boundaries
  // tile t into its slot, every warp its 4 rows 4w .. 4w + 3: lanes 0-3 a
  // q row each and 4-7 a do row (bulk), or every thread its share of
  // cp.async copies; lanes 8-11 an lse value and 12-15 a delta
  auto load = [&](int t) {
    const int sl = t % stages;
    float* st = ring + sl * SLOT;
    const int h = kvh * G + g0 + t / nqt, i0 = q_begin + (t % nqt) * WQT;
    const long long srow = ((long long)b * a.H + h) * a.Sq;
    const float* qh = qg + (long long)b * a.Sq * qstride + (long long)h * a.hd + ck;
    const float* oh = og + (long long)b * a.Sq * ostride + (long long)h * a.hdv + cv;
    if (!bulk) {
      copy_rows<float, CW>(st, qh, qstride, i0, WQT, a.Sq, dkw, a.vec_q, tid, nthr);
      copy_rows<float, CW>(st + WQT * LC, oh, ostride, i0, WQT, a.Sq, dvw, a.vec_o, tid, nthr);
    }
    const int r = 4 * warp + (lane & 3), kind = lane >> 2;  // row; q, do, lse, delta
    // the warp's rows with a query: bytes its lanes 0-7 bring
    const int live = max(0, min(4, a.Sq - i0 - 4 * warp));
    if (lane == 0) mbar_expect(&full[sl], bulk ? 4u * (dkw + dvw) * live : 0u);
    if (kind == 2 || kind == 3) {
      const float* v = (kind == 2 ? a.lse_in : a.delta) + srow;
      const bool ok = i0 + r < a.Sq;
      cp_async4(st + 2 * WQT * LC + (kind - 2) * WQT + r, ok ? v + i0 + r : v, ok ? 4 : 0);
    } else if (kind < 2 && bulk) {
      const int d = kind == 0 ? dkw : dvw;
      float* row = st + (kind * WQT + r) * LC;
      if (i0 + r < a.Sq) {
        if (d > 0)
          bulk_copy(row, (kind == 0 ? qh + (long long)(i0 + r) * qstride
                                    : oh + (long long)(i0 + r) * ostride),
                    4u * d, &full[sl]);
      } else {
        for (int c = 0; c < d; c += 4)
          *reinterpret_cast<float4*>(row + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        fence_proxy_async();  // the zeros before this lane's later bulk copies here
      }
    }
  };
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&full[0], 8);
    mbar_init(&full[1], 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();  // both CTAs' mbarriers set before either stores
  cluster_wait();
  if (n > 0) {
    copy_rows<float, CW>(Ks, static_cast<const float*>(a.k) + kbase, kstride, j0, BK,
                         a.Skv, dkw, a.vec_k, tid, nthr);
    copy_rows<float, CW>(Vs, static_cast<const float*>(a.v) + vbase, vstride, j0, BK,
                         a.Skv, dvw, a.vec_v, tid, nthr);
  }
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  // where this warp's part goes: the partial of its rank, or dk/dv (G = 1)
  const long long ndk = (long long)a.B * a.Skv * a.KVH * a.hd;
  const long long ndv = (long long)a.B * a.Skv * a.KVH * a.hdv;
  float* wk = a.ws ? a.ws + rank * ndk + kbase + qk0 : nullptr;
  float* wv = a.ws ? a.ws + cs * ndk + rank * ndv + vbase + qv0 : nullptr;
  float dk[4][4 * NK], dv[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NK; ++c) dk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) dv[i][c] = 0.f;
  }
  // the queries each of the lane's kv rows meets: [qlo, qhi)
  int qlo[4], qhi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = j0 + r0 + 4 * i;
    qlo[i] = a.causal ? kr : 0;
    qhi[i] = kr < a.Skv ? a.Sq : 0;
  }
  const int k4 = (dkq + 3) & ~3, v4 = (dvq + 3) & ~3;
  const float sl2 = a.scale * LOG2E;  // p = 2^(s * scale * log2 e - lse * log2 e)
  float* Pw = Ps + cg * BK * LQ + r0 * LQ;  // the lane's first row of its group's p^T
  float4* mine = Y + (cg * 4 + rg) * 8 * 32 + lane;      // this warp's quarters
  const float4* sib = Y + ((cg ^ 1) * 4 + rg) * 8 * 32 + lane;
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    mbar_wait(&full[t % stages], (t / stages) & 1);
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const float* Qt = ring + (t % stages) * SLOT;
    const float* Ot = Qt + WQT * LC;
    const float* Lt = Ot + WQT * LC;
    const float* Dl = Lt + WQT;
    const int i0 = q_begin + (t % nqt) * WQT, par = t & 1;
    // a row group has something live unless its kv rows are past Skv or
    // (causal) all follow the tile's last query; the pair agrees on it
    auto live = [&](int g) {
      const int kw = j0 + 16 * g;
      return kw < a.Skv && !(a.causal && kw > i0 + WQT - 1);
    };
    if (tid == 0)  // the partner's live row groups send 2 x 32 x 64 bytes each
      mbar_expect(&bars[par], 4096u * (live(0) + live(1) + live(2) + live(3)));
    if (live(rg)) {
      const int kw = j0 + rg * 16;
      const bool edge = (a.causal && kw + 15 > i0) || i0 + WQT > a.Sq || kw + 16 > a.Skv;
      float s[4][4], dp[4][4];
      // this warp's quarter of S^T = K q^T and of dP^T = V do^T
      nt_product(s, Ks + r0 * LC + qk0, LC, Qt + lx * LC + qk0, LC, k4);
      nt_product(dp, Vs + r0 * LC + qv0, LC, Ot + lx * LC + qv0, LC, v4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mine[i * 32] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        mine[(4 + i) * 32] = make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      }
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");  // the two quarters written
      // the CTA's half: quarter + quarter; warp rg stores the half of
      // S^T into the partner, warp rg + 4 the half of dP^T
      float4* rx = X + (par * 4 + rg) * 8 * 32 + lane;  // where the partner's halves land
      const uint32_t bar = map_rank(&bars[par], other);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 os = sib[i * 32], od = sib[(4 + i) * 32];
        s[i][0] += os.x, s[i][1] += os.y, s[i][2] += os.z, s[i][3] += os.w;
        dp[i][0] += od.x, dp[i][1] += od.y, dp[i][2] += od.z, dp[i][3] += od.w;
        const float4 x = cg == 0 ? make_float4(s[i][0], s[i][1], s[i][2], s[i][3])
                                 : make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
        st_async4(map_rank(rx + (4 * cg + i) * 32, other), x, bar);
      }
      mbar_wait(&bars[par], (t >> 1) & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 rs = rx[i * 32], rd = rx[(4 + i) * 32];
        const float os[4] = {rs.x, rs.y, rs.z, rs.w}, od[4] = {rd.x, rd.y, rd.z, rd.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = exp2_ftz(fmaf(s[i][j] + os[j], sl2, -Lt[lx + 8 * j] * LOG2E));
          if (edge) {
            const int qc = i0 + lx + 8 * j;
            if (!(qc >= qlo[i] && qc < qhi[i])) p = 0.f;
          }
          Pw[4 * i * LQ + lx + 8 * j] = p;
          dp[i][j] += od[j];
        }
      }
      __syncwarp();  // a kv row's p comes from the 8 lanes of its own warp
      if (dvq > 0) nn_product<NV, WQT>(dv, Pw, LQ, Ot + qv0 + 4 * lx, LC);
      __syncwarp();  // every lane is past p^T before ds^T replaces it
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* e = Pw + 4 * i * LQ + lx + 8 * j;
          *e = *e * (dp[i][j] - Dl[lx + 8 * j]) * a.scale;
        }
      __syncwarp();
      if (dkq > 0) nn_product<NK, WQT>(dk, Pw, LQ, Qt + qk0 + 4 * lx, LC);
    }
    if (g1 - g0 > 1 && t % nqt == nqt - 1) {  // a head done: into the partial
      add_part_rows<float, NK>(wk, dk, kstride, dkq, t < nqt, j0 + r0, a.Skv, lx);
      add_part_rows<float, NV>(wv, dv, vstride, dvq, t < nqt, j0 + r0, a.Skv, lx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4 * NK; ++c) dk[i][c] = 0.f;
#pragma unroll
        for (int c = 0; c < 4 * NV; ++c) dv[i][c] = 0.f;
      }
    }
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }
  if (g1 - g0 > 1 && n > 0) return;  // the partial holds the rank's heads
  if (wk) {
    add_part_rows<float, NK>(wk, dk, kstride, dkq, true, j0 + r0, a.Skv, lx);
    add_part_rows<float, NV>(wv, dv, vstride, dvq, true, j0 + r0, a.Skv, lx);
    return;
  }
  store_rows<float, NK>(static_cast<float*>(a.o1) + kbase + qk0, dk, kstride, dkq, j0 + r0,
                        a.Skv, lx);
  store_rows<float, NV>(static_cast<float*>(a.o2) + vbase + qv0, dv, vstride, dvq, j0 + r0,
                        a.Skv, lx);
}

// dk, dv = the `parts` partials of ws summed in rank order
template <typename T>
__global__ void __launch_bounds__(256)
flash_dkv_sum_kernel(const float* __restrict__ ws, T* __restrict__ dk, T* __restrict__ dv,
                     long long ndk, long long ndv, int parts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ndk + ndv) return;
  const bool is_k = i < ndk;
  const long long j = is_k ? i : i - ndk, nn = is_k ? ndk : ndv;
  const float* w = ws + (is_k ? 0 : parts * ndk) + j;
  float s = 0.f;
  for (int r = 0; r < parts; ++r) s += w[r * nn];
  (is_k ? dk : dv)[j] = from_f<T>(s);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma_bf16.cuh's register layout: lane = 4 g + t
// of warp w holds rows w * 16 + g and + 8 of its tile; of a score tile the
// columns 8 j + 2 t and + 1 in s[j][0..1] (first row) and s[j][2..3])
// ---------------------------------------------------------------------------

// `n` bf16 rows of d <= D elements (row r at src + (row0 + r) * stride)
// into dst (tc_stride(D) bytes a row); rows at or past `rows` and the
// columns from d to D are zero.  vec: 16-byte cp.async pieces (d % 8 == 0
// and 16-byte aligned rows), a thread's at one column, every nthr / (D /
// 8) rows (nthr a multiple of D / 8); else 2-byte ordinary loads.
template <int D>
__device__ __forceinline__ void copy_tc(unsigned char* dst, const bf16* __restrict__ src,
                                        long long stride, int row0, int n, int rows, int d,
                                        bool vec, int tid, int nthr) {
  constexpr int RS = tc_stride(D), CPR = D / 8;
  if (vec) {
    const int c = tid % CPR, step = nthr / CPR;
    const bool col_ok = 8 * c < d;
    const bf16* g = src + (long long)row0 * stride + 8 * c;
    unsigned char* s = dst + 16 * c;
    for (int r = tid / CPR; r < n; r += step) {
      const bool live = col_ok && row0 + r < rows;
      cp_async16(s + r * RS, live ? g + (long long)r * stride : src, live ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < n * D; idx += nthr) {
      const int r = idx / D, c = idx % D;
      const bool live = row0 + r < rows && c < d;
      reinterpret_cast<bf16*>(dst + r * RS)[c] =
          live ? src[(long long)(row0 + r) * stride + c] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the A operand of k-tile kk of a product from an accumulator tile x (its
// columns 16 kk .. 16 kk + 15 are the k of the product), each value
// rounded to bf16
template <int NJ>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[NJ][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}
// the same as a pair: hi = bf16(x), lo = bf16(x - hi), so hi + lo is x to
// within 2^-17 of |x| (x - hi is exact in f32 and lo rounds it to 8 bits)
__device__ __forceinline__ uint32_t split_bf16(float x0, float x1, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <int NJ>
__device__ __forceinline__ void a_frag_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float (&x)[NJ][4], int kk) {
  hi[0] = split_bf16(x[2 * kk][0], x[2 * kk][1], lo[0]);
  hi[1] = split_bf16(x[2 * kk][2], x[2 * kk][3], lo[1]);
  hi[2] = split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], lo[2]);
  hi[3] = split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], lo[3]);
}

// acc[j] += A B over the D columns: A's 16 rows from row-major tile `as`
// (its warp's first row), B^T's 8 NJ rows from row-major tile `bs` (its
// first row), both tc_stride(D) bytes a row.  Columns past hd are zero in
// both, so the whole width is summed, with no branch.
template <int D, int NJ>
__device__ __forceinline__ void mma_nt(float (&acc)[NJ][4], const unsigned char* as,
                                       const unsigned char* bs, int lane) {
  constexpr int RS = tc_stride(D);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, as + (lane & 15) * RS + (16 * kk + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int nn = 0; nn < NJ / 2; ++nn) {
      uint32_t b[4];
      ldsm_x4(b, bs + (16 * nn + (lane & 7) + ((lane >> 4) << 3)) * RS +
                     (16 * kk + ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(acc[2 * nn], a, b[0], b[1]);
      mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] += A B, B the 16 rows k0 .. k0 + 15 of row-major tile `bs` (its
// columns c0 .. c0 + 8 NO - 1), read through ldmatrix.trans.
template <int D, int NO>
__device__ __forceinline__ void mma_nn(float (&acc)[NO][4], const uint32_t (&a)[4],
                                       const unsigned char* bs, int k0, int c0, int lane) {
  constexpr int RS = tc_stride(D);
#pragma unroll
  for (int nn = 0; nn < NO / 2; ++nn) {
    uint32_t b[4];
    ldsm_x4_t(b, bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                     (c0 + 16 * nn + (lane >> 4) * 8) * 2);
    mma_bf16(acc[2 * nn], a, b[0], b[1]);
    mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
  }
}

// The bf16 forward.  One CTA of a.rows / 16 warps per (a.rows = 64 or 128
// query rows, head, batch), CTA x as flash_fwd_kernel's (heaviest causal
// tile first).  A warp owns 16 query rows: S = Q K^T on mma.sync (Q's
// fragments kept in registers up to D = 128, re-read from shared memory
// each tile at D = 256), the online softmax in registers (m the raw
// scores' max, so the scale folds into the FFMA before each exp2; each
// thread's share of l summed over its quad at the end), p rounded to bf16
// in registers as the A operand of O += P V (V through ldmatrix.trans).
// K/V tiles come through a cp.async ring of 1 or 2 stages; Q lands in the
// first group.  The CTA owns every column of o: at D = 256 the 128 f32
// accumulators a lane take the registers Q's fragments would, so no
// column slices.
// (At D = 64, 128 registers a thread keep 16 warps an SM in 128-row CTAs;
// left free, ptxas took 142 and the CTAs an SM halved.)
template <int D>
__global__ void __launch_bounds__(256, D == 64 ? 2 : 1) flash_fwd_tc_kernel(const Args a) {
  constexpr int RS = tc_stride(D), TILE = KT * RS, NJ = KT / 8, NV = D / 8;
  constexpr bool QREG = D <= CW;
  const int BQ = a.rows, nthr = blockDim.x;
  const int HB = a.H * a.B, nqt = cdiv_c(a.Sq, BQ);
  const int lin = blockIdx.x;
  const int q0 = (nqt - 1 - lin / HB) * BQ;
  const int h = lin % a.H, b = (lin / a.H) % a.B;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + warp * 16;  // the warp's first row; the lane's: w0 + g8, + 8
  extern __shared__ __align__(16) float sm[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(sm);  // BQ rows
  unsigned char* ring = Qs + BQ * RS;                         // stages x (K, V)

  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const bf16* qb = static_cast<const bf16*>(a.q) + (long long)b * a.Sq * qstride + (long long)h * a.hd;
  const bf16* kb = static_cast<const bf16*>(a.k) + (long long)b * a.Skv * kstride + (long long)kvh * a.hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + (long long)b * a.Skv * vstride + (long long)kvh * a.hdv;
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  const int n = cdiv_c(kv_end, KT), stages = a.stages;
  auto load = [&](int t) {
    unsigned char* st = ring + (t % stages) * 2 * TILE;
    copy_tc<D>(st, kb, kstride, t * KT, KT, a.Skv, a.hd, a.vec_k, tid, nthr);
    copy_tc<D>(st + TILE, vb, vstride, t * KT, KT, a.Skv, a.hdv, a.vec_v, tid, nthr);
  };
  copy_tc<D>(Qs, qb, qstride, q0, BQ, a.Sq, a.hd, a.vec_q, tid, nthr);
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  float o[NV][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[QREG ? D / 16 : 1][4];
  // the columns each of the lane's rows attends: [0, lim)
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lim[r] = a.causal ? min(a.Skv, w0 + g8 + 8 * r + 1) : a.Skv;
  const unsigned char* qw = Qs + warp * 16 * RS;  // the warp's rows of Q
  // m is the raw scores' max: p = 2^(s sl2 - m sl2), one FFMA a score
  const float sl2 = a.scale * LOG2E;
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const unsigned char* ks = ring + (t % stages) * 2 * TILE;
    const unsigned char* vs = ks + TILE;
    const int j0 = t * KT;
    if constexpr (QREG) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk], qw + (lane & 15) * RS + (16 * kk + (lane >> 4) * 8) * 2);
      }
    }
    // causal: nothing live for a warp whose rows all precede the tile
    if (!(a.causal && j0 > w0 + 15)) {
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      // S = Q K^T
      if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int nn = 0; nn < NJ / 2; ++nn) {
            uint32_t bk[4];
            ldsm_x4(bk, ks + (16 * nn + (lane & 7) + ((lane >> 4) << 3)) * RS +
                            (16 * kk + ((lane >> 3) & 1) * 8) * 2);
            mma_bf16(sc[2 * nn], qf[kk], bk[0], bk[1]);
            mma_bf16(sc[2 * nn + 1], qf[kk], bk[2], bk[3]);
          }
      } else {
        mma_nt<D, NJ>(sc, qw, ks, lane);
      }
      const bool edge = j0 + KT > a.Skv || (a.causal && j0 + KT - 1 > w0);
      float mx[2] = {NEG, NEG};
      if (edge) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (j0 + 8 * j + 2 * t4 + (x & 1) >= lim[x >> 1]) sc[j][x] = NEG;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) mx[x >> 1] = fmaxf(mx[x >> 1], sc[j][x]);
      float ms[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        // a row with no live column yet subtracts 0: its masked p are 0
        const float m_ref = m_new > 0.5f * NEG ? m_new : 0.f;
        ms[r] = m_ref * sl2;
        corr[r] = exp2_ftz((m[r] - m_ref) * sl2);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float p = exp2_ftz(fmaf(sc[j][x], sl2, -ms[x >> 1]));
          sum[x >> 1] += p;
          sc[j][x] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      // O += P V, p rounded to v's type (bf16) as it becomes the A operand
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t pa[4];
        a_frag<NJ>(pa, sc, kk);
        mma_nn<D, NV>(o, pa, vs, 16 * kk, 0, lane);
      }
    }
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }

  bf16* og = static_cast<bf16*>(a.o1);
  const bool pairs = (a.hdv & 1) == 0;  // bf16 pairs of a row on 4-byte boundaries
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g8 + 8 * r;
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= a.Sq) continue;
    bf16* orow = og + ((long long)b * a.Sq + row) * ostride + (long long)h * a.hdv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col >= a.hdv) break;
      const float x0 = o[j][2 * r] / lc, x1 = o[j][2 * r + 1] / lc;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        orow[col] = __float2bfloat16(x0);
        if (col + 1 < a.hdv) orow[col + 1] = __float2bfloat16(x1);
      }
    }
    if (t4 == 0) a.lse_out[((long long)b * a.H + h) * a.Sq + row] = m[r] * a.scale + logf(lc);
  }
}

// The bf16 dk/dv.  One CTA of a.rows / 16 warps per (a.rows kv rows,
// `heads` query heads of a kv head's group, batch) and, at D = 256, 128-
// column slice blockIdx.y of dk and dv; CTA x, the ranks' heads, the
// partials and the group sum are flash_dkv_kernel's.  Its K and V rows
// stay resident; q, do, lse and delta tiles of 64 queries come through a
// cp.async ring of 1 or 2 stages.  A warp owns 16 kv rows and takes a
// tile in passes of QN queries (64 at D = 64, else 32, which keeps the
// score tiles to 16 registers beside the 128 of dk and dv): S^T = K q^T
// and dP^T = V do^T on mma.sync land in accumulator layout, so p^T and
// ds^T become the A operands of dv += p^T do and dk += ds^T q (do and q
// through ldmatrix.trans) in registers.  dv takes p in f32 as the
// reference does: p^T = hi + lo, two bf16 operands and two products.  ds
// is rounded to bf16 for dk.  At D = 256 every slice recomputes S^T and
// dP^T over the whole head dim.
template <int D>
__global__ void __launch_bounds__(256) flash_dkv_tc_kernel(const Args a) {
  constexpr int RS = tc_stride(D), OW = D > CW ? CW : D, NO = OW / 8;
  constexpr int QN = D == 64 ? KT : KT / 2, NJ = QN / 8;
  const int BK = a.rows, nthr = blockDim.x;
  const int cs = a.parts, G = a.H / a.KVH;
  const int lin = blockIdx.x, per = a.B * a.KVH * cs;
  const int j0 = lin / per * BK, rank = lin % cs;
  const int kvh = (lin / cs) % a.KVH, b = (lin / (cs * a.KVH)) % a.B;
  const int g0 = rank * a.heads, g1 = min(G, g0 + a.heads);
  const int c0 = blockIdx.y * OW;
  // this slice's columns of dk and of dv (0 past either's width)
  const int dkw = max(0, min(OW, a.hd - c0)), dvw = max(0, min(OW, a.hdv - c0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int kw = j0 + warp * 16;  // the warp's first kv row; the lane's: kw + g8, + 8
  extern __shared__ __align__(16) float sm[];
  unsigned char* Ks = reinterpret_cast<unsigned char*>(sm);  // BK rows
  unsigned char* Vs = Ks + BK * RS;
  unsigned char* ring = Vs + BK * RS;  // stages x (q, do: KT rows; lse, delta: KT f32)
  const int slot = 2 * KT * RS + 2 * KT * 4;

  const bf16* qg = static_cast<const bf16*>(a.q);
  const bf16* og = static_cast<const bf16*>(a.dout);
  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const bf16* kb = static_cast<const bf16*>(a.k) + (long long)b * a.Skv * kstride + (long long)kvh * a.hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + (long long)b * a.Skv * vstride + (long long)kvh * a.hdv;
  // causal: query tiles wholly above this kv tile see none of it
  const int q_begin = a.causal ? j0 : 0;
  const int nqt = q_begin < a.Sq ? cdiv_c(a.Sq - q_begin, KT) : 0;
  const int n = (g1 - g0) * nqt, stages = a.stages;
  auto load = [&](int t) {
    unsigned char* st = ring + (t % stages) * slot;
    const int h = kvh * G + g0 + t / nqt, i0 = q_begin + (t % nqt) * KT;
    const long long srow = ((long long)b * a.H + h) * a.Sq;
    copy_tc<D>(st, qg + (long long)b * a.Sq * qstride + (long long)h * a.hd, qstride, i0, KT,
               a.Sq, a.hd, a.vec_q, tid, nthr);
    copy_tc<D>(st + KT * RS, og + (long long)b * a.Sq * ostride + (long long)h * a.hdv, ostride,
               i0, KT, a.Sq, a.hdv, a.vec_o, tid, nthr);
    float* stats = reinterpret_cast<float*>(st + 2 * KT * RS);
    copy_vec(stats, a.lse_in + srow, i0, a.Sq, tid, nthr);
    copy_vec(stats + KT, a.delta + srow, i0, a.Sq, tid, nthr);
  };
  if (n > 0) {
    copy_tc<D>(Ks, kb, kstride, j0, BK, a.Skv, a.hd, a.vec_k, tid, nthr);
    copy_tc<D>(Vs, vb, vstride, j0, BK, a.Skv, a.hdv, a.vec_v, tid, nthr);
  }
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  // where this CTA's part goes: the partial of its rank, or dk/dv (G = 1)
  const long long ndk = (long long)a.B * a.Skv * a.KVH * a.hd;
  const long long ndv = (long long)a.B * a.Skv * a.KVH * a.hdv;
  const long long kbase = (long long)b * a.Skv * kstride + (long long)kvh * a.hd + c0;
  const long long vbase = (long long)b * a.Skv * vstride + (long long)kvh * a.hdv + c0;
  float* wk = a.ws ? a.ws + rank * ndk + kbase : nullptr;
  float* wv = a.ws ? a.ws + cs * ndk + rank * ndv + vbase : nullptr;
  // adds bf16(acc) into (first: sets) the rank's f32 partial
  auto add_part = [&](float* w, const float (&acc)[NO][4], long long stride, int d, bool first) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kw + g8 + 8 * r;
      if (row >= a.Skv) continue;
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e;
          if (col < d) {
            float* x = w + row * stride + col;
            *x = (first ? 0.f : *x) + round_to<bf16>(acc[j][2 * r + e]);
          }
        }
    }
  };

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk[j][x] = dv[j][x] = 0.f;
  const float sl2 = a.scale * LOG2E;  // p = 2^(s * scale * log2 e - lse * log2 e)
  const unsigned char* kwarp = Ks + warp * 16 * RS;
  const unsigned char* vwarp = Vs + warp * 16 * RS;
  // the queries each of the lane's kv rows meets: [qlo, qhi)
  int qlo[2], qhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = kw + g8 + 8 * r;
    qlo[r] = a.causal ? kr : 0;
    qhi[r] = kr < a.Skv ? a.Sq : 0;
  }
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const unsigned char* Qt = ring + (t % stages) * slot;
    const unsigned char* Ot = Qt + KT * RS;
    const float* Lt = reinterpret_cast<const float*>(Ot + KT * RS);
    const float* Dl = Lt + KT;
    const int i0 = q_begin + (t % nqt) * KT;
#pragma unroll 1
    for (int qo = 0; qo < KT; qo += QN) {
      const int iq = i0 + qo;
      // nothing live for the warp: its kv rows past Skv, the pass's
      // queries past Sq, or (causal) every kv row after the pass's last
      // query
      if (kw >= a.Skv || iq >= a.Sq || (a.causal && kw > iq + QN - 1)) continue;
      const bool edge = (a.causal && kw + 15 > iq) || iq + QN > a.Sq || kw + 16 > a.Skv;
      float x[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
      mma_nt<D, NJ>(x, kwarp, Qt + qo * RS, lane);  // S^T = K q^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = qo + 8 * j + 2 * t4;  // the tile's query of x[j][0] and x[j][2]
        const float2 ls = *reinterpret_cast<const float2*>(Lt + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(x[j][e], sl2, -((e & 1) ? ls.y : ls.x) * LOG2E));
          const int q = i0 + qc + (e & 1);
          if (edge && !(q >= qlo[e >> 1] && q < qhi[e >> 1])) p = 0.f;
          x[j][e] = p;
        }
      }
      // dv += p^T do, p in f32 as hi + lo
      if (dvw > 0) {
#pragma unroll
        for (int kk = 0; kk < QN / 16; ++kk) {
          uint32_t hi[4], lo[4];
          a_frag_split<NJ>(hi, lo, x, kk);
          mma_nn<D, NO>(dv, hi, Ot, qo + 16 * kk, c0, lane);
          mma_nn<D, NO>(dv, lo, Ot, qo + 16 * kk, c0, lane);
        }
      }
      if (dkw > 0) {
        float dp[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        mma_nt<D, NJ>(dp, vwarp, Ot + qo * RS, lane);  // dP^T = V do^T
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(Dl + qo + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[j][e] = x[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x)) * a.scale;
        }
        // dk += ds^T q, ds rounded to bf16 as it becomes the A operand
#pragma unroll
        for (int kk = 0; kk < QN / 16; ++kk) {
          uint32_t da[4];
          a_frag<NJ>(da, x, kk);
          mma_nn<D, NO>(dk, da, Qt, qo + 16 * kk, c0, lane);
        }
      }
    }
    if (g1 - g0 > 1 && t % nqt == nqt - 1) {  // a head done: into the partial
      add_part(wk, dk, kstride, dkw, t < nqt);
      add_part(wv, dv, vstride, dvw, t < nqt);
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) dk[j][x] = dv[j][x] = 0.f;
    }
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }
  if (g1 - g0 > 1 && n > 0) return;  // the partial holds the rank's heads
  if (wk) {
    add_part(wk, dk, kstride, dkw, true);
    add_part(wv, dv, vstride, dvw, true);
    return;
  }
  bf16* dkg = static_cast<bf16*>(a.o1) + kbase;
  bf16* dvg = static_cast<bf16*>(a.o2) + vbase;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kw + g8 + 8 * r;
    if (row >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e;
        if (col < dkw) dkg[row * kstride + col] = __float2bfloat16(dk[j][2 * r + e]);
        if (col < dvw) dvg[row * vstride + col] = __float2bfloat16(dv[j][2 * r + e]);
      }
  }
}

// The bf16 dq.  One CTA of a.rows / 16 warps per (a.rows = 64 or 128
// query rows, head, batch), CTA x as flash_dq_kernel's (the heaviest causal
// tile of every head first, a kv group's heads side by side).  Its q and do
// rows stay resident; K/V tiles of 64 keys come through a cp.async ring of
// 1 or 2 stages.  A warp owns 16 query rows and takes a tile in passes of
// KN keys (64 at D = 64, else 32, which keeps S and dP to 16 registers each
// beside the D / 2 of dq): S = q K^T and dP = do V^T on mma.sync (q and do
// re-read from shared memory each pass) land in accumulator layout, and ds
// = p (dp - delta) scale, rounded to bf16 as the reference rounds it,
// becomes in registers the A operand of dq += ds K (K through
// ldmatrix.trans).  The CTA owns every column of dq (at D = 256 its 128 f32
// accumulators a lane, as the forward's o): no slices, nothing recomputed.
// Each row's kv tiles, a tile's passes and a pass's 16-key steps are summed
// in order, whatever the plan.  (At D = 64, 128 registers a thread keep two
// 128-row CTAs an SM, with no spills: 0.0907 -> 0.0725 ms at llama's
// shape; left free, ptxas took 178 and one CTA fit.)
template <int D>
__global__ void __launch_bounds__(256, D == 64 ? 2 : 1) flash_dq_tc_kernel(const Args a) {
  constexpr int RS = tc_stride(D), TILE = KT * RS, NO = D / 8;
  constexpr int KN = D == 64 ? KT : KT / 2, NJ = KN / 8;
  const int BQ = a.rows, nthr = blockDim.x;
  const int HB = a.H * a.B, nqt = cdiv_c(a.Sq, BQ);
  const int lin = blockIdx.x;
  const int q0 = (nqt - 1 - lin / HB) * BQ;
  const int h = lin % a.H, b = (lin / a.H) % a.B;
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int wq = q0 + warp * 16;  // the warp's first row; the lane's: wq + g8, + 8
  extern __shared__ __align__(16) float sm[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(sm);  // BQ rows
  unsigned char* Os = Qs + BQ * RS;                           // do, BQ rows
  unsigned char* ring = Os + BQ * RS;                         // stages x (K, V)

  const long long qstride = (long long)a.H * a.hd, ostride = (long long)a.H * a.hdv;
  const long long kstride = (long long)a.KVH * a.hd, vstride = (long long)a.KVH * a.hdv;
  const bf16* qb = static_cast<const bf16*>(a.q) + (long long)b * a.Sq * qstride + (long long)h * a.hd;
  const bf16* ob = static_cast<const bf16*>(a.dout) + (long long)b * a.Sq * ostride + (long long)h * a.hdv;
  const bf16* kb = static_cast<const bf16*>(a.k) + (long long)b * a.Skv * kstride + (long long)kvh * a.hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + (long long)b * a.Skv * vstride + (long long)kvh * a.hdv;
  const int kv_end = a.causal ? min(a.Skv, q0 + BQ) : a.Skv;
  const int n = cdiv_c(kv_end, KT), stages = a.stages;
  auto load = [&](int t) {
    unsigned char* st = ring + (t % stages) * 2 * TILE;
    copy_tc<D>(st, kb, kstride, t * KT, KT, a.Skv, a.hd, a.vec_k, tid, nthr);
    copy_tc<D>(st + TILE, vb, vstride, t * KT, KT, a.Skv, a.hdv, a.vec_v, tid, nthr);
  };
  copy_tc<D>(Qs, qb, qstride, q0, BQ, a.Sq, a.hd, a.vec_q, tid, nthr);
  copy_tc<D>(Os, ob, ostride, q0, BQ, a.Sq, a.hdv, a.vec_o, tid, nthr);
  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  // -lse log2(e), delta and the keys [0, lim) of the lane's two rows (a row
  // past Sq: none, so every p is 0)
  const long long srow = ((long long)b * a.H + h) * a.Sq;
  float nl[2], dl[2];
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + g8 + 8 * r;
    const bool ok = row < a.Sq;
    nl[r] = ok ? -a.lse_in[srow + row] * LOG2E : 0.f;
    dl[r] = ok ? a.delta[srow + row] : 0.f;
    lim[r] = ok ? (a.causal ? min(a.Skv, row + 1) : a.Skv) : 0;
  }
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  const unsigned char* qw = Qs + warp * 16 * RS;  // the warp's rows of q
  const unsigned char* ow = Os + warp * 16 * RS;  // and of do
  const float sl2 = a.scale * LOG2E;  // p = 2^(s * scale * log2 e - lse * log2 e)
  for (int t = 0; t < n; ++t) {
    if (stages == 1) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait_ring();
    __syncthreads();  // tile t landed; every warp is past tile t - 1
    if (stages > 1) {
      if (t + stages - 1 < n) load(t + stages - 1);
      cp_async_commit();
    }
    const unsigned char* ks = ring + (t % stages) * 2 * TILE;
    const unsigned char* vs = ks + TILE;
#pragma unroll 1
    for (int ko = 0; ko < KT; ko += KN) {
      const int jk = t * KT + ko;  // the pass's first key
      // nothing live for the warp: its rows past Sq, the pass's keys past
      // Skv, or (causal) every key after the warp's last row
      if (wq >= a.Sq || jk >= a.Skv || (a.causal && jk > wq + 15)) continue;
      const bool edge = jk + KN > a.Skv || (a.causal && jk + KN - 1 > wq) || wq + 16 > a.Sq;
      float x[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = dp[j][e] = 0.f;
      mma_nt<D, NJ>(x, qw, ks + ko * RS, lane);   // S = q K^T
      mma_nt<D, NJ>(dp, ow, vs + ko * RS, lane);  // dP = do V^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(x[j][e], sl2, nl[e >> 1]));
          if (edge && jk + 8 * j + 2 * t4 + (e & 1) >= lim[e >> 1]) p = 0.f;
          x[j][e] = p * (dp[j][e] - dl[e >> 1]) * a.scale;
        }
      // dq += ds K, ds rounded to bf16 as it becomes the A operand
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        uint32_t da[4];
        a_frag<NJ>(da, x, kk);
        mma_nn<D, NO>(dq, da, ks, ko + 16 * kk, 0, lane);
      }
    }
    if (stages == 1) __syncthreads();  // the one slot is reloaded next
  }

  bf16* dqg = static_cast<bf16*>(a.o1);
  const bool pairs = (a.hd & 1) == 0;  // bf16 pairs of a row on 4-byte boundaries
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + g8 + 8 * r;
    if (row >= a.Sq) continue;
    bf16* drow = dqg + ((long long)b * a.Sq + row) * qstride + (long long)h * a.hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col >= a.hd) break;
      const float x0 = dq[j][2 * r], x1 = dq[j][2 * r + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(drow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        drow[col] = __float2bfloat16(x0);
        if (col + 1 < a.hd) drow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// a paired f32 kernel at W = WIDE: a cluster of 2 CTAs (blockIdx.y) of 8
// warps, given its arguments
template <typename K, typename... P>
cudaError_t launch_pair(K kernel, long long grid, int smem, cudaStream_t st, const P&... args) {
  cudaError_t e;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  kernel<<<dim3((unsigned)grid, 2), 256, smem, st>>>(args...);
  return cudaGetLastError();
}

// The 4-D tensor map (d, KVH, Skv, B) of k or v (f32) whose box is a
// paired kernel's ring tile: `half` + 4 columns of WKT rows of one kv
// head, so its rows land half + 4 floats apart (pair_load_kv); false where
// TMA cannot describe it (rows not 16-byte multiples on 16-byte boundaries).
bool kv_map(CUtensorMap* out, const void* p, int d, int half, const Args& a) {
  if (d % 4 || reinterpret_cast<uintptr_t>(p) % 16) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)a.KVH, (cuuint64_t)a.Skv, (cuuint64_t)a.B};
  cuuint64_t strides[3] = {(cuuint64_t)d * 4, (cuuint64_t)a.KVH * d * 4,
                           (cuuint64_t)a.Skv * a.KVH * d * 4};
  cuuint32_t box[4] = {(cuuint32_t)half + 4, 1, (cuuint32_t)WKT, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a paired forward's or dq's launch: its K / V tensor maps where both
// rows take them (a.tma), else cp.async tiles
template <typename K>
int launch_pair_kv(K kernel, Args a, long long grid, int smem, cudaStream_t st) {
  CUtensorMap mk, mv;
  std::memset(&mk, 0, sizeof(mk));
  std::memset(&mv, 0, sizeof(mv));
  a.tma = kv_map(&mk, a.k, a.hd, half_cols(a.hd), a) && kv_map(&mv, a.v, a.hdv, half_cols(a.hdv), a);
  return (int)launch_pair(kernel, grid, smem, st, a, mk, mv);
}

// W: the tile width, 64, 128 or WIDE (the paired kernel of 128 query rows
// a CTA, NV accumulator groups covering a CTA's half of o's columns: 2
// where it is at most 64 wide, as MLA's 128, else 4)
template <typename T, int W>
int launch_fwd(const Args& a, cudaStream_t st) {
  const int smem = fwd_smem(W, a.stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long grid = (long long)cdiv(a.Sq, a.rows) * a.H * a.B;
  if constexpr (W > CW) {
    static_assert(sizeof(T) == 4, "the bf16 forward runs on the tensor cores");
    if (a.rows != 128) return (int)cudaErrorInvalidValue;
    return half_cols(a.hdv) <= 64 ? launch_pair_kv(flash_fwd_pair_kernel<2>, a, grid, smem, st)
                                  : launch_pair_kv(flash_fwd_pair_kernel<4>, a, grid, smem, st);
  } else {
    if (a.rows != 64) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if ((e = set_smem(flash_fwd_kernel<T, W / 32>, smem)) != cudaSuccess) return (int)e;
    flash_fwd_kernel<T, W / 32><<<(unsigned)grid, FWD_THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
}

// the group sum of the dk/dv partials, where there are any (G > 1)
template <typename T>
int sum_parts(const Args& a, cudaStream_t st) {
  if (!a.ws) return (int)cudaSuccess;
  const long long ndk = (long long)a.B * a.Skv * a.KVH * a.hd;
  const long long ndv = (long long)a.B * a.Skv * a.KVH * a.hdv;
  flash_dkv_sum_kernel<T><<<(unsigned)((ndk + ndv + 255) / 256), 256, 0, st>>>(
      a.ws, static_cast<T*>(a.o1), static_cast<T*>(a.o2), ndk, ndv, a.parts);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_dkv(const Args& a, cudaStream_t st) {
  const int smem = dkv_smem(a.rows, W, a.stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const long long grid = (long long)cdiv(a.Skv, a.rows) * a.B * a.KVH * a.parts;
  if constexpr (W > CW) {
    static_assert(sizeof(T) == 4, "bf16 dk/dv runs on the tensor cores");
    // NK / NV accumulator groups cover a warp's quarter of the columns
    // (2 / 1 where the v quarters are at most 32 wide, as MLA's 192 / 128)
    if (a.rows != 64) return (int)cudaErrorInvalidValue;
    e = half_cols(a.hdv) / 2 <= 32 ? launch_pair(flash_dkv_pair_kernel<2, 1>, grid, smem, st, a)
                                   : launch_pair(flash_dkv_pair_kernel<2, 2>, grid, smem, st, a);
    if (e != cudaSuccess) return (int)e;
  } else {
    if ((e = set_smem(flash_dkv_kernel<T, W / 32>, smem)) != cudaSuccess) return (int)e;
    flash_dkv_kernel<T, W / 32><<<(unsigned)grid, 2 * a.rows, smem, st>>>(a);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return sum_parts<T>(a, st);
}

// the bf16 kernels on the tensor cores, at D = W
template <int W>
int launch_fwd_tc(const Args& a, cudaStream_t st) {
  const int smem = fwd_tc_smem(W, a.rows, a.stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = set_smem(flash_fwd_tc_kernel<W>, smem)) != cudaSuccess) return (int)e;
  const long long grid = (long long)cdiv(a.Sq, a.rows) * a.H * a.B;
  flash_fwd_tc_kernel<W><<<(unsigned)grid, 2 * a.rows, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int launch_dkv_tc(const Args& a, cudaStream_t st) {
  const int smem = dkv_tc_smem(a.rows, W, a.stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = set_smem(flash_dkv_tc_kernel<W>, smem)) != cudaSuccess) return (int)e;
  const long long grid = (long long)cdiv(a.Skv, a.rows) * a.B * a.KVH * a.parts;
  flash_dkv_tc_kernel<W><<<dim3((unsigned)grid, a.slices), 2 * a.rows, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return sum_parts<bf16>(a, st);
}

template <int W>
int launch_dq_tc(const Args& a, cudaStream_t st) {
  const int smem = dq_tc_smem(a.rows, W, a.stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = set_smem(flash_dq_tc_kernel<W>, smem)) != cudaSuccess) return (int)e;
  const long long grid = (long long)cdiv(a.Sq, a.rows) * a.H * a.B;
  flash_dq_tc_kernel<W><<<(unsigned)grid, 2 * a.rows, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// at W = WIDE the paired kernel, NK accumulator groups and NT tails
// covering a warp's quarter of dq's columns (1 + 0 where they are at most
// 32 wide, 1 + 1 up to 48, as MLA's, else 2 + 0)
template <typename T, int W>
int launch_dq(const Args& a, cudaStream_t st) {
  const int smem = dq_smem(a.rows, W, a.stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const long long grid = (long long)cdiv(a.Sq, a.rows) * a.H * a.B;
  if constexpr (W > CW) {
    static_assert(sizeof(T) == 4, "the bf16 dq runs on the tensor cores");
    if (a.rows != 64) return (int)cudaErrorInvalidValue;
    const int quarter = half_cols(a.hd) / 2;
    return quarter <= 32   ? launch_pair_kv(flash_dq_pair_kernel<1, 0>, a, grid, smem, st)
           : quarter <= 48 ? launch_pair_kv(flash_dq_pair_kernel<1, 1>, a, grid, smem, st)
                           : launch_pair_kv(flash_dq_pair_kernel<2, 0>, a, grid, smem, st);
  } else {
    if ((e = set_smem(flash_dq_kernel<T, W / 32>, smem)) != cudaSuccess) return (int)e;
    flash_dq_kernel<T, W / 32><<<(unsigned)grid, 2 * a.rows, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

bool valid(int B, int Sq, int Skv, int H, int KVH, int hd, int hdv) {
  return B > 0 && Sq > 0 && Skv > 0 && KVH > 0 && H % KVH == 0 && hd > 0 && hdv > 0 &&
         hd <= WIDE && hdv <= WIDE && B <= 65535 && H <= 65535;
}

// the tile width of a call: max(hd, hd_v) rounded up to 64, 128 or WIDE
int width(int hd, int hdv) {
  const int m = hd > hdv ? hd : hdv;
  return m <= 64 ? 64 : m <= CW ? CW : WIDE;
}

// one launch at the call's width: F32<float, W> (dtype 0) or BF16<W>
#define FLASH_DISPATCH(F32, BF16, dtype, a, st)                                           \
  do {                                                                                     \
    const int W_ = width((a).hd, (a).hdv);                                                \
    if ((dtype) == 0)                                                                      \
      return W_ == 64 ? F32<float, 64>(a, st) : W_ == CW ? F32<float, CW>(a, st)          \
                                                         : F32<float, WIDE>(a, st);       \
    return W_ == 64 ? BF16<64>(a, st) : W_ == CW ? BF16<CW>(a, st) : BF16<WIDE>(a, st);   \
  } while (0)

// a launch's Args from its arguments; false where the plan is not one the
// kernels take
bool make_args(Args& a, int dtype, int B, int Sq, int Skv, int H, int KVH, int hd, int hdv,
               int causal, float scale, int rows, int stages) {
  if (!valid(B, Sq, Skv, H, KVH, hd, hdv) || dtype < 0 || dtype > 1) return false;
  if (stages < 1 || stages > 2 || (rows != 64 && rows != 128)) return false;
  a.B = B, a.Sq = Sq, a.Skv = Skv, a.H = H, a.KVH = KVH, a.hd = hd, a.hdv = hdv;
  a.causal = causal, a.scale = scale;
  a.rows = rows, a.stages = stages;
  a.slices = width(hd, hdv) > CW ? cdiv(hd > hdv ? hd : hdv, CW) : 1;
  // rows of 16-byte multiples on 16-byte boundaries: 16-byte cp.async
  // copies, else 4-byte (f32) or 2-byte (bf16) ones
  const int es = dtype == 0 ? 4 : 2;
  a.vec_q = hd * es % 16 == 0 && aligned16(a.q);
  a.vec_k = hd * es % 16 == 0 && aligned16(a.k);
  a.vec_v = hdv * es % 16 == 0 && aligned16(a.v);
  a.vec_o = hdv * es % 16 == 0 && aligned16(a.dout);
  return true;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv
// alike; lse and delta are f32).  The plan's arguments (stages, rows,
// heads, parts, ws) are kernels/flash_attn.py::_flash_plan's.  Each
// returns the cudaError_t of its launch (0 on success).
// rows: the query rows of a forward CTA, 16 a warp; f32 takes 64 up to W
// = 128 and 128 past it (a CTA of a pair), bf16 64 or 128.
extern "C" int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                                float* lse, int B, int Sq, int Skv, int H, int KVH, int hd,
                                int hdv, int causal, float scale, int stages, int rows,
                                void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.o1 = o, a.lse_out = lse;
  if (!make_args(a, dtype, B, Sq, Skv, H, KVH, hd, hdv, causal, scale, rows, stages))
    return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_fwd, launch_fwd_tc, dtype, a, static_cast<cudaStream_t>(stream));
}

// rows: the query rows of a dq CTA, 16 a warp (64 or 128; the paired f32
// kernel past W = 128: 64); stages: its K/V ring's, which f32 fixes at
// DQ_STAGES up to W = 128 and the paired f32 kernel and bf16 take as 1 or 2.
extern "C" int flash_dq_launch(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta, void* dq,
                               int B, int Sq, int Skv, int H, int KVH, int hd, int hdv,
                               int causal, float scale, int rows, int stages, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse_in = lse, a.delta = delta, a.o1 = dq;
  if (!make_args(a, dtype, B, Sq, Skv, H, KVH, hd, hdv, causal, scale, rows, stages) ||
      (dtype == 0 && width(hd, hdv) <= CW && stages != DQ_STAGES))
    return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dq, launch_dq_tc, dtype, a, static_cast<cudaStream_t>(stream));
}

// ws: `parts` f32 partials of dk then of dv (parts x B x Skv x KVH x (hd
// + hd_v) floats), required where G > 1, null where G = 1.
extern "C" int flash_dkv_launch(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta, void* dk,
                                void* dv, int B, int Sq, int Skv, int H, int KVH, int hd,
                                int hdv, int causal, float scale, int rows, int stages,
                                int heads, int parts, float* ws, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.dout = dout, a.lse_in = lse, a.delta = delta;
  a.o1 = dk, a.o2 = dv, a.ws = ws;
  if (!make_args(a, dtype, B, Sq, Skv, H, KVH, hd, hdv, causal, scale, rows, stages) ||
      heads < 1 || parts != cdiv(H / KVH, heads) || (H / KVH > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  a.heads = heads, a.parts = parts;
  FLASH_DISPATCH(launch_dkv, launch_dkv_tc, dtype, a, static_cast<cudaStream_t>(stream));
}
