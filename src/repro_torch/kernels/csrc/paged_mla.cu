// Paged absorbed-MLA attention for Hopper (sm_90a): decode and chunked
// prefill over the paged latent arena (c_kv, k_rope) that every head of a
// lane shares.
//
// Replaces, in kernels/paged_attn.py of the JAX package:
//   paged_mla_decode_pallas (_mla_kernel)                -> paged_mla_decode_launch
//   paged_mla_prefill_pallas (_mla_prefill_kernel)       -> paged_mla_prefill_launch
//
// Layouts (the reference's): q_abs (S, C, H, r) pre-absorbed queries and
// q_rope (S, C, H, rd), with C = 1 for decode; ckv arena (NB, bs, r) and
// krope arena (NB, bs, rd); tables (S, W) int32 physical page ids in
// logical order, dead columns repeating the last live id; lengths (S,)
// valid rows including the chunk; starts (S,) absolute position of chunk
// row 0 (prefill only; a decode query sits at position length - 1).  The
// output is the latent mix o_lat = softmax(s) @ c_kv, (S, C, H, r) in q's
// dtype, with s = (q_abs . c_kv + q_rope . k_rope) * scale.  As in the
// reference: scores and the online-softmax state (m, l, acc) are f32, p is
// rounded to the latent type before p @ c_kv while l sums the f32 p, there
// is no soft cap, a masked p is exactly 0, a lane of length 0 writes zeros,
// and chunk rows at or past the lane's length attend to every live column.
//
// What bounds it on the H100.  Every head of a lane reads the same latent
// rows: the key is [c_kv | k_rope] (576 wide at full width), the value is
// c_kv (512).  Decode (phase 3: 8 lanes, 128 heads, lengths 0-545) moves
// ~1.5 MB of live latents and q / o: ~0.001 ms of bytes, so it is latency
// that bounds it, and the design goal is enough CTAs and a short serial
// chain in each.  Prefill (C = 64 chunk rows x 128 heads a lane) moves
// 143 MB of q in and o out (0.043 ms) and does ~16.5 GFLOP of products
// (0.017 ms on the bf16 tensor cores): bytes first, then the tensor-core
// rate.  The first kernel did every 576-term dot serially on CUDA cores
// from f32 shared rows (two shared loads an FMA), staged each 16-row page
// synchronously, and ran 64 CTAs at decode: 1.02 / 3.64 ms.
//
// This kernel:
//   * a CTA owns RB flattened query rows of one lane (row i is chunk row
//     i / H, head i % H, at position start + i / H) and one split of the
//     lane's page columns: grid (splits, row blocks, S).  RB = 64 in bf16
//     (one wgmma M), 32 in f32.  Its warps form two halves (in bf16 two
//     warpgroups).  For each latent tile half 0 computes S = Q K^T over
//     the whole 576-deep key and the online softmax (exp2 of log2(e)-scaled
//     scores) while half 1 issues the next tile's copies; half 0 passes p
//     (rounded to the latent type) and each row's correction through
//     shared memory; then each half computes O += P V for half of the 512
//     value columns (128 f32 accumulators a thread).  A 64-row block's
//     64 x 512 f32 O would not fit one warpgroup's registers; this is
//     FlashMLA's split (DeepSeek's public Hopper decode kernel).
//   * bf16: both products run on wgmma (m64n64k16 for S, m64n128k16 twice
//     or m64n64k16 for O, f32 accumulate) straight from shared memory.
//     f32 (no TF32) runs the same tiles and register layout on CUDA cores.
//   * the latents stream in tiles of KT = 64 rows (32 for f32) gathered
//     across pages (one table entry a row, read a tile ahead) through a
//     two-stage ring of 16-byte cp.async copies, or element copies where an
//     arena, r or rd is not 16-byte aligned.  In bf16 a tile is stored as
//     (r + rd) / 64 blocks of 64 rows x 128 bytes in wgmma's 128-byte
//     swizzle: K-major for S, and its first blocks are the MN-major V of
//     P V; Q is stored the same way.  Q 72 KB + two 72 KB stages + P 8 KB:
//     ~226 KB of the 227 KB a CTA may take, so one CTA an SM.  f32 rows are
//     r + rd rounded up to 64 elements, XOR-swizzled by row.
//   * the causal mask runs only on a tile that reaches past a row's limit.
//     At H >= 64 a tile's rows are heads of one chunk row, so only the
//     last tile of a CTA is masked; at H < 64 a tile spans chunk rows and
//     the limit is per row.  A CTA walks only the tiles below its last
//     row's limit.
//   * split-KV (kernels/paged_mla.py::_mla_plan): while the lanes' row
//     blocks fill at most half the card, the page columns are cut into
//     splits of whole tiles, at most one CTA an SM and at most 1 MB of
//     partials for the merge.  A split past its CTA's limit returns at
//     once.  Live splits write f32 partials (m, l, unnormalised acc) to a
//     workspace the wrapper allocates and take a ticket; the last merges
//     them in ascending split order and resets the ticket: one launch a
//     call, bitwise from run to run.
//   * what was measured on the way (launch/bench_mla.py, launch/probe_mla.py;
//     PERF.md, findings): the same split on mma.sync with both halves sharing
//     S, then on wgmma with S split by columns, spent ~8,000 cycles a tile:
//     ~4,200 in S and the copy issue, ~2,000 in an expf softmax and the
//     halves' exchange of row maxima.  Neither copies of whole 128-byte
//     blocks nor Q and the tiles by TMA (one box a page run and 64-wide
//     block, an mbarrier a stage) were faster than these cp.async copies.
//     This design spends ~6,650 cycles a tile, ~3,500 of them in P V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;        // latent tiles in the ring
constexpr int SMEM_MAX = 232448;
constexpr int MAX_R = 512, MAX_RD = 64, MAX_KEY = 576;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Shared-memory matrix descriptor of a 128-byte-swizzled tile (as
// rsa_psum.cu's).  K-major (rows of 64 k): 8-row groups 1024 bytes apart,
// LBO unused (16).  MN-major (rows of 64 n, one per k): 8-k groups 1024
// bytes apart, 64-wide panels `lbo` bytes apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// d (64 x N, f32, wgmma's accumulator layout) += A (64 x 16) B (16 x N),
// both bf16 in shared memory; TB = 1: B MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
struct MlaArgs {
  const void* qa;
  const void* qr;
  const void* ckv;
  const void* krope;
  void* o;
  const int* tables;
  const int* starts;    // prefill (S,); null for decode
  const int* lengths;
  int C, H, r, rd, NB, bs, W;
  float scale;
  int dk;               // shared row width (elements): r + rd rounded up to 64, >= DV
  int rblocks;          // RB-row blocks of a lane's C * H rows
  int nsplit, pages;    // splits a unit, page columns each
  int vec_q, vec_kv;    // rows copyable in 16-byte pieces
  float* ws;            // nsplit partials a unit: RB m, RB l, RB x DV acc
  int* tickets;         // one zeroed int a unit
};

// Register layout (both types; wgmma's and mma.sync's accumulator
// layout): lane = 4 g + t of warp w holds CTA rows 16 (w % G) + g and
// 16 (w % G) + g + 8, G = RB / 16 groups of 16 rows, and its half h = w / G
// (in bf16 its warpgroup) owns the O columns h * DV / 2 + 8 j + 2 t +
// {0, 1} (j < NV) in o[j][0..1] (first row) and o[j][2..3] (second row).
// Half 0 also holds S: tile columns 8 j + 2 t + {0, 1} (j < NJ) in s[j].
template <typename T, int DV>
__global__ void __launch_bounds__(256, 1) paged_mla_kernel(const MlaArgs p) {
  constexpr int ES = (int)sizeof(T);
  constexpr bool TC = ES == 2;             // bf16: wgmma
  constexpr int RB = TC ? 64 : 32;         // query rows of a CTA
  constexpr int KT = TC ? 64 : 32;         // latent rows of a tile
  constexpr int NT = RB * 4;               // two halves of RB / 16 warps
  constexpr int NH = NT / 2;               // threads of a half
  constexpr int G = RB / 16;               // 16-row groups
  constexpr int NJ = KT / 8;               // 8-column S tiles of half 0
  constexpr int NV = DV / 16;              // 8-column O tiles of a warp
  constexpr int EPC = 16 / ES;             // elements of a 16-byte piece
  constexpr int PRS = (KT + 4) * 4;        // f32 p row (bytes)
  static_assert(!TC || DV >= 128, "a warpgroup's wgmma n is 64, 128 or 2 x 128");
  const bool prefill = p.starts != nullptr;
  const int split = blockIdx.x, s = blockIdx.z;
  const int row0 = blockIdx.y * RB;
  const int unit = blockIdx.z * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform by construction (a shuffle from lane 0), so ptxas sees the
  // wgmma path as convergent
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int grp = warp % G, half = warp / G;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rows_lane = p.C * p.H;
  const int nrows = min(RB, rows_lane - row0);
  const int rsb = p.dk * ES;               // bytes of a row's pieces
  const int cpr = rsb >> 4;                // 16-byte pieces a row
  const float sl2 = p.scale * LOG2E;       // scores in log2 units: p = 2^(x - m)
  const int* trow = p.tables + (long long)s * p.W;
  const int span = p.pages * p.bs;
  const int c_begin = split * span;
  const int c_cap = min((split + 1) * p.pages, p.W) * p.bs;   // the split's columns
  // thread r < KT reads the table entry of row r of a tile (a column below
  // W always names a page: dead ones repeat the last live id); those of the
  // first STAGES tiles go out beside the length, so the reads share a trip
  auto entry = [&](int t) -> int {
    const int col = c_begin + t * KT + tid;
    return tid < KT && col < c_cap ? trow[col / p.bs] : -1;
  };
  int pe[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i) pe[i] = entry(i);
  const int len = __shfl_sync(0xffffffffu, p.lengths[s], 0);
  const int q0 = prefill ? __shfl_sync(0xffffffffu, p.starts[s], 0) : len - 1;
  // the columns any row of the CTA attends: [0, limit), its last row's reach
  int limit = min(len, q0 + (row0 + nrows - 1) / p.H + 1);
  limit = max(0, min(limit, p.W * p.bs));
  const int nlive = max(1, min(p.nsplit, (limit + span - 1) / span));
  if (split >= nlive) return;                    // past the CTA's limit
  const int c_end = min(limit, c_cap);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + KT - 1) / KT : 0;

  // this thread's two rows, and the columns each attends: [0, rl)
  const int r0 = grp * 16 + g8, r1 = r0 + 8;
  auto row_limit = [&](int rr) -> int {
    if (rr >= nrows) return 0;
    return min(c_end, min(len, q0 + (row0 + rr) / p.H + 1));
  };
  const int rl0 = row_limit(r0), rl1 = row_limit(r1);

  // Shared memory.  bf16: the wgmma operands' 128-byte-swizzled layout, a
  // tile of n rows as dk / 64 blocks of n x 128 bytes (64 elements a row,
  // piece j of row r at piece j ^ (r % 8)): Q and a latent tile are K-major
  // operands of S = Q K^T, a latent tile's first DV / 64 blocks are the
  // MN-major V of O += P V, and P (64 x 64) is one K-major block.  f32:
  // rows of dk elements, pieces swizzled the same way.
  extern __shared__ unsigned char msm_raw[];
  unsigned char* msm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(msm_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = msm;                                   // RB query rows
  unsigned char* ring = qs + RB * rsb;                       // STAGES x KT latent rows
  unsigned char* pex = ring + STAGES * KT * rsb;             // p: bf16 64 x 64; f32 RB x PRS
  float* csh = reinterpret_cast<float*>(pex + (TC ? RB * KT * 2 : RB * PRS));  // RB corrections
  float* lsh = csh + RB;                                     // RB row sums
  int* pgs = reinterpret_cast<int*>(lsh + RB);               // STAGES x KT arena rows
  __shared__ int last;
  // byte offset of piece c of row rr of an n-row tile
  auto soff = [&](int rr, int c, int n) -> int {
    if constexpr (TC) return (c >> 3) * (n * 128) + rr * 128 + (((c & 7) ^ (rr & 7)) << 4);
    return rr * rsb + ((c ^ (rr & 7)) << 4);
  };

  const T* QA = static_cast<const T*>(p.qa);
  const T* QR = static_cast<const T*>(p.qr);
  const T* CKV = static_cast<const T*>(p.ckv);
  const T* KR = static_cast<const T*>(p.krope);
  const int cr = p.r * ES / 16, cd = p.rd * ES / 16;  // pieces of c_kv, k_rope (vec)
  // `n` shared rows of [a (r) | b (rd) | 0], by `nth` threads (this one
  // `lt` of them): row rr from row index(rr) of the two sources (-1:
  // zeros).  16-byte cp.async pieces where `vec` (nth / n threads a row,
  // each every (nth / n)-th piece), else element by element.
  auto fill = [&](unsigned char* dst, int n, const T* A, const T* B, auto&& index, bool vec,
                  int lt, int nth) {
    if (vec) {
      const int tpr = nth / n, rr = lt / tpr;
      const long long i = index(rr);
      const T* a = A + (i >= 0 ? i * p.r : 0);
      const T* b = B + (i >= 0 ? i * p.rd : 0);
      for (int c = lt % tpr; c < cpr; c += tpr) {
        const T* src = A;
        int bytes = 0;
        if (i >= 0 && c < cr) {
          src = a + c * EPC;
          bytes = 16;
        } else if (i >= 0 && c < cr + cd) {
          src = b + (c - cr) * EPC;
          bytes = 16;
        }
        cp_async16(dst + soff(rr, c, n), src, bytes);
      }
    } else {
      for (int idx = lt; idx < n * p.dk; idx += nth) {
        const int rr = idx / p.dk, d = idx - rr * p.dk;
        const long long i = index(rr);
        T x = from_f<T>(0.f);
        if (i >= 0 && d < p.r) x = A[i * p.r + d];
        else if (i >= 0 && d < p.r + p.rd) x = B[i * p.rd + (d - p.r)];
        *reinterpret_cast<T*>(dst + soff(rr, d / EPC, n) + (d % EPC) * ES) = x;
      }
    }
  };
  // the arena row (page * bs + offset) of row tid of tile t, from its table
  // entry; -1 past the split's live columns
  auto arow = [&](int t, int pg) -> int {
    const int col = c_begin + t * KT + tid;
    if (col >= c_end) return -1;
    if (pg < 0 || pg >= p.NB) __trap();          // a table naming no arena page
    return pg * p.bs + col % p.bs;
  };
  auto load = [&](int st, int lt, int nth) {
    const int* rows = pgs + st * KT;
    fill(ring + st * KT * rsb, KT, CKV, KR, [&](int rr) -> long long { return rows[rr]; },
         p.vec_kv, lt, nth);
  };

  // the query rows (zero past the CTA's rows), then the first tiles, by
  // every thread
  {
    const long long qbase = (long long)s * rows_lane + row0;
    fill(qs, RB, QA, QR, [&](int rr) -> long long { return rr < nrows ? qbase + rr : -1; },
         p.vec_q, tid, NT);
  }
  int preg = pe[STAGES - 1];
  if (tid < KT) {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) pgs[i * KT + tid] = arow(i, pe[i]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load(i, tid, NT);
    cp_async_commit();                            // group 0 holds the queries too
  }

  float o[NV][4], mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const int vcol = half * (DV / 2);              // this warp's O columns

  for (int t = 0; t < ntiles; ++t) {
    const int nxt = t + STAGES - 1;
    if (tid < KT) {                               // that slot's last reader passed a barrier
      pgs[(nxt % STAGES) * KT + tid] = arow(nxt, preg);
      preg = entry(nxt + 1);
    }
    cp_async_wait<STAGES - 2>();
    if constexpr (TC) fence_proxy_async();        // the copies, seen by wgmma
    __syncthreads();                              // tile t landed; tile t - 1 is free
    const unsigned char* ks = ring + (t % STAGES) * KT * rsb;
    float cr0, cr1;                               // this tile's O corrections
    if (half == 1) {
      // half 1 issues the next tile's copies while half 0 computes S
      if (nxt < ntiles) load(nxt % STAGES, tid - NH, NH);
    } else {
      const int c0 = c_begin + t * KT;
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;

      // S = Q K^T over the tile's KT latent rows and the whole key depth
      if constexpr (TC) {
        const uint32_t qa = smem_addr(qs), ka = smem_addr(ks);
        // the zeroed accumulators are defined before the wgmmas start (a
        // definition ptxas sees inside the run would serialize them)
        fence_regs<NJ * 4>(&sc[0][0]);
        wgmma_fence();
        for (int kb = 0; kb < p.dk / 64; ++kb) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_n64<0, 0>(&sc[0][0], gmma_desc(qa + kb * RB * 128 + j * 32, 16),
                            gmma_desc(ka + kb * KT * 128 + j * 32, 16));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NJ * 4>(&sc[0][0]);
      } else {
#pragma unroll 2
        for (int c = 0; c < cpr; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(qs + soff(r0, c, RB));
          const float4 y = *reinterpret_cast<const float4*>(qs + soff(r1, c, RB));
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 kv =
                  *reinterpret_cast<const float4*>(ks + soff(8 * j + 2 * t4 + e, c, KT));
              float u = sc[j][e], w = sc[j][2 + e];
              u = fmaf(x.x, kv.x, u); u = fmaf(x.y, kv.y, u);
              u = fmaf(x.z, kv.z, u); u = fmaf(x.w, kv.w, u);
              w = fmaf(y.x, kv.x, w); w = fmaf(y.y, kv.y, w);
              w = fmaf(y.z, kv.z, w); w = fmaf(y.w, kv.w, w);
              sc[j][e] = u;
              sc[j][2 + e] = w;
            }
        }
      }

      // online softmax in log2 units: scale, then the mask (only on a tile
      // that reaches past a row's limit)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[j][x] *= sl2;
      if (!__all_sync(0xffffffffu, c0 + KT <= min(rl0, rl1))) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (c0 + 8 * j + 2 * t4 + (x & 1) >= (x < 2 ? rl0 : rl1)) sc[j][x] = NEG;
      }
      float mx0 = fmaxf(sc[0][0], sc[0][1]), mx1 = fmaxf(sc[0][2], sc[0][3]);
#pragma unroll
      for (int j = 1; j < NJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
      const float mn0 = fmaxf(mrow[0], quad_max(mx0));
      const float mn1 = fmaxf(mrow[1], quad_max(mx1));
      cr0 = exp2_ftz(mrow[0] - mn0);
      cr1 = exp2_ftz(mrow[1] - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a masked score is exactly NEG: its p is 0 even where m is NEG
          const float x = sc[j][e] > NEG ? exp2_ftz(sc[j][e] - mn0) : 0.f;
          const float y = sc[j][2 + e] > NEG ? exp2_ftz(sc[j][2 + e] - mn1) : 0.f;
          sum0 += x;
          sum1 += y;
          sc[j][e] = x;
          sc[j][2 + e] = y;
        }
      // l: this thread's share of the row sum (the quad adds up at the end)
      lrow[0] = lrow[0] * cr0 + sum0;
      lrow[1] = lrow[1] * cr1 + sum1;
      mrow[0] = mn0;
      mrow[1] = mn1;
      // p in the latent type, and the corrections, for both halves
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * t4;
        if constexpr (TC) {
          const int pc = (j ^ g8) << 4, pw = 4 * t4;   // r0 % 8 == r1 % 8 == g8
          *reinterpret_cast<uint32_t*>(pex + r0 * 128 + pc + pw) = pack_bf16(sc[j][0], sc[j][1]);
          *reinterpret_cast<uint32_t*>(pex + r1 * 128 + pc + pw) = pack_bf16(sc[j][2], sc[j][3]);
        } else {
          *reinterpret_cast<float2*>(pex + r0 * PRS + col * 4) = make_float2(sc[j][0], sc[j][1]);
          *reinterpret_cast<float2*>(pex + r1 * PRS + col * 4) = make_float2(sc[j][2], sc[j][3]);
        }
      }
      if (t4 == 0) {
        csh[r0] = cr0;
        csh[r1] = cr1;
      }
      if constexpr (TC) fence_proxy_async();      // p, seen by wgmma
    }
    cp_async_commit();
    __syncthreads();                              // p and the corrections are in
    if (half == 1) {
      cr0 = csh[r0];
      cr1 = csh[r1];
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      o[j][0] *= cr0; o[j][1] *= cr0;
      o[j][2] *= cr1; o[j][3] *= cr1;
    }

    // O += P V over the whole tile, this half's value columns
    if constexpr (TC) {
      const uint32_t pa = smem_addr(pex), va = smem_addr(ks) + (vcol / 64) * KT * 128;
      fence_regs<NV * 4>(&o[0][0]);               // the rescaled O, as for S
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint64_t da = gmma_desc(pa + kk * 32, 16);
        if constexpr (DV / 2 == 64) {
          wgmma_n64<0, 1>(&o[0][0], da, gmma_desc(va + kk * 2048, KT * 128));
        } else {
#pragma unroll
          for (int q = 0; q < DV / 256; ++q)
            wgmma_n128<0, 1>(&o[16 * q][0], da,
                             gmma_desc(va + 2 * q * KT * 128 + kk * 2048, KT * 128));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NV * 4>(&o[0][0]);
    } else {
#pragma unroll 2
      for (int u = 0; u < KT; ++u) {
        const float p0 = *reinterpret_cast<const float*>(pex + r0 * PRS + u * 4);
        const float p1 = *reinterpret_cast<const float*>(pex + r1 * PRS + u * 4);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int col = vcol + 8 * j + 2 * t4;
          const float2 x =
              *reinterpret_cast<const float2*>(ks + soff(u, col / 4, KT) + (col % 4) * 4);
          o[j][0] = fmaf(p0, x.x, o[j][0]);
          o[j][1] = fmaf(p0, x.y, o[j][1]);
          o[j][2] = fmaf(p1, x.x, o[j][2]);
          o[j][3] = fmaf(p1, x.y, o[j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // l: half 0's quad shares, summed, for both halves
  if (half == 0) {
    lrow[0] = quad_sum(lrow[0]);
    lrow[1] = quad_sum(lrow[1]);
    if (t4 == 0) {
      lsh[r0] = lrow[0];
      lsh[r1] = lrow[1];
    }
  }
  __syncthreads();
  lrow[0] = lsh[r0];
  lrow[1] = lsh[r1];

  T* out = static_cast<T*>(p.o);
  const long long obase = (long long)s * rows_lane + row0;
  const bool pairs = (p.r & 1) == 0;             // two outputs a store
  auto emit = [&](int hr, float L) {
    const long long i = (obase + (hr ? r1 : r0)) * p.r;
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int col = vcol + 8 * j + 2 * t4;
      const float a = o[j][2 * hr] * inv, b = o[j][2 * hr + 1] * inv;
      if (pairs && col + 1 < p.r) {
        if constexpr (TC)
          *reinterpret_cast<__nv_bfloat162*>(out + i + col) = __floats2bfloat162_rn(a, b);
        else
          *reinterpret_cast<float2*>(out + i + col) = make_float2(a, b);
      } else {
        if (col < p.r) out[i + col] = from_f<T>(a);
        if (col + 1 < p.r) out[i + col + 1] = from_f<T>(b);
      }
    }
  };
  if (nlive == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if ((hr ? r1 : r0) < nrows) emit(hr, lrow[hr]);
    return;
  }

  // several live splits: write this split's partial (m in log2 units, as
  // the merge reads it), and the last of them to arrive merges them all,
  // in ascending split order
  constexpr int PSZ = RB * (DV + 2);
  {
    float* part = p.ws + ((long long)unit * p.nsplit + split) * PSZ;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rr = hr ? r1 : r0;
      if (rr >= nrows) continue;
      if (t4 == 0 && half == 0) {
        __stcg(&part[rr], mrow[hr]);
        __stcg(&part[RB + rr], lrow[hr]);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j)
        __stcg(reinterpret_cast<float2*>(&part[2 * RB + rr * DV + vcol + 8 * j + 2 * t4]),
               make_float2(o[j][2 * hr], o[j][2 * hr + 1]));
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&p.tickets[unit], 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* base = p.ws + (long long)unit * p.nsplit * PSZ;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int rr = hr ? r1 : r0;
    if (rr >= nrows) continue;
    float M = NEG, L = 0.f;
    for (int sp = 0; sp < nlive; ++sp) M = fmaxf(M, __ldcg(&base[sp * PSZ + rr]));
#pragma unroll
    for (int j = 0; j < NV; ++j) o[j][2 * hr] = o[j][2 * hr + 1] = 0.f;
    for (int sp = 0; sp < nlive; ++sp) {
      const float* part = base + sp * PSZ;
      const float f = exp2_ftz(__ldcg(&part[rr]) - M);
      L += __ldcg(&part[RB + rr]) * f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float2 x = __ldcg(
            reinterpret_cast<const float2*>(&part[2 * RB + rr * DV + vcol + 8 * j + 2 * t4]));
        o[j][2 * hr] += x.x * f;
        o[j][2 * hr + 1] += x.y * f;
      }
    }
    emit(hr, L);
  }
  if (tid == 0) p.tickets[unit] = 0;
}

// The accumulator width the kernel is instantiated for: r rounded up (bf16:
// at least 128, a warpgroup's wgmma n being 64 or more).
int mla_dv(int r, bool tc) {
  return r <= 64 && !tc ? 64 : r <= 128 ? 128 : r <= 256 ? 256 : 512;
}

template <typename T>
size_t mla_smem(int dk) {
  constexpr bool TC = sizeof(T) == 2;
  constexpr int RB = TC ? 64 : 32, KT = TC ? 64 : 32;
  return 1024 + (size_t)(RB + STAGES * KT) * dk * sizeof(T) +
         (TC ? (size_t)RB * KT * 2 : (size_t)RB * (KT + 4) * 4) + sizeof(float) * 2 * RB +
         sizeof(int) * STAGES * KT;
}

template <typename T, int DV>
int launch_mla(const MlaArgs& a, int S, cudaStream_t stream) {
  constexpr int NT = sizeof(T) == 2 ? 256 : 128;
  const size_t smem = mla_smem<T>(a.dk);
  if (smem + 16 > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_mla_kernel<T, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.nsplit, a.rblocks, S);
  paged_mla_kernel<T, DV><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

int mla_dispatch(int dtype, const void* qa, const void* qr, const void* ckv, const void* krope,
                 void* o, const int* tables, const int* starts, const int* lengths, int S, int C,
                 int H, int r, int rd, int NB, int bs, int W, float scale, int rows, int dv,
                 int nsplit, int pages, float* ws, int* tickets, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (rows != (dtype == 1 ? 64 : 32) || S < 1 || S > 65535 || C < 1 || H < 1 || r < 1 || r > MAX_R || rd < 0 ||
      rd > MAX_RD || r + rd > MAX_KEY || NB < 1 || bs < 1 || W < 0 || nsplit < 1 ||
      pages < 1 || (long long)nsplit * pages < W || dv != mla_dv(r, dtype == 1) ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long rblocks = ((long long)C * H + rows - 1) / rows;
  if (rblocks > 65535 || (long long)C * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  MlaArgs a;
  a.qa = qa;
  a.qr = qr;
  a.ckv = ckv;
  a.krope = krope;
  a.o = o;
  a.tables = tables;
  a.starts = starts;
  a.lengths = lengths;
  a.C = C;
  a.H = H;
  a.r = r;
  a.rd = rd;
  a.NB = NB;
  a.bs = bs;
  a.W = W;
  a.scale = scale;
  a.dk = max((r + rd + 63) / 64 * 64, dv);
  a.rblocks = (int)rblocks;
  a.nsplit = nsplit;
  a.pages = pages;
  const bool widths = (r * esz) % 16 == 0 && (rd * esz) % 16 == 0;
  a.vec_q = widths && aligned16(qa) && (rd == 0 || aligned16(qr));
  a.vec_kv = widths && aligned16(ckv) && (rd == 0 || aligned16(krope));
  a.ws = ws;
  a.tickets = tickets;
  if (dtype == 1) {
    if (dv == 128) return launch_mla<bf16, 128>(a, S, stream);
    if (dv == 256) return launch_mla<bf16, 256>(a, S, stream);
    return launch_mla<bf16, 512>(a, S, stream);
  }
  if (dv == 64) return launch_mla<float, 64>(a, S, stream);
  if (dv == 128) return launch_mla<float, 128>(a, S, stream);
  if (dv == 256) return launch_mla<float, 256>(a, S, stream);
  return launch_mla<float, 512>(a, S, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (queries, arenas and output
// alike).  Each returns the cudaError_t of its launch (0 on success).  The
// plan (kernels/paged_mla.py::_mla_plan) gives `rows` flattened query rows
// a CTA (bf16: 64 or 16; f32: 32), `dv` (r rounded up to 64, 128, 256 or
// 512) and `nsplit` splits of `pages` page columns (nsplit * pages >= W);
// with nsplit > 1, `ws` holds nsplit partials of rows * (dv + 2) f32 a
// (lane, row block) and `tickets` one zeroed int each, left zeroed again.
// r <= 512, rd <= 64 and r + rd <= 576.
extern "C" int paged_mla_decode_launch(int dtype, const void* q_abs, const void* q_rope,
                                       const void* ckv, const void* krope, void* o,
                                       const int* tables, const int* lengths, int S, int H,
                                       int r, int rd, int NB, int bs, int W, float scale,
                                       int rows, int dv, int nsplit, int pages, float* ws,
                                       int* tickets, void* stream) {
  return mla_dispatch(dtype, q_abs, q_rope, ckv, krope, o, tables, nullptr, lengths, S, 1, H, r,
                      rd, NB, bs, W, scale, rows, dv, nsplit, pages, ws, tickets,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int paged_mla_prefill_launch(int dtype, const void* q_abs, const void* q_rope,
                                        const void* ckv, const void* krope, void* o,
                                        const int* tables, const int* starts,
                                        const int* lengths, int S, int C, int H, int r, int rd,
                                        int NB, int bs, int W, float scale, int rows, int dv,
                                        int nsplit, int pages, float* ws, int* tickets,
                                        void* stream) {
  if (starts == nullptr) return (int)cudaErrorInvalidValue;
  return mla_dispatch(dtype, q_abs, q_rope, ckv, krope, o, tables, starts, lengths, S, C, H, r,
                      rd, NB, bs, W, scale, rows, dv, nsplit, pages, ws, tickets,
                      static_cast<cudaStream_t>(stream));
}
