// Paged GQA attention for Hopper (sm_90a): decode, chunked prefill and the
// two phases of cascade (shared-prefix) decode over a physically paged KV
// arena.
//
// Replaces, in kernels/paged_attn.py of the JAX package:
//   paged_gqa_decode_pallas (_gqa_kernel)              -> paged_decode_launch
//   paged_gqa_prefill_pallas (_gqa_prefill_kernel)     -> paged_prefill_launch
//   paged_gqa_decode_lse_pallas (_gqa_lse_kernel)      -> paged_decode_lse_launch
//   paged_gqa_prefix_pallas (_gqa_prefix_kernel)       -> paged_prefix_launch
//
// Layouts (the reference's): q (S, C, KVH, G, hd) with C = 1 for decode;
// arenas (NB, bs, KVH, hd[_v]); tables (S, W) int32 physical page ids in
// logical order, dead columns repeating the last live id; lengths (S,)
// valid rows including the chunk; starts (S,) absolute position of chunk
// row 0 (prefill only; a decode query sits at position length - 1).
//
// Every kernel, as in the reference: scores and the online-softmax state
// (m, l, acc) are f32, p is rounded to the value type before
// p @ V while l sums the f32 p, an optional tanh soft cap is applied before
// the mask, and a lane of length 0 writes zeros (and, where the state is an
// output, (0, -1e30, 0)).  Dead columns are never read.
//
// Decode and decode-lse: paged_decode_kernel, a split-KV kernel.  What
// bounds it on the H100 is the bytes of the live K/V pages (about 2 KB a
// token a kv head at hd = 64 bf16), far below the card at decode sizes, so
// the design goal is bytes in flight and no serial step per page:
//   * grid (splits, KVH * row blocks, S).  Split j of a lane covers the page
//     columns [j * pages, (j + 1) * pages) of its table; the plan
//     (kernels/paged_attn.py::_decode_plan) splits only while the (lane,
//     head) CTAs would fill at most half the card.  A split past its lane's
//     length returns at once, loading nothing (split 0 serves a lane of
//     length 0).  The CTA reads its first tile's page ids beside the
//     length, and loads the query rows while its first copies fly.
//   * inside a CTA (1-4 warps), the split's live rows stream in tiles of 32
//     token rows; warp w takes tiles w, w + warps, ...  Each warp keeps its
//     own two-stage ring of 16-byte cp.async copies (a tile's rows may lie
//     on several pages; each lane reads one table entry) and its own
//     online-softmax state, and syncs only itself (__syncwarp): there is
//     no CTA-wide barrier between the query load and the end.  For a tile,
//     lane t owns token row t for the scores (the GR <= 8 query rows of
//     the kv head are f32 in shared memory, read as broadcasts), then owns
//     VD = hd_v / 32 (2-8) output columns for p @ V, reading p from a
//     per-warp shared row.  G = 4 rows are far under wgmma's 64.
//   * the warps merge their (m, l, acc) in shared memory, in warp order.
//     Where the lane has one live split, that CTA writes the output;
//     otherwise each live split writes its f32 partial (m, l, unnormalised
//     acc) to a workspace the wrapper allocates and takes an atomic ticket,
//     and the last of them merges the live splits' partials in ascending
//     split order and resets the ticket.  The result is deterministic
//     (bitwise from run to run) and each call is one launch.
//
// Prefill and the shared-prefix phase: paged_attn_tc_kernel, one kernel for
// both.  A CTA owns a tile of 64 flattened query rows of one (lane, kv
// head), in the reference's order: prefill row i is chunk row i / G, group
// head i % G; the prefix phase reads q's (S, KVH, G, hd) layout as one chunk
// of S rows, so row i is lane i / G and every lane's rows of a kv head share
// the CTA, and with it each read of a shared page.  At llama's widths phase
// 3's prefill moves ~1.2 MB and does ~0.2 GFLOP (bound 0.0018 ms on an H100
// SXM), the prefix phase ~0.8 MB (0.00025 ms): far below the card's compute
// line, so what bounds both is latency, not bytes or the MMA rate.  The old
// kernel (4 f32 warps, one 16-row page at a time, four CTA-wide barriers a
// page, a scalar hd-long dot product per score) took 0.48 and 0.36 ms on an
// "NVIDIA H100 80GB HBM3, 700.00 W"; the prefix phase had 8 CTAs on 132
// SMs.  This one:
//   * grid (splits, KVH * row tiles, S).  The plan (kernels/paged_attn.py::
//     _attn_plan) cuts the page columns into splits: the prefix phase under
//     the decode kernel's half-card rule, prefill under its own (the grid
//     waits on the lanes with the longest causal reach).  Split j covers the
//     columns [j * pages, (j + 1) * pages) of the table and stops at the
//     CTA's limit: the causal limit of its last row (and the lane's length)
//     for prefill, its rows' longest prefix for the prefix phase.  A split
//     past that limit returns at once.  Live splits write f32 partials (m,
//     l, unnormalised acc) to a workspace, take a ticket, and the last
//     merges them in ascending split order and resets the ticket: one
//     launch, bitwise from run to run.  The merge issues each split's loads
//     together, both rows of a thread at once.
//   * K/V stream in tiles of 64 token rows gathered across pages (one table
//     entry a row) through a ring of 2-3 stages of 16-byte cp.async copies,
//     element copies where the arena or hd is not 16-byte aligned.  The
//     table entries of the first tiles are read beside the lengths, later
//     ones a tile ahead into a register, and each row's arena row (page *
//     bs + offset) is staged once in shared memory.  One barrier a tile.
//   * 4 warps a CTA, 16 rows each; a tile with fewer rows (the prefix
//     phase's 32) keeps all 4, the idle ones sharing the copies, which
//     launch/bench_decode.py timed faster than 2 warps.
//   * bf16: S = Q K^T and O += P V run on
//     mma.sync.m16n8k16 (bf16 -> f32) in FlashAttention-2's register
//     layout, the online-softmax state (m, l) in registers.  Q fragments
//     are loaded once (hd <= 128; at 256 they are re-read from shared
//     memory each tile, leaving the registers to the 128 f32 accumulators
//     of a 256-wide O), K through ldmatrix, V through ldmatrix.trans, and P
//     becomes the A operand of P V in registers.  wgmma is not used: 64-row
//     tiles of a few hundred columns are latency-bound.
//   * f32 (no TF32): the same tiles, ring, plan and register layout on CUDA
//     cores: each thread computes its 2 rows x 16 columns of S and 2 rows x
//     D / 4 columns of O, P shared across its quad by shuffles.
//   * the kernel is templated on D = max(hd, hd_v) rounded up to 64, 128 or
//     256 (zero-padded in shared memory).  The soft cap and the mask each
//     run as a pass of their own, the mask only on a tile that reaches past
//     a row's limit (the diagonal), so the common tile is one short
//     straight line.  A masked score is exactly -1e30 and its p is zeroed,
//     so a row with nothing to attend in a split keeps (m, l) = (-1e30, 0)
//     and a non-member lane comes back as exactly (0, -1e30, 0).
//   * on that card a CTA's tile costs ~4,400 cycles at one CTA an SM
//     (launch/probe_attn.py): about a quarter of it issuing the next
//     tile's 16-byte copies, a third the softmax, the MMAs far less; hence
//     the splits, which shorten each CTA's serial chain of tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ decode --

constexpr int DT = 32;          // token rows of a decode tile: one a lane
constexpr int DSTAGES = 2;      // tiles in flight per warp
constexpr int DMAXW = 4;        // warps of a decode CTA, at most
constexpr int SMEM_MAX = 232448;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* m;             // (S, KVH * G) f32 state outputs, or null
  float* l;
  const int* tables;
  const int* lengths;
  int KVH, G, hd, hdv, NB, bs, W;
  float scale, cap;
  int rblocks;          // row blocks of GR query rows a kv head
  int nsplit, pages;    // splits a (lane, head, row block), page columns each
  int kw, vw;           // shared row widths (elements): hd, hd_v rounded up
  int kstride, vstride; // shared row strides (bytes)
  int vec_k, vec_v;     // rows copyable in 16-byte pieces
  float* ws;            // nsplit partials a unit: GR m, GR l, GR x vw acc
  int* tickets;         // one zeroed int a unit
};

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

// N consecutive elements at src (aligned to N * sizeof(T)) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* src, float (&out)[N]) {
  constexpr int B = N * (int)sizeof(T);
  constexpr int E = 16 / (int)sizeof(T);
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int j = 0; j < B / 16; ++j) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[j];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int x = 0; x < E; ++x) out[j * E + x] = to_f(e[x]);
    }
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int x = 0; x < N; ++x) out[x] = to_f(e[x]);
  } else {
    static_assert(B == 4, "load_f: 4, 8 or a multiple of 16 bytes");
    const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int x = 0; x < N; ++x) out[x] = to_f(e[x]);
  }
}

// The 32 token rows of a tile, columns [c0, c0 + 32) of the lane, head h,
// `width` elements each, into shared rows of `stride` bytes: 16-byte
// cp.async copies where the rows allow (`vec`), else ordinary loads.  Lane
// r holds the page of row r (-1 past the split's live rows: zero-filled).
template <typename T>
__device__ __forceinline__ void copy_tile(unsigned char* dst, int stride, const T* arena,
                                          int width, int wpad, int page, int c0, int h,
                                          const DecodeArgs& p, int lane, bool vec) {
  if (vec) {
    const int ch = width * (int)sizeof(T) / 16;   // 16-byte pieces a row
    for (int idx = lane; idx < DT * ch; idx += 32) {
      const int r = idx / ch, c = idx - r * ch;
      const int pg = __shfl_sync(0xffffffffu, page, r);
      const T* src = arena;
      if (pg >= 0)
        src += (((long long)pg * p.bs + (c0 + r) % p.bs) * p.KVH + h) * width +
               c * (16 / (int)sizeof(T));
      cp_async16(dst + r * stride + c * 16, src, pg >= 0 ? 16 : 0);
    }
  } else {
    for (int idx = lane; idx < DT * wpad; idx += 32) {
      const int r = idx / wpad, d = idx - r * wpad;
      const int pg = __shfl_sync(0xffffffffu, page, r);
      T v = from_f<T>(0.f);
      if (pg >= 0 && d < width)
        v = arena[(((long long)pg * p.bs + (c0 + r) % p.bs) * p.KVH + h) * width + d];
      reinterpret_cast<T*>(dst + r * stride)[d] = v;
    }
  }
}

template <typename T, int GR, int VD>
__global__ void __launch_bounds__(DMAXW * 32)
paged_decode_kernel(const DecodeArgs p) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int split = blockIdx.x, h = blockIdx.y / p.rblocks, s = blockIdx.z;
  const int g0 = (blockIdx.y % p.rblocks) * GR;
  const int unit = blockIdx.z * gridDim.y + blockIdx.y;
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c_begin = split * p.pages * p.bs;
  const int c_cap = min((split + 1) * p.pages, p.W) * p.bs;   // the split's columns
  const int* trow = p.tables + (long long)s * p.W;
  // the page of this lane's row in the warp's first tile, read beside the
  // length (a table column below W always names a page; dead ones repeat
  // the last live id), so the two reads share one round trip
  const int col0 = c_begin + warp * DT + lane;
  const int page0 = col0 < c_cap ? trow[col0 / p.bs] : -1;
  const int len = max(0, min(p.lengths[s], p.W * p.bs));
  // the splits that hold rows of this lane; split 0 stands for an empty lane
  const int span = p.pages * p.bs;
  const int nlive = max(1, min(p.nsplit, (len + span - 1) / span));
  if (split >= nlive) return;                     // past the lane's length
  const int c_end = min(len, c_cap);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + DT - 1) / DT : 0;
  const int stage = DT * (p.kstride + p.vstride);

  extern __shared__ __align__(16) unsigned char dsm[];
  float* qs = reinterpret_cast<float*>(dsm);        // GR x kw
  float* ps = qs + GR * p.kw;                       // nw x GR x DT
  unsigned char* ring = reinterpret_cast<unsigned char*>(ps + nw * GR * DT);
  __shared__ int last;

  float m[GR], l[GR], acc[GR][VD];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VD; ++i) acc[g][i] = 0.f;
  }
  unsigned char* wring = ring + warp * DSTAGES * stage;
  float* wps = ps + warp * GR * DT;
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  const int d0 = lane * VD;                         // this lane's p @ V columns

  auto load = [&](int t, int st) {
    const int c0 = c_begin + t * DT, col = c0 + lane;
    int page = -1;
    if (col < c_end) {
      page = t == warp ? page0 : trow[col / p.bs];
      if (page < 0 || page >= p.NB) __trap();       // a table naming no arena page
    }
    unsigned char* kd = wring + st * stage;
    copy_tile<T>(kd, p.kstride, K, p.hd, p.kw, page, c0, h, p, lane, p.vec_k);
    copy_tile<T>(kd + DT * p.kstride, p.vstride, V, p.hdv, p.vw, page, c0, h, p, lane, p.vec_v);
  };

  const int mine = ntiles > warp ? (ntiles - warp + nw - 1) / nw : 0;
#pragma unroll
  for (int i = 0; i < DSTAGES - 1; ++i) {
    if (i < mine) load(warp + i * nw, i);
    cp_async_commit();
  }
  // the query rows, while the first copies are in flight
  const T* q = static_cast<const T*>(p.q) + ((long long)s * p.KVH + h) * p.G * p.hd;
  for (int idx = threadIdx.x; idx < GR * p.kw; idx += blockDim.x) {
    const int i = idx / p.kw, d = idx - i * p.kw;
    qs[idx] = g0 + i < p.G && d < p.hd ? to_f(q[(long long)(g0 + i) * p.hd + d]) : 0.f;
  }
  __syncthreads();
  for (int i = 0; i < mine; ++i) {
    if (i + DSTAGES - 1 < mine) load(warp + (i + DSTAGES - 1) * nw, (i + DSTAGES - 1) % DSTAGES);
    cp_async_commit();
    cp_async_wait<DSTAGES - 1>();
    __syncwarp();
    const int c0 = c_begin + (warp + i * nw) * DT;
    const int live = min(DT, c_end - c0);
    const unsigned char* kt = wring + (i % DSTAGES) * stage;
    const T* vt = reinterpret_cast<const T*>(kt + DT * p.kstride);

    // scores: lane t against token row t
    float sc[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) sc[g] = 0.f;
    const T* krow = reinterpret_cast<const T*>(kt + lane * p.kstride);
    for (int d = 0; d < p.kw; d += VEC) {
      float kf[VEC];
      load_f<T, VEC>(krow + d, kf);
#pragma unroll
      for (int g = 0; g < GR; ++g) {
#pragma unroll
        for (int x = 0; x < VEC; x += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + g * p.kw + d + x);
          sc[g] = fmaf(qv.x, kf[x], sc[g]);
          sc[g] = fmaf(qv.y, kf[x + 1], sc[g]);
          sc[g] = fmaf(qv.z, kf[x + 2], sc[g]);
          sc[g] = fmaf(qv.w, kf[x + 3], sc[g]);
        }
      }
    }
    // online softmax over the tile; p in the value type for p @ V
    float corr[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float x = sc[g] * p.scale;
      if (p.cap > 0.f) x = tanhf(x / p.cap) * p.cap;
      x = lane < live ? x : NEG;
      const float mn = fmaxf(m[g], warp_max(x));
      const float pr = lane < live ? expf(x - mn) : 0.f;
      corr[g] = expf(m[g] - mn);
      l[g] = l[g] * corr[g] + warp_sum(pr);
      m[g] = mn;
      wps[g * DT + lane] = to_f(from_f<T>(pr));
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int j = 0; j < VD; ++j) acc[g][j] *= corr[g];
    if (d0 < p.vw) {
      for (int t = 0; t < live; ++t) {
        float vf[VD];
        load_f<T, VD>(reinterpret_cast<const T*>(reinterpret_cast<const unsigned char*>(vt) +
                                                 t * p.vstride) + d0, vf);
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          const float pv = wps[g * DT + t];
#pragma unroll
          for (int j = 0; j < VD; ++j) acc[g][j] = fmaf(pv, vf[j], acc[g][j]);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();                                  // every ring is idle: reuse it

  // the warps' states, merged in warp order
  float* wm = reinterpret_cast<float*>(ring);       // nw x GR
  float* wl = wm + nw * GR;
  float* wa = wl + nw * GR;                         // nw x GR x vw
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      wm[warp * GR + g] = m[g];
      wl[warp * GR + g] = l[g];
    }
  }
  if (d0 < p.vw) {
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int j = 0; j < VD; ++j) wa[(warp * GR + g) * p.vw + d0 + j] = acc[g][j];
  }
  __syncthreads();

  const int psz = GR * (p.vw + 2);
  const long long obase = ((long long)s * p.KVH + h) * p.G + g0;
  T* out = static_cast<T*>(p.o);
  {
    float* part = nlive > 1 ? p.ws + ((long long)unit * p.nsplit + split) * psz : nullptr;
    for (int idx = threadIdx.x; idx < GR * p.vw; idx += blockDim.x) {
      const int g = idx / p.vw, d = idx - g * p.vw;
      float M = NEG, L = 0.f, A = 0.f;
      for (int w = 0; w < nw; ++w) M = fmaxf(M, wm[w * GR + g]);
      for (int w = 0; w < nw; ++w) {
        const float f = expf(wm[w * GR + g] - M);
        L += wl[w * GR + g] * f;
        A += wa[(w * GR + g) * p.vw + d] * f;
      }
      if (part != nullptr) {
        if (d == 0) {
          __stcg(&part[g], M);
          __stcg(&part[GR + g], L);
        }
        __stcg(&part[2 * GR + idx], A);
      } else if (g0 + g < p.G) {
        if (d < p.hdv) out[(obase + g) * p.hdv + d] = from_f<T>(A / fmaxf(L, 1e-30f));
        if (d == 0 && p.m != nullptr) {
          p.m[obase + g] = M;
          p.l[obase + g] = L;
        }
      }
    }
  }
  if (nlive == 1) return;

  // the last of the unit's live splits to arrive merges them, ascending
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&p.tickets[unit], 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* base = p.ws + (long long)unit * p.nsplit * psz;
  for (int idx = threadIdx.x; idx < GR * p.vw; idx += blockDim.x) {
    const int g = idx / p.vw, d = idx - g * p.vw;
    if (g0 + g >= p.G) continue;
    float M = NEG, L = 0.f, A = 0.f;
    for (int j = 0; j < nlive; ++j) M = fmaxf(M, __ldcg(&base[j * psz + g]));
    for (int j = 0; j < nlive; ++j) {
      const float* part = base + j * psz;
      const float f = expf(__ldcg(&part[g]) - M);
      L += __ldcg(&part[GR + g]) * f;
      A += __ldcg(&part[2 * GR + idx]) * f;
    }
    if (d < p.hdv) out[(obase + g) * p.hdv + d] = from_f<T>(A / fmaxf(L, 1e-30f));
    if (d == 0 && p.m != nullptr) {
      p.m[obase + g] = M;
      p.l[obase + g] = L;
    }
  }
  if (threadIdx.x == 0) p.tickets[unit] = 0;
}

int row_bytes(int width, int esz) { return (width * esz + 31) / 32 * 32 + 16; }

template <typename T, int GR, int VD>
int launch_decode(DecodeArgs a, int S, int warps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)GR * a.kw + (size_t)warps * GR * DT) +
                      (size_t)warps * DSTAGES * DT * (a.kstride + a.vstride);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, GR, VD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.nsplit, a.KVH * a.rblocks, S);
  paged_decode_kernel<T, GR, VD><<<grid, warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int GR>
int launch_decode_vd(const DecodeArgs& a, int S, int warps, cudaStream_t stream) {
  const int vd = (a.hdv + 31) / 32;
  if (vd <= 2) return launch_decode<T, GR, 2>(a, S, warps, stream);
  if (vd <= 4) return launch_decode<T, GR, 4>(a, S, warps, stream);
  return launch_decode<T, GR, 8>(a, S, warps, stream);
}

template <typename T>
int launch_decode_rows(const DecodeArgs& a, int S, int rows, int warps, cudaStream_t stream) {
  if (rows == 1) return launch_decode_vd<T, 1>(a, S, warps, stream);
  if (rows == 2) return launch_decode_vd<T, 2>(a, S, warps, stream);
  if (rows == 4) return launch_decode_vd<T, 4>(a, S, warps, stream);
  return launch_decode_vd<T, 8>(a, S, warps, stream);
}

int decode_dispatch(int dtype, const void* q, const void* k, const void* v, void* o, float* m,
                    float* l, const int* tables, const int* lengths, int S, int KVH, int G,
                    int hd, int hdv, int NB, int bs, int W, float scale, float cap, int rows,
                    int warps, int nsplit, int pages, float* ws, int* tickets,
                    cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((rows != 1 && rows != 2 && rows != 4 && rows != 8) || warps < 1 || warps > DMAXW ||
      S < 1 || S > 65535 || KVH < 1 || G < 1 || hd < 1 || hdv < 1 || hdv > 256 || bs < 1 ||
      W < 0 || nsplit < 1 || pages < 1 || (long long)nsplit * pages < W ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2, vec = 16 / esz;
  DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.m = m;
  a.l = l;
  a.tables = tables;
  a.lengths = lengths;
  a.KVH = KVH;
  a.G = G;
  a.hd = hd;
  a.hdv = hdv;
  a.NB = NB;
  a.bs = bs;
  a.W = W;
  a.scale = scale;
  a.cap = cap;
  a.rblocks = (G + rows - 1) / rows;
  if ((long long)KVH * a.rblocks > 65535) return (int)cudaErrorInvalidValue;
  a.nsplit = nsplit;
  a.pages = pages;
  a.kw = (hd + vec - 1) / vec * vec;
  a.vw = (hdv + 7) / 8 * 8;
  a.kstride = row_bytes(a.kw, esz);
  a.vstride = row_bytes(a.vw, esz);
  a.vec_k = reinterpret_cast<uintptr_t>(k) % 16 == 0 && (hd * esz) % 16 == 0;
  a.vec_v = reinterpret_cast<uintptr_t>(v) % 16 == 0 && (hdv * esz) % 16 == 0;
  a.ws = ws;
  a.tickets = tickets;
  return dtype == 0 ? launch_decode_rows<float>(a, S, rows, warps, stream)
                    : launch_decode_rows<bf16>(a, S, rows, warps, stream);
}

// ------------------------------------------------- prefill and prefix --

constexpr int AT = 64;          // query rows of a CTA tile; token rows of a K/V tile
constexpr int ANT = 128;        // threads of a CTA: 4 warps of 16 query rows

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* m;             // prefix phase: (S, KVH * G) f32 state outputs
  float* l;
  const int* tables;    // prefill (S, W); prefix (1, P)
  const int* starts;    // prefill (S,); null for the prefix phase
  const int* lengths;   // prefill (S,) lane lengths; prefix (C,) prefix lengths
  int C, KVH, G, hd, hdv, NB, bs, W;
  float scale, cap;
  int rtiles;           // 64-row tiles of a (lane, kv head)
  int nsplit, pages;    // splits a unit, page columns each
  int vec_q, vec_k, vec_v;  // rows copyable in 16-byte pieces
  float* ws;            // nsplit partials a unit: 64 m, 64 l, 64 x D acc
  int* tickets;         // one zeroed int a unit
};

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Register layout (both types, mma.sync's accumulator layout): lane = 4 g +
// t of warp w holds CTA rows w * 16 + g and w * 16 + g + 8; of S its
// columns 8 j + 2 t + {0, 1} (j < 8) in s[j][0..1] (first row) and
// s[j][2..3] (second row); of O the columns 8 j + 2 t + {0, 1} (j < D / 8)
// in o[j][..] alike.
template <typename T, int D, int STAGES>
__global__ void __launch_bounds__(ANT) paged_attn_tc_kernel(const AttnArgs p) {
  constexpr int ES = (int)sizeof(T);
  constexpr int RS = D * ES + 16;          // shared row stride (bytes)
  constexpr int TILE = AT * RS;            // one 64-row tile (bytes)
  constexpr int CPR = D * ES / 16;         // 16-byte pieces a row
  constexpr int NJ = AT / 8;               // 8-column tiles of S
  constexpr int NV = D / 8;                // 8-column tiles of O
  constexpr bool TC = sizeof(T) == 2;      // bf16: tensor cores
  constexpr bool QREG = TC && D <= 128;    // Q fragments kept in registers
  const bool prefix = p.starts == nullptr;
  const int split = blockIdx.x, h = blockIdx.y / p.rtiles, s = blockIdx.z;
  const int row0 = (blockIdx.y % p.rtiles) * AT;
  const int unit = blockIdx.z * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nrows = min(AT, p.C * p.G - row0);
  const int* trow = p.tables + (long long)s * p.W;
  const int span = p.pages * p.bs;
  const int c_begin = split * span;
  const int c_cap = min((split + 1) * p.pages, p.W) * p.bs;   // the split's columns
  // thread r < 64 reads the table entry of row r of a tile (a column below
  // W always names a page: dead ones repeat the last live id); those of the
  // first STAGES tiles go out beside the lengths, so the two share a trip
  auto entry = [&](int t) -> int {
    const int col = c_begin + t * AT + tid;
    return tid < AT && col < c_cap ? trow[col / p.bs] : -1;
  };
  int pe[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i) pe[i] = entry(i);

  // the columns any row of the CTA attends: [0, limit)
  int limit, q0 = 0;
  if (prefix) {
    int mx = 0;
    for (int c = row0 / p.G + lane; c <= (row0 + nrows - 1) / p.G; c += 32)
      mx = max(mx, p.lengths[c]);
    limit = warp_max_int(mx);
  } else {
    q0 = p.starts[s];
    limit = min(p.lengths[s], q0 + (row0 + nrows - 1) / p.G + 1);
  }
  limit = max(0, min(limit, p.W * p.bs));
  const int nlive = max(1, min(p.nsplit, (limit + span - 1) / span));
  if (split >= nlive) return;                    // past the CTA's limit
  const int c_end = min(limit, c_cap);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + AT - 1) / AT : 0;

  // this thread's two rows, and the columns each attends: [0, rl)
  const int r0 = warp * 16 + g8, r1 = r0 + 8;
  auto row_limit = [&](int r) -> int {
    if (r >= nrows) return 0;
    const int c = (row0 + r) / p.G;
    return prefix ? min(c_end, p.lengths[c]) : min(c_end, q0 + c + 1);
  };
  const int rl0 = row_limit(r0), rl1 = row_limit(r1);

  extern __shared__ __align__(16) unsigned char asmem[];
  unsigned char* qs = asmem;                                  // 64 query rows
  unsigned char* ring = asmem + TILE;                         // STAGES x (K, V)
  int* pgs = reinterpret_cast<int*>(ring + STAGES * 2 * TILE);  // STAGES x 64 arena rows
  __shared__ int last;

  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  // the arena row (page * bs + offset) of row tid of tile t, from its table
  // entry; -1 past the split's live columns
  auto arow = [&](int t, int pg) -> int {
    const int col = c_begin + t * AT + tid;
    if (col >= c_end) return -1;
    if (pg < 0 || pg >= p.NB) __trap();          // a table naming no arena page
    return pg * p.bs + col % p.bs;
  };
  // 64 rows of `width` elements (zero past width, and on rows -1) into a
  // tile: 16-byte cp.async pieces, or element copies
  auto copy = [&](unsigned char* dst, const T* arena, int width, bool vec, const int* rows) {
    if (vec) {
      const int real = width * ES / 16;
      for (int idx = tid; idx < AT * CPR; idx += ANT) {
        const int r = idx / CPR, c = idx - r * CPR;
        const int row = rows[r];
        const bool live = row >= 0 && c < real;
        const T* src = arena;
        if (live) src += ((long long)row * p.KVH + h) * width + c * (16 / ES);
        cp_async16(dst + r * RS + c * 16, src, live ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < AT * D; idx += ANT) {
        const int r = idx / D, d = idx - r * D;
        const int row = rows[r];
        T x = from_f<T>(0.f);
        if (row >= 0 && d < width) x = arena[((long long)row * p.KVH + h) * width + d];
        reinterpret_cast<T*>(dst + r * RS)[d] = x;
      }
    }
  };
  auto load = [&](int st) {
    unsigned char* kd = ring + st * 2 * TILE;
    copy(kd, K, p.hd, p.vec_k, pgs + st * AT);
    copy(kd + TILE, V, p.hdv, p.vec_v, pgs + st * AT);
  };

  // the query rows (zero past the CTA's rows and past hd)
  {
    const T* Q = static_cast<const T*>(p.q);
    auto qrow = [&](int r) -> const T* {
      const int fr = row0 + r, c = fr / p.G, g = fr - c * p.G;
      return Q + ((((long long)s * p.C + c) * p.KVH + h) * p.G + g) * p.hd;
    };
    if (p.vec_q) {
      const int real = p.hd * ES / 16;
      for (int idx = tid; idx < AT * CPR; idx += ANT) {
        const int r = idx / CPR, c = idx - r * CPR;
        const bool live = r < nrows && c < real;
        cp_async16(qs + r * RS + c * 16, live ? qrow(r) + c * (16 / ES) : Q, live ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < AT * D; idx += ANT) {
        const int r = idx / D, d = idx - r * D;
        reinterpret_cast<T*>(qs + r * RS)[d] =
            r < nrows && d < p.hd ? qrow(r)[d] : from_f<T>(0.f);
      }
    }
  }
  // the arena rows of the first STAGES - 1 tiles; the next tile's table
  // entry stays in preg
  int preg = pe[STAGES - 1];
  if (tid < AT) {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) pgs[i * AT + tid] = arow(i, pe[i]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load(i);
    cp_async_commit();                            // group 0 holds the queries too
  }
  if constexpr (STAGES == 1) cp_async_commit();

  float o[NV][4], mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  uint32_t qf[QREG ? D / 16 : 1][4];
  const bool active = warp * 16 < nrows;         // warp-uniform: a warp with rows

  for (int t = 0; t < ntiles; ++t) {
    if constexpr (STAGES == 1) {
      if (tid < AT) {
        pgs[tid] = arow(t, preg);
        preg = entry(t + 1);
      }
      __syncthreads();
      load(0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      const int nxt = t + STAGES - 1;
      if (tid < AT) {                             // that slot's last reader passed a barrier
        pgs[(nxt % STAGES) * AT + tid] = arow(nxt, preg);
        preg = entry(nxt + 1);
      }
      cp_async_wait<STAGES - 2>();
      __syncthreads();                            // tile t landed; tile t - 1 is free
      if (nxt < ntiles) load(nxt % STAGES);
      cp_async_commit();
    }
    if (active) {
      const unsigned char* ks = ring + (t % STAGES) * 2 * TILE;
      const unsigned char* vs = ks + TILE;
      const int c0 = c_begin + t * AT;
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;

      // S = Q K^T
      if constexpr (TC) {
        if constexpr (QREG) {
          if (t == 0) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * RS + (kk * 16 + (lane >> 4) * 8) * 2);
          }
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          if constexpr (QREG) {
            a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
          } else {
            ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * RS + (kk * 16 + (lane >> 4) * 8) * 2);
          }
#pragma unroll
          for (int nn = 0; nn < NJ / 2; ++nn) {
            uint32_t b[4];
            ldsm_x4(b, ks + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                           (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
            mma_bf16(sc[2 * nn], a, b[0], b[1]);
            mma_bf16(sc[2 * nn + 1], a, b[2], b[3]);
          }
        }
      } else {
        const float* qa = reinterpret_cast<const float*>(qs + r0 * RS);
        const float* qb = reinterpret_cast<const float*>(qs + r1 * RS);
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qa + d);
          const float4 y = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 kv =
                  *reinterpret_cast<const float4*>(ks + (8 * j + 2 * t4 + e) * RS + d * 4);
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

      // online softmax: scale, soft cap, then the mask (only on a tile that
      // reaches past a row's limit), each a pass of its own so the common
      // tile (no cap, no mask) runs one short straight line
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[j][x] *= p.scale;
      if (p.cap > 0.f) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[j][x] = tanhf(sc[j][x] / p.cap) * p.cap;
      }
      if (!__all_sync(0xffffffffu, c0 + AT <= min(rl0, rl1))) {
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
      const float mn0 = fmaxf(mrow[0], quad_max(mx0)), mn1 = fmaxf(mrow[1], quad_max(mx1));
      const float cr0 = __expf(mrow[0] - mn0), cr1 = __expf(mrow[1] - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a masked score is exactly NEG: its p is 0 even where m is NEG
          const float x = sc[j][e] > NEG ? __expf(sc[j][e] - mn0) : 0.f;
          const float y = sc[j][2 + e] > NEG ? __expf(sc[j][2 + e] - mn1) : 0.f;
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
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        o[j][0] *= cr0; o[j][1] *= cr0;
        o[j][2] *= cr1; o[j][3] *= cr1;
      }

      // O += P V, p in the value type
      if constexpr (TC) {
#pragma unroll
        for (int kk = 0; kk < AT / 16; ++kk) {
          const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                 pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                 pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                 pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
          for (int nn = 0; nn < NV / 2; ++nn) {
            uint32_t b[4];
            ldsm_x4_t(b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                             (nn * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(o[2 * nn], a, b[0], b[1]);
            mma_bf16(o[2 * nn + 1], a, b[2], b[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            // token 8 j + u: its p sits with quad lane u / 2, as element u % 2
            const int src = (lane & ~3) | (u >> 1);
            const float p0 = __shfl_sync(0xffffffffu, sc[j][u & 1], src);
            const float p1 = __shfl_sync(0xffffffffu, sc[j][2 + (u & 1)], src);
            const float* vr = reinterpret_cast<const float*>(vs + (8 * j + u) * RS);
#pragma unroll
            for (int jj = 0; jj < NV; ++jj) {
              const float2 x = *reinterpret_cast<const float2*>(vr + 8 * jj + 2 * t4);
              o[jj][0] = fmaf(p0, x.x, o[jj][0]);
              o[jj][1] = fmaf(p0, x.y, o[jj][1]);
              o[jj][2] = fmaf(p1, x.x, o[jj][2]);
              o[jj][3] = fmaf(p1, x.y, o[jj][3]);
            }
          }
      }
    }
    if constexpr (STAGES == 1) __syncthreads();   // the stage is refilled next
  }
  cp_async_wait<0>();
  lrow[0] = quad_sum(lrow[0]);
  lrow[1] = quad_sum(lrow[1]);

  T* out = static_cast<T*>(p.o);
  // the flattened (lane, chunk row, kv head, group head) index of CTA row r
  auto orow = [&](int r) -> long long {
    const int fr = row0 + r, c = fr / p.G, g = fr - c * p.G;
    return (((long long)s * p.C + c) * p.KVH + h) * p.G + g;
  };
  auto emit = [&](int hr, float M, float L) {
    const int r = hr ? r1 : r0;
    const long long i = orow(r);
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e;
        if (col < p.hdv) out[i * p.hdv + col] = from_f<T>(o[j][2 * hr + e] / fmaxf(L, 1e-30f));
      }
    if (p.m != nullptr && t4 == 0) {
      p.m[i] = M;
      p.l[i] = L;
    }
  };
  if (nlive == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if ((hr ? r1 : r0) < nrows) emit(hr, mrow[hr], lrow[hr]);
    return;
  }

  // several live splits: write this split's partial, and the last of them
  // to arrive merges them all, in ascending split order.  Both rows of a
  // thread go together and each split's loads issue before any is used, so
  // the merge costs a few dependent trips to L2, not two a split and row.
  constexpr int PSZ = AT * (D + 2);
  {
    float* part = p.ws + ((long long)unit * p.nsplit + split) * PSZ;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = hr ? r1 : r0;
      if (r >= nrows) continue;
      if (t4 == 0) {
        __stcg(&part[r], mrow[hr]);
        __stcg(&part[AT + r], lrow[hr]);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j)
        __stcg(reinterpret_cast<float2*>(&part[2 * AT + r * D + 8 * j + 2 * t4]),
               make_float2(o[j][2 * hr], o[j][2 * hr + 1]));
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&p.tickets[unit], 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (active) {
    const float* base = p.ws + (long long)unit * p.nsplit * PSZ;
    float M[2] = {NEG, NEG}, L[2] = {0.f, 0.f};
#pragma unroll 8
    for (int sp = 0; sp < nlive; ++sp) {
      M[0] = fmaxf(M[0], __ldcg(&base[sp * PSZ + r0]));
      M[1] = fmaxf(M[1], __ldcg(&base[sp * PSZ + r1]));
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    constexpr int MU = D <= 64 ? 4 : 1;
#pragma unroll MU
    for (int sp = 0; sp < nlive; ++sp) {
      const float* part = base + sp * PSZ;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = hr ? r1 : r0;
        const float f = __expf(__ldcg(&part[r]) - M[hr]);
        L[hr] += __ldcg(&part[AT + r]) * f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float2 x =
              __ldcg(reinterpret_cast<const float2*>(&part[2 * AT + r * D + 8 * j + 2 * t4]));
          o[j][2 * hr] += x.x * f;
          o[j][2 * hr + 1] += x.y * f;
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if ((hr ? r1 : r0) < nrows) emit(hr, M[hr], L[hr]);
  }
  if (tid == 0) p.tickets[unit] = 0;
}

template <typename T, int D, int STAGES>
int launch_attn(const AttnArgs& a, int S, cudaStream_t stream) {
  constexpr int RS = D * (int)sizeof(T) + 16;
  const size_t smem = (size_t)AT * RS * (1 + 2 * STAGES) + sizeof(int) * STAGES * AT;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attn_tc_kernel<T, D, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.nsplit, a.KVH * a.rtiles, S);
  paged_attn_tc_kernel<T, D, STAGES><<<grid, ANT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The width D the kernel is instantiated for: max(hd, hd_v) rounded up.
int attn_width(int hd, int hdv) {
  const int w = max(hd, hdv);
  return w <= 64 ? 64 : w <= 128 ? 128 : 256;
}

int attn_dispatch(int dtype, const void* q, const void* k, const void* v, void* o, float* m,
                  float* l, const int* tables, const int* starts, const int* lengths, int S,
                  int C, int KVH, int G, int hd, int hdv, int NB, int bs, int W, float scale,
                  float cap, int width, int nsplit, int pages, float* ws, int* tickets,
                  cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (S < 1 || S > 65535 || C < 1 || KVH < 1 || G < 1 || hd < 1 || hd > 256 || hdv < 1 ||
      hdv > 256 || bs < 1 || W < 0 || nsplit < 1 || pages < 1 ||
      (long long)nsplit * pages < W || width != attn_width(hd, hdv) ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.m = m;
  a.l = l;
  a.tables = tables;
  a.starts = starts;
  a.lengths = lengths;
  a.C = C;
  a.KVH = KVH;
  a.G = G;
  a.hd = hd;
  a.hdv = hdv;
  a.NB = NB;
  a.bs = bs;
  a.W = W;
  a.scale = scale;
  a.cap = cap;
  a.rtiles = (int)(((long long)C * G + AT - 1) / AT);
  if ((long long)KVH * a.rtiles > 65535) return (int)cudaErrorInvalidValue;
  a.nsplit = nsplit;
  a.pages = pages;
  a.vec_q = reinterpret_cast<uintptr_t>(q) % 16 == 0 && (hd * esz) % 16 == 0;
  a.vec_k = reinterpret_cast<uintptr_t>(k) % 16 == 0 && (hd * esz) % 16 == 0;
  a.vec_v = reinterpret_cast<uintptr_t>(v) % 16 == 0 && (hdv * esz) % 16 == 0;
  a.ws = ws;
  a.tickets = tickets;
  if (dtype == 1) {
    if (width == 64) return launch_attn<bf16, 64, 3>(a, S, stream);
    if (width == 128) return launch_attn<bf16, 128, 2>(a, S, stream);
    return launch_attn<bf16, 256, 2>(a, S, stream);
  }
  if (width == 64) return launch_attn<float, 64, 2>(a, S, stream);
  if (width == 128) return launch_attn<float, 128, 2>(a, S, stream);
  return launch_attn<float, 256, 1>(a, S, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, arenas and output alike).
// m and l are float32 whatever the dtype.  Each returns the cudaError_t of
// its launch (0 on success).
//
// Decode, and decode-lse (which also writes each row's f32 (m, l), (S, KVH,
// G) each): the split-KV plan (kernels/paged_attn.py::_decode_plan) gives
// `rows` query rows a CTA (1, 2, 4 or 8; G rounded up, in row blocks past
// 8), `warps` (1-4), `nsplit` splits of `pages` page columns (nsplit *
// pages >= W); with nsplit > 1, `ws` holds nsplit partials of rows * (hd_v
// rounded up to 8, + 2) f32 a (lane, kv head, row block) and `tickets` one
// zeroed int each, left zeroed again.
extern "C" int paged_decode_launch(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const int* tables, const int* lengths, int S,
                                   int KVH, int G, int hd, int hdv, int NB, int bs, int W,
                                   float scale, float cap, int rows, int warps, int nsplit,
                                   int pages, float* ws, int* tickets, void* stream) {
  return decode_dispatch(dtype, q, k, v, o, nullptr, nullptr, tables, lengths, S, KVH, G, hd,
                         hdv, NB, bs, W, scale, cap, rows, warps, nsplit, pages, ws, tickets,
                         static_cast<cudaStream_t>(stream));
}

// Prefill: q (S, C, KVH, G, hd), chunk row r of lane s at absolute
// position starts[s] + r, attending columns < lengths[s] and <= its
// position.  The plan (kernels/paged_attn.py::_attn_plan) gives `width`
// (max(hd, hd_v) rounded up to 64, 128 or 256) and `nsplit` splits of
// `pages` page columns (nsplit * pages >= W); with nsplit > 1, `ws` holds
// nsplit partials of 64 * (width + 2) f32 a (lane, kv head, 64-row tile)
// and `tickets` one zeroed int each, left zeroed again.
extern "C" int paged_prefill_launch(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const int* tables, const int* starts,
                                    const int* lengths, int S, int C, int KVH, int G, int hd,
                                    int hdv, int NB, int bs, int W, float scale, float cap,
                                    int width, int nsplit, int pages, float* ws, int* tickets,
                                    void* stream) {
  if (starts == nullptr) return (int)cudaErrorInvalidValue;
  return attn_dispatch(dtype, q, k, v, o, nullptr, nullptr, tables, starts, lengths, S, C, KVH,
                       G, hd, hdv, NB, bs, W, scale, cap, width, nsplit, pages, ws, tickets,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_lse_launch(int dtype, const void* q, const void* k, const void* v,
                                       void* o, float* m, float* l, const int* tables,
                                       const int* lengths, int S, int KVH, int G, int hd,
                                       int hdv, int NB, int bs, int W, float scale, float cap,
                                       int rows, int warps, int nsplit, int pages, float* ws,
                                       int* tickets, void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  return decode_dispatch(dtype, q, k, v, o, m, l, tables, lengths, S, KVH, G, hd, hdv, NB, bs,
                         W, scale, cap, rows, warps, nsplit, pages, ws, tickets,
                         static_cast<cudaStream_t>(stream));
}

// Shared-prefix phase: q (S, KVH, G, hd) against the P pages of
// prefix_pages, lane s masked to its first prefix_lens[s] rows, run as one
// chunk of S rows; the plan as for prefill, a unit being a (kv head, 64-row
// tile of the S * G rows).
extern "C" int paged_prefix_launch(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* m, float* l, const int* prefix_pages,
                                   const int* prefix_lens, int S, int KVH, int G, int hd,
                                   int hdv, int NB, int bs, int P, float scale, float cap,
                                   int width, int nsplit, int pages, float* ws, int* tickets,
                                   void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  return attn_dispatch(dtype, q, k, v, o, m, l, prefix_pages, nullptr, prefix_lens, 1, S, KVH,
                       G, hd, hdv, NB, bs, P, scale, cap, width, nsplit, pages, ws, tickets,
                       static_cast<cudaStream_t>(stream));
}
