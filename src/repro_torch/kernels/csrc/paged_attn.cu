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
// (m, l, acc) are f32 on CUDA cores, p is rounded to the value type before
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
// Prefill and the shared-prefix phase: paged_attn_kernel.  One CTA owns RB
// consecutive query rows of one (lane, kv head), in the reference's
// flattened order (row i is chunk row i / G, group head i % G), so the
// online-softmax state of a row never leaves its CTA: prefill splits the
// C * G rows of a lane across CTAs.  The CTA loads its own table row, start
// and length (there is no scalar prefetch on the GPU) and walks the lane's
// pages in order, stopping at the first page past the length or past the
// causal limit of its last row, which is exact: such a page contributes
// exp(-1e30 - m) == 0 to every row.  The shared-prefix phase reads ONE page
// list for every lane: q's (S, KVH, G, hd) layout read as a chunk of S rows
// at s = 0, so flattened row i is lane i / G, head i % G, and one CTA of
// PREFILL_RB = 32 rows holds the S * G = 8 * 4 rows of a kv head at full
// width.  Each prefix page is then read once per kv head instead of once
// per lane, which is what the cascade buys; more rows split across CTAs,
// and no state crosses a CTA.  Row i attends columns < prefix_lens[lane]
// (0 = the lane is not in the group), and the CTA stops at the first page
// past its rows' longest prefix.  A non-member row shares its CTA with
// members and is masked on every page, where m stays -1e30 and
// exp(s - m) = exp(0) = 1: its p is zeroed explicitly wherever the mask is
// off, so it keeps l == 0 and comes back as (0, -1e30, 0).  What bounds
// the prefix phase is the same as decode: the bytes of the shared pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;        // threads per CTA (4 warps)
constexpr int MAXACC = 16;     // output elements a thread accumulates
constexpr int PREFILL_RB = 32; // query rows per CTA, prefill
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

// PREFIX = false: chunked prefill, one CTA per (row block, kv head, lane).
// PREFIX = true: the shared-prefix phase, launched as one "lane" (s = 0)
// whose C rows are the lanes; tables is the single prefix page list,
// lengths[c] the prefix length of lane c, and mout / lout take each row's
// f32 (m, l).
template <typename T, int RB, bool PREFIX>
__global__ void __launch_bounds__(NT)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ karena,
                  const T* __restrict__ varena, T* __restrict__ out,
                  float* __restrict__ mout, float* __restrict__ lout,
                  const int* __restrict__ tables, const int* __restrict__ starts,
                  const int* __restrict__ lengths, int C, int KVH, int G, int hd, int hdv,
                  int NB, int bs, int W, float scale, float cap) {
  const int h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows_total = C * G;
  const int row0 = blockIdx.x * RB;
  const int nrows = min(RB, rows_total - row0);
  const int len = lengths[s];
  const int q0 = starts != nullptr ? starts[s] : len - 1;

  extern __shared__ float sm[];
  float* qs = sm;                   // RB x hd
  float* ks = qs + RB * hd;         // bs x (hd + 1)
  float* vs = ks + bs * (hd + 1);   // bs x hdv
  float* ps = vs + bs * hdv;        // RB x bs
  float* mrow = ps + RB * bs;       // RB running max
  float* lrow = mrow + RB;          // RB running exp-sum
  float* crow = lrow + RB;          // RB this page's correction
  int* rlen = reinterpret_cast<int*>(crow + RB);  // RB prefix length (PREFIX)

  for (int idx = tid; idx < RB * hd; idx += NT) {
    const int i = idx / hd, d = idx - i * hd;
    float v = 0.f;
    if (i < nrows) {
      const int r = row0 + i, c = r / G, g = r - c * G;
      v = to_f(q[((((long long)s * C + c) * KVH + h) * G + g) * hd + d]);
    }
    qs[idx] = v;
  }
  for (int i = tid; i < RB; i += NT) {
    mrow[i] = NEG;
    lrow[i] = 0.f;
    if constexpr (PREFIX) rlen[i] = i < nrows ? lengths[(row0 + i) / G] : 0;
  }
  float acc[MAXACC];
#pragma unroll
  for (int t = 0; t < MAXACC; ++t) acc[t] = 0.f;
  __syncthreads();

  // pages past `limit` rows hold nothing any row attends: decode/prefill stop
  // at the lane's length and the causal limit of this CTA's last row, the
  // prefix phase at its rows' longest prefix
  int limit = min(len, q0 + (row0 + nrows - 1) / G + 1);
  if constexpr (PREFIX) {
    limit = 0;
    for (int i = 0; i < nrows; ++i) limit = max(limit, rlen[i]);
  }
  for (int j = 0; j < W && j * bs < limit; ++j) {
    const int page = tables[(long long)s * W + j];
    if (page < 0 || page >= NB) __trap();  // a table naming no arena page
    const long long base = (long long)page * bs;
    for (int idx = tid; idx < bs * hd; idx += NT) {
      const int r = idx / hd, d = idx - r * hd;
      ks[r * (hd + 1) + d] = to_f(karena[((base + r) * KVH + h) * hd + d]);
    }
    for (int idx = tid; idx < bs * hdv; idx += NT) {
      const int r = idx / hdv, d = idx - r * hdv;
      vs[idx] = to_f(varena[((base + r) * KVH + h) * hdv + d]);
    }
    __syncthreads();
    for (int idx = tid; idx < RB * bs; idx += NT) {
      const int i = idx / bs, r = idx - i * bs;
      const int col = j * bs + r, qpos = q0 + (row0 + i) / G;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qs[i * hd + d], ks[r * (hd + 1) + d], dot);
      float sc = dot * scale;
      if (cap > 0.f) sc = tanhf(sc / cap) * cap;
      const bool live = PREFIX ? col < rlen[i] : (col < len && col <= qpos);
      ps[idx] = live ? sc : NEG;
    }
    __syncthreads();
    for (int i = warp; i < RB; i += NT / 32) {
      float mx = NEG;
      for (int r = lane; r < bs; r += 32) mx = fmaxf(mx, ps[i * bs + r]);
      const float m_new = fmaxf(mrow[i], warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < bs; r += 32) {
        float p = expf(ps[i * bs + r] - m_new);
        if constexpr (PREFIX) {
          if (j * bs + r >= rlen[i]) p = 0.f;  // a masked column adds nothing
        }
        sum += p;
        ps[i * bs + r] = to_f(from_f<T>(p));  // p in the value type for p @ V
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(mrow[i] - m_new);
        crow[i] = corr;
        lrow[i] = lrow[i] * corr + sum;
        mrow[i] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < MAXACC; ++t) {
      const int idx = tid + t * NT;
      if (idx < RB * hdv) {
        const int i = idx / hdv, d = idx - i * hdv;
        float a = acc[t] * crow[i];
        for (int r = 0; r < bs; ++r) a = fmaf(ps[i * bs + r], vs[r * hdv + d], a);
        acc[t] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < MAXACC; ++t) {
    const int idx = tid + t * NT;
    if (idx < RB * hdv) {
      const int i = idx / hdv, d = idx - i * hdv;
      if (i < nrows) {
        const int r = row0 + i, c = r / G, g = r - c * G;
        out[((((long long)s * C + c) * KVH + h) * G + g) * hdv + d] =
            from_f<T>(acc[t] / fmaxf(lrow[i], 1e-30f));
      }
    }
  }
  if (mout != nullptr) {
    for (int i = tid; i < nrows; i += NT) {
      const int r = row0 + i, c = r / G, g = r - c * G;
      const long long o = (((long long)s * C + c) * KVH + h) * G + g;
      mout[o] = mrow[i];
      lout[o] = lrow[i];
    }
  }
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

template <typename T, int RB, bool PREFIX>
int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l,
           const int* tables, const int* starts, const int* lengths, int S, int C, int KVH,
           int G, int hd, int hdv, int NB, int bs, int W, float scale, float cap,
           cudaStream_t stream) {
  if ((long long)RB * hdv > (long long)NT * MAXACC) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)RB * hd + (size_t)bs * (hd + 1) + (size_t)bs * hdv +
                       (size_t)RB * bs + 3 * RB) +
      (PREFIX ? sizeof(int) * RB : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attn_kernel<T, RB, PREFIX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((C * G + RB - 1) / RB, KVH, S);
  paged_attn_kernel<T, RB, PREFIX><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, tables, starts, lengths, C, KVH, G, hd, hdv, NB, bs, W, scale,
      cap);
  return (int)cudaGetLastError();
}

template <int RB, bool PREFIX>
int launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o, float* m,
                 float* l, const int* tables, const int* starts, const int* lengths, int S,
                 int C, int KVH, int G, int hd, int hdv, int NB, int bs, int W, float scale,
                 float cap, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, RB, PREFIX>(q, k, v, o, m, l, tables, starts, lengths, S, C, KVH, G,
                                     hd, hdv, NB, bs, W, scale, cap, stream);
  if (dtype == 1)
    return launch<bf16, RB, PREFIX>(q, k, v, o, m, l, tables, starts, lengths, S, C, KVH, G,
                                    hd, hdv, NB, bs, W, scale, cap, stream);
  return (int)cudaErrorInvalidValue;
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

extern "C" int paged_prefill_launch(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const int* tables, const int* starts,
                                    const int* lengths, int S, int C, int KVH, int G, int hd,
                                    int hdv, int NB, int bs, int W, float scale, float cap,
                                    void* stream) {
  return launch_dtype<PREFILL_RB, false>(dtype, q, k, v, o, nullptr, nullptr, tables, starts,
                                         lengths, S, C, KVH, G, hd, hdv, NB, bs, W, scale, cap,
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
// prefix_pages, lane s masked to its first prefix_lens[s] rows.
extern "C" int paged_prefix_launch(int dtype, const void* q, const void* k, const void* v,
                                   void* o, float* m, float* l, const int* prefix_pages,
                                   const int* prefix_lens, int S, int KVH, int G, int hd,
                                   int hdv, int NB, int bs, int P, float scale, float cap,
                                   void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  return launch_dtype<PREFILL_RB, true>(dtype, q, k, v, o, m, l, prefix_pages, nullptr,
                                        prefix_lens, 1, S, KVH, G, hd, hdv, NB, bs, P, scale,
                                        cap, static_cast<cudaStream_t>(stream));
}
