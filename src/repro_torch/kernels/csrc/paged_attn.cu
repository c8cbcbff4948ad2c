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
// One CTA owns RB consecutive query rows of one (lane, kv head), in the
// reference's flattened order (row i is chunk row i / G, group head i % G),
// so the online-softmax state of a row never leaves its CTA: decode runs
// the G heads of a kv head together, prefill splits the C * G rows of a
// lane across CTAs.  The CTA loads its own table row, start and length
// (there is no scalar prefetch on the GPU) and walks the lane's pages in
// order, stopping at the first page past the length (dead columns are never
// read) or past the causal limit of its last row, which is exact: such a
// page contributes exp(-1e30 - m) == 0 to every row.
//
// What bounds it on the H100: the bytes of the live K/V pages (decode) —
// each page is read once per CTA that needs it, and no CTA reads a page
// past its lane's length.  Scores and the running (m, l, acc) state are
// f32 on CUDA cores: G = 4 rows at hd = 64 are below the tensor cores'
// 16-row minimum.  As in the reference, p is rounded to the value type
// before p @ V while l sums the f32 p, an optional tanh soft cap is
// applied before the mask, and a lane of length 0 writes zeros.
//
// Cascade decode.  The unique phase (decode-lse) is the decode kernel that
// also writes each row's f32 (m, l); a lane of length 0 never enters the
// page loop and writes (0, -1e30, 0).  The shared-prefix phase reads ONE
// page list for every lane: q's (S, KVH, G, hd) layout read as a chunk of S
// rows at s = 0, so flattened row i is lane i / G, head i % G, and one CTA
// of PREFILL_RB = 32 rows holds the S * G = 8 * 4 rows of a kv head at full
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
constexpr int DECODE_RB = 8;   // query rows per CTA, decode
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

// PREFIX = false: paged decode (C = 1, starts == nullptr) or chunked prefill,
// one CTA per (row block, kv head, lane); mout/lout, when not null, take each
// row's f32 (m, l) (decode-lse).  PREFIX = true: the shared-prefix phase,
// launched as one "lane" (s = 0) whose C rows are the lanes; tables is the
// single prefix page list and lengths[c] the prefix length of lane c.
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
extern "C" int paged_decode_launch(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const int* tables, const int* lengths, int S,
                                   int KVH, int G, int hd, int hdv, int NB, int bs, int W,
                                   float scale, float cap, void* stream) {
  return launch_dtype<DECODE_RB, false>(dtype, q, k, v, o, nullptr, nullptr, tables, nullptr,
                                        lengths, S, 1, KVH, G, hd, hdv, NB, bs, W, scale, cap,
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

// Decode that also writes each row's f32 (m, l), (S, KVH, G) each.
extern "C" int paged_decode_lse_launch(int dtype, const void* q, const void* k, const void* v,
                                       void* o, float* m, float* l, const int* tables,
                                       const int* lengths, int S, int KVH, int G, int hd,
                                       int hdv, int NB, int bs, int W, float scale, float cap,
                                       void* stream) {
  if (m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  return launch_dtype<DECODE_RB, false>(dtype, q, k, v, o, m, l, tables, nullptr, lengths, S,
                                        1, KVH, G, hd, hdv, NB, bs, W, scale, cap,
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
