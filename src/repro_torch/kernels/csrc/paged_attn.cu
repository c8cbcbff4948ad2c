// Paged GQA attention for Hopper (sm_90a): decode and chunked prefill over a
// physically paged KV arena.
//
// Replaces kernels/paged_attn.py::paged_gqa_decode_pallas (_gqa_kernel) and
// kernels/paged_attn.py::paged_gqa_prefill_pallas (_gqa_prefill_kernel).
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

template <typename T, int RB>
__global__ void __launch_bounds__(NT)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ karena,
                  const T* __restrict__ varena, T* __restrict__ out,
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
  }
  float acc[MAXACC];
#pragma unroll
  for (int t = 0; t < MAXACC; ++t) acc[t] = 0.f;
  __syncthreads();

  const int last_pos = q0 + (row0 + nrows - 1) / G;  // causal limit of this CTA
  for (int j = 0; j < W && j * bs < len && j * bs <= last_pos; ++j) {
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
      ps[idx] = (col < len && col <= qpos) ? sc : NEG;
    }
    __syncthreads();
    for (int i = warp; i < RB; i += NT / 32) {
      float mx = NEG;
      for (int r = lane; r < bs; r += 32) mx = fmaxf(mx, ps[i * bs + r]);
      const float m_new = fmaxf(mrow[i], warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < bs; r += 32) {
        const float p = expf(ps[i * bs + r] - m_new);
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
}

template <typename T, int RB>
int launch(const void* q, const void* k, const void* v, void* o, const int* tables,
           const int* starts, const int* lengths, int S, int C, int KVH, int G, int hd,
           int hdv, int NB, int bs, int W, float scale, float cap, cudaStream_t stream) {
  if ((long long)RB * hdv > (long long)NT * MAXACC) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)RB * hd + (size_t)bs * (hd + 1) + (size_t)bs * hdv +
                       (size_t)RB * bs + 3 * RB);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attn_kernel<T, RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((C * G + RB - 1) / RB, KVH, S);
  paged_attn_kernel<T, RB><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), tables, starts, lengths, C, KVH, G, hd, hdv, NB, bs, W, scale, cap);
  return (int)cudaGetLastError();
}

template <int RB>
int launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                 const int* tables, const int* starts, const int* lengths, int S, int C,
                 int KVH, int G, int hd, int hdv, int NB, int bs, int W, float scale, float cap,
                 cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, RB>(q, k, v, o, tables, starts, lengths, S, C, KVH, G, hd, hdv, NB,
                             bs, W, scale, cap, stream);
  if (dtype == 1)
    return launch<bf16, RB>(q, k, v, o, tables, starts, lengths, S, C, KVH, G, hd, hdv, NB, bs,
                            W, scale, cap, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, arenas and output alike).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_launch(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const int* tables, const int* lengths, int S,
                                   int KVH, int G, int hd, int hdv, int NB, int bs, int W,
                                   float scale, float cap, void* stream) {
  return launch_dtype<DECODE_RB>(dtype, q, k, v, o, tables, nullptr, lengths, S, 1, KVH, G, hd,
                                 hdv, NB, bs, W, scale, cap, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_prefill_launch(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const int* tables, const int* starts,
                                    const int* lengths, int S, int C, int KVH, int G, int hd,
                                    int hdv, int NB, int bs, int W, float scale, float cap,
                                    void* stream) {
  return launch_dtype<PREFILL_RB>(dtype, q, k, v, o, tables, starts, lengths, S, C, KVH, G,
                                  hd, hdv, NB, bs, W, scale, cap,
                                  static_cast<cudaStream_t>(stream));
}
