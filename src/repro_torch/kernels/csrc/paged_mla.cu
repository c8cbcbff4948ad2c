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
// dtype, with s = (q_abs . c_kv + q_rope . k_rope) * scale.
//
// A lane's C * H query rows are flattened in the reference's order (row i
// is chunk row i / H, head i % H, at position start + i / H) and split
// into blocks of RB = 16 rows, one CTA each: a whole lane's 128 heads x 512
// f32 accumulators (256 KB) would not fit one CTA, and 16 rows x 512 over
// 256 threads is 32 accumulators a thread.  Every row's online-softmax
// state stays in its CTA.  The CTA loads its own table row, start and
// length (no scalar prefetch on the GPU) and walks the lane's pages in
// order, stopping at the first page past the length (dead columns are never
// read) or past the causal limit of its last row.
//
// K and V are the same bytes: the key of a row is [c_kv | k_rope] and its
// value is c_kv.  Each page is staged once in shared memory as f32 rows of
// [c_kv | k_rope] (a padded, odd row stride: no bank conflicts) and serves
// both products; the CTA's q rows are staged the same way.  At full width
// that is (16 + 16) x 577 f32, ~74 KB, above the 48 KB static limit, so the
// launch raises the kernel's dynamic shared-memory limit first.
//
// What bounds it on the H100: the bytes of the live latent pages (576
// values a row, bf16) at decode; the f32 CUDA-core FMAs at prefill, where
// C * H = 8192 rows a lane each read every live page.  Scores and the
// running (m, l, acc) state are f32.  As in the reference, p is rounded to
// the latent type before p @ c_kv while l sums the f32 p, there is no soft
// cap, and a lane of length 0 writes zeros.  Masked columns get p = 0
// explicitly (the reference's exp(-1e30 - m) is 0 for every row that has
// seen a live column, and every row sees column 0 on the first page).
// All 128 heads read the same page, so a 16-row MMA tile is full: the
// tensor cores are this kernel's next step, not taken here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads per CTA (8 warps)
constexpr int RB = 16;      // query rows per CTA
constexpr int MAXACC = 32;  // latent outputs a thread accumulates: RB * r <= NT * MAXACC
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

// One CTA per (block of RB flattened rows, lane).  starts == nullptr is
// decode: C = 1 and the query sits at position length - 1.
template <typename T>
__global__ void __launch_bounds__(NT)
paged_mla_kernel(const T* __restrict__ qa, const T* __restrict__ qr,
                 const T* __restrict__ ckv, const T* __restrict__ krope, T* __restrict__ out,
                 const int* __restrict__ tables, const int* __restrict__ starts,
                 const int* __restrict__ lengths, int C, int H, int r, int rd, int NB, int bs,
                 int W, float scale) {
  const int s = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows_total = C * H;
  const int row0 = blockIdx.x * RB;
  const int nrows = min(RB, rows_total - row0);
  const int len = lengths[s];
  const int q0 = starts != nullptr ? starts[s] : len - 1;
  const int dk = r + rd;       // key width: [c_kv | k_rope]
  const int ld = dk + 1;       // odd shared-memory row stride

  extern __shared__ float sm[];
  float* qs = sm;              // RB x ld: [q_abs | q_rope]
  float* ks = qs + RB * ld;    // bs x ld: [c_kv | k_rope] of one page
  float* ps = ks + bs * ld;    // RB x bs scores, then p
  float* mrow = ps + RB * bs;  // RB running max
  float* lrow = mrow + RB;     // RB running exp-sum
  float* crow = lrow + RB;     // RB this page's correction

  // flat row i of lane s is q row s * C * H + i, in both q arrays and out
  const long long qbase = (long long)s * rows_total + row0;
  for (int idx = tid; idx < RB * dk; idx += NT) {
    const int i = idx / dk, d = idx - i * dk;
    float v = 0.f;
    if (i < nrows)
      v = d < r ? to_f(qa[(qbase + i) * r + d]) : to_f(qr[(qbase + i) * rd + (d - r)]);
    qs[i * ld + d] = v;
  }
  for (int i = tid; i < RB; i += NT) {
    mrow[i] = NEG;
    lrow[i] = 0.f;
  }
  float acc[MAXACC];
#pragma unroll
  for (int t = 0; t < MAXACC; ++t) acc[t] = 0.f;
  __syncthreads();

  // no row of this CTA attends a column at or past `limit`
  const int limit = min(len, q0 + (row0 + nrows - 1) / H + 1);
  for (int j = 0; j < W && j * bs < limit; ++j) {
    const int page = tables[(long long)s * W + j];
    if (page < 0 || page >= NB) __trap();  // a table naming no arena page
    const long long base = (long long)page * bs;
    for (int idx = tid; idx < bs * dk; idx += NT) {
      const int c = idx / dk, d = idx - c * dk;
      ks[c * ld + d] = d < r ? to_f(ckv[(base + c) * r + d])
                             : to_f(krope[(base + c) * rd + (d - r)]);
    }
    __syncthreads();
    for (int idx = tid; idx < RB * bs; idx += NT) {
      const int i = idx / bs, c = idx - i * bs;
      const int col = j * bs + c, qpos = q0 + (row0 + i) / H;
      const float* qrow = qs + i * ld;
      const float* krow = ks + c * ld;
      float dot = 0.f;
      for (int d = 0; d < dk; ++d) dot = fmaf(qrow[d], krow[d], dot);
      ps[idx] = (col < len && col <= qpos) ? dot * scale : NEG;
    }
    __syncthreads();
    for (int i = warp; i < RB; i += NT / 32) {
      float mx = NEG;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, ps[i * bs + c]);
      const float m_new = fmaxf(mrow[i], warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float sc = ps[i * bs + c];
        const float p = sc > 0.5f * NEG ? expf(sc - m_new) : 0.f;
        sum += p;
        ps[i * bs + c] = to_f(from_f<T>(p));  // p in the latent type for p @ c_kv
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
      if (idx < RB * r) {
        const int i = idx / r, d = idx - i * r;
        float a = acc[t] * crow[i];
        for (int c = 0; c < bs; ++c) a = fmaf(ps[i * bs + c], ks[c * ld + d], a);
        acc[t] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < MAXACC; ++t) {
    const int idx = tid + t * NT;
    if (idx < RB * r) {
      const int i = idx / r, d = idx - i * r;
      if (i < nrows) out[(qbase + i) * r + d] = from_f<T>(acc[t] / fmaxf(lrow[i], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* qa, const void* qr, const void* ckv, const void* krope, void* o,
           const int* tables, const int* starts, const int* lengths, int S, int C, int H,
           int r, int rd, int NB, int bs, int W, float scale, cudaStream_t stream) {
  if ((long long)RB * r > (long long)NT * MAXACC || r <= 0 || rd < 0 || bs <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(RB + bs) * (r + rd + 1) + (size_t)RB * bs +
                                       3 * RB);
  cudaError_t e = cudaFuncSetAttribute(paged_mla_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)C * H + RB - 1) / RB;
  if (blocks > 0x7fffffffLL || S > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, S);
  paged_mla_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qa), static_cast<const T*>(qr), static_cast<const T*>(ckv),
      static_cast<const T*>(krope), static_cast<T*>(o), tables, starts, lengths, C, H, r, rd,
      NB, bs, W, scale);
  return (int)cudaGetLastError();
}

int launch_dtype(int dtype, const void* qa, const void* qr, const void* ckv,
                 const void* krope, void* o, const int* tables, const int* starts,
                 const int* lengths, int S, int C, int H, int r, int rd, int NB, int bs, int W,
                 float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(qa, qr, ckv, krope, o, tables, starts, lengths, S, C, H, r, rd, NB,
                         bs, W, scale, stream);
  if (dtype == 1)
    return launch<bf16>(qa, qr, ckv, krope, o, tables, starts, lengths, S, C, H, r, rd, NB, bs,
                        W, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (queries, arenas and output
// alike).  Each returns the cudaError_t of its launch (0 on success).
extern "C" int paged_mla_decode_launch(int dtype, const void* q_abs, const void* q_rope,
                                       const void* ckv, const void* krope, void* o,
                                       const int* tables, const int* lengths, int S, int H,
                                       int r, int rd, int NB, int bs, int W, float scale,
                                       void* stream) {
  return launch_dtype(dtype, q_abs, q_rope, ckv, krope, o, tables, nullptr, lengths, S, 1, H,
                      r, rd, NB, bs, W, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_mla_prefill_launch(int dtype, const void* q_abs, const void* q_rope,
                                        const void* ckv, const void* krope, void* o,
                                        const int* tables, const int* starts,
                                        const int* lengths, int S, int C, int H, int r, int rd,
                                        int NB, int bs, int W, float scale, void* stream) {
  if (starts == nullptr) return (int)cudaErrorInvalidValue;
  return launch_dtype(dtype, q_abs, q_rope, ckv, krope, o, tables, starts, lengths, S, C, H, r,
                      rd, NB, bs, W, scale, static_cast<cudaStream_t>(stream));
}
