// Chunked linear attention with a data-dependent decay (the RWKV6 WKV
// recurrence) for Hopper (sm_90a):
//
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces, in kernels/linear_attn.py of the JAX package:
//   linear_attn_bshk_pallas (_kernel_bshk)   -> wkv_bshk_launch
//   linear_attn_pallas (_kernel)             -> linear_attn_launch
//
// Layouts (the reference's): wkv_bshk takes r, k, logw (B, S, H, K), v
// (B, S, H, V), u (H, K) and state0 (B, H, K, V) f32, and writes o (B, S,
// H, V) in r's type and the final state sf (B, H, K, V) f32.
// linear_attn takes r, k, logw (BH, S, K), v (BH, S, V) and u (BH, K) --
// the same layout with H = 1 and one u row per BH row -- starts from a
// zero state and writes only o.  logw = log w_t <= 0; S is a multiple of
// the chunk lc (the caller pads with zero rows: k = 0 adds nothing,
// logw = 0 keeps the state).
//
// The TPU kernel's grid is (B, H, chunks) with the chunk axis sequential
// and the (K, V) state in VMEM scratch.  Here one CTA owns a (b, h) pair
// and a tile of VT = 16 state columns (output columns of the state are
// independent), keeps its K x VT slice of the state in shared memory,
// seeds it from state0 and walks the chunks in order: 32 heads at B = 1
// would otherwise fill only 32 of the 132 SMs.  Per chunk, with cs the
// inclusive cumsum of logw per key column (one thread per column, in
// order) and cs_prev = cs - logw, as the reference takes them:
//
//   o[t]  = (r[t] * exp(cs_prev[t])) @ h                                 inter-chunk
//         + sum_{j<t} A[t,j] v[j],  A[t,j] = sum_k r[t,k] k[j,k] exp(cs_prev[t,k] - cs[j,k])
//         + (sum_k r[t,k] u[k] k[t,k]) v[t]                              bonus diagonal
//   h    <- exp(wsum) h + sum_j (k[j] * exp(wsum - cs[j]))^T v[j],        wsum = cs[lc-1]
//
// The output reads the old state; a barrier separates those reads from the
// update.  Every exponent is <= 0: exp(cs_prev[t,k] - cs[j,k]) is taken
// only for j < t (never factored as exp(cs_prev) * exp(-cs), which
// overflows: logw down to -e over 64 rows gives cs ~ -174), and expf is
// the accurate one (no fast-math, no flush to zero), so terms near
// underflow match the plain version.  A is recomputed by each of a head's
// V / VT CTAs; the chunk's r, k, cs, cs_prev rows sit in shared memory with
// an odd row stride (K + 1 floats), so the threads of a warp that read
// different rows j hit different banks.  At lc = K = 64 the CTA holds ~90
// KB, above the 48 KB static limit, so the launch raises the kernel's
// dynamic shared-memory limit first.  Any chunk from 1 (decode) to 64
// works.
//
// What bounds it on the H100: the bytes of r, k, v, logw, the state and o
// (~22 MB at B = 1, S = 512, H = 32, K = V = 64: 6.6 us at 3.35 TB/s)
// against the f32 work (~0.5 GFLOP there, ~7 us at 67 TFLOP/s); this
// first kernel is neither: it runs plain f32 FMAs and one expf per (t, j,
// k) on CUDA cores, with A recomputed per V tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;    // threads per CTA
constexpr int VT = 16;     // state / output columns per CTA
constexpr int MAXD = 64;   // the largest K, V and chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// One CTA per (b * H + h, V tile).  u_b_stride: elements between the u rows
// of consecutive b (0 for wkv_bshk, whose u is per head; K for linear_attn,
// whose u is per BH row).  s0 == nullptr starts from zero; sf == nullptr
// writes no state.
template <typename T>
__global__ void __launch_bounds__(NT)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ lw, const T* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ o, float* __restrict__ sf, int S, int H, int K, int V, int lc,
           int u_b_stride) {
  extern __shared__ float sm[];
  const int KP = K + 1;
  float* rb = sm;                 // (lc, KP): r, then r * exp(cs_prev)
  float* kb = rb + lc * KP;       // (lc, KP): k, then k * exp(wsum - cs)
  float* cs = kb + lc * KP;       // (lc, KP): logw, then its inclusive cumsum
  float* cp = cs + lc * KP;       // (lc, KP): cs - logw
  float* vb = cp + lc * KP;       // (lc, VT)
  float* As = vb + lc * VT;       // (lc, lc)
  float* hs = As + lc * lc;       // (K, VT) the state's column tile
  float* us = hs + K * VT;        // (K,)
  float* ws = us + K;             // (K,) wsum
  float* ds = ws + K;             // (lc,) bonus diagonal

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh - b * H;
  const int v0 = blockIdx.y * VT;
  const int vn = min(VT, V - v0);

  const T* urow = u + (size_t)b * u_b_stride + (size_t)hh * K;
  for (int i = tid; i < K; i += NT) us[i] = to_f(urow[i]);
  for (int i = tid; i < K * VT; i += NT) {
    const int kk = i / VT, c = i - kk * VT;
    hs[i] = (s0 != nullptr && c < vn) ? s0[((size_t)bh * K + kk) * V + v0 + c] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += lc) {
    __syncthreads();  // the previous chunk's readers are done with the buffers
    for (int i = tid; i < lc * K; i += NT) {
      const int t = i / K, kk = i - t * K;
      const size_t g = (((size_t)b * S + c0 + t) * H + hh) * K + kk;
      rb[t * KP + kk] = to_f(r[g]);
      kb[t * KP + kk] = to_f(k[g]);
      cs[t * KP + kk] = to_f(lw[g]);
    }
    for (int i = tid; i < lc * VT; i += NT) {
      const int t = i / VT, c = i - t * VT;
      vb[i] = c < vn ? to_f(v[(((size_t)b * S + c0 + t) * H + hh) * V + v0 + c]) : 0.f;
    }
    __syncthreads();
    for (int kk = tid; kk < K; kk += NT) {
      float run = 0.f;
      for (int t = 0; t < lc; ++t) {
        const float w = cs[t * KP + kk];
        run += w;
        cs[t * KP + kk] = run;
        cp[t * KP + kk] = run - w;
      }
      ws[kk] = run;
    }
    __syncthreads();
    // A, strictly lower triangular, and the bonus diagonal
    for (int i = tid; i < lc * lc; i += NT) {
      const int t = i / lc, j = i - t * lc;
      float a = 0.f;
      if (j < t) {
        const float* rt = rb + t * KP;
        const float* kj = kb + j * KP;
        const float* pt = cp + t * KP;
        const float* cj = cs + j * KP;
        for (int kk = 0; kk < K; ++kk) a += rt[kk] * kj[kk] * expf(pt[kk] - cj[kk]);
      }
      As[i] = a;
    }
    for (int t = tid; t < lc; t += NT) {
      float s = 0.f;
      for (int kk = 0; kk < K; ++kk) s += rb[t * KP + kk] * us[kk] * kb[t * KP + kk];
      ds[t] = s;
    }
    __syncthreads();
    // decay r to the chunk start and k to the chunk end, in place
    for (int i = tid; i < lc * K; i += NT) {
      const int t = i / K, kk = i - t * K;
      rb[t * KP + kk] *= expf(cp[t * KP + kk]);
      kb[t * KP + kk] *= expf(ws[kk] - cs[t * KP + kk]);
    }
    __syncthreads();
    for (int i = tid; i < lc * VT; i += NT) {
      const int t = i / VT, c = i - t * VT;
      if (c >= vn) continue;
      float inter = 0.f;
      for (int kk = 0; kk < K; ++kk) inter += rb[t * KP + kk] * hs[kk * VT + c];
      float intra = 0.f;
      for (int j = 0; j < t; ++j) intra += As[t * lc + j] * vb[j * VT + c];
      const float out = inter + intra + ds[t] * vb[t * VT + c];
      o[(((size_t)b * S + c0 + t) * H + hh) * V + v0 + c] = from_f<T>(out);
    }
    __syncthreads();  // every read of the old state is done
    for (int i = tid; i < K * VT; i += NT) {
      const int kk = i / VT, c = i - kk * VT;
      float acc = 0.f;
      for (int j = 0; j < lc; ++j) acc += kb[j * KP + kk] * vb[j * VT + c];
      hs[i] = expf(ws[kk]) * hs[i] + acc;
    }
  }
  if (sf == nullptr) return;
  __syncthreads();
  for (int i = tid; i < K * VT; i += NT) {
    const int kk = i / VT, c = i - kk * VT;
    if (c < vn) sf[((size_t)bh * K + kk) * V + v0 + c] = hs[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const float* s0, void* o, float* sf, int B, int S, int H, int K, int V, int lc,
           int u_b_stride, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || K > MAXD || V < 1 || V > MAXD || lc < 1 ||
      lc > MAXD || S % lc != 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)4 * lc * (K + 1) + (size_t)lc * VT +
                                       (size_t)lc * lc + (size_t)K * VT + 2 * K + lc);
  cudaError_t e = cudaFuncSetAttribute(wkv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(B * H), (V + VT - 1) / VT);
  wkv_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), static_cast<const T*>(u), s0, static_cast<T*>(o), sf, S, H,
      K, V, lc, u_b_stride);
  return (int)cudaGetLastError();
}

int launch_dtype(int dtype, const void* r, const void* k, const void* v, const void* lw,
                 const void* u, const float* s0, void* o, float* sf, int B, int S, int H,
                 int K, int V, int lc, int u_b_stride, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(r, k, v, lw, u, s0, o, sf, B, S, H, K, V, lc, u_b_stride, stream);
  if (dtype == 1)
    return launch<bf16>(r, k, v, lw, u, s0, o, sf, B, S, H, K, V, lc, u_b_stride, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (r, k, v, logw, u and o alike;
// the state is always float32).  Each returns the cudaError_t of its
// launch (0 on success).
extern "C" int wkv_bshk_launch(int dtype, const void* r, const void* k, const void* v,
                               const void* lw, const void* u, const void* s0, void* o,
                               void* sf, int B, int S, int H, int K, int V, int chunk,
                               void* stream) {
  if (s0 == nullptr || sf == nullptr) return (int)cudaErrorInvalidValue;
  return launch_dtype(dtype, r, k, v, lw, u, static_cast<const float*>(s0), o,
                      static_cast<float*>(sf), B, S, H, K, V, chunk, 0,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int linear_attn_launch(int dtype, const void* r, const void* k, const void* v,
                                  const void* lw, const void* u, void* o, int BH, int S, int K,
                                  int V, int chunk, void* stream) {
  return launch_dtype(dtype, r, k, v, lw, u, nullptr, o, nullptr, BH, S, 1, K, V, chunk, K,
                      static_cast<cudaStream_t>(stream));
}
