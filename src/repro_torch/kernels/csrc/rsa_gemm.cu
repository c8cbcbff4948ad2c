// RSA GEMM for Hopper (sm_90a): C (M, N) = A (M, K) @ B (K, N) run with a
// SARA-recommended logical tile (block_m, block_n, block_k) and residency
// mode (OS / WS / IS).
//
// Replaces kernels/rsa_gemm.py::rsa_gemm_pallas (the _kernel_os and
// _kernel_psum bodies of the OS, WS and IS pallas_call sites).
//
// What bounds it on the H100: at decode (M = 8) every projection is a
// matrix-vector product bound by the bytes of B (the weight); at prefill
// (M = 512) the larger projections approach the tensor-core rate.  The
// design keeps one owner per output sub-tile (no atomics, no dependence on
// scheduling), reads B in place (row-major (K, N) or the transpose of a
// row-major (N, K), so the tied unembedding needs no copy) and A likewise
// (row-major (M, K) or the transpose of a row-major (K, M): the weight
// gradient x^T @ dy reads x in place), masks ragged edges instead of
// padding, and spreads the swept dimension across CTAs so a single M tile
// still covers the card.  bf16 operands run on the tensor
// cores (WMMA 16x16x16, f32 accumulation); f32 operands run on CUDA-core
// FMAs in full f32.  It is a first, simple kernel: no TMA, no wgmma, no
// software pipelining.
//
// The logical block is not the CTA tile: a 512 x 512 f32 accumulator
// would not fit in shared memory.  Each CTA works on Hopper-sized
// sub-tiles, and the mode sets its loop order and the rounding:
//
//   OS: one CTA per (TM x TN) output sub-tile; the f32 accumulator stays
//       in registers over the whole K and is cast to the output type once.
//   WS: for each block_k chunk of K, ascending, a (chunk x TN) slab of B
//       stays in shared memory while the CTA sweeps its share of the M
//       sub-tiles.  Each chunk's f32 product is cast to the output type
//       and added to the output tile in the output type, as _kernel_psum
//       does.
//   IS: for each block_k chunk, a (TM x chunk) slab of A stays in shared
//       memory while the CTA sweeps its share of the N sub-tiles, with
//       the same per-chunk rounding as WS.
//
// block_m and block_n do not change the arithmetic (each output element
// is owned by one sub-tile in every mode); block_k sets the WS/IS chunks.
//
// Expert banks.  One launch runs E independent GEMMs C[e] = A[e] @ B[e]
// (the reference's vmap of the Pallas kernel over an expert or head bank,
// which adds a grid axis): blockIdx.z is the bank, and each operand steps
// by its own bank stride, so a bank of weights can be a strided view (the
// MLA head banks are views of W_UK / W_UV).  Within a bank the arithmetic
// is the 2-D kernel's exactly; E = 1 is the 2-D GEMM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int NT = 128;  // threads per CTA (4 warps)
constexpr int BK = 32;   // k depth of one streamed tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The dynamic shared-memory slab, rounded up to a 128-byte boundary (WMMA
// needs 32-byte aligned tiles); launches request 128 extra bytes for it.
template <typename T>
__device__ __forceinline__ T* aligned_slab(unsigned char* raw) {
  return reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(raw) + 127) & ~uintptr_t(127));
}

// rows x cols of row-major src (leading dim ld) starting at (r0, c0) into
// shared dst (leading dim ldd), zero outside [0, R) x [0, C).  cols is a
// multiple of V; vec means src is 16-byte aligned and ld % V == 0.
template <typename T>
__device__ void load_tile(T* dst, int ldd, const T* __restrict__ src, long long ld,
                          int r0, int c0, int rows, int cols, int R, int C, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int gpr = cols / V;
  for (int g = threadIdx.x; g < rows * gpr; g += NT) {
    const int r = g / gpr, c = (g - r * gpr) * V;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * ldd + c;
    if (vec && gr < R && gc + V <= C) {
      *reinterpret_cast<uint4*>(d) =
          __ldg(reinterpret_cast<const uint4*>(src + gr * ld + gc));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        d[i] = (gr < R && gc + i < C) ? src[gr * ld + gc + i] : from_f<T>(0.f);
    }
  }
}

// The same tile of B (K x N) when B is given as the transpose of a
// row-major (N, K) matrix srcT: reads run along k, the tile lands in
// shared memory as [k][n].
template <typename T>
__device__ void load_tile_t(T* dst, int ldd, const T* __restrict__ srcT, long long ldt,
                            int k0, int n0, int rows, int cols, int K, int N, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int gpn = rows / V;
  for (int g = threadIdx.x; g < cols * gpn; g += NT) {
    const int n = g / gpn, k = (g - n * gpn) * V;
    const int gn = n0 + n, gk = k0 + k;
    if (vec && gn < N && gk + V <= K) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(srcT + gn * ldt + gk));
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < V; ++i) dst[(k + i) * ldd + n] = v[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        dst[(k + i) * ldd + n] =
            (gn < N && gk + i < K) ? srcT[gn * ldt + gk + i] : from_f<T>(0.f);
    }
  }
}

// A tile (rows of M x cols of K): row-major, or (AT) the transpose of a
// row-major (K, M) matrix, read along m.
template <typename T, bool AT>
__device__ __forceinline__ void load_a(T* dst, int ldd, const T* __restrict__ A, long long lda,
                                       int m0, int k0, int rows, int cols, int M, int K,
                                       bool vec) {
  if (AT)
    load_tile_t(dst, ldd, A, lda, m0, k0, rows, cols, M, K, vec);
  else
    load_tile(dst, ldd, A, lda, m0, k0, rows, cols, M, K, vec);
}

template <typename T, bool BT>
__device__ __forceinline__ void load_b(T* dst, int ldd, const T* __restrict__ B, long long ldb,
                                       int k0, int n0, int rows, int cols, int K, int N,
                                       bool vec) {
  if (BT)
    load_tile_t(dst, ldd, B, ldb, k0, n0, rows, cols, K, N, vec);
  else
    load_tile(dst, ldd, B, ldb, k0, n0, rows, cols, K, N, vec);
}

// Per-CTA accumulator of a TM x TN sub-tile over k, from shared-memory
// operands As (TM x kk, leading dim lda) and Bs (kk x TN, leading dim ldb).
template <typename T, int TM, int TN> struct Acc;

// bf16: tensor cores through WMMA, f32 accumulation.
template <int TM, int TN> struct Acc<bf16, TM, TN> {
  static constexpr int FC = TN / 16, F = (TM / 16) * FC, PER = F / (NT / 32);
  static_assert(PER * (NT / 32) == F, "fragments must split evenly across warps");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) wmma::fill_fragment(c[i], 0.f);
  }
  __device__ void mma(const bf16* As, int lda, const bf16* Bs, int ldb, int kk) {
    const int w = threadIdx.x >> 5;
    for (int k = 0; k < kk; k += 16) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int f = w * PER + i, fr = f / FC, fc = f - fr * FC;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, As + fr * 16 * lda + k, lda);
        wmma::load_matrix_sync(b, Bs + k * ldb + fc * 16, ldb);
        wmma::mma_sync(c[i], a, b, c[i]);
      }
    }
  }
  __device__ void store(float* Cs, int ldc) {
    const int w = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = w * PER + i, fr = f / FC, fc = f - fr * FC;
      wmma::store_matrix_sync(Cs + fr * 16 * ldc + fc * 16, c[i], ldc, wmma::mem_row_major);
    }
  }
};

// f32: CUDA-core FMAs (the tensor cores would round f32 operands to TF32).
template <int TM, int TN> struct Acc<float, TM, TN> {
  static constexpr int PER = TM * TN / NT;
  static_assert(PER * NT == TM * TN, "outputs must split evenly across threads");
  float c[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] = 0.f;
  }
  __device__ void mma(const float* As, int lda, const float* Bs, int ldb, int kk) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / TN, cc = idx - r * TN;
      float s = c[i];
      for (int k = 0; k < kk; ++k) s = fmaf(As[r * lda + k], Bs[k * ldb + cc], s);
      c[i] = s;
    }
  }
  __device__ void store(float* Cs, int ldc) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / TN, cc = idx - r * TN;
      Cs[r * ldc + cc] = c[i];
    }
  }
};

// Write the f32 sub-tile Cs to the output: cast once (add == false), or
// cast and add to what the output holds, in the output type (add == true,
// the WS/IS per-chunk rounding).  A thread always owns the same elements.
template <typename TO, int TM, int TN>
__device__ void epilogue(const float* Cs, int ldc, TO* __restrict__ Cg, int m0, int n0,
                         int M, int N, bool add) {
  for (int idx = threadIdx.x; idx < TM * TN; idx += NT) {
    const int r = idx / TN, c = idx - r * TN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      TO* o = Cg + (long long)gr * N + gc;
      const TO p = from_f<TO>(Cs[r * ldc + c]);
      *o = add ? from_f<TO>(to_f(*o) + to_f(p)) : p;
    }
  }
}

template <typename T> struct Tiles {
  static constexpr int P = 16 / sizeof(T);                 // 16-byte row padding
  static constexpr int OS_M = 64, OS_N = 64;
  static constexpr int WS_M = 64, WS_N = sizeof(T) == 2 ? 32 : 16;
  static constexpr int IS_M = 16, IS_N = 64;
};

template <typename T, typename TO, bool AT, bool BT>
__global__ void __launch_bounds__(NT)
rsa_os_kernel(const T* __restrict__ A, long long lda, const T* __restrict__ B, long long ldb,
              TO* __restrict__ C, int M, int N, int K, int vec_a, int vec_b, long long sa,
              long long sb, long long sc) {
  constexpr int TM = Tiles<T>::OS_M, TN = Tiles<T>::OS_N, P = Tiles<T>::P;
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C += blockIdx.z * sc;
  __shared__ __align__(128) T As[TM * (BK + P)];
  __shared__ __align__(128) T Bs[BK * (TN + P)];
  __shared__ __align__(128) float Cs[TM * (TN + 4)];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  Acc<T, TM, TN> acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<T, AT>(As, BK + P, A, lda, m0, k0, TM, BK, M, K, vec_a);
    load_b<T, BT>(Bs, TN + P, B, ldb, k0, n0, BK, TN, K, N, vec_b);
    __syncthreads();
    acc.mma(As, BK + P, Bs, TN + P, BK);
    __syncthreads();
  }
  acc.store(Cs, TN + 4);
  __syncthreads();
  epilogue<TO, TM, TN>(Cs, TN + 4, C, m0, n0, M, N, false);
}

template <typename T, typename TO, bool AT, bool BT>
__global__ void __launch_bounds__(NT)
rsa_ws_kernel(const T* __restrict__ A, long long lda, const T* __restrict__ B, long long ldb,
              TO* __restrict__ C, int M, int N, int K, int bk, int vec_a, int vec_b,
              long long sa, long long sb, long long sc) {
  constexpr int TM = Tiles<T>::WS_M, TN = Tiles<T>::WS_N, P = Tiles<T>::P;
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C += blockIdx.z * sc;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Bslab = aligned_slab<T>(smem_raw);  // (chunk rows) x (TN + P)
  __shared__ __align__(128) T As[TM * (BK + P)];
  __shared__ __align__(128) float Cs[TM * (TN + 4)];
  const int n0 = blockIdx.x * TN;
  const int mtiles = (M + TM - 1) / TM;
  for (int kb = 0; kb < K; kb += bk) {
    const int kc = min(bk, ((K - kb + BK - 1) / BK) * BK);
    __syncthreads();
    load_b<T, BT>(Bslab, TN + P, B, ldb, kb, n0, kc, TN, K, N, vec_b);
    for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
      const int m0 = mt * TM;
      Acc<T, TM, TN> acc;
      acc.zero();
      for (int k0 = 0; k0 < kc; k0 += BK) {
        load_a<T, AT>(As, BK + P, A, lda, m0, kb + k0, TM, BK, M, K, vec_a);
        __syncthreads();
        acc.mma(As, BK + P, Bslab + k0 * (TN + P), TN + P, BK);
        __syncthreads();
      }
      acc.store(Cs, TN + 4);
      __syncthreads();
      epilogue<TO, TM, TN>(Cs, TN + 4, C, m0, n0, M, N, kb > 0);
    }
  }
}

template <typename T, typename TO, bool AT, bool BT>
__global__ void __launch_bounds__(NT)
rsa_is_kernel(const T* __restrict__ A, long long lda, const T* __restrict__ B, long long ldb,
              TO* __restrict__ C, int M, int N, int K, int bk, int slab_ld, int vec_a,
              int vec_b, long long sa, long long sb, long long sc) {
  constexpr int TM = Tiles<T>::IS_M, TN = Tiles<T>::IS_N, P = Tiles<T>::P;
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C += blockIdx.z * sc;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Aslab = aligned_slab<T>(smem_raw);  // TM x slab_ld
  __shared__ __align__(128) T Bs[BK * (TN + P)];
  __shared__ __align__(128) float Cs[TM * (TN + 4)];
  const int m0 = blockIdx.y * TM;
  const int ntiles = (N + TN - 1) / TN;
  for (int kb = 0; kb < K; kb += bk) {
    const int kc = min(bk, ((K - kb + BK - 1) / BK) * BK);
    __syncthreads();
    load_a<T, AT>(Aslab, slab_ld, A, lda, m0, kb, TM, kc, M, K, vec_a);
    for (int nt = blockIdx.x; nt < ntiles; nt += gridDim.x) {
      const int n0 = nt * TN;
      Acc<T, TM, TN> acc;
      acc.zero();
      for (int k0 = 0; k0 < kc; k0 += BK) {
        load_b<T, BT>(Bs, TN + P, B, ldb, kb + k0, n0, BK, TN, K, N, vec_b);
        __syncthreads();
        acc.mma(Aslab + k0, slab_ld, Bs, TN + P, BK);
        __syncthreads();
      }
      acc.store(Cs, TN + 4);
      __syncthreads();
      epilogue<TO, TM, TN>(Cs, TN + 4, C, m0, n0, M, N, kb > 0);
    }
  }
}

template <typename T, typename TO, bool AT, bool BT>
int launch(int mode, const void* A, long long lda, const void* B, long long ldb, void* C,
           int M, int N, int K, int bk, int num_sms, int vec_a, int vec_b, int E,
           long long sa, long long sb, long long sc, cudaStream_t stream) {
  using Ti = Tiles<T>;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  TO* c = static_cast<TO*>(C);
  // CTAs to aim for when splitting a sweep; a bank's E GEMMs already
  // multiply the grid, so each aims for its share (E = 1: the 2-D split)
  const int target = max(1, cdiv(2 * num_sms, E));
  const int chunk_rows = min(bk, cdiv(K, BK) * BK);
  if (mode == 0) {
    dim3 grid(cdiv(N, Ti::OS_N), cdiv(M, Ti::OS_M), E);
    rsa_os_kernel<T, TO, AT, BT><<<grid, NT, 0, stream>>>(a, lda, b, ldb, c, M, N, K, vec_a, vec_b,
                                                      sa, sb, sc);
  } else if (mode == 1) {
    const int ntiles = cdiv(N, Ti::WS_N), mtiles = cdiv(M, Ti::WS_M);
    const int msplit = max(1, min(mtiles, cdiv(target, ntiles)));
    const size_t dyn = (size_t)chunk_rows * (Ti::WS_N + Ti::P) * sizeof(T) + 128;
    cudaError_t e = cudaFuncSetAttribute(rsa_ws_kernel<T, TO, AT, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(ntiles, msplit, E);
    rsa_ws_kernel<T, TO, AT, BT><<<grid, NT, dyn, stream>>>(a, lda, b, ldb, c, M, N, K, bk, vec_a,
                                                        vec_b, sa, sb, sc);
  } else if (mode == 2) {
    const int ntiles = cdiv(N, Ti::IS_N), mtiles = cdiv(M, Ti::IS_M);
    const int nsplit = max(1, min(ntiles, cdiv(target, mtiles)));
    const int slab_ld = chunk_rows + Ti::P;
    const size_t dyn = (size_t)Ti::IS_M * slab_ld * sizeof(T) + 128;
    cudaError_t e = cudaFuncSetAttribute(rsa_is_kernel<T, TO, AT, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(nsplit, mtiles, E);
    rsa_is_kernel<T, TO, AT, BT><<<grid, NT, dyn, stream>>>(a, lda, b, ldb, c, M, N, K, bk, slab_ld,
                                                        vec_a, vec_b, sa, sb, sc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int launch_t(int a_trans, int b_trans, int mode, const void* A, long long lda, const void* B,
             long long ldb, void* C, int M, int N, int K, int bk, int num_sms, int vec_a,
             int vec_b, int E, long long sa, long long sb, long long sc, cudaStream_t stream) {
#define RSA_LAUNCH(AT, BT)                                                                    \
  return launch<T, TO, AT, BT>(mode, A, lda, B, ldb, C, M, N, K, bk, num_sms, vec_a, vec_b, E, \
                               sa, sb, sc, stream)
  if (a_trans && b_trans) RSA_LAUNCH(true, true);
  if (a_trans) RSA_LAUNCH(true, false);
  if (b_trans) RSA_LAUNCH(false, true);
  RSA_LAUNCH(false, false);
#undef RSA_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  mode: 0 = OS, 1 = WS, 2 = IS.
// A is row-major (M, K) with row stride lda, or (a_trans) the transpose of
// a row-major (K, M) matrix with row stride lda.  B is row-major (K, N)
// with row stride ldb, or (b_trans) the transpose of a row-major (N, K)
// matrix with row stride ldb.  C is contiguous (M, N).  E >= 1 GEMMs run
// in one launch, bank e at A + e * sa, B + e * sb and C + e * sc (element
// strides; C's is M * N for a contiguous (E, M, N)).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rsa_gemm_launch(int mode, int in_dtype, int out_dtype, int a_trans, int b_trans,
                               const void* A, long long lda, const void* B, long long ldb,
                               void* C, int M, int N, int K, int bk, int num_sms, int vec_a,
                               int vec_b, int E, long long sa, long long sb, long long sc,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk <= 0 || bk % BK != 0) return (int)cudaErrorInvalidValue;
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    return launch_t<float, float>(a_trans, b_trans, mode, A, lda, B, ldb, C, M, N, K, bk,
                                  num_sms, vec_a, vec_b, E, sa, sb, sc, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_t<bf16, bf16>(a_trans, b_trans, mode, A, lda, B, ldb, C, M, N, K, bk, num_sms,
                                vec_a, vec_b, E, sa, sb, sc, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_t<bf16, float>(a_trans, b_trans, mode, A, lda, B, ldb, C, M, N, K, bk,
                                 num_sms, vec_a, vec_b, E, sa, sb, sc, st);
  return (int)cudaErrorInvalidValue;
}
