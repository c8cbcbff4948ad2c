// RSA GEMM for Hopper (sm_90a), OS mode: C (M, N) = A (M, K) @ B (K, N)
// with the whole K accumulated in f32 and cast to the output type once.
//
// Replaces kernels/rsa_gemm.py::rsa_gemm_pallas in its OS mode (the
// _kernel_os body).  The WS and IS modes (the _kernel_psum body, with its
// per-block_k-chunk rounding) are csrc/rsa_psum.cu: a wgmma + TMA kernel
// for bf16 and a register-blocked one for f32, with split-K for skinny M.
//
// What bounds it on the H100: at decode (M = 8) every projection is a
// matrix-vector product bound by the bytes of B (the weight); at prefill
// (M = 512) the larger projections approach the tensor-core rate.  The
// design keeps one owner per output sub-tile (no atomics, no dependence on
// scheduling), reads B in place (row-major (K, N) or the transpose of a
// row-major (N, K), so the tied unembedding needs no copy) and A likewise
// (row-major (M, K) or the transpose of a row-major (K, M): the weight
// gradient x^T @ dy reads x in place), and masks ragged edges instead of
// padding.  One CTA owns a 64 x 64 output sub-tile and keeps its f32
// accumulator in registers over the whole K.  bf16 operands run on the
// tensor cores (WMMA 16x16x16, f32 accumulation); f32 operands run on
// CUDA-core FMAs in full f32.  It is a first, simple kernel: no TMA, no
// wgmma, no software pipelining.  block_m, block_n and block_k do not
// change its arithmetic.
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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

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

// Write the f32 sub-tile Cs to the output, cast once.
template <typename TO, int TM, int TN>
__device__ void epilogue(const float* Cs, int ldc, TO* __restrict__ Cg, int m0, int n0,
                         int M, int N) {
  for (int idx = threadIdx.x; idx < TM * TN; idx += NT) {
    const int r = idx / TN, c = idx - r * TN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      Cg[(long long)gr * N + gc] = from_f<TO>(Cs[r * ldc + c]);
    }
  }
}

template <typename T> struct Tiles {
  static constexpr int P = 16 / sizeof(T);                 // 16-byte row padding
  static constexpr int OS_M = 64, OS_N = 64;
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
  epilogue<TO, TM, TN>(Cs, TN + 4, C, m0, n0, M, N);
}

template <typename T, typename TO, bool AT, bool BT>
int launch(int mode, const void* A, long long lda, const void* B, long long ldb, void* C,
           int M, int N, int K, int bk, int num_sms, int vec_a, int vec_b, int E,
           long long sa, long long sb, long long sc, cudaStream_t stream) {
  using Ti = Tiles<T>;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  TO* c = static_cast<TO*>(C);
  if (mode != 0) return (int)cudaErrorInvalidValue;  // WS/IS: rsa_psum.cu
  dim3 grid(cdiv(N, Ti::OS_N), cdiv(M, Ti::OS_M), E);
  rsa_os_kernel<T, TO, AT, BT><<<grid, NT, 0, stream>>>(a, lda, b, ldb, c, M, N, K, vec_a, vec_b,
                                                    sa, sb, sc);
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

// dtype codes: 0 = float32, 1 = bfloat16.  mode: 0 = OS (the only mode
// this library runs; WS and IS are rsa_psum_launch, which takes their
// split plan and workspace).
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
