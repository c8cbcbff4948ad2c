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
// The reference's 512 x 512 blocks do not fit a CTA (a 512 x 64 f32 q
// block alone is 128 KB), so the kernels work on 64 x 64 tiles:
//   fwd: one CTA per (64 query rows, head, batch) walks the kv tiles up to
//        the causal limit with the online softmax (m, l, acc) in f32;
//   dq:  the same grid, recomputing p = exp(s - lse) from the saved lse;
//   dkv: one CTA per (64 kv rows, kv head, batch) holds its K and V tiles
//        and walks the G query heads of its group and, for each, the query
//        tiles from the diagonal on; each head's dk/dv is rounded to the
//        output type before the group sum, as the reference's per-head
//        outputs are, so a kv tile past every query row writes zeros.
// The causal skip is the loop bounds.  256 threads, as a 16 x 16 grid:
// thread (ty, tx) owns tile rows 4ty..4ty+3 and tile columns tx + 16c, in
// registers; tiles are staged in shared memory as f32 with an odd row
// stride (no bank conflicts on the strided reads).
//
// Arithmetic, as the reference's: scores q.k * scale in f32; masked scores
// give p = 0; p is rounded to v's type before p @ v while l sums the f32 p;
// l is clamped at 1e-30; lse = m + log(l); ds = p (dp - delta) * scale is
// rounded to the operand type before ds @ k and ds^T @ q, and dv = p^T @ do
// in f32.  Only the summation order differs (64-column tiles against the
// reference's blocks).
//
// What bounds it on the H100: operations.  At training shapes (S = 1024,
// hd = 64) every q row meets up to 1024 keys, about 4 hd flops a pair each
// way, far above the bytes of q, k, v and o.  f32 runs on CUDA-core FMAs
// (67 TFLOP/s peak); bf16 operands are widened to f32 in shared memory and
// take the same path.  This first kernel uses no tensor cores, no TMA and
// no pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;        // threads per CTA (16 x 16)
constexpr int TILE = 64;       // query rows and kv rows per tile
constexpr int RT = 4;          // tile rows a thread owns (TILE / 16)
constexpr int SC = 4;          // score columns a thread owns (TILE / 16)
constexpr int LDS = TILE + 1;  // row stride of a score tile in shared memory
constexpr float NEG = -1e30f;

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

// TILE rows of d values from src (row r at src + (row0 + r) * stride) into
// dst (row stride ld >= width) as f32; rows at or past `rows` and columns
// d..width-1 are zero.
template <typename T>
__device__ void load_rows(float* dst, int ld, int width, const T* __restrict__ src,
                          long long stride, int row0, int rows, int d) {
  for (int idx = threadIdx.x; idx < TILE * width; idx += NT) {
    const int r = idx / width, c = idx - r * width;
    const int gr = row0 + r;
    dst[r * ld + c] = (gr < rows && c < d) ? to_f(src[gr * stride + c]) : 0.f;
  }
}

// TILE f32 values (lse or delta of a query tile) into dst; zero past `rows`.
__device__ void load_vec(float* dst, const float* __restrict__ src, int row0, int rows) {
  for (int i = threadIdx.x; i < TILE; i += NT) dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
}

// acc[r][c] += sum_kk A[(4ty + r) * lda + kk] * Bm[kk * ldb + tx + 16c] over
// kk < TILE: a (TILE x TILE) @ (TILE x 16NC) product into the thread's rows
template <int NC>
__device__ __forceinline__ void mma_rows(float (&acc)[RT][NC], const float* A, int lda,
                                         const float* Bm, int ldb, int ty, int tx) {
  for (int kk = 0; kk < TILE; ++kk) {
    float a[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) a[r] = A[(ty * RT + r) * lda + kk];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float b = Bm[kk * ldb + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r][c] = fmaf(a[r], b, acc[r][c]);
    }
  }
}

// s[r][c] = sum_k X[(4ty + r) * ld + k] * Y[(tx + 16c) * ld + k] over k < d:
// the thread's entries of a (TILE x d) @ (TILE x d)^T product
__device__ __forceinline__ void dot_rows(float (&s)[RT][SC], const float* X, const float* Y,
                                         int ld, int d, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < SC; ++c) s[r][c] = 0.f;
  for (int k = 0; k < d; ++k) {
    float x[RT], y[SC];
#pragma unroll
    for (int r = 0; r < RT; ++r) x[r] = X[(ty * RT + r) * ld + k];
#pragma unroll
    for (int c = 0; c < SC; ++c) y[c] = Y[(tx + 16 * c) * ld + k];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) s[r][c] = fmaf(x[r], y[c], s[r][c]);
  }
}

struct Dims {
  int Sq, Skv, H, KVH, hd, hdv, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Dims D) {
  constexpr int W = 16 * NC, LD = W + 1;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (D.H / D.KVH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, warp = tid >> 5, lane = tid & 31;
  extern __shared__ float sm[];
  float* Qs = sm;                 // TILE x LD
  float* Ks = Qs + TILE * LD;     // TILE x LD
  float* Vs = Ks + TILE * LD;     // TILE x LD
  float* Ps = Vs + TILE * LD;     // TILE x LDS: scores, then p
  float* mrow = Ps + TILE * LDS;  // running max
  float* lrow = mrow + TILE;      // running sum of p
  float* crow = lrow + TILE;      // this tile's correction

  const long long qstride = (long long)D.H * D.hd, ostride = (long long)D.H * D.hdv;
  const long long kstride = (long long)D.KVH * D.hd, vstride = (long long)D.KVH * D.hdv;
  const T* qb = q + (long long)b * D.Sq * qstride + (long long)h * D.hd;
  const T* kb = k + (long long)b * D.Skv * kstride + (long long)kvh * D.hd;
  const T* vb = v + (long long)b * D.Skv * vstride + (long long)kvh * D.hdv;
  load_rows(Qs, LD, W, qb, qstride, q0, D.Sq, D.hd);
  for (int i = tid; i < TILE; i += NT) {
    mrow[i] = NEG;
    lrow[i] = 0.f;
  }
  float acc[RT][NC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int kv_end = D.causal ? min(D.Skv, q0 + TILE) : D.Skv;
  for (int j0 = 0; j0 < kv_end; j0 += TILE) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    load_rows(Ks, LD, W, kb, kstride, j0, D.Skv, D.hd);
    load_rows(Vs, LD, W, vb, vstride, j0, D.Skv, D.hdv);
    __syncthreads();
    float s[RT][SC];
    dot_rows(s, Qs, Ks, LD, D.hd, ty, tx);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int row = q0 + ty * RT + r, col = j0 + tx + 16 * c;
        const bool live = col < D.Skv && (!D.causal || col <= row);
        Ps[(ty * RT + r) * LDS + tx + 16 * c] = live ? s[r][c] * D.scale : NEG;
      }
    __syncthreads();
    for (int i = warp; i < TILE; i += NT / 32) {
      float* pr = Ps + i * LDS;
      const float a = pr[lane], c2 = pr[lane + 32];
      const float m_new = fmaxf(mrow[i], warp_max(fmaxf(a, c2)));
      const float pa = a > 0.5f * NEG ? expf(a - m_new) : 0.f;
      const float pc = c2 > 0.5f * NEG ? expf(c2 - m_new) : 0.f;
      const float sum = warp_sum(pa + pc);
      pr[lane] = round_to<T>(pa);  // p in v's type for p @ v
      pr[lane + 32] = round_to<T>(pc);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(mrow[i] - m_new);
        crow[i] = corr;
        lrow[i] = lrow[i] * corr + sum;
        mrow[i] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float corr = crow[ty * RT + r];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    mma_rows<NC>(acc, Ps, LDS, Vs, LD, ty, tx);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = ty * RT + r, row = q0 + i;
    if (row >= D.Sq) continue;
    const float l = fmaxf(lrow[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D.hdv) o[((long long)b * D.Sq + row) * ostride + (long long)h * D.hdv + col] =
          from_f<T>(acc[r][c] / l);
    }
  }
  for (int i = tid; i < TILE; i += NT)
    if (q0 + i < D.Sq)
      lse[((long long)b * D.H + h) * D.Sq + q0 + i] = mrow[i] + logf(fmaxf(lrow[i], 1e-30f));
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, Dims D) {
  constexpr int W = 16 * NC, LD = W + 1;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (D.H / D.KVH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  extern __shared__ float sm[];
  float* Qs = sm;                 // TILE x LD
  float* Os = Qs + TILE * LD;     // do, TILE x LD
  float* Ks = Os + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* DS = Vs + TILE * LD;     // TILE x LDS
  float* Ls = DS + TILE * LDS;    // lse of the tile's rows
  float* Dl = Ls + TILE;          // delta of the tile's rows

  const long long qstride = (long long)D.H * D.hd, ostride = (long long)D.H * D.hdv;
  const long long kstride = (long long)D.KVH * D.hd, vstride = (long long)D.KVH * D.hdv;
  const T* qb = q + (long long)b * D.Sq * qstride + (long long)h * D.hd;
  const T* ob = dout + (long long)b * D.Sq * ostride + (long long)h * D.hdv;
  const T* kb = k + (long long)b * D.Skv * kstride + (long long)kvh * D.hd;
  const T* vb = v + (long long)b * D.Skv * vstride + (long long)kvh * D.hdv;
  const long long srow = ((long long)b * D.H + h) * D.Sq;
  load_rows(Qs, LD, W, qb, qstride, q0, D.Sq, D.hd);
  load_rows(Os, LD, W, ob, ostride, q0, D.Sq, D.hdv);
  load_vec(Ls, lse + srow, q0, D.Sq);
  load_vec(Dl, delta + srow, q0, D.Sq);
  float acc[RT][NC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int kv_end = D.causal ? min(D.Skv, q0 + TILE) : D.Skv;
  for (int j0 = 0; j0 < kv_end; j0 += TILE) {
    __syncthreads();
    load_rows(Ks, LD, W, kb, kstride, j0, D.Skv, D.hd);
    load_rows(Vs, LD, W, vb, vstride, j0, D.Skv, D.hdv);
    __syncthreads();
    float s[RT][SC], dp[RT][SC];
    dot_rows(s, Qs, Ks, LD, D.hd, ty, tx);
    dot_rows(dp, Os, Vs, LD, D.hdv, ty, tx);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        const int i = ty * RT + r, row = q0 + i, col = j0 + tx + 16 * c;
        const bool live = col < D.Skv && (!D.causal || col <= row);
        const float p = live ? expf(s[r][c] * D.scale - Ls[i]) : 0.f;
        DS[i * LDS + tx + 16 * c] = round_to<T>(p * (dp[r][c] - Dl[i]) * D.scale);
      }
    __syncthreads();
    mma_rows<NC>(acc, DS, LDS, Ks, LD, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = q0 + ty * RT + r;
    if (row >= D.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D.hd)
        dq[((long long)b * D.Sq + row) * qstride + (long long)h * D.hd + col] =
            from_f<T>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 Dims D) {
  constexpr int W = 16 * NC, LD = W + 1;
  const int j0 = blockIdx.x * TILE, kvh = blockIdx.y, b = blockIdx.z;
  const int G = D.H / D.KVH;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  extern __shared__ float sm[];
  float* Ks = sm;                 // TILE x LD, this CTA's kv rows
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;     // one query tile
  float* Os = Qs + TILE * LD;     // its do
  float* PT = Os + TILE * LD;     // p^T, TILE (kv) x LDS (q)
  float* DT = PT + TILE * LDS;    // ds^T
  float* Ls = DT + TILE * LDS;
  float* Dl = Ls + TILE;

  const long long qstride = (long long)D.H * D.hd, ostride = (long long)D.H * D.hdv;
  const long long kstride = (long long)D.KVH * D.hd, vstride = (long long)D.KVH * D.hdv;
  const T* kb = k + (long long)b * D.Skv * kstride + (long long)kvh * D.hd;
  const T* vb = v + (long long)b * D.Skv * vstride + (long long)kvh * D.hdv;
  load_rows(Ks, LD, W, kb, kstride, j0, D.Skv, D.hd);
  load_rows(Vs, LD, W, vb, vstride, j0, D.Skv, D.hdv);

  float dk_sum[RT][NC], dv_sum[RT][NC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_sum[r][c] = dv_sum[r][c] = 0.f;

  // causal: query tiles wholly above this kv tile see none of it
  const int q_begin = D.causal ? j0 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + (long long)b * D.Sq * qstride + (long long)h * D.hd;
    const T* ob = dout + (long long)b * D.Sq * ostride + (long long)h * D.hdv;
    const long long srow = ((long long)b * D.H + h) * D.Sq;
    float dk_h[RT][NC], dv_h[RT][NC];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) dk_h[r][c] = dv_h[r][c] = 0.f;
    for (int i0 = q_begin; i0 < D.Sq; i0 += TILE) {
      __syncthreads();
      load_rows(Qs, LD, W, qb, qstride, i0, D.Sq, D.hd);
      load_rows(Os, LD, W, ob, ostride, i0, D.Sq, D.hdv);
      load_vec(Ls, lse + srow, i0, D.Sq);
      load_vec(Dl, delta + srow, i0, D.Sq);
      __syncthreads();
      // the transposed tiles: rows are this CTA's kv rows, columns queries
      float s[RT][SC], dp[RT][SC];
      dot_rows(s, Ks, Qs, LD, D.hd, ty, tx);
      dot_rows(dp, Vs, Os, LD, D.hdv, ty, tx);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) {
          const int kr = ty * RT + r, qc = tx + 16 * c;
          const int col = j0 + kr, row = i0 + qc;
          const bool live = col < D.Skv && row < D.Sq && (!D.causal || col <= row);
          const float p = live ? expf(s[r][c] * D.scale - Ls[qc]) : 0.f;
          PT[kr * LDS + qc] = p;
          DT[kr * LDS + qc] = round_to<T>(p * (dp[r][c] - Dl[qc]) * D.scale);
        }
      __syncthreads();
      mma_rows<NC>(dv_h, PT, LDS, Os, LD, ty, tx);
      mma_rows<NC>(dk_h, DT, LDS, Qs, LD, ty, tx);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dk_sum[r][c] += round_to<T>(dk_h[r][c]);
        dv_sum[r][c] += round_to<T>(dv_h[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = j0 + ty * RT + r;
    if (row >= D.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D.hd)
        dk[((long long)b * D.Skv + row) * kstride + (long long)kvh * D.hd + col] =
            from_f<T>(dk_sum[r][c]);
      if (col < D.hdv)
        dv[((long long)b * D.Skv + row) * vstride + (long long)kvh * D.hdv + col] =
            from_f<T>(dv_sum[r][c]);
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

// which kernel: 0 = fwd, 1 = dq, 2 = dkv
template <typename T, int NC>
int launch(int which, const void* q, const void* k, const void* v, const void* x,
           const float* lse, const float* delta, void* o1, void* o2, float* lse_out, int B,
           const Dims& D, cudaStream_t stream) {
  constexpr int LD = 16 * NC + 1;
  const size_t tile = sizeof(float) * TILE * LD, stile = sizeof(float) * TILE * LDS;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  cudaError_t e;
  if (which == 0) {
    const size_t smem = 3 * tile + stile + 3 * TILE * sizeof(float);
    if ((e = set_smem(flash_fwd_kernel<T, NC>, smem)) != cudaSuccess) return (int)e;
    dim3 grid(cdiv(D.Sq, TILE), D.H, B);
    flash_fwd_kernel<T, NC><<<grid, NT, smem, stream>>>(qt, kt, vt, static_cast<T*>(o1),
                                                        lse_out, D);
  } else if (which == 1) {
    const size_t smem = 4 * tile + stile + 2 * TILE * sizeof(float);
    if ((e = set_smem(flash_dq_kernel<T, NC>, smem)) != cudaSuccess) return (int)e;
    dim3 grid(cdiv(D.Sq, TILE), D.H, B);
    flash_dq_kernel<T, NC><<<grid, NT, smem, stream>>>(
        qt, kt, vt, static_cast<const T*>(x), lse, delta, static_cast<T*>(o1), D);
  } else {
    const size_t smem = 4 * tile + 2 * stile + 2 * TILE * sizeof(float);
    if ((e = set_smem(flash_dkv_kernel<T, NC>, smem)) != cudaSuccess) return (int)e;
    dim3 grid(cdiv(D.Skv, TILE), D.KVH, B);
    flash_dkv_kernel<T, NC><<<grid, NT, smem, stream>>>(
        qt, kt, vt, static_cast<const T*>(x), lse, delta, static_cast<T*>(o1),
        static_cast<T*>(o2), D);
  }
  return (int)cudaGetLastError();
}

int dispatch(int which, int dtype, const void* q, const void* k, const void* v, const void* x,
             const float* lse, const float* delta, void* o1, void* o2, float* lse_out, int B,
             int Sq, int Skv, int H, int KVH, int hd, int hdv, int causal, float scale,
             void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || hdv <= 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims D{Sq, Skv, H, KVH, hd, hdv, causal, scale};
  const int width = hd > hdv ? hd : hdv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width <= 64) {
    if (dtype == 0)
      return launch<float, 4>(which, q, k, v, x, lse, delta, o1, o2, lse_out, B, D, st);
    if (dtype == 1)
      return launch<bf16, 4>(which, q, k, v, x, lse, delta, o1, o2, lse_out, B, D, st);
  } else if (width <= 128) {
    if (dtype == 0)
      return launch<float, 8>(which, q, k, v, x, lse, delta, o1, o2, lse_out, B, D, st);
    if (dtype == 1)
      return launch<bf16, 8>(which, q, k, v, x, lse, delta, o1, o2, lse_out, B, D, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv
// alike; lse and delta are f32).  Each returns the cudaError_t of its
// launch (0 on success).
extern "C" int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                                float* lse, int B, int Sq, int Skv, int H, int KVH, int hd,
                                int hdv, int causal, float scale, void* stream) {
  return dispatch(0, dtype, q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, Sq, Skv, H,
                  KVH, hd, hdv, causal, scale, stream);
}

extern "C" int flash_dq_launch(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta, void* dq,
                               int B, int Sq, int Skv, int H, int KVH, int hd, int hdv,
                               int causal, float scale, void* stream) {
  return dispatch(1, dtype, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Skv, H, KVH,
                  hd, hdv, causal, scale, stream);
}

extern "C" int flash_dkv_launch(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta, void* dk,
                                void* dv, int B, int Sq, int Skv, int H, int KVH, int hd,
                                int hdv, int causal, float scale, void* stream) {
  return dispatch(2, dtype, q, k, v, dout, lse, delta, dk, dv, nullptr, B, Sq, Skv, H, KVH, hd,
                  hdv, causal, scale, stream);
}
