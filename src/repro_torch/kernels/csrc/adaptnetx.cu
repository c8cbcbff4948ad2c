// ADAPTNETX -- one fused ADAPTNET query per CTA, for Hopper (sm_90a):
//
//   x = [emb_m[clamp(M)], emb_k[clamp(K)], emb_n[clamp(N)]]     (3E)
//   h = relu(x @ w1 + b1)                                        (H)
//   logits = h @ w2 + b2                                         (C)
//
// Replaces kernels/adaptnetx.py::adaptnetx_pallas of the JAX package (the
// paper's ADAPTNETX, Fig. 9b: the embedding gathers, the hidden layer and
// the classifier in one launch; the argmax is left to the caller).
//
// The TPU kernel answers one query with grid (1,): the ids arrive by
// scalar prefetch and pick the three embedding rows through the BlockSpec
// index maps, so only three rows leave HBM.  Here a CTA loads its own
// three ids, clamps each to [0, rows - 1] of its table (what JAX's gather
// and the reference's np.clip do) and gathers the 3 x E values into
// shared memory.  Thread j computes hidden unit j (and j + NT, ... for H
// > NT) reading w1 row by row, so a warp's reads of a row are coalesced,
// then applies relu.  After a barrier the threads stride over the C
// classes, reading w2 row by row, again coalesced over c.  A batch of B
// queries runs B CTAs (the reference's vmap written out); each reads the
// whole w1 / w2, which stay in L2 after the first.
//
// What bounds it on the H100: the bytes.  At E = 16, H = 128, C = 135
// the f32 weights are 95 KB, read once (~0.03 us at 3.35 TB/s); the work
// is 2 x (48 x 128 + 128 x 135) = 47 kFLOP (< 0.001 us at 67 TFLOP/s).
// Both are far below a launch's own latency (a few us), which is the
// real floor of one query: this kernel does nothing to hide it.  All
// arithmetic is f32 FMAs on CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per CTA
constexpr int MAX_IN = 192;    // 3 x E, E <= 64
constexpr int MAX_H = 1024;    // hidden units

__device__ __forceinline__ int clamp_id(int v, int rows) {
  return v < 0 ? 0 : (v >= rows ? rows - 1 : v);
}

__global__ void __launch_bounds__(NT)
adaptnetx_kernel(const int32_t* __restrict__ ids, const float* __restrict__ emb_m,
                 const float* __restrict__ emb_k, const float* __restrict__ emb_n,
                 int rows_m, int rows_k, int rows_n, int E,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 int H, int C, float* __restrict__ out) {
  __shared__ float x[MAX_IN];
  __shared__ float h[MAX_H];
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int in_dim = 3 * E;

  const int32_t* qid = ids + 3 * (int64_t)q;
  const int rm = clamp_id(qid[0], rows_m);
  const int rk = clamp_id(qid[1], rows_k);
  const int rn = clamp_id(qid[2], rows_n);
  for (int i = t; i < in_dim; i += NT) {
    const int f = i / E, c = i - f * E;
    const float* row = f == 0 ? emb_m + (int64_t)rm * E
                     : (f == 1 ? emb_k + (int64_t)rk * E : emb_n + (int64_t)rn * E);
    x[i] = row[c];
  }
  __syncthreads();

  for (int j = t; j < H; j += NT) {
    float acc = 0.f;
    for (int i = 0; i < in_dim; ++i) acc = fmaf(x[i], w1[(int64_t)i * H + j], acc);
    acc += b1[j];
    h[j] = acc > 0.f ? acc : 0.f;
  }
  __syncthreads();

  float* o = out + (int64_t)q * C;
  for (int c = t; c < C; c += NT) {
    float acc = 0.f;
    for (int j = 0; j < H; ++j) acc = fmaf(h[j], w2[(int64_t)j * C + c], acc);
    o[c] = acc + b2[c];
  }
}

}  // namespace

// ids (B, 3) int32; emb_* (rows_*, E), w1 (3E, H), b1 (H,), w2 (H, C),
// b2 (C,), out (B, C): all f32, contiguous, on one card.  Returns the
// launch's cudaError_t (0 = success); checks nothing the wrapper checks.
extern "C" int adaptnetx_launch(const void* ids, const void* emb_m, const void* emb_k,
                                const void* emb_n, int rows_m, int rows_k, int rows_n,
                                int E, const void* w1, const void* b1, const void* w2,
                                const void* b2, int H, int C, void* out, int B,
                                void* stream) {
  if (B <= 0 || E <= 0 || 3 * E > MAX_IN || H <= 0 || H > MAX_H || C <= 0 ||
      rows_m <= 0 || rows_k <= 0 || rows_n <= 0)
    return (int)cudaErrorInvalidValue;
  adaptnetx_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(emb_m),
      static_cast<const float*>(emb_k), static_cast<const float*>(emb_n), rows_m, rows_k,
      rows_n, E, static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), H, C,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
