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
// The closed form, per (b, h) and chunk c of lc rows, with cs the
// inclusive cumsum of logw per key column, cs_prev = cs - logw and wsum =
// cs[lc - 1], as the reference takes them:
//
//   o[t]  = sum_{j<t} A[t,j] v[j] + (sum_k r[t,k] u[k] k[t,k]) v[t]      intra
//         + (r[t] * exp(cs_prev[t])) @ h_{c-1}                            inter
//   A[t,j] = sum_k r[t,k] k[j,k] exp(cs_prev[t,k] - cs[j,k])
//   dS_c  = (k * exp(wsum - cs))^T @ v,   h_c = exp(wsum) * h_{c-1} + dS_c
//
// The TPU kernel walks the chunks in order with the state in VMEM.  Here
// only the chain h_c needs the order; everything else runs for every chunk
// at once (kernels/linear_attn.py::_wkv_plan picks the launches):
//  * intra: one CTA per (b, h, chunk) of 256 threads, two an SM (~104 KB
//    of shared memory).  Every global load of the chunk is issued before
//    the first store (float4 where K, V are multiples of 4); r, k, cs and
//    cs_prev sit row-major in shared memory ([t][k], row stride K + 4).
//    The cumsum runs in registers: a warp sums 32 columns over a quarter
//    of the rows, then adds the earlier quarters' sums.  A is computed
//    once a chunk: its pairs j < t inside a 16-row sub-chunk directly, two
//    a thread, along k in float4 steps; the rest factorised at each row's
//    sub-chunk boundary bnd as exp(cs_prev[t] - cs[bnd-1]) *
//    exp(cs[bnd-1] - cs[j]), both exponents <= 0, as 4 x 4 tiles of dot
//    products over every boundary at once (the k sum split over lanes).
//    That turns three quarters of A's pairs at lc = 64 (1536 of 2016)
//    into FMAs (all pairs direct measured 15-20% slower,
//    launch/bench_wkv.py).  Then o_intra = A' v (A' holds the bonus diagonal) and
//    dS_c = k_hat^T v as 4 x 4 register tiles.  It writes o_intra (f32),
//    r * exp(cs_prev), dS_c and exp(wsum) to the workspace.
//  * the chain, in chunk order, as the reference writes it: h_c =
//    exp(wsum_c) * h_{c-1} + dS_c, a product rounded and then a sum (no
//    FMA), seeded from state0 or zero.  Either each inter CTA folds it
//    from dS_0 .. dS_{c-1} itself ("fold": one launch fewer, O(n^2) reads
//    of the workspace, one round trip a chunk), or a kernel of one CTA per
//    (b, h, 16 columns) walks it with eight chunks' terms in flight and
//    writes every h_{c-1} ("launch").  Both give the same bits.
//  * inter: one CTA per (b, h, chunk, V tile): o = o_intra + r_hat @
//    h_{c-1} as 4 x 4 tiles, rounded once to o's type; the last chunk's
//    CTA (fold) writes the final state.
// No exponent is positive: exp(cs_prev - cs) is taken only for j < t
// (never as exp(cs_prev) * exp(-cs): logw down to -e over 64 rows gives
// cs ~ -174), and expf is the accurate one (no fast-math, no flush to
// zero), so terms near underflow match the plain version.  Every sum runs
// in a fixed order: two runs of one plan give the same bits.
//
// Decode (chunk 1) has its own one-pass kernel: one CTA of 128 threads per
// (b, h, tile of 32 state columns), each thread four columns of up to
// four rows of the state in registers, read once and written once as
// float4, a row's operands loaded into registers (the first row's ahead
// of the state); per row h <- exp(logw) * h + k v, stored with no barrier
// before it, then o = r . h_old + (sum r u k) v through a shuffle tree and
// one shared reduction.
//
// What bounds it on the H100: at B = 1, S = 512, H = 32, K = V = 64 the
// f32 work (~0.5 GFLOP, ~7.7 us at 67 TFLOP/s on the CUDA cores; no TF32)
// against ~22 MB of r, k, v, logw, the state and o (6.6 us at 3.35 TB/s).
// What holds this design above it (launch/probe_wkv.py, S = 512, two
// intra CTAs an SM): of an intra CTA's ~60,000 cycles its loads take
// ~17,000 (every CTA loads at once, nothing overlaps them), A ~21,000
// (accurate expf and the factorised tiles), its FMA tiles ~16,000; the
// inter kernel's slowest CTA ~26,000.  A decode step at B = 8 is the 8.4
// MB of state in and out (2.5 us); the kernel takes a plain copy of the
// state (~3 us of reads from a cold L2 before the first store) plus ~0.4
// us of tail after its stores: the shuffle tree, one barrier and o.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;    // threads of the intra, chain and inter CTAs
constexpr int DNT = 128;   // threads of a decode CTA
constexpr int DVT = 32;    // state columns of a decode CTA
constexpr int MAXD = 64;   // the largest K, V and chunk
constexpr int SUB = 16;    // rows of a sub-chunk of the factorised A
constexpr int LQ = MAXD * MAXD / NT;  // elements of a 64 x 64 tile a thread holds
constexpr int LQ4 = LQ / 4;            // the same in groups of four
constexpr int CHAIN_VT = 16;           // state columns of a chain CTA
constexpr int CE = MAXD * CHAIN_VT / NT;  // state elements a chain thread holds
constexpr int CB = 8;                  // chunks whose terms a chain thread has in flight
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

struct Args {
  const void *r, *k, *v, *lw, *u;
  const float* s0;  // null: a zero state
  void* o;
  float* sf;        // null: no state out
  float* ws;        // the chunked variant's workspace (see Ws)
  int B, S, H, K, V, lc, n, u_b_stride, vt;  // vt: the inter kernel's V tile
  bool vec;         // K, V multiples of 4 and r, k, v, logw aligned: vector loads
};

// The chunked variant's f32 workspace: o_intra (B, S, H, V), then per (b,
// h, chunk): r * exp(cs_prev) as (lc, K), dS as (K, V), exp(wsum) as (K,),
// and for the chain launch h_{c-1} as (K, V).
struct Ws {
  float *oi, *rh, *ds, *dec, *hin;
};

__host__ __device__ __forceinline__ Ws ws_parts(const Args& a) {
  const size_t bhn = (size_t)a.B * a.H * a.n;
  Ws w;
  w.oi = a.ws;
  w.rh = w.oi + (size_t)a.B * a.S * a.H * a.V;
  w.ds = w.rh + bhn * a.lc * a.K;
  w.dec = w.ds + bhn * a.K * a.V;
  w.hin = w.dec + bhn * a.K;
  return w;
}

// shared floats of an intra CTA: r, cs_prev, k, cs (L4 x KP each, rows
// t), A^T (L4 x LP), v (L4 x VP; before v lands, 48 rows of KP of the
// factorised A's scratch), u, wsum and the cumsum's four segment sums
__host__ __device__ __forceinline__ int intra_floats(int lc, int K, int V) {
  const int L4 = round4(lc), LP = L4 + 4, KP = round4(K) + 4, VP = round4(V) + 4;
  const int vb = L4 * VP, scratch = 48 * KP;
  return 4 * L4 * KP + L4 * LP + (vb > scratch ? vb : scratch) + 6 * round4(K);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// acc[i][j] += a[i] . b[j]: 4 x 4 dot products of rows four long
__device__ __forceinline__ void dots4(float (&acc)[4][4], const float4 (&a)[4],
                                      const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = acc[i][j];
      s = fmaf(a[i].x, b[j].x, s), s = fmaf(a[i].y, b[j].y, s);
      s = fmaf(a[i].z, b[j].z, s), acc[i][j] = fmaf(a[i].w, b[j].w, s);
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

// four consecutive elements of a row as floats: one 16-byte (f32) or
// 8-byte (bf16) load where vec, else n (< 4: the row's end) loads and zeros
__device__ __forceinline__ float4 load4(const float* p, bool vec, int n) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                     n > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ float4 load4(const bf16* p, bool vec, int n) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(n > 0 ? to_f(p[0]) : 0.f, n > 1 ? to_f(p[1]) : 0.f,
                     n > 2 ? to_f(p[2]) : 0.f, n > 3 ? to_f(p[3]) : 0.f);
}

// the q-th pair (t, j), j < t, of a triangle of rows 0 .. : t (t - 1) / 2
// <= q < t (t + 1) / 2
__device__ __forceinline__ void tri_pair(int q, int& t, int& j) {
  t = (int)((1.f + sqrtf(8.f * q + 1.f)) * 0.5f);
  while (t * (t - 1) / 2 > q) --t;
  while (t * (t + 1) / 2 <= q) ++t;
  j = q - t * (t - 1) / 2;
}

// A's pairs computed directly: those inside a 16-row sub-chunk (120 a
// full one), and the q-th of them
__device__ __forceinline__ int direct_pairs(int lc) {
  const int last = lc - (lc - 1) / SUB * SUB;  // rows of the last sub-chunk
  return (lc - 1) / SUB * (SUB * (SUB - 1) / 2) + last * (last - 1) / 2;
}
__device__ __forceinline__ void direct_pair(int q, int& t, int& j) {
  const int p = q / (SUB * (SUB - 1) / 2);
  tri_pair(q - p * (SUB * (SUB - 1) / 2), t, j);
  t += p * SUB, j += p * SUB;
}

// ---------------------------------------------------------------------------
// intra: one CTA per (b, h, chunk), blockIdx.x = (b * H + h) * n + c
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, 2) wkv_intra_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lc = a.lc, K = a.K, V = a.V, H = a.H;
  const int L4 = round4(lc), LP = L4 + 4, K4 = round4(K), KP = K4 + 4, V4 = round4(V),
            VP = V4 + 4, KG = K4 / 4, VG = V4 / 4;
  float* rR = sm;               // [t][k] r
  float* cpR = rR + L4 * KP;    // [t][k] cs - logw
  float* kR = cpR + L4 * KP;    // [t][k] k, then k * exp(wsum - cs)
  float* csR = kR + L4 * KP;    // [t][k] logw, then its inclusive cumsum
  float* AT = csR + L4 * KP;    // [j][t] A with the bonus diagonal, zero above it
  float* vb = AT + L4 * LP;     // [t][v] v
  const int vb_floats = L4 * VP, scratch = 48 * KP;
  float* us = vb + (vb_floats > scratch ? vb_floats : scratch);
  float* wsum = us + K4;
  float* segs = wsum + K4;      // [4][k] the cumsum's segment sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bc = blockIdx.x, bh = bc / a.n, c = bc - bh * a.n;
  const int b = bh / H, hh = bh - b * H;
  const size_t row0 = (size_t)b * a.S + (size_t)c * lc;  // the chunk's first row
  const bool vec = a.vec;
  const Ws w = ws_parts(a);
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* lw = static_cast<const T*>(a.lw);
  const T* v = static_cast<const T*>(a.v);
  const T* urow = static_cast<const T*>(a.u) + (size_t)b * a.u_b_stride + (size_t)hh * K;

  // every global load of the chunk issued before the first store to shared
  // memory: a thread's groups of four of r, k, logw and v in flight at once
  float4 rv[LQ4], kv[LQ4], wv[LQ4], vv[LQ4];
#pragma unroll
  for (int q = 0; q < LQ4; ++q) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const int i = tid + q * NT, t = i / KG, k4 = 4 * (i - t * KG);
    rv[q] = kv[q] = wv[q] = vv[q] = z;
    if (i < L4 * KG && t < lc && k4 < K) {
      const size_t g = ((row0 + t) * H + hh) * K + k4;
      rv[q] = load4(r + g, vec, K - k4), kv[q] = load4(k + g, vec, K - k4);
      wv[q] = load4(lw + g, vec, K - k4);
    }
    const int tv = i / VG, v4 = 4 * (i - tv * VG);
    if (i < L4 * VG && tv < lc && v4 < V)
      vv[q] = load4(v + ((row0 + tv) * H + hh) * V + v4, vec, V - v4);
  }
#pragma unroll
  for (int q = 0; q < LQ4; ++q) {
    const int i = tid + q * NT, t = i / KG, k4 = 4 * (i - t * KG);
    if (i < L4 * KG)
      st4(rR + t * KP + k4, rv[q]), st4(kR + t * KP + k4, kv[q]), st4(csR + t * KP + k4, wv[q]);
  }
  auto store_v = [&]() {
#pragma unroll
    for (int q = 0; q < LQ4; ++q) {
      const int i = tid + q * NT, tv = i / VG;
      if (i < L4 * VG) st4(vb + tv * VP + 4 * (i - tv * VG), vv[q]);
    }
  };
  for (int i = tid; i < K4; i += NT) us[i] = i < K ? to_f(urow[i]) : 0.f;
  for (int i = tid; i < L4 * LP; i += NT) AT[i] = 0.f;
  __syncthreads();

  // the cumsum, in registers: warp w takes 32 key columns (w & 1) over a
  // quarter of the rows (w >> 1), sums them in order, then adds the
  // earlier quarters' sums in order (rows past lc hold logw = 0, so they
  // repeat cs[lc - 1])
  {
    const int kk = 32 * (warp & 1) + lane, seg = warp >> 1, SEG = L4 / 4, t0 = seg * SEG;
    float x[MAXD / 4], run[MAXD / 4];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXD / 4; ++i) x[i] = (i < SEG && kk < K4) ? csR[(t0 + i) * KP + kk] : 0.f;
#pragma unroll
    for (int i = 0; i < MAXD / 4; ++i) s += x[i], run[i] = s;
    if (kk < K4) segs[seg * K4 + kk] = s;
    __syncthreads();
    if (kk < K4) {
      float off = 0.f;
      for (int q = 0; q < seg; ++q) off += segs[q * K4 + kk];
#pragma unroll
      for (int i = 0; i < MAXD / 4; ++i) {
        if (i >= SEG) break;
        const float cs = off + run[i];
        csR[(t0 + i) * KP + kk] = cs, cpR[(t0 + i) * KP + kk] = cs - x[i];
        if (t0 + i == lc - 1) wsum[kk] = cs;
      }
    }
  }
  __syncthreads();

  // the bonus diagonal, on A's diagonal
  for (int t = tid; t < lc; t += NT) {
    float s = 0.f;
    for (int k4 = 0; k4 < K4; k4 += 4) {
      const float4 x = ld4(rR + t * KP + k4), y = ld4(kR + t * KP + k4), uu = ld4(us + k4);
      s += x.x * uu.x * y.x, s += x.y * uu.y * y.y, s += x.z * uu.z * y.z, s += x.w * uu.w * y.w;
    }
    AT[t * LP + t] = s;
  }
  // r decayed to the chunk start, and the chunk's decay, for the inter kernel
  float* rh = w.rh + (size_t)bc * lc * K;
  for (int i = tid; i < lc * KG; i += NT) {
    const int t = i / KG, k4 = 4 * (i - t * KG);
    const float4 x = ld4(rR + t * KP + k4), p = ld4(cpR + t * KP + k4);
    const float4 e =
        make_float4(x.x * expf(p.x), x.y * expf(p.y), x.z * expf(p.z), x.w * expf(p.w));
    if (vec) {
      st4(rh + t * K + k4, e);
    } else {
      const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (k4 + q < K) rh[t * K + k4 + q] = ev[q];
    }
  }
  for (int kk = tid; kk < K; kk += NT) w.dec[(size_t)bc * K + kk] = expf(wsum[kk]);

  // A's pairs inside the sub-chunks, two a thread at a time, along k in fours
  const int np = direct_pairs(lc);
  for (int q0 = 0; q0 < np; q0 += 2 * NT) {
    int t0 = 1, j0 = 0, t1 = 1, j1 = 0;
    const bool ok0 = q0 + tid < np, ok1 = q0 + NT + tid < np;
    if (ok0) direct_pair(q0 + tid, t0, j0);
    if (ok1) direct_pair(q0 + NT + tid, t1, j1);
    float a0 = 0.f, a1 = 0.f;
    for (int k4 = 0; k4 < K4; k4 += 4) {
      const float4 r0 = ld4(rR + t0 * KP + k4), p0 = ld4(cpR + t0 * KP + k4);
      const float4 k0 = ld4(kR + j0 * KP + k4), c0 = ld4(csR + j0 * KP + k4);
      const float4 r1 = ld4(rR + t1 * KP + k4), p1 = ld4(cpR + t1 * KP + k4);
      const float4 k1 = ld4(kR + j1 * KP + k4), c1 = ld4(csR + j1 * KP + k4);
      a0 += r0.x * k0.x * expf(p0.x - c0.x), a1 += r1.x * k1.x * expf(p1.x - c1.x);
      a0 += r0.y * k0.y * expf(p0.y - c0.y), a1 += r1.y * k1.y * expf(p1.y - c1.y);
      a0 += r0.z * k0.z * expf(p0.z - c0.z), a1 += r1.z * k1.z * expf(p1.z - c1.z);
      a0 += r0.w * k0.w * expf(p0.w - c0.w), a1 += r1.w * k1.w * expf(p1.w - c1.w);
    }
    if (ok0) AT[j0 * LP + t0] = a0;
    if (ok1) AT[j1 * LP + t1] = a1;
  }
  {
    // across sub-chunks, factorised at each row t's boundary bnd (its
    // sub-chunk's first row) against every column j < bnd, all blocks at once
    __syncthreads();             // the direct pairs are done with r, cs_prev
    float* rt = vb;              // [t - SUB][k] r * exp(cs_prev - cs[bnd - 1])
    for (int i = tid; i < (L4 - SUB) * KG; i += NT) {
      const int tl = i / KG, k4 = 4 * (i - tl * KG), t = SUB + tl;
      const float* cb = csR + (t / SUB * SUB - 1) * KP + k4;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < lc) {
        const float4 x = ld4(rR + t * KP + k4), pt = ld4(cpR + t * KP + k4), cr = ld4(cb);
        y = make_float4(x.x * expf(pt.x - cr.x), x.y * expf(pt.y - cr.y),
                        x.z * expf(pt.z - cr.z), x.w * expf(pt.w - cr.w));
      }
      st4(rt + tl * KP + k4, y);
    }
    __syncthreads();             // r and cs_prev are free: k's blocks land there
    float* kt = rR;              // block p (bnd = 16p) at rows 8p(p - 1): [j][k]
    const int P = (lc + SUB - 1) / SUB, rows = 8 * P * (P - 1);  // k * exp(cs[bnd - 1] - cs)
    for (int i = tid; i < rows * KG; i += NT) {
      const int row = i / KG, k4 = 4 * (i - row * KG);
      const int p = row < 16 ? 1 : row < 48 ? 2 : 3, j = row - 8 * p * (p - 1);
      const float4 x = ld4(kR + j * KP + k4), cj = ld4(csR + j * KP + k4);
      const float4 cr = ld4(csR + (SUB * p - 1) * KP + k4);
      st4(kt + row * KP + k4, make_float4(x.x * expf(cr.x - cj.x), x.y * expf(cr.y - cj.y),
                                          x.z * expf(cr.z - cj.z), x.w * expf(cr.w - cj.w)));
    }
    __syncthreads();
    // 4 x 4 tiles of every block (16p of block p), the k sum split over
    // ks lanes
    const int tiles = 8 * P * (P - 1);
    int ks = 8;
    while (ks > 1 && tiles * ks > NT) ks >>= 1;
    const int item = tid / ks, part = tid - item * ks;
    const bool live = item < tiles;
    const int p = item < 16 ? 1 : item < 48 ? 2 : 3, ib = item - 8 * p * (p - 1);
    const int tg = ib & 3, jg = ib >> 2, t0 = SUB * p + 4 * tg;
    float acc[4][4] = {};
    if (live)
      for (int k4 = 4 * part; k4 < K4; k4 += 4 * ks) {
        float4 x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = ld4(rt + (t0 - SUB + i) * KP + k4);
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = ld4(kt + (8 * p * (p - 1) + 4 * jg + i) * KP + k4);
        dots4(acc, x, y);
      }
    for (int d = ks >> 1; d > 0; d >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += __shfl_xor_sync(FULL, acc[i][jj], d);
    if (live && part == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (t0 + i < lc) AT[(4 * jg + jj) * LP + t0 + i] = acc[i][jj];
    __syncthreads();  // A is done with the scratch: v lands there
    store_v();
  }
  __syncthreads();

  // k decayed to the chunk end, in place (rows past lc hold k = 0)
  for (int i = tid; i < L4 * KG; i += NT) {
    const int t = i / KG, k4 = 4 * (i - t * KG);
    const float4 x = ld4(kR + t * KP + k4), ct = ld4(csR + t * KP + k4), ws4 = ld4(wsum + k4);
    st4(kR + t * KP + k4, make_float4(x.x * expf(ws4.x - ct.x), x.y * expf(ws4.y - ct.y),
                                      x.z * expf(ws4.z - ct.z), x.w * expf(ws4.w - ct.w)));
  }
  __syncthreads();

  // o_intra = A' v, to the workspace
  for (int it = tid; it < (L4 / 4) * VG; it += NT) {
    const int tg = it / VG, vg = it - tg * VG;
    float acc[4][4] = {};
    const int jn = min(4 * tg + 4, lc);
    for (int j = 0; j < jn; ++j) outer4(acc, ld4(AT + j * LP + 4 * tg), ld4(vb + j * VP + 4 * vg));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * tg + i;
      if (t >= lc) break;
      float* orow = w.oi + ((row0 + t) * H + hh) * V;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (4 * vg + jj < V) orow[4 * vg + jj] = acc[i][jj];
    }
  }
  // dS_c = k_hat^T v
  float* ds = w.ds + (size_t)bc * K * V;
  for (int it = tid; it < KG * VG; it += NT) {
    const int kg = it / VG, vg = it - kg * VG;
    float acc[4][4] = {};
    for (int j = 0; j < L4; ++j) outer4(acc, ld4(kR + j * KP + 4 * kg), ld4(vb + j * VP + 4 * vg));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * kg + i >= K) break;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (4 * vg + jj < V) ds[(4 * kg + i) * V + 4 * vg + jj] = acc[i][jj];
    }
  }
}

// h_c = exp(wsum_c) * h_{c-1} + dS_c in the reference's rounding: the
// product rounded, then the sum (no FMA)
__device__ __forceinline__ float chain_step(float dec, float h, float ds) {
  return __fadd_rn(__fmul_rn(dec, h), ds);
}

// ---------------------------------------------------------------------------
// the chain: one CTA per (b, h, V tile) walks the chunks in order
// ---------------------------------------------------------------------------

// A thread's LQ elements e = tid + q NT of a state tile of vt columns
// from v0 (row-major, vn of them real): each one's row k and k * V + v, or
// col -1 past the state.
__device__ __forceinline__ void tile_cols(int (&row)[LQ], int (&col)[LQ], int K, int V, int v0,
                                          int vn, int vt, int tid) {
#pragma unroll
  for (int q = 0; q < LQ; ++q) {
    const int e = tid + q * NT, kk = e / vt, vv = e - kk * vt;
    row[q] = kk;
    col[q] = (kk < K && vv < vn) ? kk * V + v0 + vv : -1;
  }
}

// chunk bc's decay and dS at the thread's elements
__device__ __forceinline__ void chunk_terms(float (&d)[LQ], float (&x)[LQ], const int (&row)[LQ],
                                            const int (&col)[LQ], const float* __restrict__ dec,
                                            const float* __restrict__ ds, size_t bc, int K,
                                            int V) {
  const float* __restrict__ dc = dec + bc * K;
  const float* __restrict__ dd = ds + bc * K * V;
#pragma unroll
  for (int q = 0; q < LQ; ++q)
    if (col[q] >= 0) d[q] = dc[row[q]], x[q] = dd[col[q]];
}

__global__ void __launch_bounds__(NT, 2) wkv_chain_kernel(const Args a) {
  // a CTA owns CHAIN_VT columns: CE elements a thread, each chunk's terms
  // for CB chunks at a time in flight
  const int K = a.K, V = a.V, n = a.n, bh = blockIdx.x, v0 = blockIdx.y * CHAIN_VT;
  const int vn = min(CHAIN_VT, V - v0), tid = threadIdx.x;
  const Ws w = ws_parts(a);
  const float* __restrict__ dec = w.dec;
  const float* __restrict__ ds = w.ds;
  float* __restrict__ hin = w.hin;
  int row[CE], col[CE];
  float h[CE];
#pragma unroll
  for (int q = 0; q < CE; ++q) {
    const int e = tid + q * NT, kk = e / CHAIN_VT, vv = e - kk * CHAIN_VT;
    row[q] = kk;
    col[q] = (kk < K && vv < vn) ? kk * V + v0 + vv : -1;
    h[q] = (col[q] >= 0 && a.s0) ? a.s0[(size_t)bh * K * V + col[q]] : 0.f;
  }
  for (int c0 = 0; c0 < n; c0 += CB) {
    float d[CB][CE], x[CB][CE];
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const size_t bc = (size_t)bh * n + c0 + i;
#pragma unroll
      for (int q = 0; q < CE; ++q)
        if (c0 + i < n && col[q] >= 0)
          d[i][q] = dec[bc * K + row[q]], x[i][q] = ds[bc * K * V + col[q]];
    }
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const size_t bc = (size_t)bh * n + c0 + i;
#pragma unroll
      for (int q = 0; q < CE; ++q) {
        if (c0 + i >= n || col[q] < 0) continue;
        hin[bc * K * V + col[q]] = h[q];
        h[q] = chain_step(d[i][q], h[q], x[i][q]);
      }
    }
  }
  if (a.sf)
#pragma unroll
    for (int q = 0; q < CE; ++q)
      if (col[q] >= 0) a.sf[(size_t)bh * K * V + col[q]] = h[q];
}

// ---------------------------------------------------------------------------
// inter: one CTA per (b, h, chunk, V tile), blockIdx = ((b * H + h) * n + c,
// tile)
// ---------------------------------------------------------------------------

template <typename T, bool FOLD>
__global__ void __launch_bounds__(NT, 2) wkv_inter_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lc = a.lc, K = a.K, V = a.V, H = a.H, VT = a.vt;
  const int L4 = round4(lc), K4 = round4(K), KP = K4 + 4;
  float* rhR = sm;              // [t][k] r * exp(cs_prev)
  float* hs = rhR + L4 * KP;    // [k][v] h_{c-1}'s tile
  const int tid = threadIdx.x;
  const int bc = blockIdx.x, bh = bc / a.n, c = bc - bh * a.n;
  const int b = bh / H, hh = bh - b * H;
  const int v0 = blockIdx.y * VT, vn = min(VT, V - v0);
  const size_t row0 = (size_t)b * a.S + (size_t)c * lc;
  const Ws w = ws_parts(a);

  // h_{c-1}: the thread's elements of the tile, seeded from state0 (its
  // loads in flight with r_hat's) and folded over chunks 0 .. c-1, or the
  // chain kernel's
  int row[LQ], col[LQ];
  tile_cols(row, col, K, V, v0, vn, a.vt, tid);
  float h[LQ];
#pragma unroll
  for (int q = 0; q < LQ; ++q)
    h[q] = col[q] < 0 ? 0.f
           : FOLD ? (a.s0 ? a.s0[(size_t)bh * K * V + col[q]] : 0.f)
                  : w.hin[(size_t)bc * K * V + col[q]];
  // r_hat's rows, all in flight
  const float* __restrict__ rh = w.rh + (size_t)bc * lc * K;
  const int KG = K4 / 4;
  float4 rv[LQ4];
#pragma unroll
  for (int q = 0; q < LQ4; ++q) {
    const int i = tid + q * NT, t = i / KG, k4 = 4 * (i - t * KG);
    rv[q] = (i < L4 * KG && t < lc) ? load4(rh + t * K + k4, a.vec, K - k4)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < LQ4; ++q) {
    const int i = tid + q * NT, t = i / KG;
    if (i < L4 * KG) st4(rhR + t * KP + 4 * (i - t * KG), rv[q]);
  }
  if (FOLD) {
    const size_t base = (size_t)bh * a.n;
    float d[LQ], x[LQ];
    for (int i = 0; i < c; ++i) {
      chunk_terms(d, x, row, col, w.dec, w.ds, base + i, K, V);  // all in flight
#pragma unroll
      for (int q = 0; q < LQ; ++q)
        if (col[q] >= 0) h[q] = chain_step(d[q], h[q], x[q]);
    }
    if (c == a.n - 1 && a.sf) {  // the last chunk's CTA goes on to the final state
      chunk_terms(d, x, row, col, w.dec, w.ds, base + c, K, V);
#pragma unroll
      for (int q = 0; q < LQ; ++q)
        if (col[q] >= 0) a.sf[(size_t)bh * K * V + col[q]] = chain_step(d[q], h[q], x[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < LQ; ++q)
    if (tid + q * NT < K4 * VT) hs[tid + q * NT] = h[q];  // 0 past the state
  __syncthreads();

  // o = o_intra + r_hat h_{c-1}: o_intra's tile in flight under the products
  const int VTg = VT / 4;
  T* o = static_cast<T*>(a.o);
  const float* __restrict__ oi = w.oi;
  for (int it = tid; it < (L4 / 4) * VTg; it += NT) {
    const int tg = it / VTg, vg = it - tg * VTg;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int t = 4 * tg + i, vv = 4 * vg + jj;
        acc[i][jj] = (t < lc && vv < vn) ? oi[((row0 + t) * H + hh) * V + v0 + vv] : 0.f;
      }
    for (int k4 = 0; k4 < K4; k4 += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = ld4(rhR + (4 * tg + i) * KP + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = ld4(hs + (k4 + q) * VT + 4 * vg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xi[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(xi[q], y[q].x, acc[i][0]), acc[i][1] = fmaf(xi[q], y[q].y, acc[i][1]);
          acc[i][2] = fmaf(xi[q], y[q].z, acc[i][2]), acc[i][3] = fmaf(xi[q], y[q].w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * tg + i;
      if (t >= lc) break;
      const size_t orow = ((row0 + t) * H + hh) * V + v0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (4 * vg + jj < vn) o[orow + 4 * vg + jj] = from_f<T>(acc[i][jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// decode (chunk 1): one CTA per (b, h, tile of 32 state columns), the rows
// in order, the state in registers
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(DNT) wkv_decode_kernel(const Args a) {
  __shared__ float part[DNT / 32][DVT];
  __shared__ float dg;
  constexpr int VT = DVT, CG = VT / 4, KG = DNT / CG;  // column groups, row groups
  constexpr int MAXR = MAXD / KG;                     // rows a thread holds
  const int K = a.K, V = a.V, H = a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % CG, kg = tid / CG;
  const int bh = blockIdx.x, b = bh / H, hh = bh - b * H;
  const int vt0 = blockIdx.y * VT, c0 = vt0 + 4 * cg;  // the tile's, the thread's first column
  const bool vec = V % 4 == 0;                         // 16-byte state rows
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* lw = static_cast<const T*>(a.lw);
  const T* v = static_cast<const T*>(a.v);
  const T* urow = static_cast<const T*>(a.u) + (size_t)b * a.u_b_stride + (size_t)hh * K;
  T* o = static_cast<T*>(a.o);

  // a row's operands where the thread needs them, in registers as loaded
  // (L1 serves the CTA's repeats): r, k, logw at its state rows, v at its
  // columns and (threads < VT) at the o column it writes; warp 0 also r,
  // u, k at every k (lanes k, k + 32) for the bonus term.  Row 0's go out
  // before the state's loads, and no barrier stands before the state's
  // update: each thread updates and stores its state once its own loads
  // land, as a copy would (launch/probe_wkv.py: a barrier there waited ~3
  // us from entry behind the state's reads, and every store after it)
  const T zero = from_f<T>(0.f);
  T xr[MAXR], xk[MAXR], xw[MAXR], xv[4], br[2], bk[2], bu[2], ov = zero;
  auto load_row = [&](int s) {
    const size_t g = ((size_t)b * a.S + s) * H + hh;
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const int kk = kg + KG * i;
      const bool in = kk < K;
      xr[i] = in ? r[g * K + kk] : zero, xk[i] = in ? k[g * K + kk] : zero;
      xw[i] = in ? lw[g * K + kk] : zero;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = c0 + j < V ? v[g * V + c0 + j] : zero;
    if (warp == 0)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool in = lane + 32 * q < K;
        br[q] = in ? r[g * K + lane + 32 * q] : zero, bk[q] = in ? k[g * K + lane + 32 * q] : zero;
      }
    if (tid < VT) ov = vt0 + tid < V ? v[g * V + vt0 + tid] : zero;
  };
  load_row(0);
  if (warp == 0)
#pragma unroll
    for (int q = 0; q < 2; ++q) bu[q] = lane + 32 * q < K ? urow[lane + 32 * q] : zero;

  // the thread's state: rows kg + KG i, columns c0 .. c0 + 3
  float h[MAXR][4];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int kk = kg + KG * i;
    const float* row = a.s0 + ((size_t)bh * K + kk) * V + c0;
    if (kk < K && a.s0 && vec && c0 < V) {
      const float4 x = *reinterpret_cast<const float4*>(row);
      h[i][0] = x.x, h[i][1] = x.y, h[i][2] = x.z, h[i][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = (kk < K && a.s0 && c0 + j < V) ? row[j] : 0.f;
    }
  }
  // the thread's new state, to sf: float4 rows where V allows
  auto store_state = [&](float* sf, const float (&x)[MAXR][4]) {
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const int kk = kg + KG * i;
      float* row = sf + ((size_t)bh * K + kk) * V + c0;
      if (kk < K && vec && c0 < V) {
        *reinterpret_cast<float4*>(row) = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kk < K && c0 + j < V) row[j] = x[i][j];
      }
    }
  };
  for (int s = 0; s < a.S; ++s) {
    const size_t g = ((size_t)b * a.S + s) * H + hh;
    // r . h over the thread's rows (the old state), then the new state --
    // on the last row stored at once -- and the next row's loads issued
    float p[4] = {};
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const float rr = to_f(xr[i]);
      if (kg + KG * i < K)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] += rr * h[i][j];
    }
#pragma unroll
    for (int i = 0; i < MAXR; ++i) {
      const float e = expf(to_f(xw[i])), kv = to_f(xk[i]);
      if (kg + KG * i < K)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[i][j] = __fadd_rn(__fmul_rn(e, h[i][j]), __fmul_rn(kv, to_f(xv[j])));
    }
    if (s + 1 == a.S && a.sf) store_state(a.sf, h);
    float d = 0.f, vo = to_f(ov);
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (lane + 32 * q < K) d += to_f(br[q]) * to_f(bu[q]) * to_f(bk[q]);
    }
    if (s + 1 < a.S) load_row(s + 1);  // the next row in flight under the reductions
    // the warp's sum (a shuffle tree over the lanes of one column group),
    // the bonus term over warp 0, then the four warps' in order
    for (int off = CG; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] += __shfl_xor_sync(FULL, p[j], off);
    if (lane < CG)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = p[j];
    if (warp == 0) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
      if (lane == 0) dg = d;
    }
    __syncthreads();
    if (tid < VT && vt0 + tid < V) {
      float acc = part[0][tid];
#pragma unroll
      for (int q = 1; q < DNT / 32; ++q) acc += part[q][tid];
      o[g * V + vt0 + tid] = from_f<T>(acc + dg * vo);
    }
    if (s + 1 < a.S) __syncthreads();  // the next row overwrites part and dg
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the intra kernel's dynamic shared-memory limit, raised once per
// instantiation and device (the current one) to what the largest chunk
// and widths need
template <typename T>
cudaError_t intra_smem_limit() {
  constexpr int MAXDEV = 64;
  static bool raised[MAXDEV];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAXDEV) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(wkv_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * intra_floats(MAXD, MAXD, MAXD)));
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_intra(const Args& a, cudaStream_t st) {
  cudaError_t e = intra_smem_limit<T>();
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * intra_floats(a.lc, a.K, a.V);
  wkv_intra_kernel<T><<<(unsigned)(a.B * a.H * a.n), NT, smem, st>>>(a);
  return cudaGetLastError();
}

enum { VARIANT_CHUNKED = 0, VARIANT_DECODE = 1 };
enum { CHAIN_FOLD = 0, CHAIN_LAUNCH = 1 };

// One call of the scan under the plan (variant, chain, vt) of
// kernels/linear_attn.py::_wkv_plan: one to three kernels on the stream.
template <typename T>
int launch(Args a, int variant, int chain, cudaStream_t st) {
  const int B = a.B, S = a.S, H = a.H, K = a.K, V = a.V, lc = a.lc;
  if (B < 1 || S < 1 || H < 1 || K < 1 || K > MAXD || V < 1 || V > MAXD || lc < 1 ||
      lc > MAXD || S % lc != 0 || (long long)B * H * (S / lc) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.n = S / lc;
  const uintptr_t al = 4 * sizeof(T) - 1;
  a.vec = K % 4 == 0 && V % 4 == 0 &&
          ((reinterpret_cast<uintptr_t>(a.r) | reinterpret_cast<uintptr_t>(a.k) |
            reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.lw)) & al) == 0;
  if (variant == VARIANT_DECODE) {
    if (lc != 1 || a.vt != DVT) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)(B * H), cdiv(V, DVT));
    wkv_decode_kernel<T><<<grid, DNT, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (variant != VARIANT_CHUNKED || (chain != CHAIN_FOLD && chain != CHAIN_LAUNCH) ||
      a.ws == nullptr || a.vt < 4 || a.vt % 4 != 0 || a.vt > round4(V) || cdiv(V, a.vt) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_intra<T>(a, st);
  if (e != cudaSuccess) return (int)e;
  dim3 tiles((unsigned)(B * H * a.n), cdiv(V, a.vt));
  const size_t smem =
      sizeof(float) * ((size_t)round4(lc) * (round4(K) + 4) + (size_t)round4(K) * a.vt);
  if (chain == CHAIN_LAUNCH) {
    wkv_chain_kernel<<<dim3((unsigned)(B * H), cdiv(V, CHAIN_VT)), NT, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    wkv_inter_kernel<T, false><<<tiles, NT, smem, st>>>(a);
  } else {
    wkv_inter_kernel<T, true><<<tiles, NT, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int launch_dtype(int dtype, const Args& a, int variant, int chain, cudaStream_t st) {
  if (dtype == 0) return launch<float>(a, variant, chain, st);
  if (dtype == 1) return launch<bf16>(a, variant, chain, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (r, k, v, logw, u and o alike;
// the state and the workspace are always float32).  The plan's arguments:
// variant 0 = chunked, 1 = decode (chunk 1 only); chain 0 = folded into
// the inter kernel, 1 = its own kernel; vt the state columns a CTA of the
// inter kernel (decode: 32); ws the chunked variant's f32 workspace of
// _wkv_plan's ws_elems (null for decode).  Each returns the cudaError_t of its launches (0 on success).
extern "C" int wkv_bshk_launch(int dtype, const void* r, const void* k, const void* v,
                               const void* lw, const void* u, const void* s0, void* o,
                               void* sf, int B, int S, int H, int K, int V, int chunk,
                               int variant, int chain, int vt, void* ws, void* stream) {
  if (s0 == nullptr || sf == nullptr) return (int)cudaErrorInvalidValue;
  Args a = {r, k, v, lw, u, static_cast<const float*>(s0), o, static_cast<float*>(sf),
            static_cast<float*>(ws), B, S, H, K, V, chunk, 0, 0, vt, false};
  return launch_dtype(dtype, a, variant, chain, static_cast<cudaStream_t>(stream));
}

extern "C" int linear_attn_launch(int dtype, const void* r, const void* k, const void* v,
                                  const void* lw, const void* u, void* o, int BH, int S, int K,
                                  int V, int chunk, int variant, int chain, int vt, void* ws,
                                  void* stream) {
  Args a = {r, k, v, lw, u, nullptr, o, nullptr, static_cast<float*>(ws),
            BH, S, 1, K, V, chunk, 0, K, vt, false};
  return launch_dtype(dtype, a, variant, chain, static_cast<cudaStream_t>(stream));
}
