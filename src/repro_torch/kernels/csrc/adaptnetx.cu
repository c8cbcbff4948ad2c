// ADAPTNETX -- fused ADAPTNET queries for Hopper (sm_90a):
//
//   x = [emb_m[clamp(M)], emb_k[clamp(K)], emb_n[clamp(N)]]     (3E)
//   h = relu(x @ w1 + b1)                                        (H)
//   logits = h @ w2 + b2                                         (C)
//
// Replaces kernels/adaptnetx.py::adaptnetx_pallas of the JAX package (the
// paper's ADAPTNETX, Fig. 9b: the embedding gathers, the hidden layer and
// the classifier in one launch; the argmax is left to the caller).  The
// TPU kernel answers one query with grid (1,): scalar-prefetched ids pick
// the three embedding rows through the BlockSpec index maps.
//
// What bounds it on the H100: not the bytes (95 KB of f32 weights at E =
// 16, H = 128, C = 135 take ~0.03 us at 3.35 TB/s) nor the operations
// (47 kFLOP a query), but latency, which no design can bring to that
// bound.  A launch alone costs ~5.4 us between the L2-flushing timer's
// CUDA events (one-element add; ~3.9 us under launch/bench_wkv.py's
// timer), and a query must then wait for its ids and, through them, its
// embedding rows: two dependent round trips to memory.  The first design
// (one CTA of 128 threads a query) waited on dozens: each thread walked
// w1's 3E rows and then w2's H rows from global memory into one dependent
// sum, and no weight load left before the ids arrived.
//
// The design:
//  * Every weight byte in flight at entry.  The weights do not depend on
//    the query, so a CTA's first act, after loading its first id, is to
//    issue copies of its whole share of w1, b1, w2 and b2 into shared
//    memory (a ring of `stages` chunk buffers; with stages == chunks, all
//    of it): a contiguous w2 slice as one cp.async.bulk on an mbarrier,
//    the rest as 16-byte cp.async where source and widths are 16-byte
//    aligned and 4-byte cp.async where they are not.  The rows are then
//    gathered while the copies land, with no barrier between ids and rows.
//  * Hidden units in fixed chunks of 32, split over `groups` CTAs of
//    `chunks` chunks each.  Unit j is a sequential fmaf over i = 0 .. 3E-1,
//    then + b1[j], then relu; chunk g's partial for class c is a
//    sequential fmaf over its units; the logits are b2[c] plus the
//    partials added in ascending g.  One CTA holds every chunk (route
//    none), or the group's CTAs form a thread-block cluster of up to 8
//    (route cluster), each storing its partials with st.async into the
//    shared memory of the CTA that sums them, which waits for their bytes
//    on an mbarrier (no cluster barrier after entry, as its release is a
//    GPU-wide memory barrier).  Past 8 chunks a CTA holds several; the
//    ring and a smaller query tile keep it inside 227 KB.  The order never
//    changes, so every plan and batch size gives the same bits, and a
//    query alone the bits of the same query in a batch.
//  * A tile of `qt` queries (and `ct` classes) shares one copy of the
//    weight slice; 4 queries a thread in registers.
// All arithmetic is f32 FMAs on CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int UNITS = 32;         // hidden units a chunk
constexpr int MAX_E = 64;         // 3E <= 192 inputs
constexpr int MAX_H = 1024;       // hidden units
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int MAX_QT = 64;        // queries a tile
// the thread that sets the mbarriers and issues the bulk copies: the last,
// which gathers no embedding value of a tile of up to 4 queries at E <= 21
constexpr int BULK = NT - 1;
constexpr size_t SMEM_MAX = 232448;
enum { ROUTE_NONE = 0, ROUTE_CLUSTER = 1 };

struct AxArgs {
  const int32_t* ids;
  const float *emb_m, *emb_k, *emb_n, *w1, *b1, *w2, *b2;
  float* out;
  int rows_m, rows_k, rows_n, E, H, C, B;
  int qt, ct, groups, chunks, stages;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// the shared-memory layout, in floats (every region 16-byte aligned): the
// mbarriers (8 bytes a stage, then the combine's), the stage buffers (w1's
// columns of the chunk, then its w2 rows of the class tile at row stride
// ct, then b1), x (3E x qt, padded to 4 queries), h (a wave's 32-unit
// chunks x qt), b2's tile and the partials of every chunk.  The wrapper's
// _adaptnetx_smem mirrors it.
struct Layout {
  int bufs, stage, w2, b1, x, h, b2, part, total;
  __host__ __device__ Layout(int E, int H, int qt, int ct, int stages) {
    const int in_dim = 3 * E, qtp = round4(qt);
    w2 = in_dim * UNITS;                       // offsets inside a stage
    b1 = w2 + UNITS * ct;
    stage = b1 + UNITS;
    bufs = round4(2 * stages + 2);             // + the combine's mbarrier
    x = bufs + stages * stage;
    h = x + in_dim * qtp;
    b2 = h + stages * UNITS * qtp;
    part = b2 + round4(ct);
    total = part + round4(cdiv(H, UNITS) * qt * ct);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// the cluster barrier in halves: every thread arrives at entry (relaxed,
// after the mbarriers are set) and waits before its first store into
// another CTA's shared memory, so no CTA is written before it runs
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// a shared-memory address of this CTA, as the same address in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
// v into another CTA's shared memory, completing 4 bytes on its mbarrier
// (no cluster barrier, whose release is a GPU-wide memory barrier)
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows x cols floats from src (row stride src_stride) to dst (row stride
// dst_stride) by every thread's cp.async: 16 bytes a copy where every row
// start is 16-byte aligned on both sides, 4 bytes otherwise
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride, const float* src,
                                          int src_stride, int rows, int cols) {
  const int t = threadIdx.x;
  if (aligned16(src) && src_stride % 4 == 0 && cols % 4 == 0 && dst_stride % 4 == 0) {
    const int per = cols / 4;
#pragma unroll 1
    for (int e = t; e < rows * per; e += NT) {
      const int r = e / per, c = 4 * (e - r * per);
      cp_async16(dst + r * dst_stride + c, src + (size_t)r * src_stride + c);
    }
  } else {
#pragma unroll 1
    for (int e = t; e < rows * cols; e += NT) {
      const int r = e / cols, c = e - r * cols;
      cp_async4(dst + r * dst_stride + c, src + (size_t)r * src_stride + c);
    }
  }
}

// chunk kk's slice (w1 columns, w2 rows of the class tile, b1) into stage
// buffer `buf`, b2's class tile too where `with_b2`: thread BULK issues
// the contiguous w2 slice as one bulk copy on `bar` (arriving once, with
// its bytes; with none where the slice is not contiguous and aligned),
// every thread its cp.asyncs, awaited by cp.async.wait_all.
__device__ void issue_chunk(const AxArgs& a, float* buf, float* b2s, uint64_t* bar, int kk,
                            int c0, int nc, bool refill, bool with_b2, const Layout& L) {
  const int in_dim = 3 * a.E, j0 = kk * UNITS, nu = min(UNITS, a.H - j0);
  const float* w2 = a.w2 + (size_t)j0 * a.C + c0;
  // one class tile of every class: the chunk's w2 rows are contiguous
  const bool bulk = nc == a.C && (nu * a.C) % 4 == 0 && aligned16(w2);
  if (threadIdx.x == BULK) {
    const uint32_t bytes = bulk ? (uint32_t)(4 * nu * a.C) : 0u;
    // a refilled buffer was read through the generic proxy
    if (bulk && refill) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_tx(bar, bytes);
    if (bulk) bulk_copy(buf + L.w2, w2, bytes, bar);
  }
  copy_rows(buf, UNITS, a.w1 + j0, a.H, in_dim, nu);
  copy_rows(buf + L.b1, 0, a.b1 + j0, 0, 1, nu);
  if (with_b2) copy_rows(b2s, 0, a.b2 + c0, 0, 1, nc);
  if (!bulk) copy_rows(buf + L.w2, a.ct, w2, a.C, nu, nc);
}

// acc[j] = sequential fmaf over r < n of v[r * vs][j] * w[r * ws], for 4
// queries j: 16 rows' loads leave before their FMAs
__device__ __forceinline__ void fma_rows(float (&acc)[4], const float* w, int ws,
                                         const float4* v, int vs, int n) {
  for (int r0 = 0; r0 < n; r0 += 16) {
    float wr[16];
    float4 vr[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (r0 + j < n) {
        wr[j] = w[(r0 + j) * ws];
        vr[j] = v[(r0 + j) * vs];
      }
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (r0 + j < n) {
        acc[0] = fmaf(vr[j].x, wr[j], acc[0]);
        acc[1] = fmaf(vr[j].y, wr[j], acc[1]);
        acc[2] = fmaf(vr[j].z, wr[j], acc[2]);
        acc[3] = fmaf(vr[j].w, wr[j], acc[3]);
      }
  }
}

__device__ __forceinline__ int clamp_id(int v, int rows) {
  return v < 0 ? 0 : (v >= rows ? rows - 1 : v);
}

// ROUTE: how the partials meet
template <int ROUTE>
__global__ void __launch_bounds__(NT) adaptnetx_kernel(const AxArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int g = blockIdx.x % a.groups, tile = blockIdx.x / a.groups, ctile = blockIdx.y;
  const int nchunk = cdiv(a.H, UNITS), k0 = g * a.chunks;
  const int nk = min(a.chunks, nchunk - k0);
  const int q0 = tile * a.qt, nq = min(a.qt, a.B - q0);
  const int c0 = ctile * a.ct, nc = min(a.ct, a.C - c0);
  const int in_dim = 3 * a.E, qtp = round4(a.qt), nqb = qtp / 4;
  const Layout L(a.E, a.H, a.qt, a.ct, a.stages);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* x_s = smem + L.x;
  float* h_s = smem + L.h;
  float* b2s = smem + L.b2;
  float* part = smem + L.part;
  const size_t step = (size_t)a.qt * a.ct;     // one chunk's partials

  // the query tile's ids: each gathering thread's first, x_s[i][q] at
  // e = i * qtp + q
  int raw = 0;
  if (t < qtp * in_dim && t % qtp < nq) raw = a.ids[3 * (size_t)(q0 + t % qtp) + t / qtp / a.E];
  // the (query, class) entries this CTA sums: a share of the tile's in a
  // cluster, each entry's partials stored here by every chunk's CTA
  int lo = 0, hi = nq * nc;
  const int per = cdiv(hi, a.groups);
  if (ROUTE == ROUTE_CLUSTER) {
    lo = min(hi, g * per);
    hi = min(hi, lo + per);
  }
  uint64_t* combine_bar = &bars[a.stages];
  if (t == BULK) {
#pragma unroll 1
    for (int s = 0; s <= a.stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ROUTE == ROUTE_CLUSTER) mbar_arrive_tx(combine_bar, 4u * nchunk * (hi - lo));
  }
  if (ROUTE == ROUTE_CLUSTER) cluster_arrive_relaxed();

  // every weight byte of this CTA's chunks, in flight
#pragma unroll 1
  for (int k = 0; k < min(a.stages, nk); ++k)
    issue_chunk(a, smem + L.bufs + k * L.stage, b2s, &bars[k], k0 + k, c0, nc, false, k == 0,
                L);

  // the embedding rows, x_s[i][q] (padded queries zero)
#pragma unroll 1
  for (int e = t; e < qtp * in_dim; e += NT) {
    const int i = e / qtp, q = e - i * qtp, f = i / a.E;
    float v = 0.f;
    if (q < nq) {
      const int id = e == t ? raw : a.ids[3 * (size_t)(q0 + q) + f];
      const int rows = f == 0 ? a.rows_m : (f == 1 ? a.rows_k : a.rows_n);
      const float* tab = f == 0 ? a.emb_m : (f == 1 ? a.emb_k : a.emb_n);
      v = tab[(size_t)clamp_id(id, rows) * a.E + (i - f * a.E)];
    }
    x_s[e] = v;
  }

  // the ring: waves of up to `stages` resident chunks, each wave's units
  // and partials spread over every thread at once
  for (int w0 = 0; w0 < nk; w0 += a.stages) {
    const int nw = min(a.stages, nk - w0);
    cp_async_wait_all();
    __syncthreads();
    for (int s = 0; s < nw; ++s) mbar_wait(&bars[s], (uint32_t)((w0 / a.stages) & 1));
    // h = relu(x w1 + b1), 4 queries a thread
    for (int item = t; item < nw * UNITS * nqb; item += NT) {
      const int u = item % UNITS, r = item / UNITS, qb = r % nqb, s = r / nqb;
      if (u >= a.H - (k0 + w0 + s) * UNITS) continue;
      const float* buf = smem + L.bufs + s * L.stage;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      fma_rows(acc, buf + u, UNITS, reinterpret_cast<const float4*>(x_s) + qb, nqb, in_dim);
      const float b = buf[L.b1 + u];
      float4 hv;
      hv.x = fmaxf(acc[0] + b, 0.f);
      hv.y = fmaxf(acc[1] + b, 0.f);
      hv.z = fmaxf(acc[2] + b, 0.f);
      hv.w = fmaxf(acc[3] + b, 0.f);
      reinterpret_cast<float4*>(h_s + (s * UNITS + u) * qtp)[qb] = hv;
    }
    __syncthreads();
    if (ROUTE == ROUTE_CLUSTER && w0 == 0) cluster_wait();
    // this wave's partials, 4 queries a thread, each stored where it is
    // summed: the CTA owning its (query, class) entry (cluster) or this
    // CTA (none)
    for (int item = t; item < nw * nc * nqb; item += NT) {
      const int c = item % nc, r = item / nc, qb = r % nqb, s = r / nqb;
      const int kk = k0 + w0 + s, nu = min(UNITS, a.H - kk * UNITS);
      const float* w2s = smem + L.bufs + s * L.stage + L.w2;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      fma_rows(acc, w2s + c, a.ct, reinterpret_cast<const float4*>(h_s + s * UNITS * qtp) + qb,
               nqb, nu);
      for (int j = 0; j < 4 && 4 * qb + j < nq; ++j) {
        const int q = 4 * qb + j;
        const size_t at = kk * step + (size_t)q * a.ct + c;
        if (ROUTE == ROUTE_CLUSTER) {
          const uint32_t owner = (q * nc + c) / per;
          st_async(map_rank(part + at, owner), acc[j], map_rank(combine_bar, owner));
        } else {
          part[at] = acc[j];
        }
      }
    }
    if (w0 + a.stages < nk) {
      __syncthreads();
#pragma unroll 1
      for (int s = 0; s < min(a.stages, nk - w0 - a.stages); ++s)
        issue_chunk(a, smem + L.bufs + s * L.stage, b2s, &bars[s], k0 + w0 + a.stages + s, c0,
                    nc, true, false, L);
    }
  }

  // the combine
  if (ROUTE == ROUTE_CLUSTER)
    mbar_wait(combine_bar, 0);     // every partial of this CTA's entries here
  else
    __syncthreads();

  // the sum, in ascending chunks (the loads of 8 chunks leave together)
  for (int e = lo + t; e < hi; e += NT) {
    const int q = e / nc, c = e - q * nc;
    const size_t off = (size_t)q * a.ct + c;
    float acc = b2s[c];
#pragma unroll 8
    for (int k = 0; k < nchunk; ++k) acc += part[k * step + off];
    a.out[(size_t)(q0 + q) * a.C + c0 + c] = acc;
  }

  // done
}

// the dynamic shared-memory limit, raised to the card's once per
// instantiation and device (the current one)
template <int ROUTE>
cudaError_t smem_limit() {
  constexpr int MAXDEV = 64;
  static bool raised[MAXDEV];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAXDEV) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(adaptnetx_kernel<ROUTE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  return cudaSuccess;
}

template <int ROUTE>
cudaError_t launch(const AxArgs& a, dim3 grid, size_t smem, cudaStream_t st) {
  cudaError_t e = smem_limit<ROUTE>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (ROUTE == ROUTE_CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.groups;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, adaptnetx_kernel<ROUTE>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// ids (B, 3) int32; emb_* (rows_*, E), w1 (3E, H), b1 (H,), w2 (H, C),
// b2 (C,), out (B, C): all f32, contiguous, on one card.  The plan
// (kernels/adaptnetx.py::_adaptnetx_plan): qt queries and ct classes a
// tile, `groups` CTAs of `chunks` 32-unit hidden chunks each over the
// hidden units (a cluster where groups > 1), a ring of `stages` chunk
// buffers.  Returns
// the launch's cudaError_t (0 = success); an unfit plan returns
// cudaErrorInvalidValue before any launch.
extern "C" int adaptnetx_launch(const void* ids, const void* emb_m, const void* emb_k,
                                const void* emb_n, int rows_m, int rows_k, int rows_n,
                                int E, const void* w1, const void* b1, const void* w2,
                                const void* b2, int H, int C, void* out, int B, int qt,
                                int ct, int groups, int chunks, int stages, void* stream) {
  const int nchunk = H > 0 ? cdiv(H, UNITS) : 0;
  if (B <= 0 || E <= 0 || E > MAX_E || H <= 0 || H > MAX_H || C <= 0 || rows_m <= 0 ||
      rows_k <= 0 || rows_n <= 0 || qt <= 0 || qt > MAX_QT || ct <= 0 || ct > C ||
      (ct < C && ct % 4 != 0) || chunks <= 0 || groups != cdiv(nchunk, chunks) ||
      groups > MAX_CLUSTER || stages <= 0 || stages > chunks)
    return (int)cudaErrorInvalidValue;
  const Layout L(E, H, qt, ct, stages);
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  AxArgs a;
  a.ids = static_cast<const int32_t*>(ids);
  a.emb_m = static_cast<const float*>(emb_m);
  a.emb_k = static_cast<const float*>(emb_k);
  a.emb_n = static_cast<const float*>(emb_n);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<float*>(out);
  a.rows_m = rows_m;
  a.rows_k = rows_k;
  a.rows_n = rows_n;
  a.E = E;
  a.H = H;
  a.C = C;
  a.B = B;
  a.qt = qt;
  a.ct = ct;
  a.groups = groups;
  a.chunks = chunks;
  a.stages = stages;
  const dim3 grid((unsigned)(groups * cdiv(B, qt)), (unsigned)cdiv(C, ct));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = groups > 1 ? launch<ROUTE_CLUSTER>(a, grid, smem, st)
                             : launch<ROUTE_NONE>(a, grid, smem, st);
  return (int)e;
}
