// RSA GEMM, WS and IS modes, for Hopper (sm_90a): C (M, N) = A (M, K) @
// B (K, N) with the per-chunk rounding of the reference's _kernel_psum.
//
// Replaces kernels/rsa_gemm.py::rsa_gemm_pallas in its WS and IS modes
// (the _kernel_psum body of the two psum pallas_call sites).  The OS mode
// stays in rsa_gemm.cu.
//
// The function.  For every output tile, each block_k chunk of K, in
// ascending order, is multiplied in f32, cast to the output type T and
// added to the tile in T: run = T(run + T(chunk)).  WS and IS compute the
// same function; on the TPU they differ only in which operand's block stays
// in VMEM while the grid sweeps the other.  Here one CTA owns an output
// tile, keeps the chunk's f32 accumulator in registers and the running T
// sum on chip (in shared memory) and writes C once, so one kernel serves
// both modes and their outputs are bitwise equal.  The mode only orders the walk over tiles:
// WS walks M inside an N panel (consecutive CTAs share the panel of B, the
// weight, in L2), IS walks N inside an M panel.  In f32 output T is the
// identity, and the accumulator simply runs over the whole K.
//
// What bounds it on the H100, and what the design does about it:
//   * bf16 operands at prefill and training widths are bound by the tensor
//     cores: they run on wgmma (m64nNk16, f32 accumulation), fed by TMA
//     through an mbarrier ring of 4-8 stages of 64 k (one 128-byte swizzle
//     row), one producer warp and two consumer warpgroups.  A transposed
//     operand (A^T of the weight gradient, B^T of the tied unembedding) is
//     copied by TMA as it lies and read by wgmma through its MN-major bit;
//     an operand TMA cannot describe (base or row stride not 16-byte
//     aligned) is stored into the same swizzled layout by the producer warp
//     with ordinary loads (not cp.async: its smallest copy is 4 bytes, and
//     a bf16 view with an odd row stride is only 2-byte aligned).
//   * bf16 at decode (M = 1 ... 32) is bound by the bytes of the weight.
//     The operands swap roles: the weight tile is wgmma's 64-row side and
//     the M activation rows its n side (8 or 32; 64 for A^T), so the
//     weight is streamed once.  When the tiles fill at most half the card,
//     K is split: each split lies inside one block_k chunk, writes its f32
//     partial to a workspace the wrapper allocates, and the last CTA of
//     the tile to arrive (an atomic ticket, reset by that CTA) sums the
//     partials in a fixed order (the splits of a chunk ascending, then the
//     chunks ascending with the T rounding).  The result is deterministic
//     and one launch per GEMM.  The plan (tile, swap, splits) is
//     kernels/rsa_gemm.py::_psum_plan; it does not depend on the mode.
//   * f32 operands (training, full f32, no TF32) are bound by the CUDA
//     cores: a register-blocked SIMT mainloop, 256 threads each owning an
//     8 x 8 micro-tile of a 128 x 128 (or, for M <= 32, 32 x 512) CTA tile,
//     fed by a 3-stage cp.async ring.  A^T and B^T stay in their memory
//     orientation in shared memory and the loads that read them follow.
//
// Banks: blockIdx.z is the bank; each operand steps by its own bank stride,
// so a strided view (the MLA head banks of W_UK / W_UV) is read in place.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 64;                 // k of one pipeline stage (bf16)
constexpr int BP = 128;                // P rows of a CTA: 2 warpgroups x 64
constexpr int NCONS = 256;             // consumer threads
constexpr int NTHREADS = NCONS + 32;   // and one producer warp
constexpr int P_BYTES = BP * KS * 2;   // one stage of the P operand
constexpr int PANEL = 64 * KS * 2;     // one 64-row (or 64-column) panel

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Stages of the bf16 ring: 192 KB for the 64- and 128-wide tiles (one CTA
// an SM by registers anyway), 4 for the skinny ones (68-80 KB, so two or
// three CTAs share an SM and overlap their start-up and fix-up).
__host__ __device__ constexpr int wgmma_stages(int bq) { return bq == 128 ? 6 : bq == 64 ? 8 : 4; }

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int NR> __device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void consumer_sync() {  // the 256 consumer threads
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile.  K-major
// (rows of 64 k): 8-row groups 1024 bytes apart (SBO), LBO unused (16).
// MN-major (rows of 64 m or n, one per k): 8-k groups 1024 bytes apart
// (SBO), 64-wide panels `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BQ> struct Mma;
template <> struct Mma<8> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[4], uint64_t a, uint64_t b) {
    wgmma_n8<TA, TB>(d, a, b);
  }
};
template <> struct Mma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    wgmma_n32<TA, TB>(d, a, b);
  }
};
template <> struct Mma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    wgmma_n64<TA, TB>(d, a, b);
  }
};
template <> struct Mma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    wgmma_n128<TA, TB>(d, a, b);
  }
};

// ------------------------------------------------------- bf16 (wgmma) --

// One wgmma operand: `rows` x K, K-major (row r, k at ptr[r * ld + k]) or
// MN-major (ptr[k * ld + r]), bank e at ptr + e * sbank; tma = 1 when its
// tensor map is valid.
struct Operand {
  const bf16* ptr;
  long long ld, sbank;
  int rows, kmajor, tma;
};

struct Params {
  Operand P, Q;        // wgmma's A (64-row side) and B (n side)
  void* C;
  long long sc;        // C's bank stride (elements); C is (M, N) row-major
  int M, N, K, bk;
  int swap;            // P is B's N side and Q is A's M side
  int mode;            // 1 = WS, 2 = IS: the order of the walk only
  int p_tiles, q_tiles;
  int nsplit, pieces, piece;
  float* ws;
  int* tickets;
};

// T(run + T(acc)) on pairs, the first chunk's run being T(acc); acc = 0.
// The running sums live in shared memory (run[pair * NCONS + thread]): in
// registers they would double the accumulator's and crowd the mainloop.
template <int NR>
__device__ __forceinline__ void close_chunk(float (&acc)[NR], __nv_bfloat162* run, int tid,
                                            bool first) {
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    if (first) {
      run[i * NCONS + tid] = v;
    } else {
      const float2 r = __bfloat1622float2(run[i * NCONS + tid]), w = __bfloat1622float2(v);
      run[i * NCONS + tid] = __floats2bfloat162_rn(r.x + w.x, r.y + w.y);
    }
    acc[2 * i] = 0.f;
    acc[2 * i + 1] = 0.f;
  }
}

// The producer warp's copy of a tile TMA cannot load: ordinary loads into
// the same 128-byte-swizzled layout, zero outside rows x [kb, k1).
template <int ROWS>
__device__ void manual_tile(unsigned char* dst, const Operand& X, int r0, int kb, int k1, int e,
                            int lane) {
  const bf16* base = X.ptr + (long long)e * X.sbank;
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = lane; idx < ROWS * KS; idx += 32) {
    int row, col, gr, gk;  // row/col of the swizzled smem rows of 128 bytes
    uint32_t off;
    if (X.kmajor) {
      row = idx / KS;
      col = idx % KS;
      gr = r0 + row;
      gk = kb + col;
      off = 0;
    } else {
      const int panel = idx / (64 * KS), rem = idx % (64 * KS);
      row = rem / 64;
      col = rem % 64;
      gr = r0 + panel * 64 + col;
      gk = kb + row;
      off = panel * PANEL;
    }
    off += row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
    bf16 v = zero;
    if (gr < X.rows && gk < k1)
      v = X.kmajor ? base[(long long)gr * X.ld + gk] : base[(long long)gk * X.ld + gr];
    *reinterpret_cast<bf16*>(dst + off) = v;
  }
}

template <int BQ, typename TO>
__global__ void __launch_bounds__(NTHREADS, 1)
psum_wgmma(const __grid_constant__ CUtensorMap mapP, const __grid_constant__ CUtensorMap mapQ,
           const Params p) {
  constexpr int ST = wgmma_stages(BQ);
  constexpr int Q_BYTES = BQ * KS * 2;
  constexpr int NR = BQ / 2;             // accumulator registers a thread
  constexpr bool OUT_BF16 = sizeof(TO) == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Pt = smem;
  unsigned char* Qt = smem + ST * P_BYTES;
  __nv_bfloat162* run = reinterpret_cast<__nv_bfloat162*>(Qt + ST * Q_BYTES);
  uint64_t* bars =  // full[ST], empty[ST]
      reinterpret_cast<uint64_t*>(Qt + ST * Q_BYTES + (OUT_BF16 ? NR / 2 * NCONS * 4 : 0));
  int* last_flag = reinterpret_cast<int*>(bars + 2 * ST);

  // which tile and which split: the split innermost, then the mode's walk
  const int e = blockIdx.z;
  int lin = blockIdx.x;
  const int s = lin % p.nsplit;
  lin /= p.nsplit;
  const int m_tiles = p.swap ? p.q_tiles : p.p_tiles, n_tiles = p.swap ? p.p_tiles : p.q_tiles;
  int mt, nt;
  if (p.mode == 1) {
    mt = lin % m_tiles;
    nt = lin / m_tiles;
  } else {
    nt = lin % n_tiles;
    mt = lin / n_tiles;
  }
  const int pt = p.swap ? nt : mt, qt = p.swap ? mt : nt;
  const int tile = (e * p.p_tiles + pt) * p.q_tiles + qt;
  const int p0 = pt * BP, q0 = qt * BQ;
  int k0 = 0, k1 = p.K;
  if (p.nsplit > 1) {
    const int c = s / p.pieces, j = s % p.pieces;
    const int cb = c * p.bk, ce = min(p.K, cb + p.bk);
    k0 = min(ce, cb + j * p.piece);
    k1 = min(ce, k0 + p.piece);
  }
  // The unit's k range runs as segments that each lie inside one chunk:
  // the chunks of [0, K) when a bf16 output closes its chunks in this CTA,
  // else the whole range.  Each segment starts a fresh run of stages at its
  // own k (a chunk may start inside a 64-deep stage), so no accumulator
  // write falls between two wgmmas of a segment.
  const bool closes = OUT_BF16 && p.nsplit == 1;
  const int seg = closes ? p.bk : k1 - k0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(smem_u32(&bars[i]), 33);       // lane 0's expect_tx + 32 lanes
      mbar_init(smem_u32(&bars[ST + i]), 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, made provably warp-uniform (a shuffle from lane 0): with a
  // plain threadIdx test ptxas would see the wgmma path as divergent and
  // serialize every wgmma
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == NCONS / 128) {
    // ------------------------------------------------ producer warp --
    const int lane = threadIdx.x - NCONS;
    const uint32_t tx = (p.P.tma ? P_BYTES : 0) + (p.Q.tma ? Q_BYTES : 0);
    int t = 0;
    for (int sb = k0; sb < k1; sb += seg) {
      const int se = min(k1, sb + seg);
      for (int kb = sb; kb < se; kb += KS, ++t) {
        const int st = t % ST;
        mbar_wait(smem_u32(&bars[ST + st]), ((t / ST) & 1) ^ 1);
        const uint32_t full = smem_u32(&bars[st]);
        unsigned char* pd = Pt + st * P_BYTES;
        unsigned char* qd = Qt + st * Q_BYTES;
        if (lane == 0) {
          mbar_arrive_tx(full, tx);
          if (p.P.tma) {
            if (p.P.kmajor) {
              tma_load_3d(smem_u32(pd), &mapP, full, kb, p0, e);
            } else {
              tma_load_3d(smem_u32(pd), &mapP, full, p0, kb, e);
              tma_load_3d(smem_u32(pd + PANEL), &mapP, full, p0 + 64, kb, e);
            }
          }
          if (p.Q.tma) {
            if (p.Q.kmajor) {
              tma_load_3d(smem_u32(qd), &mapQ, full, kb, q0, e);
            } else {
#pragma unroll
              for (int j = 0; j < BQ / 64; ++j)
                tma_load_3d(smem_u32(qd + j * PANEL), &mapQ, full, q0 + 64 * j, kb, e);
            }
          }
        }
        if (!p.P.tma) manual_tile<BP>(pd, p.P, p0, kb, se, e, lane);
        if (!p.Q.tma) manual_tile<BQ>(qd, p.Q, q0, kb, se, e, lane);
        if (!p.P.tma || !p.Q.tma) fence_proxy_async();
        mbar_arrive(full);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups --
  const int wg = role;
  const int tid = threadIdx.x;
  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  bool first = true;
  const int ta = p.P.kmajor ? 0 : 1, tb = p.Q.kmajor ? 0 : 1;
  const uint32_t p_step = p.P.kmajor ? 32 : 16 * 128, q_step = p.Q.kmajor ? 32 : 16 * 128;
  const uint32_t p_lbo = p.P.kmajor ? 16 : PANEL, q_lbo = p.Q.kmajor ? 16 : PANEL;
  int t = 0;
  for (int sb = k0; sb < k1; sb += seg) {
    const int se = min(k1, sb + seg);
    int held = -1;  // the stage whose wgmma group may still be reading it
    for (int kb = sb; kb < se; kb += KS, ++t) {
      const int st = t % ST;
      mbar_wait(smem_u32(&bars[st]), (t / ST) & 1);
      const uint32_t pa = smem_u32(Pt + st * P_BYTES) + wg * PANEL;
      const uint32_t qa = smem_u32(Qt + st * Q_BYTES);
      const int steps = min(KS, se - kb + 15) / 16;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KS / 16; ++j) {
        if (j >= steps) break;
        const uint64_t da = gmma_desc(pa + j * p_step, p_lbo);
        const uint64_t db = gmma_desc(qa + j * q_step, q_lbo);
        if (ta == 0 && tb == 0)
          Mma<BQ>::template run<0, 0>(acc, da, db);
        else if (ta == 0)
          Mma<BQ>::template run<0, 1>(acc, da, db);
        else if (tb == 0)
          Mma<BQ>::template run<1, 0>(acc, da, db);
        else
          Mma<BQ>::template run<1, 1>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (held >= 0 && threadIdx.x % 128 == 0) mbar_arrive(smem_u32(&bars[ST + held]));
      held = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (held >= 0 && threadIdx.x % 128 == 0) mbar_arrive(smem_u32(&bars[ST + held]));
    if (closes && se < k1) {   // a chunk ends: run = T(run + T(acc)), acc = 0
      close_chunk<NR>(acc, run, tid, first);
      first = false;
      fence_regs(acc);
    }
  }

  if (p.nsplit > 1) {
    // this split's f32 partial, then the ticket; the last CTA of the tile
    // sums every split's partial in the fixed order
    const size_t unit = (size_t)NR * NCONS;
    float* w = p.ws + ((size_t)tile * p.nsplit + s) * unit;
#pragma unroll
    for (int i = 0; i < NR; ++i) __stcg(&w[i * NCONS + tid], acc[i]);
    __threadfence();
    consumer_sync();
    if (tid == 0) *last_flag = atomicAdd(&p.tickets[tile], 1) == p.nsplit - 1;
    consumer_sync();
    if (!*last_flag) return;
    __threadfence();
    const float* base = p.ws + (size_t)tile * p.nsplit * unit;
    // the splits in ascending order (a chunk's pieces, then the next
    // chunk), U partials loaded at once so their latencies overlap
    constexpr int U = NR >= 64 ? 1 : 64 / NR;
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.f;
    for (int s0 = 0; s0 < p.nsplit; s0 += U) {
      float v[U][NR];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* src = base + (size_t)min(s0 + u, p.nsplit - 1) * unit;
#pragma unroll
        for (int i = 0; i < NR; ++i) v[u][i] = __ldcg(&src[i * NCONS + tid]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u < p.nsplit) {
#pragma unroll
          for (int i = 0; i < NR; ++i) acc[i] += v[u][i];
          if (OUT_BF16 && (s0 + u) % p.pieces == p.pieces - 1) {  // a chunk ends
            close_chunk<NR>(acc, run, tid, first);
            first = false;
          }
        }
      }
    }
    if (tid == 0) p.tickets[tile] = 0;
  } else if (OUT_BF16) {
    close_chunk<NR>(acc, run, tid, first);
  }

  // write C once, from registers (the m64nBQ accumulator layout: pairs of
  // neighbouring columns, stored together where the row allows)
  TO* C = static_cast<TO*>(p.C) + (long long)e * p.sc;
  const int w4 = (tid % 128) / 32, lane = tid % 32;
  const bool pairs = !p.swap && p.N % 2 == 0;
#pragma unroll
  for (int i = 0; i < NR; i += 2) {
    const int row = wg * 64 + w4 * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = (i >> 2) * 8 + (lane & 3) * 2;
    const int pp = p0 + row, qq = q0 + col;
    TO v[2];
    __nv_bfloat162 r2;
    if constexpr (OUT_BF16) {
      r2 = run[(i >> 1) * NCONS + tid];
      v[0] = r2.x;
      v[1] = r2.y;
    } else {
      v[0] = acc[i];
      v[1] = acc[i + 1];
    }
    if (pairs) {
      if (pp < p.M && qq < p.N) {   // qq even and N even: qq + 1 < N
        TO* o = C + (long long)pp * p.N + qq;
        if constexpr (OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(o) = r2;
        else
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int m = p.swap ? qq + u : pp, n = p.swap ? pp : qq + u;
        if (m < p.M && n < p.N) C[(long long)m * p.N + n] = v[u];
      }
    }
  }
}

// -------------------------------------------------------- f32 (SIMT) --

constexpr int FST = 3;     // stages
// k of one stage (FK below): 32 for the 128 x 128 tile (fewer barriers a
// FLOP), 16 for the 32 x 512 one (whose B^T stage would not fit 3 times)
constexpr int FT = 256;    // threads

struct Params32 {
  const float* A;
  long long lda, sa;
  const float* B;
  long long ldb, sb;
  float* C;
  long long sc;
  int M, N, K, bk;
  int mode, m_tiles, n_tiles;
  int nsplit, pieces, piece;
  int vec_a, vec_b;
  float* ws;
  int* tickets;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x COLS of a matrix whose COLS run contiguously in memory (element
// (r, c) at g[r * ld + c]), starting at (r0, c0), into shared s (leading
// dim LDS), zero outside [0, rlim) x [0, clim).
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_f32(float* s, const float* g, long long ld, int r0, int c0,
                                         int rlim, int clim, bool vec) {
  constexpr int V = COLS / 4;
#pragma unroll
  for (int v = threadIdx.x; v < ROWS * V; v += FT) {
    const int r = v / V, c = (v % V) * 4;
    const int gr = r0 + r, gc = c0 + c;
    float* d = s + r * LDS + c;
    const bool row_ok = gr < rlim;
    if (vec && (!row_ok || gc >= clim)) {
      cp_async16(d, g, 0);
    } else if (vec && gc + 4 <= clim) {
      cp_async16(d, g + (long long)gr * ld + gc, 16);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = row_ok && gc + u < clim;
        cp_async4(d + u, ok ? g + (long long)gr * ld + gc + u : g, ok ? 4 : 0);
      }
    }
  }
}

template <int BM, bool AT, bool BT>
__global__ void __launch_bounds__(FT, 1) psum_f32(const Params32 p) {
  constexpr int BN = 16384 / BM, TX = BN / 8;
  constexpr int FK = BM == 128 ? 32 : 16;
  // A: [m][FK] (row-major A) or [k][BM] (A^T); B: [k][BN] or [n][FK] (B^T)
  constexpr int A_LD = AT ? BM + 4 : FK + 4, B_LD = BT ? FK + 4 : BN + 4;
  constexpr int A_SZ = AT ? FK * A_LD : BM * A_LD, B_SZ = BT ? BN * B_LD : FK * B_LD;
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;
  float* Bs = fsm + FST * A_SZ;
  __shared__ int last_flag;

  const int e = blockIdx.z;
  int lin = blockIdx.x;
  const int s = lin % p.nsplit;
  lin /= p.nsplit;
  int mt, nt;
  if (p.mode == 1) {
    mt = lin % p.m_tiles;
    nt = lin / p.m_tiles;
  } else {
    nt = lin % p.n_tiles;
    mt = lin / p.n_tiles;
  }
  const int tile = (e * p.m_tiles + mt) * p.n_tiles + nt;
  const int m0 = mt * BM, n0 = nt * BN;
  int k0 = 0, k1 = p.K;
  if (p.nsplit > 1) {
    const int c = s / p.pieces, j = s % p.pieces;
    const int cb = c * p.bk, ce = min(p.K, cb + p.bk);
    k0 = min(ce, cb + j * p.piece);
    k1 = min(ce, k0 + p.piece);
  }
  const int nst = (k1 - k0 + FK - 1) / FK;
  const float* A = p.A + (long long)e * p.sa;
  const float* B = p.B + (long long)e * p.sb;

  auto load_stage = [&](int t) {
    const int st = t % FST, kb = k0 + t * FK;
    if (AT)
      load_f32<FK, BM, A_LD>(As + st * A_SZ, A, p.lda, kb, m0, k1, p.M, p.vec_a);
    else
      load_f32<BM, FK, A_LD>(As + st * A_SZ, A, p.lda, m0, kb, p.M, k1, p.vec_a);
    if (BT)
      load_f32<BN, FK, B_LD>(Bs + st * B_SZ, B, p.ldb, n0, kb, p.N, k1, p.vec_b);
    else
      load_f32<FK, BN, B_LD>(Bs + st * B_SZ, B, p.ldb, kb, n0, k1, p.N, p.vec_b);
  };

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  // rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}; columns likewise, or
  // tx + TX*j for B^T (conflict-free reads of its [n][k] rows)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < FST - 1; ++t) {
    if (t < nst) load_stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<FST - 2>();
    __syncthreads();
    if (t + FST - 1 < nst) load_stage(t + FST - 1);
    cp_async_commit();
    const float* as = As + (t % FST) * A_SZ;
    const float* bs = Bs + (t % FST) * B_SZ;
#pragma unroll
    for (int kq = 0; kq < FK / 4; ++kq) {
      float a[8][4], b[4][8];
      if (AT) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(as + (kq * 4 + kk) * A_LD + ty * 4);
          const float4 y =
              *reinterpret_cast<const float4*>(as + (kq * 4 + kk) * A_LD + BM / 2 + ty * 4);
          a[0][kk] = x.x; a[1][kk] = x.y; a[2][kk] = x.z; a[3][kk] = x.w;
          a[4][kk] = y.x; a[5][kk] = y.y; a[6][kk] = y.z; a[7][kk] = y.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
          const float4 x = *reinterpret_cast<const float4*>(as + r * A_LD + kq * 4);
          a[i][0] = x.x; a[i][1] = x.y; a[i][2] = x.z; a[i][3] = x.w;
        }
      }
      if (BT) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(bs + (tx + TX * j) * B_LD + kq * 4);
          b[0][j] = x.x; b[1][j] = x.y; b[2][j] = x.z; b[3][j] = x.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(bs + (kq * 4 + kk) * B_LD + tx * 4);
          const float4 y =
              *reinterpret_cast<const float4*>(bs + (kq * 4 + kk) * B_LD + BN / 2 + tx * 4);
          b[kk][0] = x.x; b[kk][1] = x.y; b[kk][2] = x.z; b[kk][3] = x.w;
          b[kk][4] = y.x; b[kk][5] = y.y; b[kk][6] = y.z; b[kk][7] = y.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const int tid = threadIdx.x;
  if (p.nsplit > 1) {
    const size_t unit = (size_t)64 * FT;
    float* w = p.ws + ((size_t)tile * p.nsplit + s) * unit;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) __stcg(&w[(i * 8 + j) * FT + tid], acc[i][j]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last_flag = atomicAdd(&p.tickets[tile], 1) == p.nsplit - 1;
    __syncthreads();
    if (!last_flag) return;
    __threadfence();
    const float* base = p.ws + (size_t)tile * p.nsplit * unit;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int q = 0; q < p.nsplit; ++q) {   // chunks ascending, each in its splits' order
      const float* src = base + (size_t)q * unit;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += __ldcg(&src[(i * 8 + j) * FT + tid]);
    }
    if (tid == 0) p.tickets[tile] = 0;
  }

  float* C = p.C + (long long)e * p.sc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (BT ? tx + TX * j : (j < 4 ? 0 : BN / 2) + tx * 4 + (j & 3));
      if (n < p.N) C[(long long)m * p.N + n] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------- host --

// Tensor maps are built once per (pointer, layout) and kept: a model step
// launches the same weights again and again.
using MapKey = std::tuple<uintptr_t, int, long long, long long, long long, long long, int, int>;
std::mutex map_mu;
std::map<MapKey, CUtensorMap> map_cache;

// The 3-D tensor map (inner, outer, bank) of one bf16 operand, or false
// where TMA cannot describe it.  K-major: inner K, outer the rows, box
// 64 x box_rows; MN-major: inner the rows, outer K, box 64 x 64.
bool tensor_map(CUtensorMap* out, const Operand& X, int K, int E, int box_rows) {
  const uintptr_t ptr = reinterpret_cast<uintptr_t>(X.ptr);
  const long long outer = X.kmajor ? X.rows : K;
  const long long bank_bytes = E > 1 ? X.sbank * 2 : X.ld * 2 * outer;
  if (ptr % 16 || (X.ld * 2) % 16 || bank_bytes % 16 || bank_bytes <= 0) return false;
  const MapKey key{ptr, X.kmajor, (long long)X.rows, (long long)K, X.ld, bank_bytes, E, box_rows};
  std::lock_guard<std::mutex> lock(map_mu);
  auto it = map_cache.find(key);
  if (it != map_cache.end()) {
    *out = it->second;
    return true;
  }
  cuuint64_t dims[3] = {(cuuint64_t)(X.kmajor ? K : X.rows), (cuuint64_t)outer, (cuuint64_t)E};
  cuuint64_t strides[2] = {(cuuint64_t)(X.ld * 2), (cuuint64_t)bank_bytes};
  cuuint32_t box[3] = {64, (cuuint32_t)(X.kmajor ? box_rows : 64), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUtensorMap map;
  const CUresult r = cuTensorMapEncodeTiled(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(X.ptr), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  if (map_cache.size() > 4096) map_cache.clear();
  map_cache.emplace(key, map);
  *out = map;
  return true;
}

template <int BQ, typename TO>
int launch_wgmma(Params p, int E, cudaStream_t stream) {
  constexpr int ST = wgmma_stages(BQ);
  const size_t smem = 1024 + (size_t)ST * (P_BYTES + BQ * KS * 2) +
                      (sizeof(TO) == 2 ? (size_t)BQ / 4 * NCONS * 4 : 0) + 2 * ST * 8 + 16;
  cudaError_t err = cudaFuncSetAttribute(psum_wgmma<BQ, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mp, mq;
  std::memset(&mp, 0, sizeof(mp));
  std::memset(&mq, 0, sizeof(mq));
  p.P.tma = tensor_map(&mp, p.P, p.K, E, BP);
  p.Q.tma = tensor_map(&mq, p.Q, p.K, E, BQ);
  dim3 grid((unsigned)((long long)p.p_tiles * p.q_tiles * p.nsplit), 1, E);
  psum_wgmma<BQ, TO><<<grid, NTHREADS, smem, stream>>>(mp, mq, p);
  return (int)cudaGetLastError();
}

template <int BM, bool AT, bool BT>
int launch_f32(const Params32& p, int E, cudaStream_t stream) {
  constexpr int BN = 16384 / BM;
  constexpr int FK = BM == 128 ? 32 : 16;
  constexpr int A_SZ = AT ? FK * (BM + 4) : BM * (FK + 4);
  constexpr int B_SZ = BT ? BN * (FK + 4) : FK * (BN + 4);
  const size_t smem = (size_t)FST * (A_SZ + B_SZ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(psum_f32<BM, AT, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((long long)p.m_tiles * p.n_tiles * p.nsplit), 1, E);
  psum_f32<BM, AT, BT><<<grid, FT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_f32_t(int a_trans, int b_trans, const Params32& p, int E, cudaStream_t st) {
  if (a_trans && b_trans) return launch_f32<BM, true, true>(p, E, st);
  if (a_trans) return launch_f32<BM, true, false>(p, E, st);
  if (b_trans) return launch_f32<BM, false, true>(p, E, st);
  return launch_f32<BM, false, false>(p, E, st);
}

}  // namespace

// WS (mode 1) and IS (mode 2) RSA GEMM, one launch.  dtype codes: 0 =
// float32, 1 = bfloat16 (in -> out: f32 -> f32, bf16 -> bf16, bf16 -> f32).
// A is row-major (M, K) with row stride lda, or (a_trans) the transpose of
// a row-major (K, M) matrix; B is row-major (K, N) with row stride ldb, or
// (b_trans) the transpose of a row-major (N, K) matrix.  C is contiguous
// (M, N) per bank.  E banks at A + e * sa, B + e * sb, C + e * sc (element
// strides).  The plan (kernels/rsa_gemm.py::_psum_plan): `tile` is the n
// side of the bf16 tile (8, 32, 64 or 128) or the f32 tile's rows (32 or 128);
// `swap` puts B's N on wgmma's 64-row side (bf16 only); nsplit = 1, or
// ceil(K / bk) * pieces splits of `piece` k each inside every chunk, with
// `ws` holding nsplit f32 partial tiles per output tile and `tickets` one
// zeroed int per output tile.  Returns the cudaError_t (0 on success).
extern "C" int rsa_psum_launch(int mode, int in_dtype, int out_dtype, int a_trans, int b_trans,
                               const void* A, long long lda, long long sa, const void* B,
                               long long ldb, long long sb, void* C, long long sc, int E, int M,
                               int N, int K, int bk, int tile, int swap, int nsplit, int pieces,
                               int piece, void* ws, void* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((mode != 1 && mode != 2) || bk <= 0 || bk % 32 || E < 1 || E > 65535 || M < 1 || N < 1 ||
      K < 1 || nsplit < 1 || pieces < 1)
    return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (nsplit != cdiv(K, bk) * pieces || piece % 64 || !ws || !tickets))
    return (int)cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0) {
    if (tile != 32 && tile != 128) return (int)cudaErrorInvalidValue;
    Params32 p;
    p.A = static_cast<const float*>(A);
    p.lda = lda;
    p.sa = sa;
    p.B = static_cast<const float*>(B);
    p.ldb = ldb;
    p.sb = sb;
    p.C = static_cast<float*>(C);
    p.sc = sc;
    p.M = M;
    p.N = N;
    p.K = K;
    p.bk = bk;
    p.mode = mode;
    p.m_tiles = cdiv(M, tile);
    p.n_tiles = cdiv(N, 16384 / tile);
    p.nsplit = nsplit;
    p.pieces = pieces;
    p.piece = piece;
    p.vec_a = (reinterpret_cast<uintptr_t>(A) % 16 == 0) && lda % 4 == 0 && sa % 4 == 0;
    p.vec_b = (reinterpret_cast<uintptr_t>(B) % 16 == 0) && ldb % 4 == 0 && sb % 4 == 0;
    p.ws = static_cast<float*>(ws);
    p.tickets = static_cast<int*>(tickets);
    return tile == 32 ? launch_f32_t<32>(a_trans, b_trans, p, E, st)
                      : launch_f32_t<128>(a_trans, b_trans, p, E, st);
  }
  if (in_dtype != 1 || (out_dtype != 0 && out_dtype != 1)) return (int)cudaErrorInvalidValue;
  if (tile != 8 && tile != 32 && tile != 64 && tile != 128) return (int)cudaErrorInvalidValue;
  // A as an operand of M rows: K-major unless transposed; B as one of N
  // rows: K-major only when given as the transpose of a row-major (N, K)
  Operand a{static_cast<const bf16*>(A), lda, sa, M, a_trans ? 0 : 1, 0};
  Operand b{static_cast<const bf16*>(B), ldb, sb, N, b_trans ? 1 : 0, 0};
  Params p;
  p.P = swap ? b : a;
  p.Q = swap ? a : b;
  if (!p.Q.kmajor && tile % 64) return (int)cudaErrorInvalidValue;
  p.C = C;
  p.sc = sc;
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.swap = swap;
  p.mode = mode;
  p.p_tiles = cdiv(p.P.rows, BP);
  p.q_tiles = cdiv(p.Q.rows, tile);
  p.nsplit = nsplit;
  p.pieces = pieces;
  p.piece = piece;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  if (out_dtype == 1) {
    if (tile == 8) return launch_wgmma<8, bf16>(p, E, st);
    if (tile == 32) return launch_wgmma<32, bf16>(p, E, st);
    if (tile == 64) return launch_wgmma<64, bf16>(p, E, st);
    return launch_wgmma<128, bf16>(p, E, st);
  }
  if (tile == 8) return launch_wgmma<8, float>(p, E, st);
  if (tile == 32) return launch_wgmma<32, float>(p, E, st);
  if (tile == 64) return launch_wgmma<64, float>(p, E, st);
  return launch_wgmma<128, float>(p, E, st);
}
