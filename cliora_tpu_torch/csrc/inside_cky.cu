// Fused DIORA inside pass + CKY decode for Hopper (sm_90a).
//
// Replaces the TPU kernel cliora_tpu/ops/pallas_chart.py:_kernel (launched
// by fused_inside_cky_pallas).  For every chart level, for every
// (target cell, split) row, with left child l and right child r:
//
//   h1  = relu(W0[:, :D] l + W0[:, D:] r + b0)       fc0
//   hk  = relu(W1 h1 + b1)                           fc1
//   s_k = (l M) . r + s_l + s_r                      bilinear split score
//
// then per target cell: softmax over the splits, h = sum_k p_k hk, unit
// norm, inside_s = sum_k p_k s_k, and the CKY value
// max_k(v_l + v_r + s_k) - max_k s_k with the first-max backpointer
// (strict >; leaves have value 1, score 0, backpointer 0).
//
// What bounds it: operations.  Its compulsory traffic is ~7 MB at B=128,
// n=20, D=400 (leaves, weights, outputs), and it does ~8e10 FLOP there
// (below), far above the card's operations-per-byte balance point.
//
// Design.
//  * Less work than the TPU kernel.  W0[:, :D] l, W0[:, D:] r and l M are
//    linear in one child each, so they are computed once per chart cell
//    (a projection P[cell] = [W0[:, :D] h, W0[:, D:] h, h M], right after
//    the cell's level is written) instead of once per (cell, split) row.
//    Only fc1 stays per row.  That is 6 D^2 FLOP per cell + 2 D^2 per row,
//    8.0e10 FLOP per call at B=128, n=20, D=400, against 8 D^2 per row,
//    2.18e11, for the TPU kernel's formulation.  The sums keep the TPU
//    kernel's grouping: relu((P_l + P_r) + b0), and l M in f32.
//  * The TPU kernel kept one block of sentences' whole chart in VMEM; one
//    sentence's chart at n=20, D=400 does not fit the 227 KB of shared
//    memory a Hopper block has, so this version launches per level and
//    keeps the chart in device memory (the B=128 chart is 43 MB in f32,
//    21.5 MB in bf16, about the 50 MB L2).  Per call: weight prep,
//    leaves and the leaves' projection, then per level (fc0,) fc1, combine
//    and (below the root) project.
//  * f32 (the contract: no TF32, each output sums its k in order on FMA,
//    backpointers equal the plain version's): project and fc1 run on the
//    CUDA cores in simt_gemm -- 128 x 80 block tiles (80 divides D = 400
//    and 3D = 1200: no padded columns), 8 x 4 outputs a thread, 320
//    threads at 96 registers (20 warps an SM; 8 x 8 outputs a thread left
//    10 and ran slower), a 2-stage ring of 16-deep shared-memory tiles
//    filled by 16-byte cp.async (the next stage lands while one
//    multiplies; 3 or 4 stages ran fc1 slower), one barrier a stage.
//    What holds them is the FMA issue rate inside a wave and the wave
//    tails of small levels, not the loads: no loader variant ran project
//    faster than the register-staged single buffer it replaced (PERF.md,
//    PR 6).  fc0 forms h1 = relu((P_l + P_r) + b0) in its own elementwise
//    pass (a GEMM loader that built it on the fly held too many loads in
//    flight per thread and ran fc1 at half the speed).  4n - 2 launches a
//    call.
//  * bf16 (the TPU kernel's rounding: h1 and hk rounded to bf16, products
//    of bf16 values summed in f32, l M in f32): project and fc1 run on
//    the tensor cores in wg_gemm -- wgmma m64n200k16 with the A operand
//    in registers and B (the bf16 k-major weights) brought by TMA into a
//    4-stage ring, a block of 128 rows (two consumer warpgroups) x 200
//    columns, a producer warpgroup staging the A rows with cp.async.  fc1
//    builds h1 = bf16(relu((P_l + P_r) + b0)) in the consumers' registers
//    from the children's f32 projection rows, so the fc0 pass and the h1
//    buffer are gone; what bounds it is the L2 traffic of those rows
//    (8 D bytes a row and column tile), not its 2 D^2 FLOP a row.  3n - 1
//    launches a call.
//  * combine runs one block per target cell, with 16-byte (f32) or 8-byte
//    (bf16) loads of l M, r and hk.  Every reduction runs in a fixed order
//    (no atomics), so results repeat bit for bit.
//
// Plain C interface, loaded with ctypes (ops/inside_cky.py).  The caller
// allocates every buffer; kernels run on the caller's stream; each launch
// is checked and the first error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int CT = 128;           // threads per combine block (power of two)
constexpr int kSmemBlock = 232448;  // a block's shared memory

__host__ __device__ inline long long level_offset(int n, int level) {
  const long long rem = n - level;
  return (long long)n * (n + 1) / 2 - rem * (rem + 1) / 2;
}

__device__ inline float load_f(const float* p) { return *p; }
__device__ inline float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ inline T store_t(float x);
template <> __device__ inline float store_t<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 store_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------ f32 SIMT GEMM --

constexpr int FBM = 128;   // rows per tile
constexpr int FBN = 80;    // columns per tile: 400 = 5 x 80, 1200 = 15 x 80
constexpr int FBK = 16;    // k per stage
constexpr int FSTAGES = 2;
constexpr int FTM = 8;     // rows per thread: ty + 16 i
constexpr int FTN = 4;     // columns per thread: 4 tx .. 4 tx + 3
constexpr int FTX = FBN / FTN, FTY = FBM / FTM;
constexpr int FNT = FTX * FTY;                  // 320 threads
constexpr int FAS = FBK + 4;                    // A row stride (floats)
constexpr int FA_FLOATS = FBM * FAS;
constexpr int FSTAGE_FLOATS = FA_FLOATS + FBK * FBN;
constexpr int kSmemSimt = FSTAGES * FSTAGE_FLOATS * 4;
constexpr int FA_COPIES = FBM * FBK / 4;        // 16-byte copies a stage
constexpr int FW_COPIES = FBK * FBN / 4;
static_assert(FNT % 32 == 0 && FBN % FTN == 0 && FBM % FTM == 0, "thread tile");

// One stage's copies: A rows along k (src_a(r, k): 4 floats, or nullptr
// for zeros), W rows along columns (src_w(k, c)).  Every copy 16 bytes, a
// warp's copies contiguous.
template <typename SrcA, typename SrcW>
__device__ __forceinline__ void simt_stage(float* st, int k0, const SrcA& src_a,
                                           const SrcW& src_w,
                                           const float* any) {
  for (int i = threadIdx.x; i < FA_COPIES + FW_COPIES; i += FNT) {
    const float* p;
    float* dst;
    if (i < FA_COPIES) {
      const int r = i / (FBK / 4), kq = (i % (FBK / 4)) * 4;
      p = src_a(r, k0 + kq);
      dst = st + r * FAS + kq;
    } else {
      const int j = i - FA_COPIES;
      const int k = j / (FBN / 4), c = (j % (FBN / 4)) * 4;
      p = src_w(k0 + k, c);
      dst = st + FA_FLOATS + k * FBN + c;
    }
    sm90::cp_async16(dst, p ? p : any, p ? 16 : 0);
  }
}

// 4 k (kc..kc+3) of this thread's outputs
__device__ __forceinline__ void simt_k4(const float* As, const float* Ws,
                                        int kc, int tx, int ty,
                                        float (&acc)[FTM][FTN]) {
  float w[4][FTN];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(&Ws[(kc + q) * FBN + 4 * tx]);
    w[q][0] = v.x;
    w[q][1] = v.y;
    w[q][2] = v.z;
    w[q][3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    const float4 v =
        *reinterpret_cast<const float4*>(&As[(ty + FTY * i) * FAS + kc]);
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < FTN; ++j) acc[i][j] = fmaf(a[q], w[q][j], acc[i][j]);
  }
}

// acc = A[FBM rows, K] . W[K, FBN cols] for this thread's outputs, fp32
// FMAs, each output's k in order.  A sits in shared memory row-major (a
// warp's rows ty + FTY i fall on distinct banks), W k-major.  Stages t + 1
// .. t + FSTAGES - 1 are in flight while stage t multiplies.  K is a
// multiple of 4.
template <typename SrcA, typename SrcW>
__device__ __forceinline__ void simt_gemm(int K, const SrcA& src_a,
                                          const SrcW& src_w, const float* any,
                                          float* smem, float (&acc)[FTM][FTN]) {
  const int tx = threadIdx.x % FTX, ty = threadIdx.x / FTX;
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;
  const int KT = (K + FBK - 1) / FBK;
#pragma unroll
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < KT) simt_stage(smem + s * FSTAGE_FLOATS, s * FBK, src_a, src_w, any);
    sm90::cp_async_commit();
  }
  for (int t = 0; t < KT; ++t) {
    sm90::cp_async_wait<FSTAGES - 2>();  // stage t has landed (this thread's)
    __syncthreads();                     // everyone's; stage t - 1 is free
    const int tn = t + FSTAGES - 1;
    if (tn < KT)
      simt_stage(smem + (tn % FSTAGES) * FSTAGE_FLOATS, tn * FBK, src_a, src_w,
                 any);
    sm90::cp_async_commit();
    const float* As = smem + (t % FSTAGES) * FSTAGE_FLOATS;
    const float* Ws = As + FA_FLOATS;
    const int kn = K - t * FBK;  // k of this stage inside K
    if (kn >= FBK) {
#pragma unroll
      for (int kc = 0; kc < FBK; kc += 4) simt_k4(As, Ws, kc, tx, ty, acc);
    } else {
      for (int kc = 0; kc < kn; kc += 4) simt_k4(As, Ws, kc, tx, ty, acc);
    }
  }
  sm90::cp_async_wait<0>();
}

// out(row, 4 columns from col) for this thread's outputs: row = ty + FTY
// i, col = 4 tx of the tile.
template <typename Out>
__device__ __forceinline__ void simt_epilogue(const float (&acc)[FTM][FTN],
                                              const Out& out) {
  const int tx = threadIdx.x % FTX, ty = threadIdx.x / FTX;
#pragma unroll
  for (int i = 0; i < FTM; ++i)
    out(ty + FTY * i, 4 * tx,
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

// --------------------------------------------------- bf16 wgmma GEMM --

constexpr int WROWS = 128;        // rows a block: two consumer warpgroups
constexpr int WBN = 200;          // columns a block (wgmma n)
constexpr int WBK = 32;           // k a stage
constexpr int WSTAGES = 4;
constexpr int WCHUNKS = 4;        // 64-wide B boxes covering WBN
constexpr int WCHUNK_BYTES = WBK * 128;
constexpr int WB_BYTES = WCHUNKS * WCHUNK_BYTES;
constexpr int WCONSUMERS = 256;
constexpr int WTHREADS = WCONSUMERS + 128;  // + a producer warpgroup
constexpr int WAS = WBK + 8;      // A row stride (elements): conflict-free
                                  // fragment reads

enum Mode { kFc1, kProject };
// fc1 stages the children's f32 projection slices P_l, P_r; project the
// level's bf16 chart rows.
template <Mode M>
constexpr int kABytes = M == kFc1 ? 2 * WROWS * WAS * 4 : WROWS * WAS * 2;
template <Mode M>
constexpr int kStageBytes = WB_BYTES + kABytes<M>;
template <Mode M>
constexpr int kSmemWg = WSTAGES * kStageBytes<M> + 2 * WSTAGES * 8 + 1024;
static_assert(kStageBytes<kFc1> % 1024 == 0 && kStageBytes<kProject> % 1024 == 0,
              "B boxes stay 1024-byte aligned");
static_assert(kSmemWg<kFc1> <= kSmemBlock, "fc1 ring fits a block");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// What a block of wg_gemm works on: rows [row0, row0 + 128) of R, columns
// [col0, col0 + 200) of ncols; the level (fc1: N = level splits a cell).
struct WgArgs {
  int n, D, level, R, ncols;
  long long NC;
};

// Producer thread p (0..127) of the block: fc1 copies 16 bytes (4 f32) of
// k from 8 rows (p / 8 + 16 m) x both children; project 16 bytes (8 bf16)
// from 4 rows (p / 4 + 32 m).  A warp's copies cover whole 128- / 64-byte
// row slices.
template <Mode M>
constexpr int kProdRows = M == kFc1 ? 8 : 4;
template <Mode M>
constexpr int kLanesPerRow = M == kFc1 ? 8 : 4;

// bf16 GEMM of a 128 x 200 block on wgmma: P (fc1) or chart (project) rows
// in, hk or P out.  B = the k-major bf16 weights [k][ncols] by TMA.
template <Mode M>
__device__ __forceinline__ void wg_gemm(const CUtensorMap* bmap,
                                        const void* asrc, const float* bias0,
                                        const float* bias1, void* out,
                                        const WgArgs& g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WSTAGES * kStageBytes<M>);
  uint64_t* empty = full + WSTAGES;
  const int D = g.D, N = g.level, L = g.n - g.level;
  const int row0 = blockIdx.y * WROWS, col0 = blockIdx.x * WBN;
  const int KT = (D + WBK - 1) / WBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      sm90::mbar_init(&full[s], 128);                 // producer threads
      sm90::mbar_init(&empty[s], WCONSUMERS / 32);    // consumer warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= WCONSUMERS / 32) {  // producer warpgroup
    const int p = threadIdx.x - WCONSUMERS;
    constexpr int PR = kProdRows<M>, LPR = kLanesPerRow<M>;
    const int kq = (p % LPR) * (M == kFc1 ? 4 : 8);  // k inside the stage
    const int rbase = p / LPR;
    // source rows: fc1 P_l = P[l] + 0, P_r = P[r] + D; project chart[cell]
    const float* srcl[PR];
    const float* srcr[PR];
    const __nv_bfloat16* srcc[PR];
#pragma unroll
    for (int m = 0; m < PR; ++m) {
      const int row = row0 + rbase + (128 / PR) * m;
      srcl[m] = srcr[m] = nullptr;
      srcc[m] = nullptr;
      if (row >= g.R) continue;
      if constexpr (M == kFc1) {
        const int k = row % N, pos = row / N % L;
        const long long cb = (long long)(row / N / L) * g.NC;
        const float* P = static_cast<const float*>(asrc);
        srcl[m] = P + (cb + level_offset(g.n, k) + pos) * 3 * D;
        srcr[m] = P + (cb + level_offset(g.n, N - k - 1) + pos + k + 1) * 3 * D + D;
      } else {
        const long long cell =
            (long long)(row / L) * g.NC + level_offset(g.n, g.level) + row % L;
        srcc[m] = static_cast<const __nv_bfloat16*>(asrc) + cell * D;
      }
    }
    int chunks = 0;  // B boxes with a column inside ncols
    while (chunks < WCHUNKS && col0 + 64 * chunks < g.ncols) ++chunks;
    if (p == 0) sm90::tma_prefetch_desc(bmap);
    for (int t = 0; t < KT; ++t) {
      const int s = t % WSTAGES;
      if (t >= WSTAGES) sm90::mbar_wait(&empty[s], (t / WSTAGES - 1) & 1);
      unsigned char* st = smem + s * kStageBytes<M>;
      if (p == 0) {
        sm90::mbar_expect_tx(&full[s], chunks * WCHUNK_BYTES);
        for (int j = 0; j < chunks; ++j)
          sm90::tma_load_2d(st + j * WCHUNK_BYTES, bmap, &full[s], col0 + 64 * j,
                            t * WBK);
      }
      const int k = t * WBK + kq;
      const bool kin = k < D;  // D % 8 == 0: a copy is wholly inside or out
#pragma unroll
      for (int m = 0; m < PR; ++m) {
        const int r = rbase + (128 / PR) * m;
        if constexpr (M == kFc1) {
          float* al = reinterpret_cast<float*>(st + WB_BYTES);
          float* ar = al + WROWS * WAS;
          const bool ok = kin && srcl[m] != nullptr;
          sm90::cp_async16(al + r * WAS + kq, ok ? srcl[m] + k : asrc, ok ? 16 : 0);
          sm90::cp_async16(ar + r * WAS + kq, ok ? srcr[m] + k : asrc, ok ? 16 : 0);
        } else {
          __nv_bfloat16* ac = reinterpret_cast<__nv_bfloat16*>(st + WB_BYTES);
          const bool ok = kin && srcc[m] != nullptr;
          sm90::cp_async16(ac + r * WAS + kq, ok ? srcc[m] + k : asrc, ok ? 16 : 0);
        }
      }
      sm90::mbar_arrive_cp_async(&full[s]);
    }
    return;
  }

  // consumer: warpgroup u owns tile rows 64 u + 16 (warp % 4) + lane / 4
  // (+ 8), the m16n8k16 A-fragment rows of its warp; q = lane % 4
  const int u = warp / 4, q = lane % 4;
  const int rowa = 64 * u + 16 * (warp % 4) + lane / 4;
  float acc[100];
#pragma unroll
  for (int i = 0; i < 100; ++i) acc[i] = 0.f;
  sm90::fence_regs(acc);
  // Wait for tile t, build its A fragments in f (register 2e + h holds
  // row rowa + 8h, k = 16j + 2q + 8e and the next k) and issue its wgmmas
  // as one group.
  auto issue = [&](uint32_t(&f)[WBK / 16][4], int t) {
    const int s = t % WSTAGES;
    sm90::mbar_wait(&full[s], (t / WSTAGES) & 1);
    const unsigned char* st = smem + s * kStageBytes<M>;
    const int jn = min(WBK / 16, (D - t * WBK + 15) / 16);  // k16 steps in D
#pragma unroll
    for (int j = 0; j < WBK / 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 16 * j + 2 * q + 8 * e, r = rowa + 8 * h;
          if constexpr (M == kFc1) {
            const float* al = reinterpret_cast<const float*>(st + WB_BYTES);
            const float* ar = al + WROWS * WAS;
            const int k = t * WBK + kk;
            const float2 l = *reinterpret_cast<const float2*>(al + r * WAS + kk);
            const float2 rr = *reinterpret_cast<const float2*>(ar + r * WAS + kk);
            float x0 = 0.f, x1 = 0.f;
            if (k < D) {  // k + 1 < D too (D even)
              x0 = fmaxf((l.x + rr.x) + __ldg(bias0 + k), 0.f);
              x1 = fmaxf((l.y + rr.y) + __ldg(bias0 + k + 1), 0.f);
            }
            f[j][2 * e + h] = pack_bf16(x0, x1);  // h1, rounded to bf16
          } else {
            const __nv_bfloat16* ac =
                reinterpret_cast<const __nv_bfloat16*>(st + WB_BYTES);
            f[j][2 * e + h] = *reinterpret_cast<const uint32_t*>(ac + r * WAS + kk);
          }
        }
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < WBK / 16; ++j) {  // 16 k-rows = 2048 bytes
      if (j >= jn) break;
      const uint64_t db = sm90::desc_sw128(st + 2048 * j, WCHUNK_BYTES, 1024);
      sm90::wgmma_m64n200_rs(acc, f[j], db, 1);
    }
    sm90::wgmma_commit();
  };
  // tile t's stage is free once every consumer warp is past its wgmmas
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[t % WSTAGES]);
  };
  // two fragment sets: tile t + 1's are built while tile t's wgmmas run
  uint32_t fa[WBK / 16][4], fb[WBK / 16][4];
  issue(fa, 0);
  int t = 1;
  for (; t + 1 < KT; t += 2) {
    issue(fb, t);
    sm90::wgmma_wait<1>();
    release(t - 1);
    issue(fa, t + 1);
    sm90::wgmma_wait<1>();
    release(t);
  }
  if (t < KT) {
    issue(fb, t);
    sm90::wgmma_wait<1>();
    release(t - 1);
    ++t;
  }
  sm90::wgmma_wait<0>();
  release(t - 1);
  sm90::fence_regs(acc);

  // d[4j + 2h + e] is (row rowa + 8h, column 8j + 2q + e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + rowa + 8 * h;
    if (row >= g.R) continue;
    long long base;
    if constexpr (M == kFc1)
      base = (long long)row * D;
    else
      base = ((long long)(row / L) * g.NC + level_offset(g.n, g.level) + row % L) *
             3 * D;
#pragma unroll
    for (int j = 0; j < WBN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * q;  // ncols % 8 == 0: col + 1 inside
      if (col >= g.ncols) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (M == kFc1) {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + base + col) =
            pack_bf16(fmaxf(v0 + __ldg(bias1 + col), 0.f),
                      fmaxf(v1 + __ldg(bias1 + col + 1), 0.f));
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + base + col) =
            make_float2(v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------ kernels --

// Weights rounded to the compute dtype and stored k-major for the GEMMs:
// wp[k, 0:3D] = [W0[:, :D]^T, W0[:, D:]^T, M] (the projection), w1t = W1^T.
template <typename T>
__global__ void prep_weights(const float* __restrict__ w0,
                             const float* __restrict__ w1,
                             const float* __restrict__ mat, T* __restrict__ wp,
                             T* __restrict__ w1t, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long np = 3LL * D * D;
  if (i < np) {
    const int k = (int)(i / (3 * D)), o = (int)(i % (3 * D));
    float w;
    if (o < D)
      w = w0[(long long)o * 2 * D + k];
    else if (o < 2 * D)
      w = w0[(long long)(o - D) * 2 * D + D + k];
    else
      w = mat[(long long)k * D + (o - 2 * D)];
    wp[i] = store_t<T>(w);
  } else if (i < np + (long long)D * D) {
    const long long j = i - np;
    const int k = (int)(j / D), o = (int)(j % D);
    w1t[j] = store_t<T>(w1[(long long)o * D + k]);
  }
}

// Leaves -> chart level 0: h (cast to the chart dtype), score 0, CKY
// value 1, backpointer 0.
template <typename T>
__global__ void init_leaves(const float* __restrict__ h0, T* __restrict__ chart,
                            float* __restrict__ s, float* __restrict__ val,
                            int* __restrict__ bp, int B, int n, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * n * D) return;
  const int d = (int)(i % D);
  const long long bpos = i / D;
  const int pos = (int)(bpos % n);
  const long long b = bpos / n;
  const long long cell = b * ((long long)n * (n + 1) / 2) + pos;
  chart[cell * D + d] = store_t<T>(h0[i]);
  if (d == 0) {
    s[cell] = 0.f;
    val[cell] = 1.f;
    bp[cell] = 0;
  }
}

// f32: P[cell, 0:3D] = [W0[:, :D] h, W0[:, D:] h, h M] for the B * (n -
// level) cells of ``level``.  Grid: (ceil(3D / 80), row tiles).
__global__ void __launch_bounds__(FNT, 2)
project_simt(const float* __restrict__ chart, const float* __restrict__ wp,
             float* __restrict__ P, int n, int D, int level, int B) {
  extern __shared__ __align__(16) float fsmem[];
  __shared__ long long cell_of[FBM];  // flat cell of each tile row, -1 = pad
  const int L = n - level;
  const int R = B * L, N3 = 3 * D;
  const long long NC = (long long)n * (n + 1) / 2;
  const int row0 = blockIdx.y * FBM, col0 = blockIdx.x * FBN;
  for (int i = threadIdx.x; i < FBM; i += FNT) {
    const int r = row0 + i;
    cell_of[i] = r < R ? (r / L) * NC + level_offset(n, level) + r % L : -1;
  }
  __syncthreads();
  float acc[FTM][FTN];
  simt_gemm(
      D,
      [&](int r, int k) -> const float* {
        const long long c = cell_of[r];
        return c >= 0 && k < D ? chart + c * D + k : nullptr;
      },
      [&](int k, int c) -> const float* {
        const int o = col0 + c;
        return k < D && o < N3 ? wp + (long long)k * N3 + o : nullptr;
      },
      wp, fsmem, acc);
  simt_epilogue(acc, [&](int r, int c, float4 v) {
    const long long cell = cell_of[r];
    const int o = col0 + c;
    if (cell >= 0 && o < N3)
      *reinterpret_cast<float4*>(P + cell * N3 + o) = v;
  });
}

// f32: h1[r] = relu((P_l[:D] + P_r[D:2D]) + b0), one block per level row
// r = (b * L + p) * N + k: target (level, p) of sentence b, split k.
__global__ void __launch_bounds__(CT)
fc0(const float* __restrict__ P, const float* __restrict__ b0,
    float* __restrict__ h1, int n, int D, int level) {
  const int N = level, L = n - level;
  const long long NC = (long long)n * (n + 1) / 2;
  const long long r = blockIdx.x;
  const int k = (int)(r % N), p = (int)(r / N % L);
  const long long cb = r / N / L * NC;
  const float* pl = P + (cb + level_offset(n, k) + p) * 3 * D;
  const float* pr = P + (cb + level_offset(n, level - k - 1) + p + k + 1) * 3 * D + D;
  for (int d = threadIdx.x; d < D; d += CT)
    h1[r * D + d] = fmaxf(pl[d] + pr[d] + b0[d], 0.f);
}

// f32: hk[rows] = relu(h1 W1^T + b1).  Grid: (ceil(D / 80), row tiles).
__global__ void __launch_bounds__(FNT, 2)
fc1_simt(const float* __restrict__ h1, const float* __restrict__ w1t,
         const float* __restrict__ b1, float* __restrict__ hk, int D, int R) {
  extern __shared__ __align__(16) float fsmem[];
  const int row0 = blockIdx.y * FBM, col0 = blockIdx.x * FBN;
  float acc[FTM][FTN];
  simt_gemm(
      D,
      [&](int r, int k) -> const float* {
        const int row = row0 + r;
        return row < R && k < D ? h1 + (long long)row * D + k : nullptr;
      },
      [&](int k, int c) -> const float* {
        const int o = col0 + c;
        return k < D && o < D ? w1t + (long long)k * D + o : nullptr;
      },
      w1t, fsmem, acc);
  simt_epilogue(acc, [&](int r, int c, float4 v) {
    const int row = row0 + r, o = col0 + c;
    if (row >= R || o >= D) return;
    *reinterpret_cast<float4*>(hk + (long long)row * D + o) =
        make_float4(fmaxf(v.x + b1[o], 0.f), fmaxf(v.y + b1[o + 1], 0.f),
                    fmaxf(v.z + b1[o + 2], 0.f), fmaxf(v.w + b1[o + 3], 0.f));
  });
}

// bf16: P[cell] = chart[cell] . wp for the B * (n - level) cells of
// ``level`` on wgmma.  Grid: (ceil(3D / 200), row tiles of 128).
__global__ void __launch_bounds__(WTHREADS, 1)
project_wgmma(const __grid_constant__ CUtensorMap wp_map,
              const __nv_bfloat16* __restrict__ chart, float* __restrict__ P,
              int n, int D, int level, int B) {
  const WgArgs g{n, D, level, B * (n - level), 3 * D,
                 (long long)n * (n + 1) / 2};
  wg_gemm<kProject>(&wp_map, chart, nullptr, nullptr, P, g);
}

// bf16: hk[rows] = bf16(relu(bf16(relu((P_l + P_r) + b0)) W1^T + b1)) on
// wgmma, h1 built in registers.  Grid: (ceil(D / 200), row tiles of 128).
__global__ void __launch_bounds__(WTHREADS, 1)
fc1_wgmma(const __grid_constant__ CUtensorMap w1_map, const float* __restrict__ P,
          const float* __restrict__ b0, const float* __restrict__ b1,
          __nv_bfloat16* __restrict__ hk, int n, int D, int level, int R) {
  const WgArgs g{n, D, level, R, D, (long long)n * (n + 1) / 2};
  wg_gemm<kFc1>(&w1_map, P, b0, b1, hk, g);
}

// four consecutive values (16-byte / 8-byte aligned) as floats, and back
__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ inline void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ inline void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// One block per target cell t = b * L + p: split scores (the bilinear dot
// (l M) . r; warp w takes splits w, w + 4, ..., lane l columns 4 l + 128 c
// with 16-byte (f32) or 8-byte (bf16) loads), softmax and CKY on one
// thread in split order, the weighted sum of hk in split order with thread
// i owning columns 4 i + 4 CT c, unit norm, written into the chart.  What
// bounds it: the latency of those reads, a level's cells being about one
// wave.  Dynamic shared memory: D floats of h, then 2N split floats.
template <typename T>
__global__ void __launch_bounds__(CT)
combine(T* __restrict__ chart, float* __restrict__ s, float* __restrict__ val,
        int* __restrict__ bp, const T* __restrict__ hk,
        const float* __restrict__ P, int n, int D, int level, int unit_norm) {
  extern __shared__ float4 sm4[];
  __shared__ float z_sh, red[CT / 32];
  const int N = level, L = n - level;
  float* hv = reinterpret_cast<float*>(sm4);  // aggregated h
  float* sk = hv + D;        // split scores, then exp(s_k - max)
  float* pk = sk + N;        // CKY candidates v_l + v_r + s_k
  const long long NC = (long long)n * (n + 1) / 2;
  const long long t = blockIdx.x;
  const int p = (int)(t % L);
  const long long cb = (t / L) * NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

#pragma unroll 2
  for (int k = warp; k < N; k += CT / 32) {
    const long long lc = cb + level_offset(n, k) + p;
    const long long rc = cb + level_offset(n, level - k - 1) + p + k + 1;
    const float* lm = P + lc * 3 * D + 2 * D;  // l M of the left child
    const T* r = chart + rc * D;
    float bil = 0.f;
    for (int d = 4 * lane; d < D; d += 128) {
      const float4 a = load4(lm + d), b = load4(r + d);
      bil = fmaf(a.x, b.x, bil);
      bil = fmaf(a.y, b.y, bil);
      bil = fmaf(a.z, b.z, bil);
      bil = fmaf(a.w, b.w, bil);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      bil += __shfl_xor_sync(0xffffffffu, bil, off);
    if (lane == 0) {
      const float v = bil + s[lc] + s[rc];
      sk[k] = v;
      pk[k] = v + val[lc] + val[rc];
    }
  }
  __syncthreads();

  const long long tc = cb + level_offset(n, level) + p;
  if (threadIdx.x == 0) {
    // sequential over the splits, in split order: the TPU kernel's order
    float m = sk[0];
    for (int k = 1; k < N; ++k) m = fmaxf(m, sk[k]);
    float z = 0.f, sacc = 0.f, best = pk[0];
    int barg = 0;
    for (int k = 0; k < N; ++k) {
      const float e = expf(sk[k] - m);
      z += e;
      sacc += sk[k] * e;
      if (pk[k] > best) {
        best = pk[k];
        barg = k;
      }
      sk[k] = e;
    }
    s[tc] = sacc / z;
    val[tc] = best - m;
    bp[tc] = barg;
    z_sh = z;
  }
  __syncthreads();

  const float z = z_sh;
  const T* hrow = hk + t * N * D;
  float ss = 0.f;
  for (int d = 4 * threadIdx.x; d < D; d += 4 * CT) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      const float4 h = load4(hrow + (long long)k * D + d);
      const float e = sk[k];
      acc.x += h.x * e;
      acc.y += h.y * e;
      acc.z += h.z * e;
      acc.w += h.w * e;
    }
    const float4 h = make_float4(acc.x / z, acc.y / z, acc.z / z, acc.w / z);
    store4(hv + d, h);
    ss += h.x * h.x + h.y * h.y + h.z * h.z + h.w * h.w;
  }
  float inv = 1.f;
  if (unit_norm) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < CT / 32; ++w) tot += red[w];
    inv = 1.f / sqrtf(fmaxf(tot, 1e-16f));
  }
  for (int d = 4 * threadIdx.x; d < D; d += 4 * CT) {
    const float4 h = load4(hv + d);
    store4(chart + tc * D + d, make_float4(h.x * inv, h.y * inv, h.z * inv, h.w * inv));
  }
}

unsigned tiles(long long x, int tile) { return (unsigned)((x + tile - 1) / tile); }

// Weight prep and the leaves, shared by both routes.
template <typename T>
cudaError_t prologue(const float* h0, const float* w0, const float* w1,
                     const float* mat, T* chart, float* s, float* val, int* bp,
                     T* wp, T* w1t, int B, int n, int D, cudaStream_t stream) {
  prep_weights<T><<<tiles(4LL * D * D, 256), 256, 0, stream>>>(w0, w1, mat, wp,
                                                               w1t, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  init_leaves<T><<<tiles((long long)B * n * D, 256), 256, 0, stream>>>(
      h0, chart, s, val, bp, B, n, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(T* chart, float* s, float* val, int* bp, const T* hk,
                           const float* P, int B, int n, int D, int level,
                           int unit_norm, cudaStream_t stream) {
  const size_t smem = (size_t)(D + 2 * level) * sizeof(float);
  combine<T><<<(unsigned)(B * (n - level)), CT, smem, stream>>>(
      chart, s, val, bp, hk, P, n, D, level, unit_norm);
  return cudaGetLastError();
}

#define CHECK(x)                            \
  do {                                      \
    const cudaError_t e_ = (x);             \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

int run_f32(const float* h0, const float* w0, const float* b0, const float* w1,
            const float* b1, const float* mat, float* chart, float* s,
            float* val, int* bp, float* P, float* h1, float* hk, float* wp,
            float* w1t, int B, int n, int D, int unit_norm,
            cudaStream_t stream) {
  CHECK(prologue<float>(h0, w0, w1, mat, chart, s, val, bp, wp, w1t, B, n, D,
                        stream));
  CHECK(cudaFuncSetAttribute(project_simt,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemSimt));
  CHECK(cudaFuncSetAttribute(fc1_simt,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemSimt));
  project_simt<<<dim3(tiles(3 * D, FBN), tiles(B * n, FBM)), FNT, kSmemSimt,
                 stream>>>(chart, wp, P, n, D, 0, B);
  CHECK(cudaGetLastError());
  for (int level = 1; level < n; ++level) {
    const int L = n - level;
    const int R = B * L * level;
    fc0<<<(unsigned)R, CT, 0, stream>>>(P, b0, h1, n, D, level);
    CHECK(cudaGetLastError());
    fc1_simt<<<dim3(tiles(D, FBN), tiles(R, FBM)), FNT, kSmemSimt, stream>>>(
        h1, w1t, b1, hk, D, R);
    CHECK(cudaGetLastError());
    CHECK(launch_combine<float>(chart, s, val, bp, hk, P, B, n, D, level,
                                unit_norm, stream));
    if (level < n - 1) {  // the root is nobody's child
      project_simt<<<dim3(tiles(3 * D, FBN), tiles(B * L, FBM)), FNT,
                     kSmemSimt, stream>>>(chart, wp, P, n, D, level, B);
      CHECK(cudaGetLastError());
    }
  }
  return 0;
}

int run_bf16(const float* h0, const float* w0, const float* b0, const float* w1,
             const float* b1, const float* mat, __nv_bfloat16* chart, float* s,
             float* val, int* bp, float* P, __nv_bfloat16* hk,
             __nv_bfloat16* wp, __nv_bfloat16* w1t, int B, int n, int D,
             int unit_norm, cudaStream_t stream) {
  if (D % 8) return (int)cudaErrorInvalidValue;  // TMA rows of 16-byte multiples
  CHECK(prologue<__nv_bfloat16>(h0, w0, w1, mat, chart, s, val, bp, wp, w1t, B,
                                n, D, stream));
  CUtensorMap wp_map, w1_map;
  CHECK(sm90_host::tensor_map_bf16(&wp_map, wp, D, 3LL * D, WBK, 64));
  CHECK(sm90_host::tensor_map_bf16(&w1_map, w1t, D, D, WBK, 64));
  CHECK(cudaFuncSetAttribute(project_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemWg<kProject>));
  CHECK(cudaFuncSetAttribute(fc1_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemWg<kFc1>));
  project_wgmma<<<dim3(tiles(3 * D, WBN), tiles(B * n, WROWS)), WTHREADS,
                  kSmemWg<kProject>, stream>>>(wp_map, chart, P, n, D, 0, B);
  CHECK(cudaGetLastError());
  for (int level = 1; level < n; ++level) {
    const int L = n - level;
    const int R = B * L * level;
    fc1_wgmma<<<dim3(tiles(D, WBN), tiles(R, WROWS)), WTHREADS, kSmemWg<kFc1>,
                stream>>>(w1_map, P, b0, b1, hk, n, D, level, R);
    CHECK(cudaGetLastError());
    CHECK(launch_combine<__nv_bfloat16>(chart, s, val, bp, hk, P, B, n, D,
                                        level, unit_norm, stream));
    if (level < n - 1) {
      project_wgmma<<<dim3(tiles(3 * D, WBN), tiles(B * L, WROWS)), WTHREADS,
                      kSmemWg<kProject>, stream>>>(wp_map, chart, P, n, D,
                                                   level, B);
      CHECK(cudaGetLastError());
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// h0 (B, n, D) f32; w0 (D, 2D), b0 (D), w1 (D, D), b1 (D), mat (D, D)
// f32; chart (B, ncells, D) in the compute dtype; s, val (B, ncells) f32;
// bp (B, ncells) int32; P (B, ncells, 3D) f32; hk (rows, D) in the
// compute dtype, rows = B * max_level (n - level) * level; h1 (rows, D)
// f32 for f32 (unused for bf16, may be null); wp (D, 3D) and w1t (D, D)
// scratch in the compute dtype for the k-major weights.  Needs D % 4 == 0
// (f32) or D % 8 == 0 and 16-byte-aligned wp, w1t, chart and P (bf16).
int inside_cky_forward(const float* h0, const float* w0, const float* b0,
                       const float* w1, const float* b1, const float* mat,
                       void* chart, float* s, float* val, int* bp, float* P,
                       void* h1, void* hk, void* wp, void* w1t, int B, int n,
                       int D, int bf16, int unit_norm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_bf16(h0, w0, b0, w1, b1, mat, static_cast<__nv_bfloat16*>(chart),
                    s, val, bp, P, static_cast<__nv_bfloat16*>(hk),
                    static_cast<__nv_bfloat16*>(wp),
                    static_cast<__nv_bfloat16*>(w1t), B, n, D, unit_norm, st);
  return run_f32(h0, w0, b0, w1, b1, mat, static_cast<float*>(chart), s, val,
                 bp, P, static_cast<float*>(h1), static_cast<float*>(hk),
                 static_cast<float*>(wp), static_cast<float*>(w1t), B, n, D,
                 unit_norm, st);
}

const char* inside_cky_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
