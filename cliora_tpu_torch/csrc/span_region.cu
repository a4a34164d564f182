// Span x region best-match scores and their gradient, for Hopper (sm_90a).
//
// Three kernels, each replacing one TPU kernel of cliora_tpu/ops/span_region.py:
//
//  K2 span_region_fwd   replaces _pallas_kernel (launched by
//                       _max_and_argmax_pallas):
//      out[a,c,m] = max_r sum_d span[a,m,d] obj[c,r,d], am[a,c,m] = its
//      first-max r (strict > over increasing r), scores accumulated in f32.
//  K3 span_region_dspan replaces _dspan_kernel with _bwd_w (launched by
//                       _bwd_pallas):
//      dspan[a,m,:] = sum_c g[a,c,m] obj[c, am[a,c,m], :]
//  K4 span_region_dobj  replaces _dobj_kernel (launched by _bwd_pallas):
//      dobj[c,r,:] = sum_{(a,m): am[a,c,m] = r} g[a,c,m] span[a,m,:]
//
// K2.  A GEMM of the A*M span rows against the C*R region rows, both along
// D, whose epilogue takes each image's max/argmax over its R regions: the
// (A, C, M, R) scores never leave the chip.  What bounds it: operations
// (2 A M C R D FLOP; at the contrastive call A=C=128, M=210, R=36, D=400
// that is 9.9e10 FLOP against 52.7 MB of compulsory traffic).  Column
// tiles hold whole images: BN=144 columns are CI = BN / R images (R=36: 4
// images, no padding; other R leave BN - CI*R columns that the epilogue
// ignores).
//  * bf16 spans (the contrastive call; obj is cast to bf16 by the
//    wrapper): k2_fwd_bf16.  A block owns 128 span rows x 144 columns.
//    One producer warp keeps a 3-stage ring of 64-deep tiles filled by TMA
//    (128-byte swizzle, the D tail zero-filled); two consumer warpgroups
//    each run wgmma m64n144k16 on 64 of the rows, f32 accumulators in
//    registers.  Epilogue from the registers: a quad of threads holds one
//    row's 144 columns; each thread takes a first max per image over its
//    columns in order, and a quad shuffle keeps the larger value, the
//    lower region on a tie -- the strict > over increasing r of the plain
//    version.  No score tile goes through shared memory.  Two blocks fit
//    an SM, so one block's epilogue overlaps the other's loads.
//  * f32 spans (the VG call): k2_fwd_f32, fp32 FMAs on the CUDA cores, no
//    TF32, each thread an 8 x 9 block of a 64-row tile, 16-deep
//    shared-memory stages with the next stage's loads in registers; its
//    scores go to shared memory and one thread per (row, image) scans them.
//  At init the image encoder is zero, every score ties at 0, and the
//  argmax is 0, as in the JAX package.
//
// K3.  The TPU multiplied a g-weighted one-hot (tile x C*R) by obj on the
// MXU.  Here each warp owns one span row (a, m) and gathers the argmax row
// obj[c, am] directly for c = 0, 1, ..., C-1 in that order, 4 columns a
// lane (16-byte loads), f32 accumulators in registers: deterministic by
// construction.  What bounds it: the gathered obj rows (A M C D floats,
// 5.5 GB at the contrastive call, read through L1/L2: obj itself is 7.4 MB),
// not the 2 A M C D FLOP.
//
// K4.  dobj = W . span as a GEMM over the A*M span rows, with
// W[c R + r, a M + m] = g[a, c, m] [am[a, c, m] = r] -- the TPU kernel's
// one-hot matmul.  No float atomics, so two calls on the same inputs give
// the same bits (the JAX package promises bitwise-exact resume): the rows
// are cut into a shape-determined number of fixed segments, each block
// writes its segment's partial sums, and k4_reduce adds them in segment
// order.
//  * bf16 spans (the contrastive call): k4_dobj_gemm, on the tensor cores.
//    A block owns 128 region rows (two consumer warpgroups of 64) x 200
//    columns of D.  A producer warp brings each 64-row k tile of span by
//    TMA (MN-major, four 64-wide boxes) and stages the argmax and g of the
//    tile's rows for the block's images (a few KB) in a 4-stage ring.
//    Each consumer thread builds its own wgmma A fragment of W in
//    registers from those, so W never reaches memory, and runs wgmma
//    m64n200k16 with B = the span tile.  g is split into two bf16 terms,
//    g_hi = bf16(g), g_lo = bf16(g - g_hi): each term times a bf16 span
//    value is exact in f32, sums are f32, and what is left out of g is
//    at most 2^-16 of it.  The work is the dense product, 2 terms x 2 C R A
//    M D FLOP, whatever the argmax: all rows on region 0 at init cost what
//    random ones cost.  What bounds it: the tensor-core operations (0.10
//    ms a term at the contrastive call), not the bytes.
//  * f32 spans (the VG call): k4_dobj_f32, a scatter with one owner thread
//    per accumulator entry.  A block owns G images (4, or 2 where R is
//    large) and a 128-wide slice of D, keeps their (G, R, 128) f32
//    accumulator in shared memory, and walks a row segment in order: warp
//    w handles image w, lane l columns 4l..4l+3.  What bounds it:
//    instructions per (row, image) update -- a load, a shared-memory
//    read-modify-write.
//
// g stays f32 in K3 and the f32 K4 (the Pallas backward rounds the
// weighted one-hot to bf16 before its matmuls; the port's plain backward,
// and the JAX package's einsum/chunked backward, do not), and enters the
// bf16 K4 as two bf16 terms whose sum is g within 2^-16; obj is read in
// f32 by K3, span in its own dtype by K4.
//
// Plain C interface, loaded with ctypes (ops/span_region.py).  The caller
// allocates every buffer; kernels run on the caller's stream; each launch
// is checked and the first error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "sm90.cuh"

namespace {

// four consecutive floats (16-byte aligned)
__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

template <typename T> __device__ inline T store_t(float x);
template <> __device__ inline float store_t<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 store_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// ---------------------------------------------------------------- K2 ----

constexpr int BN = 144;          // region columns per block (whole images)

// f32: 64 span rows a block, 128 threads of 8 x 9 scores, 16-deep stages
constexpr int BM = 64;
constexpr int NT = 128;
constexpr int CS = BN + 4;       // f32 score tile row stride
constexpr int FBK = 16;
constexpr int FTM = 8, FTN = 9;
constexpr int FA = BM * FBK / 4 / NT;                 // A float4s a thread
constexpr int FB = (BN * FBK / 4 + NT - 1) / NT;      // B float4s a thread
static_assert((BM / FTM) * (BN / FTN) == NT, "f32 thread tile");
constexpr int kSmemF32 = (FBK * BM + FBK * BN) * 4;
constexpr int kSmemScores = BM * CS * 4;
constexpr int kSmemK2 = kSmemScores > kSmemF32 ? kSmemScores : kSmemF32;

// The block's operands: span rows [row0, row0 + BM) of the flat (A*M, D)
// span, region rows [col0, col0 + ncols) of the flat (C*R, D) obj; rows
// and columns past the end read as zero.
struct Tile {
  long long row0, rows;  // first row, total span rows
  long long col0;        // first region row (= first image * R)
  int ncols;             // region columns of this block (<= BN)
  int D;
};

// acc (in shared memory Cs, row-major, stride CS) = span tile . obj tile^T
// in f32 on the CUDA cores.
__device__ __forceinline__ void mainloop_f32(const float* __restrict__ span,
                                             const float* __restrict__ obj,
                                             const Tile& t, unsigned char* smem) {
  auto As = reinterpret_cast<float (*)[BM]>(smem);              // [k][row]
  auto Bs = reinterpret_cast<float (*)[BN]>(smem + FBK * BM * 4);  // [k][col]
  const int tx = threadIdx.x % (BN / FTN), ty = threadIdx.x / (BN / FTN);
  float acc[FTM][FTN];
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;

  float4 ra[FA], rb[FB];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < FA; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int r = idx / 4, k = k0 + (idx % 4) * 4;
      const long long row = t.row0 + r;
      ra[j] = (row < t.rows && k < t.D)
                  ? *reinterpret_cast<const float4*>(span + row * t.D + k)
                  : zero;
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int c = idx / 4, k = k0 + (idx % 4) * 4;
      rb[j] = (idx < BN * FBK / 4 && c < t.ncols && k < t.D)
                  ? *reinterpret_cast<const float4*>(obj + (t.col0 + c) * t.D + k)
                  : zero;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < FA; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int r = idx / 4, k = (idx % 4) * 4;
      As[k][r] = ra[j].x;
      As[k + 1][r] = ra[j].y;
      As[k + 2][r] = ra[j].z;
      As[k + 3][r] = ra[j].w;
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      const int idx = threadIdx.x + NT * j;
      if (idx >= BN * FBK / 4) continue;
      const int c = idx / 4, k = (idx % 4) * 4;
      Bs[k][c] = rb[j].x;
      Bs[k + 1][c] = rb[j].y;
      Bs[k + 2][c] = rb[j].z;
      Bs[k + 3][c] = rb[j].w;
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < t.D; k0 += FBK) {
    const bool more = k0 + FBK < t.D;
    if (more) fetch(k0 + FBK);  // in flight while this stage multiplies
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * FTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * FTM + 4]);
      const float a[FTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[FTN];
#pragma unroll
      for (int j = 0; j < FTN; ++j) b[j] = Bs[kk][tx * FTN + j];
#pragma unroll
      for (int i = 0; i < FTM; ++i)
#pragma unroll
        for (int j = 0; j < FTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
  auto Cs = reinterpret_cast<float (*)[CS]>(smem);
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) Cs[ty * FTM + i][tx * FTN + j] = acc[i][j];
}

// Grid: (column tiles of CI images, row tiles of BM rows).
__global__ void __launch_bounds__(NT)
k2_fwd_f32(const float* __restrict__ span, const float* __restrict__ obj,
           float* __restrict__ mx, int* __restrict__ am, int A, int M, int C,
           int R, int D) {
  __shared__ __align__(128) unsigned char smem[kSmemK2];
  const int CI = BN / R;                 // images per column tile
  const int c0 = blockIdx.x * CI;
  const int nimg = min(CI, C - c0);
  Tile t;
  t.row0 = (long long)blockIdx.y * BM;
  t.rows = (long long)A * M;
  t.col0 = (long long)c0 * R;
  t.ncols = nimg * R;
  t.D = D;
  mainloop_f32(span, obj, t, smem);
  __syncthreads();

  // segmented max/argmax: one thread per (row, image), regions in order
  auto Cs = reinterpret_cast<const float (*)[CS]>(smem);
  for (int p = threadIdx.x; p < BM * nimg; p += NT) {
    const int r = p % BM, ci = p / BM;
    const long long row = t.row0 + r;
    if (row >= t.rows) continue;
    const float* s = &Cs[r][ci * R];
    float best = s[0];
    int arg = 0;
    for (int q = 1; q < R; ++q)
      if (s[q] > best) {
        best = s[q];
        arg = q;
      }
    const long long a = row / M, m = row % M;
    const long long o = (a * C + c0 + ci) * M + m;
    mx[o] = best;
    am[o] = arg;
  }
}

// bf16: 256 span rows a block (two consumer warpgroups of 128, each two
// wgmma row tiles of 64) and one producer warp; a ring of 64-deep stages,
// each the span tile (256 x 64) and the obj tile (144 x 64), 128-byte rows
// swizzled by TMA.  256 x 144 tiles read span and obj from L2 1.07 GB at
// the contrastive call (128 x 144 tiles: 1.46 GB).
constexpr int K2_ROWS = 256;
constexpr int K2_BK = 64;
constexpr int K2_STAGES = 4;
constexpr int K2_CONSUMERS = 256;
constexpr int K2_THREADS = K2_CONSUMERS + 128;  // + a producer warpgroup
constexpr int K2_A_BYTES = K2_ROWS * K2_BK * 2;
constexpr int K2_B_BYTES = BN * K2_BK * 2;
constexpr int K2_STAGE_BYTES = K2_A_BYTES + K2_B_BYTES;
static_assert(K2_A_BYTES % 1024 == 0 && K2_B_BYTES % 1024 == 0,
              "swizzle atoms stay 1024-byte aligned");
constexpr int kSmemK2Bf16 = K2_STAGES * K2_STAGE_BYTES + 2 * K2_STAGES * 8 + 1024;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Max and first-max region of image ci for the thread's two rows of one
// 64 x 144 accumulator tile (rows g and g + 8 of its warp's 16, columns
// 8j + 2q (+1)).  Each thread scans its columns in increasing order, then
// the quad's four partial results meet by shuffles: the larger value
// wins, the lower region on a tie.  RT > 0 fixes R at compile time, so
// only the registers that can hold the image's columns are scanned.
template <int RT>
__device__ __forceinline__ void k2_image(const float (&acc)[72], int ci,
                                         long long row, int q, int R, int c0,
                                         int C, int M, long long rows,
                                         float* mx, int* am) {
  const int Rr = RT > 0 ? RT : R;
  const int lo = ci * Rr;
  float best[2] = {-INFINITY, -INFINITY};
  int arg[2] = {INT_MAX, INT_MAX};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (RT > 0 && (8 * j + 7 < ci * RT || 8 * j >= (ci + 1) * RT)) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * q + e;
      const bool in = col >= lo && col < lo + Rr;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = acc[4 * j + 2 * h + e];
        if (in && v > best[h]) {
          best[h] = v;
          arg[h] = col - lo;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[h], off);
      if (ob > best[h] || (ob == best[h] && oa < arg[h])) {
        best[h] = ob;
        arg[h] = oa;
      }
    }
    const long long r = row + 8 * h;
    if (q == 0 && r < rows) {
      const long long a = r / M, m = r % M;
      const long long o = (a * C + c0 + ci) * M + m;
      mx[o] = best[h];
      am[o] = arg[h] == INT_MAX ? 0 : arg[h];
    }
  }
}

template <int RT>
__device__ __forceinline__ void k2_epilogue(const float (&acc)[72],
                                            long long row, int q, int R,
                                            int nimg, int c0, int C, int M,
                                            long long rows, float* mx,
                                            int* am) {
  if constexpr (RT > 0) {
#pragma unroll
    for (int ci = 0; ci < BN / RT; ++ci)
      if (ci < nimg) k2_image<RT>(acc, ci, row, q, R, c0, C, M, rows, mx, am);
  } else {
#pragma unroll 1
    for (int ci = 0; ci < nimg; ++ci)
      k2_image<RT>(acc, ci, row, q, R, c0, C, M, rows, mx, am);
  }
}

// Grid: (column tiles of CI images, row tiles of K2_ROWS rows).  RT: R
// fixed at compile time (36, the model's region count), or 0.
template <int RT>
__global__ void __launch_bounds__(K2_THREADS, 1)
k2_fwd_bf16(const __grid_constant__ CUtensorMap span_map,
            const __grid_constant__ CUtensorMap obj_map,
            float* __restrict__ mx, int* __restrict__ am, int A, int M, int C,
            int R, int D) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K2_STAGES * K2_STAGE_BYTES);
  uint64_t* empty = full + K2_STAGES;
  const int CI = BN / R;
  const int c0 = blockIdx.x * CI;
  const int nimg = min(CI, C - c0);
  const int row0 = blockIdx.y * K2_ROWS;
  const int ktiles = (D + K2_BK - 1) / K2_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K2_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], K2_CONSUMERS / 32);  // consumer warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the launch bound caps registers at 168 a thread (65,536 over 384);
  // the producer warpgroup hands its share to the consumers, whose two
  // 64 x 144 accumulators take 144.  One producer thread issues the loads.
  if (warp >= K2_CONSUMERS / 32) {  // producer warpgroup
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == K2_CONSUMERS) {
      sm90::tma_prefetch_desc(&span_map);
      sm90::tma_prefetch_desc(&obj_map);
      for (int t = 0; t < ktiles; ++t) {
        const int s = t % K2_STAGES;
        if (t >= K2_STAGES) sm90::mbar_wait(&empty[s], (t / K2_STAGES - 1) & 1);
        unsigned char* st = smem + s * K2_STAGE_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], K2_STAGE_BYTES);
        sm90::tma_load_2d(st, &span_map, &full[s], t * K2_BK, row0);
        sm90::tma_load_2d(st + K2_A_BYTES, &obj_map, &full[s], t * K2_BK,
                          c0 * R);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int wg = warp / 4;
  float acc[2][72];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int i = 0; i < 72; ++i) acc[u][i] = 0.f;
    sm90::fence_regs(acc[u]);
  }
  // one wgmma group in flight while the next tile's is issued; a stage is
  // free once every consumer warp is past its group
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[t % K2_STAGES]);
  };
  for (int t = 0; t < ktiles; ++t) {
    const int s = t % K2_STAGES;
    sm90::mbar_wait(&full[s], (t / K2_STAGES) & 1);
    const unsigned char* st = smem + s * K2_STAGE_BYTES;
    const uint64_t db = sm90::desc_sw128(st + K2_A_BYTES, 16, 1024);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < K2_BK / 16; ++j)  // +32 bytes along the row
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint64_t da =
            sm90::desc_sw128(st + (wg * 128 + 64 * u) * 128, 16, 1024);
        sm90::wgmma_m64n144_ss(acc[u], da + 2 * j, db + 2 * j, 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    if (t > 0) release(t - 1);
  }
  sm90::wgmma_wait<0>();
  release(ktiles - 1);
#pragma unroll
  for (int u = 0; u < 2; ++u) sm90::fence_regs(acc[u]);

  const long long rows = (long long)A * M;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long row =
        row0 + wg * 128 + 64 * u + (warp % 4) * 16 + lane / 4;
    k2_epilogue<RT>(acc[u], row, lane % 4, R, nimg, c0, C, M, rows, mx, am);
  }
}

// ---------------------------------------------------------------- K3 ----

constexpr int K3_WARPS = 8;     // span rows per block, one a warp
constexpr int K3_MAXQ = 8;      // D <= 128 * K3_MAXQ (4 columns a lane)

template <typename TS>
__device__ inline void store4(TS* p, float4 v) {
  p[0] = store_t<TS>(v.x);
  p[1] = store_t<TS>(v.y);
  p[2] = store_t<TS>(v.z);
  p[3] = store_t<TS>(v.w);
}

// One warp per span row (a, m); lane l owns columns 4l + 128q (q < 8).
template <typename TS>
__global__ void __launch_bounds__(32 * K3_WARPS)
k3_dspan(const float* __restrict__ obj, const int* __restrict__ am,
         const float* __restrict__ g, TS* __restrict__ dspan, int A, int M,
         int C, int R, int D) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * K3_WARPS + threadIdx.x / 32;
  if (row >= (long long)A * M) return;  // whole warp
  const long long a = row / M, m = row % M;
  float4 acc[K3_MAXQ];
#pragma unroll
  for (int q = 0; q < K3_MAXQ; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < C; c0 += 32) {
    // lane i holds g and am of image c0 + i; broadcast one at a time
    const int cl = c0 + lane;
    const long long gi = (a * C + cl) * M + m;
    const float gl = cl < C ? g[gi] : 0.f;
    const int al = cl < C ? am[gi] : 0;
    const int nc = min(32, C - c0);
    for (int i = 0; i < nc; ++i) {
      const float gv = __shfl_sync(0xffffffffu, gl, i);
      const int r = __shfl_sync(0xffffffffu, al, i);
      const float* orow = obj + ((long long)(c0 + i) * R + r) * D;
#pragma unroll
      for (int q = 0; q < K3_MAXQ; ++q) {
        const int d = 128 * q + 4 * lane;
        if (d < D) acc[q] = fma4(gv, load4(orow + d), acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < K3_MAXQ; ++q) {
    const int d = 128 * q + 4 * lane;
    if (d < D) store4(dspan + row * D + d, acc[q]);
  }
}

// ---------------------------------------------------------------- K4 ----

constexpr int K4_DS = 128;      // f32: D columns per block, 4 a lane
constexpr int K4_ROWS = 16;     // f32: span rows whose loads are in flight together

// f32 spans.  Grid: (D slices, image groups of G, row segments).  Dynamic
// shared memory: G * R * K4_DS floats.  Writes the segment's partial sums
// to out[segment] (C, R, D).  Rows go 32 at a time: lane i fetches the
// argmax and g of row base + i; then, K4_ROWS rows at a time, every lane
// loads its 4 columns of each row (all loads in flight together), and the
// updates run in row order with the argmax and g broadcast from their lane.
template <int G>
__global__ void __launch_bounds__(32 * G)
k4_dobj_f32(const float* __restrict__ span, const int* __restrict__ am,
            const float* __restrict__ g, float* __restrict__ out, int A, int M,
            int C, int R, int D, int segs) {
  extern __shared__ float4 acc_all[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.y * G + warp;
  const int d = blockIdx.x * K4_DS + 4 * lane;
  if (c >= C) return;  // whole warp; no barrier follows
  // this thread's accumulator column: acc[r * 32] for r < R
  float4* acc = acc_all + warp * R * 32 + lane;
  for (int r = 0; r < R; ++r) acc[r * 32] = make_float4(0.f, 0.f, 0.f, 0.f);

  const long long rows = (long long)A * M;
  const long long r0 = rows * blockIdx.z / segs;
  const long long r1 = rows * (blockIdx.z + 1) / segs;
  const bool dok = d < D;
  for (long long base = r0; base < r1; base += 32) {
    const long long ri = base + lane;
    int al = 0;
    float gl = 0.f;
    if (ri < r1) {
      const long long gi = ((ri / M) * C + c) * M + ri % M;
      al = am[gi];
      gl = g[gi];
    }
#pragma unroll
    for (int h = 0; h < 32; h += K4_ROWS) {
      float4 sv[K4_ROWS];
#pragma unroll
      for (int u = 0; u < K4_ROWS; ++u) {
        const long long row = base + h + u;
        sv[u] = (dok && row < r1) ? load4(span + row * D + d)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < K4_ROWS; ++u) {
        const int r = __shfl_sync(0xffffffffu, al, h + u);
        const float gv = __shfl_sync(0xffffffffu, gl, h + u);
        if (base + h + u < r1) acc[r * 32] = fma4(gv, sv[u], acc[r * 32]);
      }
    }
  }
  if (!dok) return;
  float* o = out + ((long long)blockIdx.z * C + c) * R * D + d;
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(o + (long long)r * D) = acc[r * 32];
}

// bf16 spans: the one-hot GEMM.  A block owns K4W_ROWS region rows (flat
// c * R + r) and K4W_BN columns of D; a stage holds a 64-row k tile of
// span (four 64-wide MN-major boxes, 32 KB) and the (argmax, g) pairs of
// those rows for the block's KI images.
constexpr int K4W_ROWS = 128;
constexpr int K4W_BN = 200;
constexpr int K4W_BK = 64;
constexpr int K4W_CHUNKS = 4;                       // 4 x 64 >= K4W_BN
constexpr int K4W_CHUNK_BYTES = K4W_BK * 128;
constexpr int K4W_B_BYTES = K4W_CHUNKS * K4W_CHUNK_BYTES;
constexpr int K4W_CONSUMERS = 256;
constexpr int K4W_THREADS = K4W_CONSUMERS + 32;
constexpr int kSmemBlock = 232448;                  // a block's shared memory

// images a block of K4W_ROWS region rows can touch
int k4_images(int C, int R) {
  const int ki = (K4W_ROWS - 1 + R - 1) / R + 1;
  return ki < C ? ki : C;
}
size_t k4_smem(int stages, int KI) {
  return (size_t)stages * (K4W_B_BYTES + KI * K4W_BK * 8) + 16 * stages + 1024;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Grid: (column tiles of K4W_BN, region-row tiles of K4W_ROWS, row
// segments).  Segment s walks k tiles [T s / segs, T (s + 1) / segs) of
// the T = ceil(A M / 64) tiles and writes its partial sums to out[s].
__global__ void __launch_bounds__(K4W_THREADS, 1)
k4_dobj_gemm(const __grid_constant__ CUtensorMap span_map,
             const int* __restrict__ am, const float* __restrict__ g,
             float* __restrict__ out, int A, int M, int C, int R, int D,
             int segs, int KI, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  int2* amg = reinterpret_cast<int2*>(smem + stages * K4W_B_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(amg + (size_t)stages * KI * K4W_BK);
  uint64_t* empty = full + stages;
  const long long rows = (long long)A * M;
  const int nrows = C * R;
  const int p0 = blockIdx.y * K4W_ROWS;
  const int cb = p0 / R;                     // the block's first image
  const int d0 = blockIdx.x * K4W_BN;
  const long long T = (rows + K4W_BK - 1) / K4W_BK;
  const int t0 = (int)(T * blockIdx.z / segs);
  const int t1 = (int)(T * (blockIdx.z + 1) / segs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 32);                  // producer lanes
      sm90::mbar_init(&empty[s], K4W_CONSUMERS / 32);  // consumer warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == K4W_CONSUMERS / 32) {  // producer warp
    int chunks = 0;                  // boxes with a column inside D
    while (chunks < K4W_CHUNKS && d0 + 64 * chunks < D) ++chunks;
    if (lane == 0) sm90::tma_prefetch_desc(&span_map);
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % stages;
      if (i >= stages) sm90::mbar_wait(&empty[s], (i / stages - 1) & 1);
      if (lane == 0) {
        sm90::mbar_expect_tx(&full[s], chunks * K4W_CHUNK_BYTES);
        for (int j = 0; j < chunks; ++j)
          sm90::tma_load_2d(smem + s * K4W_B_BYTES + j * K4W_CHUNK_BYTES,
                            &span_map, &full[s], d0 + 64 * j, t * K4W_BK);
      }
      // (argmax, g) of rows k = t * 64 + kk for images cb + ci, copied
      // asynchronously; rows past the end and images past C arrive as
      // zeros (g = 0: no contribution)
      int2* st = amg + (size_t)s * KI * K4W_BK;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = lane + 32 * half;
        const int k = t * K4W_BK + kk;
        const bool ok = k < rows;
        const int a = ok ? k / M : 0;
        const long long base = ((long long)a * C + cb) * M + (ok ? k - a * M : 0);
        for (int ci = 0; ci < KI; ++ci) {
          const bool in = ok && cb + ci < C;
          const long long off = in ? base + (long long)ci * M : 0;
          sm90::cp_async4(&st[ci * K4W_BK + kk].x, am + off, in ? 4 : 0);
          sm90::cp_async4(&st[ci * K4W_BK + kk].y, g + off, in ? 4 : 0);
        }
      }
      sm90::mbar_arrive_cp_async(&full[s]);
    }
    return;
  }

  // consumer: this thread's rows n[h] = p0 + 64 wg + 16 w + lane/4 + 8h
  const int wg = warp / 4, q = lane % 4;
  int ci[2], rr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = p0 + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * h;
    const bool ok = n < nrows;
    ci[h] = ok ? n / R - cb : 0;
    rr[h] = ok ? n % R : -2;                 // -2 matches no argmax
  }
  float acc[100];
#pragma unroll
  for (int i = 0; i < 100; ++i) acc[i] = 0.f;
  sm90::fence_regs(acc);
  // Wait for tile t, build its A fragments of W = g [am = r] in f (bf16
  // hi and lo terms; register 2e + h holds row h, k = 16j + 2q + 8e and
  // the next k), and issue its wgmmas as one group.
  auto issue = [&](uint32_t(&f)[2][4][4], int t) {
    const int i = t - t0, s = i % stages;
    sm90::mbar_wait(&full[s], (i / stages) & 1);
    const int2* st = amg + (size_t)s * KI * K4W_BK;
#pragma unroll
    for (int j = 0; j < K4W_BK / 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 16 * j + 2 * q + 8 * e;
          const int4 v = *reinterpret_cast<const int4*>(st + ci[h] * K4W_BK + kk);
          const float w0 = v.x == rr[h] ? __int_as_float(v.y) : 0.f;
          const float w1 = v.z == rr[h] ? __int_as_float(v.w) : 0.f;
          const float h0 = __bfloat162float(__float2bfloat16_rn(w0));
          const float h1 = __bfloat162float(__float2bfloat16_rn(w1));
          f[0][j][2 * e + h] = pack_bf16(h0, h1);
          f[1][j][2 * e + h] = pack_bf16(w0 - h0, w1 - h1);
        }
    const unsigned char* b = smem + s * K4W_B_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < K4W_BK / 16; ++j) {  // 16 k-rows = 2048 bytes
      const uint64_t db = sm90::desc_sw128(b + 2048 * j, K4W_CHUNK_BYTES, 1024);
      sm90::wgmma_m64n200_rs(acc, f[0][j], db, 1);
      sm90::wgmma_m64n200_rs(acc, f[1][j], db, 1);
    }
    sm90::wgmma_commit();
  };
  // tile t's stage is free once every consumer warp is past its wgmmas
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[(t - t0) % stages]);
  };
  // two fragment sets: tile t + 1's are built while tile t's wgmmas run
  uint32_t fa[2][4][4], fb[2][4][4];
  if (t0 < t1) {
    issue(fa, t0);
    int t = t0 + 1;
    for (; t + 1 < t1; t += 2) {
      issue(fb, t);
      sm90::wgmma_wait<1>();
      release(t - 1);
      issue(fa, t + 1);
      sm90::wgmma_wait<1>();
      release(t);
    }
    if (t < t1) {
      issue(fb, t);
      sm90::wgmma_wait<1>();
      release(t - 1);
      ++t;
    }
    sm90::wgmma_wait<0>();
    release(t - 1);
  }
  sm90::fence_regs(acc);

  float* o = out + (long long)blockIdx.z * nrows * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = p0 + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * h;
    if (n >= nrows) continue;
#pragma unroll
    for (int j = 0; j < K4W_BN / 8; ++j) {
      const int col = d0 + 8 * j + 2 * q;    // D % 8 == 0: col + 1 < D too
      if (col < D)
        *reinterpret_cast<float2*>(o + (long long)n * D + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// dobj[i] = sum over segments s, in order, of partial[s][i].
__global__ void k4_reduce(const float* __restrict__ partial,
                          float* __restrict__ dobj, long long n, int segs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = partial[i];
  for (int k = 1; k < segs; ++k) s += partial[(long long)k * n + i];
  dobj[i] = s;
}

unsigned tiles(long long x, long long tile) {
  return (unsigned)((x + tile - 1) / tile);
}

}  // namespace

extern "C" {

// span (A, M, D) and obj (C, R, D) in the same dtype (bf16 if bf16, else
// f32), contiguous; mx (A, C, M) f32, am (A, C, M) int32.  Needs
// D % 8 == 0, 1 <= R <= 144, and for bf16 16-byte-aligned span and obj.
int span_region_fwd(const void* span, const void* obj, float* mx, int* am,
                    int A, int M, int C, int R, int D, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > BN || D % 8) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)A * M;
  if (rows == 0 || C == 0) return 0;
  if (!bf16) {
    const dim3 grid(tiles(C, BN / R), tiles(rows, BM));
    if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    k2_fwd_f32<<<grid, NT, 0, st>>>(static_cast<const float*>(span),
                                    static_cast<const float*>(obj), mx, am, A,
                                    M, C, R, D);
    return (int)cudaGetLastError();
  }
  const dim3 grid(tiles(C, BN / R), tiles(rows, K2_ROWS));
  if (grid.y > 65535u || rows > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap span_map, obj_map;
  cudaError_t err = sm90_host::tensor_map_bf16(&span_map, span, rows, D, K2_ROWS, K2_BK);
  if (err == cudaSuccess)
    err = sm90_host::tensor_map_bf16(&obj_map, obj, (long long)C * R, D, BN, K2_BK);
  if (err != cudaSuccess) return (int)err;
  const auto kern = R == 36 ? k2_fwd_bf16<36> : k2_fwd_bf16<0>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemK2Bf16);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, K2_THREADS, kSmemK2Bf16, st>>>(span_map, obj_map, mx, am, A, M, C,
                                              R, D);
  return (int)cudaGetLastError();
}

// obj (C, R, D) f32; am (A, C, M) int32; g (A, C, M) f32; dspan (A, M, D)
// bf16 if bf16, else f32.  Needs D % 4 == 0 and D <= 1024.
int span_region_dspan(const float* obj, const int* am, const float* g,
                      void* dspan, int A, int M, int C, int R, int D, int bf16,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 || D > 128 * K3_MAXQ) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)A * M;
  if (rows == 0) return 0;
  const unsigned grid = tiles(rows, K3_WARPS);
  if (bf16)
    k3_dspan<__nv_bfloat16><<<grid, 32 * K3_WARPS, 0, st>>>(
        obj, am, g, static_cast<__nv_bfloat16*>(dspan), A, M, C, R, D);
  else
    k3_dspan<float><<<grid, 32 * K3_WARPS, 0, st>>>(
        obj, am, g, static_cast<float*>(dspan), A, M, C, R, D);
  return (int)cudaGetLastError();
}

// span (A, M, D) bf16 if bf16, else f32; am (A, C, M) int32; g (A, C, M)
// f32; partial (segs, C, R, D) f32 scratch (may be dobj when segs == 1);
// dobj (C, R, D) f32.  Needs D % 8 == 0 and for bf16 a 16-byte-aligned
// span.  The f32 kernel takes 4 images a block where their accumulators
// fit a block's shared memory, else 2 (ops/span_region.py mirrors this).
int span_region_dobj(const void* span, const int* am, const float* g,
                     float* partial, float* dobj, int A, int M, int C, int R,
                     int D, int segs, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (segs < 1 || segs > 65535 || R < 1 || R > BN || D % 8)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)C * R * D;
  const long long rows = (long long)A * M;
  if (n == 0) return 0;
  if (rows == 0) return (int)cudaMemsetAsync(dobj, 0, n * sizeof(float), st);
  float* out = segs == 1 ? dobj : partial;
  cudaError_t err;
  if (bf16) {
    if (rows > INT_MAX - K4W_BK || (long long)C * R > INT_MAX)
      return (int)cudaErrorInvalidConfiguration;
    const int KI = k4_images(C, R);
    int stages = 4;
    while (stages > 2 && k4_smem(stages, KI) > (size_t)kSmemBlock) --stages;
    const size_t smem = k4_smem(stages, KI);
    if (smem > (size_t)kSmemBlock) return (int)cudaErrorInvalidValue;
    const dim3 grid(tiles(D, K4W_BN), tiles((long long)C * R, K4W_ROWS),
                    (unsigned)segs);
    if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    CUtensorMap span_map;
    err = sm90_host::tensor_map_bf16(&span_map, span, rows, D,
                                     K4W_BK, 64);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(k4_dobj_gemm,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k4_dobj_gemm<<<grid, K4W_THREADS, smem, st>>>(span_map, am, g, out, A, M, C,
                                                  R, D, segs, KI, stages);
  } else {
    const bool four = (size_t)4 * R * K4_DS * sizeof(float) <= (size_t)kSmemBlock;
    const int G = four ? 4 : 2;
    const size_t smem = (size_t)G * R * K4_DS * sizeof(float);
    const dim3 grid(tiles(D, K4_DS), tiles(C, G), (unsigned)segs);
    const auto kern = four ? k4_dobj_f32<4> : k4_dobj_f32<2>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, 32 * G, smem, st>>>(static_cast<const float*>(span), am, g, out,
                                     A, M, C, R, D, segs);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (segs > 1) {
    k4_reduce<<<tiles(n, 256), 256, 0, st>>>(partial, dobj, n, segs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* span_region_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
