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
//  * f32 spans (the VG call, and the contrastive call of the f32 step):
//    k2_fwd_f32, fp32 FMAs on the CUDA cores, no TF32, each thread an 8 x 9
//    block of a 128-row tile, 16-deep shared-memory stages with the next
//    stage's loads in registers; its scores go to shared memory and one
//    thread per (row, image) scans them.  Each score is one fmaf chain over
//    D in order from 0, the order of torch's f32 GEMM, so the scores carry
//    its bits: the contrastive loss is a hinge on them, and its gradient
//    moves wherever a reordered sum moves a score across the margin (a
//    3xTF32 tensor-core route, closer to the exact scores than either,
//    turned the f32 step's gradient of the region encoder's bias away from
//    the reference route's).
//  At init the image encoder is zero, every score ties at 0, and the
//  argmax is 0, as in the JAX package.
//
// K3.  The TPU multiplied a g-weighted one-hot (tile x C*R) by obj on the
// MXU.  Here the gather is served from shared memory: k3_dspan.  A block
// of 128 threads owns a tile of 256 flat span rows and a 32-column slice
// of D, and walks its images in a 4-stage ring of cp.async copies: the
// image's R x 32 slice of obj (16-byte copies, one 128-byte row a region)
// and the tile's argmax and g (8-byte copies of two rows where M is even),
// the next images' copies in flight while the current one's gathers run.
// Each thread owns two rows and all eight column quads of each, in
// float4 accumulators; per row and image it reads the argmax and g once
// and then the region's eight quads, quad (t ^ s) % 8 at step s, so the
// eight lanes of a quarter warp read eight distinct bank groups whatever
// regions their rows gather: no bank conflicts and a time that does not
// depend on the argmax (all-ties argmax 0 at init included).  Each output
// sums its images in increasing order with one fmaf an image from 0, as
// the plain gather does; where the shape leaves too few blocks to fill
// the card (the VG call), the images are cut into a shape-determined
// number of segments, each block writes its segment's f32 partial sums,
// and segment_reduce adds them in segment order and rounds once to the
// span dtype.  No float atomics: two calls give the same bits.  What bounds
// it: shared-memory reads, 16 bytes per 4 FMAs (A M C D floats gathered,
// 5.5 GB at the contrastive call) and the staging writes beside them, not
// the 2 A M C D FLOP; staging re-reads obj once per row tile and the
// argmax and g once per D slice, from L2, where obj stays (7.4 MB).
//
// K4.  dobj = W . span as a GEMM over the A*M span rows, with
// W[c R + r, a M + m] = g[a, c, m] [am[a, c, m] = r] -- the TPU kernel's
// one-hot matmul.  No float atomics, so two calls on the same inputs give
// the same bits (the JAX package promises bitwise-exact resume): the rows
// are cut into a shape-determined number of fixed segments, each block
// writes its segment's partial sums, and segment_reduce adds them in
// segment order.
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
//  * f32 spans, R = 36 (the VG call, and the contrastive call of the f32
//    step): k4_dobj_regs, the argmax-routed sum with its accumulators in
//    registers.  A block owns 4 images and a 256-wide slice of D; each
//    image's 36 regions are dealt to 4 consumer warps of 9, a lane keeping
//    8 columns of each of its regions (72 floats).  A producer warp brings
//    32-row stages of the span slice by TMA and their argmax and g by
//    cp.async; a consumer warp finds its regions' rows of a stage by
//    ballots and applies each region's rows in increasing order, one fmaf
//    a row per entry, into the registers the unrolled region index names.
//    Stages are freed warp by warp, so uneven regions even out over the
//    ring.  The rows are cut into shape-determined segments (2 at both
//    calls: one wave of one block an SM).  What bounds it: the span slice
//    read from shared memory once per (row, image), 4 bytes per FMA, and
//    per stage and warp a ballot per region; all rows on one region (the
//    all-ties argmax of init) load one warp of each image with every row.
//  * f32 spans, other R: k4_dobj_f32, a scatter with one owner thread per
//    accumulator entry.  A block owns G images (4, or 2 where R is large)
//    and a 128-wide slice of D, keeps their (G, R, 128) f32 accumulator in
//    shared memory, and walks a row segment in order: warp w handles image
//    w, lane l columns 4l..4l+3.  What bounds it: instructions per (row,
//    image) update -- a load, a shared-memory read-modify-write.
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

// four consecutive entries of a row: 16 bytes of f32 or 8 of bf16 (each
// rounded to nearest even, as torch's .to())
__device__ inline void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ inline void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The second pass of K3 and K4 where they cut their sums into segments:
// out[i] = the TS rounding of the sum over segments s, in order, of
// partial[s][i] (partial is (segs, n) f32); four consecutive entries a
// thread, n % 4 == 0.
template <typename TS>
__global__ void segment_reduce(const float* __restrict__ partial,
                               TS* __restrict__ out, long long n, int segs) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 s = load4(partial + i);
  for (int k = 1; k < segs; ++k) {
    const float4 v = load4(partial + (long long)k * n + i);
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  store4(out + i, s);
}

// ---------------------------------------------------------------- K2 ----

constexpr int BN = 144;          // region columns per block (whole images)

// f32: 128 span rows a block, 256 threads of 8 x 9 scores, 16-deep stages
// (64-row blocks read obj's tile from L2 twice as often and ran longer at
// both calls: PERF.md section 6); the same FMA order either way
constexpr int BM = 128;
constexpr int NT = 256;
constexpr int CS = BN + 4;       // f32 score tile row stride
constexpr int FBK = 16;
constexpr int FTM = 8, FTN = 9;
constexpr int FA = BM * FBK / 4 / NT;                 // A float4s a thread
constexpr int FB = (BN * FBK / 4 + NT - 1) / NT;      // B float4s a thread
static_assert((BM / FTM) * (BN / FTN) == NT, "f32 thread tile");
constexpr int kSmemF32 = (FBK * BM + FBK * BN) * 4;
constexpr int kSmemScores = BM * CS * 4;
constexpr int kSmemK2 = kSmemScores > kSmemF32 ? kSmemScores : kSmemF32;

// Grid: (column tiles of CI images, row tiles of BM rows).  Dynamic shared
// memory: kSmemK2.  The block's operands: span rows [row0, row0 + BM) of
// the flat (A*M, D) span, region rows [col0, col0 + ncols) of the flat
// (C*R, D) obj; rows and columns past the end read as zero.  Each score
// is one fmaf chain over k = 0, 1, ..., D - 1 from 0.
__global__ void __launch_bounds__(NT, 1)
k2_fwd_f32(const float* __restrict__ span, const float* __restrict__ obj,
           float* __restrict__ mx, int* __restrict__ am, int A, int M, int C,
           int R, int D) {
  extern __shared__ float4 k2f_raw[];
  float* As = reinterpret_cast<float*>(k2f_raw);  // [k][row]
  float* Bs = As + FBK * BM;                      // [k][col]
  const int CI = BN / R;
  const int c0 = blockIdx.x * CI;
  const int nimg = min(CI, C - c0);
  const long long row0 = (long long)blockIdx.y * BM;
  const long long rows = (long long)A * M;
  const long long col0 = (long long)c0 * R;
  const int ncols = nimg * R;
  const int tx = threadIdx.x % (BN / FTN), ty = threadIdx.x / (BN / FTN);
  float acc[FTM][FTN];
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;

  // the next stage's loads wait in registers while this stage multiplies
  float4 ra[FA], rb[FB];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < FA; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int r = idx / 4, k = k0 + (idx % 4) * 4;
      const long long row = row0 + r;
      ra[j] = (row < rows && k < D)
                  ? *reinterpret_cast<const float4*>(span + row * D + k)
                  : zero;
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int c = idx / 4, k = k0 + (idx % 4) * 4;
      rb[j] = (idx < BN * FBK / 4 && c < ncols && k < D)
                  ? *reinterpret_cast<const float4*>(obj + (col0 + c) * D + k)
                  : zero;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < FA; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int r = idx / 4, k = (idx % 4) * 4;
      As[k * BM + r] = ra[j].x;
      As[(k + 1) * BM + r] = ra[j].y;
      As[(k + 2) * BM + r] = ra[j].z;
      As[(k + 3) * BM + r] = ra[j].w;
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      const int idx = threadIdx.x + NT * j;
      if (idx >= BN * FBK / 4) continue;
      const int c = idx / 4, k = (idx % 4) * 4;
      Bs[k * BN + c] = rb[j].x;
      Bs[(k + 1) * BN + c] = rb[j].y;
      Bs[(k + 2) * BN + c] = rb[j].z;
      Bs[(k + 3) * BN + c] = rb[j].w;
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += FBK) {
    const bool more = k0 + FBK < D;
    if (more) fetch(k0 + FBK);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * BM + ty * FTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * BM + ty * FTM + 4]);
      const float a[FTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[FTN];
#pragma unroll
      for (int j = 0; j < FTN; ++j) b[j] = Bs[kk * BN + tx * FTN + j];
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

  // the scores to shared memory (over the stage), then the segmented
  // max/argmax: one thread per (row, image), regions in order
  float* Cs = As;
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) Cs[(ty * FTM + i) * CS + tx * FTN + j] = acc[i][j];
  __syncthreads();
  for (int p = threadIdx.x; p < BM * nimg; p += NT) {
    const int r = p % BM, ci = p / BM;
    const long long row = row0 + r;
    if (row >= rows) continue;
    const float* sc = &Cs[r * CS + ci * R];
    float best = sc[0];
    int arg = 0;
    for (int q = 1; q < R; ++q)
      if (sc[q] > best) {
        best = sc[q];
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

constexpr int K3_THREADS = 128;
constexpr int K3_Q = 8;                          // column quads a slice
constexpr int K3_DS = 4 * K3_Q;                  // D columns a slice
constexpr int K3_KR = 2;                         // tile rows a thread
constexpr int K3_ROWS = K3_THREADS * K3_KR;      // tile rows (256)
constexpr int K3_STAGES = 4;

size_t k3_smem(int R) {
  return (size_t)K3_STAGES * (R * K3_Q * sizeof(float4) + K3_ROWS * 8) + 128;
}

// 8 bytes from global to shared, asynchronously; `bytes` 0 writes zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Grid: (D slices of K3_DS, row tiles of K3_ROWS, image segments).
// Dynamic shared memory: k3_smem(R), a ring of K3_STAGES stages, each an
// obj slice (R rows of K3_Q float4s, 128 bytes a row) and the tile's
// argmax and g.  Thread t owns tile rows t + 128 k (k < K3_KR), all K3_Q
// quads of each; at step s it reads quad (t ^ s) % 8, so the eight lanes
// of a quarter warp read eight distinct 16-byte bank groups whatever rows
// they gather.  EVEN (M even): argmax and g of two rows come in one 8-byte
// copy.  Segment z sums images [C z / segs, C (z + 1) / segs); with one
// segment it writes dspan, else its f32 partial sums to partial[z].
template <typename TS, bool EVEN>
__global__ void __launch_bounds__(K3_THREADS, 4)
k3_dspan(const float* __restrict__ obj, const int* __restrict__ am,
         const float* __restrict__ g, TS* __restrict__ dspan,
         float* __restrict__ partial, int A, int M, int C, int R, int D,
         int segs) {
  extern __shared__ float4 k3_smem_raw[];
  // 128-byte-aligned stages: a staged obj row is one pass over the banks
  float4* objs = reinterpret_cast<float4*>(
      (reinterpret_cast<uintptr_t>(k3_smem_raw) + 127) & ~uintptr_t(127));
  const int so = R * K3_Q;                  // float4s of an obj stage
  int* ams = reinterpret_cast<int*>(objs + K3_STAGES * so);
  float* gs = reinterpret_cast<float*>(ams + K3_STAGES * K3_ROWS);
  const int t = threadIdx.x, rho = t % K3_Q;
  const long long rows = (long long)A * M;
  const long long row0 = (long long)blockIdx.y * K3_ROWS;
  const int d0 = blockIdx.x * K3_DS;
  const int c0 = (int)((long long)C * blockIdx.z / segs);
  const int n = (int)((long long)C * (blockIdx.z + 1) / segs) - c0;

  // this thread stages tile rows 2t and 2t + 1: base is the offset of
  // row 2t's (a, 0, m) in g and am (-1 past the end), step the distance
  // to row 2t + 1's (1 within a span)
  static_assert(K3_ROWS == 2 * K3_THREADS, "two staged rows a thread");
  const long long srow = row0 + 2 * t;
  int base = -1, step = 1;
  if (srow < rows) {
    const int a = (int)(srow / M), m = (int)(srow % M);
    base = a * C * M + m;
    if (m + 1 == M) step = C * M - m;
  }
  const bool two = srow + 1 < rows;
  auto stage_in = [&](int c, int s) {
    float4* od = objs + s * so;
    const float* src = obj + (long long)c * R * D + d0;
    for (int e = t; e < so; e += K3_THREADS) {
      const int r = e / K3_Q, j = e % K3_Q;
      const bool ok = d0 + 4 * j < D;
      sm90::cp_async16(od + e, ok ? src + (long long)r * D + 4 * j : obj,
                       ok ? 16 : 0);
    }
    int* ad = ams + s * K3_ROWS + 2 * t;
    float* gd = gs + s * K3_ROWS + 2 * t;
    const int off = base >= 0 ? base + c * M : 0;
    if (EVEN) {  // both rows in one span, or both past the end
      cp_async8(ad, am + off, base >= 0 ? 8 : 0);
      cp_async8(gd, g + off, base >= 0 ? 8 : 0);
    } else {
      sm90::cp_async4(ad, am + off, base >= 0 ? 4 : 0);
      sm90::cp_async4(gd, g + off, base >= 0 ? 4 : 0);
      sm90::cp_async4(ad + 1, am + (two ? off + step : 0), two ? 4 : 0);
      sm90::cp_async4(gd + 1, g + (two ? off + step : 0), two ? 4 : 0);
    }
  };

  float4 acc[K3_KR][K3_Q];
#pragma unroll
  for (int k = 0; k < K3_KR; ++k)
#pragma unroll
    for (int s = 0; s < K3_Q; ++s) acc[k][s] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int p = 0; p < K3_STAGES - 1; ++p) {
    if (p < n) stage_in(c0 + p, p);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    // image i has landed for every thread, and every thread is past image
    // i - 1, whose stage the copy of image i + K3_STAGES - 1 reuses
    sm90::cp_async_wait<K3_STAGES - 2>();
    __syncthreads();
    if (i + K3_STAGES - 1 < n)
      stage_in(c0 + i + K3_STAGES - 1, (i + K3_STAGES - 1) % K3_STAGES);
    sm90::cp_async_commit();
    const int st = i % K3_STAGES;
    const float4* ob = objs + st * so;
#pragma unroll
    for (int k = 0; k < K3_KR; ++k) {
      const int r = ams[st * K3_ROWS + t + K3_THREADS * k];
      const float gv = gs[st * K3_ROWS + t + K3_THREADS * k];
      const float4* orow = ob + r * K3_Q;
#pragma unroll
      for (int s = 0; s < K3_Q; ++s) acc[k][s] = fma4(gv, orow[rho ^ s], acc[k][s]);
    }
  }

#pragma unroll
  for (int k = 0; k < K3_KR; ++k) {
    const long long row = row0 + t + K3_THREADS * k;
    if (row >= rows) continue;
#pragma unroll
    for (int s = 0; s < K3_Q; ++s) {
      const int d = d0 + 4 * (rho ^ s);
      if (d >= D) continue;
      if (segs == 1)
        store4(dspan + row * D + d, acc[k][s]);
      else
        *reinterpret_cast<float4*>(
            partial + ((long long)blockIdx.z * rows + row) * D + d) = acc[k][s];
    }
  }
}

// ---------------------------------------------------------------- K4 ----

constexpr int K4_DS = 128;      // f32: D columns per block, 4 a lane
constexpr int K4_ROWS = 16;     // f32: span rows whose loads are in flight together

// f32 spans, any R.  Grid: (D slices, image groups of G, row segments).  Dynamic
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

// f32 spans, R = K4R_R fixed at compile time (the model's 36):
// accumulators in registers.  A block owns K4R_G images and a
// K4R_DS-wide slice of D; each image's regions are dealt to K4R_R /
// K4R_RW consumer warps of K4R_RW regions each, and lane l of a warp
// keeps the float4 accumulators of columns 4l + 128 q (q < K4R_Q) of its
// regions in registers.  A
// producer warp fills a ring of K4R_STAGES stages: K4R_ROWS rows of the
// span slice by TMA and those rows' (argmax, g) for the block's images by
// cp.async (the rest of the producer warpgroup idles, to lend its
// registers).  Per stage a consumer warp takes its regions in turn: a ballot
// over the stage's rows (lane i holds row i's argmax) gives the rows of
// region k, which it applies in increasing order, two rows an iteration --
// one fmaf a row per accumulator entry, the register named by the
// unrolled k.  No branch on data picks a register.  Warps free a stage on
// their own, so their work evens out over the ring.
constexpr int K4R_R = 36;
constexpr int K4R_G = 4;
constexpr int K4R_Q = 2;
constexpr int K4R_DS = 128 * K4R_Q;
constexpr int K4R_ROWS = 32;
constexpr int K4R_STAGES = 6;
constexpr int K4R_RW = 9;            // regions a warp: 4 warps an image
static_assert(K4R_R % K4R_RW == 0, "whole region groups");
constexpr int K4R_CONSUMERS = 32 * K4R_G * (K4R_R / K4R_RW);
constexpr int K4R_THREADS = K4R_CONSUMERS + 128;  // + a producer warpgroup
constexpr int K4R_SPAN_BYTES = K4R_ROWS * K4R_DS * 4;
constexpr int K4R_STAGE_BYTES = K4R_SPAN_BYTES + K4R_G * K4R_ROWS * 8;
constexpr int kSmemK4R = K4R_STAGES * K4R_STAGE_BYTES + 2 * K4R_STAGES * 8 + 128;

// Grid: (D slices, image groups of K4R_G, row segments).  Segment z walks
// rows [A M z / segs, A M (z + 1) / segs) and writes its partial sums to
// out[z] (C, K4R_R, D).  Needs A M <= INT_MAX.  The launch bound caps a
// thread at 96 registers (65,536 over 640); the producer warpgroup, of
// which one warp works, hands its share to the consumers, whose 72
// accumulators need 112 (an SM sub-partition holds four consumer warps
// and one producer warp: 4 x 112 + 24 registers a lane).
__global__ void __launch_bounds__(K4R_THREADS, 1)
k4_dobj_regs(const __grid_constant__ CUtensorMap span_map,
             const int* __restrict__ am, const float* __restrict__ g,
             float* __restrict__ out, int A, int M, int C, int D, int segs) {
  constexpr int NG = K4R_R / K4R_RW;                 // warps an image
  constexpr int CONSUMERS = K4R_CONSUMERS;
  extern __shared__ unsigned char k4r_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(k4r_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K4R_STAGES * K4R_STAGE_BYTES);
  uint64_t* empty = full + K4R_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cb = blockIdx.y * K4R_G;
  const int d0 = blockIdx.x * K4R_DS;
  const int rows = A * M;
  const int r0 = (int)((long long)rows * blockIdx.z / segs);
  const int r1 = (int)((long long)rows * (blockIdx.z + 1) / segs);
  const int ntiles = (r1 - r0 + K4R_ROWS - 1) / K4R_ROWS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K4R_STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);                 // producer lanes
      sm90::mbar_init(&empty[s], CONSUMERS / 32);    // consumer warps
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (warp > CONSUMERS / 32) return;
    if (lane == 0) sm90::tma_prefetch_desc(&span_map);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % K4R_STAGES;
      if (i >= K4R_STAGES) sm90::mbar_wait(&empty[s], (i / K4R_STAGES - 1) & 1);
      unsigned char* st = smem + s * K4R_STAGE_BYTES;
      const int base = r0 + i * K4R_ROWS;
      if (lane == 0) {
        sm90::mbar_expect_tx(&full[s], K4R_SPAN_BYTES);
        sm90::tma_load_2d(st, &span_map, &full[s], d0, base);
      }
      // (argmax, g) of row base + lane for each image; past r1 and past
      // C they arrive as zeros
      int2* ad = reinterpret_cast<int2*>(st + K4R_SPAN_BYTES);
      const int row = base + lane;
      const long long rowoff = row < r1 ? (long long)(row / M) * C * M + row % M : 0;
#pragma unroll
      for (int ck = 0; ck < K4R_G; ++ck) {
        const bool ok = row < r1 && cb + ck < C;
        const long long off = ok ? rowoff + (long long)(cb + ck) * M : 0;
        sm90::cp_async4(&ad[ck * K4R_ROWS + lane].x, am + off, ok ? 4 : 0);
        sm90::cp_async4(&ad[ck * K4R_ROWS + lane].y, g + off, ok ? 4 : 0);
      }
      sm90::mbar_arrive_cp_async(&full[s]);
    }
    return;
  }

  sm90::setmaxnreg_inc<112>();
  const int ci = warp / NG, r0g = (warp % NG) * K4R_RW;  // image, first region
  const int c = cb + ci;
  float4 acc[K4R_RW][K4R_Q];
#pragma unroll
  for (int k = 0; k < K4R_RW; ++k)
#pragma unroll
    for (int q = 0; q < K4R_Q; ++q) acc[k][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % K4R_STAGES;
    sm90::mbar_wait(&full[s], (i / K4R_STAGES) & 1);
    const unsigned char* st = smem + s * K4R_STAGE_BYTES;
    if (c < C) {
      const float4* sp = reinterpret_cast<const float4*>(st) + lane;
      // lane kk: row kk's region relative to this warp's first (rows past
      // the segment are left out)
      const int2 v = reinterpret_cast<const int2*>(st + K4R_SPAN_BYTES)[ci * K4R_ROWS + lane];
      const int mine = i * K4R_ROWS + lane < r1 - r0 ? v.x - r0g : -1;
      const float gl = __int_as_float(v.y);
#pragma unroll
      for (int k = 0; k < K4R_RW; ++k) {
        // bit 31 - kk of `mask`: row kk is in region k; __clz finds the
        // lowest such row
        unsigned mask = __brev(__ballot_sync(0xffffffffu, mine == k));
        while (mask) {
          const int k0 = __clz(mask);
          mask ^= 0x80000000u >> k0;
          const bool two = mask != 0;
          const int k1 = two ? __clz(mask) : k0;
          if (two) mask ^= 0x80000000u >> k1;
          const float g0 = __shfl_sync(0xffffffffu, gl, k0);
          const float g1 = __shfl_sync(0xffffffffu, gl, k1);
          float4 s0[K4R_Q], s1[K4R_Q];
#pragma unroll
          for (int q = 0; q < K4R_Q; ++q) {
            s0[q] = sp[k0 * (K4R_DS / 4) + 32 * q];
            s1[q] = sp[k1 * (K4R_DS / 4) + 32 * q];
          }
#pragma unroll
          for (int q = 0; q < K4R_Q; ++q) acc[k][q] = fma4(g0, s0[q], acc[k][q]);
          if (two) {
#pragma unroll
            for (int q = 0; q < K4R_Q; ++q) acc[k][q] = fma4(g1, s1[q], acc[k][q]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
  if (c >= C) return;
  float* o = out + (((long long)blockIdx.z * C + c) * K4R_R + r0g) * D;
#pragma unroll
  for (int q = 0; q < K4R_Q; ++q) {
    const int d = d0 + 128 * q + 4 * lane;
    if (d >= D) continue;
#pragma unroll
    for (int k = 0; k < K4R_RW; ++k)
      *reinterpret_cast<float4*>(o + (long long)k * D + d) = acc[k][q];
  }
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

unsigned tiles(long long x, long long tile) {
  return (unsigned)((x + tile - 1) / tile);
}

// k3_dspan, and segment_reduce after it when the images are cut into
// segments
template <typename TS>
cudaError_t k3_launch(const float* obj, const int* am, const float* g,
                      float* partial, TS* dspan, int A, int M, int C, int R,
                      int D, int segs, cudaStream_t st) {
  const long long rows = (long long)A * M;
  const dim3 grid(tiles(D, K3_DS), tiles(rows, K3_ROWS), (unsigned)segs);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  const size_t smem = k3_smem(R);
  // two rows' argmax and g a copy where rows pair up within a span and
  // the copies stay 8-byte aligned
  const uintptr_t ag = reinterpret_cast<uintptr_t>(am) | reinterpret_cast<uintptr_t>(g);
  const bool even = M % 2 == 0 && ag % 8 == 0;
  const auto kern = even ? k3_dspan<TS, true> : k3_dspan<TS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, K3_THREADS, smem, st>>>(obj, am, g, dspan, partial, A, M, C, R,
                                        D, segs);
  if ((err = cudaGetLastError()) != cudaSuccess || segs == 1) return err;
  const long long n = rows * D;
  segment_reduce<TS><<<tiles(n / 4, 256), 256, 0, st>>>(partial, dspan, n, segs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// span (A, M, D) and obj (C, R, D) in the same dtype (bf16 if bf16, else
// f32), contiguous; mx (A, C, M) f32, am (A, C, M) int32.  Needs
// D % 8 == 0, 1 <= R <= 144, and 16-byte-aligned span and obj.
int span_region_fwd(const void* span, const void* obj, float* mx, int* am,
                    int A, int M, int C, int R, int D, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > BN || D % 8) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)A * M;
  if (rows == 0 || C == 0) return 0;
  if (!bf16) {
    const dim3 grid(tiles(C, BN / R), tiles(rows, BM));
    if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(
        k2_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemK2);
    if (err != cudaSuccess) return (int)err;
    k2_fwd_f32<<<grid, NT, kSmemK2, st>>>(static_cast<const float*>(span),
                                          static_cast<const float*>(obj), mx,
                                          am, A, M, C, R, D);
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

// obj (C, R, D) f32, 16-byte aligned; am (A, C, M) int32; g (A, C, M) f32;
// partial (segs, A, M, D) f32 scratch (unused when segs == 1); dspan
// (A, M, D) bf16 if bf16, else f32.  Needs D % 8 == 0, 1 <= R <= 144 and
// 1 <= segs <= max(C, 1).
int span_region_dspan(const float* obj, const int* am, const float* g,
                      float* partial, void* dspan, int A, int M, int C, int R,
                      int D, int segs, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > BN || D % 8 || segs < 1 || segs > (C > 1 ? C : 1) ||
      segs > 65535)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)A * M;
  if (rows == 0 || D == 0) return 0;
  if ((long long)A * C * M > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  if (bf16)
    return (int)k3_launch(obj, am, g, partial,
                          static_cast<__nv_bfloat16*>(dspan), A, M, C, R, D,
                          segs, st);
  return (int)k3_launch(obj, am, g, partial, static_cast<float*>(dspan), A, M,
                        C, R, D, segs, st);
}

// span (A, M, D) bf16 if bf16, else f32, 16-byte aligned; am (A, C, M)
// int32; g (A, C, M) f32; partial (segs, C, R, D) f32 scratch (may be dobj
// when segs == 1); dobj (C, R, D) f32.  Needs D % 8 == 0.  f32 spans take
// k4_dobj_regs where R == 36, else k4_dobj_f32 with 4 images a block where
// their accumulators fit a block's shared memory, else 2
// (ops/span_region.py mirrors this).
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
  } else if (R == K4R_R) {
    if (rows > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid(tiles(D, K4R_DS), tiles(C, K4R_G), (unsigned)segs);
    if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
    CUtensorMap span_map;
    err = sm90_host::tensor_map_f32(&span_map, span, rows, D, K4R_ROWS, K4R_DS);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(k4_dobj_regs,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemK4R);
    if (err != cudaSuccess) return (int)err;
    k4_dobj_regs<<<grid, K4R_THREADS, kSmemK4R, st>>>(span_map, am, g, out, A,
                                                      M, C, D, segs);
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
    segment_reduce<float><<<tiles(n / 4, 256), 256, 0, st>>>(partial, dobj, n,
                                                          segs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// Phase markers of the train step (training/trainer.py:_mark): empty
// kernels whose names show in a device trace where a step's forward,
// backward and update begin and where the step ends.  Launched on the
// caller's stream, they are captured into a CUDA graph with the step.
__global__ void cliora_mark_forward() {}
__global__ void cliora_mark_backward() {}
__global__ void cliora_mark_update() {}
__global__ void cliora_mark_end() {}

// phase 0..3: forward, backward, update, end.
int cliora_mark(int phase, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: cliora_mark_forward<<<1, 1, 0, st>>>(); break;
    case 1: cliora_mark_backward<<<1, 1, 0, st>>>(); break;
    case 2: cliora_mark_update<<<1, 1, 0, st>>>(); break;
    case 3: cliora_mark_end<<<1, 1, 0, st>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* span_region_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
