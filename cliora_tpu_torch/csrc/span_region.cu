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
// (A, C, M, R) scores never leave the block.  What bounds it: operations
// (2 A M C R D FLOP; at the contrastive call A=C=128, M=210, R=36, D=400
// that is 9.9e10 FLOP against 52.7 MB of compulsory traffic).
//  * Column tiles hold whole images: a block owns BM=64 span rows and the
//    BN=144 columns of CI = BN / R images (R=36: 4 images, no padding;
//    other R leave BN - CI*R zero columns).  R=36 is not a tile width, but
//    144 = 4 * 36 = 9 * 16 is both a whole number of images and of WMMA
//    tiles.
//  * f32 spans (the VG call): fp32 FMAs on the CUDA cores, no TF32, each
//    thread an 8 x 9 block of scores, 16-deep shared-memory stages with the
//    next stage's global loads in registers.
//  * bf16 spans (the contrastive call; obj is cast to bf16 by the
//    wrapper): the tensor cores through WMMA 16x16x16 with f32
//    accumulation, each of 4 warps a 16 x 144 strip, 32-deep stages.
//  * Epilogue: the f32 score tile goes to shared memory, and one thread per
//    (row, image) scans that image's R scores in order, keeping the first
//    max.  At init the image encoder is zero, every score ties at 0, and
//    the argmax is 0, as in the JAX package.
//
// K3.  The TPU multiplied a g-weighted one-hot (tile x C*R) by obj on the
// MXU.  Here each warp owns one span row (a, m) and gathers the argmax row
// obj[c, am] directly for c = 0, 1, ..., C-1 in that order, 4 columns a
// lane (16-byte loads), f32 accumulators in registers: deterministic by
// construction.  What bounds it: the gathered obj rows (A M C D floats,
// 5.5 GB at the contrastive call, read through L1/L2: obj itself is 7.4 MB),
// not the 2 A M C D FLOP.
//
// K4.  A scatter-add with no float atomics, so two calls on the same inputs
// give the same bits (the JAX package promises bitwise-exact resume).  A
// block owns G=4 images and a 128-wide slice of D, keeps their (G, R, 128)
// f32 accumulator in shared memory (74 KB at R=36), and walks a fixed
// segment of span rows in order: warp w handles image w, lane l columns
// 4l..4l+3, so every accumulator entry has one owner thread and no two
// threads race.  Walking all rows once per image would read the span C
// times; a group of G images reads it C/G times (from L2: 21.5 MB at the
// bf16 contrastive call).  The rows are cut into a shape-determined number
// of segments so the card is full; a second pass adds the segments'
// partial sums in segment order.  What bounds it: instructions per
// (row, image) update -- a load, a shared-memory read-modify-write -- so
// each moves 4 columns at once; not the FLOP, nor the bytes.
//
// g stays f32 in K3 and K4 (the Pallas backward rounds the weighted
// one-hot to bf16 before its matmuls; the port's plain backward, and the
// JAX package's einsum/chunked backward, do not), obj is read in f32 by K3,
// span in its own dtype by K4.
//
// Plain C interface, loaded with ctypes (ops/span_region.py).  The caller
// allocates every buffer; kernels run on the caller's stream; each launch
// is checked and the first error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

__device__ inline float load_f(const float* p) { return *p; }
__device__ inline float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// four consecutive values (16-byte / 8-byte aligned) as floats
__device__ inline float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ inline float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

constexpr int BM = 64;           // span rows per block
constexpr int BN = 144;          // region columns per block (whole images)
constexpr int NT = 128;          // threads per block
constexpr int CS = BN + 4;       // f32 score tile row stride

// f32 mainloop: 8 x 9 scores a thread, 8 row groups x 16 column groups
constexpr int FBK = 16;
constexpr int FTM = 8, FTN = 9;
constexpr int FA = BM * FBK / 4 / NT;                 // A float4s a thread
constexpr int FB = (BN * FBK / 4 + NT - 1) / NT;      // B float4s a thread
static_assert((BM / FTM) * (BN / FTN) == NT, "f32 thread tile");

// bf16 mainloop: 4 warps, each a 16 x 144 strip of 9 WMMA tiles
constexpr int HBK = 32;
constexpr int HS = HBK + 8;                           // bf16 tile row stride
constexpr int HA = BM * HBK / 8 / NT;                 // A 16-byte loads a thread
constexpr int HB = (BN * HBK / 8 + NT - 1) / NT;      // B 16-byte loads a thread
static_assert(BM == 16 * (NT / 32) && BN % 16 == 0, "bf16 warp tile");

constexpr int kSmemF32 = (FBK * BM + FBK * BN) * 4;
constexpr int kSmemBf16 = (BM * HS + BN * HS) * 2;
constexpr int kSmemScores = BM * CS * 4;
constexpr int kSmemK2 =
    kSmemScores > kSmemF32
        ? (kSmemScores > kSmemBf16 ? kSmemScores : kSmemBf16)
        : (kSmemF32 > kSmemBf16 ? kSmemF32 : kSmemBf16);

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

// The same product on the tensor cores: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mainloop_bf16(const __nv_bfloat16* __restrict__ span,
                                              const __nv_bfloat16* __restrict__ obj,
                                              const Tile& t, unsigned char* smem) {
  using namespace nvcuda;
  auto As = reinterpret_cast<__nv_bfloat16 (*)[HS]>(smem);               // [row][k]
  auto Bs = reinterpret_cast<__nv_bfloat16 (*)[HS]>(smem + BM * HS * 2);  // [col][k]
  const int warp = threadIdx.x / 32;
  const int r0 = warp * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(c[j], 0.f);

  uint4 ra[HA], rb[HB];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < HA; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int r = idx / 4, k = k0 + (idx % 4) * 8;
      const long long row = t.row0 + r;
      ra[j] = (row < t.rows && k < t.D)
                  ? *reinterpret_cast<const uint4*>(span + row * t.D + k)
                  : zero;
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int cc = idx / 4, k = k0 + (idx % 4) * 8;
      rb[j] = (idx < BN * HBK / 8 && cc < t.ncols && k < t.D)
                  ? *reinterpret_cast<const uint4*>(obj + (t.col0 + cc) * t.D + k)
                  : zero;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < HA; ++j) {
      const int idx = threadIdx.x + NT * j;
      *reinterpret_cast<uint4*>(&As[idx / 4][(idx % 4) * 8]) = ra[j];
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const int idx = threadIdx.x + NT * j;
      if (idx < BN * HBK / 8)
        *reinterpret_cast<uint4*>(&Bs[idx / 4][(idx % 4) * 8]) = rb[j];
    }
  };

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < t.D; k0 += HBK) {
    const bool more = k0 + HBK < t.D;
    if (more) fetch(k0 + HBK);
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[r0][kk], HS);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, &Bs[16 * j][kk], HS);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
  auto Cs = reinterpret_cast<float (*)[CS]>(smem);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(&Cs[r0][16 * j], c[j], CS, wmma::mem_row_major);
}

// Grid: (column tiles of CI images, row tiles of BM rows).
template <typename T>
__global__ void __launch_bounds__(NT)
k2_fwd(const T* __restrict__ span, const T* __restrict__ obj,
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
  if constexpr (std::is_same_v<T, float>)
    mainloop_f32(span, obj, t, smem);
  else
    mainloop_bf16(span, obj, t, smem);
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

constexpr int K4_G = 4;         // images per block, one a warp
constexpr int K4_DS = 128;      // D columns per block, 4 a lane
constexpr int K4_ROWS = 16;     // span rows whose loads are in flight together

// Grid: (D slices, image groups, row segments).  Dynamic shared memory:
// K4_G * R * K4_DS floats.  Writes the segment's partial sums to
// out[segment] (C, R, D).  Rows go 32 at a time: lane i fetches the argmax
// and g of row base + i; then, K4_ROWS rows at a time, every lane loads its
// 4 columns of each row (all loads in flight together), and the updates run
// in row order with the argmax and g broadcast from their lane.
template <typename TS>
__global__ void __launch_bounds__(32 * K4_G)
k4_dobj(const TS* __restrict__ span, const int* __restrict__ am,
        const float* __restrict__ g, float* __restrict__ out, int A, int M,
        int C, int R, int D, int segs) {
  extern __shared__ float4 acc_all[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.y * K4_G + warp;
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
// D % 8 == 0 and 1 <= R <= 144.
int span_region_fwd(const void* span, const void* obj, float* mx, int* am,
                    int A, int M, int C, int R, int D, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > BN || D % 8) return (int)cudaErrorInvalidValue;
  if (A * (long long)M == 0 || C == 0) return 0;
  const dim3 grid(tiles(C, BN / R), tiles((long long)A * M, BM));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  if (bf16)
    k2_fwd<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(span),
        static_cast<const __nv_bfloat16*>(obj), mx, am, A, M, C, R, D);
  else
    k2_fwd<float><<<grid, NT, 0, st>>>(static_cast<const float*>(span),
                                       static_cast<const float*>(obj), mx, am,
                                       A, M, C, R, D);
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
// dobj (C, R, D) f32.
int span_region_dobj(const void* span, const int* am, const float* g,
                     float* partial, float* dobj, int A, int M, int C, int R,
                     int D, int segs, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (segs < 1 || segs > 65535 || R < 1 || D % 4)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)C * R * D;
  if (n == 0) return 0;
  const size_t smem = (size_t)K4_G * R * K4_DS * sizeof(float);
  const dim3 grid(tiles(D, K4_DS), tiles(C, K4_G), (unsigned)segs);
  float* out = segs == 1 ? dobj : partial;
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(k4_dobj<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k4_dobj<__nv_bfloat16><<<grid, 32 * K4_G, smem, st>>>(
        static_cast<const __nv_bfloat16*>(span), am, g, out, A, M, C, R, D,
        segs);
  } else {
    err = cudaFuncSetAttribute(k4_dobj<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k4_dobj<float><<<grid, 32 * K4_G, smem, st>>>(
        static_cast<const float*>(span), am, g, out, A, M, C, R, D, segs);
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
