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
//    kernel's grouping: relu(dot_l + dot_r + b0), and l M in f32.
//  * The TPU kernel kept one block of sentences' whole chart in VMEM; one
//    sentence's chart at n=20, D=400 does not fit the 227 KB of shared
//    memory a Hopper block has, so this version launches per level and
//    keeps the chart in device memory (the B=128 chart is 43 MB in f32,
//    21.5 MB in bf16, about the 50 MB L2).  Per call: weight prep,
//    leaves and the leaves' projection, then per level fc0, fc1, combine
//    and (below the root) project: 4n - 2 launches.
//  * project and fc1 are one tiled GEMM: 128x64 block tile, 8x4 outputs
//    per thread, 32-deep shared-memory stages with the next stage's
//    global loads in registers while the current one is multiplied.
//    Every global load is 16 bytes a thread and coalesced (D must be a
//    multiple of 4): A rows along k, weights pre-stored k-major by
//    prep_weights.
//    fc0 forms h1 = relu(P_l + P_r + b0) from the children's projections
//    (an elementwise pass; a GEMM loader that built it on the fly held
//    too many loads in flight per thread and ran fc1 at half the speed).
//    The column tiles of one row tile are neighbours in the grid, so
//    they run together and share its A rows through L2.  combine runs
//    one block per target cell.
//  * In f32 the GEMMs run as fp32 FMAs on the CUDA cores: that is the
//    contract (no TF32: backpointers must equal the plain version's).  In
//    bf16 the chart and the matmul operands are rounded to bf16 and the
//    GEMM tiles are multiplied on the tensor cores (WMMA, f32
//    accumulation), the numerics of the TPU kernel.  Every reduction runs
//    in a fixed order (no atomics), so results repeat from run to run.
//
// Plain C interface, loaded with ctypes (ops/inside_cky.py).  The caller
// allocates every buffer; kernels run on the caller's stream; each launch
// is checked and the first error code is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // rows per GEMM tile
constexpr int BN = 64;   // output columns per GEMM tile
constexpr int BK = 32;   // reduction depth per shared-memory stage
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int NT = 256;  // threads per GEMM block: (BM/TM) * (BN/TN)
constexpr int AQ = BM * BK / (4 * NT);  // A float4s each thread loads a stage
constexpr int WQ = BN * BK / (4 * NT);  // W float4s each thread loads a stage
constexpr int CT = 128;  // threads per combine block (power of two)

static_assert((BM / TM) * (BN / TN) == NT, "thread tile");
static_assert(AQ == 4 && WQ == 2 && BK == 32 && BN == 64, "tile loader");

__host__ __device__ inline long long level_offset(int n, int level) {
  const long long rem = n - level;
  return (long long)n * (n + 1) / 2 - rem * (rem + 1) / 2;
}

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

template <typename T> __device__ inline T store_t(float x);
template <> __device__ inline float store_t<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 store_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// a float32 value as the compute dtype holds it
template <typename T> __device__ inline float round_t(float x) {
  const T v = store_t<T>(x);
  return load_f(&v);
}

// One stage of a 128x64 GEMM tile as this thread loads it: AQ float4s of
// A (rows a_row(j), k a_k..a_k+3) and WQ float4s of W (k rows w_k(j),
// columns w_col..w_col+3).  Every load is 16 bytes a thread and a warp's
// loads are contiguous: 8 lanes cover the 32 k of one A row, 16 lanes the
// 64 columns of one W row (W is stored k-major).  load_a(row, k) and
// load_w(k, col) return 4 values; K and the column count are multiples of
// 4, so a float4 is wholly inside or wholly outside an operand.
struct Stage {
  float4 a[AQ], w[WQ];
};

__device__ inline int a_row(int j) {
  return (threadIdx.x / 32) * 4 + (threadIdx.x % 32) / 8 + 32 * j;
}
__device__ inline int a_k() { return (threadIdx.x % 8) * 4; }
__device__ inline int w_k(int j) { return threadIdx.x / 16 + 16 * j; }
__device__ inline int w_col() { return (threadIdx.x % 16) * 4; }

template <typename LoadA, typename LoadW>
__device__ __forceinline__ void fetch(Stage& st, int k0, int K,
                                      const LoadA& load_a,
                                      const LoadW& load_w) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ka = k0 + a_k();
#pragma unroll
  for (int j = 0; j < AQ; ++j) st.a[j] = ka < K ? load_a(a_row(j), ka) : zero;
#pragma unroll
  for (int j = 0; j < WQ; ++j) {
    const int k = k0 + w_k(j);
    st.w[j] = k < K ? load_w(k, w_col()) : zero;
  }
}

// acc[TM][TN] = A[BM rows, K] * W[K, BN cols] for this thread's 8x4
// sub-tile, fp32 FMAs on the CUDA cores.  A sits in shared memory
// row-major, W k-major, so the inner loop reads A as float4 over k and W
// as float4 over columns.  The next stage's loads are in registers while
// the current stage multiplies.  Each output sums its k in order.
constexpr int AS = BK + 4;  // f32 A tile row stride (16-byte rows)

template <typename LoadA, typename LoadW>
__device__ __forceinline__ void tile_gemm(int K, const LoadA& load_a,
                                          const LoadW& load_w,
                                          unsigned char* smem,
                                          float (&acc)[TM][TN]) {
  auto As = reinterpret_cast<float (*)[AS]>(smem);
  auto Ws = reinterpret_cast<float (*)[BN]>(smem + BM * AS * sizeof(float));
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  Stage st;
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < AQ; ++j)
      *reinterpret_cast<float4*>(&As[a_row(j)][a_k()]) = st.a[j];
#pragma unroll
    for (int j = 0; j < WQ; ++j)
      *reinterpret_cast<float4*>(&Ws[w_k(j)][w_col()]) = st.w[j];
  };
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  fetch(st, 0, K, load_a, load_w);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(st, k0 + BK, K, load_a, load_w);  // in flight meanwhile
#pragma unroll
    for (int kc = 0; kc < BK; kc += 4) {
      float w[4][TN];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&Ws[kc + q][tx * TN]);
        w[q][0] = v.x;
        w[q][1] = v.y;
        w[q][2] = v.z;
        w[q][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(&As[ty * TM + i][kc]);
        const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[q], w[q][j], acc[i][j]);
      }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
}

// The bf16 mainloop: the same loads, tiles and output layout as
// tile_gemm, but the tiles are held in bf16 and multiplied on the tensor
// cores (WMMA 16x16x16, f32 accumulation), each warp owning a 32x32 block
// of the 128x64 tile.  The accumulators go through shared memory into
// acc[TM][TN] so both mainloops share their epilogues.
constexpr int AB = BK + 8;  // bf16 A tile row stride (16-byte rows)
constexpr int WB = BN + 8;  // bf16 W tile row stride
constexpr int CS = BN + 4;  // f32 accumulator tile row stride

__device__ inline uint2 pack_bf16(float4 v) {  // exact for bf16 values
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi));
}

template <typename LoadA, typename LoadW>
__device__ __forceinline__ void tile_gemm_tc(int K, const LoadA& load_a,
                                             const LoadW& load_w,
                                             unsigned char* smem,
                                             float (&acc)[TM][TN]) {
  using namespace nvcuda;
  auto As = reinterpret_cast<__nv_bfloat16 (*)[AB]>(smem);
  auto Ws = reinterpret_cast<__nv_bfloat16 (*)[WB]>(
      smem + BM * AB * sizeof(__nv_bfloat16));
  auto Cs = reinterpret_cast<float (*)[CS]>(smem);
  const int warp = threadIdx.x / 32;
  const int r0 = (warp / 2) * 32, c0 = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  Stage st;
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < AQ; ++j)
      *reinterpret_cast<uint2*>(&As[a_row(j)][a_k()]) = pack_bf16(st.a[j]);
#pragma unroll
    for (int j = 0; j < WQ; ++j)
      *reinterpret_cast<uint2*>(&Ws[w_k(j)][w_col()]) = pack_bf16(st.w[j]);
  };
  fetch(st, 0, K, load_a, load_w);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(st, k0 + BK, K, load_a, load_w);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[r0 + 16 * i][kk], AB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Ws[kk][c0 + 16 * j], WB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[r0 + 16 * i][c0 + 16 * j], c[i][j], CS,
                              wmma::mem_row_major);
  __syncthreads();
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Cs[ty * TM + i][tx * TN + j];
}

// Shared memory of one GEMM block, by compute dtype.
template <typename T>
constexpr int kGemmSmem =
    std::is_same_v<T, float>
        ? (BM * AS + BK * BN) * (int)sizeof(float)
        : (BM * CS * (int)sizeof(float) >
                   (BM * AB + BK * WB) * (int)sizeof(__nv_bfloat16)
               ? BM * CS * (int)sizeof(float)
               : (BM * AB + BK * WB) * (int)sizeof(__nv_bfloat16));

// f32 on the CUDA cores, bf16 on the tensor cores.
template <typename T, typename LoadA, typename LoadW>
__device__ __forceinline__ void gemm(int K, const LoadA& load_a,
                                     const LoadW& load_w, unsigned char* smem,
                                     float (&acc)[TM][TN]) {
  if constexpr (std::is_same_v<T, float>)
    tile_gemm(K, load_a, load_w, smem, acc);
  else
    tile_gemm_tc(K, load_a, load_w, smem, acc);
}

// Weights rounded to the compute dtype and stored k-major for the GEMMs:
// wp[k, 0:3D] = [W0[:, :D]^T, W0[:, D:]^T, M] (the projection), w1t = W1^T.
template <typename T>
__global__ void prep_weights(const float* __restrict__ w0,
                             const float* __restrict__ w1,
                             const float* __restrict__ mat,
                             float* __restrict__ wp, float* __restrict__ w1t,
                             int D) {
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
    wp[i] = round_t<T>(w);
  } else if (i < np + (long long)D * D) {
    const long long j = i - np;
    const int k = (int)(j / D), o = (int)(j % D);
    w1t[j] = round_t<T>(w1[(long long)o * D + k]);
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

// P[cell, 0:3D] = [W0[:, :D] h, W0[:, D:] h, h M] for the B * (n - level)
// cells of ``level``.  Grid: (ceil(3D / BN), row tiles).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
project(const T* __restrict__ chart, const float* __restrict__ wp,
        float* __restrict__ P, int n, int D, int level, int B) {
  __shared__ __align__(128) unsigned char smem[kGemmSmem<T>];
  __shared__ long long cell_of[BM];  // flat cell of each tile row, -1 = pad
  const int L = n - level;
  const int R = B * L;
  const long long NC = (long long)n * (n + 1) / 2;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (threadIdx.x < BM) {
    const int r = row0 + threadIdx.x;
    cell_of[threadIdx.x] =
        r < R ? (r / L) * NC + level_offset(n, level) + r % L : -1;
  }
  __syncthreads();
  float acc[TM][TN];
  gemm<T>(
      D,
      [&](int r, int kk) {
        const long long c = cell_of[r];
        return c < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : load4(chart + c * D + kk);
      },
      [&](int kk, int c) {
        const int o = col0 + c;
        return o < 3 * D ? load4(wp + (long long)kk * 3 * D + o)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      },
      smem, acc);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long c = cell_of[ty * TM + i];
    if (c < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = col0 + tx * TN + j;
      if (o < 3 * D) P[c * 3 * D + o] = acc[i][j];
    }
  }
}

// h1[r] = relu(P_l[:D] + P_r[D:2D] + b0) in the compute dtype, one block
// per level row r = (b * L + p) * N + k: target (level, p) of sentence
// b, split k.
template <typename T>
__global__ void __launch_bounds__(CT)
fc0(const float* __restrict__ P, const float* __restrict__ b0,
    T* __restrict__ h1, int n, int D, int level) {
  const int N = level, L = n - level;
  const long long NC = (long long)n * (n + 1) / 2;
  const long long r = blockIdx.x;
  const int k = (int)(r % N), p = (int)(r / N % L);
  const long long cb = r / N / L * NC;
  const float* pl = P + (cb + level_offset(n, k) + p) * 3 * D;
  const float* pr = P + (cb + level_offset(n, level - k - 1) + p + k + 1) * 3 * D + D;
  for (int d = threadIdx.x; d < D; d += CT)
    h1[r * D + d] = store_t<T>(fmaxf(pl[d] + pr[d] + b0[d], 0.f));
}

// hk[rows] = relu(h1 W1^T + b1).  Grid: (ceil(D / BN), row tiles).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
fc1(const T* __restrict__ h1, const float* __restrict__ w1t,
    const float* __restrict__ b1, T* __restrict__ hk, int D, int R) {
  __shared__ __align__(128) unsigned char smem[kGemmSmem<T>];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
  gemm<T>(
      D,
      [&](int r, int kk) {
        const int row = row0 + r;
        return row < R ? load4(h1 + (long long)row * D + kk)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      },
      [&](int kk, int c) {
        const int o = col0 + c;
        return o < D ? load4(w1t + (long long)kk * D + o)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      },
      smem, acc);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = col0 + tx * TN + j;
      if (o < D)
        hk[(long long)r * D + o] = store_t<T>(fmaxf(acc[i][j] + b1[o], 0.f));
    }
  }
}

// One block per target cell t = b * L + p: split scores (the bilinear dot
// (l M) . r, one warp per split), softmax, CKY, weighted sum of hk, unit
// norm, written into the chart.  Dynamic shared memory: 2N split floats,
// D floats of h, CT floats of reduction buffer.
template <typename T>
__global__ void __launch_bounds__(CT)
combine(T* __restrict__ chart, float* __restrict__ s, float* __restrict__ val,
        int* __restrict__ bp, const T* __restrict__ hk,
        const float* __restrict__ P, int n, int D, int level, int unit_norm) {
  extern __shared__ float sm[];
  __shared__ float z_sh;
  const int N = level, L = n - level;
  float* sk = sm;            // split scores, then exp(s_k - max)
  float* pk = sm + N;        // CKY candidates v_l + v_r + s_k
  float* hv = sm + 2 * N;    // aggregated h
  float* red = hv + D;
  const long long NC = (long long)n * (n + 1) / 2;
  const long long t = blockIdx.x;
  const int p = (int)(t % L);
  const long long cb = (t / L) * NC;
  const int lane = threadIdx.x % 32;

  for (int k = threadIdx.x / 32; k < N; k += CT / 32) {
    const long long lc = cb + level_offset(n, k) + p;
    const long long rc = cb + level_offset(n, level - k - 1) + p + k + 1;
    const float* lm = P + lc * 3 * D + 2 * D;  // l M of the left child
    const T* r = chart + rc * D;
    float bil = 0.f;
    for (int d = lane; d < D; d += 32) bil = fmaf(lm[d], load_f(r + d), bil);
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
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += CT) {
    float acc = 0.f;
    for (int k = 0; k < N; ++k)
      acc += load_f(hk + (t * N + k) * D + d) * sk[k];
    const float h = acc / z;
    hv[d] = h;
    ss += h * h;
  }
  float inv = 1.f;
  if (unit_norm) {
    red[threadIdx.x] = ss;
    __syncthreads();
    for (int w = CT / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
      __syncthreads();
    }
    inv = 1.f / sqrtf(fmaxf(red[0], 1e-16f));
  }
  for (int d = threadIdx.x; d < D; d += CT)
    chart[tc * D + d] = store_t<T>(hv[d] * inv);
}

unsigned tiles(long long x, int tile) { return (unsigned)((x + tile - 1) / tile); }

template <typename T>
int run(const float* h0, const float* w0, const float* b0, const float* w1,
        const float* b1, const float* mat, T* chart, float* s, float* val,
        int* bp, float* P, T* h1, T* hk, float* wp, float* w1t, int B, int n,
        int D, int unit_norm, cudaStream_t stream) {
  prep_weights<T><<<tiles(4LL * D * D, 256), 256, 0, stream>>>(w0, w1, mat,
                                                               wp, w1t, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long leaves = (long long)B * n * D;
  init_leaves<T><<<tiles(leaves, 256), 256, 0, stream>>>(h0, chart, s, val,
                                                          bp, B, n, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  project<T><<<dim3(tiles(3 * D, BN), tiles(B * n, BM)), NT, 0, stream>>>(
      chart, wp, P, n, D, 0, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int level = 1; level < n; ++level) {
    const int L = n - level;
    const int R = B * L * level;
    fc0<T><<<(unsigned)R, CT, 0, stream>>>(P, b0, h1, n, D, level);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fc1<T><<<dim3(tiles(D, BN), tiles(R, BM)), NT, 0, stream>>>(h1, w1t, b1,
                                                                hk, D, R);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t smem = (size_t)(2 * level + D + CT) * sizeof(float);
    combine<T><<<(unsigned)(B * L), CT, smem, stream>>>(
        chart, s, val, bp, hk, P, n, D, level, unit_norm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (level < n - 1) {  // the root is nobody's child
      project<T><<<dim3(tiles(3 * D, BN), tiles(B * L, BM)), NT, 0, stream>>>(
          chart, wp, P, n, D, level, B);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// h0 (B, n, D) f32; w0 (D, 2D), b0 (D), w1 (D, D), b1 (D), mat (D, D)
// f32; chart (B, ncells, D) in the compute dtype; s, val (B, ncells) f32;
// bp (B, ncells) int32; P (B, ncells, 3D) f32; h1, hk (rows, D) in the
// compute dtype, rows = B * max_level (n - level) * level; wp (D, 3D) and
// w1t (D, D) f32 scratch for the k-major weights.
int inside_cky_forward(const float* h0, const float* w0, const float* b0,
                       const float* w1, const float* b1, const float* mat,
                       void* chart, float* s, float* val, int* bp, float* P,
                       void* h1, void* hk, float* wp, float* w1t, int B, int n,
                       int D, int bf16, int unit_norm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(
        h0, w0, b0, w1, b1, mat, static_cast<__nv_bfloat16*>(chart), s, val,
        bp, P, static_cast<__nv_bfloat16*>(h1),
        static_cast<__nv_bfloat16*>(hk), wp, w1t, B, n, D, unit_norm, st);
  return run<float>(h0, w0, b0, w1, b1, mat, static_cast<float*>(chart), s,
                    val, bp, P, static_cast<float*>(h1),
                    static_cast<float*>(hk), wp, w1t, B, n, D, unit_norm, st);
}

const char* inside_cky_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
