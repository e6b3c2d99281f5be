// One tile of C[M, N] = A[M, K] @ B[K, N], tiled through shared memory,
// shared by the matmul and the implicit-GEMM convolution, in two
// instances picked by the element type of B and C:
//
// float: a block of 256 threads owns a 64 x 64 tile of C and walks K in
// steps of 16.  Each step stages a 64 x 16 slab of A and a 16 x 64 slab
// of B in shared memory; each thread then accumulates a 4 x 4 sub-tile
// with fmaf, rows ty + 16 i and columns tx + 16 j, so a warp's
// shared-memory reads are broadcasts (A) or 16 consecutive words (B).
//
// bf16 (__nv_bfloat16 A and B, float sums, C stored as bf16;
// gemm_tile_bf16) runs what the wgmma engine (wgmma_gemm.cuh) does not
// take: the matmul below 1024 rows (the ResNet and serving fc), K or N
// not a multiple of 8, the conv at C % 64 != 0 (C = 3, 20), operands off
// 16-byte alignment and the fused conv + BN statistics; its MmaTile is
// also the filter gradient's (conv_dw.cu).  A block of 256 threads owns
// a 128 x 64 tile of C and walks K in steps of 32 on the tensor cores.
// Each step's slabs (A 128 x 32, B 32 x 64) are loaded as vectors of 8
// bf16, one 16-byte load each where the shape and alignment allow
// (kVec), into registers while the previous step's products run, then
// stored to the other of two shared buffers: one barrier a step.  The 8
// warps each own a 32 x 32 piece of C (warp w: rows 32 (w % 4), columns
// 32 (w / 4)) and issue eight mma.sync.m16n8k16 bf16 products with f32
// accumulators per 16 of K, their fragments read with ldmatrix (B, and
// the filter gradient's A, transposed on the way).  Slab rows are padded
// by 8 bf16 (16 bytes), so the 8 row addresses of each ldmatrix fall in
// distinct banks.
//
// Everything outside [0, M) x [0, K) x [0, N) is read as zero and never
// stored: any M, K, N works, the ragged edge is masked.
//
// B is row-major with leading dimension N.  A comes from a loader, so
// one tile engine serves a dense matrix (matmul.cu) and a gathered
// implicit-GEMM view of an NHWC image (conv.cu).  An f32 loader has
//   __device__ void prepare(int k);         // this thread's column k
//   __device__ float load(int i, int k);    // row slot i in 0..3
// Each thread always loads the same column offset (tid % 16) of the A
// slab for the same four rows (tid / 16 + 16 i), so a loader can do its
// per-row index work once per block and its per-column work once per K
// step.  The bf16 loaders work the same way on vectors of 8 columns (see
// gemm_tile_bf16).
//
// With kStats, the block also writes the per-column sum and sum of
// squares of its f32 accumulator tile (before any rounding to C's type)
// to row blockIdx.x of psum / psq (each gridDim.x x N): the BN
// statistics epilogue of the fused conv.  The block reduces its rows in
// a fixed order, without atomics.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace ptt {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row of C (and of A) that row slot i of an A-loading thread covers.
__device__ __forceinline__ int a_row(int i) {
  return blockIdx.x * kBM + static_cast<int>(threadIdx.x) / kBK + 16 * i;
}

// The f32 engine.
template <bool kStats, class ALoader>
__device__ __forceinline__ void gemm_tile(ALoader& a,
                                          const float* __restrict__ B,
                                          float* __restrict__ C, int M, int N,
                                          int K, float* __restrict__ psum,
                                          float* __restrict__ psq) {
  // +1 column: the A slab is written column-wise (k fixed per thread),
  // so without padding a warp's 32 stores hit 2 banks.
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ak = tid % kBK;   // this thread's column of the A slab
  const int am = tid / kBK;   // its first row; rows am + 16 i
  const int bn = tid % kBN;   // this thread's column of the B slab
  const int bk = tid / kBN;   // its first row; rows bk + 4 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    a.prepare(k0 + ak);
#pragma unroll
    for (int i = 0; i < 4; ++i) As[ak][am + 16 * i] = a.load(i, k0 + ak);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + bk + 4 * i;
      const int n = n0 + bn;
      Bs[bk + 4 * i][bn] =
          (k < K && n < N) ? B[static_cast<long long>(k) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[static_cast<long long>(m) * N + n] = acc[i][j];
    }
  }

  if constexpr (kStats) {
    // rows past M hold exact zeros (A read as zero): they add nothing
    __shared__ float red[2][16][kBN];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s += acc[i][j];
        q = fmaf(acc[i][j], acc[i][j], q);
      }
      red[0][ty][tx + 16 * j] = s;
      red[1][ty][tx + 16 * j] = q;
    }
    __syncthreads();
    if (tid < kBN && n0 + tid < N) {
      float s = 0.f, q = 0.f;
      for (int r = 0; r < 16; ++r) {
        s += red[0][r][tid];
        q += red[1][r][tid];
      }
      const long long o = static_cast<long long>(blockIdx.x) * N + n0 + tid;
      psum[o] = s;
      psq[o] = q;
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 engine: a 128 x 64 block tile, K steps of 32, mma.sync.m16n8k16
// ---------------------------------------------------------------------------

constexpr int kHM = 128;        // block rows
constexpr int kHN = 64;         // block columns
constexpr int kHK = 32;         // K step
constexpr int kLdA = kHK + 8;   // As[m][k] row: 40 bf16 (80 bytes)
constexpr int kLdAT = kHM + 8;  // AsT[k][m] row: 136 bf16 (272 bytes)
constexpr int kLdB = kHN + 8;   // Bs[k][n] row: 72 bf16 (144 bytes)

// 8 bf16 values (as their bits), the unit every bf16 slab is loaded and
// stored in.
union Vec8 {
  uint4 u;
  unsigned short s[8];
};

__device__ __forceinline__ Vec8 vec8_zero() {
  Vec8 v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  return v;
}

// A warp's 32 x 32 piece of the block's 128 x 64 tile (warp w: rows
// 32 (w % 4), columns 32 (w / 4)), as 2 x 4 m16n8 accumulators.  Lane
// (g = lane / 4, t = lane % 4) holds, for m16 tile i and n8 tile j,
// c[i][j][0..1] at (row 16 i + g, columns 8 j + 2t, 2t + 1) and
// c[i][j][2..3] at row 16 i + g + 8.
struct MmaTile {
  float c[2][4][4];
  int wm, wn, lane;

  __device__ void init() {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wm = (warp % 4) * 32;
    wn = (warp / 4) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
  }

  // One K step of 32 from Bs[k][n] and As[m][k] (kATrans: AsT[k][m]).
  template <bool kATrans>
  __device__ void step(const bf16* As, const bf16* Bs) {
    const int r = lane % 8;
    const int q = lane / 8;
#pragma unroll
    for (int kk = 0; kk < kHK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + 16 * i;
        if constexpr (kATrans)
          ldsm_x4<true>(a[i],
                        As + (kk + r + 8 * (q / 2)) * kLdAT + m + 8 * (q % 2));
        else
          ldsm_x4<false>(a[i],
                         As + (m + r + 8 * (q % 2)) * kLdA + kk + 8 * (q / 2));
      }
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t t4[4];
        ldsm_x4<true>(t4, Bs + (kk + r + 8 * (q % 2)) * kLdB + wn + 16 * h +
                              8 * (q / 2));
        b[2 * h][0] = t4[0];
        b[2 * h][1] = t4[1];
        b[2 * h + 1][0] = t4[2];
        b[2 * h + 1][1] = t4[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(c[i][j], a[i], b[j]);
    }
  }

  // Stores the tile at (m0, n0) of the row-major M x N matrix C as T.
  template <class T>
  __device__ void store(T* __restrict__ C, int m0, int n0, int M,
                        int N) const {
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * i + g + 8 * h;
          if (m >= M) continue;
          T* row = C + static_cast<long long>(m) * N;
          if (n < N) row[n] = from_f32<T>(c[i][j][2 * h]);
          if (n + 1 < N) row[n + 1] = from_f32<T>(c[i][j][2 * h + 1]);
        }
      }
  }

  // Per-column sum and sum of squares of the block's 128 x 64 tile into
  // row blockIdx.x of psum / psq (all 256 threads must call it).  Lanes
  // of one t add their rows by a fixed butterfly, the four row-warps'
  // partials meet in shared memory in a fixed order.
  __device__ void stats(float* __restrict__ psum, float* __restrict__ psq,
                        int n0, int N) const {
    __shared__ float red[2][4][kHN];
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s += c[i][j][e] + c[i][j][2 + e];
          q = fmaf(c[i][j][e], c[i][j][e], q);
          q = fmaf(c[i][j][2 + e], c[i][j][2 + e], q);
        }
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (g == 0) {
          red[0][wm / 32][wn + 8 * j + 2 * t + e] = s;
          red[1][wm / 32][wn + 8 * j + 2 * t + e] = q;
        }
      }
    }
    __syncthreads();
    const int tid = threadIdx.x;
    if (tid < kHN && n0 + tid < N) {
      const float s = ((red[0][0][tid] + red[0][1][tid]) + red[0][2][tid]) +
                      red[0][3][tid];
      const float q = ((red[1][0][tid] + red[1][1][tid]) + red[1][2][tid]) +
                      red[1][3][tid];
      const long long o = static_cast<long long>(blockIdx.x) * N + n0 + tid;
      psum[o] = s;
      psq[o] = q;
    }
  }
};

// B[k0 .. k0 + 31][n0 .. n0 + 63] of a row-major K x N bf16 matrix, as
// 256 vectors of 8: thread t's is row t / 8, columns 8 (t % 8).  kVec: N %
// 8 == 0 and B 16-byte aligned, so a vector in bounds is one 16-byte load.
template <bool kVec>
__device__ __forceinline__ Vec8 load_b(const bf16* __restrict__ B, int k0,
                                       int n0, int K, int N) {
  const int k = k0 + static_cast<int>(threadIdx.x) / 8;
  const int n = n0 + 8 * (static_cast<int>(threadIdx.x) % 8);
  Vec8 v = vec8_zero();
  if (k >= K) return v;
  const bf16* p = B + static_cast<long long>(k) * N + n;
  if constexpr (kVec) {
    if (n < N) v.u = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (n + e < N) v.s[e] = __bfloat16_as_ushort(p[e]);
  }
  return v;
}

__device__ __forceinline__ void store_b(bf16* Bs, const Vec8& v) {
  const int t = threadIdx.x;
  *reinterpret_cast<uint4*>(Bs + (t / 8) * kLdB + 8 * (t % 8)) = v.u;
}

// Row of C (and of A) that A-vector slot i (0 or 1) of this thread covers
// in the bf16 engine, and its first column within the K step.
__device__ __forceinline__ int a_row_h(int i) {
  return blockIdx.x * kHM + static_cast<int>(threadIdx.x) / 4 + 64 * i;
}
__device__ __forceinline__ int a_col_h() {
  return 8 * (static_cast<int>(threadIdx.x) % 4);
}

// The bf16 engine: bf16 A (from the loader) and B, f32 sums, C in bf16.
// A bf16 loader has
//   __device__ void prepare(int k);     // this thread's first column
//   __device__ Vec8 load(int i);        // slot i's 8 values from there
// for rows a_row_h(i), columns k .. k + 7 (k = k0 + a_col_h()).  The
// slabs are double-buffered: the next K step's global loads are issued
// before this step's products and stored after them, one barrier a step.
template <bool kStats, bool kVec, class ALoader>
__device__ __forceinline__ void gemm_tile_bf16(
    ALoader& a, const bf16* __restrict__ B, bf16* __restrict__ C, int M,
    int N, int K, float* __restrict__ psum, float* __restrict__ psq) {
  __shared__ __align__(16) bf16 As[2][kHM * kLdA];
  __shared__ __align__(16) bf16 Bs[2][kHK * kLdB];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kHM;
  const int n0 = blockIdx.y * kHN;
  const int ar = tid / 4;
  const int ac = a_col_h();

  MmaTile tile;
  tile.init();
  Vec8 av[2], bv;
  a.prepare(ac);
  av[0] = a.load(0);
  av[1] = a.load(1);
  bv = load_b<kVec>(B, 0, n0, K, N);
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kHK) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&As[buf][(ar + 64 * i) * kLdA + ac]) =
          av[i].u;
    store_b(Bs[buf], bv);
    __syncthreads();
    if (k0 + kHK < K) {
      a.prepare(k0 + kHK + ac);
      av[0] = a.load(0);
      av[1] = a.load(1);
      bv = load_b<kVec>(B, k0 + kHK, n0, K, N);
    }
    tile.step<false>(As[buf], Bs[buf]);
    buf ^= 1;
  }
  tile.store(C, m0, n0, M, N);
  if constexpr (kStats) tile.stats(psum, psq, n0, N);
}

// Grid of a gemm_tile launch: M tiles on x (up to 2^31 - 1 blocks), N
// tiles on y.
inline dim3 gemm_grid(int M, int N) {
  return dim3((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
}
inline dim3 gemm_grid_bf16(int M, int N) {
  return dim3((M + kHM - 1) / kHM, (N + kHN - 1) / kHN);
}

}  // namespace ptt
