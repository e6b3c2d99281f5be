// One float32 tile of C[M, N] = A[M, K] @ B[K, N], tiled through shared
// memory, shared by the matmul and the implicit-GEMM convolution.
//
// A block of 256 threads owns a 64 x 64 tile of C and walks K in steps
// of 16.  Each step stages a 64 x 16 slab of A and a 16 x 64 slab of B
// in shared memory; each thread then accumulates a 4 x 4 sub-tile with
// fmaf, rows ty + 16 i and columns tx + 16 j, so a warp's shared-memory
// reads are broadcasts (A) or 16 consecutive words (B).  Everything
// outside [0, M) x [0, K) x [0, N) is read as zero and never stored: any
// M, K, N works, the ragged edge is masked.
//
// B is row-major with leading dimension N.  A comes from a loader, so
// one tile engine serves a dense matrix (matmul.cu) and a gathered
// implicit-GEMM view of an NHWC image (conv.cu).  A loader has
//   __device__ void prepare(int k);         // this thread's column k
//   __device__ float load(int i, int k);    // row slot i in 0..3
// Each thread always loads the same column offset (tid % 16) of the A
// slab for the same four rows (tid / 16 + 16 i), so a loader can do its
// per-row index work once per block and its per-column work once per K
// step.
#pragma once

#include "common.cuh"

namespace ptt {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

// Row of C (and of A) that row slot i of an A-loading thread covers.
__device__ __forceinline__ int a_row(int i) {
  return blockIdx.x * kBM + static_cast<int>(threadIdx.x) / kBK + 16 * i;
}

template <class ALoader>
__device__ __forceinline__ void gemm_tile(ALoader& a,
                                          const float* __restrict__ B,
                                          float* __restrict__ C, int M, int N,
                                          int K) {
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
}

// Grid of a gemm_tile launch: M tiles on x (up to 2^31 - 1 blocks), N
// tiles on y.
inline dim3 gemm_grid(int M, int N) {
  return dim3((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
}

}  // namespace ptt
