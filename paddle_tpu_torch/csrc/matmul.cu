// Dense float32 matmul, out[M, N] = x[M, K] @ y[K, N], all row-major.
//
// Replaces the TPU kernel paddle_tpu/pallas/matmul.py:92 _matmul_impl
// (_mm_kernel :47), which walks a (M/bm, N/bn, K/bk) grid with a VMEM
// accumulator carried across the K steps.  On Hopper the blocks run in
// parallel, so each block owns one 64 x 64 output tile and loops over K
// itself (tile_gemm.cuh), accumulating in registers with f32 FMA.
//
// What bounds it on the H100: at the serving shape (the fc 2048 -> 1000
// at batch 32) the 8 MB weight read dominates, so the bound is bytes
// (3.35 TB/s), but with 64 x 64 tiles a 32-row problem runs only 16
// blocks on 132 SMs, so this simple kernel is latency-bound far above
// that.  wgmma/TMA tiles and split-K are later work.
#include "tile_gemm.cuh"

namespace {

struct DenseA {
  const float* __restrict__ a;
  int M, K;
  int rows[4];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) rows[i] = ptt::a_row(i);
  }
  __device__ void prepare(int) {}
  __device__ float load(int i, int k) const {
    const int m = rows[i];
    return (m < M && k < K) ? a[static_cast<long long>(m) * K + k] : 0.f;
  }
};

__global__ void __launch_bounds__(ptt::kThreads)
    matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ out, int M, int N, int K) {
  DenseA a{x, M, K, {}};
  a.init();
  ptt::gemm_tile(a, y, out, M, N, K);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
PTT_EXPORT int ptt_matmul_f32(const float* x, const float* y, float* out,
                              int M, int N, int K, cudaStream_t stream) {
  matmul_f32_kernel<<<ptt::gemm_grid(M, N), ptt::kThreads, 0, stream>>>(
      x, y, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
