// Dense matmul, out[M, N] = x[M, K] @ y[K, N], all row-major: float32,
// and bf16 (bf16 x and y, float32 sums, bf16 out).
//
// Replaces the TPU kernel paddle_tpu/pallas/matmul.py:92 _matmul_impl
// (_mm_kernel :47), which walks a (M/bm, N/bn, K/bk) grid with a VMEM
// accumulator carried across the K steps and writes out in x's dtype.
// On Hopper the blocks run in parallel, so each block owns one output
// tile and loops over K itself (tile_gemm.cuh), accumulating in
// registers: 64 x 64 with f32 FMA for float32, 128 x 64 with mma.sync
// bf16 tensor-core products for bf16.
//
// What bounds it on the H100: at the serving and ResNet-50 shapes (the
// fc 2048 -> 1000 at batch 32 or 256) the weight read dominates, so the
// bound is bytes (3.35 TB/s; half of them in bf16), but a 256-row
// problem runs only 32-64 blocks on 132 SMs, each walking all of K, so
// this kernel is latency-bound far above that.  Split-K and wgmma/TMA
// tiles are later work.
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

// The bf16 engine's A: rows a_row_h(i), 8 columns from k.  kVec: K % 8 ==
// 0 and x 16-byte aligned, so a group in bounds is one 16-byte load.
template <bool kVec>
struct DenseA8 {
  const ptt::bf16* __restrict__ a;
  int M, K;
  int k;

  __device__ void prepare(int k_) { k = k_; }
  __device__ ptt::Vec8 load(int i) const {
    ptt::Vec8 v = ptt::vec8_zero();
    const int m = ptt::a_row_h(i);
    if (m >= M || k >= K) return v;
    const ptt::bf16* p = a + static_cast<long long>(m) * K + k;
    if constexpr (kVec) {
      v.u = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k + e < K) v.s[e] = __bfloat16_as_ushort(p[e]);
    }
    return v;
  }
};

__global__ void __launch_bounds__(ptt::kThreads)
    matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ out, int M, int N, int K) {
  DenseA a{x, M, K, {}};
  a.init();
  ptt::gemm_tile<false>(a, y, out, M, N, K, nullptr, nullptr);
}

template <bool kVec>
__global__ void __launch_bounds__(ptt::kThreads)
    matmul_bf16_kernel(const ptt::bf16* __restrict__ x,
                       const ptt::bf16* __restrict__ y,
                       ptt::bf16* __restrict__ out, int M, int N, int K) {
  DenseA8<kVec> a{x, M, K, 0};
  ptt::gemm_tile_bf16<false, kVec>(a, y, out, M, N, K, nullptr, nullptr);
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() of the launch.
PTT_EXPORT int ptt_matmul_f32(const float* x, const float* y, float* out,
                              int M, int N, int K, cudaStream_t stream) {
  matmul_f32_kernel<<<ptt::gemm_grid(M, N), ptt::kThreads, 0, stream>>>(
      x, y, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

PTT_EXPORT int ptt_matmul_bf16(const ptt::bf16* x, const ptt::bf16* y,
                               ptt::bf16* out, int M, int N, int K,
                               cudaStream_t stream) {
  const dim3 grid = ptt::gemm_grid_bf16(M, N);
  if (K % 8 == 0 && N % 8 == 0 && ptt::aligned16(x) && ptt::aligned16(y))
    matmul_bf16_kernel<true><<<grid, ptt::kThreads, 0, stream>>>(x, y, out,
                                                                 M, N, K);
  else
    matmul_bf16_kernel<false><<<grid, ptt::kThreads, 0, stream>>>(x, y, out,
                                                                  M, N, K);
  return static_cast<int>(cudaGetLastError());
}
