// Dense matmul, out[M, N] = x[M, K] @ y[K, N], all row-major: float32,
// and bf16 (bf16 x and y, float32 sums, bf16 out).
//
// Replaces the TPU kernel paddle_tpu/pallas/matmul.py:92 _matmul_impl
// (_mm_kernel :47), which walks a (M/bm, N/bn, K/bk) grid with a VMEM
// accumulator carried across the K steps and writes out in x's dtype.
// On Hopper the blocks run in parallel, so each block owns one output
// tile and loops over K itself, accumulating in registers.  Each instance
// has two engines, picked by shape.  float32 (kernels/matmul.py
// f32_engine, mirrored in ptt_matmul_f32):
// - wgmma in split TF32 (wgmma_tf32.cuh): M >= kWgmmaMinRows, K % 4 == 0,
//   N % 4 == 0, 16-byte-aligned x and y.  x split into hi and lo copies
//   and y split and transposed to (N, K) by a pass before the launch; a
//   128 x 128 tile (128 x 64 for N <= 64), three TF32 products a product
//   in fresh sums.  The transformer's products take it.
// - SIMT (tile_gemm.cuh gemm_tile): everything else, a 64 x 64 tile with
//   f32 FMA: the ResNet and serving fc, ragged and misaligned operands.
// bf16 (kernels/matmul.py bf16_engine, mirrored in ptt_matmul_bf16):
// - wgmma (wgmma_gemm.cuh): M >= kWgmmaMinRows, K % 8 == 0, N % 8 == 0,
//   16-byte-aligned x and y.  A 128 x 256 tile (narrower for N <= 128),
//   x and y fed by TMA through a 4-stage shared ring by a producer
//   warpgroup, two consumer warpgroups on wgmma.  The transformer's
//   products (8192 rows) take it.
// - mma.sync (tile_gemm.cuh gemm_tile_bf16): everything else, a 128 x 64
//   tile; the small-batch products (the ResNet fc at 256 rows, the
//   serving fc at 32 or fewer), where a 128 x 256 grid would hold a few
//   blocks for 132 SMs, and the ragged shapes TMA does not take.
//
// What bounds it on the H100: at the transformer's shapes (K 2048-8192)
// operations, 989 TFLOP/s bf16 on the tensor cores (f32: 67 TFLOP/s on
// the SIMT units, 495 / 3 in split TF32): the wgmma engines
// issue the card's asynchronous warpgroup products from shared memory,
// spend no consumer register or issue slot on loads, and bring x and y
// on chip in 128 x 256 tiles (85 flops per byte read, against 43 for the
// 128 x 64 tile).  At the serving and
// ResNet-50 fc (2048 -> 1000 at batch 32 or 256) the weight read
// dominates, so the bound is bytes (3.35 TB/s), but a 256-row problem
// runs only 32-64 blocks on 132 SMs, each walking all of K, so the
// mma.sync tile is latency-bound far above that; split-K is later work.
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"
#include "wgmma_tf32.cuh"

namespace {

// The least M the wgmma engines take (kernels/matmul.py WGMMA_MIN_ROWS).
constexpr int kWgmmaMinRows = 1024;

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

// Launch on `stream`; return cudaGetLastError() of the launch.  engine:
// 0 the SIMT tile (any shape; xs and ys unused), 1 the split-TF32 wgmma
// engine, with xs (2 M K floats) and ys (2 K N floats) its scratch for
// the split operands (refused with cudaErrorInvalidValue where the shape
// or alignment rule fails).
PTT_EXPORT int ptt_matmul_f32(const float* x, const float* y, float* out,
                              float* xs, float* ys, int M, int N, int K,
                              int engine, cudaStream_t stream) {
  if (engine == 1) {
    if (M < kWgmmaMinRows || !ptt::wg::tf32::takes(K, N, x, y, out, xs, ys))
      return static_cast<int>(cudaErrorInvalidValue);
    return ptt::wg::tf32::gemm_dense(x, y, xs, ys, out, M, N, K, stream);
  }
  if (engine != 0) return static_cast<int>(cudaErrorInvalidValue);
  matmul_f32_kernel<<<ptt::gemm_grid(M, N), ptt::kThreads, 0, stream>>>(
      x, y, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// engine: 0 the mma.sync tile (any shape), 1 the wgmma engine (refused
// with cudaErrorInvalidValue where the shape or alignment rule fails).
PTT_EXPORT int ptt_matmul_bf16(const ptt::bf16* x, const ptt::bf16* y,
                               ptt::bf16* out, int M, int N, int K,
                               int engine, cudaStream_t stream) {
  if (engine == 1) {
    if (M < kWgmmaMinRows || !ptt::wg::takes(K, N, x, y, out))
      return static_cast<int>(cudaErrorInvalidValue);
    return ptt::wg::gemm_dense(x, y, out, M, N, K, stream);
  }
  if (engine != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = ptt::gemm_grid_bf16(M, N);
  if (K % 8 == 0 && N % 8 == 0 && ptt::aligned16(x) && ptt::aligned16(y))
    matmul_bf16_kernel<true><<<grid, ptt::kThreads, 0, stream>>>(x, y, out,
                                                                 M, N, K);
  else
    matmul_bf16_kernel<false><<<grid, ptt::kThreads, 0, stream>>>(x, y, out,
                                                                  M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma instance for tile width bn (64, 128, 256): registers, spill
// bytes, static and dynamic shared memory into out[0..4).
PTT_EXPORT int ptt_matmul_wgmma_attributes(int bn, int* out) {
  return ptt::wg::attributes_bn<false>(bn, out);
}

// The same for the split-TF32 instance for tile width bn (64, 128).
PTT_EXPORT int ptt_matmul_wgmma_tf32_attributes(int bn, int* out) {
  return ptt::wg::tf32::attributes_bn<false>(bn, out);
}
