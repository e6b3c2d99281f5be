// Stride-1 float32 convolution over NHWC images, as an implicit GEMM:
//   out[N, OH, OW, O] = sum over (kh, kw, c) of
//                       x[n, oh + kh - pad, ow + kw - pad, c] * w[kh, kw, c, O]
// with OH = H + 2 pad - KH + 1 (the SAME extent for pad = KH / 2).
//
// Replaces the TPU kernel paddle_tpu/pallas/conv.py:161 _conv_fwd_impl
// (_fwd_kernel :103).  That kernel pads x in HBM (jnp.pad) and walks a
// (batch block, output row, kh) grid, adding KW shifted row products
// into a VMEM accumulator.  Here the GEMM view is
//   M = N * OH * OW output pixels, N_gemm = O, K = KH * KW * C,
//   A[m, k] = x at the pixel m shifted by (kh, kw), channel c,
//   B = w flattened to (KH * KW * C, O), which is w's own memory layout,
// and A is gathered straight from x with a bounds check instead of a
// padded copy: rows outside the image read as zero.  One 64 x 64 output
// tile per block (tile_gemm.cuh), f32 FMA accumulation over K.
//
// What bounds it on the H100: at the ResNet-50 shapes each conv does
// 2 * M * O * K flops on a few MB of data, so the bound is operations.
// This kernel runs on the f32 SIMT units (67 TFLOP/s peak), with no
// tensor cores and no overlap of loads and math; wgmma/TMA tiles and a
// cp.async pipeline are later work.
#include "tile_gemm.cuh"

namespace {

struct ConvA {
  const float* __restrict__ x;
  int H, W, C, KW, pad, OH, OW, M, K;
  // per row slot: the output pixel (n, oh, ow), or n = -1 past M
  int n[4], oh[4], ow[4];
  // per K step: this thread's (kh, kw, c), kh = -1 past K
  int kh, kw, c;

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ptt::a_row(i);
      if (m < M) {
        const int pix = m % (OH * OW);
        n[i] = m / (OH * OW);
        oh[i] = pix / OW;
        ow[i] = pix % OW;
      } else {
        n[i] = -1;
        oh[i] = ow[i] = 0;
      }
    }
  }
  __device__ void prepare(int k) {
    if (k >= K) {
      kh = -1;
      return;
    }
    c = k % C;
    const int r = k / C;
    kw = r % KW;
    kh = r / KW;
  }
  __device__ float load(int i, int) const {
    if (n[i] < 0 || kh < 0) return 0.f;
    const int ih = oh[i] + kh - pad;
    const int iw = ow[i] + kw - pad;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return 0.f;
    return x[((static_cast<long long>(n[i]) * H + ih) * W + iw) * C + c];
  }
};

__global__ void __launch_bounds__(ptt::kThreads)
    conv2d_nhwc_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out, int N, int H, int W,
                           int C, int KH, int KW, int O, int pad, int OH,
                           int OW) {
  const int M = N * OH * OW;
  const int K = KH * KW * C;
  ConvA a{x, H, W, C, KW, pad, OH, OW, M, K, {}, {}, {}, 0, 0, 0};
  a.init();
  ptt::gemm_tile(a, w, out, M, O, K);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
PTT_EXPORT int ptt_conv2d_nhwc_f32(const float* x, const float* w, float* out,
                                   int N, int H, int W, int C, int KH, int KW,
                                   int O, int pad, cudaStream_t stream) {
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  conv2d_nhwc_f32_kernel<<<ptt::gemm_grid(N * OH * OW, O), ptt::kThreads, 0,
                           stream>>>(x, w, out, N, H, W, C, KH, KW, O, pad,
                                     OH, OW);
  return static_cast<int>(cudaGetLastError());
}
