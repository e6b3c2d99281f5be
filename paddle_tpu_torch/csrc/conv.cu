// Stride-1 convolution over NHWC images, as an implicit GEMM:
//   out[N, OH, OW, O] = sum over (kh, kw, c) of
//                       x[n, oh + kh - pad, ow + kw - pad, c] * w[kh, kw, c, O]
// with OH = H + 2 pad - KH + 1 (the SAME extent for pad = KH / 2), in
// float32 and in bf16 (bf16 x and w, float32 sums, bf16 out), and the
// fused conv + BN-statistics forward of either: out plus the per-channel
// batch mean and biased variance of the float32 sums over (N, OH, OW).
//
// Replaces the TPU kernel paddle_tpu/pallas/conv.py:161 _conv_fwd_impl
// (_fwd_kernel :103), and its with_stats form, conv2d_bn_stats_nhwc
// (:288, epilogue :149-155).  That kernel pads x in HBM (jnp.pad) and
// walks a (batch block, output row, kh) grid, adding KW shifted row
// products into a VMEM accumulator; with_stats adds each flushed f32
// block's column sums into two (1, O) outputs revisited by every grid
// step, so its grid runs sequentially.  Here the GEMM view is
//   M = N * OH * OW output pixels, N_gemm = O, K = KH * KW * C,
//   A[m, k] = x at the pixel m shifted by (kh, kw), channel c,
//   B = w flattened to (KH * KW * C, O), which is w's own memory layout,
// and A is gathered straight from x with a bounds check instead of a
// padded copy: rows outside the image read as zero.  One output tile per
// block (tile_gemm.cuh): 64 x 64 with f32 FMA for float32; 128 x 64 with
// mma.sync bf16 tensor-core products and f32 accumulators for bf16, A
// gathered 8 channels (16 bytes) at a time when C % 8 == 0, the next K
// step's loads in flight during this step's products.  The statistics:
// each block writes its tile's column sum and sum of squares of the f32
// accumulators, before rounding, to row (M tile) of an f32 scratch of
// (M tiles) x O, and a second launch adds the rows in a fixed order in
// double: no atomics, the same statistics from run to run.
//
// The float32 instance has two engines, by shape (kernels/conv.py
// f32_engine, mirrored in ptt_conv2d_nhwc_f32):
// - wgmma in split TF32 (wgmma_tf32.cuh): C % 32 == 0, O % 4 == 0,
//   16-byte-aligned x and w, any M.  x split into hi and lo copies and w
//   split and transposed to (O, KH * KW * C) by a pass before the launch
//   (for the backward-input the pass also flips the forward's filter and
//   swaps its channels, so the wrapper makes no flipped copy); A by TMA
//   for a 1 x 1 conv, else gathered, a 32-wide K step inside one tap.
//   Every stride-1 conv of ResNet-50 takes it, forward and backward-input.
// - SIMT (tile_gemm.cuh gemm_tile): everything else (C = 1, 3, 20, views
//   off alignment) and the fused conv + BN statistics.
// The bf16 instance has two engines, by shape (kernels/conv.py
// bf16_engine, mirrored in ptt_conv2d_nhwc_bf16):
// - wgmma (wgmma_gemm.cuh): C % 64 == 0, O % 8 == 0, 16-byte-aligned x
//   and w, any M.  A 128 x BN tile (BN = O rounded up to 64, at most
//   256), wgmma products from a shared ring that a producer warpgroup
//   keeps full: w by TMA; A by TMA for a 1 x 1 conv (x is then a dense
//   (M, C) matrix), else gathered with 16-byte cp.async copies, a 64-wide
//   K step inside one tap, halo pixels zero-filled.  Every stride-1 conv
//   of ResNet-50 takes it, forward and backward-input (C, O in {64, ...,
//   2048}).
// - mma.sync (tile_gemm.cuh gemm_tile_bf16): everything else (C = 3, C =
//   20, views off alignment) and the fused conv + BN statistics.
//
// What bounds it on the H100 (bf16: 989 TFLOP/s on the tensor cores,
// 3.35 TB/s): operations for the 3 x 3 convs at 7 x 7 to 28 x 28 and
// the 1 x 1 convs at 7 x 7; bytes for the 1 x 1 convs at 14 x 14 and
// larger and the 3 x 3 conv at 56 x 56, where each conv does 2 * M * O * K
// flops on a few MB of data and K is 64-1024; float32 by operations (67
// TFLOP/s on the SIMT units, 495 / 3 in split TF32) but for the 1 x 1
// convs at 56 x 56.  The wgmma engine issues the asynchronous warpgroup
// products the card's rate needs, spends no consumer register on loads,
// and keeps up to 8 stages in flight so the byte-bound shapes stream;
// the 1 x 1 convs at 56 x 56 (K 64: one stage a tile) gain least.  The
// f32 SIMT kernel stages every K step of 16 through shared memory with
// scalar gathers and two barriers.  The statistics scratch is (M tiles)
// * O * 8 bytes, small beside out.
#include <type_traits>

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"
#include "wgmma_tf32.cuh"

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

// The bf16 engine's A: slot i is output pixel a_row_h(i), and a column
// group of 8 is (kh, kw, c .. c + 7).  kVec: C % 8 == 0 and x 16-byte
// aligned, so a group shares (kh, kw) and is one 16-byte load of 8
// channels; otherwise each of the 8 columns is found and read alone.
template <bool kVec>
struct ConvA8 {
  const ptt::bf16* __restrict__ x;
  int H, W, C, KW, pad, OH, OW, M, K;
  int n[2], oh[2], ow[2];
  // this thread's first column of the K step, and (kVec) its (kh, kw, c),
  // kh = -1 past K
  int k, kh, kw, c;

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = ptt::a_row_h(i);
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
  __device__ void prepare(int k_) {
    k = k_;
    if constexpr (kVec) {
      if (k >= K) {
        kh = -1;
        return;
      }
      c = k % C;
      const int r = k / C;
      kw = r % KW;
      kh = r / KW;
    }
  }
  // x at slot i's pixel shifted by (dh, dw), channel cc; null outside
  __device__ const ptt::bf16* at(int i, int dh, int dw, int cc) const {
    const int ih = oh[i] + dh - pad;
    const int iw = ow[i] + dw - pad;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    return x + ((static_cast<long long>(n[i]) * H + ih) * W + iw) * C + cc;
  }
  __device__ ptt::Vec8 load(int i) const {
    ptt::Vec8 v = ptt::vec8_zero();
    if (n[i] < 0) return v;
    if constexpr (kVec) {
      if (kh >= 0) {
        const ptt::bf16* p = at(i, kh, kw, c);
        if (p != nullptr) v.u = *reinterpret_cast<const uint4*>(p);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (k + e >= K) break;
        const int r = (k + e) / C;
        const ptt::bf16* p = at(i, r / KW, r % KW, (k + e) % C);
        if (p != nullptr) v.s[e] = __bfloat16_as_ushort(*p);
      }
    }
    return v;
  }
};

template <bool kStats>
__global__ void __launch_bounds__(ptt::kThreads)
    conv2d_nhwc_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out, float* __restrict__ psum,
                           float* __restrict__ psq, int N, int H, int W,
                           int C, int KH, int KW, int O, int pad, int OH,
                           int OW) {
  const int M = N * OH * OW;
  const int K = KH * KW * C;
  ConvA a{x, H, W, C, KW, pad, OH, OW, M, K, {}, {}, {}, 0, 0, 0};
  a.init();
  ptt::gemm_tile<kStats>(a, w, out, M, O, K, psum, psq);
}

template <bool kStats, bool kVec>
__global__ void __launch_bounds__(ptt::kThreads)
    conv2d_nhwc_bf16_kernel(const ptt::bf16* __restrict__ x,
                            const ptt::bf16* __restrict__ w,
                            ptt::bf16* __restrict__ out,
                            float* __restrict__ psum, float* __restrict__ psq,
                            int N, int H, int W, int C, int KH, int KW, int O,
                            int pad, int OH, int OW) {
  const int M = N * OH * OW;
  const int K = KH * KW * C;
  ConvA8<kVec> a{x, H, W, C, KW, pad, OH, OW, M, K, {}, {}, {}, 0, 0, 0, 0};
  a.init();
  ptt::gemm_tile_bf16<kStats, kVec>(a, w, out, M, O, K, psum, psq);
}

// mean[o] = sum of the tiles' partial sums / cnt, var[o] = the partial
// squares' sum / cnt - mean^2 (biased, as the TPU kernel's wrapper),
// tiles added in order in double.
__global__ void conv_stats_finalize_kernel(const float* __restrict__ psum,
                                           const float* __restrict__ psq,
                                           float* __restrict__ mean,
                                           float* __restrict__ var, int tiles,
                                           int O, double cnt) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  double s = 0.0, q = 0.0;
  for (int t = 0; t < tiles; ++t) {
    s += psum[static_cast<long long>(t) * O + o];
    q += psq[static_cast<long long>(t) * O + o];
  }
  const double m = s / cnt;
  mean[o] = static_cast<float>(m);
  var[o] = static_cast<float>(q / cnt - m * m);
}

template <bool kStats, bool kVec>
void launch_bf16(dim3 grid, cudaStream_t stream, const ptt::bf16* x,
                 const ptt::bf16* w, ptt::bf16* out, float* psum, float* psq,
                 int N, int H, int W, int C, int KH, int KW, int O, int pad,
                 int OH, int OW) {
  conv2d_nhwc_bf16_kernel<kStats, kVec><<<grid, ptt::kThreads, 0, stream>>>(
      x, w, out, psum, psq, N, H, W, C, KH, KW, O, pad, OH, OW);
}

// The bf16 conv on the wgmma engine (C % 64 == 0): a 1 x 1 conv as the
// dense (N * H * W, C) @ (C, O) product, A by TMA; any other filter as
// out[N * OH * OW, O] with A gathered from x.
int wgmma_conv(const ptt::bf16* x, const ptt::bf16* w, ptt::bf16* out, int N,
               int H, int W, int C, int KH, int KW, int O, int pad,
               cudaStream_t stream) {
  namespace wg = ptt::wg;
  if (KH == 1 && KW == 1 && pad == 0)
    return wg::gemm_dense(x, w, out, N * H * W, O, C, stream);
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  const int K = KH * KW * C;
  CUtensorMap tb;
  const int err = wg::encode_bf16(&tb, w, O, K, 64, wg::kBK);
  if (err != 0) return err;
  const wg::ConvGeom g{x, H, W, C, KW, pad, OH, OW};
  return wg::launch_bn<true>(wg::tile_n(O), tb, tb, g, out, N * OH * OW, O,
                             K, stream);
}

template <class T>
int launch_conv(const T* x, const T* w, T* out, float* part, float* mean,
                float* var, int N, int H, int W, int C, int KH, int KW, int O,
                int pad, cudaStream_t stream) {
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  const int M = N * OH * OW;
  dim3 grid;
  float* psq = nullptr;
  if constexpr (std::is_same<T, float>::value) {
    grid = ptt::gemm_grid(M, O);
    if (part != nullptr) {
      psq = part + static_cast<long long>(grid.x) * O;
      conv2d_nhwc_f32_kernel<true><<<grid, ptt::kThreads, 0, stream>>>(
          x, w, out, part, psq, N, H, W, C, KH, KW, O, pad, OH, OW);
    } else {
      conv2d_nhwc_f32_kernel<false><<<grid, ptt::kThreads, 0, stream>>>(
          x, w, out, nullptr, nullptr, N, H, W, C, KH, KW, O, pad, OH, OW);
    }
  } else {
    grid = ptt::gemm_grid_bf16(M, O);
    if (part != nullptr) psq = part + static_cast<long long>(grid.x) * O;
    const bool vec = C % 8 == 0 && O % 8 == 0 && ptt::aligned16(x) &&
                     ptt::aligned16(w);
    if (part != nullptr) {
      if (vec)
        launch_bf16<true, true>(grid, stream, x, w, out, part, psq, N, H, W,
                                C, KH, KW, O, pad, OH, OW);
      else
        launch_bf16<true, false>(grid, stream, x, w, out, part, psq, N, H, W,
                                 C, KH, KW, O, pad, OH, OW);
    } else if (vec) {
      launch_bf16<false, true>(grid, stream, x, w, out, nullptr, nullptr, N,
                               H, W, C, KH, KW, O, pad, OH, OW);
    } else {
      launch_bf16<false, false>(grid, stream, x, w, out, nullptr, nullptr, N,
                                H, W, C, KH, KW, O, pad, OH, OW);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  conv_stats_finalize_kernel<<<(O + 255) / 256, 256, 0, stream>>>(
      part, psq, mean, var, static_cast<int>(grid.x), O,
      static_cast<double>(N) * OH * OW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 conv on the split-TF32 wgmma engine (C % 32 == 0): x split into
// xs (2 N H W C floats), w split into ws (2 KH KW C O floats) as the
// transposed (O, KH * KW * C) weight, or with flip from the forward's
// filter (KH, KW, O, C) flipped; then a 1 x 1 conv as the dense
// (N * H * W, C) @ (C, O) product, A by TMA, any other filter with A
// gathered from the split image.
int wgmma_conv_f32(const float* x, const float* w, float* xs, float* ws,
                   float* out, int N, int H, int W, int C, int KH, int KW,
                   int O, int pad, bool flip, cudaStream_t stream) {
  namespace tf = ptt::wg::tf32;
  const long long nx = static_cast<long long>(N) * H * W * C;
  const int T = KH * KW;
  const int K = T * C;
  int err = tf::split_rows(x, xs, nx, stream);
  if (err == 0)
    err = flip ? tf::split_flip(w, ws, T, O, C, stream)
               : tf::split_t(w, ws, T, C, O, stream);
  if (err != 0) return err;
  if (KH == 1 && KW == 1 && pad == 0) {
    const tf::Geom g{nullptr, nullptr, 0, 0, 0, 0, 0, 0, 0};
    return tf::launch_split<false>(xs, N * H * W, ws, g, out, N * H * W, O, C,
                                   stream);
  }
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  const tf::Geom g{xs, xs + nx, H, W, C, KW, pad, OH, OW};
  return tf::launch_split<true>(nullptr, 0, ws, g, out, N * OH * OW, O, K,
                                stream);
}

// Launch on `stream`; return cudaGetLastError() of the launch.  engine: 0
// the SIMT tile (any shape; xs, ws unused, flip refused), 1 the
// split-TF32 wgmma engine, xs (2 N H W C floats) and ws (2 KH KW C O
// floats) its scratch (refused with cudaErrorInvalidValue where the shape
// or alignment rule fails).  flip (wgmma only): w is the forward's filter
// (KH, KW, O, C) of the backward-input, flipped and channel-swapped by the
// split pass.
PTT_EXPORT int ptt_conv2d_nhwc_f32(const float* x, const float* w, float* out,
                                   float* xs, float* ws, int N, int H, int W,
                                   int C, int KH, int KW, int O, int pad,
                                   int flip, int engine,
                                   cudaStream_t stream) {
  if (engine == 1) {
    if (C % 32 != 0 ||
        !ptt::wg::tf32::takes(KH * KW * C, O, x, w, out, xs, ws))
      return static_cast<int>(cudaErrorInvalidValue);
    return wgmma_conv_f32(x, w, xs, ws, out, N, H, W, C, KH, KW, O, pad,
                          flip != 0, stream);
  }
  if (engine != 0 || flip != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_conv(x, w, out, nullptr, nullptr, nullptr, N, H, W, C, KH,
                     KW, O, pad, stream);
}

// engine: 0 the mma.sync tile (any shape), 1 the wgmma engine (refused
// with cudaErrorInvalidValue where the shape or alignment rule fails).
PTT_EXPORT int ptt_conv2d_nhwc_bf16(const ptt::bf16* x, const ptt::bf16* w,
                                    ptt::bf16* out, int N, int H, int W,
                                    int C, int KH, int KW, int O, int pad,
                                    int engine, cudaStream_t stream) {
  if (engine == 1) {
    if (C % 64 != 0 || !ptt::wg::takes(KH * KW * C, O, x, w, out))
      return static_cast<int>(cudaErrorInvalidValue);
    return wgmma_conv(x, w, out, N, H, W, C, KH, KW, O, pad, stream);
  }
  if (engine != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_conv(x, w, out, nullptr, nullptr, nullptr, N, H, W, C, KH,
                     KW, O, pad, stream);
}

// The wgmma instance for tile width bn (64, 128, 256), with A gathered
// (gather 1) or by TMA (0): registers, spill bytes, static and dynamic
// shared memory into out[0..4).
PTT_EXPORT int ptt_conv_wgmma_attributes(int bn, int gather, int* out) {
  return gather ? ptt::wg::attributes_bn<true>(bn, out)
                : ptt::wg::attributes_bn<false>(bn, out);
}

// The same for the split-TF32 instances (bn 64, 128).
PTT_EXPORT int ptt_conv_wgmma_tf32_attributes(int bn, int gather, int* out) {
  return gather ? ptt::wg::tf32::attributes_bn<true>(bn, out)
                : ptt::wg::tf32::attributes_bn<false>(bn, out);
}

// The fused conv + BN statistics: out, and mean / var (O floats each);
// `part` is f32 scratch of 2 * ceil(N * OH * OW / 64) * O floats (the
// bf16 instance's tiles are 128 rows and use half of it).
PTT_EXPORT int ptt_conv2d_bn_stats_nhwc_f32(const float* x, const float* w,
                                            float* out, float* part,
                                            float* mean, float* var, int N,
                                            int H, int W, int C, int KH,
                                            int KW, int O, int pad,
                                            cudaStream_t stream) {
  return launch_conv(x, w, out, part, mean, var, N, H, W, C, KH, KW, O, pad,
                     stream);
}

PTT_EXPORT int ptt_conv2d_bn_stats_nhwc_bf16(
    const ptt::bf16* x, const ptt::bf16* w, ptt::bf16* out, float* part,
    float* mean, float* var, int N, int H, int W, int C, int KH, int KW,
    int O, int pad, cudaStream_t stream) {
  return launch_conv(x, w, out, part, mean, var, N, H, W, C, KH, KW, O, pad,
                     stream);
}
