// Filter gradient of the stride-1 float32 NHWC convolution, as a split-K
// implicit GEMM:
//   dw[kh, kw, c, o] = sum over (n, oh, ow) of
//                      x[n, oh + kh - pad, ow + kw - pad, c] * g[n, oh, ow, o]
// The GEMM view is M = KH * KW * C filter rows, N = O, and the reduction
// K = N * OH * OW output pixels:
//   A^T[k, m] = x at pixel k shifted by (kh, kw), channel c   (gathered)
//   B[k, o]   = g[pixel k, o]              (g's own NHWC memory)
// and dw[m, o] is w's (KH, KW, C, O) layout.
//
// Replaces the TPU kernel paddle_tpu/pallas/conv.py:252 _conv_dw_impl
// (_dw_kernel :224).  That kernel pads x in HBM and carries one (KW*C, O)
// VMEM accumulator across a sequential (kh, batch block, row) grid.  On
// Hopper the blocks run in parallel and in no order, and M x N is small
// against K (at 56x56, 1x1, 64 -> 64: a single 64 x 64 tile over
// K = 802,816 pixels at batch 256), so one block per tile would leave
// 131 of 132 SMs idle.  Here the reduction is split: block z of the grid
// sums pixels [z * chunk, (z + 1) * chunk) of every (m, o) tile into its
// own slice of a partial buffer, and a second launch adds the slices in
// a fixed order (no atomics: the result is the same from run to run).
// The host picks the split so that about 8 blocks per SM are in flight.
//
// Tiles: the compute core of tile_gemm.cuh (64 x 64 tile, 256 threads,
// 4 x 4 sub-tile each, K steps of 16), but A is staged transposed: a
// thread loads filter row m = m0 + tid % 64 for pixels tid / 64 + 4 i,
// so a warp reads 32 neighbouring channels of one pixel (coalesced, like
// B), instead of tile_gemm's one channel of 16 pixels.  Each thread
// keeps its four pixels' (n, oh, ow) and steps them by 16 with carries,
// so there is no division in the K loop.  Rows outside the image read
// as zero: no padded copy of x.
//
// What bounds it on the H100: operations, 2 * N * H * W * KH * KW * C * O
// flops on f32 FMA units (67 TFLOP/s peak) with no tensor cores and no
// load/math overlap; wgmma tiles and a cp.async/TMA pipeline are later
// work.  The partial buffer adds splits * M * O * 8 bytes (write + read),
// at most a few tens of MB at the ResNet-50 shapes.
#include "tile_gemm.cuh"

namespace {

using ptt::kBK;
using ptt::kBM;
using ptt::kBN;
using ptt::kThreads;

__global__ void __launch_bounds__(kThreads)
    conv_dw_partial_kernel(const float* __restrict__ x,
                           const float* __restrict__ g,
                           float* __restrict__ part, int H, int W, int C,
                           int KW, int O, int pad, int OH, int OW, int M,
                           int K, int chunk) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(kbeg + chunk, K);

  // A^T staging: this thread's filter row and its (kh, kw) offsets
  const int am = tid % kBM;
  const int ak = tid / kBM;  // pixel slots ak + 4 i of each K step
  const int m = m0 + am;
  const bool m_ok = m < M;
  const int c = m_ok ? m % C : 0;
  const int r = m_ok ? m / C : 0;
  const int dkw = r % KW - pad;
  const int dkh = r / KW - pad;
  int pn[4], ph[4], pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = kbeg + ak + 4 * i;
    pn[i] = p / (OH * OW);
    const int rem = p - pn[i] * (OH * OW);
    ph[i] = rem / OW;
    pw[i] = rem - ph[i] * OW;
  }
  // B staging, as in tile_gemm.cuh
  const int bn = tid % kBN;
  const int bk = tid / kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (m_ok && k0 + ak + 4 * i < kend) {
        const int ih = ph[i] + dkh;
        const int iw = pw[i] + dkw;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = x[((static_cast<long long>(pn[i]) * H + ih) * W + iw) * C + c];
      }
      As[ak + 4 * i][am] = v;
      pw[i] += kBK;  // this slot's pixel of the next K step
      while (pw[i] >= OW) {
        pw[i] -= OW;
        if (++ph[i] == OH) {
          ph[i] = 0;
          ++pn[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + bk + 4 * i;
      const int n = n0 + bn;
      Bs[bk + 4 * i][bn] =
          (k < kend && n < O) ? g[static_cast<long long>(k) * O + n] : 0.f;
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

  float* out = part + static_cast<long long>(blockIdx.z) * M * O;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + ty + 16 * i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < O) out[static_cast<long long>(mm) * O + n] = acc[i][j];
    }
  }
}

// out[i] = sum over z of part[z][i], in order z = 0, 1, ...
__global__ void __launch_bounds__(256)
    conv_dw_reduce_kernel(const float* __restrict__ part,
                          float* __restrict__ out, long long MN, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < MN; i += stride) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * MN + i];
    out[i] = s;
  }
}

}  // namespace

// Launches on `stream`: the partial GEMMs into `part` (splits x M x O;
// `part` may be `out` when splits == 1), then, for splits > 1, the
// reduce into `out`.  Returns the first cudaGetLastError() that is not 0.
PTT_EXPORT int ptt_conv_dw_nhwc_f32(const float* x, const float* g,
                                    float* part, float* out, int N, int H,
                                    int W, int C, int KH, int KW, int O,
                                    int pad, int splits, int chunk,
                                    cudaStream_t stream) {
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  const int M = KH * KW * C;
  const int K = N * OH * OW;
  const dim3 grid((M + kBM - 1) / kBM, (O + kBN - 1) / kBN, splits);
  conv_dw_partial_kernel<<<grid, kThreads, 0, stream>>>(
      x, g, part, H, W, C, KW, O, pad, OH, OW, M, K, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * O;
  const long long blocks = (MN + 255) / 256;
  conv_dw_reduce_kernel<<<static_cast<int>(blocks < 1056 ? blocks : 1056),
                          256, 0, stream>>>(part, out, MN, splits);
  return static_cast<int>(cudaGetLastError());
}
