// Filter gradient of the stride-1 NHWC convolution, as a split-K implicit
// GEMM, from float32 or bf16 x and g, always summed and written in
// float32 (the TPU kernel's out_shape is f32 for either):
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
// The bf16 instance tiles 128 filter rows x 64 outputs and walks the
// pixels 32 at a time: each thread loads 8 neighbouring channels of a
// pixel (one 16-byte load when C % 8 == 0) for two pixel slots, and 8
// outputs of g's row, into registers during the previous step's products;
// the A^T slab is stored [pixel][filter row] and read transposed by
// ldmatrix into tile_gemm.cuh's MmaTile (mma.sync bf16, f32 accumulators,
// f32 partials).
//
// What bounds it on the H100: operations, 2 * N * H * W * KH * KW * C * O
// flops (67 TFLOP/s on the f32 FMA units, 989 TFLOP/s bf16 on the tensor
// cores), with no load/math overlap here; wgmma tiles and a cp.async/TMA
// pipeline are later work.  The partial buffer adds splits * M * O * 8
// bytes (write + read), at most a few tens of MB at the ResNet-50 shapes.
#include <type_traits>

#include "tile_gemm.cuh"

namespace {

using ptt::kBK;
using ptt::kBM;
using ptt::kBN;
using ptt::kThreads;

// A^T staging of one block: this thread's filter row m = m0 + tid % 64
// (its (kh, kw) offsets and channel) and its four pixel slots
// tid / 64 + 4 i of each K step, stepped by 16 with carries.
struct DwA {
  const float* __restrict__ x;
  int H, W, C, OH, OW, kend;
  bool m_ok;
  int c, dkh, dkw;
  int pn[4], ph[4], pw[4];

  __device__ void init(int m, int M, int KW, int pad, int kbeg, int ak) {
    m_ok = m < M;
    c = m_ok ? m % C : 0;
    const int r = m_ok ? m / C : 0;
    dkw = r % KW - pad;
    dkh = r / KW - pad;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = kbeg + ak + 4 * i;
      pn[i] = p / (OH * OW);
      const int rem = p - pn[i] * (OH * OW);
      ph[i] = rem / OW;
      pw[i] = rem - ph[i] * OW;
    }
  }
  // slot i's value at pixel k (zero past kend or outside the image),
  // then the slot moves on to its pixel of the next K step
  __device__ float next(int i, int k) {
    float v = 0.f;
    if (m_ok && k < kend) {
      const int ih = ph[i] + dkh;
      const int iw = pw[i] + dkw;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = x[((static_cast<long long>(pn[i]) * H + ih) * W + iw) * C + c];
    }
    pw[i] += kBK;
    while (pw[i] >= OW) {
      pw[i] -= OW;
      if (++ph[i] == OH) {
        ph[i] = 0;
        ++pn[i];
      }
    }
    return v;
  }
};

__global__ void __launch_bounds__(kThreads)
    conv_dw_partial_f32_kernel(const float* __restrict__ x,
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
  const int am = tid % kBM;
  const int ak = tid / kBM;  // pixel slots ak + 4 i of each K step
  DwA a{x, H, W, C, OH, OW, kend};
  a.init(m0 + am, M, KW, pad, kbeg, ak);
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
    for (int i = 0; i < 4; ++i) As[ak + 4 * i][am] = a.next(i, k0 + ak + 4 * i);
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

// The bf16 instance's A^T staging: this thread's 8 filter rows
// m0 + 8 (tid % 16) .. + 7 and its two pixel slots tid / 16 + 16 i of
// each K step of 32, stepped by 32 with carries.  kVec: C % 8 == 0 and x
// 16-byte aligned, so the 8 rows share (kh, kw) and are one 16-byte load
// of 8 channels; otherwise each row's (kh, kw, c) is kept and read alone.
template <bool kVec>
struct DwA8 {
  const ptt::bf16* __restrict__ x;
  int H, W, C, OH, OW, kend;
  int dkh[8], dkw[8], c[8];   // kVec: entry 0 only; dkh = INT_MIN past M
  int pn[2], ph[2], pw[2];

  __device__ void init(int m, int M, int KW, int pad, int kbeg, int ak) {
#pragma unroll
    for (int e = 0; e < (kVec ? 1 : 8); ++e) {
      const int mm = m + e;
      c[e] = mm % C;
      const int r = mm / C;
      dkw[e] = r % KW - pad;
      dkh[e] = mm < M ? r / KW - pad : -(1 << 30);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = kbeg + ak + 16 * i;
      pn[i] = p / (OH * OW);
      const int rem = p - pn[i] * (OH * OW);
      ph[i] = rem / OW;
      pw[i] = rem - ph[i] * OW;
    }
  }
  __device__ const ptt::bf16* at(int i, int e) const {
    const int ih = ph[i] + dkh[e];
    const int iw = pw[i] + dkw[e];
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    return x + ((static_cast<long long>(pn[i]) * H + ih) * W + iw) * C + c[e];
  }
  // slot i's 8 values at pixel k (zero past kend or outside the image),
  // then the slot moves on to its pixel of the next K step
  __device__ ptt::Vec8 next(int i, int k) {
    ptt::Vec8 v = ptt::vec8_zero();
    if (k < kend) {
      if constexpr (kVec) {
        const ptt::bf16* p = at(i, 0);
        if (p != nullptr) v.u = *reinterpret_cast<const uint4*>(p);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const ptt::bf16* p = at(i, e);
          if (p != nullptr) v.s[e] = __bfloat16_as_ushort(*p);
        }
      }
    }
    pw[i] += ptt::kHK;
    while (pw[i] >= OW) {
      pw[i] -= OW;
      if (++ph[i] == OH) {
        ph[i] = 0;
        ++pn[i];
      }
    }
    return v;
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    conv_dw_partial_bf16_kernel(const ptt::bf16* __restrict__ x,
                                const ptt::bf16* __restrict__ g,
                                float* __restrict__ part, int H, int W, int C,
                                int KW, int O, int pad, int OH, int OW, int M,
                                int K, int chunk) {
  __shared__ __align__(16) ptt::bf16 As[2][ptt::kHK * ptt::kLdAT];
  __shared__ __align__(16) ptt::bf16 Bs[2][ptt::kHK * ptt::kLdB];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * ptt::kHM;
  const int n0 = blockIdx.y * ptt::kHN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(kbeg + chunk, K);
  const int am = 8 * (tid % 16);  // this thread's filter rows am .. am + 7
  const int ak = tid / 16;        // its pixel slots ak + 16 i of a K step
  DwA8<kVec> a{x, H, W, C, OH, OW, kend};
  a.init(m0 + am, M, KW, pad, kbeg, ak);

  ptt::MmaTile tile;
  tile.init();
  ptt::Vec8 av[2], bv;
#pragma unroll
  for (int i = 0; i < 2; ++i) av[i] = a.next(i, kbeg + ak + 16 * i);
  bv = ptt::load_b<kVec>(g, kbeg, n0, kend, O);
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += ptt::kHK) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&As[buf][(ak + 16 * i) * ptt::kLdAT + am]) =
          av[i].u;
    ptt::store_b(Bs[buf], bv);
    __syncthreads();
    if (k0 + ptt::kHK < kend) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        av[i] = a.next(i, k0 + ptt::kHK + ak + 16 * i);
      bv = ptt::load_b<kVec>(g, k0 + ptt::kHK, n0, kend, O);
    }
    tile.step<true>(As[buf], Bs[buf]);
    buf ^= 1;
  }
  tile.store(part + static_cast<long long>(blockIdx.z) * M * O, m0, n0, M, O);
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

template <class T>
int launch_dw(const T* x, const T* g, float* part, float* out, int N, int H,
              int W, int C, int KH, int KW, int O, int pad, int splits,
              int chunk, cudaStream_t stream) {
  const int OH = H + 2 * pad - KH + 1;
  const int OW = W + 2 * pad - KW + 1;
  const int M = KH * KW * C;
  const int K = N * OH * OW;
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid((M + kBM - 1) / kBM, (O + kBN - 1) / kBN, splits);
    conv_dw_partial_f32_kernel<<<grid, kThreads, 0, stream>>>(
        x, g, part, H, W, C, KW, O, pad, OH, OW, M, K, chunk);
  } else {
    const dim3 grid((M + ptt::kHM - 1) / ptt::kHM,
                    (O + ptt::kHN - 1) / ptt::kHN, splits);
    if (C % 8 == 0 && O % 8 == 0 && ptt::aligned16(x) && ptt::aligned16(g))
      conv_dw_partial_bf16_kernel<true><<<grid, kThreads, 0, stream>>>(
          x, g, part, H, W, C, KW, O, pad, OH, OW, M, K, chunk);
    else
      conv_dw_partial_bf16_kernel<false><<<grid, kThreads, 0, stream>>>(
          x, g, part, H, W, C, KW, O, pad, OH, OW, M, K, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * O;
  const long long blocks = (MN + 255) / 256;
  conv_dw_reduce_kernel<<<static_cast<int>(blocks < 1056 ? blocks : 1056),
                          256, 0, stream>>>(part, out, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: the partial GEMMs into `part` (splits x M x O;
// `part` may be `out` when splits == 1), then, for splits > 1, the
// reduce into `out`.  Return the first cudaGetLastError() that is not 0.
PTT_EXPORT int ptt_conv_dw_nhwc_f32(const float* x, const float* g,
                                    float* part, float* out, int N, int H,
                                    int W, int C, int KH, int KW, int O,
                                    int pad, int splits, int chunk,
                                    cudaStream_t stream) {
  return launch_dw(x, g, part, out, N, H, W, C, KH, KW, O, pad, splits, chunk,
                   stream);
}

PTT_EXPORT int ptt_conv_dw_nhwc_bf16(const ptt::bf16* x, const ptt::bf16* g,
                                     float* part, float* out, int N, int H,
                                     int W, int C, int KH, int KW, int O,
                                     int pad, int splits, int chunk,
                                     cudaStream_t stream) {
  return launch_dw(x, g, part, out, N, H, W, C, KH, KW, O, pad, splits, chunk,
                   stream);
}
