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
// The bf16 instance has two engines, by shape (kernels/conv.py
// bf16_engine, mirrored in ptt_conv_dw_nhwc_bf16's wgmma_dw_takes):
// - wgmma (wgmma_gemm.cuh's products, barriers and TMA), for C % 64 == 0,
//   O % 8 == 0 and 16-byte-aligned x and g: every stride-1 conv of
//   ResNet-50.  A 128 x BN tile (two consumer warpgroups of 64 filter rows,
//   each one 64-channel slab of one tap; BN = O up to 256), one block an
//   SM, a producer warpgroup keeping a ring of 4-8 stages of 64 pixels
//   full.  A stage's A is the shifted x read with pixels as K and channels
//   as M: 128-byte rows of 64 channels, one a pixel, in the 128-byte
//   swizzle, the very layout of the forward's gathered A, which wgmma
//   reads as an MN-major A with the transpose bit.  For a 1 x 1 filter
//   A^T is x itself, a (K, C) matrix, and comes by TMA; otherwise the
//   producer gathers it with 16-byte cp.async copies (halo pixels and
//   pixels past the split zero-filled).  B, g as a (K, O) matrix, comes by
//   TMA.  The split is chosen for one or two waves of 132 blocks
//   (dw_splits_wgmma); each consumer writes its f32 fragment straight into
//   its split's slice, and the same fixed-order reduce adds the slices.
// - mma.sync (the rest: C = 3, 20, misaligned views): 128 filter rows x
//   64 outputs, pixels 32 at a time; each thread loads 8 neighbouring
//   channels of a pixel (one 16-byte load when C % 8 == 0) for two pixel
//   slots, and 8 outputs of g's row, into registers during the previous
//   step's products; the A^T slab is stored [pixel][filter row] and read
//   transposed by ldmatrix into tile_gemm.cuh's MmaTile (mma.sync bf16,
//   f32 accumulators, f32 partials).
//
// The float32 instance has two engines too, by shape (kernels/conv.py
// f32_dw_engine, mirrored in ptt_conv_dw_nhwc_f32's tf32_dw_takes):
// - wgmma in split TF32 (wgmma_tf32.cuh's block: products, barriers, fresh,
//   mid and running sums, epilogue), for C % 64 == 0, O % 4 == 0 and
//   16-byte-aligned x and g: every stride-1 conv of ResNet-50.  wgmma reads
//   .tf32 operands K-major only, and both x and g are contiguous along an M
//   or N index (c, o), so both are transposed: a split pass on the caller's
//   stream writes each as hi and lo copies, channel-major, over the pixel
//   layout of wgmma_tf32.cuh dw_pixels, in which each image row is followed
//   by at least pad zero columns (rows of WP = W + pad rounded up to 4) and
//   each image by pad zero rows.  There a tap (kh, kw) is a constant offset
//   (kh - pad) WP + kw - pad along the positions, its halo reads the zeros,
//   and the zeros of g make every separator position add nothing.  x comes
//   in KW copies, copy kw shifted by kw - pad, so that each tap's offset
//   into its copy is a multiple of 16 bytes: each stage's A (two 64-channel
//   slabs,
//   one tap each, 32 positions) and B (BN outputs x 32 positions) are dense
//   2-D TMA boxes at shifted, 16-byte-aligned coordinates, no gather.  The
//   separators cost 9%, 18%, 22% and 31% more positions at 56^2, 28^2, 14^2
//   and 7^2 (3 x 3); a 1 x 1 filter (pad 0, no copies) has none but the
//   rounding of its positions to 4.  Split over positions as the bf16 route
//   (dw_splits_tf32), each consumer's epilogue into its split's slice.
// - the SIMT tile above (the rest: LeNet's C 1 and 20, misaligned views).
//
// What bounds it on the H100: operations, 2 * N * H * W * KH * KW * C * O
// flops (67 TFLOP/s on the f32 FMA units, 495 TFLOP/s TF32 and 989 bf16 on
// the tensor cores; split TF32 does three TF32 products a product), for
// the 3 x 3 filters at 7 x 7 to 28 x 28 and the 1 x 1 ones at 7 x 7; bytes
// (x and g read once, 3.35 TB/s) for the rest, where M x O is small against
// K.  The SIMT and mma.sync tiles do not overlap loads and math beyond one
// register-staged step; the wgmma routes issue asynchronous warpgroup
// products from shared memory with every consumer register an accumulator,
// and keep 3-8 stages of loads in flight.  The split pass moves 12 bytes an
// element of x and g (read, hi and lo written) before the products read hi
// and lo.  The partial buffer adds splits * M * O * 8 bytes (write + read),
// at most a few tens of MB at the ResNet-50 shapes.
#include <climits>
#include <type_traits>

#include "tile_gemm.cuh"
#include "wgmma_tf32.cuh"

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

// ---------------------------------------------------------------------------
// the bf16 filter gradient on the wgmma engine (wgmma_gemm.cuh)
// ---------------------------------------------------------------------------

namespace wg = ptt::wg;

// One A box: 64 pixels (K) x 64 channels of one tap (M), 128-byte rows in
// the 128-byte swizzle.  A stage holds two (wg::kATile), one per consumer
// slab, then B's BN / 64 boxes of 64 pixels x 64 outputs.
constexpr int kDwBox = 64 * 64 * 2;
// The producer's gather keeps four pixels' (oh, ow) and two slabs' taps in
// registers: more than the engine's 40, so the consumers give up 8.
constexpr int kDwProducerRegs = 56;
constexpr int kDwConsumerRegs = 224;
// The ring and its barriers, and 1 KB of slack to align the start: no
// gather table and no staging tile (the epilogue stores f32 straight).
template <int BN>
constexpr int kDwSmemBytes =
    wg::kStages<BN> * wg::kStageBytes<BN> + 16 * wg::kStages<BN> + 1024;

// The image and the split: stride 1, SAME (the output pixel k is the
// input pixel k), K = N * H * W pixels, each split `chunk` of them (a
// multiple of 64), and 64 pixels as (rows, columns) within one image:
// 64 % (H * W) = step_h * W + step_w.
struct DwGeom {
  const ptt::bf16* x;
  int H, W, C, KW, pad, K, chunk, step_h, step_w;
};

// The producer with a dense A (one thread), for a 1 x 1 filter, where A^T
// is x itself, a (K pixels, C) matrix: each stage's live slabs' A boxes
// (64 channels x 64 pixels) and B's boxes (64 outputs x 64 pixels) by
// TMA.  Pixels past K (the last split's ragged step) read as zero.
template <int BN>
__device__ __forceinline__ void dw_produce_tma(const CUtensorMap* ta,
                                               const CUtensorMap* tb,
                                               uint32_t base, uint32_t full0,
                                               uint32_t empty0, int m0,
                                               int slabs, int n0, int kbeg,
                                               int KT) {
  constexpr int S = wg::kStages<BN>;
  const uint32_t bytes = slabs * kDwBox + BN * wg::kBK * 2;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    wg::mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    const uint32_t a = base + s * wg::kStageBytes<BN>;
    const int k = kbeg + kt * wg::kBK;
    wg::mbar_expect_tx(full, bytes);
    for (int i = 0; i < slabs; ++i)
      wg::tma_load_2d(a + i * kDwBox, ta, m0 + 64 * i, k, full);
#pragma unroll
    for (int i = 0; i < BN / 64; ++i)
      wg::tma_load_2d(a + wg::kATile + i * wg::kBBox, tb, n0 + 64 * i, k,
                      full);
  }
}

// The producer with a gathered A (all 128 threads of warpgroup 0), for a
// KH x KW filter.  Slab s of the tile (filter rows m0 + 64 s ..) is 64
// channels of one tap (C % 64 == 0), fixed for the block.  Thread t copies
// 16-byte chunk t % 8 of pixel rows t / 8 + 16 i (i < 4) of both slabs,
// so a warp's copy covers four whole 128-byte rows; it keeps those four
// pixels' (oh, ow) and steps them by 64 with one carry each, no division
// in the loop.  Halo pixels and pixels past the split are zero fills.  B
// comes by TMA from thread 0; a stage's gathered copies are published
// kStages - 2 stages later, after this thread's own copies have landed and
// a proxy fence (as wg::produce_gather does).
template <int BN>
__device__ __forceinline__ void dw_produce_gather(const CUtensorMap* tb,
                                                  const DwGeom& g,
                                                  uint32_t base, uint32_t full0,
                                                  uint32_t empty0, int m0,
                                                  int M, int n0, int kbeg,
                                                  int kend, int KT) {
  constexpr int S = wg::kStages<BN>;
  constexpr int L = S - 2;
  const int t = threadIdx.x;
  const int j = t % 8;
  const int r0 = t / 8;
  const bool live1 = m0 + 64 < M;
  // each slab's tap (dh, dw) and the element offset of its shifted
  // pixel's channel chunk from pixel k's row: (dh W + dw) C + c + 8 j
  int dh[2], dw[2], off[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int m = m0 + 64 * s;
    const int tap = m / g.C;
    dh[s] = tap / g.KW - g.pad;
    dw[s] = tap % g.KW - g.pad;
    off[s] = (dh[s] * g.W + dw[s]) * g.C + (m - tap * g.C) + 8 * j;
  }
  int oh[4], ow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = (kbeg + r0 + 16 * i) % (g.H * g.W);
    oh[i] = q / g.W;
    ow[i] = q - oh[i] * g.W;
  }
  const uint32_t dst0 = r0 * 128 + ((j ^ (r0 % 8)) << 4);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    wg::mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
    const uint32_t a = base + s * wg::kStageBytes<BN>;
    const int k0 = kbeg + kt * wg::kBK;
    if (t == 0) {
      const uint32_t full = full0 + 8 * s;
      wg::mbar_expect_tx(full, BN * wg::kBK * 2);
#pragma unroll
      for (int i = 0; i < BN / 64; ++i)
        wg::tma_load_2d(a + wg::kATile + i * wg::kBBox, tb, n0 + 64 * i, k0,
                        full);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + r0 + 16 * i;
      const bool in = k < kend;
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        if (sl == 1 && !live1) break;
        const int ih = oh[i] + dh[sl];
        const int iw = ow[i] + dw[sl];
        const bool ok = in &&
                        static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
        const ptt::bf16* src =
            ok ? g.x + (static_cast<long long>(k) * g.C + off[sl]) : g.x;
        wg::cp_async16_zfill(a + sl * kDwBox + dst0 + i * 16 * 128, src, ok);
      }
      // the next step's pixel: step_h rows and step_w columns on, with
      // one carry (oh < 2 H before the wrap)
      ow[i] += g.step_w;
      oh[i] += g.step_h;
      if (ow[i] >= g.W) {
        ow[i] -= g.W;
        ++oh[i];
      }
      if (oh[i] >= g.H) oh[i] -= g.H;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (kt >= L) {
      wg::cp_async_wait_n<L>();
      wg::fence_proxy_async();
      wg::mbar_arrive(full0 + 8 * ((kt - L) % S));
    }
  }
  wg::cp_async_wait_n<0>();
  wg::fence_proxy_async();
  for (int kt = KT > L ? KT - L : 0; kt < KT; ++kt)
    wg::mbar_arrive(full0 + 8 * (kt % S));
}

// A consumer warpgroup whose slab lies past M (M % 128 == 64): it only
// frees the stages, one arrival a warp, as the live one reads them.
template <int S>
__device__ __forceinline__ void dw_idle(uint32_t full0, uint32_t empty0,
                                        int KT) {
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    wg::mbar_wait(full0 + 8 * s, (kt / S) & 1);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(empty0 + 8 * s);
  }
}

// A consumer warpgroup (cw 0 or 1: filter rows m0 + 64 cw .. + 63, one
// slab, inside M): wgmma over the ring with A MN-major (the transpose
// bit: the stage's rows are pixels, K, of 64 channels, M), then its f32
// fragment straight into this split's slice of the partial buffer.  No
// branch inside the product loop but the engine's own (ptxas serializes
// the products behind one, C7518).
template <int BN>
__device__ __forceinline__ void dw_consume(uint32_t base, uint32_t full0,
                                           uint32_t empty0,
                                           float* __restrict__ part, int m0,
                                           int n0, int O, int KT) {
  constexpr int S = wg::kStages<BN>;
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  // never zeroed: the first product overwrites d (acc = 0), and KT >= 1
  float d[BN / 2];
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    wg::mbar_wait(full0 + 8 * s, (kt / S) & 1);
    const uint32_t a = base + s * wg::kStageBytes<BN>;
    // A and B alike: MN-major, 8-pixel groups 1024 bytes apart; A's 64
    // rows are one box wide, B's 64-column boxes kBBox apart
    const uint64_t da = wg::desc_sw128(a + cw * kDwBox, kDwBox, 1024);
    const uint64_t db = wg::desc_sw128(a + wg::kATile, wg::kBBox, 1024);
    wg::fence_operands<BN>(d);
    wg::wgmma_fence();
    // k16 steps: 16 pixel rows (2048 bytes) down both
#pragma unroll
    for (int kk = 0; kk < wg::kBK / 16; ++kk)
      wg::wgmma_tile<BN, 1>(d, da + 128 * kk, db + 128 * kk, kt > 0 || kk > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
    wg::fence_operands<BN>(d);
    if (kt > 0 && t % 32 == 0) wg::mbar_arrive(empty0 + 8 * ((kt - 1) % S));
  }
  wg::wgmma_wait<0>();
  wg::fence_operands<BN>(d);
  // d[4 j .. 4 j + 1] at (r, 8 j + 2 (t % 4)), d[4 j + 2 ..] 8 rows down:
  // four lanes write 32 contiguous bytes, a whole sector; O % 8 == 0, so
  // an 8-column group is all in or all out
  const int lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4;
  float* row = part + static_cast<long long>(m0 + 64 * cw + r) * O + n0 +
               2 * (lane % 4);
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    if (n0 + 8 * jj < O) {
      *reinterpret_cast<float2*>(row + 8 * jj) =
          make_float2(d[4 * jj], d[4 * jj + 1]);
      *reinterpret_cast<float2*>(row + 8 * static_cast<long long>(O) +
                                 8 * jj) =
          make_float2(d[4 * jj + 2], d[4 * jj + 3]);
    }
  }
}

// Block (x, y, z): the 128 x BN tile of dw that the engine's grouped order
// gives (x, y), summed over split z's pixels [z chunk, (z + 1) chunk) into
// part[z] (M x O f32).  One block an SM.
template <int BN, bool kGather>
__global__ void __launch_bounds__(wg::kThreads, 1)
    wgmma_dw_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const DwGeom geom, float* __restrict__ part, int M,
                    int O) {
  constexpr int S = wg::kStages<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + S * wg::kStageBytes<BN>;
  const uint32_t empty0 = full0 + 8 * S;
  int m0, n0;
  {
    const int id = blockIdx.y * gridDim.x + blockIdx.x;
    const int per = wg::kGroupM * gridDim.y;
    const int first = id / per * wg::kGroupM;
    const int left = static_cast<int>(gridDim.x) - first;
    const int rows_in = left < wg::kGroupM ? left : wg::kGroupM;
    m0 = (first + id % per % rows_in) * wg::kBM;
    n0 = id % per / rows_in * BN;
  }
  const int kbeg = blockIdx.z * geom.chunk;
  const int kend = min(kbeg + geom.chunk, geom.K);
  const int KT = (kend - kbeg + wg::kBK - 1) / wg::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full0 + 8 * s, kGather ? 129 : 1);
      wg::mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDwProducerRegs));
    if constexpr (kGather)
      dw_produce_gather<BN>(&tm_b, geom, base, full0, empty0, m0, M, n0, kbeg,
                            kend, KT);
    else if (threadIdx.x == 0)
      dw_produce_tma<BN>(&tm_a, &tm_b, base, full0, empty0, m0,
                         m0 + 64 < M ? 2 : 1, n0, kbeg, KT);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kDwConsumerRegs));
    if (m0 + 64 * (threadIdx.x / 128 - 1) < M)
      dw_consume<BN>(base, full0, empty0,
                     part + static_cast<long long>(blockIdx.z) * M * O, m0,
                     n0, O, KT);
    else
      dw_idle<S>(full0, empty0, KT);
  }
}

template <int BN, bool kGather>
int launch_wgmma_dw(const CUtensorMap& ta, const CUtensorMap& tb,
                    const DwGeom& g, float* part, int M, int O, int splits,
                    cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only once allowed, per instance
  static const cudaError_t allowed = cudaFuncSetAttribute(
      wgmma_dw_kernel<BN, kGather>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmemBytes<BN>);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((M + wg::kBM - 1) / wg::kBM, (O + BN - 1) / BN, splits);
  wgmma_dw_kernel<BN, kGather><<<grid, wg::kThreads, kDwSmemBytes<BN>,
                                 stream>>>(ta, tb, g, part, M, O);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGather>
int launch_wgmma_dw_bn(int bn, const CUtensorMap& ta, const CUtensorMap& tb,
                       const DwGeom& g, float* part, int M, int O, int splits,
                       cudaStream_t stream) {
  if (bn == 64)
    return launch_wgmma_dw<64, kGather>(ta, tb, g, part, M, O, splits, stream);
  if (bn == 128)
    return launch_wgmma_dw<128, kGather>(ta, tb, g, part, M, O, splits,
                                         stream);
  return launch_wgmma_dw<256, kGather>(ta, tb, g, part, M, O, splits, stream);
}

// out[0..4): registers, spill bytes, static and dynamic shared memory of
// the instance for tile width bn; 0 or a cudaError_t.
template <int BN, bool kGather>
int wgmma_dw_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, wgmma_dw_kernel<BN, kGather>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kDwSmemBytes<BN>;
  return 0;
}

template <bool kGather>
int wgmma_dw_attributes_bn(int bn, int* out) {
  if (bn == 64) return wgmma_dw_attributes<64, kGather>(out);
  if (bn == 128) return wgmma_dw_attributes<128, kGather>(out);
  return wgmma_dw_attributes<256, kGather>(out);
}

// The fixed-order sum of the splits into out (splits > 1); 0 or an error.
int reduce_splits(const float* part, float* out, int M, int O, int splits,
                  cudaStream_t stream) {
  if (splits == 1) return 0;
  const long long MN = static_cast<long long>(M) * O;
  const long long blocks = (MN + 255) / 256;
  conv_dw_reduce_kernel<<<static_cast<int>(blocks < 1056 ? blocks : 1056),
                          256, 0, stream>>>(part, out, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma route: A by TMA for a 1 x 1 filter, else gathered; B (g as a
// (K pixels, O) matrix) by TMA; then the splits' fixed-order sum.
int wgmma_dw(const ptt::bf16* x, const ptt::bf16* g, float* part, float* out,
             int N, int H, int W, int C, int KH, int KW, int O, int pad,
             int splits, int chunk, cudaStream_t stream) {
  const int M = KH * KW * C;
  const int K = N * H * W;
  const bool gather = KH != 1 || KW != 1;
  CUtensorMap ta, tb;
  int err = wg::encode_bf16(&tb, g, O, K, 64, wg::kBK);
  if (err == 0 && !gather) err = wg::encode_bf16(&ta, x, C, K, 64, wg::kBK);
  if (err != 0) return err;
  const int step = 64 % (H * W);
  const DwGeom geo{x, H, W, C, KW, pad, K, chunk, step / W, step % W};
  const int bn = wg::tile_n(O);
  err = gather ? launch_wgmma_dw_bn<true>(bn, tb, tb, geo, part, M, O, splits,
                                          stream)
               : launch_wgmma_dw_bn<false>(bn, ta, tb, geo, part, M, O,
                                           splits, stream);
  if (err != 0) return err;
  return reduce_splits(part, out, M, O, splits, stream);
}

// Whether the wgmma route takes this launch (kernels/conv.py bf16_engine
// and dw_splits_wgmma): 64-channel slabs inside one tap, 16-byte rows and
// bases for TMA, the cp.async gather and the float2 epilogue, a SAME
// stride-1 image (output pixel k is input pixel k), and splits of whole
// 64-pixel steps that cover the K pixels, none empty.
bool wgmma_dw_takes(const void* x, const void* g, const void* part,
                    const void* out, int N, int H, int W, int C, int KH,
                    int KW, int O, int pad, int splits, int chunk) {
  if (C % 64 != 0 || O % 8 != 0 || !ptt::aligned16(x) || !ptt::aligned16(g))
    return false;
  const long long K = static_cast<long long>(N) * H * W;
  return ptt::aligned16(part) && ptt::aligned16(out) && K > 0 &&
         H + 2 * pad - KH + 1 == H && W + 2 * pad - KW + 1 == W &&
         chunk > 0 && chunk % 64 == 0 && splits >= 1 &&
         static_cast<long long>(splits) * chunk >= K &&
         static_cast<long long>(splits - 1) * chunk < K;
}

// ---------------------------------------------------------------------------
// the float32 filter gradient on the split-TF32 wgmma engine
// (wgmma_tf32.cuh)
// ---------------------------------------------------------------------------

namespace wt = ptt::wg::tf32;

// One A box: 32 positions (K) x 64 channels of one tap (M), 128-byte rows
// in the 128-byte swizzle; a stage's A hi (and A lo) holds two, one per
// consumer slab, which is the engine's 128-row A tile.
constexpr int kDwTf32Box = 64 * wt::kBK * 4;

// The split images' geometry: channels, the filter's width, the padding,
// the layout's row (dw_row) and x's lead (dw_lead), the positions K
// (dw_pixels) and a split's chunk.
struct DwTf32Geom {
  int C, KW, pad, wp, lead, K, chunk;
};

// The producer (one thread): each stage's A hi and lo boxes of the live
// slabs (slab s: filter rows m0 + 64 s .., 64 channels c of one tap (kh,
// kw), C % 64 == 0), each from x's copy kw, rows kw C + c, at the tap's
// offset along the positions, and B's hi and lo boxes (g's BN outputs x
// 32 positions), all by TMA.  Nothing is gathered: the zero separators of
// the layout are the halo.
template <int BN>
__device__ __forceinline__ void dw_tf32_produce(
    const CUtensorMap* xh, const CUtensorMap* xl, const CUtensorMap* gh,
    const CUtensorMap* gl, const DwTf32Geom& g, uint32_t base, uint32_t full0,
    uint32_t empty0, int m0, int slabs, int n0, int kbeg, int KT) {
  constexpr int S = wt::kStages<BN>;
  int row[2], off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + 64 * i;
    const int tap = m / g.C;
    row[i] = tap % g.KW * g.C + m - tap * g.C;
    off[i] = g.lead + (tap / g.KW - g.pad) * g.wp;
  }
  const uint32_t bytes = 2 * slabs * kDwTf32Box + 2 * wt::kBTile<BN>;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    wg::mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    const uint32_t a = base + s * wt::kStageBytes<BN>;
    const uint32_t b = a + 2 * wt::kATile;
    const int k = kbeg + kt * wt::kBK;
    wg::mbar_expect_tx(full, bytes);
    for (int i = 0; i < slabs; ++i) {
      wg::tma_load_2d(a + i * kDwTf32Box, xh, k + off[i], row[i], full);
      wg::tma_load_2d(a + wt::kATile + i * kDwTf32Box, xl, k + off[i],
                      row[i], full);
    }
    wg::tma_load_2d(b, gh, k, n0, full);
    wg::tma_load_2d(b + wt::kBTile<BN>, gl, k, n0, full);
  }
}

// Block (x, y, z): the 128 x BN tile of dw that the engine's grouped order
// gives (x, y), summed over split z's positions [z chunk, (z + 1) chunk)
// into part[z] (M x O f32) by the engine's consumers (fresh, mid and
// running sums; the epilogue through the staging tile).  One block an SM.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, 1)
    wgmma_tf32_dw_kernel(const __grid_constant__ CUtensorMap tm_xh,
                         const __grid_constant__ CUtensorMap tm_xl,
                         const __grid_constant__ CUtensorMap tm_gh,
                         const __grid_constant__ CUtensorMap tm_gl,
                         const DwTf32Geom geom, float* __restrict__ part,
                         int M, int O) {
  constexpr int S = wt::kStages<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + S * wt::kStageBytes<BN>;
  const uint32_t empty0 = full0 + 8 * S;
  // the engine's layout: the ring, its barriers, an unused gather table,
  // the consumers' staging tiles
  float* staging = reinterpret_cast<float*>(
      smem_raw + (base - raw) + S * wt::kStageBytes<BN> + 16 * S +
      16 * wg::kBM);
  int m0, n0;
  {
    const int id = blockIdx.y * gridDim.x + blockIdx.x;
    const int per = wg::kGroupM * gridDim.y;
    const int first = id / per * wg::kGroupM;
    const int left = static_cast<int>(gridDim.x) - first;
    const int rows_in = left < wg::kGroupM ? left : wg::kGroupM;
    m0 = (first + id % per % rows_in) * wg::kBM;
    n0 = id % per / rows_in * BN;
  }
  const int kbeg = blockIdx.z * geom.chunk;
  const int kend = min(kbeg + geom.chunk, geom.K);
  const int KT = (kend - kbeg + wt::kBK - 1) / wt::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full0 + 8 * s, 1);
      wg::mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        wt::kProducerRegs));
    if (threadIdx.x == 0)
      dw_tf32_produce<BN>(&tm_xh, &tm_xl, &tm_gh, &tm_gl, geom, base, full0,
                          empty0, m0, m0 + 64 < M ? 2 : 1, n0, kbeg, KT);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        wt::kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    if (m0 + 64 * cw < M)
      wt::consume<BN>(base, full0, empty0, staging + cw * (wt::kOutTile / 4),
                      part + static_cast<long long>(blockIdx.z) * M * O, m0,
                      n0, M, O, KT);
    else
      dw_idle<S>(full0, empty0, KT);
  }
}

template <int BN>
int launch_tf32_dw(const CUtensorMap (&maps)[4], const DwTf32Geom& g,
                   float* part, int M, int O, int splits,
                   cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only once allowed, per instance
  static const cudaError_t allowed = cudaFuncSetAttribute(
      wgmma_tf32_dw_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wt::kSmemBytes<BN>);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((M + wg::kBM - 1) / wg::kBM, (O + BN - 1) / BN, splits);
  wgmma_tf32_dw_kernel<BN><<<grid, wg::kThreads, wt::kSmemBytes<BN>,
                             stream>>>(maps[0], maps[1], maps[2], maps[3], g,
                                       part, M, O);
  return static_cast<int>(cudaGetLastError());
}

// Whether the split-TF32 route takes this launch (kernels/conv.py
// f32_dw_engine and dw_splits_tf32): 64-channel slabs inside one tap,
// O % 4 == 0 (TMA's 16-byte strides of the split g, the epilogue's 16-byte
// stores), 16-byte-aligned operands and scratch, a SAME stride-1 image,
// at most INT_MAX positions in x's layout, and splits of whole
// 32-position steps that cover g's (dw_pixels), none empty.
bool tf32_dw_takes(const void* x, const void* g, const void* part,
                   const void* out, const void* xs, const void* gs, int N,
                   int H, int W, int C, int KH, int KW, int O, int pad,
                   int splits, int chunk) {
  if (C % 64 != 0 || O % 4 != 0 || !ptt::aligned16(x) || !ptt::aligned16(g))
    return false;
  const long long K = wt::dw_pixels(N, H, W, pad);
  return ptt::aligned16(part) && ptt::aligned16(out) && ptt::aligned16(xs) &&
         ptt::aligned16(gs) && N > 0 && H > 0 && W > 0 &&
         wt::dw_pixels_x(N, H, W, pad) <= INT_MAX &&
         H + 2 * pad - KH + 1 == H && W + 2 * pad - KW + 1 == W &&
         chunk > 0 && chunk % wt::kBK == 0 && splits >= 1 &&
         static_cast<long long>(splits) * chunk >= K &&
         static_cast<long long>(splits - 1) * chunk < K;
}

// The split-TF32 route: the split pass writes x and g as hi and lo in the
// filter gradient's layout, channel-major (xs: 2 KW C KX floats, x's KW
// shifted copies, KX = dw_pixels_x; gs: 2 O K, K = dw_pixels), then the
// products by TMA, then the splits' fixed-order sum.
int tf32_dw(const float* x, const float* g, float* part, float* out,
            float* xs, float* gs, int N, int H, int W, int C, int KH, int KW,
            int O, int pad, int splits, int chunk, cudaStream_t stream) {
  const int M = KH * KW * C;
  const int K = static_cast<int>(wt::dw_pixels(N, H, W, pad));
  const int KX = static_cast<int>(wt::dw_pixels_x(N, H, W, pad));
  const int lead = wt::dw_lead(W, pad);
  int err = wt::split_dw(x, xs, N, H, W, C, pad, lead, -pad, KW, KX, stream);
  if (err == 0) err = wt::split_dw(g, gs, N, H, W, O, pad, 0, 0, 1, K, stream);
  if (err != 0) return err;
  const int bn = wt::tile_n(O);
  CUtensorMap maps[4];
  err = wt::encode_f32(&maps[0], xs, KX, KW * C, 64);
  if (err == 0)
    err = wt::encode_f32(&maps[1], xs + static_cast<long long>(KW) * C * KX,
                         KX, KW * C, 64);
  if (err == 0) err = wt::encode_f32(&maps[2], gs, K, O, bn);
  if (err == 0)
    err = wt::encode_f32(&maps[3], gs + static_cast<long long>(O) * K, K, O,
                         bn);
  if (err != 0) return err;
  const DwTf32Geom geo{C, KW, pad, wt::dw_row(W, pad), lead, K, chunk};
  err = bn == 64 ? launch_tf32_dw<64>(maps, geo, part, M, O, splits, stream)
                 : launch_tf32_dw<128>(maps, geo, part, M, O, splits, stream);
  if (err != 0) return err;
  return reduce_splits(part, out, M, O, splits, stream);
}

// out[0..4): registers, spill bytes, static and dynamic shared memory of
// the split-TF32 instance for tile width bn; 0 or a cudaError_t.
template <int BN>
int tf32_dw_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, wgmma_tf32_dw_kernel<BN>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = wt::kSmemBytes<BN>;
  return 0;
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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_splits(part, out, M, O, splits, stream);
}

}  // namespace

// Launch on `stream`: the partial GEMMs into `part` (splits x M x O;
// `part` may be `out` when splits == 1), then, for splits > 1, the
// reduce into `out`.  Return the first cudaGetLastError() that is not 0.
// engine: 0 the SIMT tile (any shape; xs and gs unused), 1 the split-TF32
// wgmma engine (refused with cudaErrorInvalidValue where tf32_dw_takes
// fails), with xs and gs the split pass's scratch of 2 KW C KX and 2 O K
// floats, KX = dw_pixels_x(N, H, W, pad), K = dw_pixels(N, H, W, pad),
// and splits of that K.
PTT_EXPORT int ptt_conv_dw_nhwc_f32(const float* x, const float* g,
                                    float* part, float* out, float* xs,
                                    float* gs, int N, int H, int W, int C,
                                    int KH, int KW, int O, int pad,
                                    int splits, int chunk, int engine,
                                    cudaStream_t stream) {
  if (engine == 1) {
    if (!tf32_dw_takes(x, g, part, out, xs, gs, N, H, W, C, KH, KW, O, pad,
                       splits, chunk))
      return static_cast<int>(cudaErrorInvalidValue);
    return tf32_dw(x, g, part, out, xs, gs, N, H, W, C, KH, KW, O, pad,
                   splits, chunk, stream);
  }
  if (engine != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(x, g, part, out, N, H, W, C, KH, KW, O, pad, splits, chunk,
                   stream);
}

// engine: 0 the mma.sync tile (any shape), 1 the wgmma engine (refused
// with cudaErrorInvalidValue where wgmma_dw_takes fails).
PTT_EXPORT int ptt_conv_dw_nhwc_bf16(const ptt::bf16* x, const ptt::bf16* g,
                                     float* part, float* out, int N, int H,
                                     int W, int C, int KH, int KW, int O,
                                     int pad, int splits, int chunk,
                                     int engine, cudaStream_t stream) {
  if (engine == 1) {
    if (!wgmma_dw_takes(x, g, part, out, N, H, W, C, KH, KW, O, pad, splits,
                        chunk))
      return static_cast<int>(cudaErrorInvalidValue);
    return wgmma_dw(x, g, part, out, N, H, W, C, KH, KW, O, pad, splits,
                    chunk, stream);
  }
  if (engine != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(x, g, part, out, N, H, W, C, KH, KW, O, pad, splits, chunk,
                   stream);
}

// The wgmma filter gradient's instance for tile width bn (64, 128, 256),
// A gathered (gather 1) or by TMA (0): registers, spill bytes, static and
// dynamic shared memory into out[0..4).
PTT_EXPORT int ptt_conv_dw_wgmma_attributes(int bn, int gather, int* out) {
  return gather ? wgmma_dw_attributes_bn<true>(bn, out)
                : wgmma_dw_attributes_bn<false>(bn, out);
}

// The split-TF32 filter gradient's instance for tile width bn (64, 128):
// registers, spill bytes, static and dynamic shared memory into out[0..4).
PTT_EXPORT int ptt_conv_dw_tf32_attributes(int bn, int* out) {
  return bn == 64 ? tf32_dw_attributes<64>(out) : tf32_dw_attributes<128>(out);
}
