// The float32 GEMM engine on Hopper's warpgroup products in split TF32,
// shared by the matmul (matmul.cu), the stride-1 NHWC implicit-GEMM
// convolution (conv.cu, forward and backward-input) and its filter
// gradient (conv_dw.cu: this block's consumers, its own producer over the
// split pass wgmma_tf32_split_dw_kernel's layout):
//
//   C[M, N] = A[M, K] @ B[K, N], float32 A, B and C, float32 accuracy.
//
// Through those two it replaces, in float32, the TPU kernels
// paddle_tpu/pallas/matmul.py:92 _matmul_impl (at M >= 1024) and
// paddle_tpu/pallas/conv.py:161 _conv_fwd_impl (C % 32 == 0), as the bf16
// engine of wgmma_gemm.cuh does in bf16.  What bounds it on the H100:
// operations.  The SIMT units do 67 TFLOP/s in f32; the tensor cores 495
// in TF32, which keeps 10 mantissa bits.  Each f32 operand x is split as
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32; x - hi is exact,
// hi + lo holds x to 2^-22 |x|), and each product is three TF32 products,
// lo hi + hi lo + hi hi (lo lo, at most 2^-22 |a b|, is dropped): 495 / 3
// = 165 TFLOP/s at float32 accuracy.
//
// The tensor cores truncate their sums (each product's accumulator is cut
// to f32 toward zero), so no long sum runs through them.  Each
// kFreshSteps k8 steps (16 terms, all three products, the small ones
// first) go into a fresh accumulator (scale-d 0 on its first product);
// once wgmma.wait_group has retired them, an f32 add (round to nearest)
// takes it into a mid sum, and every kMidSums fresh sums the mid sum goes
// into the running one: a two-level sum, as a blocked SIMT GEMM sums, so
// that the running sum takes K / 256 rounded adds, not K / 16.  The CPU
// model of tests/test_torch_gemm_tf32.py pins this scheme: with one
// accumulator over K = 8192 the truncation errs about K / 8 ulps one way;
// with fresh sums of 4 k8 steps and no mid sum the largest error passed
// twice a float32 product's at K 8192.  Three accumulators of BN / 2
// floats a thread (the running, mid and fresh sums): 192 registers at BN
// 128, so the tile is 128 x 64 or 128 x 128.
//
// wgmma reads .tf32 operands K-major only (the transpose bit exists for
// 16-bit types), so both operands reach the engine as rows of K, split
// beforehand by a pass on the caller's stream into scratch the wrapper
// allocates: A (the matmul's x, the conv's NHWC image) keeps its layout
// as hi and lo copies; B is written transposed, as (N, K) hi and lo (the
// matmul's y (K, N); the conv's w (KH * KW * C, O) to (O, KH * KW * C);
// for the backward-input the forward's filter, spatially flipped and
// channel-swapped in the same pass).  The pass moves 12 bytes an element
// of A and B; splitting A inside the kernel is later work.
//
// The block is the bf16 engine's (wgmma_gemm.cuh): 128 x BN of C, three
// warpgroups (a producer at kProducerRegs registers, two consumers of 64
// rows at kConsumerRegs), a ring of kStages<BN> stages with full and
// empty mbarriers, group-M rasterisation, the epilogue through a staging
// tile.  A stage is 32 f32 of K (one 128-byte row, the same 128-byte
// swizzle and descriptor strides as bf16's 64): A hi and lo (128 rows, 2
// x 16 KB), B hi and lo (BN rows, 2 x BN x 128 bytes); 3 stages at BN
// 128, 4 at BN 64.  The producer brings B by TMA (cp.async.bulk.tensor.2d
// on CU_TENSOR_MAP_DATA_TYPE_FLOAT32 maps), A by TMA when it is a dense
// (M, K) matrix (the matmul, a 1 x 1 conv), else gathered from the split
// image with 16-byte cp.async copies to their swizzled places, halo pixels
// zero-filled, published kStages - 2 stages late after
// fence.proxy.async (a 32-wide K step lies inside one tap: C % 32 == 0).
// A consumer issues wgmma.m64n{BN}k8.f32.tf32.tf32, four k8 steps a
// stage, three products a step; its epilogue writes f32 32 columns at a
// time to the staging tile and out as 16-byte rows, masked at M and N.
// Everything outside [0, M) x [0, K) x [0, N) reads as zero.  With
// kStats (the fused conv + BN statistics, conv.cu) each consumer then
// forms the column sums and sums of squares of its merged f32 sums
// (wgmma_gemm.cuh tile_stats), one partial row per 128-row tile.
//
// Shapes it takes: K % 4 == 0, N % 4 == 0 (TMA's 16-byte strides, the
// epilogue's 16-byte stores), 16-byte-aligned operands, out and scratch,
// and with the gather C % 32 == 0.  The callers check this before a
// launch and refuse anything else.
#pragma once

#include "wgmma_gemm.cuh"

namespace ptt {
namespace wg {
namespace {   // internal linkage, as wgmma_gemm.cuh explains
namespace tf32 {

constexpr int kBK = 32;                  // K step: one 128-byte row of f32
constexpr int kATile = kBM * kBK * 4;    // A hi or lo of a stage (16 KB)
template <int BN>
constexpr int kBTile = BN * kBK * 4;     // B hi or lo of a stage
template <int BN>
constexpr int kStageBytes = 2 * kATile + 2 * kBTile<BN>;
// 192 KB of ring at both widths
template <int BN>
constexpr int kStages = BN == 128 ? 3 : 4;
// k8 steps a fresh sum takes; fresh sums a mid sum takes (see above;
// tests/test_torch_gemm_tf32.py models the same numbers)
constexpr int kFreshSteps = 2;
constexpr int kMidSums = 16;
constexpr int kStepsPerStage = kBK / 8;
static_assert(kStepsPerStage % kFreshSteps == 0, "fresh sums in a stage");
constexpr int kMidStages = kMidSums * kFreshSteps / kStepsPerStage;
static_assert(kMidStages * kStepsPerStage == kMidSums * kFreshSteps,
              "mid sums of whole stages");
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// the epilogue's staging tile of a consumer: 64 rows of 32 f32, rows
// padded to 40 (160 bytes) so that neither the float2 writes of a half
// warp nor the 16-byte row reads meet in a bank
constexpr int kOutCols = 32;
constexpr int kOutLd = kOutCols + 8;
constexpr int kOutTile = 64 * kOutLd * 4;
template <int BN>
constexpr int kSmemBytes = kStages<BN> * kStageBytes<BN> + 16 * kStages<BN> +
                           16 * kBM + 2 * kOutTile + 1024;
static_assert(kSmemBytes<128> <= 232448 && kSmemBytes<64> <= 232448,
              "shared memory a block may use");

// The conv's image geometry for the gathered A: the split image's hi and
// lo copies (unused by a dense A).
struct Geom {
  const float* xh;
  const float* xl;
  int H, W, C, KW, pad, OH, OW;
};

// d (64 x n f32) = A (64 x 8 tf32, desc da) @ B (8 x n tf32, desc db),
// both K-major, plus d when acc != 0; the fragment layout of d is the
// bf16 engine's (wgmma_gemm.cuh wgmma_m64n64).
__device__ __forceinline__ void mma_m64n64(float (&d)[32], uint64_t da,
                                           uint64_t db, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_m64n128(float (&d)[64], uint64_t da,
                                           uint64_t db, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                    uint64_t db, uint32_t acc) {
  if constexpr (BN == 128)
    mma_m64n128(d, da, db, acc);
  else
    mma_m64n64(d, da, db, acc);
}

// tf32(x): round to nearest, ties away from zero, to 10 mantissa bits
// (the f32 bits with the low 13 cleared).
__device__ __forceinline__ float tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - hi);
}

__device__ __forceinline__ void split4(const float4& v, float4& h, float4& l) {
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
}

// hi and lo of n4 float4s, in place of their layout.
__global__ void __launch_bounds__(256)
    wgmma_tf32_split_rows_kernel(const float4* __restrict__ x,
                                 float4* __restrict__ hi,
                                 float4* __restrict__ lo, long long n4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * 256) {
    float4 h, l;
    split4(x[i], h, l);
    hi[i] = h;
    lo[i] = l;
  }
}

// hi and lo of in (T, R, S) transposed: out[s][t][r] = in[t][r][s], in
// 32 x 32 tiles through shared memory (a block each, s tiles fastest).
__global__ void __launch_bounds__(256)
    wgmma_tf32_split_t_kernel(const float* __restrict__ in,
                              float* __restrict__ hi, float* __restrict__ lo,
                              int T, int R, int S) {
  __shared__ float tile[32][33];
  const long long ns = (S + 31) / 32, nr = (R + 31) / 32;
  long long b = blockIdx.x;
  const int s0 = static_cast<int>(b % ns) * 32;
  b /= ns;
  const int r0 = static_cast<int>(b % nr) * 32;
  const int t = static_cast<int>(b / nr);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* src = in + static_cast<long long>(t) * R * S;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, s = s0 + tx;
    tile[i][tx] = (r < R && s < S) ? src[static_cast<long long>(r) * S + s]
                                   : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int s = s0 + i, r = r0 + tx;
    if (s < S && r < R) {
      const long long o = (static_cast<long long>(s) * T + t) * R + r;
      split(tile[tx][i], hi[o], lo[o]);
    }
  }
}

// hi and lo of in (T, R, S) with T reversed and R moved out:
// out[r][t][s] = in[T - 1 - t][r][s], S4 = S / 4 float4s a row.
__global__ void __launch_bounds__(256)
    wgmma_tf32_split_flip_kernel(const float4* __restrict__ in,
                                 float4* __restrict__ hi,
                                 float4* __restrict__ lo, int T, int R,
                                 int S4, long long n4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * 256) {
    const long long s = i % S4, rt = i / S4;
    const long long t = rt % T, r = rt / T;
    float4 h, l;
    split4(in[((T - 1 - t) * R + r) * S4 + s], h, l);
    hi[i] = h;
    lo[i] = l;
  }
}

// The filter gradient's pixel layout (conv_dw.cu): pixel (n, h, w) of an
// (N, H, W) batch at position lead + n (H + pad) WP + h WP + w, WP =
// dw_row (W + pad rounded up to 4; W for pad 0), every other position
// zero: each image row is followed by WP - W >= pad zero columns and each
// image by pad zero rows, so that a tap (kh, kw) of a SAME stride-1 filter
// is the offset (kh - pad) WP + kw - pad along it, and its halo reads
// zeros.  g takes lead 0: its dw_pixels positions are the reduction's.  x
// comes in KW copies, copy j shifted by j - pad positions, each with
// dw_lead zeros at both ends (dw_pixels_x positions): tap (kh, kw) reads
// copy kw at k + dw_lead + (kh - pad) WP for g's position k, a multiple of
// 4 (16 bytes) when k is, and never before the copy's first position.  So
// every TMA box of the products starts 16-byte aligned inside its tensor
// (TMA zero-fills only past the end).  Lengths are multiples of 4 (TMA's
// 16-byte row strides).
inline int dw_row(int W, int pad) { return pad ? (W + pad + 3) / 4 * 4 : W; }

inline int dw_lead(int W, int pad) {
  return (pad * dw_row(W, pad) + pad + 3) / 4 * 4;
}

inline long long dw_pixels(int N, int H, int W, int pad) {
  const long long n = static_cast<long long>(N) * (H + pad) * dw_row(W, pad);
  return (n + 3) / 4 * 4;
}

inline long long dw_pixels_x(int N, int H, int W, int pad) {
  return dw_pixels(N, H, W, pad) + 2 * dw_lead(W, pad);
}

// hi and lo of an NHWC image in (N, H, W, R) transposed into that layout
// with `lead` zeros first, in `copies` copies of R rows, copy j shifted
// by shift0 + j positions: out[j R + r][p] for p < P holds the pixel at
// position p + shift0 + j - lead of the unshifted layout, zero where no
// pixel is (R % 4 == 0 and `in` 16-byte aligned; R % 32 == 0 when copies
// > 1, so that a tile of 32 rows lies in one copy).  32 x 32 tiles
// through shared memory, a block each, position tiles fastest: thread t
// reads channels 4 (t % 8) .. + 3 of position t / 8 as one float4 (one
// pixel lookup for four channels), then each warp writes 32 neighbouring
// positions of a row.
__global__ void __launch_bounds__(256)
    wgmma_tf32_split_dw_kernel(const float* __restrict__ in,
                               float* __restrict__ hi, float* __restrict__ lo,
                               int N, int H, int W, int R, int wp, int pad,
                               int lead, int shift0, int copies, int P) {
  __shared__ float tile[32][33];
  const int np = (P + 31) / 32;
  const int p0 = static_cast<int>(blockIdx.x % np) * 32;
  const int r0 = static_cast<int>(blockIdx.x / np) * 32;
  const int copy = r0 / R;
  const int img = (H + pad) * wp;
  {
    // position p0 + i: pixel (n, h, w) if h < H and w < W
    const int i = threadIdx.x / 8, c = 4 * (threadIdx.x % 8);
    const int q = p0 + i + shift0 + copy - lead;
    const int n = q >= 0 ? q / img : N;
    const int rem = q - n * img;
    const int h = rem / wp;
    const int w = rem - h * wp;
    const int r = r0 - copy * R + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N && h < H && w < W && r < R)
      v = *reinterpret_cast<const float4*>(
          in + ((static_cast<long long>(n) * H + h) * W + w) * R + r);
    tile[c][i] = v.x;
    tile[c + 1][i] = v.y;
    tile[c + 2][i] = v.z;
    tile[c + 3][i] = v.w;
  }
  __syncthreads();
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int row = r0 + i, p = p0 + tx;
    if (row < copies * R && p < P) {
      const long long o = static_cast<long long>(row) * P + p;
      split(tile[i][tx], hi[o], lo[o]);
    }
  }
}

// The producer with a dense A (one thread): each stage's A hi and lo
// boxes (32 K x 128 rows) and B hi and lo boxes (32 K x BN rows) by TMA.
template <int BN>
__device__ __forceinline__ void produce_tma(const CUtensorMap* ah,
                                            const CUtensorMap* al,
                                            const CUtensorMap* bh,
                                            const CUtensorMap* bl,
                                            uint32_t base, uint32_t full0,
                                            uint32_t empty0, int m0, int n0,
                                            int KT) {
  constexpr int S = kStages<BN>;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    const uint32_t a = base + s * kStageBytes<BN>;
    const uint32_t b = a + 2 * kATile;
    mbar_expect_tx(full, kStageBytes<BN>);
    tma_load_2d(a, ah, kt * kBK, m0, full);
    tma_load_2d(a + kATile, al, kt * kBK, m0, full);
    tma_load_2d(b, bh, kt * kBK, n0, full);
    tma_load_2d(b + kBTile<BN>, bl, kt * kBK, n0, full);
  }
}

// The producer with a gathered A (all 128 threads of warpgroup 0), as
// wgmma_gemm.cuh's produce_gather: thread t copies 16-byte chunk t % 8 of
// rows t / 8 + 16 i (i < 8) of both A hi and A lo; B hi and lo by TMA
// from thread 0; a stage published kStages - 2 stages later.
template <int BN>
__device__ __forceinline__ void produce_gather(const CUtensorMap* bh,
                                               const CUtensorMap* bl,
                                               const Geom& g, int4* rows,
                                               uint32_t base, uint32_t full0,
                                               uint32_t empty0, int m0, int n0,
                                               int M, int KT) {
  constexpr int S = kStages<BN>;
  constexpr int L = S - 2;
  const int t = threadIdx.x;
  {
    // (first pixel of the image, oh, ow) of row t; oh far below zero
    // past M, so every tap of it is a zero fill
    int4 r = make_int4(0, -(1 << 30), 0, 0);
    const int m = m0 + t;
    if (m < M) {
      const int img = g.OH * g.OW;
      const int n = m / img;
      const int p = m - n * img;
      const int oh = p / g.OW;
      r = make_int4(n * g.H * g.W, oh, p - oh * g.OW, 0);
    }
    rows[t] = r;
  }
  warpgroup_sync(1);
  const int j = t % 8;
  const int r0 = t / 8;
  const uint32_t dst0 = r0 * 128 + ((j ^ (r0 % 8)) << 4);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
    const uint32_t a = base + s * kStageBytes<BN>;
    const int k0 = kt * kBK;
    if (t == 0) {
      const uint32_t full = full0 + 8 * s;
      const uint32_t b = a + 2 * kATile;
      mbar_expect_tx(full, 2 * kBTile<BN>);
      tma_load_2d(b, bh, k0, n0, full);
      tma_load_2d(b + kBTile<BN>, bl, k0, n0, full);
    }
    // the K step lies inside one tap (kh, kw): channels c0 .. c0 + 31
    const int tap = k0 / g.C;
    const int c = k0 - tap * g.C + 4 * j;
    const int dh = tap / g.KW - g.pad;
    const int dw = tap % g.KW - g.pad;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 r = rows[r0 + 16 * i];
      const int ih = r.y + dh;
      const int iw = r.z + dw;
      const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
      const long long off =
          ok ? static_cast<long long>(r.x + ih * g.W + iw) * g.C + c : 0;
      const uint32_t dst = a + dst0 + i * 16 * 128;
      cp_async16_zfill(dst, g.xh + off, ok);
      cp_async16_zfill(dst + kATile, g.xl + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (kt >= L) {
      cp_async_wait_n<L>();
      fence_proxy_async();
      mbar_arrive(full0 + 8 * ((kt - L) % S));
    }
  }
  cp_async_wait_n<0>();
  fence_proxy_async();
  for (int kt = KT > L ? KT - L : 0; kt < KT; ++kt)
    mbar_arrive(full0 + 8 * (kt % S));
}

// A consumer warpgroup (cw 0 or 1: rows 64 cw .. 64 cw + 63 of the tile):
// the split products over the ring in fresh, mid and running sums, then
// the f32 epilogue through its staging tile, and with kStats the
// statistics of the merged sums (tile_stats; psum of gridDim.x x N
// floats, psq after it; both consumers must take part).
template <int BN, bool kStats = false>
__device__ __forceinline__ void consume(uint32_t base, uint32_t full0,
                                        uint32_t empty0, float* staging,
                                        float* __restrict__ out, int m0,
                                        int n0, int M, int N, int KT,
                                        float* __restrict__ psum = nullptr) {
  constexpr int S = kStages<BN>;
  constexpr int R = BN / 2;
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  // the fresh sum is never zeroed: its first product has scale-d 0
  float acc[R], mid[R], part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = mid[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(full0 + 8 * s, (kt / S) & 1);
    const uint32_t a = base + s * kStageBytes<BN>;
    // both operands K-major, 8-row groups 1024 bytes apart; lo 16 KB
    // (A) or kBTile (B) past hi; a k8 step is 32 bytes along the rows
    const uint64_t dah = desc_sw128(a + cw * 64 * 128, 16, 1024);
    const uint64_t dal = dah + (kATile >> 4);
    const uint64_t dbh = desc_sw128(a + 2 * kATile, 16, 1024);
    const uint64_t dbl = dbh + (kBTile<BN> >> 4);
#pragma unroll
    for (int f = 0; f < kStepsPerStage; f += kFreshSteps) {
      fence_operands<BN>(part);
      wgmma_fence();
#pragma unroll
      for (int kk = f; kk < f + kFreshSteps; ++kk) {
        mma<BN>(part, dal + 2 * kk, dbh + 2 * kk, kk > f);
        mma<BN>(part, dah + 2 * kk, dbl + 2 * kk, 1);
        mma<BN>(part, dah + 2 * kk, dbh + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<BN>(part);
#pragma unroll
      for (int i = 0; i < R; ++i) mid[i] += part[i];
    }
    if (t % 32 == 0) mbar_arrive(empty0 + 8 * s);
    if ((kt + 1) % kMidStages == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i] += mid[i];
        mid[i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += mid[i];

  // 32 columns at a time: the fragment into the staging tile as float2,
  // a barrier, then each row of it out as 16-byte stores (8 lanes a
  // row), masked at M and N (N % 4 == 0: a chunk is all in or all out),
  // and a barrier before the next 32 columns overwrite it.
  const int lane = t % 32;
  const int fr = 16 * (t / 32) + lane / 4;
  const int fc = 2 * (lane % 4);
#pragma unroll
  for (int c = 0; c < BN / kOutCols; ++c) {
#pragma unroll
    for (int j = 0; j < kOutCols / 8; ++j) {
      const int q = 4 * (kOutCols / 8 * c + j);
      *reinterpret_cast<float2*>(staging + fr * kOutLd + 8 * j + fc) =
          make_float2(acc[q], acc[q + 1]);
      *reinterpret_cast<float2*>(staging + (fr + 8) * kOutLd + 8 * j + fc) =
          make_float2(acc[q + 2], acc[q + 3]);
    }
    warpgroup_sync(2 + cw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * i + t / 8;
      const int m = m0 + 64 * cw + r;
      const int n = n0 + kOutCols * c + 4 * (t % 8);
      if (m < M && n < N)
        *reinterpret_cast<float4*>(out + static_cast<long long>(m) * N + n) =
            *reinterpret_cast<const float4*>(staging + r * kOutLd +
                                             4 * (t % 8));
    }
    warpgroup_sync(2 + cw);
  }
  if constexpr (kStats)
    tile_stats<BN>(acc, staging - cw * (kOutTile / 4), kOutTile / 4, psum,
                   psum + static_cast<long long>(gridDim.x) * N, m0 / kBM,
                   n0, N);
}

// psum: with kStats, the statistics scratch (2 x gridDim.x x N floats);
// unused otherwise.
template <int BN, bool kGather, bool kStats = false>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_tf32_kernel(const __grid_constant__ CUtensorMap tm_ah,
                      const __grid_constant__ CUtensorMap tm_al,
                      const __grid_constant__ CUtensorMap tm_bh,
                      const __grid_constant__ CUtensorMap tm_bl,
                      const Geom geom, float* __restrict__ out, int M, int N,
                      int K, float* __restrict__ psum) {
  constexpr int S = kStages<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + S * kStageBytes<BN>;
  const uint32_t empty0 = full0 + 8 * S;
  uint8_t* tables = smem_raw + (base - raw) + S * kStageBytes<BN> + 16 * S;
  int4* rows = reinterpret_cast<int4*>(tables);
  float* staging = reinterpret_cast<float*>(tables + 16 * kBM);
  // group-M rasterisation, as wgmma_gemm_kernel
  int m0, n0;
  {
    const int id = blockIdx.y * gridDim.x + blockIdx.x;
    const int per = kGroupM * gridDim.y;
    const int first = id / per * kGroupM;
    const int left = static_cast<int>(gridDim.x) - first;
    const int rows_in = left < kGroupM ? left : kGroupM;
    m0 = (first + id % per % rows_in) * kBM;
    n0 = id % per / rows_in * BN;
  }
  const int KT = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, kGather ? 129 : 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if constexpr (kGather)
      produce_gather<BN>(&tm_bh, &tm_bl, geom, rows, base, full0, empty0, m0,
                         n0, M, KT);
    else if (threadIdx.x == 0)
      produce_tma<BN>(&tm_ah, &tm_al, &tm_bh, &tm_bl, base, full0, empty0,
                      m0, n0, KT);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<BN, kStats>(base, full0, empty0,
                        staging + (threadIdx.x / 128 - 1) * (kOutTile / 4),
                        out, m0, n0, M, N, KT, psum);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The map of a row-major rows x cols f32 matrix cut in boxes of 32
// columns (128 bytes) x box_rows, 128-byte swizzle, zeros outside; 0 or an
// error code.
inline int encode_f32(CUtensorMap* map, const float* p, int cols, int rows,
                      int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoTensorMapEncode;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// Blocks of a grid-stride split pass over n4 float4s: at most 8 waves of
// 256-thread blocks on 132 SMs.
inline unsigned split_blocks(long long n4) {
  const long long b = (n4 + 255) / 256;
  return static_cast<unsigned>(b < 132 * 8 ? (b > 0 ? b : 1) : 132 * 8);
}

// hi at s, lo at s + n: the split of the n floats of x (n % 4 == 0).
inline int split_rows(const float* x, float* s, long long n,
                      cudaStream_t stream) {
  wgmma_tf32_split_rows_kernel<<<split_blocks(n / 4), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(s),
      reinterpret_cast<float4*>(s + n), n / 4);
  return static_cast<int>(cudaGetLastError());
}

// hi at s, lo at s + T R S: the split of in (T, R, S) as (S, T, R).
inline int split_t(const float* in, float* s, int T, int R, int S,
                   cudaStream_t stream) {
  const long long n = static_cast<long long>(T) * R * S;
  const long long blocks = static_cast<long long>(T) * ((R + 31) / 32) *
                           ((S + 31) / 32);
  wgmma_tf32_split_t_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                              stream>>>(in, s, s + n, T, R, S);
  return static_cast<int>(cudaGetLastError());
}

// hi at s, lo at s + copies R P: the split of the NHWC image in (N, H, W,
// R) in the filter gradient's layout (wgmma_tf32_split_dw_kernel), P
// positions (dw_pixels or dw_pixels_x, <= INT_MAX).
inline int split_dw(const float* in, float* s, int N, int H, int W, int R,
                    int pad, int lead, int shift0, int copies, int P,
                    cudaStream_t stream) {
  const long long rows = static_cast<long long>(copies) * R;
  const long long blocks =
      static_cast<long long>((P + 31) / 32) * ((rows + 31) / 32);
  wgmma_tf32_split_dw_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                               stream>>>(in, s, s + rows * P, N, H, W, R,
                                         dw_row(W, pad), pad, lead, shift0,
                                         copies, P);
  return static_cast<int>(cudaGetLastError());
}

// hi at s, lo at s + T R S: the split of in (T, R, S) as (R, T, S) with T
// reversed (S % 4 == 0).
inline int split_flip(const float* in, float* s, int T, int R, int S,
                      cudaStream_t stream) {
  const long long n = static_cast<long long>(T) * R * S;
  wgmma_tf32_split_flip_kernel<<<split_blocks(n / 4), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(s),
      reinterpret_cast<float4*>(s + n), T, R, S / 4, n / 4);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool kGather, bool kStats>
int launch(const CUtensorMap (&maps)[4], const Geom& g, float* out, int M,
           int N, int K, float* psum, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only once allowed, per instance
  static const cudaError_t allowed = cudaFuncSetAttribute(
      wgmma_tf32_kernel<BN, kGather, kStats>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<BN>);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  wgmma_tf32_kernel<BN, kGather, kStats>
      <<<grid, kThreads, kSmemBytes<BN>, stream>>>(
          maps[0], maps[1], maps[2], maps[3], g, out, M, N, K, psum);
  return static_cast<int>(cudaGetLastError());
}

// The tile width for N columns: 64 up to 64, else 128.
inline int tile_n(int n) { return n > 64 ? 128 : 64; }

// Encode the maps of A hi / lo (a_rows x K, at a and a + a_rows K) and B
// hi / lo (N x K, at b and b + N K), then launch (with kStats, out's
// column statistics into psum: 2 x ceil(M / kBM) x N floats).
template <bool kGather, bool kStats = false>
int launch_split(const float* a, int a_rows, const float* b, const Geom& g,
                 float* out, int M, int N, int K, cudaStream_t stream,
                 float* psum = nullptr) {
  const int bn = tile_n(N);
  const long long an = static_cast<long long>(a_rows) * K;
  const long long bnk = static_cast<long long>(N) * K;
  CUtensorMap maps[4];
  int err = 0;
  if (!kGather) {
    err = encode_f32(&maps[0], a, K, a_rows, kBM);
    if (err == 0) err = encode_f32(&maps[1], a + an, K, a_rows, kBM);
  } else {
    maps[0] = maps[1] = CUtensorMap{};
  }
  if (err == 0) err = encode_f32(&maps[2], b, K, N, bn);
  if (err == 0) err = encode_f32(&maps[3], b + bnk, K, N, bn);
  if (err != 0) return err;
  return bn == 64
             ? launch<64, kGather, kStats>(maps, g, out, M, N, K, psum, stream)
             : launch<128, kGather, kStats>(maps, g, out, M, N, K, psum,
                                            stream);
}

// Whether the engine takes these operands: K % 4 == 0 and N % 4 == 0 (a
// row's bytes a multiple of 16), 16-byte-aligned A, B, out and scratch.
inline bool takes(int K, int N, const void* a, const void* b, const void* out,
                  const void* as, const void* bs) {
  return K > 0 && K % 4 == 0 && N > 0 && N % 4 == 0 && aligned16(a) &&
         aligned16(b) && aligned16(out) && aligned16(as) && aligned16(bs);
}

// out[M, N] = a[M, K] @ b[K, N] (b row-major): a split into as (2 M K
// floats), b split and transposed into bs (2 K N floats), A by TMA.
inline int gemm_dense(const float* a, const float* b, float* as, float* bs,
                      float* out, int M, int N, int K, cudaStream_t stream) {
  int err = split_rows(a, as, static_cast<long long>(M) * K, stream);
  if (err == 0) err = split_t(b, bs, 1, K, N, stream);
  if (err != 0) return err;
  const Geom g{nullptr, nullptr, 0, 0, 0, 0, 0, 0, 0};
  return launch_split<false>(as, M, bs, g, out, M, N, K, stream);
}

// out[0..4): registers, local (spill) bytes, static and dynamic shared
// memory of the instance for tile width bn; 0 or a cudaError_t.
template <int BN, bool kGather>
int attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, wgmma_tf32_kernel<BN, kGather>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kSmemBytes<BN>;
  return 0;
}

template <bool kGather>
int attributes_bn(int bn, int* out) {
  return bn == 64 ? attributes<64, kGather>(out)
                  : attributes<128, kGather>(out);
}

}  // namespace tf32
}  // namespace
}  // namespace wg
}  // namespace ptt
