// Flash attention: the forward (out and the per-row logsumexp) and the
// two backward kernels (dq; dk and dv), on (B, S, H, D) tensors read
// through their strides, in a float32 and a bf16 instance (the element
// type of q, k, v, do, out, dq, dk and dv; lse and delta are float32 in
// both).
//
// Replaces the TPU kernels of paddle_tpu/pallas/flash_attention.py:
//   - _flash_fwd_impl (:145, _fwd_kernel :96): online softmax over the
//     K/V blocks, the running max m, normaliser l and the accumulator
//     carried across a sequential grid axis in VMEM;
//   - _flash_bwd_impl (:277): _dq_kernel (:191, call :293) and
//     _dkv_kernel (:231, call :313), both recomputing p = exp(s - lse)
//     from the forward's logsumexp, with delta = rowsum(do * o) - dlse.
// On Hopper the blocks run in parallel, so each block owns one output
// tile and loops over the other axis itself: the forward and dq one
// block per (b*h, query tile) looping over the key tiles, dk/dv one
// block per (b*h, key tile) looping over the query tiles.  Each output
// tile has one owner, so there are no atomics and every sum has a fixed
// order.  Causal blocks stop at (forward, dq) or start from (dk/dv) the
// diagonal tile, as the TPU kernel skips the strictly-upper blocks, the
// longest blocks are scheduled first, and only the diagonal and ragged
// tiles are masked.  Rows past S and columns past D are read as zero, so
// any S and any D <= 256 work (the TPU kernel needs S divisible by a
// block of at least 128).
//
// What bounds them on the H100: operations.  At the transformer's shape
// (B*H = 128, S = 1024, D = 128, causal) the forward does 2 products of
// 2 * BH * S(S+1)/2 * D FLOPs (34.4 GFLOP: 0.035 ms at 989 TFLOP/s bf16,
// 0.51 ms at 67 TFLOP/s f32), dq 3 and dk/dv 4 such products, while the
// bytes (q, k, v, o, do at 34 MB each in bf16) take 0.05 ms at 3.35 TB/s.
//
// The float32 SIMT kernels (ptt_flash_{fwd,dq,dkv}_f32_simt, which the
// wrapper no longer launches: they stay to be timed and checked beside the
// split-TF32 ones).  A tile is BT query or key rows, 64 for D <= 128 and
// 32 for D <= 256, so that the f32 tiles fit the 227 KB of shared memory a
// block may have (dk/dv holds six: 165 KB at D 128, one block per SM).  A
// block of 4 * BT threads computes each BT x BT score tile as 4 x (BT /
// 16) sub-tiles per thread with fmaf, rows ty + (BT / 4) i and columns
// tx + 16 j, so a row's max and sum are shuffles over 16 lanes; the
// products with V, K, Q and dO give each thread the same 4 rows and the
// head-dim columns tx + 16 j.  Tiles read across rows at one d have a row
// pitch of DPAD + 1.  Bound by shared-memory loads (two FMAs a load).
//
// float32 (ptt_flash_{fwd,dq,dkv}_f32, namespace tf32): the tensor cores in
// split TF32.  Each f32 operand x is hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna.tf32.f32; x - hi is exact), and each product is three
// mma.sync.m16n8k8 tf32 with f32 sums, lo hi + hi lo + hi hi; lo lo (at most
// 2^-22 |a b|) is dropped.  hi + lo holds x to 2^-22 |x|, so a product keeps
// float32 accuracy, and nothing else is rounded (the f32 function rounds
// nothing, unlike the bf16 instance).  The tensor cores truncate their sums, so
// no long sum runs through them: in a product over the head dim the hi hi terms
// of each 4 k8 steps (32 terms) go into a fresh accumulator, which an f32 add
// (round to nearest) takes into the running one, while lo hi and hi lo, 2^-10
// of it, run in an accumulator of their own; in a product over keys or queries
// each 2 k8 steps (16 terms, all three products, the small ones first) go into
// a fresh accumulator.  Summed in one accumulator, or in 32-term chunks of all
// three products, the error against float64 passed twice the SIMT kernels' at S
// 200 (kStepsD, kStepsS).  cvt.rna.tf32.f32 compiles to four instructions (an
// add, an inf/NaN test, a select, a mask), so a split costs nine, and split at
// every fragment load the conversions took most of the issue slots
// (chip_smoke.py's phase 1 prints the opcode counts).  So the streaming operand
// (k and v in dq; q and do in dk/dv) is split once a tile, by all the block's
// threads, into hi and lo tiles that every warp reads as they are; the resident
// operand (q and do in dq; k and v in dk/dv), each warp's own rows, is split as
// its fragments load, once a k8 step for 2-4 n8 tiles; p and ds, made in
// registers, are split there.  Scores never leave registers: m16n8k8's f32 C
// fragment gives a lane columns 2t and 2t + 1 where the tf32 A fragment wants
// columns t and t + 4, so the second products (ds k; in dk/dv, which forms S^T
// = k q^T and dP^T = v do^T, p^T do and ds^T q) take the reduction index
// permuted: A's k index t is key (query) 2t and t + 4 is 2t + 1, and the B
// fragment reads rows 2t and 2t + 1 to match.  The [row][d] fragments (both
// operands of q k^T and do v^T) come by ldmatrix, whose b16 pairs are f32
// elements; ldmatrix .trans moves 16-bit elements, so the permuted [key][d] B
// fragments of the second products come by 32-bit shared loads.  f32 tiles are
// unpadded, DPAD floats a row, with the 16-byte chunk c of row r at c ^ (r %
// 8), which makes both conflict-free: ldmatrix's 8 rows of 16 bytes, and the
// 32-bit loads of rows 2t, 2t + 1 at column g.  A block is 8 warps of 16 rows:
// dq 128 query rows over 32-key tiles of K and V, dk/dv 128 key rows over
// 32-query tiles of Q, dO, lse and delta.  Each tile lands raw by 16-byte
// cp.async copies while the previous tile's products run, and is split after
// the next barrier (shared memory at D 128: dq 229,376 bytes, dk/dv 229,888, of
// the 232,448 a block may have; one block an SM); the forward is dq's block
// without dP and ds (163,840 bytes): s = q k^T, the online softmax in the C
// fragments, p split in registers for p V, whose fresh sums join the running
// accumulator after it is rescaled by exp(m_old - m_new).  (Splitting the
// forward's resident q once a block, into hi and lo tiles in dO's room,
// instead of at each fragment load, left its time unchanged on the card.)  At D 256 dq and the
// forward take 64 rows over 16-key tiles and dk/dv 64 key rows over 16-query
// tiles with the head dim split between warp pairs.  out, dq, dk and dv are
// stored from the accumulators as float2 (element-wise stores where the load
// variant is, below).  A split-TF32
// product costs three TF32 products (495 TFLOP/s dense), so its least time is 3
// x FLOPs / 495e12: under the 67 TFLOP/s f32 bound it is held to.
//
// bf16 (ptt_flash_*_bf16, namespace tc): the tensor cores.  Each product
// is mma.sync.m16n8k16 with bf16 operands and f32 sums, and rounds where
// the TPU kernel rounds on bf16 inputs and nowhere else:
//   - q k^T, do v^T (and k q^T, v do^T in dk/dv): the TPU kernel widens
//     bf16 q, k, v, do to f32 and multiplies (:113-116, :218-220); bf16 x
//     bf16 products are exact in f32, so a bf16 mma with f32 sums is the
//     same product;
//   - p v in the forward: p rounded to v's dtype (:130-132), a bf16 mma;
//     l sums the unrounded p; m, l and the accumulator stay f32;
//   - ds k in dq: ds rounded to k's dtype (:222-224), a bf16 mma;
//   - p^T do and ds^T q in dk/dv: the TPU kernel takes p and ds in f32,
//     unrounded (:259-268).  Each is a split pair, hi = bf16(x) and lo =
//     bf16(x - hi), and two bf16 mmas into one f32 accumulator.  x - hi
//     is exact in f32 and |x - hi| <= 2^-8 |x|, so lo misses it by at
//     most 2^-8 |x - hi| <= 2^-16 |x|: a per-term error 2^8 below the one
//     bf16 rounding of dk and dv (2^-8).  No TF32, no rounding of p or ds.
// Scores never leave registers: the f32 C fragments of s = q k^T are
// scaled, masked, exponentiated and re-packed as the bf16x2 A fragments
// of the next product (p v, ds k, or, in dk/dv, which forms S^T = k q^T
// and dP^T = v do^T, the A operands of p^T do and ds^T q); a row's max
// and sum are shuffles over the 4 lanes of a quad.  Fragments come from
// shared memory through ldmatrix (.trans for the B[k][n] operands v, k,
// do and q of the second products).
// Tiles stay bf16 in shared memory, rows padded by 16 bytes so every
// ldmatrix hits 8 distinct banks.  A block is 4 warps.  The forward walks
// 64-key tiles to D 128 and 32-key tiles to D 256 (key_tile() in
// kernels/flash_attention.py: the forward's tile is part of the function,
// since p is rounded against the running max of each tile) for 128 query
// rows to D 128, each warp two m16 row blocks that share every K and V
// fragment, and 64 rows (one block a warp) at D 256, where a second f32
// 16 x 256 accumulator would not fit a thread's registers.  dq: 64 query
// rows, 16 a warp, over the same key tiles.  dk/dv: 64 key rows over
// 64-query tiles to D 128, and at D 256 32 key rows over 32-query tiles
// with the head dim split between warp pairs.  K/V (forward, dq) and
// Q/dO/lse/delta (dk/dv) come through a two-stage ring of 16-byte
// cp.async copies: the next tile's copies are issued before the current
// tile's products.  Shared memory at D 128: forward, dq and dk/dv 102-103
// KB, so two blocks share an SM.  Out, dq, dk and dv are staged through
// shared memory and stored as 16-byte vectors.  Where a base pointer or
// stride is not 16-byte aligned (or D % 8 != 0), the launcher picks the
// same kernel with element-wise loads and stores (kVec false).
// Left for later: wgmma over TMA-fed shared tiles with a producer warp
// (the FlashAttention-3 shape), two row blocks a warp in dq and dk/dv,
// exp2 with the scale folded in; for the split-TF32 kernels, wgmma over
// hi/lo tiles, and the resident operand split once instead of at every
// fragment load.
#include <cuda_bf16.h>
#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // _NEG_INF of the TPU kernel

// Element strides of dims 0 (batch), 1 (sequence) and 2 (head); the
// head dim is contiguous.
struct Strides {
  long long b, s, h;
};

template <int BT, int DPAD>
struct Tile {
  static constexpr int kTY = BT / 4;          // thread rows
  static constexpr int kThreads = 16 * kTY;   // 4 * BT: 256 or 128
  static constexpr int kRS = BT / 16;         // score columns per thread
  static constexpr int kRD = DPAD / 16;       // head-dim columns per thread
  static constexpr int kPitch = DPAD + 1;     // rows read across at one d
  static constexpr int kPPitch = BT + 1;      // score tiles
};

// Rows [row0, row0 + BT) of the (b, h) slice of `src` into shared memory
// with row pitch `pitch`; rows past S and columns past D read as zero.
template <int BT, int DPAD, int NT, class E>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int pitch,
                                          const E* __restrict__ src,
                                          Strides st, int b, int h, int row0,
                                          int S, int D) {
  const E* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < BT * DPAD; idx += NT) {
    const int r = idx / DPAD;
    const int d = idx % DPAD;
    const int s = row0 + r;
    dst[r * pitch + d] = (s < S && d < D) ? base[s * st.s + d] : 0.f;
  }
}

// Entries [row0, row0 + BT) of one (b*h) row of an (BH, S) array.
template <int BT, int NT>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < BT; r += NT)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// Max and sum over the 16 lanes that share a score row.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Store one thread's 4 x RD tile of a contiguous (B, S, H, D) output.
template <int BT, int DPAD, class E>
__device__ __forceinline__ void store_tile(
    E* __restrict__ dst, const float (&acc)[4][Tile<BT, DPAD>::kRD],
    int b, int h, int row0, int H, int S, int D) {
  using T = Tile<BT, DPAD>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + T::kTY * i;
    if (row >= S) continue;
    E* o = dst + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < T::kRD; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[d] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

template <int BT, int DPAD, class E>
__global__ void __launch_bounds__(4 * BT)
    flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, E* __restrict__ out,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, int H, int S, int D, float scale,
                     int causal) {
  using T = Tile<BT, DPAD>;
  constexpr int NT = T::kThreads, TY = T::kTY, RS = T::kRS, RD = T::kRD;
  constexpr int KP = T::kPitch, PP = T::kPPitch;
  extern __shared__ float smem[];
  float* Qs = smem;              // BT x DPAD
  float* Ks = Qs + BT * DPAD;    // BT x KP
  float* Vs = Ks + BT * KP;      // BT x DPAD
  float* Ps = Vs + BT * DPAD;    // BT x PP

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = gridDim.y;
  const int qt = causal ? nt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<BT, DPAD, NT>(Qs, DPAD, q, sq, b, h, q0, S, D);

  float m[4], l[4], acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? qt + 1 : nt;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's products are done
    load_tile<BT, DPAD, NT>(Ks, KP, k, sk, b, h, k0, S, D);
    load_tile<BT, DPAD, NT>(Vs, DPAD, v, sv, b, h, k0, S, D);
    __syncthreads();

    float s[4][RS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[RS];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + TY * i) * DPAD + d];
#pragma unroll
      for (int j = 0; j < RS; ++j) c[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RS; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + TY * i;
      const int row = q0 + r;
      bool ok[RS];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < S && (!causal || col <= row);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[r * PP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int kk_end = min(BT, S - k0);
    for (int kk = 0; kk < kk_end; ++kk) {
      float p[4], c[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + TY * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) c[j] = Vs[kk * DPAD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(p[i], c[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] /= li;
    const int row = q0 + ty + TY * i;
    if (tx == 0 && row < S)
      lse[static_cast<long long>(bh) * S + row] = m[i] + logf(li);
  }
  store_tile<BT, DPAD>(out, acc, b, h, q0, H, S, D);
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <int BT, int DPAD, class E>
__global__ void __launch_bounds__(4 * BT)
    flash_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, E* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sdo, int H,
                    int S, int D, float scale, int causal) {
  using T = Tile<BT, DPAD>;
  constexpr int NT = T::kThreads, TY = T::kTY, RS = T::kRS, RD = T::kRD;
  constexpr int KP = T::kPitch, PP = T::kPPitch;
  extern __shared__ float smem[];
  float* Qs = smem;              // BT x DPAD
  float* dOs = Qs + BT * DPAD;   // BT x DPAD
  float* Ks = dOs + BT * DPAD;   // BT x KP
  float* Vs = Ks + BT * KP;      // BT x KP
  float* dSs = Vs + BT * KP;     // BT x PP
  float* Ls = dSs + BT * PP;     // BT
  float* Ds = Ls + BT;           // BT

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = gridDim.y;
  const int qt = causal ? nt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row_base = static_cast<long long>(bh) * S;

  load_tile<BT, DPAD, NT>(Qs, DPAD, q, sq, b, h, q0, S, D);
  load_tile<BT, DPAD, NT>(dOs, DPAD, dout, sdo, b, h, q0, S, D);
  load_rows<BT, NT>(Ls, lse + row_base, q0, S);
  load_rows<BT, NT>(Ds, delta + row_base, q0, S);

  float acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  const int kend = causal ? qt + 1 : nt;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_tile<BT, DPAD, NT>(Ks, KP, k, sk, b, h, k0, S, D);
    load_tile<BT, DPAD, NT>(Vs, KP, v, sv, b, h, k0, S, D);
    __syncthreads();

    float s[4][RS], dp[4][RS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], c[RS], e[RS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + TY * i) * DPAD + d];
        g[i] = dOs[(ty + TY * i) * DPAD + d];
      }
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        c[j] = Ks[(tx + 16 * j) * KP + d];
        e[j] = Vs[(tx + 16 * j) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RS; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + TY * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < S && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        dSs[r * PP + tx + 16 * j] = p * (dp[i][j] - Ds[r]) * scale;
      }
    }
    __syncthreads();

    const int kk_end = min(BT, S - k0);
    for (int kk = 0; kk < kk_end; ++kk) {
      float ds[4], c[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + TY * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) c[j] = Ks[kk * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(ds[i], c[j], acc[i][j]);
    }
  }
  store_tile<BT, DPAD>(dq, acc, b, h, q0, H, S, D);
}

// ---------------------------------------------------------------------------
// backward: dk and dv
// ---------------------------------------------------------------------------

template <int BT, int DPAD, class E>
__global__ void __launch_bounds__(4 * BT)
    flash_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v,
                     const E* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, E* __restrict__ dk,
                     E* __restrict__ dv, Strides sq, Strides sk,
                     Strides sv, Strides sdo, int H, int S, int D, float scale,
                     int causal) {
  using T = Tile<BT, DPAD>;
  constexpr int NT = T::kThreads, TY = T::kTY, RS = T::kRS, RD = T::kRD;
  constexpr int QP = T::kPitch, PP = T::kPPitch;
  extern __shared__ float smem[];
  float* Ks = smem;              // BT x DPAD
  float* Vs = Ks + BT * DPAD;    // BT x DPAD
  float* Qs = Vs + BT * DPAD;    // BT x QP
  float* dOs = Qs + BT * QP;     // BT x QP
  float* Pt = dOs + BT * QP;     // BT x PP: p transposed, key rows
  float* dSt = Pt + BT * PP;     // BT x PP
  float* Ls = dSt + BT * PP;     // BT
  float* Ds = Ls + BT;           // BT

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nt = gridDim.y;
  const int kt = blockIdx.y;     // causal: the low key tiles loop longest
  const int k0 = kt * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row_base = static_cast<long long>(bh) * S;

  load_tile<BT, DPAD, NT>(Ks, DPAD, k, sk, b, h, k0, S, D);
  load_tile<BT, DPAD, NT>(Vs, DPAD, v, sv, b, h, k0, S, D);

  float adk[4][RD], adv[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int qt = causal ? kt : 0; qt < nt; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_tile<BT, DPAD, NT>(Qs, QP, q, sq, b, h, q0, S, D);
    load_tile<BT, DPAD, NT>(dOs, QP, dout, sdo, b, h, q0, S, D);
    load_rows<BT, NT>(Ls, lse + row_base, q0, S);
    load_rows<BT, NT>(Ds, delta + row_base, q0, S);
    __syncthreads();

    // transposed scores: rows are keys, columns queries
    float st[4][RS], dpt[4][RS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RS; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], e[4], c[RS], g[RS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(ty + TY * i) * DPAD + d];
        e[i] = Vs[(ty + TY * i) * DPAD + d];
      }
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        c[j] = Qs[(tx + 16 * j) * QP + d];
        g[j] = dOs[(tx + 16 * j) * QP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RS; ++j) {
          st[i][j] = fmaf(a[i], c[j], st[i][j]);
          dpt[i][j] = fmaf(e[i], g[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + TY * i;
      const int krow = k0 + r;
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int qc = tx + 16 * j;
        const int qrow = q0 + qc;
        const bool ok = qrow < S && (!causal || qrow >= krow);
        const float p = ok ? expf(st[i][j] * scale - Ls[qc]) : 0.f;
        Pt[r * PP + qc] = p;
        dSt[r * PP + qc] = p * (dpt[i][j] - Ds[qc]) * scale;
      }
    }
    __syncthreads();

    const int qq_end = min(BT, S - q0);
    for (int qq = 0; qq < qq_end; ++qq) {
      float pa[4], da[4], g[RD], c[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Pt[(ty + TY * i) * PP + qq];
        da[i] = dSt[(ty + TY * i) * PP + qq];
      }
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        g[j] = dOs[qq * QP + tx + 16 * j];
        c[j] = Qs[qq * QP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          adv[i][j] = fmaf(pa[i], g[j], adv[i][j]);
          adk[i][j] = fmaf(da[i], c[j], adk[i][j]);
        }
    }
  }
  store_tile<BT, DPAD>(dk, adk, b, h, k0, H, S, D);
  store_tile<BT, DPAD>(dv, adv, b, h, k0, H, S, D);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int BT, int DPAD>
constexpr size_t fwd_smem() {
  using T = Tile<BT, DPAD>;
  return sizeof(float) * (2 * BT * DPAD + BT * T::kPitch + BT * T::kPPitch);
}

template <int BT, int DPAD>
constexpr size_t dq_smem() {
  using T = Tile<BT, DPAD>;
  return sizeof(float) *
         (2 * BT * DPAD + 2 * BT * T::kPitch + BT * T::kPPitch + 2 * BT);
}

template <int BT, int DPAD>
constexpr size_t dkv_smem() {
  using T = Tile<BT, DPAD>;
  return sizeof(float) *
         (2 * BT * DPAD + 2 * BT * T::kPitch + 2 * BT * T::kPPitch + 2 * BT);
}

template <int BT, int DPAD, class E>
int fwd(const E* q, const E* k, const E* v, E* out, float* lse, int B, int H,
        int S, int D, Strides sq, Strides sk, Strides sv, float scale,
        int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<BT, DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<BT, DPAD, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BT - 1) / BT);
  flash_fwd_kernel<BT, DPAD, E>
      <<<grid, Tile<BT, DPAD>::kThreads, smem, stream>>>(
          q, k, v, out, lse, sq, sk, sv, H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BT, int DPAD, class E>
int dq(const E* q, const E* k, const E* v, const E* dout, const float* lse,
       const float* delta, E* dqo, int B, int H, int S, int D, Strides sq,
       Strides sk, Strides sv, Strides sdo, float scale, int causal,
       cudaStream_t stream) {
  constexpr size_t smem = dq_smem<BT, DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<BT, DPAD, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BT - 1) / BT);
  flash_dq_kernel<BT, DPAD, E>
      <<<grid, Tile<BT, DPAD>::kThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, dqo, sq, sk, sv, sdo, H, S, D, scale,
          causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BT, int DPAD, class E>
int dkv(const E* q, const E* k, const E* v, const E* dout, const float* lse,
        const float* delta, E* dko, E* dvo, int B, int H, int S, int D,
        Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
        int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<BT, DPAD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<BT, DPAD, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BT - 1) / BT);
  flash_dkv_kernel<BT, DPAD, E>
      <<<grid, Tile<BT, DPAD>::kThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, dko, dvo, sq, sk, sv, sdo, H, S, D,
          scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The tile for head dim D: 64 rows to D 128, 32 rows to D 256.
template <class E>
int fwd_any(const E* q, const E* k, const E* v, E* out, float* lse, int B,
            int H, int S, int D, Strides sq, Strides sk, Strides sv,
            float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return fwd<64, 64>(q, k, v, out, lse, B, H, S, D, sq, sk, sv, scale,
                       causal, stream);
  if (D <= 128)
    return fwd<64, 128>(q, k, v, out, lse, B, H, S, D, sq, sk, sv, scale,
                        causal, stream);
  if (D <= 256)
    return fwd<32, 256>(q, k, v, out, lse, B, H, S, D, sq, sk, sv, scale,
                        causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class E>
int dq_any(const E* q, const E* k, const E* v, const E* dout,
           const float* lse, const float* delta, E* dqo, int B, int H, int S,
           int D, Strides sq, Strides sk, Strides sv, Strides sdo,
           float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return dq<64, 64>(q, k, v, dout, lse, delta, dqo, B, H, S, D, sq, sk, sv,
                      sdo, scale, causal, stream);
  if (D <= 128)
    return dq<64, 128>(q, k, v, dout, lse, delta, dqo, B, H, S, D, sq, sk, sv,
                       sdo, scale, causal, stream);
  if (D <= 256)
    return dq<32, 256>(q, k, v, dout, lse, delta, dqo, B, H, S, D, sq, sk, sv,
                       sdo, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class E>
int dkv_any(const E* q, const E* k, const E* v, const E* dout,
            const float* lse, const float* delta, E* dko, E* dvo, int B,
            int H, int S, int D, Strides sq, Strides sk, Strides sv,
            Strides sdo, float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return dkv<64, 64>(q, k, v, dout, lse, delta, dko, dvo, B, H, S, D, sq,
                       sk, sv, sdo, scale, causal, stream);
  if (D <= 128)
    return dkv<64, 128>(q, k, v, dout, lse, delta, dko, dvo, B, H, S, D, sq,
                        sk, sv, sdo, scale, causal, stream);
  if (D <= 256)
    return dkv<32, 256>(q, k, v, dout, lse, delta, dko, dvo, B, H, S, D, sq,
                        sk, sv, sdo, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// launch helpers of the tensor-core kernels (bf16, and the float32 backward)
// ---------------------------------------------------------------------------

// Whether every tensor of element type E allows the 16-byte path: D a
// multiple of the elements in 16 bytes, and each base pointer and element
// stride 16-byte aligned.
template <class E>
bool vec_ok(int D, std::initializer_list<const void*> ptrs,
            std::initializer_list<Strides> strides) {
  constexpr int n = 16 / sizeof(E);
  if (D % n) return false;
  for (const void* p : ptrs)
    if (!ptt::aligned16(p)) return false;
  for (const Strides& s : strides)
    if (s.b % n || s.s % n || s.h % n) return false;
  return true;
}

template <class Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// f(DPAD, kVec) for the smallest padded head dim of 64, 128 or 256 that
// holds D, as compile-time constants; kVec picks the 16-byte cp.async
// loads and stores, else the element-wise variant of the same kernel.
template <class F>
int by_head_dim(int D, bool vec, F&& f) {
  using Vec = std::true_type;
  using Elem = std::false_type;
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  using D256 = std::integral_constant<int, 256>;
  if (D <= 64) return vec ? f(D64{}, Vec{}) : f(D64{}, Elem{});
  if (D <= 128) return vec ? f(D128{}, Vec{}) : f(D128{}, Elem{});
  if (D <= 256) return vec ? f(D256{}, Vec{}) : f(D256{}, Elem{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

using ptt::cp_async16;
using ptt::cp_async4;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::ldsm_x4;
using ptt::mma_16816;
using ptt::pack_bf16x2;

constexpr int kThreads = 128;  // 4 warps

// bf16 elements per shared row of a DPAD-wide tile: 16 bytes of padding
// put the 8 rows of every ldmatrix in distinct banks.
template <int DPAD>
constexpr int kPitch = DPAD + 8;

// Rows [row0, row0 + R) x columns [0, DPAD) of a (b, h) slice (`base`,
// row stride `rs`) into `dst`, all 128 threads: 16-byte cp.async chunks
// (kVec: base and rs 16-byte aligned, D % 8 == 0), or element loads and
// stores.  Rows past S and columns past D are zero.
template <int R, int DPAD, bool kVec>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst,
                                          const bf16* __restrict__ base,
                                          long long rs, int row0, int S,
                                          int D) {
  constexpr int P = kPitch<DPAD>, CH = DPAD / 8, RS = kThreads / CH;
  static_assert(kThreads % CH == 0 && R % RS == 0, "tile shape");
  // this thread's chunks: column c of rows r, r + RS, ...
  const int r = threadIdx.x / CH, c = 8 * (threadIdx.x % CH);
  const bf16* src = base + (row0 + r) * rs + c;
  bf16* d = dst + r * P + c;
#pragma unroll
  for (int i = 0; i < R / RS; ++i, src += RS * rs, d += RS * P) {
    const bool row_ok = row0 + r + RS * i < S;
    if constexpr (kVec) {
      const bool ok = row_ok && c < D;
      cp_async16(d, ok ? src : base, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row_ok && c + e < D ? src[e] : __float2bfloat16_rn(0.f);
    }
  }
}

// Entries [row0, row0 + R) of one (b*h) row of a float (BH, S) array.
template <int R>
__device__ __forceinline__ void load_vec(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int row0, int S) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool ok = row0 + r < S;
    cp_async4(dst + r, ok ? src + row0 + r : src, ok);
  }
}

// Rows [row0, row0 + R) of a shared tile to the contiguous (B, S, H, D)
// output at (b, h), all 128 threads; rows past S and columns past D are
// not stored.
template <int R, int DPAD, bool kVec>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int b, int h, int row0, int H,
                                           int S, int D) {
  constexpr int P = kPitch<DPAD>, CH = DPAD / 8;
  for (int idx = threadIdx.x; idx < R * CH; idx += kThreads) {
    const int r = idx / CH, c = 8 * (idx % CH), s = row0 + r;
    if (s >= S || c >= D) continue;
    bf16* o = dst + ((static_cast<long long>(b) * S + s) * H + h) * D + c;
    const bf16* in = src + r * P + c;
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < D) o[e] = in[e];
    }
  }
}

// One warp's f32 accumulator rows (16 x 8N, m16n8 C fragments), the
// lane's two rows divided by l0 and l1, rounded into rows [0, 16) and
// columns [c0, c0 + 8N) of a shared tile.
template <int N, int DPAD>
__device__ __forceinline__ void put_rows(bf16* dst, const float (&acc)[N][4],
                                         int c0, float l0 = 1.f,
                                         float l1 = 1.f) {
  constexpr int P = kPitch<DPAD>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + g * P + c) =
        pack_bf16x2(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * P + c) =
        pack_bf16x2(acc[n][2] / l1, acc[n][3] / l1);
  }
}

// acc[i] (16 x 8N) += A_i (16 x 16K, fragments from rows [16 i, 16 i +
// 16) of tile `a`) times B^T, B the rows [0, 8N) of tile `b` (both
// row-major over the head dim): a QK^T-shaped product over the first 16K
// head-dim columns, for MT row blocks that share each B fragment.
template <int MT, int N, int K, int DPAD>
__device__ __forceinline__ void mma_abt(float (&acc)[MT][N][4],
                                        const bf16* __restrict__ a,
                                        const bf16* __restrict__ b) {
  constexpr int P = kPitch<DPAD>;
  const int lane = threadIdx.x % 32, r8 = lane % 8, mq = lane / 8;
#pragma unroll
  for (int kd = 0; kd < K; ++kd) {
    uint32_t fa[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm_x4<false>(fa[i], a + (16 * i + r8 + 8 * (mq % 2)) * P + 16 * kd +
                                8 * (mq / 2));
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      uint32_t fb[4];
      ldsm_x4<false>(
          fb, b + (8 * j + r8 + 8 * (mq / 2)) * P + 16 * kd + 8 * (mq % 2));
      const uint32_t b0[2] = {fb[0], fb[1]}, b1[2] = {fb[2], fb[3]};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_16816(acc[i][j], fa[i], b0);
        mma_16816(acc[i][j + 1], fa[i], b1);
      }
    }
  }
}

// The same for one row block.
template <int N, int K, int DPAD>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4],
                                        const bf16* __restrict__ a,
                                        const bf16* __restrict__ b) {
  mma_abt<1, N, K, DPAD>(reinterpret_cast<float(&)[1][N][4]>(acc), a, b);
}

// The B fragments (n8 tiles 2 n2 and 2 n2 + 1) of rows [16 kk, 16 kk +
// 16) x columns [c0 + 16 n2, + 16) of a row-major tile read as B[k][n]:
// the PV-shaped product's right operand.
template <int DPAD>
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                          const bf16* __restrict__ tile,
                                          int kk, int col) {
  constexpr int P = kPitch<DPAD>;
  const int lane = threadIdx.x % 32, r8 = lane % 8, mq = lane / 8;
  uint32_t f[4];
  ldsm_x4<true>(
      f, tile + (16 * kk + r8 + 8 * (mq % 2)) * P + col + 8 * (mq / 2));
  b0[0] = f[0];
  b0[1] = f[1];
  b1[0] = f[2];
  b1[1] = f[3];
}

// The A fragment of k16 step kk of a 16-row score block held as m16n8 C
// fragments s[2 kk] and s[2 kk + 1], rounded to bf16 (the product's
// operand dtype): the scores never leave registers.
template <int N>
__device__ __forceinline__ void a_of(uint32_t (&a)[4], const float (&s)[N][4],
                                     int kk) {
  a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// The same fragment of unrounded float32 values as a split pair: hi =
// bf16(x), lo = bf16(x - hi), so hi + lo is x to within 2^-16 |x| and two
// products into one f32 accumulator take x unrounded (see the header).
template <int N>
__device__ __forceinline__ void a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&s)[N][4], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = s[2 * kk + i / 2][2 * (i % 2)];
    const float x1 = s[2 * kk + i / 2][2 * (i % 2) + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16x2(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// Max and sum over the 4 lanes of a quad, which share a C-fragment row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// forward: a block owns 64 MT query rows (warp w rows 16 MT w .. 16 MT
// (w + 1) - 1, MT m16 row blocks sharing each K and V fragment) and walks
// BK-key tiles of K and V through a two-stage ring.
template <int MT, int BK, int DPAD, bool kVec>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, Strides sq, Strides sk,
                          Strides sv, int H, int S, int D, float scale,
                          int causal) {
  constexpr int P = kPitch<DPAD>, NS = BK / 8, ND = DPAD / 8;
  constexpr int WR = 16 * MT, BQ = 4 * WR;  // rows of a warp, of the block
  extern __shared__ __align__(16) unsigned char flash_tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(flash_tc_smem);  // BQ x P
  bf16* Ks = Qs + BQ * P;                              // 2 x BK x P
  bf16* Vs = Ks + 2 * BK * P;                          // 2 x BK x P

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = WR * warp;  // the warp's first row in the block
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  load_tile<BQ, DPAD, kVec>(Qs, qb, sq.s, q0, S, D);
  load_tile<BK, DPAD, kVec>(Ks, kb, sk.s, 0, S, D);
  load_tile<BK, DPAD, kVec>(Vs, vb, sv.s, 0, S, D);
  cp_async_commit();

  // row (i, r): the lane's row g + 8 r of m16 block i
  float o[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  }

  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BK;
    // tile kt has landed, and every warp is done with tile kt - 1, whose
    // stage takes tile kt + 1 while tile kt's products run
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kend) {
      const int nst = (kt + 1) & 1;
      load_tile<BK, DPAD, kVec>(Ks + nst * BK * P, kb, sk.s, k0 + BK, S, D);
      load_tile<BK, DPAD, kVec>(Vs + nst * BK * P, vb, sv.s, k0 + BK, S, D);
      cp_async_commit();
    }
    const bf16* Kt = Ks + (kt & 1) * BK * P;
    const bf16* Vt = Vs + (kt & 1) * BK * P;
    // a warp whose rows all precede the tile's keys has nothing to add
    if (!causal || k0 <= q0 + wr + WR - 1) {
      float s[MT][NS][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
      mma_abt<MT, NS, DPAD / 16, DPAD>(s, Qs + wr * P, Kt);

      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0 + wr);
      uint32_t pa[MT][BK / 16][4];  // bf16(p) as the A fragments of p V
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float mx[2] = {m[i][0], m[i][1]};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = q0 + wr + 16 * i + g + 8 * (e / 2);
            const bool ok = !edge || (col < S && (!causal || col <= row));
            s[i][j][e] = ok ? s[i][j][e] * scale : kNegInf;
            mx[e / 2] = fmaxf(mx[e / 2], s[i][j][e]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          const float corr = expf(m[i][r] - mx[r]);
          m[i][r] = mx[r];
          l[i][r] *= corr;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            o[i][n][2 * r] *= corr;
            o[i][n][2 * r + 1] *= corr;
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // masked entries hold kNegInf: exp underflows to exactly 0
            s[i][j][e] = expf(s[i][j][e] - m[i][e / 2]);
            l[i][e / 2] += s[i][j][e];  // the unrounded p
          }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) a_of(pa[i][kk], s[i], kk);
      }
      // o += bf16(p) V
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b0[2], b1[2];
          ldsm_b_kn<DPAD>(b0, b1, Vt, kk, 16 * n2);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_16816(o[i][2 * n2], pa[i][kk], b0);
            mma_16816(o[i][2 * n2 + 1], pa[i][kk], b1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float li[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + 16 * i + g + 8 * r;
      li[r] = quad_sum(l[i][r]);
      li[r] = li[r] == 0.f ? 1.f : li[r];
      if (t == 0 && row < S)
        lse[static_cast<long long>(bh) * S + row] = m[i][r] + logf(li[r]);
    }
    put_rows<ND, DPAD>(Qs + (wr + 16 * i) * P, o[i], 0, li[0], li[1]);
  }
  __syncthreads();
  store_tile<BQ, DPAD, kVec>(out, Qs, b, h, q0, H, S, D);
}

// dq: a block owns BQ = 64 query rows (warp w rows 16 w ..) and walks
// BK-key tiles of K and V through a two-stage ring.
template <int BQ, int BK, int DPAD, bool kVec>
__global__ void __launch_bounds__(kThreads)
    flash_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, Strides sq, Strides sk,
                         Strides sv, Strides sdo, int H, int S, int D,
                         float scale, int causal) {
  constexpr int P = kPitch<DPAD>, NS = BK / 8, ND = DPAD / 8;
  extern __shared__ __align__(16) unsigned char flash_tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(flash_tc_smem);  // BQ x P
  bf16* dOs = Qs + BQ * P;                             // BQ x P
  bf16* Ks = dOs + BQ * P;                             // 2 x BK x P
  bf16* Vs = Ks + 2 * BK * P;                          // 2 x BK x P

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const long long row_base = static_cast<long long>(bh) * S;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  load_tile<BQ, DPAD, kVec>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
  load_tile<BQ, DPAD, kVec>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                            D);
  load_tile<BK, DPAD, kVec>(Ks, kb, sk.s, 0, S, D);
  load_tile<BK, DPAD, kVec>(Vs, vb, sv.s, 0, S, D);
  cp_async_commit();
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr[i] = row[i] < S ? lse[row_base + row[i]] : 0.f;
    dr[i] = row[i] < S ? delta[row_base + row[i]] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BK;
    // tile kt has landed, and every warp is done with tile kt - 1, whose
    // stage takes tile kt + 1 while tile kt's products run
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kend) {
      const int nst = (kt + 1) & 1;
      load_tile<BK, DPAD, kVec>(Ks + nst * BK * P, kb, sk.s, k0 + BK, S, D);
      load_tile<BK, DPAD, kVec>(Vs + nst * BK * P, vb, sv.s, k0 + BK, S, D);
      cp_async_commit();
    }
    const bf16* Kt = Ks + (kt & 1) * BK * P;
    const bf16* Vt = Vs + (kt & 1) * BK * P;
    if (!causal || k0 <= q0 + wr + 15) {
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<NS, DPAD / 16, DPAD>(s, Qs + wr * P, Kt);
      mma_abt<NS, DPAD / 16, DPAD>(dp, dOs + wr * P, Vt);

      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0 + wr);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok =
              !edge || (col < S && (!causal || col <= row[e / 2]));
          const float p = ok ? expf(s[j][e] * scale - lr[e / 2]) : 0.f;
          s[j][e] = p * (dp[j][e] - dr[e / 2]) * scale;  // ds
        }
      // acc += bf16(ds) K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a_of(a, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b0[2], b1[2];
          ldsm_b_kn<DPAD>(b0, b1, Kt, kk, 16 * n2);
          mma_16816(acc[2 * n2], a, b0);
          mma_16816(acc[2 * n2 + 1], a, b1);
        }
      }
    }
  }

  put_rows<ND, DPAD>(Qs + wr * P, acc, 0);  // the warp's own rows
  __syncthreads();
  store_tile<BQ, DPAD, kVec>(dq, Qs, b, h, q0, H, S, D);
}

// dk and dv: a block owns BKV key rows and walks BQ-query tiles of Q, dO,
// lse and delta through a two-stage ring, QC queries at a time.  The 4
// warps split the block's rows 16 apiece, and at D 256 also its head dim
// in two halves of 128 (the two f32 accumulators of 16 rows x 256 would
// not fit a thread's registers): warp w owns key rows 16 (w % RW) and
// columns DW (w / RW) of dk and dv, and both warps of a row block form
// the whole S^T and dP^T for it.
template <int BKV, int BQ, int DPAD, bool kVec>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Strides sq, Strides sk, Strides sv, Strides sdo,
                          int H, int S, int D, float scale, int causal) {
  constexpr int P = kPitch<DPAD>;
  constexpr int RW = BKV / 16;           // warps along the key rows
  constexpr int DW = DPAD / (4 / RW);    // head-dim columns per warp
  constexpr int QC = 32, NQ = QC / 8, NDW = DW / 8;
  static_assert(RW * 16 == BKV && (4 / RW) * DW == DPAD && BQ % QC == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char flash_tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(flash_tc_smem);  // BKV x P
  bf16* Vs = Ks + BKV * P;                             // BKV x P
  bf16* Qs = Vs + BKV * P;                             // 2 x BQ x P
  bf16* dOs = Qs + 2 * BQ * P;                         // 2 x BQ x P
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * P);  // 2 x BQ
  float* Ds = Ls + 2 * BQ;                                 // 2 x BQ

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BKV;  // causal: the low key tiles loop longest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * (warp % RW), dc = DW * (warp / RW);
  const int krow[2] = {k0 + wr + g, k0 + wr + g + 8};
  const long long row_base = static_cast<long long>(bh) * S;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sdo.b + h * sdo.h;
  const int nq = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;

  load_tile<BKV, DPAD, kVec>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, S, D);
  load_tile<BKV, DPAD, kVec>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, S, D);
  load_tile<BQ, DPAD, kVec>(Qs, qb, sq.s, qt0 * BQ, S, D);
  load_tile<BQ, DPAD, kVec>(dOs, db, sdo.s, qt0 * BQ, S, D);
  load_vec<BQ>(Ls, lse + row_base, qt0 * BQ, S);
  load_vec<BQ>(Ds, delta + row_base, qt0 * BQ, S);
  cp_async_commit();

  float adk[NDW][4], adv[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ, st = (qt - qt0) & 1;
    cp_async_wait<0>();  // as in the forward's ring
    __syncthreads();
    if (qt + 1 < nq) {
      const int n0 = q0 + BQ, nst = st ^ 1;
      load_tile<BQ, DPAD, kVec>(Qs + nst * BQ * P, qb, sq.s, n0, S, D);
      load_tile<BQ, DPAD, kVec>(dOs + nst * BQ * P, db, sdo.s, n0, S, D);
      load_vec<BQ>(Ls + nst * BQ, lse + row_base, n0, S);
      load_vec<BQ>(Ds + nst * BQ, delta + row_base, n0, S);
      cp_async_commit();
    }
#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += QC) {
      const int qc0 = q0 + c0;  // this chunk's first query
      // past S, or every query of the chunk precedes the warp's keys
      if (qc0 >= S || (causal && qc0 + QC - 1 < k0 + wr)) continue;
      const bf16* Qc = Qs + st * BQ * P + c0 * P;
      const bf16* dOc = dOs + st * BQ * P + c0 * P;
      const float* Lc = Ls + st * BQ + c0;
      const float* Dc = Ds + st * BQ + c0;
      // S^T = K Q^T and dP^T = V dO^T, key rows x query columns
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<NQ, DPAD / 16, DPAD>(s, Ks + wr * P, Qc);
      mma_abt<NQ, DPAD / 16, DPAD>(dp, Vs + wr * P, dOc);

      const bool edge = qc0 + QC > S || (causal && qc0 < k0 + wr + 15);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qcol = 8 * j + 2 * t + (e & 1);
          const int qrow = qc0 + qcol;
          const bool ok =
              !edge || (qrow < S && (!causal || qrow >= krow[e / 2]));
          const float p = ok ? expf(s[j][e] * scale - Lc[qcol]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dc[qcol]) * scale;  // ds
        }
      // dv += p^T dO and dk += ds^T Q, p and ds unrounded: split pairs
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t hi[4], lo[4];
        a_split(hi, lo, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < NDW / 2; ++n2) {
          uint32_t b0[2], b1[2];
          ldsm_b_kn<DPAD>(b0, b1, dOc, kk, dc + 16 * n2);
          mma_16816(adv[2 * n2], hi, b0);
          mma_16816(adv[2 * n2], lo, b0);
          mma_16816(adv[2 * n2 + 1], hi, b1);
          mma_16816(adv[2 * n2 + 1], lo, b1);
        }
        a_split(hi, lo, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < NDW / 2; ++n2) {
          uint32_t b0[2], b1[2];
          ldsm_b_kn<DPAD>(b0, b1, Qc, kk, dc + 16 * n2);
          mma_16816(adk[2 * n2], hi, b0);
          mma_16816(adk[2 * n2], lo, b0);
          mma_16816(adk[2 * n2 + 1], hi, b1);
          mma_16816(adk[2 * n2 + 1], lo, b1);
        }
      }
    }
  }

  __syncthreads();  // the partner warp of a row block still reads K, V
  put_rows<NDW, DPAD>(Ks + wr * P, adk, dc);
  put_rows<NDW, DPAD>(Vs + wr * P, adv, dc);
  __syncthreads();
  store_tile<BKV, DPAD, kVec>(dk, Ks, b, h, k0, H, S, D);
  store_tile<BKV, DPAD, kVec>(dv, Vs, b, h, k0, H, S, D);
}

// ---------------------------------------------------------------------------
// bf16 launches
// ---------------------------------------------------------------------------

template <int MT, int BK, int DPAD, bool kVec>
int fwd(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
        int B, int H, int S, int D, Strides sq, Strides sk, Strides sv,
        float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = 64 * MT;
  constexpr size_t smem = sizeof(bf16) * (BQ + 4 * BK) * kPitch<DPAD>;
  auto kernel = flash_fwd_bf16_kernel<MT, BK, DPAD, kVec>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(B * H, (S + BQ - 1) / BQ), kThreads, smem, stream>>>(
      q, k, v, out, lse, sq, sk, sv, H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BK, int DPAD, bool kVec>
int dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
       const float* lse, const float* delta, bf16* dqo, int B, int H, int S,
       int D, Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
       int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * (2 * BQ + 4 * BK) * kPitch<DPAD>;
  auto kernel = flash_dq_bf16_kernel<BQ, BK, DPAD, kVec>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(B * H, (S + BQ - 1) / BQ), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dqo, sq, sk, sv, sdo, H, S, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BKV, int BQ, int DPAD, bool kVec>
int dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
        const float* lse, const float* delta, bf16* dko, bf16* dvo, int B,
        int H, int S, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
        float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * (2 * BKV + 4 * BQ) * kPitch<DPAD> +
                          sizeof(float) * 4 * BQ;
  auto kernel = flash_dkv_bf16_kernel<BKV, BQ, DPAD, kVec>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(B * H, (S + BKV - 1) / BKV), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dko, dvo, sq, sk, sv, sdo, H, S, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// The tiles for a padded head dim: 64-key tiles to D 128 and 32 to D 256
// (key_tile() in kernels/flash_attention.py names the forward's: the
// rounded p depends on it); the forward's m16 row blocks a warp (2, then
// 1); dq's 64 query rows; dk/dv's key rows a block and queries a tile.
constexpr int key_tile(int dpad) { return dpad <= 128 ? 64 : 32; }
constexpr int fwd_row_blocks(int dpad) { return dpad <= 128 ? 2 : 1; }
constexpr int kDqRows = 64;

int fwd_any(const bf16* q, const bf16* k, const bf16* v, bf16* out,
            float* lse, int B, int H, int S, int D, Strides sq, Strides sk,
            Strides sv, float scale, int causal, cudaStream_t stream) {
  const bool vec = vec_ok<bf16>(D, {q, k, v, out}, {sq, sk, sv});
  return by_head_dim(D, vec, [&](auto dpad, auto kvec) {
    constexpr int DP = decltype(dpad)::value;
    constexpr bool V = decltype(kvec)::value;
    return fwd<fwd_row_blocks(DP), key_tile(DP), DP, V>(
        q, k, v, out, lse, B, H, S, D, sq, sk, sv, scale, causal, stream);
  });
}

int dq_any(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* lse, const float* delta, bf16* dqo, int B, int H,
           int S, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
           float scale, int causal, cudaStream_t stream) {
  const bool vec = vec_ok<bf16>(D, {q, k, v, dout, dqo}, {sq, sk, sv, sdo});
  return by_head_dim(D, vec, [&](auto dpad, auto kvec) {
    constexpr int DP = decltype(dpad)::value;
    return dq<kDqRows, key_tile(DP), DP, decltype(kvec)::value>(
        q, k, v, dout, lse, delta, dqo, B, H, S, D, sq, sk, sv, sdo, scale,
        causal, stream);
  });
}

int dkv_any(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
            const float* lse, const float* delta, bf16* dko, bf16* dvo,
            int B, int H, int S, int D, Strides sq, Strides sk, Strides sv,
            Strides sdo, float scale, int causal, cudaStream_t stream) {
  const bool vec =
      vec_ok<bf16>(D, {q, k, v, dout, dko, dvo}, {sq, sk, sv, sdo});
  return by_head_dim(D, vec, [&](auto dpad, auto kvec) {
    constexpr int DP = decltype(dpad)::value;
    return dkv<key_tile(DP), key_tile(DP), DP, decltype(kvec)::value>(
        q, k, v, dout, lse, delta, dko, dvo, B, H, S, D, sq, sk, sv, sdo,
        scale, causal, stream);
  });
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: split-TF32 products on the tensor cores
// ---------------------------------------------------------------------------

namespace tf32 {

using ptt::cp_async16;
using ptt::cp_async4;
using ptt::cp_async_commit;
using ptt::cp_async_wait;

// k8 steps summed in a fresh accumulator before it is added to the
// running one (see the header): 4 over the head dim (q k^T, do v^T: the
// hi hi terms; lo hi and hi lo run in a sum of their own), 2 over keys
// or queries (ds k, p^T do, ds^T q: all three terms).
constexpr int kStepsD = 4;
constexpr int kStepsS = 2;

// Element (row, col) of a shared f32 tile DPAD floats wide, unpadded: the
// 16-byte chunk col / 4 of a row sits at chunk (col / 4) ^ (row % 8), so
// the 8 rows of an ldmatrix block and the rows 2t, 2t + 1 of a permuted B
// fragment fall in distinct banks (see the header).
template <int DPAD>
__device__ __forceinline__ int at(int row, int col) {
  return row * DPAD + ((col >> 2) ^ (row & 7)) * 4 + (col & 3);
}

// tf32(x): round to nearest, ties away from zero, to 10 mantissa bits (the
// f32 bits with the low 13 cleared).
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// A split operand fragment: hi and lo.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// d += a b on the tensor cores, m16n8k8, tf32 operands and f32 sums.
// Lane (g = lane / 4, t = lane % 4) holds a[0] (row g, k t), a[1] (row
// g + 8, k t), a[2] (row g, k t + 4), a[3] (row g + 8, k t + 4); b[0]
// (k t, column g), b[1] (k t + 4, column g); d[0..1] (row g, columns 2t,
// 2t + 1), d[2..3] (row g + 8, the same columns).
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b of split operands: lo hi + hi lo + hi hi, the small terms
// first; lo lo (at most 2^-22 |a b|) is dropped.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_1688(d, a.lo, b.hi);
  mma_1688(d, a.hi, b.lo);
  mma_1688(d, a.hi, b.hi);
}

// Four 8 x 4 f32 blocks from shared memory with one ldmatrix: read as b16
// pairs, lane (g, t) gets row g, f32 column t of block i in r[i], which
// is where the tf32 A and B fragments want them.  Lane l gives the
// address of row l % 8 of block l / 8.
__device__ __forceinline__ void ldsm_f32(uint32_t (&r)[4], const float* p) {
  ptt::ldsm_x4<false>(r, reinterpret_cast<const bf16*>(p));
}

// This lane's offsets (in floats, from a tile's start) of the fragments it
// loads, for at()'s layout: the XOR of a chunk with the row takes only the
// chunk's low 3 bits, so with the row's low 3 bits fixed by the lane, the
// offset of k8 step kk (or n8 tile n) is off[kk % 4] + 32 (kk / 4), and
// each load below is one register plus an immediate.
struct Lane {
  int a[4];      // A fragments, rows [ar0, ar0 + 16), columns 8 kk
  int b[4];      // B pairs of an A B^T product, rows [0, 16), columns 8 kk
  int kn[4][2];  // permuted B of a C B product, rows 2t and 2t + 1,
                 // columns bc0 + 8 n + g
};

template <int DPAD>
__device__ __forceinline__ Lane lane_offsets(int ar0, int bc0) {
  const int lane = threadIdx.x % 32, m = lane / 8, x = lane % 8;
  const int g = lane / 4, t = lane % 4;
  Lane o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o.a[i] = (ar0 + 8 * (m % 2) + x) * DPAD + ((2 * i + m / 2) ^ x) * 4;
    o.b[i] = (8 * (m / 2) + x) * DPAD + ((2 * i + m % 2) ^ x) * 4;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      o.kn[i][e] = (2 * t + e) * DPAD + bc0 +
                   ((2 * i + g / 4) ^ (2 * t + e)) * 4 + g % 4;
  }
  return o;
}

// The A fragment of 16 rows x 8 columns of a raw shared tile at this
// lane's ldmatrix address p (blocks: rows 0-7 | 8-15 x columns 0-3 |
// 4-7), split.
__device__ __forceinline__ void ld_a(FragA& f, const float* p) {
  uint32_t r[4];
  ldsm_f32(r, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), f.hi[i], f.lo[i]);
}

// The B fragments of B[k][n] = tile[n][k] for n rows 0-7 (f0) and 8-15
// (f1) x 8 k columns, from the hi and lo tiles of a split shared tile at
// this lane's ldmatrix offset: the right operand of an A B^T product, two
// n8 tiles.
__device__ __forceinline__ void ld_b_nk2(FragB& f0, FragB& f1,
                                         const float* hi, const float* lo,
                                         int off) {
  uint32_t h[4], l[4];
  ldsm_f32(h, hi + off);
  ldsm_f32(l, lo + off);
  f0 = {{h[0], h[1]}, {l[0], l[1]}};
  f1 = {{h[2], h[3]}, {l[2], l[3]}};
}

// The B fragment of B[k][n] = tile[k][n], 8 k rows x 8 n columns of a
// split shared tile, with k in the order a_of_c gives A's (k index t is
// row 2t, t + 4 is row 2t + 1): this lane's elements at offsets o0, o1.
__device__ __forceinline__ void ld_b_kn(FragB& f, const float* hi,
                                        const float* lo, int o0, int o1) {
  f = {{__float_as_uint(hi[o0]), __float_as_uint(hi[o1])},
       {__float_as_uint(lo[o0]), __float_as_uint(lo[o1])}};
}

// The A fragment of a 16 x 8 block held in registers as one m16n8 C
// fragment c, its columns taken as k in the permuted order (k index t is
// column 2t, t + 4 is column 2t + 1): the lane holds exactly those.
__device__ __forceinline__ void a_of_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// acc[j] (16 x 8N) += A B^T over the head-dim columns [0, 8K): A the rows
// [ar0, ar0 + 16) of the raw tile a (ar0 in ln), B the rows [0, 8N) of
// the split tile (bh, bl), both row-major over the head dim (a
// QK^T-shaped product).  The small terms (lo hi, hi lo) run in one sum
// over all 8K columns, at most 2^-10 of the product, so its truncation is
// negligible; the hi hi terms go into fresh sums of kStepsD k8 steps,
// each added to acc in f32.
template <int N, int K, int DPAD>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const float* a,
                                        const float* bh, const float* bl,
                                        const Lane& ln) {
  static_assert(K % kStepsD == 0 && N % 2 == 0, "k8 chunks, n8 pairs");
  float small[N][4], part[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = part[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    FragA fa;
    ld_a(fa, a + ln.a[kk % 4] + 32 * (kk / 4));
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      FragB fb[2];
      ld_b_nk2(fb[0], fb[1], bh, bl,
               ln.b[kk % 4] + 32 * (kk / 4) + 8 * j * DPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_1688(small[j + i], fa.lo, fb[i].hi);
        mma_1688(small[j + i], fa.hi, fb[i].lo);
        mma_1688(part[j + i], fa.hi, fb[i].hi);
      }
    }
    if ((kk + 1) % kStepsD == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] += part[j][e];
          part[j][e] = 0.f;
        }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// acc[n] (16 x 8N) += C B: C the 16 x 8NK block held as the C fragments
// c (scores, never stored), B the rows [0, 8NK) x columns [bc0, bc0 + 8N)
// of the split tile (bh, bl) (bc0 in ln; a PV-shaped product).  Each
// kStepsS k8 steps of an n8 tile go into a fresh accumulator, added to
// acc in f32.
template <int N, int NK, int DPAD>
__device__ __forceinline__ void mma_cb(float (&acc)[N][4],
                                       const float (&c)[NK][4],
                                       const float* bh, const float* bl,
                                       const Lane& ln) {
  static_assert(NK % kStepsS == 0, "key or query chunks");
  FragA fa[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) a_of_c(fa[j], c[j]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j0 = 0; j0 < NK; j0 += kStepsS) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = j0; j < j0 + kStepsS; ++j) {
        const int o = 32 * (n / 4) + 8 * j * DPAD;
        FragB fb;
        ld_b_kn(fb, bh, bl, ln.kn[n % 4][0] + o, ln.kn[n % 4][1] + o);
        mma3(part, fa[j], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
}

// Rows [row0, row0 + R) x columns [0, DPAD) of a (b, h) slice (`base`,
// row stride `rs`) into the shared tile `dst` (at()'s layout), all NT
// threads: 16-byte cp.async chunks (kVec: base and rs 16-byte aligned,
// D % 4 == 0), or element loads and stores.  Rows past S and columns
// past D are zero.
template <int R, int DPAD, int NT, bool kVec>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ base,
                                          long long rs, int row0, int S,
                                          int D) {
  constexpr int CH = DPAD / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < R * CH; idx += NT) {
    const int r = idx / CH, c = 4 * (idx % CH);
    const float* src = base + (row0 + r) * rs + c;
    float* d = dst + at<DPAD>(r, c);
    const bool row_ok = row0 + r < S;
    if constexpr (kVec) {
      const bool ok = row_ok && c < D;
      cp_async16(d, ok ? src : base, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = row_ok && c + e < D ? src[e] : 0.f;
    }
  }
}

// The R x DPAD raw tile `raw` split into the tiles hi and lo of the same
// layout, all NT threads.
template <int R, int DPAD, int NT>
__device__ __forceinline__ void split_tile(float* __restrict__ hi,
                                           float* __restrict__ lo,
                                           const float* __restrict__ raw) {
#pragma unroll
  for (int i = 4 * threadIdx.x; i < R * DPAD; i += 4 * NT) {
    const float4 x = *reinterpret_cast<const float4*>(raw + i);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// Entries [row0, row0 + R) of one (b*h) row of a float (BH, S) array.
template <int R, int NT>
__device__ __forceinline__ void load_vec(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int row0, int S) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool ok = row0 + r < S;
    cp_async4(dst + r, ok ? src + row0 + r : src, ok);
  }
}

// One warp's f32 accumulator rows (16 x 8N, m16n8 C fragments) to rows
// row0 + g, row0 + g + 8 and columns [c0, c0 + 8N) of the contiguous
// (B, S, H, D) output at (b, h); rows past S and columns past D are not
// stored.  kVec: D % 4 == 0 and dst 16-byte aligned, so float2 stores.
template <int N, bool kVec>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[N][4], int b,
                                           int h, int row0, int c0, int H,
                                           int S, int D) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + g + 8 * r;
    if (s >= S) continue;
    float* o = dst + ((static_cast<long long>(b) * S + s) * H + h) * D;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if constexpr (kVec) {
        if (c < D)
          *reinterpret_cast<float2*>(o + c) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        if (c < D) o[c] = acc[n][2 * r];
        if (c + 1 < D) o[c + 1] = acc[n][2 * r + 1];
      }
    }
  }
}

// dq: a block of NW warps owns BQ = 16 NW query rows (warp w rows 16 w ..
// 16 w + 15) and walks BK-key tiles of K and V: each lands raw by
// cp.async while the previous one's products run, and is split into hi
// and lo tiles once for all warps.
template <int NW, int BK, int DPAD, bool kVec>
__global__ void __launch_bounds__(32 * NW)
    flash_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, Strides sq, Strides sk,
                         Strides sv, Strides sdo, int H, int S, int D,
                         float scale, int causal) {
  constexpr int NT = 32 * NW, BQ = 16 * NW, T = BK * DPAD;
  constexpr int NS = BK / 8, ND = DPAD / 8;
  extern __shared__ __align__(16) float flash_tf32_smem[];
  float* Qs = flash_tf32_smem;  // BQ x DPAD, raw
  float* dOs = Qs + BQ * DPAD;  // BQ x DPAD, raw
  float* Kr = dOs + BQ * DPAD;  // BK x DPAD each: K and V raw, then
  float* Vr = Kr + T;           // split into hi and lo
  float* Kh = Vr + T;
  float* Kl = Kh + T;
  float* Vh = Kl + T;
  float* Vl = Vh + T;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const long long row_base = static_cast<long long>(bh) * S;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const Lane ln = lane_offsets<DPAD>(wr, 0);

  load_tile<BQ, DPAD, NT, kVec>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
  load_tile<BQ, DPAD, NT, kVec>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s,
                                q0, S, D);
  load_tile<BK, DPAD, NT, kVec>(Kr, kb, sk.s, 0, S, D);
  load_tile<BK, DPAD, NT, kVec>(Vr, vb, sv.s, 0, S, D);
  cp_async_commit();
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr[i] = row[i] < S ? lse[row_base + row[i]] : 0.f;
    dr[i] = row[i] < S ? delta[row_base + row[i]] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BK;
    // tile kt has landed raw, and every warp is done with tile kt - 1's
    // split tiles; split tile kt, then take tile kt + 1 while it runs
    cp_async_wait<0>();
    __syncthreads();
    split_tile<BK, DPAD, NT>(Kh, Kl, Kr);
    split_tile<BK, DPAD, NT>(Vh, Vl, Vr);
    __syncthreads();
    if (kt + 1 < kend) {
      load_tile<BK, DPAD, NT, kVec>(Kr, kb, sk.s, k0 + BK, S, D);
      load_tile<BK, DPAD, NT, kVec>(Vr, vb, sv.s, k0 + BK, S, D);
      cp_async_commit();
    }
    // a warp whose rows all precede the tile's keys has nothing to add
    if (causal && k0 > q0 + wr + 15) continue;
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<NS, ND, DPAD>(s, Qs, Kh, Kl, ln);
    mma_abt<NS, ND, DPAD>(dp, dOs, Vh, Vl, ln);

    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0 + wr);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = !edge || (col < S && (!causal || col <= row[e / 2]));
        const float p = ok ? expf(s[j][e] * scale - lr[e / 2]) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[e / 2]) * scale;  // ds
      }
    mma_cb<ND, NS, DPAD>(acc, s, Kh, Kl, ln);  // acc += ds K
  }
  store_rows<ND, kVec>(dq, acc, b, h, q0 + wr, 0, H, S, D);
}

// dk and dv: a block of NW warps owns BKV = 16 RW key rows and walks
// BQ-query tiles of Q, dO, lse and delta, each landing raw by cp.async
// while the previous one's products run, Q and dO split into hi and lo
// tiles once for all warps.  Warp w owns key rows 16 (w % RW) and
// head-dim columns DW (w / RW) of dk and dv (to D 128 every warp its own
// rows, all columns; at D 256 the columns split between warp pairs, each
// forming the whole S^T and dP^T of its rows: two f32 accumulators of
// 16 x 256 would not fit a thread's registers).
template <int NW, int RW, int BQ, int DPAD, bool kVec>
__global__ void __launch_bounds__(32 * NW)
    flash_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Strides sq, Strides sk, Strides sv, Strides sdo,
                          int H, int S, int D, float scale, int causal) {
  constexpr int NT = 32 * NW, BKV = 16 * RW, T = BQ * DPAD;
  constexpr int DW = DPAD / (NW / RW), NQ = BQ / 8, NDW = DW / 8;
  static_assert(NW % RW == 0 && (NW / RW) * DW == DPAD, "tile shape");
  extern __shared__ __align__(16) float flash_tf32_smem[];
  float* Ks = flash_tf32_smem;   // BKV x DPAD, raw
  float* Vs = Ks + BKV * DPAD;   // BKV x DPAD, raw
  float* Qr = Vs + BKV * DPAD;   // BQ x DPAD each: Q and dO raw, then
  float* dOr = Qr + T;           // split into hi and lo
  float* Qh = dOr + T;
  float* Ql = Qh + T;
  float* dOh = Ql + T;
  float* dOl = dOh + T;
  float* Lr = dOl + T;           // BQ each: lse and delta as they land,
  float* Dr = Lr + BQ;           // and as the split tiles' products read
  float* Lc = Dr + BQ;           // them
  float* Dc = Lc + BQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BKV;  // causal: the low key tiles loop longest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int wr = 16 * (warp % RW), dc = DW * (warp / RW);
  const int krow[2] = {k0 + wr + lane / 4, k0 + wr + lane / 4 + 8};
  const long long row_base = static_cast<long long>(bh) * S;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* db = dout + b * sdo.b + h * sdo.h;
  const int nq = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const Lane ln = lane_offsets<DPAD>(wr, dc);

  load_tile<BKV, DPAD, NT, kVec>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, S, D);
  load_tile<BKV, DPAD, NT, kVec>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, S, D);
  load_tile<BQ, DPAD, NT, kVec>(Qr, qb, sq.s, qt0 * BQ, S, D);
  load_tile<BQ, DPAD, NT, kVec>(dOr, db, sdo.s, qt0 * BQ, S, D);
  load_vec<BQ, NT>(Lr, lse + row_base, qt0 * BQ, S);
  load_vec<BQ, NT>(Dr, delta + row_base, qt0 * BQ, S);
  cp_async_commit();

  float adk[NDW][4], adv[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    cp_async_wait<0>();  // as in dq
    __syncthreads();
    split_tile<BQ, DPAD, NT>(Qh, Ql, Qr);
    split_tile<BQ, DPAD, NT>(dOh, dOl, dOr);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      Lc[r] = Lr[r];
      Dc[r] = Dr[r];
    }
    __syncthreads();
    if (qt + 1 < nq) {
      const int n0 = q0 + BQ;
      load_tile<BQ, DPAD, NT, kVec>(Qr, qb, sq.s, n0, S, D);
      load_tile<BQ, DPAD, NT, kVec>(dOr, db, sdo.s, n0, S, D);
      load_vec<BQ, NT>(Lr, lse + row_base, n0, S);
      load_vec<BQ, NT>(Dr, delta + row_base, n0, S);
      cp_async_commit();
    }
    // every query of the tile precedes the warp's keys
    if (causal && q0 + BQ - 1 < k0 + wr) continue;
    // S^T = K Q^T and dP^T = V dO^T, key rows x query columns
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<NQ, DPAD / 8, DPAD>(s, Ks, Qh, Ql, ln);
    mma_abt<NQ, DPAD / 8, DPAD>(dp, Vs, dOh, dOl, ln);

    const bool edge = q0 + BQ > S || (causal && q0 < k0 + wr + 15);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qcol = 8 * j + 2 * t + (e & 1);
        const int qrow = q0 + qcol;
        const bool ok =
            !edge || (qrow < S && (!causal || qrow >= krow[e / 2]));
        const float p = ok ? expf(s[j][e] * scale - Lc[qcol]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dc[qcol]) * scale;  // ds
      }
    mma_cb<NDW, NQ, DPAD>(adv, s, dOh, dOl, ln);  // dv += p^T dO
    mma_cb<NDW, NQ, DPAD>(adk, dp, Qh, Ql, ln);   // dk += ds^T Q
  }
  store_rows<NDW, kVec>(dk, adk, b, h, k0 + wr, dc, H, S, D);
  store_rows<NDW, kVec>(dv, adv, b, h, k0 + wr, dc, H, S, D);
}

template <int NW, int BK, int DPAD, bool kVec>
int dq(const float* q, const float* k, const float* v, const float* dout,
       const float* lse, const float* delta, float* dqo, int B, int H, int S,
       int D, Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
       int causal, cudaStream_t stream) {
  constexpr int BQ = 16 * NW;
  constexpr size_t smem = sizeof(float) * (2 * BQ + 6 * BK) * DPAD;
  auto kernel = flash_dq_tf32_kernel<NW, BK, DPAD, kVec>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(B * H, (S + BQ - 1) / BQ), 32 * NW, smem, stream>>>(
      q, k, v, dout, lse, delta, dqo, sq, sk, sv, sdo, H, S, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int NW, int RW, int BQ, int DPAD, bool kVec>
int dkv(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dko, float* dvo, int B,
        int H, int S, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
        float scale, int causal, cudaStream_t stream) {
  constexpr int BKV = 16 * RW;
  constexpr size_t smem =
      sizeof(float) * ((2 * BKV + 6 * BQ) * DPAD + 4 * BQ);
  auto kernel = flash_dkv_tf32_kernel<NW, RW, BQ, DPAD, kVec>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(B * H, (S + BKV - 1) / BKV), 32 * NW, smem, stream>>>(
      q, k, v, dout, lse, delta, dko, dvo, sq, sk, sv, sdo, H, S, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// The tiles for a padded head dim (shared memory at D 128: dq 229,376
// bytes, dk/dv 229,888, one block an SM): dq's warps (16 query rows each)
// and key tile; dk/dv's warps along the key rows (of 8) and query tile.
constexpr int dq_warps(int dpad) { return dpad <= 128 ? 8 : 4; }
constexpr int dq_keys(int dpad) { return dpad <= 128 ? 32 : 16; }
constexpr int kDkvWarps = 8;
constexpr int dkv_row_warps(int dpad) { return dpad <= 128 ? 8 : 4; }
constexpr int dkv_queries(int dpad) { return dpad <= 128 ? 32 : 16; }

// The forward: dq's blocks (NW warps of 16 query rows over BK-key tiles of
// K and V, each landing raw by cp.async while the previous one's products
// run and split once for all warps) without dP and ds.  s = q k^T as in
// dq; the online softmax in the C fragments (m and l f32, a row's max and
// sum over the quad); p split in registers as the A operand of p V, whose
// fresh sums of kStepsS k8 steps go into the running accumulator after it
// is rescaled by exp(m_old - m_new).
template <int NW, int BK, int DPAD, bool kVec>
__global__ void __launch_bounds__(32 * NW)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out, float* __restrict__ lse,
                          Strides sq, Strides sk, Strides sv, int H, int S,
                          int D, float scale, int causal) {
  constexpr int NT = 32 * NW, BQ = 16 * NW, T = BK * DPAD;
  constexpr int NS = BK / 8, ND = DPAD / 8;
  extern __shared__ __align__(16) float flash_tf32_smem[];
  float* Qs = flash_tf32_smem;  // BQ x DPAD, raw
  float* Kr = Qs + BQ * DPAD;   // BK x DPAD each: K and V raw, then
  float* Vr = Kr + T;           // split into hi and lo
  float* Kh = Vr + T;
  float* Kl = Kh + T;
  float* Vh = Kl + T;
  float* Vl = Vh + T;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const Lane ln = lane_offsets<DPAD>(wr, 0);

  load_tile<BQ, DPAD, NT, kVec>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
  load_tile<BK, DPAD, NT, kVec>(Kr, kb, sk.s, 0, S, D);
  load_tile<BK, DPAD, NT, kVec>(Vr, vb, sv.s, 0, S, D);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * BK;
    cp_async_wait<0>();  // as in dq
    __syncthreads();
    split_tile<BK, DPAD, NT>(Kh, Kl, Kr);
    split_tile<BK, DPAD, NT>(Vh, Vl, Vr);
    __syncthreads();
    if (kt + 1 < kend) {
      load_tile<BK, DPAD, NT, kVec>(Kr, kb, sk.s, k0 + BK, S, D);
      load_tile<BK, DPAD, NT, kVec>(Vr, vb, sv.s, k0 + BK, S, D);
      cp_async_commit();
    }
    // a warp whose rows all precede the tile's keys has nothing to add
    if (causal && k0 > q0 + wr + 15) continue;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_abt<NS, ND, DPAD>(s, Qs, Kh, Kl, ln);

    // scaled and masked scores (kNegInf where masked), each row's max
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0 + wr);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = !edge || (col < S && (!causal || col <= row[e / 2]));
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], tc::quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // p = exp(s - m) in place of s; a masked entry is 0 (its row's m may
    // still be kNegInf)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[j][e] == kNegInf ? 0.f : expf(s[j][e] - m[e / 2]);
        rs[e / 2] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + tc::quad_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];
    mma_cb<ND, NS, DPAD>(acc, s, Vh, Vl, ln);  // acc += p V
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / li;
    if (t == 0 && row[i] < S)
      lse[static_cast<long long>(bh) * S + row[i]] = m[i] + logf(li);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e / 2];
  store_rows<ND, kVec>(out, acc, b, h, q0 + wr, 0, H, S, D);
}

template <int NW, int BK, int DPAD, bool kVec>
int fwd(const float* q, const float* k, const float* v, float* out,
        float* lse, int B, int H, int S, int D, Strides sq, Strides sk,
        Strides sv, float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = 16 * NW;
  constexpr size_t smem = sizeof(float) * (BQ + 6 * BK) * DPAD;
  auto kernel = flash_fwd_tf32_kernel<NW, BK, DPAD, kVec>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(B * H, (S + BQ - 1) / BQ), 32 * NW, smem, stream>>>(
      q, k, v, out, lse, sq, sk, sv, H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The forward takes dq's tiles (shared memory at D 128: 163,840 bytes).
int fwd_any(const float* q, const float* k, const float* v, float* out,
            float* lse, int B, int H, int S, int D, Strides sq, Strides sk,
            Strides sv, float scale, int causal, cudaStream_t stream) {
  const bool vec = vec_ok<float>(D, {q, k, v, out}, {sq, sk, sv});
  return by_head_dim(D, vec, [&](auto dpad, auto kvec) {
    constexpr int DP = decltype(dpad)::value;
    return fwd<dq_warps(DP), dq_keys(DP), DP, decltype(kvec)::value>(
        q, k, v, out, lse, B, H, S, D, sq, sk, sv, scale, causal, stream);
  });
}

int dq_any(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dqo, int B, int H,
           int S, int D, Strides sq, Strides sk, Strides sv, Strides sdo,
           float scale, int causal, cudaStream_t stream) {
  const bool vec =
      vec_ok<float>(D, {q, k, v, dout, dqo}, {sq, sk, sv, sdo});
  return by_head_dim(D, vec, [&](auto dpad, auto kvec) {
    constexpr int DP = decltype(dpad)::value;
    return dq<dq_warps(DP), dq_keys(DP), DP, decltype(kvec)::value>(
        q, k, v, dout, lse, delta, dqo, B, H, S, D, sq, sk, sv, sdo, scale,
        causal, stream);
  });
}

int dkv_any(const float* q, const float* k, const float* v,
            const float* dout, const float* lse, const float* delta,
            float* dko, float* dvo, int B, int H, int S, int D, Strides sq,
            Strides sk, Strides sv, Strides sdo, float scale, int causal,
            cudaStream_t stream) {
  const bool vec =
      vec_ok<float>(D, {q, k, v, dout, dko, dvo}, {sq, sk, sv, sdo});
  return by_head_dim(D, vec, [&](auto dpad, auto kvec) {
    constexpr int DP = decltype(dpad)::value;
    return dkv<kDkvWarps, dkv_row_warps(DP), dkv_queries(DP), DP,
               decltype(kvec)::value>(q, k, v, dout, lse, delta, dko, dvo,
                                      B, H, S, D, sq, sk, sv, sdo, scale,
                                      causal, stream);
  });
}

}  // namespace tf32

}  // namespace

// Each entry launches on `stream` and returns the CUDA error of the
// launch (cudaErrorInvalidValue for D > 256).  q, k, v and do are
// (B, S, H, D) with the given element strides of dims 0-2 and a
// contiguous head dim; out, dq, dk and dv are contiguous (B, S, H, D);
// lse and delta are contiguous (B*H, S) float32.  The _f32 entries take
// float32 tensors, the _bf16 entries bf16 ones.  The _f32_simt entries
// are the float32 SIMT kernels, which the wrapper never launches: they
// are kept to be timed and checked beside the split-TF32 kernels of the
// _f32 entries.
#define PTT_FLASH_FWD(SUFFIX, E, FWD)                                         \
  PTT_EXPORT int ptt_flash_fwd_##SUFFIX(                                      \
      const E* q, const E* k, const E* v, E* out, float* lse, int B, int H,   \
      int S, int D, long long q_sb, long long q_ss, long long q_sh,           \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,         \
      long long v_ss, long long v_sh, float scale, int causal,                \
      cudaStream_t stream) {                                                  \
    return FWD(q, k, v, out, lse, B, H, S, D, {q_sb, q_ss, q_sh},             \
               {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, scale, causal,         \
               stream);                                                       \
  }
#define PTT_FLASH_BWD(SUFFIX, E, DQ, DKV)                                     \
  PTT_EXPORT int ptt_flash_dq_##SUFFIX(                                       \
      const E* q, const E* k, const E* v, const E* dout, const float* lse,    \
      const float* delta, E* dqo, int B, int H, int S, int D, long long q_sb, \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,         \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,         \
      long long do_sb, long long do_ss, long long do_sh, float scale,         \
      int causal, cudaStream_t stream) {                                      \
    return DQ(q, k, v, dout, lse, delta, dqo, B, H, S, D,                     \
              {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},     \
              {do_sb, do_ss, do_sh}, scale, causal, stream);                  \
  }                                                                           \
  PTT_EXPORT int ptt_flash_dkv_##SUFFIX(                                      \
      const E* q, const E* k, const E* v, const E* dout, const float* lse,    \
      const float* delta, E* dko, E* dvo, int B, int H, int S, int D,         \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,         \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,         \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,      \
      float scale, int causal, cudaStream_t stream) {                         \
    return DKV(q, k, v, dout, lse, delta, dko, dvo, B, H, S, D,               \
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},    \
               {do_sb, do_ss, do_sh}, scale, causal, stream);                 \
  }

PTT_FLASH_FWD(f32, float, tf32::fwd_any)
PTT_FLASH_FWD(f32_simt, float, fwd_any<float>)
PTT_FLASH_BWD(f32, float, tf32::dq_any, tf32::dkv_any)
PTT_FLASH_BWD(f32_simt, float, dq_any<float>, dkv_any<float>)
PTT_FLASH_FWD(bf16, bf16, tc::fwd_any)
PTT_FLASH_BWD(bf16, bf16, tc::dq_any, tc::dkv_any)
