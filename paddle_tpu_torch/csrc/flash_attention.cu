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
// tile has one owner, so there are no atomics.  Causal blocks stop at
// (forward, dq) or start from (dk/dv) the diagonal tile, as the TPU
// kernel skips the strictly-upper blocks, and the longest blocks are
// scheduled first.  Rows past S and columns past D are read as zero and
// masked, so any S and any D <= 256 work (the TPU kernel needs S
// divisible by a block of at least 128).
//
// A tile is BT query or key rows: 64 for D <= 128, 32 for D <= 256, so
// that the tiles fit the 227 KB of dynamic shared memory a block may
// have (the dk/dv kernel holds six tiles: 165 KB at D = 128).  A block
// of 4 * BT threads computes each BT x BT score tile as 4 x (BT / 16)
// sub-tiles per thread, rows ty + (BT / 4) i and columns tx + 16 j, so a
// row's max and sum are shuffles over 16 lanes; the products with V, K,
// Q and dO give each thread the same 4 rows and the head-dim columns
// tx + 16 j.  Tiles read across rows at one d (K in the forward and dq,
// Q and dO in dk/dv) have a row pitch of DPAD + 1, so a warp's 16 rows
// fall in 16 banks.
//
// The bf16 instance rounds where the TPU kernel rounds on bf16 inputs,
// and nowhere else: scores, the online-softmax state and every
// accumulator stay float32 (tiles are widened to float32 in shared
// memory); the forward rounds p to bf16 before the PV product
// (flash_attention.py:130-132; l sums the unrounded p) and writes out in
// bf16; dq rounds ds to bf16 before ds K (:222-224) and writes dq in
// bf16; dk/dv rounds nothing until dk and dv are written (:258-269).
//
// What bounds it on the H100: operations.  At the transformer's shape
// (B*H = 128, S = 1024, D = 128, causal) the forward does 2 products of
// 2 * BH * S(S+1)/2 * D FLOPs (34.4 GFLOP, 0.51 ms at 67 TFLOP/s f32),
// dq 3 and dk/dv 4 such products, while the bytes (q, k, v, o, do at
// 67 MB each) take 0.1 ms at 3.35 TB/s.  This is a simple f32 SIMT
// kernel (fmaf from shared memory, one block per SM); in bf16 the same
// products run on the same f32 tiles, bytes halved at the edges only:
// wgmma tiles and TMA are later work.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to E and widened back: the identity for float.
template <class E>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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
    dst[r * pitch + d] = (s < S && d < D) ? to_f32(base[s * st.s + d]) : 0.f;
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
      if (d < D) put(o + d, acc[i][j]);
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
        Ps[r * PP + tx + 16 * j] = round_to<E>(p);  // PV takes v's dtype
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
        // ds K takes k's dtype
        dSs[r * PP + tx + 16 * j] = round_to<E>(p * (dp[i][j] - Ds[r]) * scale);
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

}  // namespace

// Each entry launches on `stream` and returns the CUDA error of the
// launch (cudaErrorInvalidValue for D > 256).  q, k, v and do are
// (B, S, H, D) with the given element strides of dims 0-2 and a
// contiguous head dim; out, dq, dk and dv are contiguous (B, S, H, D);
// lse and delta are contiguous (B*H, S) float32.  The _f32 entries take
// float32 tensors, the _bf16 entries bf16 ones.
#define PTT_FLASH_ENTRIES(SUFFIX, E)                                          \
  PTT_EXPORT int ptt_flash_fwd_##SUFFIX(                                      \
      const E* q, const E* k, const E* v, E* out, float* lse, int B, int H,   \
      int S, int D, long long q_sb, long long q_ss, long long q_sh,           \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb,         \
      long long v_ss, long long v_sh, float scale, int causal,                \
      cudaStream_t stream) {                                                  \
    return fwd_any<E>(q, k, v, out, lse, B, H, S, D, {q_sb, q_ss, q_sh},      \
                      {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, scale, causal,  \
                      stream);                                                \
  }                                                                           \
  PTT_EXPORT int ptt_flash_dq_##SUFFIX(                                       \
      const E* q, const E* k, const E* v, const E* dout, const float* lse,    \
      const float* delta, E* dqo, int B, int H, int S, int D, long long q_sb, \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,         \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,         \
      long long do_sb, long long do_ss, long long do_sh, float scale,         \
      int causal, cudaStream_t stream) {                                      \
    return dq_any<E>(q, k, v, dout, lse, delta, dqo, B, H, S, D,              \
                     {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},                  \
                     {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}, scale,        \
                     causal, stream);                                         \
  }                                                                           \
  PTT_EXPORT int ptt_flash_dkv_##SUFFIX(                                      \
      const E* q, const E* k, const E* v, const E* dout, const float* lse,    \
      const float* delta, E* dko, E* dvo, int B, int H, int S, int D,         \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,         \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,         \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,      \
      float scale, int causal, cudaStream_t stream) {                         \
    return dkv_any<E>(q, k, v, dout, lse, delta, dko, dvo, B, H, S, D,        \
                      {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},                 \
                      {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}, scale,       \
                      causal, stream);                                        \
  }

PTT_FLASH_ENTRIES(f32, float)
PTT_FLASH_ENTRIES(bf16, bf16)
