// Ragged paged attention in float32: query rows of each sequence slot
// attend over K/V rows that live scattered across fixed-size pages of a
// shared pool, named by the slot's page table.
//
// Replaces the TPU kernels of paddle_tpu/decode/attention.py:
//   - ragged_paged_attention (:222): _rpa_kernel (:117, pallas_call
//     :293) and its slot-blocked variant _rpa_kernel_blocked (:166,
//     call :264).  One query token per slot, q (S, H, D); the slot sees
//     pool positions t < lens[s].
//   - ragged_paged_attention_chunk (:382): _rpa_chunk_kernel (:333,
//     call :410).  T query tokens per slot, q (S, T, H, D); row j sees
//     positions t < lens[s] + j + 1 (the chunk's own rows are already
//     in the pages).
// Pools are (N, page, H, D), page tables (S, P) int32, lens (S,) int32;
// out has q's shape.  Position t of slot s is row t % page of page
// tables[s][t / page].  Limits are capped at P * page (the table's
// reach), as the TPU kernel's grid ends at P pages.
//
// The TPU kernel walks a (slot, page) grid in order on one core, with
// the page table and lengths scalar-prefetched and the running max,
// normaliser and accumulator carried in VMEM scratch from one page to
// the next.  On Hopper the blocks run in parallel, so each block owns
// whole outputs instead: one block per (slot, head, tile of R query
// rows), 8 warps.  The block reads its own length and the table
// entries it needs into shared memory (in place of the scalar
// prefetch) and loops over its positions only up to the row's limit:
// it never touches a page at or past ceil(limit / page), not even the
// null page that the table's padding names.  The W = 8 / R warps of a
// query row split its positions 4 at a time (4 K rows and 4 V rows in
// flight per warp); each warp keeps its own running max m, normaliser
// l and accumulator in registers, lane x holding head-dim columns
// x + 32 i, and a q . k dot is a butterfly of warp shuffles.  At the
// end the W partial softmaxes of a row merge through shared memory.
// R is 1 for the decode step (all 8 warps on one row) and min(8, the
// power of two >= T) for the chunk.
//
// That chunk design (paged_attention_chunk_kernel, reached only by
// ptt_paged_attention_f32 with chunk = 1) is kept by name; the chunk
// entry point runs the redesign below (paged_chunk_split_kernel and
// paged_chunk_merge_kernel, ptt_paged_attention_chunk_f32).
//
// An empty context (limit 0) gives zeros, as the TPU kernel's l == 0
// -> 1 does (:159-163); the jnp reference gives the mean of V there.
// Page ids outside [0, N) are clamped into the pool, as the JAX
// reference's gather clamps them: no read leaves the pool.
//
// What bounds it on the H100: bytes.  Each slot's K and V rows up to
// its limit are read once, sum(limits) * H * D * 4 B * 2; at S 16,
// H 16, D 128 with every lens 2048 that is 537 MB, 0.160 ms at
// 3.35 TB/s, against 2 * 2 * 16 * 16 * 2048 * 128 = 268 MFLOP (4 us at
// 67 TFLOP/s f32).  The old chunk design loads the same rows once per
// query row of a tile into registers (4x the load instructions at T 4,
// each row's warps walking a quarter of the positions), and one warp
// walks all of a row's positions at T > 4: a split of the positions
// across blocks was missing.
//
// The chunk redesign (the speculative verify at T 4 and the prefix-hit
// suffix at T 88: one block per (slot, head, split, tile of rows)):
// - A split is a fixed span of pages, planned on the host from the
//   shapes alone (kernels/paged_attention.py chunk_plan: enough blocks
//   to fill the card at a slot's full reach, at least 32 positions a
//   split, and at most the span whose table entries leave two ring
//   slots, so the chunk takes every table the decode kernel takes); the
//   host never reads lens.  A block reads its slot's length
//   and exits at once if its span starts at or past the tile's longest
//   row limit, min(lens + j + 1, P * page); it reads only its own
//   span's table entries and never a page at or past ceil(limit / page).
// - Query rows: tiles of 16 rows at D <= 128, of 8 past it; a tile's rows
//   past T skip their products.
// - A producer warp stages 16 positions at a time (8 past D 128) of K and
//   V, its head's slice of each pool row, into a ring of as many slots as
//   fit 48 KB of shared memory (2 at D 128 and at D 256), each row one
//   1-D bulk copy (TMA, cp.async.bulk) completing on the slot's full
//   mbarrier (4-byte cp.async by the warp's lanes where D % 4 != 0 or a
//   pool is not 16-byte aligned); the consumer warps release a slot on
//   its empty mbarrier.  So the loads run ahead of the arithmetic by the
//   whole ring, without a block-wide barrier, the bytes leave HBM once
//   per (slot, head, tile), and every query row of the tile reads them
//   from shared memory.  A staged row's pitch is D rounded up so that the
//   score reads (lanes on positions) meet in no bank.
// - Scores: threads (row r, position p, part) of the tile, one thread a
//   dot (four at D > 128), the row's running max and normaliser in its
//   lanes, updated by xor shuffles, rows past T skipped; the
//   probabilities and each row's rescale go through shared memory (two
//   buffers, one consumer barrier a slot) to the P.V update: warp w holds
//   rows w + 8 i, lane x the head-dim float4s x + 32 c.  SIMT FMAs: the
//   chunk is bound by bytes at T <= 8 (S 16, T 4: 266 MB, 80 us) and by
//   launch and wave time at T 88 (S 1 over 600 rows: 0.43 GFLOP, 6 us at
//   67 TFLOP/s), so tensor cores would buy nothing.
// - Each block writes its rows' partial softmax (running max m,
//   normaliser l, unnormalised acc[D]) to an f32 scratch the wrapper
//   allocates; a second launch merges, for row j, the ceil(limit / span)
//   splits that hold its positions in split order, whatever order they
//   ran in: the output is the same from call to call.  Two launches a
//   call.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the TPU kernel
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 4;           // positions a warp has in flight

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* tables;
  const int* lens;
  float* out;
  int S, T, H, D, page, P, N;
  int rows;        // query rows per block (R)
  int row_offset;  // limit of row j: lens + j + row_offset
  float scale;
};

__device__ __forceinline__ int row_limit(const Args& a, int s, int j) {
  const long long lim = static_cast<long long>(a.lens[s]) + j + a.row_offset;
  const long long cap = static_cast<long long>(a.P) * a.page;
  return static_cast<int>(lim < 0 ? 0 : (lim > cap ? cap : lim));
}

// DJ head-dim columns per lane: lane x holds columns x + 32 i, i < DJ.
template <int DJ>
__device__ __forceinline__ void attend(const Args& a) {
  extern __shared__ int smem[];
  int* pages = smem;                                      // P entries
  float* m_s = reinterpret_cast<float*>(pages + a.P);     // kWarps
  float* l_s = m_s + kWarps;                              // kWarps
  float* acc_s = l_s + kWarps;                            // kWarps * D

  const int tile = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = kWarps / a.rows;
  const int r = warp / W, wi = warp % W;
  const int j = tile * a.rows + r;
  const bool row_ok = j < a.T;

  // the tile's longest row is its last: the table entries it reaches
  const int j_last = min(tile * a.rows + a.rows, a.T) - 1;
  const int npages = (row_limit(a, s, j_last) + a.page - 1) / a.page;
  for (int i = threadIdx.x; i < npages; i += kThreads) {
    const int pg = a.tables[static_cast<long long>(s) * a.P + i];
    pages[i] = pg < 0 ? 0 : (pg >= a.N ? a.N - 1 : pg);
  }
  __syncthreads();

  const int limit = row_ok ? row_limit(a, s, j) : 0;
  const long long qoff =
      ((static_cast<long long>(s) * a.T + (row_ok ? j : 0)) * a.H + h) * a.D;
  float qv[DJ], acc[DJ];
#pragma unroll
  for (int i = 0; i < DJ; ++i) {
    const int d = lane + 32 * i;
    qv[i] = (row_ok && d < a.D) ? a.q[qoff + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const long long row_stride = static_cast<long long>(a.H) * a.D;
  const long long head_off = static_cast<long long>(h) * a.D;

  for (int t0 = wi * kKeys; t0 < limit; t0 += W * kKeys) {
    float kr[kKeys][DJ], vr[kKeys][DJ];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int t = t0 + u;
      if (t < limit) {
        const long long base =
            (static_cast<long long>(pages[t / a.page]) * a.page + t % a.page) *
                row_stride + head_off;
#pragma unroll
        for (int i = 0; i < DJ; ++i) {
          const int d = lane + 32 * i;
          kr[u][i] = d < a.D ? __ldg(a.k + base + d) : 0.f;
          vr[u][i] = d < a.D ? __ldg(a.v + base + d) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < DJ; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    float sc[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < DJ; ++i) p = fmaf(qv[i], kr[u][i], p);
      sc[u] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kKeys; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      sc[u] *= a.scale;
      if (t0 + u < limit) m_new = fmaxf(m_new, sc[u]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < DJ; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      if (t0 + u < limit) {
        const float p = expf(sc[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < DJ; ++i) acc[i] = fmaf(p, vr[u][i], acc[i]);
      }
    }
    m = m_new;
  }

  // merge the W partial softmaxes of each row
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DJ; ++i) {
    const int d = lane + 32 * i;
    if (d < a.D) acc_s[warp * a.D + d] = acc[i];
  }
  __syncthreads();
  if (wi != 0 || !row_ok) return;
  float M = kNegInf;
  for (int w = 0; w < W; ++w) M = fmaxf(M, m_s[r * W + w]);
  float L = 0.f;
  for (int w = 0; w < W; ++w) L += l_s[r * W + w] * expf(m_s[r * W + w] - M);
  if (L == 0.f) L = 1.f;  // an empty context: zeros, as the TPU kernel
  for (int d = lane; d < a.D; d += 32) {
    float o = 0.f;
    for (int w = 0; w < W; ++w)
      o = fmaf(acc_s[(r * W + w) * a.D + d], expf(m_s[r * W + w] - M), o);
    a.out[qoff + d] = o / L;
  }
}

template <int DJ>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Args a) {
  attend<DJ>(a);
}

template <int DJ>
__global__ void __launch_bounds__(kThreads)
    paged_attention_chunk_kernel(Args a) {
  attend<DJ>(a);
}

template <int DJ>
void launch_dj(const Args& a, bool chunk, dim3 grid, size_t smem,
               cudaStream_t stream) {
  if (chunk)
    paged_attention_chunk_kernel<DJ><<<grid, kThreads, smem, stream>>>(a);
  else
    paged_attention_kernel<DJ><<<grid, kThreads, smem, stream>>>(a);
}

// ---------------------------------------------------------------------------
// the chunk redesign: split over pages, staged K/V (see the header)
// ---------------------------------------------------------------------------

namespace chunk {

namespace wg = ptt::wg;

// A block: 8 consumer warps (the scores and the P.V update) and one
// producer warp (the copies into the ring).
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxSlots = 8;
// CJ: the head-dim float4s a lane holds in the P.V update (D <= 128: 1,
// D <= 256: 2); the positions a ring slot holds (two slots of 16 do not
// fit 48 KB at D 256), R query rows a tile, and the threads a score takes
template <int CJ>
constexpr int kPos = CJ == 1 ? 16 : 8;
template <int CJ>
constexpr int kRows = CJ == 1 ? 16 : 8;
template <int CJ>
constexpr int kParts = kConsumers / (kRows<CJ> * kPos<CJ>);

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* tables;
  const int* lens;
  float* part;   // acc (rows x splits x D), then (m, l) pairs
  float* out;
  int S, T, H, D, page, P, N;
  int span;      // pages a split
  int splits;    // ceil(P / span)
  int dp;        // a staged row's pitch in floats (pitch_of)
  int slots;     // ring slots (slots_of)
  float scale;
};

// Row j's limit: lens + j + 1, capped at P * page, at least 0.
__device__ __forceinline__ int chunk_limit(int len, int j, long long cap) {
  const long long lim = static_cast<long long>(len) + j + 1;
  return static_cast<int>(lim < 0 ? 0 : (lim > cap ? cap : lim));
}

// The pitch of a staged K or V row: D rounded up to 4 floats, then to 4
// kParts (mod 32) floats, so that the score reads (the 8 lanes of a
// quarter warp on positions x kParts parts of the row's float4s) meet in
// no bank, and every row starts 16-byte aligned.
inline int pitch_of(int D, int parts) {
  const int d4 = (D + 3) / 4 * 4;
  return (d4 - 4 * parts + 31) / 32 * 32 + 4 * parts;
}

// Shared memory (bytes) at `slots` ring slots: the slots' full and empty
// mbarriers, the ring (K then V of KP rows a slot), the q tile (qrows
// rows of D rounded up to 4), two buffers of probabilities (R x KP) and
// of rescales (R), the span's table entries.
inline long long smem_bytes(int dp, int D, int R, int KP, int qrows,
                            int span, int slots) {
  return 16LL * slots + 4LL * slots * 2 * KP * dp +
         4LL * qrows * ((D + 3) / 4 * 4) + 8LL * R * KP + 8LL * R +
         4LL * span;
}

// The most ring slots (<= kMaxSlots) of instance CJ that fit 48 KB, or 0
// if two do not.
template <int CJ>
int slots_of(int D, int qrows, int span) {
  const int dp = pitch_of(D, kParts<CJ>);
  for (int s = kMaxSlots; s >= 2; --s)
    if (smem_bytes(dp, D, kRows<CJ>, kPos<CJ>, qrows, span, s) <= 48 * 1024)
      return s;
  return 0;
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Block (split + splits * tile, head, slot): the partial softmax of the
// tile's rows over the split's positions.  kVec: D % 4 == 0 and 16-byte
// aligned pools, each staged row one 1-D bulk copy (TMA) completing on
// its slot's full barrier; otherwise 4-byte cp.async copies by the
// producer warp's 32 lanes, each lane's completion an arrival.
template <int CJ, bool kVec>
__global__ void __launch_bounds__(kThreads, 5)
    paged_chunk_split_kernel(Args a) {
  constexpr int KP = kPos<CJ>, R = kRows<CJ>, PARTS = kParts<CJ>;
  constexpr int RW = R / 8;   // P.V rows a warp
  static_assert(PARTS * R * KP == kConsumers && RW * 8 == R, "the layouts");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int dp = a.dp, S = a.slots;
  const int dq = (a.D + 3) / 4 * 4;
  const int sp = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int h = blockIdx.y, s = blockIdx.z;
  const long long cap = static_cast<long long>(a.P) * a.page;
  const int j0 = tile * R;
  const int qrows = min(R, a.T - j0);
  const uint32_t bars = wg::smem_addr(smem_raw);   // full, then empty
  float* ring = reinterpret_cast<float*>(smem_raw + 16 * S);
  float* qs = ring + S * 2 * KP * dp;
  float* ps = qs + qrows * dq;          // two buffers of R x KP
  float* corr_s = ps + 2 * R * KP;      // two buffers of R
  int* pages = reinterpret_cast<int*>(corr_s + 2 * R);

  const int len = a.lens[s];
  // the tile's longest row limit: its last row's
  const int lim_max = chunk_limit(len, min(j0 + R, a.T) - 1, cap);
  const int start = sp * a.span * a.page;
  if (start >= lim_max) return;
  const int end = min(start + a.span * a.page, lim_max);
  const int pg0 = sp * a.span;
  const int npg = (end - 1) / a.page - pg0 + 1;
  const int nst = (end - start + KP - 1) / KP;
  for (int i = threadIdx.x; i < npg; i += kThreads) {
    const int pg = a.tables[static_cast<long long>(s) * a.P + pg0 + i];
    pages[i] = pg < 0 ? 0 : (pg >= a.N ? a.N - 1 : pg);
  }
  // the q tile (rows past T and columns past D zero)
  for (int i = threadIdx.x; i < qrows * dq; i += kThreads) {
    const int r = i / dq, d = i - r * dq;
    const int j = j0 + r;
    qs[i] = (j < a.T && d < a.D)
                ? a.q[((static_cast<long long>(s) * a.T + j) * a.H + h) *
                          a.D + d]
                : 0.f;
  }
  // With 4-byte copies the last float4 of a staged row holds columns past
  // D that are never written: the ring is zeroed so that they read 0 (a 0
  // * NaN of stale bits would poison the dot).  The bulk copies' rows are
  // read no further than D, and rows past `end` are masked (scores) or
  // skipped (P.V), so that ring is left as it is.
  if constexpr (!kVec) {
    for (int i = threadIdx.x; i < S * 2 * KP * dp; i += kThreads)
      ring[i] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      wg::mbar_init(bars + 8 * i, kVec ? 1 : 32);
      wg::mbar_init(bars + 8 * (S + i), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row_stride = static_cast<long long>(a.H) * a.D;
  const long long head_off = static_cast<long long>(h) * a.D;

  if (warp == kConsumers / 32) {
    // the producer: stage st into slot st % S once the consumers released
    // the stage before it there
    for (int st = 0; st < nst; ++st) {
      const int slot = st % S;
      const uint32_t full = bars + 8 * slot;
      float* kb = ring + slot * 2 * KP * dp;
      const int t0 = start + st * KP;
      const int valid = min(KP, end - t0);
      if (lane == 0) {
        if (st >= S) wg::mbar_wait(bars + 8 * (S + slot), (st / S - 1) & 1);
        if constexpr (kVec)
          wg::mbar_expect_tx(full, 2 * valid * a.D * 4);
      }
      __syncwarp();
      if constexpr (kVec) {
        // lane p: K row p, lane KP + p: V row p
        const int p = lane % KP;
        if (lane < 2 * KP && p < valid) {
          const int t = t0 + p;
          const float* pool = lane < KP ? a.k : a.v;
          const float* src =
              pool + (static_cast<long long>(pages[t / a.page - pg0]) *
                          a.page + t % a.page) * row_stride + head_off;
          bulk_copy(wg::smem_addr(kb + (lane < KP ? 0 : KP * dp) + p * dp),
                    src, a.D * 4, full);
        }
      } else {
        for (int i = lane; i < 2 * valid * a.D; i += 32) {
          const int which = i / (valid * a.D);
          const int e = i - which * valid * a.D;
          const int p = e / a.D, d = e - p * a.D;
          const int t = t0 + p;
          const float* pool = which == 0 ? a.k : a.v;
          cp_async4(wg::smem_addr(kb + which * KP * dp + p * dp + d),
                    pool + (static_cast<long long>(pages[t / a.page - pg0]) *
                                a.page + t % a.page) * row_stride +
                        head_off + d);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     ::"r"(full)
                     : "memory");
      }
    }
    return;
  }

  // the scores' layout: thread (row r_s, position p_s, part), the row's
  // running max and normaliser replicated in its PARTS * KP lanes
  const int tid = threadIdx.x;
  const int part = tid % PARTS;
  const int p_s = tid / PARTS % KP;
  const int r_s = tid / (PARTS * KP);
  const bool row_s = j0 + r_s < a.T;
  const int lim_s = row_s ? min(chunk_limit(len, j0 + r_s, cap), end) : 0;
  const int d4n = (a.D + 3) / 4;
  float m_r = kNegInf, l_r = 0.f;
  // the P.V layout: warp w rows w + 8 i, lane x head-dim float4s x + 32 c
  float4 acc[RW][CJ];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int st = 0; st < nst; ++st) {
    const int slot = st % S;
    wg::mbar_wait(bars + 8 * slot, (st / S) & 1);
    const float* kb = ring + slot * 2 * KP * dp;
    const float* vb = kb + KP * dp;
    float* pb = ps + (st & 1) * R * KP;
    float* cb = corr_s + (st & 1) * R;
    const int t0 = start + st * KP;
    {
      // rows past T (a tile of 16 at T 4, or T 1) skip their products
      float dot = 0.f;
      const float* qr = qs + r_s * dq;
      const float* kr = kb + p_s * dp;
      for (int c = part; c < (row_s ? d4n : 0); c += PARTS) {
        const float4 x = *reinterpret_cast<const float4*>(qr + 4 * c);
        const float4 y = *reinterpret_cast<const float4*>(kr + 4 * c);
        dot = fmaf(x.x, y.x, dot);
        dot = fmaf(x.y, y.y, dot);
        dot = fmaf(x.z, y.z, dot);
        dot = fmaf(x.w, y.w, dot);
      }
#pragma unroll
      for (int off = 1; off < PARTS; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const bool ok = t0 + p_s < lim_s;
      const float sc = ok ? dot * a.scale : kNegInf;
      float mx = sc;
#pragma unroll
      for (int off = PARTS; off < PARTS * KP; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r, mx);
      const float pr = ok ? expf(sc - m_new) : 0.f;
      float sum = pr;
#pragma unroll
      for (int off = PARTS; off < PARTS * KP; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_r - m_new);
      l_r = l_r * corr + sum;
      m_r = m_new;
      if (part == 0) pb[r_s * KP + p_s] = pr;
      if (part == 0 && p_s == 0) cb[r_s] = corr;
    }
    // the consumers' barrier (1; 0 is __syncthreads): the probabilities
    // are written.  One a stage: the buffers alternate, and a warp can
    // write a stage's buffer again only past the next stage's barrier,
    // which waits for every warp's P.V update of this one.
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float corr = cb[warp + 8 * i];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }
    // positions past `end` were not staged: skipped (block-uniform)
    const int valid = min(KP, end - t0);
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      if (p >= valid) break;
      float4 vv[CJ];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int ch = lane + 32 * c;
        vv[c] = ch < d4n
                    ? *reinterpret_cast<const float4*>(vb + p * dp + 4 * ch)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (j0 + warp + 8 * i >= a.T) break;   // warp-uniform
        const float pr = pb[(warp + 8 * i) * KP + p];
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          acc[i][c].x = fmaf(pr, vv[c].x, acc[i][c].x);
          acc[i][c].y = fmaf(pr, vv[c].y, acc[i][c].y);
          acc[i][c].z = fmaf(pr, vv[c].z, acc[i][c].z);
          acc[i][c].w = fmaf(pr, vv[c].w, acc[i][c].w);
        }
      }
    }
    // this warp is done with the slot (K in the scores, V here)
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(bars + 8 * (S + slot));
  }

  // the partials of the tile's rows: row (s, h, j, sp)
  const long long rows = static_cast<long long>(a.S) * a.H * a.T * a.splits;
  const long long row0 =
      ((static_cast<long long>(s) * a.H + h) * a.T + j0) * a.splits + sp;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + 8 * i;
    if (j0 + r >= a.T) continue;
    float* dst = a.part + (row0 + static_cast<long long>(r) * a.splits) * a.D;
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int d = 4 * (lane + 32 * c);
      const float v4[4] = {acc[i][c].x, acc[i][c].y, acc[i][c].z, acc[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < a.D) dst[d + e] = v4[e];
    }
  }
  if (part == 0 && p_s == 0 && row_s) {
    float* ml = a.part + rows * a.D +
                2 * (row0 + static_cast<long long>(r_s) * a.splits);
    ml[0] = m_r;
    ml[1] = l_r;
  }
}

// One warp per output row (s, j, h): the ceil(limit / (span page))
// splits that hold row j's positions, merged in split order; an empty
// context gives zeros.
__global__ void __launch_bounds__(kConsumers) paged_chunk_merge_kernel(Args a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + warp;
  if (row >= static_cast<long long>(a.S) * a.T * a.H) return;
  const int h = static_cast<int>(row % a.H);
  const long long sj = row / a.H;
  const int j = static_cast<int>(sj % a.T);
  const int s = static_cast<int>(sj / a.T);
  const long long per = static_cast<long long>(a.span) * a.page;
  const int lim =
      chunk_limit(a.lens[s], j, static_cast<long long>(a.P) * a.page);
  const int n = static_cast<int>((lim + per - 1) / per);
  const long long base =
      ((static_cast<long long>(s) * a.H + h) * a.T + j) * a.splits;
  const float* ml =
      a.part + static_cast<long long>(a.S) * a.H * a.T * a.splits * a.D;
  float M = kNegInf;
  for (int i = 0; i < n; ++i) M = fmaxf(M, ml[2 * (base + i)]);
  float L = 0.f;
  for (int i = 0; i < n; ++i)
    L += ml[2 * (base + i) + 1] * expf(ml[2 * (base + i)] - M);
  if (L == 0.f) L = 1.f;  // an empty context: zeros, as the TPU kernel
  float* o = a.out + row * a.D;
  for (int d = lane; d < a.D; d += 32) {
    float x = 0.f;
    for (int i = 0; i < n; ++i)
      x = fmaf(a.part[(base + i) * a.D + d], expf(ml[2 * (base + i)] - M), x);
    o[d] = x / L;
  }
}

template <int CJ, bool kVec>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int R = kRows<CJ>;
  const size_t smem = static_cast<size_t>(smem_bytes(
      a.dp, a.D, R, kPos<CJ>, min(R, a.T), a.span, a.slots));
  const unsigned tiles = (a.T + R - 1) / R;
  const dim3 grid(static_cast<unsigned>(a.splits) * tiles, a.H, a.S);
  paged_chunk_split_kernel<CJ, kVec><<<grid, kThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.S) * a.T * a.H;
  paged_chunk_merge_kernel<<<static_cast<unsigned>((rows + 7) / 8),
                             kConsumers, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunk

}  // namespace

// Ring slots the chunk redesign's block takes at head dim D, T query
// rows and `span` pages a split: the most that fit 48 KB of shared
// memory with the rest of the block's (at most kMaxSlots), or 0 where two
// do not fit (kernels/paged_attention.py chunk_slots mirrors it).
PTT_EXPORT int ptt_paged_chunk_slots(int D, int T, int span) {
  if ((D + 31) / 32 * 32 <= 128)
    return chunk::slots_of<1>(D, T < chunk::kRows<1> ? T : chunk::kRows<1>,
                              span);
  return chunk::slots_of<2>(D, T < chunk::kRows<2> ? T : chunk::kRows<2>,
                            span);
}

// The chunk entry point, redesigned: q and out (S, T, H, D) contiguous,
// pools (N, page, H, D) contiguous, tables (S, P) and lens (S,) int32;
// row j of slot s attends over t < lens[s] + j + 1 (capped at P * page).
// span: pages a split (1 <= span <= P; splits = ceil(P / span)); part:
// f32 scratch of S * H * T * splits * (D + 2) floats.  Two launches on
// `stream` (the splits, the merge); returns cudaGetLastError() of the
// last, or cudaErrorInvalidValue for what it does not take.
PTT_EXPORT int ptt_paged_attention_chunk_f32(
    const float* q, const float* k, const float* v, const int* tables,
    const int* lens, float* out, float* part, int S, int T, int H, int D,
    int page, int P, int N, int span, float scale, cudaStream_t stream) {
  if (D < 1 || D > 256 || S < 1 || T < 1 || H < 1 || page < 1 || P < 1 ||
      N < 1 || S > 65535 || H > 65535 || span < 1 || span > P ||
      static_cast<long long>(P) * page > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = ptt_paged_chunk_slots(D, T, span);
  if (slots == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = (D + 31) / 32 * 32 <= 128;
  const chunk::Args a{
      q, k, v, tables, lens, part, out, S, T, H, D, page, P, N, span,
      (P + span - 1) / span,
      chunk::pitch_of(D, small ? chunk::kParts<1> : chunk::kParts<2>), slots,
      scale};
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (small)
    return vec ? chunk::launch<1, true>(a, stream)
               : chunk::launch<1, false>(a, stream);
  return vec ? chunk::launch<2, true>(a, stream)
             : chunk::launch<2, false>(a, stream);
}

// Shared memory a block takes: the slot's table entries and the merge
// buffers of its 8 warps.  The wrapper's gate keeps it under 48 KB.
PTT_EXPORT long long ptt_paged_attention_smem_bytes(int P, int D) {
  return 4LL * P + 4LL * kWarps * (2 + D);
}

// q and out (S, T, H, D) contiguous (T = 1 for the decode step), pools
// (N, page, H, D) contiguous, tables (S, P) and lens (S,) int32.
// chunk = 0: the decode step, row limit lens; chunk = 1: row j's limit
// lens + j + 1.  Launches on `stream`; returns cudaGetLastError() of
// the launch.
PTT_EXPORT int ptt_paged_attention_f32(const float* q, const float* k,
                                       const float* v, const int* tables,
                                       const int* lens, float* out, int S,
                                       int T, int H, int D, int page, int P,
                                       int N, int chunk, float scale,
                                       cudaStream_t stream) {
  if (D < 1 || D > 256 || S < 1 || T < 1 || H < 1 || page < 1 || P < 1 ||
      N < 1 || S > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, tables, lens, out, S, T, H, D, page, P, N, 1, 0, scale};
  if (chunk) {
    int rows = 1;
    while (rows < T && rows < kWarps) rows *= 2;
    a.rows = rows;
    a.row_offset = 1;
  }
  const dim3 grid((T + a.rows - 1) / a.rows, H, S);
  const size_t smem = static_cast<size_t>(ptt_paged_attention_smem_bytes(P, D));
  switch ((D + 31) / 32) {
    case 1: launch_dj<1>(a, chunk, grid, smem, stream); break;
    case 2: launch_dj<2>(a, chunk, grid, smem, stream); break;
    case 3: launch_dj<3>(a, chunk, grid, smem, stream); break;
    case 4: launch_dj<4>(a, chunk, grid, smem, stream); break;
    case 5: launch_dj<5>(a, chunk, grid, smem, stream); break;
    case 6: launch_dj<6>(a, chunk, grid, smem, stream); break;
    case 7: launch_dj<7>(a, chunk, grid, smem, stream); break;
    default: launch_dj<8>(a, chunk, grid, smem, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}
