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
// An empty context (limit 0) gives zeros, as the TPU kernel's l == 0
// -> 1 does (:159-163); the jnp reference gives the mean of V there.
// Page ids outside [0, N) are clamped into the pool, as the JAX
// reference's gather clamps them: no read leaves the pool.
//
// What bounds it on the H100: bytes.  Each slot's K and V rows up to
// its limit are read once, sum(limits) * H * D * 4 B * 2; at S 16,
// H 16, D 128 with every lens 2048 that is 537 MB, 0.160 ms at
// 3.35 TB/s, against 2 * 2 * 16 * 16 * 2048 * 128 = 268 MFLOP (4 us at
// 67 TFLOP/s f32).  The chunk reads the same bytes once per query row
// of a tile (T <= 8 rows share one block's reads through L1, longer
// chunks re-read them from L2 once per tile of 8 rows).  This is a
// simple kernel: split-K across blocks ("flash-decoding") for short
// batches, cp.async or TMA pipelining and bf16 pools are later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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

}  // namespace

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
