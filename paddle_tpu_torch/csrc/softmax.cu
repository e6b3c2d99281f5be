// Row softmax in float32: y[r, :] = exp(x[r, :] - max) / sum(exp(...)).
//
// Replaces the TPU kernel paddle_tpu/pallas/softmax.py:68 _softmax_impl
// (_softmax_kernel :14), which holds a (block_rows, cols) block in VMEM
// and needs cols % 128 == 0.  Here any number of rows and columns is
// taken; -inf entries give 0, and a row that is all -inf (or holds +inf
// or NaN) gives NaN, as the plain version does.
//
// What bounds it on the H100: bytes, 8 per element (x read once, y
// written once), at 3.35 TB/s; its arithmetic (an exp or two and a few
// adds an element) is far below the card's rates.  So the design moves
// x from device memory once, and keeps the reductions off the critical
// path.  Three routes, picked by shape and alignment (plan_of here,
// softmax_route in kernels/softmax.py; the entry refuses any other):
//
// - warp (cols <= 2048 where cols % 4 == 0 and x and y are 16-byte
//   aligned, cols <= 1024 otherwise; every path's 2-1000 classes): a
//   group of G lanes owns a row (G the power of two that covers the
//   row's 16-byte or 4-byte units, up to a warp; several rows a block).
//   The row is loaded once into registers, 16 bytes a lane where
//   aligned, reduced by xor shuffles alone (no shared memory and no
//   __syncthreads), and written once.  Past 2048 columns a lane's 64
//   registers of row leave too few warps an SM: at 2048 x 4096 the
//   staged route's one CTA a row is faster (scripts/softmax_variants.py).
// - staged (wider rows, x and y at one offset modulo 16 bytes): a
//   cluster of C CTAs (C = 1-8, each CTA's part about kPartCols columns
//   where that takes at most 8) owns a row, each CTA one part.  Its part
//   is staged in shared memory once by 1-D bulk copies (TMA,
//   cp.async.bulk) in chunks of kChunkCols columns, each chunk on its own
//   mbarrier, so the running max m and sum s (online: s rescaled by
//   exp(m_old - m_new) each chunk) start on the first chunk while the
//   rest arrive.  A part whose start is not 16-byte aligned (cols % 4 !=
//   0) copies its head and tail (0-3 floats each) with 4-byte cp.async:
//   a bulk copy never starts off a 16-byte boundary (a misaligned TMA
//   start faults).  The CTAs exchange their (m_i, s_i) through
//   distributed shared memory (mapa, ld.shared::cluster between two
//   cluster barriers), merge them in rank order (so every CTA holds the
//   same m and s), and each writes its part from shared memory in one
//   sweep: x leaves device memory once and y is written once.  The
//   overlap of one row's loads with another's writes comes from the
//   split: parts of about kPartCols columns (64 KB) leave room for three
//   CTAs an SM, so while one CTA writes its part, the others' bulk copies
//   are in flight.  scripts/softmax_variants.py measures the cluster
//   sizes and chunk sizes at 2048 x 30000 (the kept rule is C =
//   ceil(cols / kPartCols), at most 8).
// - two-read (rows past 8 parts of one CTA's shared memory, about 463 k
//   columns, or x and y at different offsets modulo 16 bytes): a cluster
//   of C CTAs, each reading its part twice, the first time for its
//   online (m, s), exchanged as above, the second time to write y.
//   3 passes of bytes against the bound's 2.
//
// The sums are taken in another order than the plain version's, and y
// is exp(x - m) times 1 / s (one division a thread, not one an element:
// at the paths' 1000 columns the divisions held a lane longer than its
// loads): the results agree within a few float32 ulps (atol 1e-6 in the
// tests).
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

// the routes, numbered as kernels/softmax.py's ROUTES
constexpr int kWarpRoute = 0;
constexpr int kStagedRoute = 1;
constexpr int kTwoReadRoute = 2;

// the warp route's widest rows: 16-byte units, 4-byte units
constexpr int kNarrowVec = 2048;
constexpr int kNarrowScalar = 1024;
constexpr int kWarpThreads = 128;

// the staged and two-read routes
constexpr int kPartCols = 16384;   // columns a CTA aims at (64 KB)
constexpr int kMaxCluster = 8;
constexpr int kChunkCols = 2048;   // columns a bulk-copied chunk (8 KB)
constexpr int kMaxChunks = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a block's opt-in shared memory on the H100 (227 KB)
constexpr int kSmemLimit = 232448;
// the staged CTA's shared memory before its part: the chunks' mbarriers,
// the warps' partials (m, s), the CTA's partial (m, s) that its peers
// read (padded to 16 bytes)
constexpr int kHeaderBytes = 8 * kMaxChunks + 8 * kWarps + 16;
// columns of a staged part: the buffer holds the part shifted by up to 3
// floats so that its body starts 16-byte aligned
constexpr int kStagedCap = ((kSmemLimit - kHeaderBytes) / 4 - 4) / 4 * 4;
static_assert(kHeaderBytes % 16 == 0, "the part's buffer is 16-byte aligned");
static_assert(kStagedCap <= kMaxChunks * kChunkCols, "one mbarrier a chunk");

// A wait on an mbarrier longer than this many clocks (about 17 s) traps:
// a copy that never lands ends the launch with an error instead of
// hanging the card.
constexpr long long kWaitTrapClocks = 1ll << 35;

struct Plan {
  int route, cluster, part;
};

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// The rule (kernels/softmax.py softmax_route / softmax_plan mirror it).
Plan plan_of(int cols, uintptr_t x, uintptr_t y) {
  const bool vec = cols % 4 == 0 && x % 16 == 0 && y % 16 == 0;
  if (cols <= (vec ? kNarrowVec : kNarrowScalar)) return {kWarpRoute, 1, cols};
  const int c = ceil_div(cols, kPartCols) < kMaxCluster
                    ? ceil_div(cols, kPartCols)
                    : kMaxCluster;
  const int part = ceil_div(ceil_div(cols, c), 4) * 4;
  if ((x - y) % 16 == 0 && part <= kStagedCap)
    return {kStagedRoute, c, part};
  return {kTwoReadRoute, c, part};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (m, s) of the union of two sets of elements, each given by its max and
// its sum of exp(x - max).  All -inf so far: (-inf, 0).
__device__ __forceinline__ void merge(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

// The sum of e[0..N) by halves (N a power of two), in place: a running
// sum then takes one add for N terms, and its rounding error grows with
// the number of folds, not of elements.
template <int N>
__device__ __forceinline__ float tree_sum(float* e) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) e[i] += e[i + w];
  }
  return e[0];
}

// Fold N values (a power of two) into this thread's running (m, s).
template <int N>
__device__ __forceinline__ void fold(float& m, float& s, const float* v) {
  float cm = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) cm = fmaxf(cm, v[i]);
  const float mn = fmaxf(m, cm);
  if (mn == -INFINITY) return;
  float e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = expf(v[i] - mn);
  s = s * expf(m - mn) + tree_sum<N>(e);
  m = mn;
}

// ---------------------------------------------------------------------
// the warp route

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// G lanes a row, NV units a lane (a unit 4 floats with V4, else 1): lane
// l holds units l + G i, so that a group's loads are contiguous.
template <int G, int NV, bool V4>
__global__ void __launch_bounds__(kWarpThreads)
    softmax_warp_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int rows, int cols) {
  constexpr int W = V4 ? 4 : 1;
  const int lane = threadIdx.x % G;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kWarpThreads / G) +
      threadIdx.x / G;
  const bool live = row < rows;
  const long long base = (live ? row : 0) * static_cast<long long>(cols);
  float v[NV * W];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = i * G + lane;
    if constexpr (V4) {
      float4 t = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (live && 4 * u < cols)
        t = __ldg(reinterpret_cast<const float4*>(x + base) + u);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    } else {
      v[i] = (live && u < cols) ? __ldg(x + base + u) : -INFINITY;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NV * W; ++j) m = fmaxf(m, v[j]);
  m = group_max<G>(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool in = live && (i * G + lane) * W < cols;
#pragma unroll
    for (int k = 0; k < W; ++k) v[i * W + k] = in ? expf(v[i * W + k] - m) : 0.f;
    // a unit's exps by halves, then into the lane's running sum
    s += W == 4 ? (v[4 * i] + v[4 * i + 1]) + (v[4 * i + 2] + v[4 * i + 3])
                : v[i * W];
  }
  const float r = 1.f / group_sum<G>(s);  // one division a lane
  if (!live) return;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = i * G + lane;
    if (u * W >= cols) continue;
    if constexpr (V4) {
      reinterpret_cast<float4*>(y + base)[u] =
          make_float4(v[4 * i] * r, v[4 * i + 1] * r, v[4 * i + 2] * r,
                      v[4 * i + 3] * r);
    } else {
      y[base + u] = v[i] * r;
    }
  }
}

// ---------------------------------------------------------------------
// the cluster's exchange (staged and two-read)

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's (m, s) from every thread's: shuffles in each warp, then
// warp order through `red` (2 floats a warp).  Every thread returns it.
__device__ __forceinline__ void block_merge(float& m, float& s, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, mo, so);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[2 * warp] = m;
    red[2 * warp + 1] = s;
  }
  __syncthreads();
  m = red[0];
  s = red[1];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) merge(m, s, red[2 * w], red[2 * w + 1]);
}

// The row's (m, s) from the cluster's CTAs: each publishes its own in
// `mine`, then every thread reads all of them in rank order (the same
// merge in every CTA).  Ends with this CTA's arrival on the cluster
// barrier that cluster_done() waits on before exit, so that no CTA
// leaves while a peer may still read its `mine`.
__device__ __forceinline__ void cluster_merge(float& m, float& s, float* mine,
                                              uint32_t csize) {
  if (csize == 1) return;
  if (threadIdx.x == 0) {
    mine[0] = m;
    mine[1] = s;
  }
  cluster_sync();
  const uint32_t local = smem_addr(mine);
  m = -INFINITY;
  s = 0.f;
  for (uint32_t r = 0; r < csize; ++r) {
    uint32_t remote;
    float mo, so;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(local), "r"(r));
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                 : "=f"(mo)
                 : "r"(remote)
                 : "memory");
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                 : "=f"(so)
                 : "r"(remote + 4)
                 : "memory");
    merge(m, s, mo, so);
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_done(uint32_t csize) {
  if (csize > 1)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// the staged route

__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitTrapClocks) __trap();
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// CTA (row, rank) of a cluster of C: columns [rank * part, + len) of the
// row.  Shared memory: kMaxChunks mbarriers, the warps' partials, the
// CTA's partial, then the part at float offset `shift`, so that its
// 16-byte aligned body starts on a 16-byte boundary.
__global__ void __launch_bounds__(kThreads)
    softmax_staged_kernel(const float* __restrict__ x, float* __restrict__ y,
                          int cols, int part) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = smem_addr(smem);
  float* red = reinterpret_cast<float*>(smem + 8 * kMaxChunks);
  float* mine = red + 2 * kWarps;
  float* buf = reinterpret_cast<float*>(smem + kHeaderBytes);

  const uint32_t csize = cluster_size();
  const int rank = static_cast<int>(cluster_rank());
  const long long row = blockIdx.x / csize;
  const int c0 = rank * part;
  const int len = max(0, min(part, cols - c0));
  const float* src = x + row * cols + c0;
  float* dst = y + row * cols + c0;
  // the floats before src's first 16-byte boundary, the aligned body,
  // the floats after it
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(len, (4 - mis) & 3);
  const int body = (len - head) & ~3;
  const int tail = len - head - body;
  const int shift = (4 - head) & 3;  // buf[shift + j] holds column c0 + j
  const int nchunks = (body + kChunkCols - 1) / kChunkCols;
  float4* b4 = reinterpret_cast<float4*>(buf + shift + head);

  if (threadIdx.x == 0) {
    for (int k = 0; k < nchunks; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * k)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < nchunks; ++k) {
      const int n = min(kChunkCols, body - k * kChunkCols);
      const uint32_t bar = bars + 8 * k;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                       "r"(bar),
                   "r"(4 * n)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(b4 + k * kChunkCols / 4)),
          "l"(src + head + k * kChunkCols), "r"(4 * n), "r"(bar)
          : "memory");
    }
  }
  // head and tail, 4 bytes a lane
  if (threadIdx.x < head) {
    cp_async4(smem_addr(buf + shift + threadIdx.x), src + threadIdx.x);
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + tail) {
    const int j = head + body + threadIdx.x - 32;
    cp_async4(smem_addr(buf + shift + j), src + j);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float m = -INFINITY, s = 0.f;
  {
    float v[1] = {-INFINITY};
    if (threadIdx.x < head) v[0] = buf[shift + threadIdx.x];
    else if (threadIdx.x >= 32 && threadIdx.x < 32 + tail)
      v[0] = buf[shift + head + body + threadIdx.x - 32];
    fold<1>(m, s, v);
  }
  // each chunk as it lands: kPer float4s a thread
  constexpr int kPer = kChunkCols / 4 / kThreads;
  static_assert(kPer * 4 * kThreads == kChunkCols, "a chunk's float4s");
  for (int k = 0; k < nchunks; ++k) {
    mbar_wait(bars + 8 * k);
    const int n4 = min(kChunkCols, body - k * kChunkCols) / 4;
    float v[4 * kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const float4 t = q < n4 ? b4[k * kChunkCols / 4 + q]
                              : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                            -INFINITY);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
    fold<4 * kPer>(m, s, v);
  }
  block_merge(m, s, red);
  cluster_merge(m, s, mine, csize);

  // the sweep: y from shared memory, written once
  const float r = 1.f / s;
  const int n4 = body / 4;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    const float4 t = b4[q];
    d4[q] = make_float4(expf(t.x - m) * r, expf(t.y - m) * r,
                        expf(t.z - m) * r, expf(t.w - m) * r);
  }
  if (threadIdx.x < head) {
    dst[threadIdx.x] = expf(buf[shift + threadIdx.x] - m) * r;
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + tail) {
    const int j = head + body + threadIdx.x - 32;
    dst[j] = expf(buf[shift + j] - m) * r;
  }
  cluster_done(csize);
}

// ---------------------------------------------------------------------
// the two-read route: each CTA of a cluster reads its part twice

template <bool V4>
__global__ void __launch_bounds__(kThreads)
    softmax_two_read_kernel(const float* __restrict__ x, float* __restrict__ y,
                            int cols, int part) {
  __shared__ float red[2 * kWarps];
  __shared__ __align__(16) float mine[4];
  const uint32_t csize = cluster_size();
  const int rank = static_cast<int>(cluster_rank());
  const long long row = blockIdx.x / csize;
  const int c0 = rank * part;
  const int len = max(0, min(part, cols - c0));
  const float* src = x + row * cols + c0;
  float* dst = y + row * cols + c0;
  constexpr int U = 4;  // loads in flight a thread an iteration

  float m = -INFINITY, s = 0.f;
  if constexpr (V4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int n4 = len / 4;
    for (int q0 = threadIdx.x; q0 < n4; q0 += U * kThreads) {
      float v[4 * U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int q = q0 + i * kThreads;
        const float4 t = q < n4 ? __ldg(s4 + q)
                                : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                              -INFINITY);
        v[4 * i] = t.x;
        v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z;
        v[4 * i + 3] = t.w;
      }
      fold<4 * U>(m, s, v);
    }
  } else {
    for (int j0 = threadIdx.x; j0 < len; j0 += 4 * U * kThreads) {
      float v[4 * U];
#pragma unroll
      for (int i = 0; i < 4 * U; ++i) {
        const int j = j0 + i * kThreads;
        v[i] = j < len ? __ldg(src + j) : -INFINITY;
      }
      fold<4 * U>(m, s, v);
    }
  }
  block_merge(m, s, red);
  cluster_merge(m, s, mine, csize);

  const float r = 1.f / s;
  if constexpr (V4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int q = threadIdx.x; q < len / 4; q += kThreads) {
      const float4 t = __ldg(s4 + q);
      d4[q] = make_float4(expf(t.x - m) * r, expf(t.y - m) * r,
                          expf(t.z - m) * r, expf(t.w - m) * r);
    }
  } else {
    for (int j = threadIdx.x; j < len; j += kThreads)
      dst[j] = expf(__ldg(src + j) - m) * r;
  }
  cluster_done(csize);
}

// ---------------------------------------------------------------------
// launches

template <int G, int NV, bool V4>
int launch_warp_kernel(const float* x, float* y, int rows, int cols,
                       cudaStream_t stream) {
  constexpr int per = kWarpThreads / G;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  softmax_warp_kernel<G, NV, V4><<<blocks, kWarpThreads, 0, stream>>>(
      x, y, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

template <bool V4>
int launch_warp(const float* x, float* y, int rows, int cols,
                cudaStream_t stream) {
  const int units = V4 ? cols / 4 : cols;
  if (units <= 32) {
    if (units <= 1) return launch_warp_kernel<1, 1, V4>(x, y, rows, cols, stream);
    if (units <= 2) return launch_warp_kernel<2, 1, V4>(x, y, rows, cols, stream);
    if (units <= 4) return launch_warp_kernel<4, 1, V4>(x, y, rows, cols, stream);
    if (units <= 8) return launch_warp_kernel<8, 1, V4>(x, y, rows, cols, stream);
    if (units <= 16)
      return launch_warp_kernel<16, 1, V4>(x, y, rows, cols, stream);
    return launch_warp_kernel<32, 1, V4>(x, y, rows, cols, stream);
  }
  const int nv = (units + 31) / 32;
  if (nv <= 2) return launch_warp_kernel<32, 2, V4>(x, y, rows, cols, stream);
  if (nv <= 4) return launch_warp_kernel<32, 4, V4>(x, y, rows, cols, stream);
  if (nv <= 8) return launch_warp_kernel<32, 8, V4>(x, y, rows, cols, stream);
  if (nv <= 16) return launch_warp_kernel<32, 16, V4>(x, y, rows, cols, stream);
  // 4-byte rows up to 1024 columns; 16-byte rows stop at 2048 (nv 16)
  if constexpr (!V4) {
    if (nv <= 32)
      return launch_warp_kernel<32, 32, false>(x, y, rows, cols, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int staged_smem(int part) { return kHeaderBytes + 4 * (part + 4); }

// Lets `kernel` take a block's whole opt-in shared memory on the current
// device, once per device: the first launch sets it, so that a launch
// inside a CUDA graph capture makes no attribute call.
template <class Kernel>
int allow_smem(Kernel kernel) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemLimit);
  if (e != cudaSuccess) return static_cast<int>(e);
  done.fetch_or(bit);
  return 0;
}

template <class Kernel>
int launch_cluster(Kernel kernel, const float* x, float* y, int rows,
                   int cols, int cluster, int part, int smem,
                   cudaStream_t stream) {
  if (static_cast<long long>(rows) * cluster > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const int e = allow_smem(kernel);
    if (e) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, y, cols, part);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// Launches `route` with a cluster of `cluster` CTAs (staged, two-read);
// cudaErrorInvalidValue where that route's kernel cannot take the shape
// or the alignment.
int launch(const float* x, float* y, int rows, int cols, int route,
           int cluster, cudaStream_t stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  const bool vec = cols % 4 == 0 && xa % 16 == 0 && ya % 16 == 0;
  if (rows <= 0 || cols <= 0 || xa % 4 != 0 || ya % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kWarpRoute) {
    if (cols > (vec ? kNarrowVec : kNarrowScalar))
      return static_cast<int>(cudaErrorInvalidValue);
    return vec ? launch_warp<true>(x, y, rows, cols, stream)
               : launch_warp<false>(x, y, rows, cols, stream);
  }
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int part = ceil_div(ceil_div(cols, cluster), 4) * 4;
  if (route == kStagedRoute) {
    if ((xa - ya) % 16 != 0 || part > kStagedCap)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_cluster(softmax_staged_kernel, x, y, rows, cols, cluster,
                          part, staged_smem(part), stream);
  }
  if (route == kTwoReadRoute) {
    return vec ? launch_cluster(softmax_two_read_kernel<true>, x, y, rows,
                                cols, cluster, part, 0, stream)
               : launch_cluster(softmax_two_read_kernel<false>, x, y, rows,
                                cols, cluster, part, 0, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the softmax of x (rows, cols) into y on `stream` by `route`,
// which must be the one the rule picks (plan_of): any other is refused
// with cudaErrorInvalidValue, never replaced.  Returns the launch's error.
PTT_EXPORT int ptt_softmax_f32(const float* x, float* y, int rows, int cols,
                               int route, cudaStream_t stream) {
  const Plan p = plan_of(cols, reinterpret_cast<uintptr_t>(x),
                         reinterpret_cast<uintptr_t>(y));
  if (route != p.route) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, y, rows, cols, p.route, p.cluster, stream);
}

// Any route at any cluster size its kernel can take, off the rule: for
// scripts/softmax_variants.py and the card tests, never for the op.
PTT_EXPORT int ptt_softmax_variant_f32(const float* x, float* y, int rows,
                                       int cols, int route, int cluster,
                                       cudaStream_t stream) {
  return launch(x, y, rows, cols, route, cluster, stream);
}

// The rule's (route, cluster, part) for cols columns at addresses x, y,
// and the staged part's limit and the preferred part: out[0..4].
PTT_EXPORT int ptt_softmax_plan(int cols, const void* x, const void* y,
                                int* out) {
  const Plan p = plan_of(cols, reinterpret_cast<uintptr_t>(x),
                         reinterpret_cast<uintptr_t>(y));
  out[0] = p.route;
  out[1] = p.cluster;
  out[2] = p.part;
  out[3] = kStagedCap;
  out[4] = kPartCols;
  return 0;
}
