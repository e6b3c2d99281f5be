// Whole-sequence LSTM, forward and backward, one launch each per
// sequence: thread-block clusters that walk the T steps, one cluster per
// tile of batch rows.  Two instances of each, by the element type of the
// sequence tensors: float32, and bf16 (AMP: the TPU kernel on bf16 xproj,
// h0 and c0 with the float32 master W and bias).  Both carry h and c in
// float32 across the steps, take h W with float32 sums, and round only
// what they write, as pallas/lstm.py:41-65 does.
//
// The forward replaces the TPU kernel paddle_tpu/pallas/lstm.py:112
// _lstm_seq_impl: _lstm_kernel (:35, grid (T,), pallas_call :148) and its
// VMEM tiling _lstm_kernel_blocked (:94, grid (B/bb, T), pallas_call
// :122), both running _lstm_step_body (:48) for every t:
//   gates = xproj_t + h_{t-1} W + bias      (gate order i, f, cand, o)
//   i, f, o = sigmoid(.), g = tanh(.)
//   c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
// and writing hs, cs and the activated gates.  The backward is the
// counterpart of the custom_vjp's reverse lax.scan, _lstm_seq_bwd
// (pallas/lstm.py:191-230), which XLA compiles into one device loop: for
// t = T-1 .. 0, from the forward's gates and cs,
//   dh = dh_next + dhs_t,  dc = dc_next + dcs_t + dh o (1 - tanh^2 c_t)
//   dgates = [dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), dh tanh(c_t)
//             o(1-o)]
//   dh_next = dgates W^T,  dc_next = dc f
// writing dgates (float32) and, after t = 0, dh0 and dc0 (float32).  dW
// and dbias are one product and one sum over all T B rows, outside.
//
// The design.  Batch rows never interact: h_t[b] depends on h_{t-1}[b]
// only.  So the launch is ceil(B / rows) independent clusters, one per
// tile of `rows` (4 or 8) batch rows, and no cluster waits on another
// (no cooperative launch, any B).  The cluster's `cluster` blocks split
// the H hidden units, `units` each.  Every step a block needs the whole
// of h_{t-1} (the backward: the whole 4H row of dgates_t) for the tile's
// rows: each block keeps it in its own shared memory, in two slots
// ([k][row] floats; slot t % 2 holds step t's), and stores its units'
// part of step t into that slot of every peer through distributed
// shared memory with st.async, which completes on the peer's mbarrier
// for the slot (Exchange below).  No barrier a step: a block waits only
// for its own slot's mbarrier phase, and two slots are enough because a
// peer can send step t's data only after it has received this block's
// step t - 1 data, which this block sends after it has read the slot
// that data overwrites.  A cluster barrier before the first step and
// after the last keeps every block present while a peer may write into
// its shared memory.  Where two of the backward's 4H-row slots do not
// fit (H 1280 at 8 rows), it takes one, and a cluster barrier spans each
// step: a block arrives once it has read the slot and waits before it
// writes into its peers'.  The cell state and the backward's
// (dh, dc) carry stay in the registers of the thread that owns the
// (unit, row) pair.  The block's slice of W (forward: H x 4 units
// columns; backward: units rows x 4H, read as its transpose) sits in
// shared memory for the whole sequence where it fits beside the slots
// ("resident", loaded once by cp.async), else it streams from L2
// through a ring of kStages chunks of kc rows, refilled by cp.async
// while the previous chunks are summed.  The plan (make_plan, mirrored
// by kernels/lstm.py:plan and exported as ptt_lstm_plan) picks rows,
// cluster, units, the thread tiling and the route from (B, H, the SM
// count, the shared-memory limit).
//
// The product of a step: each thread sums an R x CW register tile (the
// tile's R rows by CW columns) over its kk rows of K of each chunk, f32
// fmaf in k order; the ks partial sums of a column go through shared
// memory and are added in s order by the thread that owns the pair.  The
// order is fixed: two calls are bit for bit the same.  No atomics.
//
// xproj is read through its batch and time strides (the op's (B, T, 4H)
// view of the input projection); hs and cs are written as contiguous
// (B, T, H), the op's layout, and the gates as contiguous (B, T, 4H).
//
// What bounds it on the H100: operations, 2 T B H 4H FLOPs in each
// direction (0.050 ms at T 100, B 64, H 256 on 67 TFLOP/s f32); but the
// T dependent steps set a latency floor that bound does not count.  A
// step costs the block's share of the product (rows x 4 units x H FMAs
// over its 256 threads, fed from shared memory), the cell update and the
// exchange with the cluster's other blocks, not a grid-wide barrier and
// not a reload of h and W from L2.  Where W streams (H 512 and 1280, at
// 16 blocks a cluster), every cluster reads all of W from L2 every step:
// tiles x 4H^2 x 4 bytes a step.
//
// The earlier design, one cooperative grid with a grid-wide barrier a
// step that re-read h_{t-1} and W from L2 in dependent rounds, stays
// below as namespace grid (ptt_lstm_seq_grid_*), reached only by name, so
// that the two are measured side by side.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

constexpr int kThreads = 256;
constexpr int kMaxPairs = 4;      // (unit, row) pairs a thread owns
constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kUnitsTarget = 32;  // hidden units a block aims at
constexpr int kStages = 3;        // the streamed route's ring
constexpr int kBarrierBytes = 16; // the exchange's two mbarriers

// The launch plan of one direction.
struct Plan {
  int rows;     // batch rows per tile (4 or 8): the kernel's R
  int cluster;  // blocks per cluster
  int units;    // hidden units per block (the last block may have fewer)
  int tiles;    // clusters
  int cw;       // columns per thread (forward 4; backward 1 or 2)
  int ncp;      // columns per block, padded to cw (forward: 4 gates of
                // units rounded up to 4)
  int pitch;    // floats per K row of the W slice in shared memory
  int ks;       // threads along K
  int kk;       // K rows per thread per chunk
  int kc;       // K rows per chunk (ks kk)
  int chunks;   // chunks per step (1 where resident)
  int stages;   // 0: W resident; else the ring's stages
  int smem;     // dynamic shared memory bytes
  int slots;    // the exchange's slots: 2, or 1 (backward only)
};

constexpr int kPlanFields = 14;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// The plan of a call on B rows, H hidden units, on a card of `sms` SMs
// with `smem_limit` bytes of shared memory a block; `rows` and `cluster`
// force those choices where non-zero (variants for measurement).
// Returns 0, or cudaErrorInvalidValue for a shape no plan takes.
//   cluster: the least power of two that leaves each block at most
//     kUnitsTarget units, at most kMaxCluster;
//   rows: 4 where ceil(B / 4) clusters fill at most half the SMs, else
//     8 (4 where 8 does not fit shared memory or the pairs): the card
//     does not hold sms / cluster clusters at once (an H100's 132 SMs
//     hold 15 clusters of 8 and 7 of 16), and a second wave of clusters
//     doubles the time;
//   columns: forward the 4 gates of the block's units (cw 4, units
//     rounded up to 4 per gate); backward the units (cw 2, 1 at one
//     unit), the W slice's rows 2 floats apart;
//   ks = 256 / (columns / cw) threads along K;
//   resident where two slots of K x rows, the partial sums and the
//     K x pitch slice fit; else kStages chunks of as many K rows
//     (kc a multiple of ks) as fit beside the slots and partials;
//   the backward, whose slots hold 4H rows, takes one slot (and a
//     cluster barrier a step) where two do not fit at these rows.
int make_plan(int B, int H, int sms, int backward, int smem_limit,
              int rows_req, int cluster_req, Plan* p) {
  if (B < 1 || H < 1 || sms < 1 || (rows_req && rows_req != 4 &&
                                    rows_req != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cluster =
      cluster_req ? cluster_req
                  : min(kMaxCluster, pow2_ceil(ceil_div(H, kUnitsTarget)));
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = ceil_div(H, cluster);
  if ((cluster - 1) * units >= H)  // a block without units
    return static_cast<int>(cudaErrorInvalidValue);
  const int first =
      rows_req ? rows_req : (ceil_div(B, 4) * cluster <= sms / 2 ? 4 : 8);
  for (int trial = 0; trial < 4; ++trial) {
    const int rows = first - 4 * (trial / 2), nslots = 2 - trial % 2;
    if (rows < 4 || (rows_req && rows != rows_req) ||
        (nslots == 1 && !backward))
      continue;
    const int K = backward ? 4 * H : H;
    const int cw = backward ? (units == 1 ? 1 : 2) : 4;
    const int ncp = backward ? ceil_div(units, cw) * cw
                             : 4 * (ceil_div(units, 4) * 4);
    const int pitch = backward ? ncp + 2 : ncp;
    const int ncg = ncp / cw;
    if (ncg > kThreads) return static_cast<int>(cudaErrorInvalidValue);
    const int ks = kThreads / ncg;
    if (units * rows > kMaxPairs * kThreads) continue;
    const long long slots = 1LL * nslots * K * rows * 4 + kBarrierBytes;
    const long long red = 1LL * ks * rows * ncp * 4;
    const long long whole = 1LL * K * pitch * 4;
    Plan q{};
    q.rows = rows;
    q.cluster = cluster;
    q.units = units;
    q.tiles = ceil_div(B, rows);
    q.cw = cw;
    q.ncp = ncp;
    q.pitch = pitch;
    q.ks = ks;
    q.slots = nslots;
    if (slots + red + whole <= smem_limit) {
      q.kk = ceil_div(K, ks);
      q.kc = ks * q.kk;
      q.chunks = 1;
      q.stages = 0;
      q.smem = static_cast<int>(slots + red + whole);
    } else {
      const long long avail = smem_limit - slots - red;
      const long long kk = avail / (1LL * kStages * ks * pitch * 4);
      if (kk < 1) continue;
      q.kk = static_cast<int>(kk);
      q.kc = ks * q.kk;
      q.chunks = ceil_div(K, q.kc);
      q.stages = kStages;
      q.smem = static_cast<int>(slots + red + 1LL * kStages * q.kc * pitch * 4);
    }
    *p = q;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What both kernels take of the plan, and the shape.
struct Shape {
  int B, T, H;
  int cluster, units, ncp, pitch, ks, kk, kc, chunks, stages, slots;
  int vec;  // forward: the W slice's rows are 16-byte runs (cp.async 16)
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A wait on an mbarrier longer than this many clocks (about 17 s) traps:
// a phase that never completes (a fault of the exchange's accounting)
// ends the launch with an error instead of hanging the card.
constexpr long long kWaitTrapClocks = 1ll << 35;

// A step's exchange between the blocks of a cluster.  Each block keeps
// two slots (step t's in slot t % 2) and, for each, an mbarrier in its
// own shared memory.  A block stores its slab of step t into that slot
// of every peer with st.async, which completes on the peer's mbarrier
// for the slot; the block that owns the slot arms the mbarrier's phase
// with one arrival expecting the bytes all its peers send, and reads
// the slot once the phase has completed.  No barrier a step: a block
// can be sent step t's data only by peers that have received its own
// step t - 1 data, sent after it finished reading the slot t's data
// overwrites (two steps back).  scripts/lstm_variants.py measures it
// beside generic stores through map_shared_rank and one barrier.cluster
// arrive.release / wait.acquire a step (its cluster_barrier variant).
struct Exchange {
  uint32_t bar;    // shared address of the two mbarriers (8 bytes each)
  uint32_t bytes;  // what the peers send into a slot a step

  // Thread 0, before the cluster barrier that publishes it: both
  // mbarriers for one arrival, each armed for its first phase.  A block
  // alone in its cluster has no peers and no mbarriers (an arming that
  // expects no bytes would complete its phase at once, and the next
  // arming could pass a phase some thread still waits on).
  __device__ void init() const {
    if (threadIdx.x != 0 || bytes == 0) return;
    for (int slot = 0; slot < 2; ++slot)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       bar + 8 * slot)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm(0);
    arm(1);
  }

  // The slot's next phase: one arrival that expects the peers' bytes.
  __device__ void arm(int slot) const {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar + 8 * slot),
                 "r"(bytes)
                 : "memory");
  }

  // Every thread: until phase `phase` of the slot has completed (the
  // peers' stores into it are visible), then thread 0 arms the next.
  __device__ void wait(int slot, int phase) const {
    if (bytes == 0) return;
    const uint32_t b = bar + 8 * slot;
    const uint32_t parity = phase & 1;
    const long long t0 = clock64();
    for (;;) {
      uint32_t done;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"(parity)
          : "memory");
      if (done) break;
      if (clock64() - t0 > kWaitTrapClocks) __trap();
    }
    if (threadIdx.x == 0) arm(slot);
  }

  // The `n` floats (a multiple of 4, 16-byte aligned) at `src` in this
  // block's slot `slot` to the same place in every peer.
  __device__ void send(cg::cluster_group& cluster, const float* src, int n,
                       int slot) const {
    const int rank = static_cast<int>(cluster.block_rank());
    const int peers = static_cast<int>(cluster.num_blocks()) - 1;
    const int nv = n / 4;
    const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(src));
    const float4* from = reinterpret_cast<const float4*>(src);
    for (int idx = threadIdx.x; idx < peers * nv; idx += kThreads) {
      int peer = idx / nv;
      peer += peer >= rank;
      const int v = idx % nv;
      uint32_t to, to_bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(to)
                   : "r"(local + 16 * v), "r"(peer));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(to_bar)
                   : "r"(bar + 8 * slot), "r"(peer));
      const float4 x = from[v];
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
          "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(to),
          "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(to_bar)
          : "memory");
    }
  }
};

// Rows [k0, k0 + n) of the forward's W slice into `dst` ([k][pitch]):
// dst[k][g ub + u] = W[k][g H + j0 + u] for u < nu, zero for the
// padding u < ub; rows past K are left alone (never read).
__device__ __forceinline__ void fill_fwd(float* dst, const float* w,
                                         const Shape& s, int j0, int nu,
                                         int k0, int n) {
  const int H = s.H, ub = s.ncp / 4;
  n = min(n, H - k0);
  if (s.vec) {  // ub == nu, a multiple of 4; H % 4 == 0; W 16-byte aligned
    const int per = s.ncp / 4;
    for (int q = threadIdx.x; q < n * per; q += kThreads) {
      const int r = q / per, c = (q % per) * 4;
      const int g = c / ub, u = c % ub;
      ptt::cp_async16(dst + r * s.pitch + c,
                      w + static_cast<long long>(k0 + r) * 4 * H + g * H +
                          j0 + u,
                      true);
    }
    return;
  }
  for (int q = threadIdx.x; q < n * s.ncp; q += kThreads) {
    const int r = q / s.ncp, c = q % s.ncp;
    const int g = c / ub, u = c % ub;
    const bool ok = u < nu;
    ptt::cp_async4(dst + r * s.pitch + c,
                   ok ? w + static_cast<long long>(k0 + r) * 4 * H + g * H +
                            j0 + u
                      : w,
                   ok);
  }
}

// Rows [k0, k0 + n) of the backward's W slice, W^T restricted to the
// block's units: dst[kap][u] = W[j0 + u][kap] (kap = g H + j, the gate
// column), zero for u >= nu; read along W's rows (coalesced), written
// down dst's columns (pitch = ncp + 2 spreads them over the banks).
__device__ __forceinline__ void fill_bwd(float* dst, const float* w,
                                         const Shape& s, int j0, int nu,
                                         int k0, int n) {
  const int K = 4 * s.H;
  n = min(n, K - k0);
  for (int q = threadIdx.x; q < n * s.ncp; q += kThreads) {
    const int u = q / n, r = q % n;
    const bool ok = u < nu;
    ptt::cp_async4(dst + r * s.pitch + u,
                   ok ? w + static_cast<long long>(j0 + u) * K + k0 + r : w,
                   ok);
  }
}

// One step's product for this thread: acc[R][CW] += act[k][0..R) x
// W[k][c0..c0 + CW) over its kk rows of every chunk, chunks from the
// resident slice or, streamed, from the ring (waiting for each chunk,
// refilling the stage freed by the one before).  `q` counts the ring's
// chunks across steps.
template <int R, int CW, class Fill>
__device__ __forceinline__ void step_product(float (&acc)[R][CW],
                                             const float* act, float* wbuf,
                                             const Shape& s, int K, int c0,
                                             int sk, bool live, int& q,
                                             Fill fill) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  for (int ch = 0; ch < s.chunks; ++ch) {
    const float* wc = wbuf;
    if (s.stages) {
      ptt::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk q is in; every thread is past chunk q - 1
      const int next = q + kStages - 1;
      fill(wbuf + (next % kStages) * s.kc * s.pitch,
           (next % s.chunks) * s.kc);
      ptt::cp_async_commit();
      wc = wbuf + (q % kStages) * s.kc * s.pitch;
      ++q;
    }
    if (!live) continue;
    const int k0 = ch * s.kc;
    const int kb = k0 + sk * s.kk;
    const int ke = min(kb + s.kk, K);
    const float* a = act + kb * R;
    const float* b = wc + (kb - k0) * s.pitch + c0;
#pragma unroll 4
    for (int k = kb; k < ke; ++k, a += R, b += s.pitch) {
      float hv[R], wv[CW];
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(a + i);
        hv[i] = v.x;
        hv[i + 1] = v.y;
        hv[i + 2] = v.z;
        hv[i + 3] = v.w;
      }
      if constexpr (CW == 4) {
        const float4 v = *reinterpret_cast<const float4*>(b);
        wv[0] = v.x;
        wv[1] = v.y;
        wv[2] = v.z;
        wv[3] = v.w;
      } else if constexpr (CW == 2) {
        const float2 v = *reinterpret_cast<const float2*>(b);
        wv[0] = v.x;
        wv[1] = v.y;
      } else {
        wv[0] = b[0];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(hv[i], wv[c], acc[i][c]);
    }
  }
}

// The partial sums into red ([sk][R][ncp]).
template <int R, int CW>
__device__ __forceinline__ void put_partials(float* red, const float (&acc)[R][CW],
                                             int ncp, int c0, int sk) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) red[(sk * R + i) * ncp + c0 + c] = acc[i][c];
}

// Column `col` of row i summed over the ks partials, in order.
template <int R>
__device__ __forceinline__ float sum_partials(const float* red, int ks,
                                              int ncp, int i, int col) {
  float v = 0.f;
  for (int sk = 0; sk < ks; ++sk) v += red[(sk * R + i) * ncp + col];
  return v;
}

template <class E>
struct FwdParams {
  const E* x;  // xproj (B, T, 4H), last dim contiguous
  long long sxb, sxt;
  const float* w;     // (H, 4H)
  const float* bias;  // (4H)
  const E* h0;        // (B, H)
  const E* c0;        // (B, H)
  E* hs;              // (B, T, H)
  E* cs;              // (B, T, H)
  E* gates;           // (B, T, 4H)
  Shape s;
};

template <class E, int R>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_kernel(FwdParams<E> p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Shape& s = p.s;
  const int H = s.H, K = H, ub = s.ncp / 4;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / s.cluster) * R;
  const int j0 = rank * s.units;
  const int nu = min(s.units, H - j0);
  const int pairs = nu * R;
  float* act = smem + 4;                   // [2][K][R], after 2 mbarriers
  float* red = act + 2 * K * R;            // [ks][R][ncp]
  float* wbuf = red + s.ks * R * s.ncp;    // [K][pitch] or [stages][kc][pitch]
  const Exchange xch{static_cast<uint32_t>(__cvta_generic_to_shared(smem)),
                     static_cast<uint32_t>((H - nu) * R * 4)};
  const int tid = threadIdx.x;
  const int ncg = s.ncp / 4;
  const int sk = tid / ncg, c0 = (tid % ncg) * 4;
  const bool live = sk < s.ks;
  const long long row = static_cast<long long>(s.T) * H;  // hs/cs row stride
  auto fill = [&](float* dst, int k0) {
    fill_fwd(dst, p.w, s, j0, nu, k0, s.kc);
  };

  // h0 in slot 1 (step 0 reads slot (0 + 1) % 2), slot 0 zero; c0 and
  // the first step's xproj into the pairs' registers; W loading
  for (int idx = tid; idx < K * R; idx += kThreads) {
    const int k = idx / R, b = b0 + idx % R;
    act[idx] = 0.f;
    act[K * R + idx] = b < s.B ? to_f32(p.h0[b * H + k]) : 0.f;
  }
  float cst[kMaxPairs], xv[kMaxPairs][4];
  auto load_x = [&](int t) {
#pragma unroll
    for (int pp = 0; pp < kMaxPairs; ++pp) {
      const int q = tid + pp * kThreads;
      const int b = b0 + q / max(nu, 1), j = j0 + q % max(nu, 1);
      if (q < pairs && b < s.B) {
        const E* xr = p.x + b * p.sxb + t * p.sxt;
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[pp][g] = to_f32(xr[g * H + j]);
      }
    }
  };
#pragma unroll
  for (int pp = 0; pp < kMaxPairs; ++pp) {
    const int q = tid + pp * kThreads;
    const int b = b0 + q / max(nu, 1), j = j0 + q % max(nu, 1);
    cst[pp] = q < pairs && b < s.B ? to_f32(p.c0[b * H + j]) : 0.f;
  }
  load_x(0);
  int q = 0;
  if (s.stages) {
    for (int st = 0; st < kStages - 1; ++st) {
      fill(wbuf + st * s.kc * s.pitch, (st % s.chunks) * s.kc);
      ptt::cp_async_commit();
    }
  } else {
    fill_fwd(wbuf, p.w, s, j0, nu, 0, K);
    ptt::cp_async_commit();
    ptt::cp_async_wait<0>();
  }
  xch.init();
  // every block of the cluster is running and set up (its mbarriers
  // armed) before any peer writes into its shared memory
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < s.T; ++t) {
    if (t > 0) xch.wait((t - 1) & 1, (t - 1) >> 1);  // the peers' h_{t-1}
    const float* h_prev = act + ((t + 1) & 1) * K * R;
    float* h_next = act + (t & 1) * K * R;
    float acc[R][4];
    step_product<R, 4>(acc, h_prev, wbuf, s, K, c0, sk, live, q, fill);
    if (live) put_partials<R, 4>(red, acc, s.ncp, c0, sk);
    __syncthreads();

#pragma unroll
    for (int pp = 0; pp < kMaxPairs; ++pp) {
      const int qq = tid + pp * kThreads;
      if (qq >= pairs) break;
      const int i = qq / nu, u = qq % nu;
      const int b = b0 + i, j = j0 + u;
      if (b >= s.B) continue;
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        pre[g] = (xv[pp][g] + sum_partials<R>(red, s.ks, s.ncp, i, g * ub + u)) +
                 p.bias[g * H + j];
      const float ig = sigmoid(pre[0]);
      const float fg = sigmoid(pre[1]);
      const float cand = tanhf(pre[2]);
      const float og = sigmoid(pre[3]);
      const float c = fg * cst[pp] + ig * cand;
      const float hv = og * tanhf(c);
      cst[pp] = c;
      h_next[j * R + i] = hv;
      const long long at = b * row + static_cast<long long>(t) * H + j;
      put(p.cs + at, c);
      put(p.hs + at, hv);
      E* gout = p.gates + (static_cast<long long>(b) * s.T + t) * 4 * H;
      put(gout + j, ig);
      put(gout + H + j, fg);
      put(gout + 2 * H + j, cand);
      put(gout + 3 * H + j, og);
    }
    __syncthreads();  // the block's h_t is in its own slot
    if (t + 1 < s.T) {  // the last step's h_t goes to no peer
      xch.send(cluster, h_next + j0 * R, nu * R, t & 1);
      load_x(t + 1);
    }
  }
  if (s.stages) ptt::cp_async_wait<0>();  // no copy in flight at exit
  // no block leaves while a peer may still write into its shared memory
  cluster_arrive();
  cluster_wait();
}

template <class E>
struct BwdParams {
  const E* gates;  // (B, T, 4H) activated, from the forward
  const E* cs;     // (B, T, H)
  const E* c0;     // (B, H)
  const float* w;  // (H, 4H)
  const E* dhs;    // (B, T, H) or null (zero)
  const E* dcs;    // (B, T, H) or null (zero)
  float* dgates;   // (B, T, 4H)
  float* dh0;      // (B, H)
  float* dc0;      // (B, H)
  Shape s;
};

template <class E, int R, int CW>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_kernel(BwdParams<E> p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Shape& s = p.s;
  const int H = s.H, K = 4 * H;
  const int rank = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / s.cluster) * R;
  const int j0 = rank * s.units;
  const int nu = min(s.units, H - j0);
  const int pairs = nu * R;
  float* act = smem + 4;  // [slots][4H][R]: dgates, kap = g H + j
  float* red = act + s.slots * K * R;    // [ks][R][ncp]
  float* wbuf = red + s.ks * R * s.ncp;  // [4H][pitch] or the ring
  const Exchange xch{static_cast<uint32_t>(__cvta_generic_to_shared(smem)),
                     static_cast<uint32_t>((H - nu) * 4 * R * 4)};
  const int tid = threadIdx.x;
  const int ncg = s.ncp / CW;
  const int sk = tid / ncg, c0 = (tid % ncg) * CW;
  const bool live = sk < s.ks;
  auto fill = [&](float* dst, int k0) {
    fill_bwd(dst, p.w, s, j0, nu, k0, s.kc);
  };

  for (int idx = tid; idx < s.slots * K * R; idx += kThreads) act[idx] = 0.f;
  // the carry (dh, dc) from step t + 1, and step t's residuals
  float dh[kMaxPairs], dc[kMaxPairs];
  float gi[kMaxPairs], gf[kMaxPairs], gg[kMaxPairs], go[kMaxPairs];
  float ct[kMaxPairs], cp[kMaxPairs], dho[kMaxPairs], dco[kMaxPairs];
  auto load = [&](int t) {
#pragma unroll
    for (int pp = 0; pp < kMaxPairs; ++pp) {
      const int q = tid + pp * kThreads;
      const int b = b0 + q / max(nu, 1), j = j0 + q % max(nu, 1);
      if (q < pairs && b < s.B) {
        const long long bt = static_cast<long long>(b) * s.T + t;
        const E* gr = p.gates + bt * 4 * H;
        gi[pp] = to_f32(gr[j]);
        gf[pp] = to_f32(gr[H + j]);
        gg[pp] = to_f32(gr[2 * H + j]);
        go[pp] = to_f32(gr[3 * H + j]);
        ct[pp] = to_f32(p.cs[bt * H + j]);
        cp[pp] = to_f32(t > 0 ? p.cs[(bt - 1) * H + j] : p.c0[b * H + j]);
        dho[pp] = p.dhs ? to_f32(p.dhs[bt * H + j]) : 0.f;
        dco[pp] = p.dcs ? to_f32(p.dcs[bt * H + j]) : 0.f;
      }
    }
  };
#pragma unroll
  for (int pp = 0; pp < kMaxPairs; ++pp) dh[pp] = dc[pp] = 0.f;
  load(s.T - 1);
  int q = 0;
  if (s.stages) {
    for (int st = 0; st < kStages - 1; ++st) {
      fill(wbuf + st * s.kc * s.pitch, (st % s.chunks) * s.kc);
      ptt::cp_async_commit();
    }
  } else {
    fill_bwd(wbuf, p.w, s, j0, nu, 0, K);
    ptt::cp_async_commit();
    ptt::cp_async_wait<0>();
  }
  xch.init();
  // one slot: a block may write a peer's slot only once every block has
  // read it (arrived after its product), so a cluster barrier spans each
  // step, arrive after the product, wait before the sends; two slots:
  // no barrier a step (Exchange)
  const bool one = s.slots == 1;
  cluster_arrive();
  if (!one) cluster_wait();

  for (int t = s.T - 1; t >= 0; --t) {
    const int slot = one ? 0 : t & 1;
    const int phase = one ? s.T - 1 - t : (s.T - 1 - t) >> 1;
    float* dg = act + slot * K * R;
#pragma unroll
    for (int pp = 0; pp < kMaxPairs; ++pp) {
      const int qq = tid + pp * kThreads;
      if (qq >= pairs) break;
      const int i = qq / nu, u = qq % nu;
      const int b = b0 + i, j = j0 + u;
      if (b >= s.B) continue;
      const float tanh_c = tanhf(ct[pp]);
      const float dhv = dh[pp] + dho[pp];
      const float dcv = (dc[pp] + dco[pp]) + dhv * go[pp] * (1.f - tanh_c * tanh_c);
      const float d[4] = {
          dcv * gg[pp] * gi[pp] * (1.f - gi[pp]),
          dcv * cp[pp] * gf[pp] * (1.f - gf[pp]),
          dcv * gi[pp] * (1.f - gg[pp] * gg[pp]),
          dhv * tanh_c * go[pp] * (1.f - go[pp])};
      float* out = p.dgates + (static_cast<long long>(b) * s.T + t) * K;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        out[g * H + j] = d[g];
        dg[(g * H + j) * R + i] = d[g];
      }
      dc[pp] = dcv * gf[pp];
    }
    __syncthreads();  // the block's dgates_t are in its own slot
    if (one) cluster_wait();  // every block has read the slot
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xch.send(cluster, dg + (g * H + j0) * R, nu * R, slot);
    if (t > 0) load(t - 1);
    xch.wait(slot, phase);  // the peers' dgates_t

    float acc[R][CW];
    step_product<R, CW>(acc, dg, wbuf, s, K, c0, sk, live, q, fill);
    if (live) put_partials<R, CW>(red, acc, s.ncp, c0, sk);
    __syncthreads();
    if (one) cluster_arrive();  // this block has read the slot
#pragma unroll
    for (int pp = 0; pp < kMaxPairs; ++pp) {
      const int qq = tid + pp * kThreads;
      if (qq >= pairs) break;
      dh[pp] = sum_partials<R>(red, s.ks, s.ncp, qq / nu, qq % nu);
    }
  }
  if (one) cluster_wait();
#pragma unroll
  for (int pp = 0; pp < kMaxPairs; ++pp) {
    const int qq = tid + pp * kThreads;
    if (qq >= pairs) break;
    const int b = b0 + qq / nu, j = j0 + qq % nu;
    if (b >= s.B) continue;
    p.dh0[b * H + j] = dh[pp];
    p.dc0[b * H + j] = dc[pp];
  }
  if (s.stages) ptt::cp_async_wait<0>();
  cluster_arrive();
  cluster_wait();
}

// The device's SM count and opt-in shared memory a block.
int device_limits(int* sms, int* smem_limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

Shape shape_of(const Plan& pl, int B, int T, int H) {
  return Shape{B,         T,         H,        pl.cluster, pl.units,
               pl.ncp,    pl.pitch,  pl.ks,    pl.kk,      pl.kc,
               pl.chunks, pl.stages, pl.slots, 0};
}

// Launches `kernel` as pl.tiles clusters of pl.cluster blocks on
// `stream`; info gets {blocks, cluster, tiles, the most clusters of this
// kernel the card holds at once, 1 if W is resident}.  Refused (no
// launch) where the card holds no such cluster.
template <class P>
int launch_clusters(void (*kernel)(P), const P& params, const Plan& pl,
                    int* info, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e == cudaSuccess && pl.cluster > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster * pl.tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  info[0] = pl.cluster * pl.tiles;
  info[1] = pl.cluster;
  info[2] = pl.tiles;
  info[3] = active;
  info[4] = pl.stages == 0;
  e = cudaLaunchKernelEx(&cfg, kernel, params);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <class E>
int lstm_fwd(const E* x, long long sxb, long long sxt, const float* w,
             const float* bias, const E* h0, const E* c0, E* hs, E* cs,
             E* gates, int B, int T, int H, int rows, int cluster, int* info,
             cudaStream_t stream) {
  int sms = 0, smem_limit = 0;
  int e = device_limits(&sms, &smem_limit);
  if (e) return e;
  Plan pl;
  e = make_plan(B, H, sms, 0, smem_limit, rows, cluster, &pl);
  if (e) return e;
  FwdParams<E> p{x, sxb, sxt, w, bias, h0, c0, hs, cs, gates,
                 shape_of(pl, B, T, H)};
  p.s.vec = pl.units % 4 == 0 && pl.cluster * pl.units == H &&
            ptt::aligned16(w);
  return pl.rows == 4
             ? launch_clusters(lstm_fwd_kernel<E, 4>, p, pl, info, stream)
             : launch_clusters(lstm_fwd_kernel<E, 8>, p, pl, info, stream);
}

template <class E>
int lstm_bwd(const E* gates, const E* cs, const E* c0, const float* w,
             const E* dhs, const E* dcs, float* dgates, float* dh0,
             float* dc0, int B, int T, int H, int rows, int cluster, int* info,
             cudaStream_t stream) {
  int sms = 0, smem_limit = 0;
  int e = device_limits(&sms, &smem_limit);
  if (e) return e;
  Plan pl;
  e = make_plan(B, H, sms, 1, smem_limit, rows, cluster, &pl);
  if (e) return e;
  BwdParams<E> p{gates, cs, c0, w, dhs, dcs, dgates, dh0, dc0,
                 shape_of(pl, B, T, H)};
  if (pl.cw == 1)
    return pl.rows == 4
               ? launch_clusters(lstm_bwd_kernel<E, 4, 1>, p, pl, info, stream)
               : launch_clusters(lstm_bwd_kernel<E, 8, 1>, p, pl, info,
                                 stream);
  return pl.rows == 4
             ? launch_clusters(lstm_bwd_kernel<E, 4, 2>, p, pl, info, stream)
             : launch_clusters(lstm_bwd_kernel<E, 8, 2>, p, pl, info, stream);
}

// The earlier design (ptt_lstm_seq_grid_*, reached by name only): one
// cooperative grid, block k owning hidden units [k hb, (k + 1) hb) for
// every batch row, h_{t-1} read back from a float32 (2, B, H) scratch in
// L2 (slot t % 2 holding h_t) in chunks of 32 units staged in shared
// memory beside the matching rows of W (read through the read-only path
// every step), c from a (B, H) scratch, and a grid-wide barrier ending
// every step.  hb = ceil(H / #SMs); a grid that cannot be co-resident is
// refused (cudaErrorCooperativeLaunchTooLarge).
namespace grid {

constexpr int kKC = 32;         // hidden units of h_{t-1} per K chunk
constexpr int kMaxRows = 128;   // batch rows per tile
constexpr int kMaxUnits = 64;   // hidden units per block

template <class E>
struct Params {
  const E* x;  // xproj (B, T, 4H), last dim contiguous
  long long sxb, sxt;
  const float* w;     // (H, 4H)
  const float* bias;  // (4H)
  const E* h0;        // (B, H)
  const E* c0;        // (B, H)
  E* hs;              // (B, T, H)
  E* cs;              // (B, T, H)
  E* gates;           // (B, T, 4H)
  float* hstate;      // (2, B, H): h_t in slot t % 2
  float* cstate;      // (B, H): c_t
  int B, T, H, hb, bt;
};

// Each thread sums an R x CW register tile of the row tile's bt x 4hb
// gate pre-activations: rows r0 .. r0 + R - 1, columns c0 .. c0 + CW - 1
// (thread (ty, tx) of a grid of 4hb / CW columns), so a step of the
// chunk loop loads R values of h and CW of W from shared memory for
// R x CW FMAs.  The chunk is always kKC deep (zero-filled past H), so the
// loop has no runtime bound.  Rows past the tile read the tile's last row
// and are dropped.
template <class E, int R, int CW>
__global__ void __launch_bounds__(kThreads) lstm_seq_kernel(Params<E> p) {
  extern __shared__ float smem[];
  const int H = p.H;
  const int H4 = 4 * H;
  const int hb = p.hb;
  const int nc = 4 * hb;                    // gate columns of this block
  float* h_tile = smem;                     // bt x (kKC + 1)
  float* w_tile = h_tile + p.bt * (kKC + 1);  // kKC x nc
  float* g_tile = w_tile + kKC * nc;        // bt x nc
  const int j0 = blockIdx.x * hb;
  const long long row = static_cast<long long>(p.T) * H;  // hs/cs row stride
  const long long slot = static_cast<long long>(p.B) * H;  // hstate slot
  cg::grid_group grid = cg::this_grid();

  const int ncg = nc / CW;
  const int c0 = (threadIdx.x % ncg) * CW;
  const int r0 = (threadIdx.x / ncg) * R;
  const bool live = r0 < p.bt;
  int h_off[R];
#pragma unroll
  for (int i = 0; i < R; ++i) h_off[i] = min(r0 + i, p.bt - 1) * (kKC + 1);

  // the carry's start, as the TPU kernel's _init: h0 into slot 1 (step
  // 0 reads slot (0 + 1) % 2), c0 into cstate, each block its own units
  for (int q = threadIdx.x; q < p.B * hb; q += kThreads) {
    const int b = q / hb, j = j0 + q % hb;
    if (j >= H) continue;
    p.hstate[slot + b * H + j] = to_f32(p.h0[b * H + j]);
    p.cstate[b * H + j] = to_f32(p.c0[b * H + j]);
  }
  grid.sync();

  for (int t = 0; t < p.T; ++t) {
    const float* h_prev = p.hstate + ((t + 1) % 2) * slot;  // h_{t-1}
    float* h_next = p.hstate + (t % 2) * slot;
    for (int b0 = 0; b0 < p.B; b0 += p.bt) {
      float acc[R][CW];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < H; k0 += kKC) {
        for (int idx = threadIdx.x; idx < p.bt * kKC; idx += kThreads) {
          const int r = idx / kKC, kk = idx % kKC;
          const int b = b0 + r, k = k0 + kk;
          h_tile[r * (kKC + 1) + kk] =
              (b < p.B && k < H) ? __ldcg(h_prev + b * H + k) : 0.f;
        }
        for (int idx = threadIdx.x; idx < kKC * nc; idx += kThreads) {
          const int kk = idx / nc, c = idx % nc;
          const int k = k0 + kk, j = j0 + c % hb;
          w_tile[idx] = (k < H && j < H)
                            ? __ldg(p.w + static_cast<long long>(k) * H4 +
                                    (c / hb) * H + j)
                            : 0.f;
        }
        __syncthreads();
        if (live) {
#pragma unroll 8
          for (int kk = 0; kk < kKC; ++kk) {
            float hv[R], wv[CW];
#pragma unroll
            for (int i = 0; i < R; ++i) hv[i] = h_tile[h_off[i] + kk];
#pragma unroll
            for (int j = 0; j < CW; ++j) wv[j] = w_tile[kk * nc + c0 + j];
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int j = 0; j < CW; ++j)
                acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (r0 + i >= p.bt) break;
#pragma unroll
          for (int j = 0; j < CW; ++j) g_tile[(r0 + i) * nc + c0 + j] = acc[i][j];
        }
      }
      __syncthreads();

      for (int q = threadIdx.x; q < p.bt * hb; q += kThreads) {
        const int r = q / hb, jj = q % hb;
        const int b = b0 + r, j = j0 + jj;
        if (b >= p.B || j >= H) continue;
        const E* xr = p.x + b * p.sxb + t * p.sxt;
        const float* gr = g_tile + r * nc;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g] = (to_f32(xr[g * H + j]) + gr[g * hb + jj]) +
                   p.bias[g * H + j];
        const float i = sigmoid(pre[0]);
        const float f = sigmoid(pre[1]);
        const float cand = tanhf(pre[2]);
        const float o = sigmoid(pre[3]);
        const long long at = b * row + static_cast<long long>(t) * H + j;
        const int bj = b * H + j;
        const float c_prev = __ldcg(p.cstate + bj);
        const float c = f * c_prev + i * cand;
        const float hv = o * tanhf(c);
        p.cstate[bj] = c;
        h_next[bj] = hv;
        put(p.cs + at, c);
        put(p.hs + at, hv);
        E* gout = p.gates + (static_cast<long long>(b) * p.T + t) * H4;
        put(gout + j, i);
        put(gout + H + j, f);
        put(gout + 2 * H + j, cand);
        put(gout + 3 * H + j, o);
      }
      __syncthreads();  // g_tile is rewritten by the next row tile
    }
    grid.sync();  // h_t of every unit is in hstate before step t + 1 reads it
  }
}

template <class E>
using Kernel = void (*)(Params<E>);

// The register tiles, smallest first: R x CW sums a thread.  CW divides
// 4hb (a multiple of 4).
template <class E>
struct Tiling {
  int r, cw;
  Kernel<E> kernel;
};

// The smallest tiling whose thread grid, (4hb / CW) x ceil(bt / R),
// fits one block; null if none does.
template <class E>
const Tiling<E>* tiling_for(int bt, int nc) {
  static const Tiling<E> tilings[] = {
      {1, 1, lstm_seq_kernel<E, 1, 1>}, {1, 2, lstm_seq_kernel<E, 1, 2>},
      {2, 2, lstm_seq_kernel<E, 2, 2>}, {2, 4, lstm_seq_kernel<E, 2, 4>},
      {4, 4, lstm_seq_kernel<E, 4, 4>},
  };
  for (const Tiling<E>& t : tilings)
    if ((nc / t.cw) * ((bt + t.r - 1) / t.r) <= kThreads) return &t;
  return nullptr;
}

// Launches the cooperative kernel on `stream` and writes its block count
// to *grid_blocks; returns the launch's error (cudaSuccess is 0).
template <class E>
int lstm_seq(const E* x, long long sxb, long long sxt, const float* w,
             const float* bias, const E* h0, const E* c0, E* hs, E* cs,
             E* gates, float* hstate, float* cstate, int B, int T, int H,
             int* grid_blocks, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int hb = (H + sms - 1) / sms;
  if (hb > kMaxUnits) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (H + hb - 1) / hb;
  const int nc = 4 * hb;
  // rows per tile: at most kMaxRows and what the largest register tiling
  // (4 x 4) covers in one block, the row tiles of B balanced
  const int cap = min(kMaxRows, 4 * (kThreads / (nc / 4)));
  const int tiles = (B + cap - 1) / cap;
  const int bt = (B + tiles - 1) / tiles;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(bt) * (kKC + 1) +
                       static_cast<size_t>(kKC) * nc +
                       static_cast<size_t>(bt) * nc);
  const Tiling<E>* tiling = tiling_for<E>(bt, nc);
  if (tiling == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel<E> kernel = tiling->kernel;
  // above 48 KB only as opted-in dynamic shared memory (up to 51 KB here)
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm * sms < blocks)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *grid_blocks = blocks;
  Params<E> p{x,     sxb,    sxt, w, bias, h0, c0, hs, cs,
              gates, hstate, cstate, B, T, H, hb, bt};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(blocks), dim3(kThreads), args, smem,
                                  stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace grid

}  // namespace

// The plan make_plan computes, as 14 ints in Plan's field order (rows,
// cluster, units, tiles, cw, ncp, pitch, ks, kk, kc, chunks, stages,
// smem, slots); 0 or cudaErrorInvalidValue.  kernels/lstm.py:plan
// mirrors it.
PTT_EXPORT int ptt_lstm_plan(int B, int H, int sms, int backward,
                             int smem_limit, int rows, int cluster,
                             int* out) {
  Plan pl;
  const int e = make_plan(B, H, sms, backward, smem_limit, rows, cluster,
                          &pl);
  if (e) return e;
  const int fields[kPlanFields] = {
      pl.rows, pl.cluster, pl.units, pl.tiles,  pl.cw,     pl.ncp,  pl.pitch,
      pl.ks,   pl.kk,      pl.kc,    pl.chunks, pl.stages, pl.smem, pl.slots};
  for (int i = 0; i < kPlanFields; ++i) out[i] = fields[i];
  return 0;
}

// Forward: xproj (B, T, 4H) through its batch and time strides, W (H, 4H)
// and bias (4H) float32, h0 and c0 (B, H); hs, cs (B, T, H) and gates
// (B, T, 4H) contiguous.  Backward: the forward's gates and cs, c0, W,
// the cotangents dhs and dcs (B, T, H; null for zero); dgates (B, T, 4H),
// dh0 and dc0 (B, H) float32.  rows and cluster 0 take the plan's; info
// gets 5 ints (see launch_clusters).  The _f32 entries take float32
// sequence tensors, the _bf16 entries bf16 ones.  The _grid entries are
// the earlier cooperative forward (hstate (2, B, H), cstate (B, H)
// float32 scratch; its block count into *grid_blocks).
#define PTT_LSTM_ENTRIES(SUFFIX, E)                                           \
  PTT_EXPORT int ptt_lstm_seq_##SUFFIX(                                       \
      const E* x, long long sxb, long long sxt, const float* w,               \
      const float* bias, const E* h0, const E* c0, E* hs, E* cs, E* gates,    \
      int B, int T, int H, int rows, int cluster, int* info,                  \
      cudaStream_t stream) {                                                  \
    return lstm_fwd<E>(x, sxb, sxt, w, bias, h0, c0, hs, cs, gates, B, T, H,  \
                       rows, cluster, info, stream);                          \
  }                                                                           \
  PTT_EXPORT int ptt_lstm_seq_bwd_##SUFFIX(                                   \
      const E* gates, const E* cs, const E* c0, const float* w, const E* dhs, \
      const E* dcs, float* dgates, float* dh0, float* dc0, int B, int T,      \
      int H, int rows, int cluster, int* info, cudaStream_t stream) {         \
    return lstm_bwd<E>(gates, cs, c0, w, dhs, dcs, dgates, dh0, dc0, B, T, H, \
                       rows, cluster, info, stream);                          \
  }                                                                           \
  PTT_EXPORT int ptt_lstm_seq_grid_##SUFFIX(                                  \
      const E* x, long long sxb, long long sxt, const float* w,               \
      const float* bias, const E* h0, const E* c0, E* hs, E* cs, E* gates,    \
      float* hstate, float* cstate, int B, int T, int H, int* grid_blocks,    \
      cudaStream_t stream) {                                                  \
    return grid::lstm_seq<E>(x, sxb, sxt, w, bias, h0, c0, hs, cs, gates,     \
                             hstate, cstate, B, T, H, grid_blocks, stream);   \
  }

PTT_LSTM_ENTRIES(f32, float)
PTT_LSTM_ENTRIES(bf16, bf16)
