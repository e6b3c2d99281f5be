// Whole-sequence LSTM forward in one launch per sequence: a persistent
// cooperative kernel that walks the T steps with a grid-wide barrier
// between them.  Two instances, by the element type of xproj, h0, c0 and
// the outputs: float32, and bf16 (AMP: the TPU kernel on bf16 xproj, h0
// and c0 with the float32 master W and bias).  Both carry h and c in
// float32 across the steps, take h W with float32 sums, and round only
// what they write (hs, cs and the gates), as pallas/lstm.py:41-65 does.
//
// Replaces the TPU kernel paddle_tpu/pallas/lstm.py:112 _lstm_seq_impl:
// _lstm_kernel (:35, grid (T,), pallas_call :148) and its VMEM tiling
// _lstm_kernel_blocked (:94, grid (B/bb, T), pallas_call :122), both
// running _lstm_step_body (:48) for every t:
//   gates = xproj_t + h_{t-1} W + bias      (gate order i, f, cand, o)
//   i, f, o = sigmoid(.), g = tanh(.)
//   c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
// and writing hs, cs and the activated gates.  The TPU kernel keeps W and
// (h, c) resident in one core's VMEM across the sequential grid.  Here
// the recurrence is spread over the SMs: block k owns the hidden units
// [k hb, (k + 1) hb) and computes their four gate columns j, H + j,
// 2H + j, 3H + j for every batch row, so the cell update of its units is
// local to the block.  Every step needs all of h_{t-1}: each block reads
// it from a float32 (2, B, H) scratch, slot t % 2 holding h_t (written by
// every block before the barrier, read through L2 with ld.cg; two slots,
// so a block that starts step t + 1 never overwrites what a slower block
// still reads of step t), in tiles of BT rows x 32 hidden units staged in
// shared memory beside the matching 32 x 4hb slice of W (read through
// the read-only path; W stays in L2, 26 MB at H 1280).  c_{t-1} of a unit
// is read back from a float32 (B, H) scratch by the thread that wrote it.
// The scratch is the TPU kernel's VMEM carry (h_s, c_s); it keeps the
// bf16 instance's recurrence in float32 where hs and cs are rounded.  The blocked TPU
// variant is only another VMEM tiling of the same function; this one
// kernel takes any B and H.
//
// xproj is read through its batch and time strides (the op's (B, T, 4H)
// view of the input projection); hs and cs are written as contiguous
// (B, T, H), the op's layout, and the gates as contiguous (B, T, 4H).
//
// What bounds it on the H100: operations, 2 T B H 4H FLOPs (0.050 ms at
// T 100, B 64, H 256 on 67 TFLOP/s f32), but T dependent steps, each
// ending in a grid-wide barrier, set a latency floor that bound does not
// count.  The grid is ceil(H / hb) blocks with hb = ceil(H / #SMs), one
// per SM at most; a grid that cannot be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge), never run.  This is a simple
// SIMT kernel: fmaf on register tiles of up to 4 x 4 sums a thread, fed
// from shared memory; keeping the W slice in shared memory across steps
// and fewer barriers are later work.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
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

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

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

}  // namespace

// xproj (B, T, 4H) through its batch and time strides, W (H, 4H) and bias
// (4H) float32, h0 and c0 (B, H); hs, cs (B, T, H) and gates (B, T, 4H)
// contiguous; hstate (2, B, H) and cstate (B, H) float32 scratch.  The
// _f32 entry takes float32 xproj, h0, c0 and outputs, the _bf16 entry
// bf16 ones.
#define PTT_LSTM_ENTRY(SUFFIX, E)                                            \
  PTT_EXPORT int ptt_lstm_seq_##SUFFIX(                                      \
      const E* x, long long sxb, long long sxt, const float* w,              \
      const float* bias, const E* h0, const E* c0, E* hs, E* cs, E* gates,   \
      float* hstate, float* cstate, int B, int T, int H, int* grid_blocks,   \
      cudaStream_t stream) {                                                 \
    return lstm_seq<E>(x, sxb, sxt, w, bias, h0, c0, hs, cs, gates, hstate,  \
                       cstate, B, T, H, grid_blocks, stream);                \
  }

PTT_LSTM_ENTRY(f32, float)
PTT_LSTM_ENTRY(bf16, bf16)
