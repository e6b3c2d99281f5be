// Training batch norm over a channel-minor (R, C) view (R = N*H*W rows of
// an NHWC tensor), forward and backward, in float32 and in bf16: bf16 x,
// dy, y and dx, float32 statistics, sums, dgamma and dbeta.
//
// Replaces the TPU kernels paddle_tpu/pallas/batch_norm.py:124
// _bn_fwd_impl (_bn_fwd_kernel :92) and :197 _bn_bwd_impl
// (_bn_bwd_kernel :160).  Each is one pallas_call with a two-phase
// sequential grid: phase 0 streams row blocks into a per-channel VMEM
// accumulator, phase 1 streams them again and writes the result.  On
// Hopper the blocks run in parallel and in no order, so each direction is
// two launches on one stream:
//   1. statistics: block (channel tile, row chunk) sums its rows and
//      writes one f32 partial per channel and chunk (forward: sum x and
//      sum x^2; backward: sum dy and sum dy * xhat).  It then takes a
//      ticket on its chunk group's counter; the group's last block adds
//      the group's partials in a fixed order in double and takes a ticket
//      on the tile's counter; the tile's last block adds the groups' sums
//      in a fixed order in double and writes (forward)
//      mean, biased variance E[x^2] - m^2 (as the TPU kernel and the JAX
//      op compute it, cancellation included) and the affine folded into
//      y = x * a + b, for bf16 with a and b rounded to bf16 values as the
//      JAX op rounds them (paddle_tpu/ops/nn_ops.py:464-472); (backward)
//      dbeta, dgamma and the three dx coefficients.  Each counter goes
//      back to 0 for the next call on the stream.
//   2. the elementwise pass over the same tiles: y = x * a + b, or
//      dx = gamma * inv * (dy - dbeta / R - xhat * dgamma / R).
// No value is summed by an atomic: the result is the same bit for bit
// from run to run.
//
// What bounds it on the H100: bytes.  The bound counts each input once
// and each output once (forward 2 passes of R x C, backward 3), but x
// cannot stay on the chip between the two launches (up to 822 MB), so
// the forward moves 3 passes (x, x, y) and the backward 5 (x, dy, x, dy,
// dx): at 3.35 TB/s at most 67% and 60% of the bound, more only where
// the second read hits the 50 MB L2.  The design:
//   - 16-byte accesses (route "vector"): a thread loads and stores 4 f32
//     or 8 bf16 channels of a row; a tile is L <= 32 such lanes (128 f32
//     or 256 bf16 channels), the block's 256 threads 256 / L row lanes,
//     so a warp covers at least 512 contiguous bytes (at C 64 f32, two
//     rows).  Each thread issues its loads for 4 rows (2 rows of x and dy
//     in the backward) before it adds: 64 bytes in flight a thread, 16 KB
//     a block.  A cp.async.bulk ring fed by a producer warp would keep as
//     much in flight, but the loads here are used once, straight from
//     registers; plain unrolled loads need no barrier and no shared
//     memory, so they were chosen.  Where C is not a multiple of the
//     vector or a pointer is not 16-byte aligned, the call takes the same
//     kernels with one channel a thread (route "scalar"): a dispatch by
//     shape and address (kernels/batch_norm.py:route), checked here.
//   - the finalize folded into the statistics launch (the tickets above):
//     two launches a call, down from three.  One block reading every
//     chunk's partials of a 256-channel tile would read up to 1 MB alone
//     (about 10 us from L2 into one SM); in groups of gc ~ sqrt(2 P)
//     chunks each level reads at most ~70 KB.
//   - an elementwise pass that reads from L2: it walks the chunks in the
//     reverse of the statistics pass's order and each chunk's rows from
//     its end, so the tail that the statistics pass read last, still in
//     L2, is read first; it writes y and dx with streaming stores
//     (st.global.cs), so they do not evict what is about to be read.
//   - the grid is one wave: 4 blocks an SM (kMinBlocks: at most 64
//     registers a thread), chunks of at least 8 rows a thread
//     (kernels/batch_norm.py:plan).
// The earlier three-launch design (32 channels x 8 row lanes, one scalar
// a thread, a finalize launch) stays as route "three-pass", reached only
// by that explicit argument of the C entries.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The routes of the C entries (kernels/batch_norm.py:ROUTES).
constexpr int kScalar = 0;
constexpr int kVector = 1;
constexpr int kThreePass = 2;

// ---------------------------------------------------------------------------
// the earlier three-launch design (route kThreePass)
// ---------------------------------------------------------------------------

namespace three_pass {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kTX = 32;  // channels per block
constexpr int kTY = 8;   // row lanes per block

// Block-wide sum over the row lanes of (s, q) for this thread's channel,
// written as chunk p's partials (ps[p * C + c], pq[p * C + c]).
__device__ __forceinline__ void write_partials(float s, float q, float* ps,
                                               float* pq, int c, int C,
                                               int p) {
  __shared__ float sh[2][kTY][kTX];
  sh[0][threadIdx.y][threadIdx.x] = s;
  sh[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < kTY; ++i) {
      a += sh[0][i][threadIdx.x];
      b += sh[1][i][threadIdx.x];
    }
    ps[static_cast<long long>(p) * C + c] = a;
    pq[static_cast<long long>(p) * C + c] = b;
  }
}

template <class T>
__global__ void __launch_bounds__(kTX* kTY)
    bn_fwd_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                          int R, int C, int P, int chunk) {
  const int c = blockIdx.x * kTX + threadIdx.x;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(r0 + chunk, R);
  float s = 0.f, q = 0.f;
  if (c < C) {
    for (int r = r0 + threadIdx.y; r < r1; r += kTY) {
      const float v = to_f32(x[static_cast<long long>(r) * C + c]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  write_partials(s, q, part, part + static_cast<long long>(P) * C, c, C,
                 blockIdx.y);
}

__global__ void bn_fwd_finalize_kernel(const float* __restrict__ part,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       float* __restrict__ mean,
                                       float* __restrict__ var,
                                       float* __restrict__ ab, int R, int C,
                                       int P, float eps, int round_ab) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double s = 0.0, q = 0.0;
  for (int p = 0; p < P; ++p) {
    s += part[static_cast<long long>(p) * C + c];
    q += part[static_cast<long long>(P + p) * C + c];
  }
  const float m = static_cast<float>(s / R);
  const float v = static_cast<float>(q / R - (s / R) * (s / R));
  const float a = gamma[c] * rsqrtf(v + eps);
  const float b = beta[c] - m * a;
  mean[c] = m;
  var[c] = v;
  ab[c] = round_ab ? round_bf16(a) : a;
  ab[C + c] = round_ab ? round_bf16(b) : b;
}

template <class T>
__global__ void __launch_bounds__(kTX* kTY)
    bn_fwd_normalize_kernel(const T* __restrict__ x,
                            const float* __restrict__ ab, T* __restrict__ y,
                            int R, int C, int chunk) {
  const int c = blockIdx.x * kTX + threadIdx.x;
  if (c >= C) return;
  const float a = ab[c];
  const float b = ab[C + c];
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(r0 + chunk, R);
  for (int r = r0 + threadIdx.y; r < r1; r += kTY) {
    const long long i = static_cast<long long>(r) * C + c;
    put(y + i, fmaf(to_f32(x[i]), a, b));
  }
}

template <class T>
__global__ void __launch_bounds__(kTX* kTY)
    bn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ mean,
                          const float* __restrict__ inv,
                          float* __restrict__ part, int R, int C, int P,
                          int chunk) {
  const int c = blockIdx.x * kTX + threadIdx.x;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(r0 + chunk, R);
  float s = 0.f, q = 0.f;
  if (c < C) {
    const float m = mean[c];
    const float iv = inv[c];
    for (int r = r0 + threadIdx.y; r < r1; r += kTY) {
      const long long i = static_cast<long long>(r) * C + c;
      const float d = to_f32(dy[i]);
      s += d;
      q = fmaf(d, (to_f32(x[i]) - m) * iv, q);
    }
  }
  write_partials(s, q, part, part + static_cast<long long>(P) * C, c, C,
                 blockIdx.y);
}

__global__ void bn_bwd_finalize_kernel(const float* __restrict__ part,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ inv,
                                       float* __restrict__ dgamma,
                                       float* __restrict__ dbeta,
                                       float* __restrict__ coef, int R, int C,
                                       int P) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double s = 0.0, q = 0.0;
  for (int p = 0; p < P; ++p) {
    s += part[static_cast<long long>(p) * C + c];
    q += part[static_cast<long long>(P + p) * C + c];
  }
  const float db = static_cast<float>(s);
  const float dg = static_cast<float>(q);
  const float inv_r = 1.0f / static_cast<float>(R);
  dbeta[c] = db;
  dgamma[c] = dg;
  coef[c] = gamma[c] * inv[c];
  coef[C + c] = db * inv_r;
  coef[2 * C + c] = dg * inv_r;
}

template <class T>
__global__ void __launch_bounds__(kTX* kTY)
    bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const float* __restrict__ coef, T* __restrict__ dx, int R,
                     int C, int chunk) {
  const int c = blockIdx.x * kTX + threadIdx.x;
  if (c >= C) return;
  const float m = mean[c];
  const float iv = inv[c];
  const float k1 = coef[c];
  const float k2 = coef[C + c];
  const float k3 = coef[2 * C + c];
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(r0 + chunk, R);
  for (int r = r0 + threadIdx.y; r < r1; r += kTY) {
    const long long i = static_cast<long long>(r) * C + c;
    const float xhat = (to_f32(x[i]) - m) * iv;
    put(dx + i, k1 * (to_f32(dy[i]) - k2 - xhat * k3));
  }
}

template <class T>
int launch_fwd(const T* x, const float* gamma, const float* beta, T* y,
               float* mean, float* var, float* part, float* ab, int R, int C,
               int P, int chunk, float eps, cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((C + kTX - 1) / kTX, P);
  bn_fwd_partial_kernel<<<grid, block, 0, stream>>>(x, part, R, C, P, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_fwd_finalize_kernel<<<(C + 255) / 256, 256, 0, stream>>>(
      part, gamma, beta, mean, var, ab, R, C, P, eps,
      std::is_same<T, bf16>::value);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_fwd_normalize_kernel<<<grid, block, 0, stream>>>(x, ab, y, R, C, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_bwd(const T* x, const T* dy, const float* gamma, const float* mean,
               const float* inv, T* dx, float* dgamma, float* dbeta,
               float* part, float* coef, int R, int C, int P, int chunk,
               cudaStream_t stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((C + kTX - 1) / kTX, P);
  bn_bwd_partial_kernel<<<grid, block, 0, stream>>>(x, dy, mean, inv, part, R,
                                                    C, P, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_bwd_finalize_kernel<<<(C + 255) / 256, 256, 0, stream>>>(
      part, gamma, inv, dgamma, dbeta, coef, R, C, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_bwd_dx_kernel<<<grid, block, 0, stream>>>(x, dy, mean, inv, coef, dx, R,
                                               C, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace three_pass

// ---------------------------------------------------------------------------
// the two-launch design (routes kScalar and kVector)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;  // 16-byte lanes of a channel tile

// V channels of one row as one access: 16 bytes (4 f32, 8 bf16) on the
// vector route, one element on the scalar route.
template <class T, int V>
struct Io;

template <>
struct Io<float, 4> {
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static Raw pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<bf16, 8> {
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static Raw pack(const float (&v)[8]) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

template <>
struct Io<float, 1> {
  using Raw = float;
  __device__ static void unpack(const Raw& r, float (&v)[1]) { v[0] = r; }
  __device__ static Raw pack(const float (&v)[1]) { return v[0]; }
};

template <>
struct Io<bf16, 1> {
  using Raw = unsigned short;
  __device__ static void unpack(const Raw& r, float (&v)[1]) {
    v[0] = __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ static Raw pack(const float (&v)[1]) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  }
};

template <class T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  using I = Io<T, V>;
  I::unpack(*reinterpret_cast<const typename I::Raw*>(p), v);
}

// The elementwise pass's loads, the last read of x and dy: default cache
// policy.  Evict-first loads (ld.global.cs) were 1-3% slower
// (scripts/bn_variants.py, variant evict_first).
template <class T, int V>
__device__ __forceinline__ void load_last(const T* p, float (&v)[V]) {
  load<T, V>(p, v);
}

// streaming store: y and dx are not read again by this call
template <class T, int V>
__device__ __forceinline__ void store_cs(T* p, const float (&v)[V]) {
  using I = Io<T, V>;
  __stcs(reinterpret_cast<typename I::Raw*>(p), I::pack(v));
}

// V consecutive values of the call's scratch (float partials, double
// group sums) as doubles, from L2: other blocks wrote them in this
// launch.  Volatile asm, so that the compiler keeps the loads after the
// ticket's fence (the __ldcg intrinsic is not volatile).
template <int V>
__device__ __forceinline__ void load_cg(const float* p, double (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      float a, b, c, d;
      asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(a), "=f"(b), "=f"(c), "=f"(d)
                   : "l"(p + 4 * i)
                   : "memory");
      v[4 * i] = a;
      v[4 * i + 1] = b;
      v[4 * i + 2] = c;
      v[4 * i + 3] = d;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float a;
      asm volatile("ld.global.cg.f32 %0, [%1];"
                   : "=f"(a)
                   : "l"(p + i)
                   : "memory");
      v[i] = a;
    }
  }
}

template <int V>
__device__ __forceinline__ void load_cg(const double* p, double (&v)[V]) {
  if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      asm volatile("ld.global.cg.v2.f64 {%0, %1}, [%2];"
                   : "=d"(v[2 * i]), "=d"(v[2 * i + 1])
                   : "l"(p + 2 * i)
                   : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      asm volatile("ld.global.cg.f64 %0, [%1];"
                   : "=d"(v[i])
                   : "l"(p + i)
                   : "memory");
  }
}

// A block's place in the plan: lane = 2^lg channel lanes of V channels,
// the rest row lanes; the row chunk [r0, r1).
struct Place {
  int lanes, rows_step, lane, row_lane, cv, r0, r1;
};

__device__ __forceinline__ Place place(int lg, int R, int chunk, int p) {
  Place s;
  s.lanes = 1 << lg;
  s.rows_step = kThreads >> lg;
  s.lane = threadIdx.x & (s.lanes - 1);
  s.row_lane = threadIdx.x >> lg;
  s.cv = blockIdx.x * s.lanes + s.lane;
  s.r0 = p * chunk;
  s.r1 = min(s.r0 + chunk, R);
  return s;
}

// Sums (s, q) of every thread over the block's row lanes in a fixed order
// (a butterfly over the row lanes of a warp, then the warps in order);
// block_sum_value reads the result.  `sh` holds kWarps * 2 * kMaxLanes *
// V Acc.
template <class Acc, int V>
__device__ __forceinline__ void block_sum(Acc (&s)[V], Acc (&q)[V], int lg,
                                          Acc* sh) {
  const int lanes = 1 << lg;
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], o);
    }
  }
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  constexpr int kQ = kMaxLanes * V;  // one quantity of one warp
  if (wl < lanes) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sh[(2 * warp) * kQ + wl * V + j] = s[j];
      sh[(2 * warp + 1) * kQ + wl * V + j] = q[j];
    }
  }
  __syncthreads();
}

// Value i (quantity i / n, tile channel i % n) of block_sum's result.
template <class Acc, int V>
__device__ __forceinline__ Acc block_sum_value(const Acc* sh, int i, int n) {
  constexpr int kQ = kMaxLanes * V;
  const int k = i / n, cc = i - k * n;
  Acc a = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) a += sh[(2 * w + k) * kQ + cc];
  return a;
}

// Writes the block's float partials of (s, q) for chunk p: part[k][p][c],
// k = 0 for s, 1 for q.
template <int V>
__device__ __forceinline__ void write_partials(float (&s)[V], float (&q)[V],
                                               float* part, int C, int P,
                                               int p, int lg, double* shd) {
  float* sh = reinterpret_cast<float*>(shd);
  block_sum<float, V>(s, q, lg, sh);
  const int n = (1 << lg) * V;
  const int c0 = blockIdx.x * n;
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
    const int k = i / n, c = c0 + i - k * n;
    if (c < C)
      part[(static_cast<long long>(k) * P + p) * C + c] =
          block_sum_value<float, V>(sh, i, n);
  }
}

// A ticket on `counter` once every thread's stores are done: true in the
// last of n blocks to take one, which then sees all of their stores.
__device__ __forceinline__ bool ticket(unsigned* counter, unsigned n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == n - 1u;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// (S, Q) of tile channel threadIdx.x (< lanes * V): rows [p0, p1) of the
// (2, rows, C) scratch `src` (float partials or double group sums) added
// in double, row p by row lane (p - p0) % rows_step in order of p, then
// the row lanes by block_sum.
template <class Src, int V>
__device__ __forceinline__ void sum_rows(const Src* src, long long rows,
                                         int p0, int p1, int C, int lg,
                                         double* shd, double& S, double& Q) {
  const Place s = place(lg, 0, 0, 0);
  double ds[V], dq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) ds[j] = dq[j] = 0.0;
  if (s.cv * V < C) {
    const Src* a = src + s.cv * V;
    const Src* b = a + rows * C;
#pragma unroll 4
    for (int p = p0 + s.row_lane; p < p1; p += s.rows_step) {
      double va[V], vb[V];
      load_cg<V>(a + static_cast<long long>(p) * C, va);
      load_cg<V>(b + static_cast<long long>(p) * C, vb);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ds[j] += va[j];
        dq[j] += vb[j];
      }
    }
  }
  __syncthreads();  // the shared buffer's last values have been read
  block_sum<double, V>(ds, dq, lg, shd);
  const int n = s.lanes * V;
  if (threadIdx.x < n) {
    S = block_sum_value<double, V>(shd, threadIdx.x, n);
    Q = block_sum_value<double, V>(shd, n + threadIdx.x, n);
  }
}

// After the block's partials: the fixed-order sum in two levels.  The
// chunks form groups of gc; the last block of a group to finish adds the
// group's partials in double (gsum[k][g][c] where there is more than one
// group); the last of the tile's groups adds the group sums and returns
// true with (S, Q) of tile channel threadIdx.x.  Each level reads at most
// max(gc, groups) rows, not P (kernels/batch_norm.py:plan).  Counters
// (one per group, one per tile: [tile][0] and [tile][1 + g]) go back to
// 0 in the block that finishes with them.
template <int V>
__device__ __forceinline__ bool finish_sums(const float* part, double* gsum,
                                            unsigned* counter, int C, int P,
                                            int p, int gc, int lg,
                                            double* shd, double& S,
                                            double& Q) {
  const int G = (P + gc - 1) / gc;
  const int g = p / gc;
  const int p0 = g * gc, p1 = min(p0 + gc, P);
  unsigned* tile = counter + blockIdx.x * (G + 1);
  if (!ticket(tile + 1 + g, p1 - p0)) return false;
  sum_rows<float, V>(part, P, p0, p1, C, lg, shd, S, Q);
  if (threadIdx.x == 0) tile[1 + g] = 0u;
  if (G == 1) return true;
  const int n = (1 << lg) * V;
  const int c = blockIdx.x * n + threadIdx.x;
  if (threadIdx.x < n && c < C) {
    gsum[static_cast<long long>(g) * C + c] = S;
    gsum[static_cast<long long>(G + g) * C + c] = Q;
  }
  if (!ticket(tile, G)) return false;
  sum_rows<double, V>(gsum, G, 0, G, C, lg, shd, S, Q);
  if (threadIdx.x == 0) tile[0] = 0u;
  return true;
}

template <class T, int V, int U>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_fwd_stats_kernel(const T* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        float* __restrict__ part, double* __restrict__ gsum,
                        float* __restrict__ mean, float* __restrict__ var,
                        float* __restrict__ ab, unsigned* __restrict__ counter,
                        int R, int C, int P, int chunk, int gc, int lg,
                        float eps) {
  __shared__ double shd[kWarps * 2 * kMaxLanes * V];
  const Place s = place(lg, R, chunk, blockIdx.y);
  float sx[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sx[j] = sq[j] = 0.f;
  if (s.cv * V < C) {
    const T* base = x + s.cv * V;
    int r = s.r0 + s.row_lane;
    for (; r + (U - 1) * s.rows_step < s.r1; r += U * s.rows_step) {
      float v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load<T, V>(base + static_cast<long long>(r + u * s.rows_step) * C,
                   v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sx[j] += v[u][j];
          sq[j] = fmaf(v[u][j], v[u][j], sq[j]);
        }
    }
    for (; r < s.r1; r += s.rows_step) {
      float v[V];
      load<T, V>(base + static_cast<long long>(r) * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sx[j] += v[j];
        sq[j] = fmaf(v[j], v[j], sq[j]);
      }
    }
  }
  write_partials<V>(sx, sq, part, C, P, blockIdx.y, lg, shd);
  double S = 0.0, Q = 0.0;
  if (!finish_sums<V>(part, gsum, counter, C, P, blockIdx.y, gc, lg, shd, S,
                      Q))
    return;
  const int c = blockIdx.x * s.lanes * V + threadIdx.x;
  if (threadIdx.x < s.lanes * V && c < C) {
    const float m = static_cast<float>(S / R);
    const float v = static_cast<float>(Q / R - (S / R) * (S / R));
    const float a = gamma[c] * rsqrtf(v + eps);
    const float b = beta[c] - m * a;
    constexpr bool kRound = std::is_same<T, bf16>::value;
    mean[c] = m;
    var[c] = v;
    ab[c] = kRound ? round_bf16(a) : a;
    ab[C + c] = kRound ? round_bf16(b) : b;
  }
}

template <class T, int V, int U>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ ab,
                        T* __restrict__ y, int R, int C, int P, int chunk,
                        int lg) {
  const Place s = place(lg, R, chunk, P - 1 - blockIdx.y);
  if (s.cv * V >= C) return;
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = ab[s.cv * V + j];
    b[j] = ab[C + s.cv * V + j];
  }
  const long long off = s.cv * V;
  const int n = s.r1 - s.r0;
  int k = s.row_lane;
  for (; k + (U - 1) * s.rows_step < n; k += U * s.rows_step) {
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_last<T, V>(
          x + static_cast<long long>(s.r1 - 1 - k - u * s.rows_step) * C +
              off,
          v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[u][j] = fmaf(v[u][j], a[j], b[j]);
      store_cs<T, V>(
          y + static_cast<long long>(s.r1 - 1 - k - u * s.rows_step) * C + off,
          v[u]);
    }
  }
  for (; k < n; k += s.rows_step) {
    const long long i = static_cast<long long>(s.r1 - 1 - k) * C + off;
    float v[V];
    load_last<T, V>(x + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = fmaf(v[j], a[j], b[j]);
    store_cs<T, V>(y + i, v);
  }
}

template <class T, int V, int U>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ gamma,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        float* __restrict__ part, double* __restrict__ gsum,
                        float* __restrict__ dgamma, float* __restrict__ dbeta,
                        float* __restrict__ coef,
                        unsigned* __restrict__ counter, int R, int C, int P,
                        int chunk, int gc, int lg) {
  __shared__ double shd[kWarps * 2 * kMaxLanes * V];
  const Place s = place(lg, R, chunk, blockIdx.y);
  float sd[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sd[j] = sq[j] = 0.f;
  if (s.cv * V < C) {
    float m[V], iv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = mean[s.cv * V + j];
      iv[j] = inv[s.cv * V + j];
    }
    const long long off = s.cv * V;
    int r = s.r0 + s.row_lane;
    for (; r + (U - 1) * s.rows_step < s.r1; r += U * s.rows_step) {
      float vx[U][V], vd[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i =
            static_cast<long long>(r + u * s.rows_step) * C + off;
        load<T, V>(x + i, vx[u]);
        load<T, V>(dy + i, vd[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sd[j] += vd[u][j];
          sq[j] = fmaf(vd[u][j], (vx[u][j] - m[j]) * iv[j], sq[j]);
        }
    }
    for (; r < s.r1; r += s.rows_step) {
      const long long i = static_cast<long long>(r) * C + off;
      float vx[V], vd[V];
      load<T, V>(x + i, vx);
      load<T, V>(dy + i, vd);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sd[j] += vd[j];
        sq[j] = fmaf(vd[j], (vx[j] - m[j]) * iv[j], sq[j]);
      }
    }
  }
  write_partials<V>(sd, sq, part, C, P, blockIdx.y, lg, shd);
  double S = 0.0, Q = 0.0;
  if (!finish_sums<V>(part, gsum, counter, C, P, blockIdx.y, gc, lg, shd, S,
                      Q))
    return;
  const int c = blockIdx.x * s.lanes * V + threadIdx.x;
  if (threadIdx.x < s.lanes * V && c < C) {
    const float db = static_cast<float>(S);
    const float dg = static_cast<float>(Q);
    const float inv_r = 1.0f / static_cast<float>(R);
    dbeta[c] = db;
    dgamma[c] = dg;
    coef[c] = gamma[c] * inv[c];
    coef[C + c] = db * inv_r;
    coef[2 * C + c] = dg * inv_r;
  }
}

template <class T, int V, int U>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const float* __restrict__ coef, T* __restrict__ dx,
                        int R, int C, int P, int chunk, int lg) {
  const Place s = place(lg, R, chunk, P - 1 - blockIdx.y);
  if (s.cv * V >= C) return;
  float m[V], iv[V], k1[V], k2[V], k3[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = s.cv * V + j;
    m[j] = mean[c];
    iv[j] = inv[c];
    k1[j] = coef[c];
    k2[j] = coef[C + c];
    k3[j] = coef[2 * C + c];
  }
  const long long off = s.cv * V;
  const int n = s.r1 - s.r0;
  int k = s.row_lane;
  for (; k + (U - 1) * s.rows_step < n; k += U * s.rows_step) {
    float vx[U][V], vd[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i =
          static_cast<long long>(s.r1 - 1 - k - u * s.rows_step) * C + off;
      load_last<T, V>(x + i, vx[u]);
      load_last<T, V>(dy + i, vd[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xhat = (vx[u][j] - m[j]) * iv[j];
        vd[u][j] = k1[j] * (vd[u][j] - k2[j] - xhat * k3[j]);
      }
      store_cs<T, V>(
          dx + static_cast<long long>(s.r1 - 1 - k - u * s.rows_step) * C +
              off,
          vd[u]);
    }
  }
  for (; k < n; k += s.rows_step) {
    const long long i = static_cast<long long>(s.r1 - 1 - k) * C + off;
    float vx[V], vd[V];
    load_last<T, V>(x + i, vx);
    load_last<T, V>(dy + i, vd);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xhat = (vx[j] - m[j]) * iv[j];
      vd[j] = k1[j] * (vd[j] - k2[j] - xhat * k3[j]);
    }
    store_cs<T, V>(dx + i, vd);
  }
}

// Rows a thread loads before it adds: 4 in the forward, 2 of x and 2 of
// dy in the backward (64 bytes in flight a thread on the vector route).
constexpr int kFwdUnroll = 4;
constexpr int kBwdUnroll = 2;

// The vector width of a route for element type T (channels an access).
template <class T>
constexpr int vec_of(int route) {
  return route == kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// log2 of the channel lanes of a tile: the vectors of C rounded up to a
// power of two, at most kMaxLanes (kernels/batch_norm.py:plan).
inline int lanes_log2(int C, int vec) {
  const int vecs = (C + vec - 1) / vec;
  int lg = 0;
  while ((1 << lg) < vecs && (1 << lg) < kMaxLanes) ++lg;
  return lg;
}

// Chunks a group of the two-level sum: the least gc with gc^2 >= 2 P, so
// that a group's gc float partials and the groups' double sums are about
// as many bytes (kernels/batch_norm.py:plan).
inline int group_chunks(int P) {
  int gc = 1;
  while (gc * gc < 2 * P) ++gc;
  return gc;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

// The checks every route shares, and the vector route's rule: C a
// multiple of the vector, every row pointer 16-byte aligned.
template <class T>
int check_args(int route, int R, int C, int P, int chunk, const void* a,
               const void* b, const void* c, const unsigned* counter) {
  if (route < kScalar || route > kThreePass || P < 1 || chunk < 1 ||
      static_cast<long long>(P) * chunk < R || P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route != kThreePass && counter == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kVector &&
      (C % vec_of<T>(kVector) != 0 || !aligned16(a) || !aligned16(b) ||
       !aligned16(c)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <class T, int V>
int launch_fwd_v(const T* x, const float* gamma, const float* beta, T* y,
                 float* mean, float* var, float* part, float* ab,
                 unsigned* counter, int R, int C, int P, int chunk, float eps,
                 cudaStream_t stream) {
  const int lg = lanes_log2(C, V);
  const int vecs = (C + V - 1) / V;
  const dim3 grid((vecs + (1 << lg) - 1) >> lg, P);
  double* gsum = reinterpret_cast<double*>(part + 2LL * P * C);
  bn_fwd_stats_kernel<T, V, kFwdUnroll><<<grid, kThreads, 0, stream>>>(
      x, gamma, beta, part, gsum, mean, var, ab, counter, R, C, P, chunk,
      group_chunks(P), lg, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_fwd_apply_kernel<T, V, kFwdUnroll><<<grid, kThreads, 0, stream>>>(
      x, ab, y, R, C, P, chunk, lg);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int V>
int launch_bwd_v(const T* x, const T* dy, const float* gamma,
                 const float* mean, const float* inv, T* dx, float* dgamma,
                 float* dbeta, float* part, float* coef, unsigned* counter,
                 int R, int C, int P, int chunk, cudaStream_t stream) {
  const int lg = lanes_log2(C, V);
  const int vecs = (C + V - 1) / V;
  const dim3 grid((vecs + (1 << lg) - 1) >> lg, P);
  double* gsum = reinterpret_cast<double*>(part + 2LL * P * C);
  bn_bwd_stats_kernel<T, V, kBwdUnroll><<<grid, kThreads, 0, stream>>>(
      x, dy, gamma, mean, inv, part, gsum, dgamma, dbeta, coef, counter, R, C,
      P, chunk, group_chunks(P), lg);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_bwd_apply_kernel<T, V, kBwdUnroll><<<grid, kThreads, 0, stream>>>(
      x, dy, mean, inv, coef, dx, R, C, P, chunk, lg);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_fwd(const T* x, const float* gamma, const float* beta, T* y,
               float* mean, float* var, float* part, float* ab,
               unsigned* counter, int R, int C, int P, int chunk, float eps,
               int route, cudaStream_t stream) {
  const int err = check_args<T>(route, R, C, P, chunk, x, y, x, counter);
  if (err != 0) return err;
  if (route == kThreePass)
    return three_pass::launch_fwd(x, gamma, beta, y, mean, var, part, ab, R,
                                  C, P, chunk, eps, stream);
  if (route == kVector)
    return launch_fwd_v<T, vec_of<T>(kVector)>(x, gamma, beta, y, mean, var,
                                               part, ab, counter, R, C, P,
                                               chunk, eps, stream);
  return launch_fwd_v<T, 1>(x, gamma, beta, y, mean, var, part, ab, counter,
                            R, C, P, chunk, eps, stream);
}

template <class T>
int launch_bwd(const T* x, const T* dy, const float* gamma, const float* mean,
               const float* inv, T* dx, float* dgamma, float* dbeta,
               float* part, float* coef, unsigned* counter, int R, int C,
               int P, int chunk, int route, cudaStream_t stream) {
  const int err = check_args<T>(route, R, C, P, chunk, x, dy, dx, counter);
  if (err != 0) return err;
  if (route == kThreePass)
    return three_pass::launch_bwd(x, dy, gamma, mean, inv, dx, dgamma, dbeta,
                                  part, coef, R, C, P, chunk, stream);
  if (route == kVector)
    return launch_bwd_v<T, vec_of<T>(kVector)>(x, dy, gamma, mean, inv, dx,
                                               dgamma, dbeta, part, coef,
                                               counter, R, C, P, chunk,
                                               stream);
  return launch_bwd_v<T, 1>(x, dy, gamma, mean, inv, dx, dgamma, dbeta, part,
                            coef, counter, R, C, P, chunk, stream);
}

}  // namespace

// Forward on `stream`: y (R, C), mean and biased var (C).  Rows are cut
// into P chunks of `chunk` rows.  `part` is scratch of 2 * P * C floats
// (8-byte aligned), then, on routes 0 and 1, 2 * G * C doubles (G =
// ceil(P / group_chunks(P)) groups); `ab` of 2 * C floats; `counter`
// holds tiles * (G + 1) unsigned, 0 on entry and left 0 (routes 0 and
// 1).  `route`: 0 one channel a
// thread, 1 16 bytes a thread (refused unless C is a multiple of the
// vector and x and y are 16-byte aligned), 2 the three-launch design
// (counter unused).  Returns the first error, cudaErrorInvalidValue for
// arguments it refuses.
PTT_EXPORT int ptt_bn_fwd_f32(const float* x, const float* gamma,
                              const float* beta, float* y, float* mean,
                              float* var, float* part, float* ab,
                              unsigned* counter, int R, int C, int P,
                              int chunk, float eps, int route,
                              cudaStream_t stream) {
  return launch_fwd(x, gamma, beta, y, mean, var, part, ab, counter, R, C, P,
                    chunk, eps, route, stream);
}

PTT_EXPORT int ptt_bn_fwd_bf16(const bf16* x, const float* gamma,
                               const float* beta, bf16* y, float* mean,
                               float* var, float* part, float* ab,
                               unsigned* counter, int R, int C, int P,
                               int chunk, float eps, int route,
                               cudaStream_t stream) {
  return launch_fwd(x, gamma, beta, y, mean, var, part, ab, counter, R, C, P,
                    chunk, eps, route, stream);
}

// Backward on `stream`: dx (R, C), dgamma and dbeta (C), from x, dy,
// gamma, the batch mean and inv = rsqrt(var + eps); `part` and `counter`
// as the forward's, `coef` scratch of 3 * C floats; the vector route also
// needs dy and dx 16-byte aligned.
PTT_EXPORT int ptt_bn_bwd_f32(const float* x, const float* dy,
                              const float* gamma, const float* mean,
                              const float* inv, float* dx, float* dgamma,
                              float* dbeta, float* part, float* coef,
                              unsigned* counter, int R, int C, int P,
                              int chunk, int route, cudaStream_t stream) {
  return launch_bwd(x, dy, gamma, mean, inv, dx, dgamma, dbeta, part, coef,
                    counter, R, C, P, chunk, route, stream);
}

PTT_EXPORT int ptt_bn_bwd_bf16(const bf16* x, const bf16* dy,
                               const float* gamma, const float* mean,
                               const float* inv, bf16* dx, float* dgamma,
                               float* dbeta, float* part, float* coef,
                               unsigned* counter, int R, int C, int P,
                               int chunk, int route, cudaStream_t stream) {
  return launch_bwd(x, dy, gamma, mean, inv, dx, dgamma, dbeta, part, coef,
                    counter, R, C, P, chunk, route, stream);
}

// The plan's shape as this library computes it, for a check of the
// Python mirror (kernels/batch_norm.py:plan): out = {channels an access,
// channel lanes of a tile, channel tiles, chunks a group, groups} for C
// channels of `elem_bytes` (4 or 2) on `route` (0 or 1) in P chunks.
PTT_EXPORT int ptt_bn_plan(int C, int elem_bytes, int route, int P,
                           int* out) {
  if ((elem_bytes != 4 && elem_bytes != 2) || route < kScalar ||
      route > kVector || C < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = route == kVector ? 16 / elem_bytes : 1;
  const int lg = lanes_log2(C, vec);
  out[0] = vec;
  out[1] = 1 << lg;
  out[2] = ((C + vec - 1) / vec + (1 << lg) - 1) >> lg;
  out[3] = group_chunks(P);
  out[4] = (P + out[3] - 1) / out[3];
  return 0;
}
