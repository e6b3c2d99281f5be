// Training batch norm over a channel-minor (R, C) view (R = N*H*W rows of
// an NHWC tensor), forward and backward, in float32 and in bf16: bf16 x,
// dy, y and dx, float32 statistics, sums, dgamma and dbeta.
//
// Replaces the TPU kernels paddle_tpu/pallas/batch_norm.py:124
// _bn_fwd_impl (_bn_fwd_kernel :92) and :197 _bn_bwd_impl
// (_bn_bwd_kernel :160).  Each is one pallas_call with a two-phase
// sequential grid: phase 0 streams row blocks into a per-channel VMEM
// accumulator, phase 1 streams them again and writes the result.  On
// Hopper the blocks run in parallel and in no order, so a reduction
// across blocks needs another launch.  Each direction is three launches
// on one stream:
//   1. partial sums: block (channel tile, row chunk) sums its rows for 32
//      channels and writes one partial per chunk (forward: sum x and
//      sum x^2; backward: sum dy and sum dy * xhat);
//   2. finalize, one thread per channel: adds the chunks' partials in a
//      fixed order in double, then (forward) mean, biased variance
//      E[x^2] - m^2 (as the TPU kernel and the JAX op compute it,
//      cancellation included) and the affine folded into y = x * a + b;
//      (backward) dbeta, dgamma and the three dx coefficients.  For bf16
//      the folded a and b are rounded to bf16 values, as the JAX op
//      rounds them before its bf16 normalize (paddle_tpu/ops/
//      nn_ops.py:464-472);
//   3. the elementwise pass over the same tiles: y = x * a + b, or
//      dx = gamma * inv * (dy - dbeta / R - xhat * dgamma / R).
// No atomics: the result is the same from run to run.
//
// Threads: a block is 32 channels x 8 row lanes; a warp reads 32
// neighbouring channels of one row (128 contiguous bytes) and each thread
// keeps its channel's constants in registers for the whole chunk.  The
// host picks the row chunk so that about 8 blocks per SM are in flight.
//
// What bounds it on the H100: bytes.  The forward reads x twice and
// writes y (the TPU kernel's minimum, 3 passes); the backward reads x and
// dy twice and writes dx (5 passes); bf16 halves every pass.  A bf16 warp
// reads 64 contiguous bytes of a row, half the f32 transaction, so it
// reaches a smaller share of the bandwidth; vector loads of 2 channels a
// thread are later work.  The partials are chunks * C * 8 bytes, small
// beside the rows.  The second read of x mostly misses the 50 MB L2 at
// ResNet-50 sizes; a single-pass variant that keeps a chunk in shared
// memory is later work.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

}  // namespace

// Forward on `stream`: y (R, C), mean and biased var (C); `part` is
// scratch of 2 * P * C floats, `ab` of 2 * C.  Rows are cut into P chunks
// of `chunk` rows.  Returns the first cudaGetLastError() that is not 0.
PTT_EXPORT int ptt_bn_fwd_f32(const float* x, const float* gamma,
                              const float* beta, float* y, float* mean,
                              float* var, float* part, float* ab, int R,
                              int C, int P, int chunk, float eps,
                              cudaStream_t stream) {
  return launch_fwd(x, gamma, beta, y, mean, var, part, ab, R, C, P, chunk,
                    eps, stream);
}

PTT_EXPORT int ptt_bn_fwd_bf16(const bf16* x, const float* gamma,
                               const float* beta, bf16* y, float* mean,
                               float* var, float* part, float* ab, int R,
                               int C, int P, int chunk, float eps,
                               cudaStream_t stream) {
  return launch_fwd(x, gamma, beta, y, mean, var, part, ab, R, C, P, chunk,
                    eps, stream);
}

// Backward on `stream`: dx (R, C), dgamma and dbeta (C), from x, dy,
// gamma, the batch mean and inv = rsqrt(var + eps); `part` is scratch of
// 2 * P * C floats, `coef` of 3 * C.
PTT_EXPORT int ptt_bn_bwd_f32(const float* x, const float* dy,
                              const float* gamma, const float* mean,
                              const float* inv, float* dx, float* dgamma,
                              float* dbeta, float* part, float* coef, int R,
                              int C, int P, int chunk, cudaStream_t stream) {
  return launch_bwd(x, dy, gamma, mean, inv, dx, dgamma, dbeta, part, coef, R,
                    C, P, chunk, stream);
}

PTT_EXPORT int ptt_bn_bwd_bf16(const bf16* x, const bf16* dy,
                               const float* gamma, const float* mean,
                               const float* inv, bf16* dx, float* dgamma,
                               float* dbeta, float* part, float* coef, int R,
                               int C, int P, int chunk, cudaStream_t stream) {
  return launch_bwd(x, dy, gamma, mean, inv, dx, dgamma, dbeta, part, coef, R,
                    C, P, chunk, stream);
}
