// Row softmax in float32: y[r, :] = exp(x[r, :] - max) / sum(exp(...)).
//
// Replaces the TPU kernel paddle_tpu/pallas/softmax.py:68 _softmax_impl
// (_softmax_kernel :14), which holds a (block_rows, cols) block in VMEM
// and needs cols % 128 == 0.  Here one block of 256 threads owns one row
// of any length: it strides over the columns three times (max, sum of
// exponentials, divide), the tail masked by the loop bound and the max
// starting from -inf, with warp-shuffle reductions finished across the
// 8 warps in shared memory.  The row's 4 KB (1000 classes) stays in L1
// between the passes.
//
// What bounds it on the H100: bytes, 8 per element (one read, one
// write), at 3.35 TB/s.  At the serving shape (32 x 1000) the whole call
// is ~256 KB, so launch latency dominates.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Every thread gets the block-wide result; `red` is reusable on return.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float out = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) out = fmaxf(out, red[i]);
  __syncthreads();
  return out;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) out += red[i];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
    softmax_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int cols) {
  __shared__ float red[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * cols;
  const float* xr = x + base;
  float* yr = y + base;

  float m = -INFINITY;
  for (int c = threadIdx.x; c < cols; c += kThreads) m = fmaxf(m, xr[c]);
  m = block_max(m, red);

  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) s += expf(xr[c] - m);
  s = block_sum(s, red);

  for (int c = threadIdx.x; c < cols; c += kThreads)
    yr[c] = expf(xr[c] - m) / s;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
PTT_EXPORT int ptt_softmax_f32(const float* x, float* y, int rows, int cols,
                               cudaStream_t stream) {
  softmax_f32_kernel<<<rows, kThreads, 0, stream>>>(x, y, cols);
  return static_cast<int>(cudaGetLastError());
}
