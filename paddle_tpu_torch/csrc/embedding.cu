// Embedding gather in float32: out[n, :] = W[ids[n], :] for a (V, D)
// table and N int64 or int32 ids.
//
// Replaces the TPU kernel paddle_tpu/pallas/embedding.py:47 _gather_impl
// (_gather_kernel :18, pallas_call :63), where scalar-prefetched ids drive
// each grid step's index map so that the DMA engine copies one (1, D)
// row per step, and D must be a multiple of 128.  Here one warp copies
// one row: it loads its own id, then strides over the row's columns,
// 16 bytes a lane (float4) where D % 4 == 0 and both pointers are
// 16-byte aligned, 4 bytes a lane otherwise, so any D works.
//
// An id outside the table never reads outside it.  The function is
// jnp.take's, which the JAX op falls back to: an id in [-V, 0) counts
// from the end, and any other id outside [0, V) gives a row of NaN.
//
// What bounds it on the H100: bytes, N * D * 4 read and as many
// written (plus the ids), at 3.35 TB/s; there is no arithmetic.  Rows
// are independent, so the grid is ceil(N / 8) blocks of 8 warps.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <typename Id, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ w, const Id* __restrict__ ids,
                       float* __restrict__ out, long long n, long long v,
                       int d) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
  if (row >= n) return;
  const int lane = threadIdx.x % 32;
  long long id = static_cast<long long>(ids[row]);
  if (id < 0) id += v;
  const bool valid = id >= 0 && id < v;
  float* dst = out + row * d;
  if (kVec4) {
    const int d4 = d / 4;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    if (valid) {
      const float4* src4 = reinterpret_cast<const float4*>(w + id * d);
      for (int c = lane; c < d4; c += 32) dst4[c] = __ldg(src4 + c);
    } else {
      const float4 nan4 = make_float4(NAN, NAN, NAN, NAN);
      for (int c = lane; c < d4; c += 32) dst4[c] = nan4;
    }
  } else {
    if (valid) {
      const float* src = w + id * d;
      for (int c = lane; c < d; c += 32) dst[c] = __ldg(src + c);
    } else {
      for (int c = lane; c < d; c += 32) dst[c] = NAN;
    }
  }
}

template <typename Id>
int launch(const float* w, const Id* ids, float* out, long long n,
           long long v, int d, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4)
    gather_rows_kernel<Id, true><<<blocks, kThreads, 0, stream>>>(
        w, ids, out, n, v, d);
  else
    gather_rows_kernel<Id, false><<<blocks, kThreads, 0, stream>>>(
        w, ids, out, n, v, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids are int64 when ids_are_int64 is 1, int32 otherwise.  Launches on
// `stream`; returns cudaGetLastError() of the launch.
PTT_EXPORT int ptt_gather_rows_f32(const float* w, const void* ids,
                                   float* out, long long n, long long v,
                                   int d, int ids_are_int64,
                                   cudaStream_t stream) {
  if (ids_are_int64)
    return launch(w, static_cast<const long long*>(ids), out, n, v, d, stream);
  return launch(w, static_cast<const int*>(ids), out, n, v, d, stream);
}
