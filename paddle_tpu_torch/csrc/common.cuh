// Shared by every kernel library of paddle_tpu_torch: the export macro
// of the plain C interface that the Python wrappers load with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <stdio.h>

#define PTT_EXPORT extern "C" __attribute__((visibility("default")))

namespace ptt {

// Error codes past every cudaError_t that a library's host code returns
// (wgmma_gemm.cuh): the driver has no cuTensorMapEncodeTiled, or it
// refused a tensor map (kTensorMapError + its CUresult).
constexpr int kNoTensorMapEncode = 100000;
constexpr int kTensorMapError = 100001;

}  // namespace ptt

// Message for an error code returned by an entry point of this library.
PTT_EXPORT const char* ptt_error_string(int code) {
  if (code == ptt::kNoTensorMapEncode)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (code >= ptt::kTensorMapError) {
    static thread_local char msg[80];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - ptt::kTensorMapError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
