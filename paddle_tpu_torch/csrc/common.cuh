// Shared by every kernel library of paddle_tpu_torch: the export macro
// of the plain C interface that the Python wrappers load with ctypes.
#pragma once

#include <cuda_runtime.h>

#define PTT_EXPORT extern "C" __attribute__((visibility("default")))

// Message for a cudaError_t returned by an entry point of this library.
PTT_EXPORT const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
