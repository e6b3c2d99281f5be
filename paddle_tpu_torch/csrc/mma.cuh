// The warp-level tensor-core and copy primitives that the bf16 kernels
// share (tile_gemm.cuh's engine, flash_attention.cu, and the bf16 packing
// and alignment test of wgmma_gemm.cuh): the m16n8k16 bf16
// product, ldmatrix, bf16x2 packing, cp.async and the 16-byte alignment
// test that picks a kernel's vector path.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {

// d += a b on the tensor cores: a a 16 x 16 bf16 A fragment (row-major),
// b a 16 x 8 bf16 B fragment (column-major), d 16 x 8 float.  Lane
// (g = lane / 4, t = lane % 4) holds d[0..1] at (row g, columns 2t,
// 2t + 1) and d[2..3] at row g + 8; a[0] (row g, k 2t, 2t + 1), a[1]
// (row g + 8), a[2] (row g, k 2t + 8, 2t + 9), a[3] (row g + 8, k + 8);
// b[0] (k 2t, 2t + 1, column g), b[1] (k 2t + 8, 2t + 9).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address
// of row l % 8 of matrix l / 8; register i gets matrix i's (row l / 4,
// columns 2 (l % 4), 2 (l % 4) + 1), or with kTrans its transpose's.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// (lo, hi) rounded to bf16 and packed as one fragment register, lo in
// the low half (the lower k or column index).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from global to shared memory without a trip through
// registers; with !valid, 16 zero bytes (nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// The same for one 4-byte word.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Close the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight (this
// thread's copies; a barrier then makes every thread's visible).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether a pointer allows the 16-byte vector path (host side).
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace ptt
