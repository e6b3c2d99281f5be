// The bf16 GEMM engine on Hopper's warpgroup products (wgmma), shared by
// the matmul (matmul.cu) and the stride-1 NHWC implicit-GEMM convolution
// (conv.cu, forward and backward-input); the filter gradient (conv_dw.cu)
// builds its own kernel from this file's products, barriers, copies and
// descriptors, with A MN-major (wgmma_tile's kTransA):
//
//   C[M, N] = A[M, K] @ B[K, N], bf16 A and B, f32 sums, C stored as bf16.
//
// Through those two it replaces, in bf16, the TPU kernels
// paddle_tpu/pallas/matmul.py:92 _matmul_impl (at M >= 1024) and
// paddle_tpu/pallas/conv.py:161 _conv_fwd_impl (C % 64 == 0), which walk
// sequential grids with VMEM accumulators.  What bounds it on the H100:
// operations (989 TFLOP/s bf16) for the transformer's products and the
// 3 x 3 convs at 7 x 7 to 28 x 28, bytes (3.35 TB/s) for the 1 x 1 convs
// at 14 x 14 and larger and the 3 x 3 conv at 56 x 56.  For the first, the
// design issues the card's asynchronous warpgroup products from shared
// memory and keeps every consumer register and issue slot for them; for
// the second, it keeps up to 8 stages of loads in flight and writes C in
// 16-byte rows.
//
// B is the weight, row-major (K, N): the matmul's y, the conv's w
// flattened to (KH * KW * C, O), which is its own memory layout.  B is
// therefore MN-major and wgmma reads it with the transpose bit; the
// weight is never transposed in device memory.
//
// A block owns a 128 x BN tile of C (BN 64, 128 or 256) and holds three
// warpgroups of 128 threads (__launch_bounds__(384, 1)):
//
// - warpgroup 0, the producer, drops to kProducerRegs registers
//   (setmaxnreg.dec) and keeps a ring of kStages<BN> stages full.  A
//   stage is A (128 x 64 bf16, 16 KB) and B (64 x BN bf16, BN / 64 boxes
//   of 64 x 64), both in the 128-byte swizzle: row r of a 128-byte-wide
//   tile at byte 128 r, its 16-byte chunk j at chunk j ^ (r % 8).  B comes
//   by TMA (cp.async.bulk.tensor.2d, one thread).  A comes by TMA when it
//   is a dense (M, K) matrix (the matmul, a 1 x 1 conv), or is gathered
//   by all 128 producer threads with 16-byte cp.async copies, written to
//   their swizzled places, when it is the implicit-GEMM view of an image
//   (kGather: rows are output pixels, a 64-wide K step lies inside one
//   filter tap because C % 64 == 0; a halo pixel is a zero fill).
// - warpgroups 1 and 2, the consumers, rise to kConsumerRegs registers
//   (setmaxnreg.inc) and each issues wgmma.m64n{BN}k16 on its 64 rows of
//   the stage, both operands read from shared memory through descriptors,
//   f32 accumulators in registers (BN / 2 floats a thread).
//
// Each stage has a *full* and an *empty* mbarrier.  The consumers wait on
// full; once wgmma.wait_group has retired a stage's products they arrive
// on its empty barrier (one lane a warp, 8 arrivals), which the producer
// waits on before it refills the stage.  With TMA for A, full counts one
// arrival (arrive.expect_tx by the thread that issues the loads) and the
// loads' bytes.  With the gather it counts 128 more: cp.async writes
// shared memory through the generic proxy and wgmma reads it through the
// async proxy, so each producer thread waits for its copies of a stage
// (cp.async.wait_group, lagging kStages - 2 stages so that the ring never
// waits on itself), issues fence.proxy.async.shared::cta, and only then
// arrives.
//
// The epilogue rounds each consumer's f32 accumulators to bf16 and writes
// them 64 columns at a time into a staging tile in shared memory, whose
// rows go out as 16-byte stores, masked at the ragged edge (the
// fragment's own bf16x2 words, 8 rows a warp instruction, would cost
// eight times the store instructions).  Everything outside
// [0, M) x [0, K) x [0, N) is read as zero (TMA's out-of-bounds fill, the
// gather's zero fills): any M and a ragged last tile work.  One output
// tile per block, the blocks taking their tiles in groups of kGroupM M
// tiles (every N tile of a group before the next) so that a wave shares
// its A and B panels in L2; a persistent tile scheduler, clusters and TMA
// multicast are later work.
//
// The tensor maps come from cuTensorMapEncodeTiled, a driver API call.
// The libraries are built without -lcuda, so the entry point is looked up
// at run time with cudaGetDriverEntryPointByVersion and only <cuda.h>'s
// types are used.  The maps are encoded on the host at every call and
// passed as __grid_constant__ kernel parameters.  A failed lookup or
// encoding is returned as the launch's error code (kNoTensorMapEncode,
// kTensorMapError + the CUresult), which ptt_error_string names.
//
// Shapes it takes: K % 8 == 0, N % 8 == 0 (TMA's 16-byte stride rule),
// 16-byte-aligned A, B and C, and with kGather C % 64 == 0.
// The callers check this before a launch and refuse anything else.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace ptt {
namespace wg {
// Internal linkage: the matmul and conv libraries each hold their own
// instances.  A template's function-local static (the shared-memory
// attribute, set once per instance) is otherwise one object for the
// whole process, and the second library's kernel would launch without
// its attribute.
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                // block rows: 2 consumers x 64
constexpr int kBK = 64;                 // K step: one 128-byte row of bf16
constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kATile = kBM * kBK * 2;   // A stage bytes (16 KB)
constexpr int kBBox = kBK * 64 * 2;     // one 64 x 64 B box (8 KB)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Stages of the ring: 192 KB at every BN, of the 227 KB a block may use.
template <int BN>
constexpr int kStages = BN == 256 ? 4 : (BN == 128 ? 6 : 8);
template <int BN>
constexpr int kStageBytes = kATile + BN * kBK * 2;
// The epilogue's staging tile of a consumer warpgroup: 64 x 64 bf16, rows
// padded by 8 (144 bytes) so that neither its bf16x2 writes nor its
// 16-byte row reads meet in a bank.
constexpr int kOutLd = 64 + 8;
constexpr int kOutTile = 64 * kOutLd * 2;
// M tiles a block group walks together (see wgmma_gemm_kernel).
constexpr int kGroupM = 16;
// The stages (1024-byte aligned: the swizzle follows address bits 4-9),
// a full and an empty barrier each, the gather's 128-row table, the two
// consumers' staging tiles, and 1 KB of slack to align the dynamic
// shared memory's start.
template <int BN>
constexpr int kSmemBytes = kStages<BN> * kStageBytes<BN> + 16 * kStages<BN> +
                           16 * kBM + 2 * kOutTile + 1024;

// The conv's image geometry, for the gathered A (unused by a dense A).
struct ConvGeom {
  const bf16* x;
  int H, W, C, KW, pad, OH, OW;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// A wait longer than this many clocks (about 20 s) traps: an arrival
// that never comes (a fault of the ring's accounting) ends the launch
// with an error instead of hanging the card.
constexpr long long kWaitTrapClocks = 1ll << 35;

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitTrapClocks) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// The box of `map` at (c0 innermost, c1) into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes from global to shared memory, or 16 zero bytes (nothing read)
// when !valid.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to
// the async proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among one warpgroup's 128 threads only: id 1 the producer,
// 2 + cw consumer cw (0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x n f32, the warpgroup's fragment) = A (64 x 16, desc da: K-major,
// or MN-major with the transpose bit when kTransA == 1) @ B (16 x n,
// MN-major: the transpose bit, desc db), plus d when acc != 0.  Thread t
// of the
// warpgroup holds, for each 8 columns j, d[4j .. 4j + 1] at row 16 (t / 32)
// + (t % 32) / 4, columns 8j + 2 (t % 4) and the next, and d[4j + 2 ..
// 4j + 3] eight rows below.
template <int kTransA>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(kTransA));
}

template <int kTransA>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                             uint64_t db, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(kTransA));
}

template <int kTransA>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                             uint64_t db, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc), "n"(kTransA));
}

// kTransA 0: A K-major (the matmul's x, the conv's gathered pixels, rows
// of 64 K values); 1: A MN-major, read with the transpose bit (the filter
// gradient's x, rows of 64 M values, laid out as B is).
template <int BN, int kTransA = 0>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, uint32_t acc) {
  if constexpr (BN == 256)
    wgmma_m64n256<kTransA>(d, da, db, acc);
  else if constexpr (BN == 128)
    wgmma_m64n128<kTransA>(d, da, db, acc);
  else
    wgmma_m64n64<kTransA>(d, da, db, acc);
}

// Pin the accumulators in their registers around the asynchronous
// products: no other instruction may define them while a wgmma that
// writes them is in flight (ptxas serializes the products otherwise).
template <int BN>
__device__ __forceinline__ void fence_operands(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The producer with a dense A (one thread): each stage's A box (64 K x
// 128 rows) and BN / 64 B boxes (64 columns x 64 K) by TMA.
template <int BN>
__device__ __forceinline__ void produce_tma(const CUtensorMap* ta,
                                            const CUtensorMap* tb,
                                            uint32_t base, uint32_t full0,
                                            uint32_t empty0, int m0, int n0,
                                            int KT) {
  constexpr int S = kStages<BN>;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
    const uint32_t full = full0 + 8 * s;
    const uint32_t a = base + s * kStageBytes<BN>;
    mbar_expect_tx(full, kStageBytes<BN>);
    tma_load_2d(a, ta, kt * kBK, m0, full);
#pragma unroll
    for (int i = 0; i < BN / 64; ++i)
      tma_load_2d(a + kATile + i * kBBox, tb, n0 + 64 * i, kt * kBK, full);
  }
}

// The producer with a gathered A (all 128 threads of warpgroup 0).
// Thread t copies 16-byte chunk t % 8 of rows t / 8 + 16 i (i < 8), so a
// warp's copy covers four whole 128-byte rows.  The rows' output pixels
// are found once per block, into a shared table.  B comes by TMA from
// thread 0.  A stage's gathered copies are published kStages - 2 stages
// later (see the header comment).
template <int BN>
__device__ __forceinline__ void produce_gather(const CUtensorMap* tb,
                                               const ConvGeom& g, int4* rows,
                                               uint32_t base, uint32_t full0,
                                               uint32_t empty0, int m0, int n0,
                                               int M, int KT) {
  constexpr int S = kStages<BN>;
  constexpr int L = S - 2;
  const int t = threadIdx.x;
  {
    // (first pixel of the image, oh, ow) of row t; oh far below zero
    // past M, so every tap of it is a zero fill
    int4 r = make_int4(0, -(1 << 30), 0, 0);
    const int m = m0 + t;
    if (m < M) {
      const int img = g.OH * g.OW;
      const int n = m / img;
      const int p = m - n * img;
      const int oh = p / g.OW;
      r = make_int4(n * g.H * g.W, oh, p - oh * g.OW, 0);
    }
    rows[t] = r;
  }
  warpgroup_sync(1);
  const int j = t % 8;
  const int r0 = t / 8;
  const uint32_t dst0 = r0 * 128 + ((j ^ (r0 % 8)) << 4);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
    const uint32_t a = base + s * kStageBytes<BN>;
    const int k0 = kt * kBK;
    if (t == 0) {
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, BN * kBK * 2);
#pragma unroll
      for (int i = 0; i < BN / 64; ++i)
        tma_load_2d(a + kATile + i * kBBox, tb, n0 + 64 * i, k0, full);
    }
    // the K step lies inside one tap (kh, kw): channels c0 .. c0 + 63
    const int tap = k0 / g.C;
    const int c = k0 - tap * g.C + 8 * j;
    const int dh = tap / g.KW - g.pad;
    const int dw = tap % g.KW - g.pad;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 r = rows[r0 + 16 * i];
      const int ih = r.y + dh;
      const int iw = r.z + dw;
      const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(g.H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(g.W);
      const bf16* src =
          ok ? g.x + (static_cast<long long>(r.x + ih * g.W + iw) * g.C + c)
             : g.x;
      cp_async16_zfill(a + dst0 + i * 16 * 128, src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (kt >= L) {
      cp_async_wait_n<L>();
      fence_proxy_async();
      mbar_arrive(full0 + 8 * ((kt - L) % S));
    }
  }
  cp_async_wait_n<0>();
  fence_proxy_async();
  for (int kt = KT > L ? KT - L : 0; kt < KT; ++kt)
    mbar_arrive(full0 + 8 * (kt % S));
}

// A consumer warpgroup (cw 0 or 1: rows 64 cw .. 64 cw + 63 of the tile):
// wgmma over the ring, then the bf16 epilogue through its staging tile.
template <int BN>
__device__ __forceinline__ void consume(uint32_t base, uint32_t full0,
                                        uint32_t empty0, uint8_t* staging,
                                        bf16* __restrict__ out, int m0,
                                        int n0, int M, int N, int KT) {
  constexpr int S = kStages<BN>;
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  // never zeroed: the tile's first product overwrites d (acc = 0), and
  // KT >= 1 (K > 0)
  float d[BN / 2];
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    mbar_wait(full0 + 8 * s, (kt / S) & 1);
    const uint32_t a = base + s * kStageBytes<BN>;
    // A: K-major, 8-row groups 1024 bytes apart (the leading offset is
    // not used under the swizzle); B: MN-major, 8-row K groups 1024 bytes
    // apart, 64-column boxes kBBox apart
    const uint64_t da = desc_sw128(a + cw * 64 * 128, 16, 1024);
    const uint64_t db = desc_sw128(a + kATile, kBBox, 1024);
    fence_operands<BN>(d);
    wgmma_fence();
    // k16 steps: 32 bytes along A's rows, 16 rows (2048 bytes) down B
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_tile<BN>(d, da + 2 * kk, db + 128 * kk, kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands<BN>(d);
    if (kt > 0 && t % 32 == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % S));
  }
  wgmma_wait<0>();
  fence_operands<BN>(d);

  // 64 columns at a time: the fragment into the staging tile as bf16x2
  // words, a barrier, then each row of it out as 16-byte stores (8 lanes
  // a row), masked at M and N (N % 8 == 0: a 16-byte chunk is all in or
  // all out), and a barrier before the next 64 columns overwrite it.
  const int lane = t % 32;
  const int fr = 16 * (t / 32) + lane / 4;
  const int fc = 2 * (lane % 4);
#pragma unroll
  for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = 4 * (8 * c + j);
      *reinterpret_cast<uint32_t*>(staging + 2 * (fr * kOutLd + 8 * j + fc)) =
          pack_bf16x2(d[q], d[q + 1]);
      *reinterpret_cast<uint32_t*>(staging +
                                   2 * ((fr + 8) * kOutLd + 8 * j + fc)) =
          pack_bf16x2(d[q + 2], d[q + 3]);
    }
    warpgroup_sync(2 + cw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * i + t / 8;
      const int m = m0 + 64 * cw + r;
      const int n = n0 + 64 * c + 8 * (t % 8);
      if (m < M && n < N)
        *reinterpret_cast<uint4*>(out + static_cast<long long>(m) * N + n) =
            *reinterpret_cast<const uint4*>(staging + 2 * r * kOutLd +
                                            16 * (t % 8));
    }
    warpgroup_sync(2 + cw);
  }
}

template <int BN, bool kGather>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b,
                      const ConvGeom geom, bf16* __restrict__ out, int M,
                      int N, int K) {
  constexpr int S = kStages<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + S * kStageBytes<BN>;
  const uint32_t empty0 = full0 + 8 * S;
  uint8_t* tables = smem_raw + (base - raw) + S * kStageBytes<BN> + 16 * S;
  int4* rows = reinterpret_cast<int4*>(tables);
  uint8_t* staging = tables + 16 * kBM;
  // The blocks walk the tiles in groups of kGroupM M tiles, every N tile
  // of a group before the next group, so that a wave of blocks shares a
  // few A and B panels in L2 instead of reading every A panel.
  int m0, n0;
  {
    const int id = blockIdx.y * gridDim.x + blockIdx.x;
    const int per = kGroupM * gridDim.y;
    const int first = id / per * kGroupM;
    const int left = static_cast<int>(gridDim.x) - first;
    const int rows_in = left < kGroupM ? left : kGroupM;
    m0 = (first + id % per % rows_in) * kBM;
    n0 = id % per / rows_in * BN;
  }
  const int KT = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, kGather ? 129 : 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if constexpr (kGather)
      produce_gather<BN>(&tm_b, geom, rows, base, full0, empty0, m0, n0, M,
                         KT);
    else if (threadIdx.x == 0)
      produce_tma<BN>(&tm_a, &tm_b, base, full0, empty0, m0, n0, KT);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<BN>(base, full0, empty0,
                staging + (threadIdx.x / 128 - 1) * kOutTile, out, m0, n0, M,
                N, KT);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; null if the
// driver does not have it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();   // leave no error for the next launch's check
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of a row-major rows x cols bf16 matrix cut in boxes of box_cols
// x box_rows, 128-byte swizzle, zeros outside; 0 or an error code.
inline int encode_bf16(CUtensorMap* map, const void* p, int cols, int rows,
                       int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoTensorMapEncode;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

template <int BN, bool kGather>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const ConvGeom& g,
           bf16* out, int M, int N, int K, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only once allowed, per instance
  static const cudaError_t allowed = cudaFuncSetAttribute(
      wgmma_gemm_kernel<BN, kGather>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<BN>);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  wgmma_gemm_kernel<BN, kGather><<<grid, kThreads, kSmemBytes<BN>, stream>>>(
      ta, tb, g, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The tile width for N columns: 64, 128 or 256, the least that covers N
// up to 256 (O = 64 must not fill a quarter of a 256-wide tile).
inline int tile_n(int n) { return n > 128 ? 256 : (n > 64 ? 128 : 64); }

template <bool kGather>
int launch_bn(int bn, const CUtensorMap& ta, const CUtensorMap& tb,
              const ConvGeom& g, bf16* out, int M, int N, int K,
              cudaStream_t stream) {
  if (bn == 64) return launch<64, kGather>(ta, tb, g, out, M, N, K, stream);
  if (bn == 128) return launch<128, kGather>(ta, tb, g, out, M, N, K, stream);
  return launch<256, kGather>(ta, tb, g, out, M, N, K, stream);
}

// Whether the engine takes these operands: K % 8 == 0 and N % 8 == 0 (a
// row's bytes a multiple of 16), 16-byte-aligned A, B and out (the
// epilogue's 16-byte stores).
inline bool takes(int K, int N, const void* a, const void* b,
                  const void* out) {
  return K > 0 && K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(b) &&
         aligned16(out);
}

// out[M, N] = a[M, K] @ b[K, N] with A loaded by TMA.
inline int gemm_dense(const bf16* a, const bf16* b, bf16* out, int M, int N,
                      int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = encode_bf16(&ta, a, K, M, kBK, kBM);
  if (err == 0) err = encode_bf16(&tb, b, N, K, 64, kBK);
  if (err != 0) return err;
  const ConvGeom g{nullptr, 0, 0, 0, 0, 0, 0, 0};
  return launch_bn<false>(tile_n(N), ta, tb, g, out, M, N, K, stream);
}

// out[0..4): registers, local (spill) bytes, static and dynamic shared
// memory of the instance for tile width bn; 0 or a cudaError_t.
template <int BN, bool kGather>
int attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, wgmma_gemm_kernel<BN, kGather>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kSmemBytes<BN>;
  return 0;
}

template <bool kGather>
int attributes_bn(int bn, int* out) {
  if (bn == 64) return attributes<64, kGather>(out);
  if (bn == 128) return attributes<128, kGather>(out);
  return attributes<256, kGather>(out);
}

}  // namespace
}  // namespace wg
}  // namespace ptt
