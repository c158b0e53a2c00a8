// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers,
// the Tensor Memory Accelerator (2-D tensor maps, bulk copies and tensor
// stores), wgmma shared-memory descriptors, wgmma itself for the widths the
// kernels use, proxy fences and named barriers.
// Plain inline PTX, no CuTe, so that a source including it builds in
// seconds.  Device code unless marked host.
//
// Shared-memory operand layout of the wgmma here: "K-major, 128-byte
// swizzle" (with MN = true, fp16 only, its MN-major counterpart:
// wgmma_desc_mn).  A matrix of R rows and 64 bf16 columns (one "chunk", 128
// bytes a row) is stored row after row, and within each group of 8 rows
// (1024 bytes, 1024-aligned) the 16-byte piece q of row r sits at piece
// position q ^ (r % 8).  A TMA map with CU_TENSOR_MAP_SWIZZLE_128B and a
// 64-column box writes exactly this layout; swz128() gives the byte offset
// of an element for code that reads or writes it by hand.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, col) in a K-major 128-byte-swizzled chunk of 64
// 2-byte columns.
__host__ __device__ __forceinline__ uint32_t swz128(int row, int col) {
  return (uint32_t)row * 128u + (uint32_t)((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the inits visible to the async proxy (TMA) and the other threads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed.  A wait that
// lasts over 4 s traps, so that a protocol fault ends the kernel with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((tries & 1023) == 0) {
      const uint64_t t = global_ns();
      if (tries == 0) t0 = t;
      else if (t - t0 > 4000000000ull) __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA and bulk copies
// ---------------------------------------------------------------------------

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned), completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// The box of `map` at (c0 innermost, c1) into shared `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// Shared `src` to the box of `map` at (c0, c1); rows past the map's extent
// are dropped.  Tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are incomplete.
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory become visible to the async proxy
// (wgmma operands, TMA stores): each writing thread, before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Global-memory writes made visible to this thread (a completed bulk store,
// seen through an mbarrier) become visible to its async-proxy reads (TMA).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Four 8x8 b16 matrices from a warp's registers to shared memory: thread
// l holds, in r[i], the two values of row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1, of matrix i (a wgmma accumulator fragment's layout), and
// gives the address of row l % 8 of matrix l / 8 (16 bytes a row).
__device__ __forceinline__ void stsm_x4(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Two f32 values rounded to fp16 and packed (the first in the low half),
// and such a pair back to f32.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float2 unpack_f16(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// Named barrier `id` (1..15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A warpgroup's register budget a thread raised or lowered to N (a multiple
// of 8 in 24..256): all 128 threads of the warpgroup execute it.
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a K-major 128-byte-swizzled operand whose 8-row groups lie
// 1024 bytes apart, starting at `p` (the chunk's row 0, plus 32 bytes per
// 16-column step along K).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Descriptor of an MN-major ("transposed") 128-byte-swizzled fp16 operand:
// atoms of 8 K rows x 64 MN columns, each K row's 64 columns (128 bytes)
// contiguous and swizzled as a K-major chunk's row (swz128(k % 8, mn % 64)),
// each atom 1024 bytes and 1024-aligned; atoms `lbo` bytes apart along MN
// and `sbo` bytes apart along K, from `p` (the atom of MN 0 and the first K
// row; a 16-deep K step is two atoms along K).
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After wgmma_wait, the accumulator registers may be read: this keeps the
// compiler from moving their reads above the wait.
template <int R> __device__ __forceinline__ void wgmma_fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], both from shared memory (descriptors;
// MN: both MN-major), bf16 (F16: fp16) in, f32 accumulate: d[0..15] of each thread.
#define HOPPER_WGMMA_N32(TY, TR) \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, " TR ";\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <int R, bool F16 = false, bool MN = false>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[R], uint64_t da, uint64_t db,
                                               int scale_d) {
  static_assert(R >= 16, "accumulator too small");
  static_assert(!MN || F16, "MN-major operands: fp16 here");
  if constexpr (MN) HOPPER_WGMMA_N32("f16", "1, 1");
  else if constexpr (F16) HOPPER_WGMMA_N32("f16", "0, 0");
  else HOPPER_WGMMA_N32("bf16", "0, 0");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory (descriptors;
// MN: both MN-major), bf16 (F16: fp16) in, f32 accumulate: d[0..31] of each thread.
#define HOPPER_WGMMA_N64(TY, TR) \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, " TR ";\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <int R, bool F16 = false, bool MN = false>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[R], uint64_t da, uint64_t db,
                                               int scale_d) {
  static_assert(R >= 32, "accumulator too small");
  static_assert(!MN || F16, "MN-major operands: fp16 here");
  if constexpr (MN) HOPPER_WGMMA_N64("f16", "1, 1");
  else if constexpr (F16) HOPPER_WGMMA_N64("f16", "0, 0");
  else HOPPER_WGMMA_N64("bf16", "0, 0");
}

// D[64 x 96] (+)= A[64 x 16] B[16 x 96], both from shared memory (descriptors;
// MN: both MN-major), bf16 (F16: fp16) in, f32 accumulate: d[0..47] of each thread.
#define HOPPER_WGMMA_N96(TY, TR) \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %50, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47" \
      "}, %48, %49, p, 1, 1, " TR ";\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <int R, bool F16 = false, bool MN = false>
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[R], uint64_t da, uint64_t db,
                                               int scale_d) {
  static_assert(R >= 48, "accumulator too small");
  static_assert(!MN || F16, "MN-major operands: fp16 here");
  if constexpr (MN) HOPPER_WGMMA_N96("f16", "1, 1");
  else if constexpr (F16) HOPPER_WGMMA_N96("f16", "0, 0");
  else HOPPER_WGMMA_N96("bf16", "0, 0");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory (descriptors;
// MN: both MN-major), bf16 (F16: fp16) in, f32 accumulate: d[0..63] of each thread.
#define HOPPER_WGMMA_N128(TY, TR) \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, " TR ";\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <int R, bool F16 = false, bool MN = false>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[R], uint64_t da, uint64_t db,
                                               int scale_d) {
  static_assert(R >= 64, "accumulator too small");
  static_assert(!MN || F16, "MN-major operands: fp16 here");
  if constexpr (MN) HOPPER_WGMMA_N128("f16", "1, 1");
  else if constexpr (F16) HOPPER_WGMMA_N128("f16", "0, 0");
  else HOPPER_WGMMA_N128("bf16", "0, 0");
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], both from shared memory (descriptors;
// MN: both MN-major), bf16 (F16: fp16) in, f32 accumulate: d[0..127] of each thread.
#define HOPPER_WGMMA_N256(TY, TR) \
  asm volatile( \
      "{\n.reg .pred p;\n" \
      "setp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, " TR ";\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(scale_d))
template <int R, bool F16 = false, bool MN = false>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[R], uint64_t da, uint64_t db,
                                                int scale_d) {
  static_assert(R >= 128, "accumulator too small");
  static_assert(!MN || F16, "MN-major operands: fp16 here");
  if constexpr (MN) HOPPER_WGMMA_N256("f16", "1, 1");
  else if constexpr (F16) HOPPER_WGMMA_N256("f16", "0, 0");
  else HOPPER_WGMMA_N256("bf16", "0, 0");
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// A 2-D bf16 tensor map over a row-major [rows][cols] array with row stride
// `ld_bytes`, box [box_rows][box_cols] (box_cols * 2 <= 128 bytes with the
// 128-byte swizzle), zeros past the extent.  cuTensorMapEncodeTiled is a
// driver function: it is reached through the runtime's entry-point query,
// so nothing links libcuda.  Returns 0 or a CUDA error code.
inline int make_map_2d_bf16(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                            uint64_t ld_bytes, uint32_t box_rows, uint32_t box_cols) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
