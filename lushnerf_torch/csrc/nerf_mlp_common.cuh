// Shared device code of the fused NeRF-MLP kernels (nerf_mlp_fwd.cu,
// nerf_mlp_bwd.cu, nerf_mlp_dgrad.cu, nerf_pe_mm.cu): the layouts, the
// stash's element type by mode and the bf16 mma.sync / ldmatrix / cp.async
// helpers of the wgrad.
// The forward's layer sequence (both modes) is nerf_mlp_fwd_sm90.cuh.
//
// The weight grads' layout (row-major [out][in], K padded with zero
// columns; kx = round_up(pe_x channels, 32), kd = round_up(pe_d channels,
// 32)):  W0 [256][kx] | W1..W4 [256][256] | W5 [256][kx + 256] (pe_x part,
// then a4 part) | W6, W7 [256][256] | Wf [256][256] | Wv [128][256 + kd]
// (feat part, then pe_d part); w_numel() counts it.  The forward's weight
// blobs are laid out for wgmma (nerf_mlp_fwd_sm90.cuh).  The f32 blob `fp`
// holds biases and the two small heads at the FP_* offsets below (head
// weights pre-rounded to bf16 in bf16 mode).
//
// Activation stash ([P][ACTS_LD] in the compute dtype, one row per point):
// a0..a7 at columns l * 256, feat at 8 * 256, hv (128 wide) at 9 * 256.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_mlp {

constexpr int W = 256;         // scene MLP width
constexpr int WH = 128;        // views layer width
constexpr int PE_MAX = 128;    // kx + kd
constexpr int NTHREADS = 256;  // 8 warps
constexpr int ACTS_LD = 9 * W + WH;  // stash row: a0..a7, feat, hv

constexpr int FP_BF = 8 * W;         // b0..b7 at l * W
constexpr int FP_BV = FP_BF + W;
constexpr int FP_BA = FP_BV + WH;
constexpr int FP_BR = FP_BA + 4;
constexpr int FP_WA = FP_BR + 4;
constexpr int FP_WR = FP_WA + W;     // [3][WH]
constexpr int FP_NUMEL = FP_WR + 3 * WH;

typedef __nv_bfloat16 bf16;

template <bool BF16> struct Tile;
template <> struct Tile<true> {
  typedef bf16 T_act;
};
template <> struct Tile<false> {
  typedef float T_act;
};

// v rounded to the compute dtype (bf16 mode) or unchanged (f32 mode)
template <bool BF16> __device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix.trans: lane l gives the address of row l % 8 of matrix l / 8
// (16 bytes a row); each thread gets the transposed fragment.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline long long w_numel(int kx, int kd) {
  return (long long)W * kx + 7LL * W * W + (long long)W * (kx + W) + (long long)WH * (W + kd);
}

}  // namespace nerf_mlp
