// Shared device code of the fused NeRF-MLP kernels (nerf_mlp_fwd.cu,
// nerf_mlp_bwd.cu, nerf_mlp_dgrad.cu, nerf_pe_mm.cu): the layouts and the
// bf16 rounding.
// The forward's layer sequence (both modes) is nerf_mlp_fwd_sm90.cuh.
//
// The scene MLP's width W is a compile-time constant: 256 (the default),
// or 128 with -DNERF_MLP_WIDTH=128 (every kernel of the MLP but K5, the
// matmul-only kernel of nerf_pe_mm.cu).  The views layer always has WH = 128
// lanes: W / 2 at width 256; at width 128 its 64 columns padded with zero
// columns (zero weights, bias and rgb-head rows), as the JAX package's
// `pad_params` pads it to 128 lanes, so that its relu output there is 0.
//
// The PE: pe_x of in_ch = 3 + 6 nfx channels and pe_d of d_ch = 3 + 6 nfd,
// in_ch + d_ch <= PE_LANES (the JAX kernels' one 128-lane PE register);
// padded each to kx = round_up(in_ch, 32) and kd = round_up(d_ch, 32) in
// the backward (kx, kd in {32 .. 128}, kx + kd <= PE_PAD_MAX); the
// forward's PE tile: nerf_mlp_fwd_sm90.cuh.
//
// The weight grads' layout (row-major [out][in], K padded with zero
// columns):  W0 [W][kx] | W1..W4 [W][W] | W5 [W][kx + W] (pe_x part, then a4
// part) | W6, W7 [W][W] | Wf [W][W] | Wv [WH][W + kd] (feat part, then
// pe_d part); w_numel() counts it.  The forward's weight blobs are laid
// out for wgmma (nerf_mlp_fwd_sm90.cuh).  The f32 blob `fp` holds biases
// and the two small heads at the FP_* offsets below (head weights
// pre-rounded to bf16 in bf16 mode).
//
// Activation stash ([P][ACTS_LD] in the compute dtype, one row per point):
// a0..a7 at columns l * W, feat at 8 * W, hv (WH wide) at 9 * W.
// Beside the f32 stash K1 writes its scale units ([ceil(P / 128)]
// [UNIT_BLOCKS][UNIT_WARPS] f32): per 128-point tile, block (a0..a7, feat)
// and consumer warp (rows 16 w .. 16 w + 15 of the tile) the largest 2^k
// over its rows before P, k the least k >= 0 that puts the row's largest
// |value| of the block below 2^ROW_SCALE_BITS, the scale at which K1 f32
// splits the row into fp16 parts; the f32 wgrad splits its A with them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_mlp {

#ifndef NERF_MLP_WIDTH
#define NERF_MLP_WIDTH 256
#endif
constexpr int W = NERF_MLP_WIDTH;  // scene MLP width
static_assert(W == 256 || W == 128, "the kernels are written for widths 256 and 128");
constexpr int WH = 128;        // views layer lanes
constexpr int PE_LANES = 128;    // in_ch + d_ch, and the forward's PE tile columns
constexpr int PE_PAD_MAX = 160;  // kx + kd
constexpr int ACTS_LD = 9 * W + WH;  // stash row: a0..a7, feat, hv
constexpr int UNIT_BLOCKS = 9;       // the f32 stash's scale units: a0..a7, feat
constexpr int UNIT_WARPS = 8;        // and K1's consumer warps
constexpr int ROW_SCALE_BITS = 15;   // a row's fp16 parts hold values below 2^15

constexpr int FP_BF = 8 * W;         // b0..b7 at l * W
constexpr int FP_BV = FP_BF + W;
constexpr int FP_BA = FP_BV + WH;
constexpr int FP_BR = FP_BA + 4;
constexpr int FP_WA = FP_BR + 4;
constexpr int FP_WR = FP_WA + W;     // [3][WH]
constexpr int FP_NUMEL = FP_WR + 3 * WH;

typedef __nv_bfloat16 bf16;

// v rounded to the compute dtype (bf16 mode) or unchanged (f32 mode)
template <bool BF16> __device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

inline long long w_numel(int kx, int kd) {
  return (long long)W * kx + 7LL * W * W + (long long)W * (kx + W) + (long long)WH * (W + kd);
}

}  // namespace nerf_mlp
