// Shared device code of the fused NeRF-MLP kernels (nerf_mlp_fwd.cu,
// nerf_mlp_bwd.cu, nerf_mlp_dgrad.cu, nerf_pe_mm.cu): tile shapes, the
// bf16 mma.sync / ldmatrix helpers of the wgrad, the f32 FMA matmul loop
// over one tile of points and the positional encoding of the f32 dgrad.
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
  static constexpr int T = 64;
  static constexpr int ACT_LD = W + 4;
  static constexpr int PE_LD = PE_MAX + 4;
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }

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

// ---------------------------------------------------------------------------
// f32 FMA path
// ---------------------------------------------------------------------------

// acc[i] += A[grp * PP + i, 0:K] . Wg[n, w_col0 : w_col0 + K] for this
// thread's neuron n = tid % N; the warp reads one A row at a time
// (a broadcast), the weights straight from L1/L2.
template <int N>
__device__ __forceinline__ void gemm_f32(float (&acc)[Tile<false>::T * N / NTHREADS],
                                         const float* A, int lda, const float* Wg,
                                         int ldw, int w_col0, int K) {
  constexpr int PP = Tile<false>::T * N / NTHREADS;
  const int n = threadIdx.x % N, grp = threadIdx.x / N;
  const float* wrow = Wg + (size_t)n * ldw + w_col0;
  const float* arow = A + grp * PP * lda;
  for (int k = 0; k < K; k += 4) {
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(wrow + k));
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const float4 a4 = *reinterpret_cast<const float4*>(arow + i * lda + k);
      float s = acc[i];
      s = fmaf(a4.x, w4.x, s);
      s = fmaf(a4.y, w4.y, s);
      s = fmaf(a4.z, w4.z, s);
      s = fmaf(a4.w, w4.w, s);
      acc[i] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// Rows [p0, min(p0 + T, P)) of a [T][LD] shared-memory tile, N columns,
// into a row-major global array at dst (row stride ldd), 16 bytes a thread.
template <int T, int LD, int N, typename AT>
__device__ __forceinline__ void store_rows(const AT* src, AT* dst, int ldd, int p0, int P) {
  constexpr int V = 16 / sizeof(AT);
  for (int i = threadIdx.x; i < T * (N / V); i += NTHREADS) {
    const int p = i / (N / V), c = (i % (N / V)) * V;
    if (p0 + p < P)
      *reinterpret_cast<uint4*>(dst + (size_t)(p0 + p) * ldd + c) =
          *reinterpret_cast<const uint4*>(src + p * LD + c);
  }
}

// Positional encoding of the tile into pe[T][PE_LD]: columns [0, kx) hold
// pe_x (zero past its 3 + 6 nfx channels), [kx, kx + kd) hold pe_d.  xs is
// the tile's packed input [T][8].  sinf/cosf, never the fast intrinsics:
// arguments reach |x| ~ 800 in NDC at nfx = 10.
template <int T, int LD, typename AT>
__device__ __forceinline__ void pe_tile(AT* pe, const float* xs, int kx, int kd,
                                        int nfx, int nfd) {
  const int ncol = kx + kd;
  for (int idx = threadIdx.x; idx < T * ncol; idx += NTHREADS) {
    const int p = idx / ncol, c = idx - p * ncol;
    const bool is_x = c < kx;
    const float* src = xs + p * 8 + (is_x ? 0 : 3);
    const int L = is_x ? nfx : nfd;
    const int local = is_x ? c : c - kx;
    float v = 0.f;
    if (local < 3) {
      v = src[local];
    } else if (local < 3 + 6 * L) {
      const int j = (local - 3) / 6, r = (local - 3) % 6;
      const float a = src[r % 3] * (float)(1 << j);  // exact power-of-two scale
      v = (r < 3) ? sinf(a) : cosf(a);
    }
    put(pe + p * LD + c, v);
  }
}

// The tile's packed input rows [p0, p0 + T) of xd [P][8] into xs[T][8]
// (zeros past P).
template <int T>
__device__ __forceinline__ void load_xd(float* xs, const float* xd, int p0, int P) {
  for (int i = threadIdx.x; i < T * 2; i += NTHREADS) {
    const int p = i >> 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + p < P) v = __ldg(reinterpret_cast<const float4*>(xd + (size_t)(p0 + p) * 8) + (i & 1));
    reinterpret_cast<float4*>(xs + p * 8)[i & 1] = v;
  }
}

inline long long w_numel(int kx, int kd) {
  return (long long)W * kx + 7LL * W * W + (long long)W * (kx + W) + (long long)WH * (W + kd);
}

}  // namespace nerf_mlp
