// Shared device code of the fused NeRF-MLP kernels (nerf_mlp_fwd.cu,
// nerf_mlp_bwd.cu, nerf_mlp_dgrad.cu, nerf_pe_mm.cu): tile shapes, the
// bf16 mma.sync / ldmatrix helpers of the wgrad, the f32 FMA matmul loop
// over one tile of points, the positional encoding, the f32 forward layer
// sequence and its alpha and rgb heads.  The bf16 forward's layer sequence
// is nerf_mlp_fwd_sm90.cuh.
//
// f32 weight blob (row-major [out][in], K padded with zero columns; kx =
// round_up(pe_x channels, 32), kd = round_up(pe_d channels, 32)):  W0
// [256][kx] | W1..W4 [256][256] | W5 [256][kx + 256] (pe_x part, then a4
// part) | W6, W7 [256][256] | Wf [256][256] | Wv [128][256 + kd] (feat
// part, then pe_d part); w_numel() counts it, and the backward's weight
// grads have its layout.  The bf16 blob is laid out for wgmma
// (nerf_mlp_fwd_sm90.cuh).  The f32 blob `fp` holds biases and the two
// small heads at the FP_* offsets below (head weights pre-rounded to bf16
// in bf16 mode).
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
constexpr int NWARPS = NTHREADS / 32;
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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
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

template <int N>
__device__ __forceinline__ void epilogue_f32(const float (&acc)[Tile<false>::T * N / NTHREADS],
                                             const float* bias, bool relu,
                                             float* dst, int ldd) {
  constexpr int PP = Tile<false>::T * N / NTHREADS;
  const int n = threadIdx.x % N, grp = threadIdx.x / N;
  const float b = bias[n];
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    const float v = acc[i] + b;
    dst[(grp * PP + i) * ldd + n] = relu ? fmaxf(v, 0.f) : v;
  }
}

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

// One f32 dense layer: dst = act(A1 . W[:, :K1]^T + A2 . W[:, K1:]^T +
// bias), written in place over the activation buffer (dst may alias A1).
template <int N>
__device__ __forceinline__ void dense(const float* Wg, int ldw, const float* A1, int lda1, int K1,
                                      const float* A2, int lda2, int K2, const float* bias,
                                      bool relu, float* dst) {
  float acc[Tile<false>::T * N / NTHREADS];
#pragma unroll
  for (int i = 0; i < Tile<false>::T * N / NTHREADS; ++i) acc[i] = 0.f;
  gemm_f32<N>(acc, A1, lda1, Wg, ldw, 0, K1);
  if (K2 > 0) gemm_f32<N>(acc, A2, lda2, Wg, ldw, K1, K2);
  __syncthreads();
  epilogue_f32<N>(acc, bias, relu, dst, Tile<false>::ACT_LD);
  __syncthreads();
}

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

// The ten weight matrices inside the weight blob.
template <typename WT>
__host__ __device__ inline void fill_offsets(const WT* (&w)[10], const void* blob, int kx, int kd) {
  const WT* base = static_cast<const WT*>(blob);
  size_t off = 0;
  const size_t sizes[10] = {
      (size_t)W * kx, (size_t)W * W, (size_t)W * W, (size_t)W * W, (size_t)W * W,
      (size_t)W * (kx + W), (size_t)W * W, (size_t)W * W, (size_t)W * W,
      (size_t)WH * (W + kd)};
  for (int i = 0; i < 10; ++i) {
    w[i] = base + off;
    off += sizes[i];
  }
}

inline long long w_numel(int kx, int kd) {
  return (long long)W * kx + 7LL * W * W + (long long)W * (kx + W) + (long long)WH * (W + kd);
}

// The scene MLP's layers in f32 on one tile whose PE is in `pe`: every
// activation is written over `act` in turn (a7, then feat, then hv in its
// first 128 columns).  With `acts` non-null each activation (a0..a7, feat,
// hv) is also stored to the stash rows [p0, min(p0 + T, P)).  `after_a7`
// runs with a7 in `act`, before the feature layer overwrites it.
template <typename F>
__device__ __forceinline__ void forward_tile(const float* const (&w)[10], const float* fp, int kx,
                                             int kd, float* act, const float* pe, float* acts,
                                             int p0, int P, F after_a7) {
  typedef Tile<false> TL;
  constexpr int T = TL::T, ALD = TL::ACT_LD, PLD = TL::PE_LD;
  auto emit = [&](int col) {
    if (acts != nullptr) store_rows<T, ALD, W>(act, acts + col, ACTS_LD, p0, P);
  };
  dense<W>(w[0], kx, pe, PLD, kx, pe, PLD, 0, fp, true, act);
  emit(0);
#pragma unroll 1
  for (int l = 1; l <= 4; ++l) {
    dense<W>(w[l], W, act, ALD, W, act, ALD, 0, fp + l * W, true, act);
    emit(l * W);
  }
  dense<W>(w[5], kx + W, pe, PLD, kx, act, ALD, W, fp + 5 * W, true, act);
  emit(5 * W);
  dense<W>(w[6], W, act, ALD, W, act, ALD, 0, fp + 6 * W, true, act);
  emit(6 * W);
  dense<W>(w[7], W, act, ALD, W, act, ALD, 0, fp + 7 * W, true, act);
  emit(7 * W);
  // reads of a7 here finish before the feature layer's epilogue overwrites
  // it (that epilogue runs only after the feature gemm's barrier)
  after_a7();
  dense<W>(w[8], W, act, ALD, W, act, ALD, 0, fp + FP_BF, false, act);
  emit(8 * W);
  dense<WH>(w[9], W + kd, act, ALD, W, pe + kx, PLD, kd, fp + FP_BV, true, act);
  if (acts != nullptr) store_rows<T, ALD, WH>(act, acts + 9 * W, ACTS_LD, p0, P);
}

__device__ __forceinline__ void load_row(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// alpha = a7 . Wa + ba into out[p * 4 + 3] for the tile's points p < n,
// one warp per point (K = 256: 8 values a lane).
template <int T, int LD, typename AT>
__device__ __forceinline__ void head_alpha(const AT* act, const float* fp, float* out, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < T; p += NWARPS) {
    float v[8];
    load_row(act + p * LD + lane * 8, v);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(v[j], fp[FP_WA + lane * 8 + j], s);
    s = warp_sum(s);
    if (lane == 0 && p < n) out[(size_t)p * 4 + 3] = s + fp[FP_BA];
  }
}

// rgb = hv . Wr + br into out[p * 4 + 0..2] for the tile's points p < n,
// one warp per point (K = 128: lanes 0..15 take 8 values).
template <int T, int LD, typename AT>
__device__ __forceinline__ void head_rgb(const AT* act, const float* fp, float* out, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < T; p += NWARPS) {
    float s[3] = {0.f, 0.f, 0.f};
    if (lane < WH / 8) {
      float v[8];
      load_row(act + p * LD + lane * 8, v);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[c] = fmaf(v[j], fp[FP_WR + c * WH + lane * 8 + j], s[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] = warp_sum(s[c]);
    if (lane == 0 && p < n) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out[(size_t)p * 4 + c] = s[c] + fp[FP_BR + c];
    }
  }
}

// Shared memory of an f32 forward tile: the activation and PE tiles and
// the packed input rows (T x 8 floats).
constexpr int fwd_smem_f32() {
  typedef Tile<false> TL;
  return (TL::T * TL::ACT_LD + TL::T * TL::PE_LD) * 4 + TL::T * 8 * 4;
}

}  // namespace nerf_mlp
