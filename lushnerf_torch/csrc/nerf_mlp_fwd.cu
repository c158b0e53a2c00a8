// Fused NeRF-MLP forward for Hopper (sm_90a): positional encoding + the
// 8x256 scene MLP with skip at layer 4 + alpha / feature / views / rgb heads.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// lushnerf_tpu/ops/fused/nerf_mlp.py (launched by `_fwd_call`, entry
// `eval_points_fused`), forward output only: the activation stash that the
// TPU kernel can also emit for its backward comes with the backward kernel.
//
// Per point (xd = [x, y, z, dx, dy, dz, 0, 0]):
//   pe_x = posenc(xyz, nfx), pe_d = posenc(dir, nfd)   (identity, then
//          [sin(2^j v), cos(2^j v)] blocks; sinf/cosf, never the fast
//          intrinsics: arguments reach |x| ~ 800 in NDC at nfx = 10)
//   a0 = relu(pe_x W0 + b0); a_l = relu(a_{l-1} W_l + b_l), l = 1..4
//   a5 = relu(pe_x W5a + a4 W5b + b5)      (skip concat as one K = 64+256
//                                           accumulation; the plain version
//                                           adds two partial products, so
//                                           the sums differ in order only)
//   a6, a7 as a1; alpha = a7 Wa + ba; feat = a7 Wf + bf
//   hv = relu(feat Wvf + pe_d Wvd + bv); rgb = hv Wr + br
//   out[p] = [rgb, alpha]                  ([P, 4] float32)
//
// Two modes, chosen per launch:
//   bf16: every matmul input (PE, activations, weights) is rounded to bf16,
//         products accumulate in f32, bias and relu in f32 -- the rounding
//         points of the TPU kernel's bfloat16 mode.  Tensor cores
//         (mma.sync m16n8k16, bf16 in, f32 accumulate).
//   f32:  IEEE float32 FMAs throughout (no TF32).
//
// What bounds it: compute.  1,186,816 FLOP per point against 48 bytes of
// input and output, far above the card's ~295 FLOP/byte ridge; the weights
// (1.19 MB in bf16) are re-read from L2 by every tile.  The TPU kernel kept
// all weights resident in VMEM; an SM has 227 KB of shared memory, so here
// a tile of 128 points keeps its activations in shared memory (one bf16
// buffer, rewritten in place once a layer's accumulators are complete) and
// streams each layer's weights through a two-stage cp.async ring in
// K-chunks of 32, so the next chunk's load overlaps the current chunk's
// mma.  Eight warps split each layer's output as 2 (points) x 4 (neurons).
// The two heads with 1 and 3 outputs are warp-reduced dot products.
// wgmma/TMA and a persistent schedule are later work.
//
// Weight blob (row-major [out][in], bf16 or f32, K padded with zero
// columns; kx = round_up(pe_x channels, 32), kd = round_up(pe_d channels,
// 32)):  W0 [256][kx] | W1..W4 [256][256] | W5 [256][kx + 256] (pe_x part,
// then a4 part) | W6, W7 [256][256] | Wf [256][256] | Wv [128][256 + kd]
// (feat part, then pe_d part).  The f32 blob `fp` holds biases and the two
// small heads at the FP_* offsets below (head weights pre-rounded to bf16
// in bf16 mode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W = 256;         // scene MLP width
constexpr int WH = 128;        // views layer width
constexpr int PE_MAX = 128;    // kx + kd
constexpr int KC = 32;         // K-chunk of the weight ring
constexpr int NTHREADS = 256;  // 8 warps
constexpr int NWARPS = NTHREADS / 32;

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
  static constexpr int T = 128;
  static constexpr int ACT_LD = W + 8;       // 132 words: conflict-free frags
  static constexpr int PE_LD = PE_MAX + 8;   // 68 words
  static constexpr int WST_LD = KC + 8;      // 20 words
  static constexpr int SMEM = (T * ACT_LD + T * PE_LD) * 2 + T * 8 * 4 +
                              2 * W * WST_LD * 2;
};
template <> struct Tile<false> {
  typedef float T_act;
  static constexpr int T = 64;
  static constexpr int ACT_LD = W + 4;
  static constexpr int PE_LD = PE_MAX + 4;
  static constexpr int SMEM = (T * ACT_LD + T * PE_LD) * 4 + T * 8 * 4;
};

template <typename WT> struct Args {
  const float* xd;   // [P, 8]
  const float* fp;   // biases and heads
  const WT* w[10];   // W0..W7, Wf, Wv inside the weight blob
  float* out;        // [P, 4]
  int P, kx, kd, nfx, nfd;
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// bf16 tensor-core path
// ---------------------------------------------------------------------------

// One K-chunk (N rows x 32 columns) of a [N][ldw] bf16 weight into a stage.
template <int N>
__device__ __forceinline__ void load_wchunk(bf16* st, const bf16* Wg, int ldw, int col0) {
  constexpr int LD = Tile<true>::WST_LD;
  for (int i = threadIdx.x; i < N * 4; i += NTHREADS) {
    const int r = i >> 2, q = i & 3;
    cp_async16(st + r * LD + q * 8, Wg + (size_t)r * ldw + col0 + q * 8);
  }
}

// acc += A[:, 0:K] . Wg[:, w_col0 : w_col0 + K]^T for this warp's
// 64 rows x N/4 columns.  Ends with a barrier: every read of A and of the
// weight stages is done when it returns.
template <int N>
__device__ __forceinline__ void gemm_bf16(float (&acc)[4][N / 32][4], const bf16* A,
                                          int lda, const bf16* Wg, int ldw,
                                          int w_col0, int K, bf16* wst) {
  constexpr int NT = N / 32;
  constexpr int LD = Tile<true>::WST_LD;
  constexpr int STAGE = W * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int nch = K / KC;

  load_wchunk<N>(wst, Wg, ldw, w_col0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const bf16* cur = wst + (c & 1) * STAGE;
    if (c + 1 < nch) {
      load_wchunk<N>(wst + ((c + 1) & 1) * STAGE, Wg, ldw, w_col0 + (c + 1) * KC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* ap = A + (wm * 64 + mt * 16 + g) * lda + c * KC + ks + 2 * t;
        af[mt][0] = ld32(ap);
        af[mt][1] = ld32(ap + 8 * lda);
        af[mt][2] = ld32(ap + 8);
        af[mt][3] = ld32(ap + 8 * lda + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* bp = cur + (wn * (N / 4) + nt * 8 + g) * LD + ks + 2 * t;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }
}

template <int N>
__device__ __forceinline__ void epilogue_bf16(const float (&acc)[4][N / 32][4],
                                              const float* bias, bool relu,
                                              bf16* dst, int ldd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < N / 32; ++nt) {
      const int r = wm * 64 + mt * 16 + g;
      const int col = wn * (N / 4) + nt * 8 + 2 * t;
      const float c0 = bias[col], c1 = bias[col + 1];
      float v0 = acc[mt][nt][0] + c0, v1 = acc[mt][nt][1] + c1;
      float v2 = acc[mt][nt][2] + c0, v3 = acc[mt][nt][3] + c1;
      if (relu) {
        v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + r * ldd + col) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * ldd + col) = __floats2bfloat162_rn(v2, v3);
    }
  }
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

// One dense layer: dst = act(A1 . W[:, :K1]^T + A2 . W[:, K1:]^T + bias),
// written in place over the activation buffer (dst may alias A1).
template <bool BF16, int N, typename WT>
__device__ __forceinline__ void dense(const WT* Wg, int ldw,
                                      const typename Tile<BF16>::T_act* A1, int lda1, int K1,
                                      const typename Tile<BF16>::T_act* A2, int lda2, int K2,
                                      const float* bias, bool relu,
                                      typename Tile<BF16>::T_act* dst, WT* wst) {
  if constexpr (BF16) {
    float acc[4][N / 32][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 32; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
    gemm_bf16<N>(acc, A1, lda1, Wg, ldw, 0, K1, wst);
    if (K2 > 0) gemm_bf16<N>(acc, A2, lda2, Wg, ldw, K1, K2, wst);
    epilogue_bf16<N>(acc, bias, relu, dst, Tile<true>::ACT_LD);
  } else {
    float acc[Tile<false>::T * N / NTHREADS];
#pragma unroll
    for (int i = 0; i < Tile<false>::T * N / NTHREADS; ++i) acc[i] = 0.f;
    gemm_f32<N>(acc, A1, lda1, Wg, ldw, 0, K1);
    if (K2 > 0) gemm_f32<N>(acc, A2, lda2, Wg, ldw, K1, K2);
    __syncthreads();
    epilogue_f32<N>(acc, bias, relu, dst, Tile<false>::ACT_LD);
  }
  __syncthreads();
}

__device__ __forceinline__ void load_row(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load_row(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// alpha = a7 . Wa + ba, one warp per point (K = 256: 8 values a lane).
template <int T, int LD, typename AT>
__device__ __forceinline__ void head_alpha(const AT* act, const float* fp, float* out,
                                           int p0, int P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < T; p += NWARPS) {
    float v[8];
    load_row(act + p * LD + lane * 8, v);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(v[j], fp[FP_WA + lane * 8 + j], s);
    s = warp_sum(s);
    if (lane == 0 && p0 + p < P) out[(size_t)(p0 + p) * 4 + 3] = s + fp[FP_BA];
  }
}

// rgb = hv . Wr + br, one warp per point (K = 128: lanes 0..15 take 8 values).
template <int T, int LD, typename AT>
__device__ __forceinline__ void head_rgb(const AT* act, const float* fp, float* out,
                                         int p0, int P) {
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
    if (lane == 0 && p0 + p < P) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out[(size_t)(p0 + p) * 4 + c] = s[c] + fp[FP_BR + c];
    }
  }
}

// Positional encoding of the tile into pe[T][PE_LD]: columns [0, kx) hold
// pe_x (zero past its 3 + 6 nfx channels), [kx, kx + kd) hold pe_d.
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

template <bool BF16, typename WT>
__global__ void __launch_bounds__(NTHREADS, 1) nerf_mlp_fwd_kernel(Args<WT> args) {
  typedef Tile<BF16> TL;
  typedef typename TL::T_act AT;
  constexpr int T = TL::T, ALD = TL::ACT_LD, PLD = TL::PE_LD;
  extern __shared__ __align__(16) unsigned char smem[];
  AT* act = reinterpret_cast<AT*>(smem);
  AT* pe = act + T * ALD;
  float* xs = reinterpret_cast<float*>(pe + T * PLD);
  WT* wst = reinterpret_cast<WT*>(xs + T * 8);  // weight ring (bf16 only)

  const int p0 = blockIdx.x * T;
  const int P = args.P, kx = args.kx, kd = args.kd;
  const float* fp = args.fp;

  for (int i = threadIdx.x; i < T * 2; i += NTHREADS) {
    const int p = i >> 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + p < P) v = __ldg(reinterpret_cast<const float4*>(args.xd + (size_t)(p0 + p) * 8) + (i & 1));
    reinterpret_cast<float4*>(xs + p * 8)[i & 1] = v;
  }
  __syncthreads();
  pe_tile<T, PLD>(pe, xs, kx, kd, args.nfx, args.nfd);
  __syncthreads();

  dense<BF16, W>(args.w[0], kx, pe, PLD, kx, pe, PLD, 0, fp, true, act, wst);
#pragma unroll 1
  for (int l = 1; l <= 4; ++l)
    dense<BF16, W>(args.w[l], W, act, ALD, W, act, ALD, 0, fp + l * W, true, act, wst);
  dense<BF16, W>(args.w[5], kx + W, pe, PLD, kx, act, ALD, W, fp + 5 * W, true, act, wst);
  dense<BF16, W>(args.w[6], W, act, ALD, W, act, ALD, 0, fp + 6 * W, true, act, wst);
  dense<BF16, W>(args.w[7], W, act, ALD, W, act, ALD, 0, fp + 7 * W, true, act, wst);
  // alpha reads a7 before the feature layer's epilogue overwrites it (that
  // epilogue runs only after the feature gemm's barriers)
  head_alpha<T, ALD>(act, fp, args.out, p0, P);
  dense<BF16, W>(args.w[8], W, act, ALD, W, act, ALD, 0, fp + FP_BF, false, act, wst);
  dense<BF16, WH>(args.w[9], W + kd, act, ALD, W, pe + kx, PLD, kd, fp + FP_BV, true, act, wst);
  head_rgb<T, ALD>(act, fp, args.out, p0, P);
}

template <typename WT>
void fill_offsets(Args<WT>& a, const void* w, int kx, int kd) {
  const WT* base = static_cast<const WT*>(w);
  size_t off = 0;
  const size_t sizes[10] = {
      (size_t)W * kx, (size_t)W * W, (size_t)W * W, (size_t)W * W, (size_t)W * W,
      (size_t)W * (kx + W), (size_t)W * W, (size_t)W * W, (size_t)W * W,
      (size_t)WH * (W + kd)};
  for (int i = 0; i < 10; ++i) {
    a.w[i] = base + off;
    off += sizes[i];
  }
}

template <bool BF16, typename WT>
int launch(const float* xd, const void* w, const float* fp, float* out, int P,
           int kx, int kd, int nfx, int nfd, cudaStream_t stream) {
  typedef Tile<BF16> TL;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(nerf_mlp_fwd_kernel<BF16, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  Args<WT> a;
  a.xd = xd;
  a.fp = fp;
  a.out = out;
  a.P = P;
  a.kx = kx;
  a.kd = kd;
  a.nfx = nfx;
  a.nfd = nfd;
  fill_offsets(a, w, kx, kd);
  const int grid = (P + TL::T - 1) / TL::T;
  nerf_mlp_fwd_kernel<BF16, WT><<<grid, NTHREADS, TL::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of elements of the weight blob and of the f32 blob for (kx, kd);
// the Python packer checks its layout against these.
long long nerf_mlp_fwd_w_numel(int kx, int kd) {
  return (long long)W * kx + 7LL * W * W + (long long)W * (kx + W) + (long long)WH * (W + kd);
}
long long nerf_mlp_fwd_fp_numel() { return FP_NUMEL; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = OK).
// Requires P > 0, kx and kd multiples of 32 with kx + kd <= 128,
// 3 + 6 * nfx <= kx and 3 + 6 * nfd <= kd; all pointers 16-byte aligned.
int nerf_mlp_fwd(const float* xd, const void* w, const float* fp, float* out, int P,
                 int kx, int kd, int nfx, int nfd, int bf16_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_mode)
    return launch<true, bf16>(xd, w, fp, out, P, kx, kd, nfx, nfd, s);
  return launch<false, float>(xd, w, fp, out, P, kx, kd, nfx, nfd, s);
}

const char* nerf_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
