// Fused NeRF-MLP backward for Hopper (sm_90a), its second half: the weight
// grads of all scene-MLP parameters, summed over the points, and the two
// fixed-order reductions, after the dgrad of nerf_mlp_dgrad.cu.
//
// Replaces, with that dgrad, the Pallas TPU kernels `_bwd_stash_kernel`
// (activations read from the forward's stash) and `_bwd_kernel`
// (activations recomputed) of lushnerf_tpu/ops/fused/nerf_mlp.py (one
// `pallas_call` in `_bwd_call`, the custom VJP's `_fused_bwd`).  Both
// compute `_bwd_math`:
//   d_hv  = (g_rgb Wr) * [hv > 0]
//   d_feat = d_hv Wvf;   d_a7 = d_feat Wf + g_alpha Wa;  d_z7 = d_a7 * [a7 > 0]
//   d_z6 = (d_z7 W7) * [a6 > 0] ... d_z4 = (d_z5 W5b) * [a4 > 0] ...
//   d_z0 = (d_z1 W1) * [a0 > 0]
//   d_pe = d_z0 W0 + d_z5 W5a + d_hv Wvd, then d(xd) through the PE
//          derivative (d sin(2^j x) = 2^j cos(2^j x) dx; sincosf, as the
//          forward uses sinf/cosf)
//   dW = A^T dZ for the 14 weight blocks, db = column sums of dZ.
// Rounding points of the bf16 mode, as the TPU kernel's: every matmul input
// (g, each d_z, activations, PE, weights) is rounded to bf16, products
// accumulate in f32; bias grads sum the unrounded f32 d_z; relu masks test
// the stored activation (a > 0).  In f32 the dgrad's products are the
// split (three fp16 products of two parts each, nerf_mlp_dgrad.cu) and the
// wgrad's IEEE f32 FMAs (no TF32).
//
// The TPU kernel summed the weight grads in VMEM across its sequential
// grid.  Blocks on this card run in no order, so the backward is three
// kernels, all with fixed summation orders (two runs give the same bits):
//   1. dgrad (nerf_mlp_dgrad.cu, wgmma, both modes): a loop over point
//      tiles, one block per SM, writing the PE to a scratch `pe`, every d_z
//      to the scratch `dz`, the bias grads and the two small heads' weight
//      grads (K = 3 and 1) into per-block partials, and d(xd);
//   2. wgrad: dW = dZ^T A for the 12 weight blocks of the weight blob in
//      one launch: one block per 128 x 128 output tile and point split,
//      A and dZ staged row-major with cp.async and read transposed by
//      ldmatrix.trans (bf16) or as f32 FMAs (f32); per-split f32 partials;
//   3. reduce (twice): the partials summed in split / block order.
// The remat backward (K3) is the stash backward on a stash that the
// forward kernel writes into scratch first (lushnerf_torch/ops/fused/
// nerf_mlp.py), so the two give the same bits.
// What bounds the wgrad: operations (1,186,816 FLOP per point; bf16 tensor
// rate, or f32 FMAs) against its reads of dz, the stash and the PE.
//
// Layouts of the weight blob, the f32 blob and the stash:
// nerf_mlp_common.cuh.  The weight grad `dw` has the weight blob's layout
// in f32; the f32-blob grad `dfp` has the f32 blob's layout (bias grads and
// the two heads' weight grads).

#include "nerf_mlp_common.cuh"

namespace {

using namespace nerf_mlp;

// ---------------------------------------------------------------------------
// wgrad: dW[o][i] = sum_p dZ[p][o] A[p][i], split over the points
// ---------------------------------------------------------------------------

constexpr int N_JOBS = 12;
constexpr int MAX_TILES = 48;
constexpr int WG_KT = 32;            // points per stage
constexpr int WG_LD_B = 128 + 8;     // bf16 stage row: 68 words, ldmatrix conflict-free
constexpr int WG_LD_F = 128 + 4;

struct WJob {
  long long out_off;  // the block's first element in the weight blob
  int O, I;           // rows (outputs of the layer) and columns (its inputs)
  int z_col;          // dZ column in the dz scratch
  int a_pe;           // A from the pe scratch (1) or from acts (0)
  int a_col;          // A column
  int ldw;            // row length of the matrix in the blob
};

template <typename AT> struct WgradArgs {
  const AT* dz;
  const AT* acts;
  const AT* pe;
  float* part;        // [n_splits][w_numel]
  long long part_stride;
  int P, pts_per_split, pe_ld;
  WJob jobs[N_JOBS];
  unsigned char tile_job[MAX_TILES];
  short tile_o0[MAX_TILES], tile_i0[MAX_TILES];
};

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool fill) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// One stage: WG_KT points x 128 columns of dZ (at o0) and of A (at i0; zero
// past the block's I columns and past k_end) into row-major [WG_KT][LD].
template <typename AT, int LD>
__device__ __forceinline__ void wgrad_stage(AT* sz, AT* sa, const WgradArgs<AT>& a,
                                            const WJob& job, const AT* asrc, int a_ld,
                                            int o0, int i0, int k0, int k_end) {
  constexpr int V = 16 / sizeof(AT);
  constexpr int CH = WG_KT * (128 / V);
  for (int c = threadIdx.x; c < 2 * CH; c += NTHREADS) {
    const bool is_a = c >= CH;
    const int cc = is_a ? c - CH : c;
    const int p = cc / (128 / V), q = (cc % (128 / V)) * V;
    const bool in_k = k0 + p < k_end;
    if (!is_a) {
      const AT* src = in_k ? a.dz + (size_t)(k0 + p) * ACTS_LD + job.z_col + o0 + q : a.dz;
      cp_async16_zfill(sz + p * LD + q, src, in_k);
    } else {
      const bool ok = in_k && i0 + q < job.I;
      const AT* src = ok ? asrc + (size_t)(k0 + p) * a_ld + job.a_col + i0 + q : asrc;
      cp_async16_zfill(sa + p * LD + q, src, ok);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(NTHREADS, 2) nerf_mlp_bwd_wgrad_bf16(WgradArgs<bf16> a) {
  __shared__ __align__(16) bf16 sz[2][WG_KT * WG_LD_B];
  __shared__ __align__(16) bf16 sa[2][WG_KT * WG_LD_B];
  const WJob job = a.jobs[a.tile_job[blockIdx.x]];
  const int o0 = a.tile_o0[blockIdx.x], i0 = a.tile_i0[blockIdx.x];
  const int k_begin = blockIdx.y * a.pts_per_split;
  const int k_end = min(a.P, k_begin + a.pts_per_split);
  const bf16* asrc = job.a_pe ? a.pe : a.acts;
  const int a_ld = job.a_pe ? a.pe_ld : ACTS_LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 o x 32 i
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, rr = lane & 7;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  const int nk = k_end > k_begin ? (k_end - k_begin + WG_KT - 1) / WG_KT : 0;
  if (nk > 0)
    wgrad_stage<bf16, WG_LD_B>(sz[0], sa[0], a, job, asrc, a_ld, o0, i0, k_begin, k_end);
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      wgrad_stage<bf16, WG_LD_B>(sz[(it + 1) & 1], sa[(it + 1) & 1], a, job, asrc, a_ld, o0, i0,
                                 k_begin + (it + 1) * WG_KT, k_end);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* z = sz[it & 1];
    const bf16* x = sa[it & 1];
#pragma unroll
    for (int ks = 0; ks < WG_KT; ks += 16) {
      // A fragments (rows o, k = points) from dZ stored [k][o]; B fragments
      // (k = points, columns i) from A stored [k][i]: both transposed by
      // ldmatrix.trans
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(af[mt], z + (ks + rr + ((mi >> 1) << 3)) * WG_LD_B + wm * 64 + mt * 16 +
                              ((mi & 1) << 3));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, x + (ks + rr + ((mi & 1) << 3)) * WG_LD_B + wn * 32 + np * 16 +
                           ((mi >> 1) << 3));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }
  float* out = a.part + (size_t)blockIdx.y * a.part_stride + job.out_off;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + wm * 64 + mt * 16 + g + 8 * h;
        const int i = i0 + wn * 32 + nt * 8 + 2 * t;
        if (i < job.I) {
          out[(size_t)o * job.ldw + i] = acc[mt][nt][2 * h];
          out[(size_t)o * job.ldw + i + 1] = acc[mt][nt][2 * h + 1];
        }
      }
}

__global__ void __launch_bounds__(NTHREADS) nerf_mlp_bwd_wgrad_f32(WgradArgs<float> a) {
  __shared__ __align__(16) float sz[WG_KT * WG_LD_F];
  __shared__ __align__(16) float sa[WG_KT * WG_LD_F];
  const WJob job = a.jobs[a.tile_job[blockIdx.x]];
  const int o0 = a.tile_o0[blockIdx.x], i0 = a.tile_i0[blockIdx.x];
  const int k_begin = blockIdx.y * a.pts_per_split;
  const int k_end = min(a.P, k_begin + a.pts_per_split);
  const float* asrc = job.a_pe ? a.pe : a.acts;
  const int a_ld = job.a_pe ? a.pe_ld : ACTS_LD;
  const int to = threadIdx.x >> 4, ti = threadIdx.x & 15;  // 8 o x 8 i a thread

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += WG_KT) {
    wgrad_stage<float, WG_LD_F>(sz, sa, a, job, asrc, a_ld, o0, i0, k0, k_end);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < WG_KT; ++k) {
      float zv[8], xv[8];
      *reinterpret_cast<float4*>(zv) = *reinterpret_cast<const float4*>(sz + k * WG_LD_F + to * 8);
      *reinterpret_cast<float4*>(zv + 4) =
          *reinterpret_cast<const float4*>(sz + k * WG_LD_F + to * 8 + 4);
      *reinterpret_cast<float4*>(xv) = *reinterpret_cast<const float4*>(sa + k * WG_LD_F + ti * 8);
      *reinterpret_cast<float4*>(xv + 4) =
          *reinterpret_cast<const float4*>(sa + k * WG_LD_F + ti * 8 + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(zv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = a.part + (size_t)blockIdx.y * a.part_stride + job.out_off;
  if (i0 + ti * 8 < job.I) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[(size_t)(o0 + to * 8 + i) * job.ldw + i0 + ti * 8 + j] = acc[i][j];
  }
}

// out[n] = sum over r of in[r][n], in order of r
__global__ void nerf_mlp_bwd_reduce(const float* in, int R, long long N, float* out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += in[(size_t)r * N + n];
  out[n] = s;
}

// The 12 weight blocks of the weight blob and their 128 x 128 tiles.
template <typename AT>
int fill_jobs(WgradArgs<AT>& a, int kx, int kd) {
  long long off[10];
  {
    const long long sizes[10] = {(long long)W * kx, W * W, W * W, W * W, W * W,
                                 (long long)W * (kx + W), W * W, W * W, W * W,
                                 (long long)WH * (W + kd)};
    long long o = 0;
    for (int i = 0; i < 10; ++i) {
      off[i] = o;
      o += sizes[i];
    }
  }
  const WJob jobs[N_JOBS] = {
      {off[0], W, kx, 0, 1, 0, kx},                   // W0: d_z0, pe_x
      {off[1], W, W, 1 * W, 0, 0 * W, W},             // W1: d_z1, a0
      {off[2], W, W, 2 * W, 0, 1 * W, W},
      {off[3], W, W, 3 * W, 0, 2 * W, W},
      {off[4], W, W, 4 * W, 0, 3 * W, W},
      {off[5], W, kx, 5 * W, 1, 0, kx + W},           // W5a: d_z5, pe_x
      {off[5] + kx, W, W, 5 * W, 0, 4 * W, kx + W},   // W5b: d_z5, a4
      {off[6], W, W, 6 * W, 0, 5 * W, W},
      {off[7], W, W, 7 * W, 0, 6 * W, W},
      {off[8], W, W, 8 * W, 0, 7 * W, W},             // Wf: d_feat, a7
      {off[9], WH, W, 9 * W, 0, 8 * W, W + kd},       // Wvf: d_hv, feat
      {off[9] + W, WH, kd, 9 * W, 1, kx, W + kd},     // Wvd: d_hv, pe_d
  };
  int n = 0;
  for (int j = 0; j < N_JOBS; ++j) {
    a.jobs[j] = jobs[j];
    for (int o0 = 0; o0 < jobs[j].O; o0 += 128)
      for (int i0 = 0; i0 < jobs[j].I; i0 += 128) {
        if (n >= MAX_TILES) return -1;
        a.tile_job[n] = (unsigned char)j;
        a.tile_o0[n] = (short)o0;
        a.tile_i0[n] = (short)i0;
        ++n;
      }
  }
  return n;
}

// The wgrad and the two reductions of the mode's backward, on the dz, pe
// and fp_part of a dgrad (nerf_mlp_dgrad.cu) that ran before.
template <bool BF16>
int launch_bwd(const void* acts, const void* dz, const void* pe, float* fp_part, float* w_part,
               float* dw, float* dfp, int P, int kx, int kd, int n_blocks, int n_splits,
               cudaStream_t stream) {
  typedef typename Tile<BF16>::T_act AT;
  cudaError_t e;
  WgradArgs<AT> wa;
  wa.dz = static_cast<const AT*>(dz);
  wa.acts = static_cast<const AT*>(acts);
  wa.pe = static_cast<const AT*>(pe);
  wa.part = w_part;
  wa.part_stride = w_numel(kx, kd);
  wa.P = P;
  wa.pts_per_split = ((P + n_splits - 1) / n_splits + WG_KT - 1) / WG_KT * WG_KT;
  wa.pe_ld = kx + kd;
  const int ntiles = fill_jobs(wa, kx, kd);
  if (ntiles < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(ntiles, n_splits);
  if constexpr (BF16)
    nerf_mlp_bwd_wgrad_bf16<<<grid, NTHREADS, 0, stream>>>(wa);
  else
    nerf_mlp_bwd_wgrad_f32<<<grid, NTHREADS, 0, stream>>>(wa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long wn = w_numel(kx, kd);
  nerf_mlp_bwd_reduce<<<(unsigned)((wn + 255) / 256), 256, 0, stream>>>(w_part, n_splits, wn, dw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nerf_mlp_bwd_reduce<<<(FP_NUMEL + 255) / 256, 256, 0, stream>>>(fp_part, n_blocks, FP_NUMEL, dfp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long nerf_mlp_bwd_w_numel(int kx, int kd) { return w_numel(kx, kd); }
long long nerf_mlp_bwd_fp_numel() { return FP_NUMEL; }
long long nerf_mlp_bwd_acts_ld() { return ACTS_LD; }
// The backward of nerf_mlp_fwd on `stream` after its dgrad
// (nerf_mlp_dgrad.cu): the wgrad and the two reductions on the dgrad's dz,
// pe and fp_part.  Returns the first cudaGetLastError() that is not 0,
// else 0.
//   acts [P, ACTS_LD] the stash, dz [P, ACTS_LD] and pe [P, kx + kd]
//   scratch, in the compute dtype; fp_part [n_blocks, FP_NUMEL] and w_part
//   [n_splits, w_numel] f32 scratch; dw [w_numel] and dfp [FP_NUMEL] f32 out.
// n_blocks: the dgrad's blocks (rows of fp_part); n_splits: point splits of
// the wgrad.  Requires what nerf_mlp_fwd requires.
int nerf_mlp_bwd(const void* acts, const void* dz, const void* pe, float* fp_part, float* w_part,
                 float* dw, float* dfp, int P, int kx, int kd, int bf16_mode, int n_blocks,
                 int n_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_mode)
    return launch_bwd<true>(acts, dz, pe, fp_part, w_part, dw, dfp, P, kx, kd, n_blocks, n_splits, s);
  return launch_bwd<false>(acts, dz, pe, fp_part, w_part, dw, dfp, P, kx, kd, n_blocks, n_splits, s);
}

const char* nerf_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
