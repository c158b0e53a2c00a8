// Fused NeRF-MLP backward for Hopper (sm_90a): d(xd) and the grads of all
// scene-MLP parameters, summed over the points, for the forward of
// nerf_mlp_fwd.cu.
//
// Replaces the Pallas TPU kernels `_bwd_stash_kernel` (activations read
// from the forward's stash) and `_bwd_kernel` (activations recomputed) of
// lushnerf_tpu/ops/fused/nerf_mlp.py (one `pallas_call` in `_bwd_call`,
// the custom VJP's `_fused_bwd`).  Both compute `_bwd_math`:
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
// the stored activation (a > 0).  The f32 mode is IEEE f32 FMAs (no TF32).
//
// The TPU kernel summed the weight grads in VMEM across its sequential
// grid.  Blocks on this card run in no order, so the backward is three
// kernels, all with fixed summation orders (two runs give the same bits):
//   1. dgrad: a loop over point tiles, one block per SM: the PE of the tile
//      (stored to a scratch `pe`), then the dgrad chain above, writing
//      every d_z (rounded) to the scratch `dz`, summing bias grads and the
//      two small heads' weight grads (K = 3 and 1) into per-block partials,
//      and writing d(xd).  bf16: nerf_mlp_dgrad.cu (wgmma, TMA).  f32: the
//      kernel below, 64-point tiles in shared memory, FMA matmuls, the
//      mask's stash rows prefetched into L2 while each matmul runs.
//   2. wgrad: dW = dZ^T A for the 12 weight blocks of the weight blob in
//      one launch: one block per 128 x 128 output tile and point split,
//      A and dZ staged row-major with cp.async and read transposed by
//      ldmatrix.trans; per-split f32 partials.
//   3. reduce (twice): the partials summed in split / block order.
// The remat backward (K3) is the stash backward on a stash that the
// forward kernel writes into scratch first (lushnerf_torch/ops/fused/
// nerf_mlp.py), so the two give the same bits.
// What bounds it: operations (2 x 1,186,816 FLOP per point) against 4,864 B
// per point of stash in bf16.  The design also moves the dz scratch (4,864
// B per point written and read again) and the wgrad partials; that traffic
// is not part of the bound.
//
// Layouts of the weight blob, the f32 blob and the stash:
// nerf_mlp_common.cuh.  The transposed blob `wt` holds, each [in][out]
// row-major:  W0^T [kx][256] | W1^T..W4^T [256][256] | W5a^T [kx][256] |
// W5b^T [256][256] | W6^T, W7^T, Wf^T [256][256] | Wvf^T [256][128] |
// Wvd^T [kd][128] (f32 here; the bf16 dgrad takes the same blocks
// chunk-major and swizzled, nerf_mlp_dgrad.cu).  The weight grad `dw` has
// the weight blob's layout in f32; the f32-blob grad `dfp` has the f32
// blob's layout (bias grads and the two heads' weight grads).

#include "nerf_mlp_common.cuh"

namespace {

using namespace nerf_mlp;

enum { T_W0, T_W1, T_W2, T_W3, T_W4, T_W5A, T_W5B, T_W6, T_W7, T_WF, T_WVF, T_WVD, N_WT };

// The f32 dgrad's tile: 64 points, rows of W + 4 (activations) floats.
constexpr int FT = Tile<false>::T;
constexpr int F_ALD = Tile<false>::ACT_LD;
constexpr int F_PLD = Tile<false>::PE_LD;
constexpr int DPE_LD = PE_MAX + 4;

struct BwdArgs {
  const float* xd;  // [P, 8]
  const float* g;   // [P, 4] cotangent of [rgb, alpha]
  const float* fp;  // biases and heads
  const float* wt[N_WT];
  const float* acts;  // [P, ACTS_LD]: the stash
  float* dz;          // [P, ACTS_LD]: d_z0..d_z7, d_feat, d_hv
  float* pe;          // [P, kx + kd]
  float* dxd;         // [P, 8]
  float* fp_part;     // [gridDim.x, FP_NUMEL]
  int P, kx, kd, nfx, nfd, ntiles;
};

// Rows [p0, min(p0 + FT, P)) of `ncols` stash columns at `col` into L2, one
// prefetch per 32-byte sector, so that the loads that follow a matmul find
// them there.
__device__ __forceinline__ void prefetch_rows(const float* acts, int col, int ncols, int p0, int P) {
  constexpr int E = 8;  // floats per sector
  const int per_row = ncols / E;
  for (int i = threadIdx.x; i < FT * per_row; i += NTHREADS) {
    const int p = i / per_row, c = (i % per_row) * E;
    if (p0 + p < P)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(acts + (size_t)(p0 + p) * ACTS_LD + col + c));
  }
}

struct BwdSmem {
  static constexpr int DZS = FT * F_ALD * 4;
  static constexpr int PE_B = FT * F_PLD * 4;
  static constexpr int DPE_B = FT * DPE_LD * 4;
  static constexpr int UNION = PE_B > DPE_B ? PE_B : DPE_B;
  static constexpr int BYTES = DZS + UNION + FT * 8 * 4 + FT * 4 * 4 + 2 * W * 4 + FP_NUMEL * 4;
  float* dzs;   // [FT][F_ALD]: the dgrad chain's current d_z
  float* pe;    // [FT][F_PLD]: the tile's PE (aliases dpe)
  float* dpe;   // [FT][DPE_LD]: d_pe
  float* xs;    // [FT][8]
  float* gs;    // [FT][4]
  float* red;   // [2 * W]: column-sum staging
  float* facc;  // [FP_NUMEL]: this block's f32-blob grads
  __device__ explicit BwdSmem(unsigned char* s) {
    dzs = reinterpret_cast<float*>(s);
    pe = reinterpret_cast<float*>(s + DZS);
    dpe = reinterpret_cast<float*>(s + DZS);
    xs = reinterpret_cast<float*>(s + DZS + UNION);
    gs = xs + FT * 8;
    red = gs + FT * 4;
    facc = red + 2 * W;
  }
};

// The dgrad epilogue of one layer of width N: v = acc (+ g_alpha Wa when
// `alpha`), times the relu mask of the activation at stash column
// `act_col` (no mask when act_col < 0).  v goes to the shared tile, its
// column sums to facc[bias_off].
template <int N>
__device__ __forceinline__ void dgrad_epilogue(const float (&acc)[FT * N / NTHREADS], BwdSmem& s,
                                               const BwdArgs& a, int p0, int act_col, bool alpha,
                                               int bias_off) {
  constexpr int PP = FT * N / NTHREADS;
  const int n = threadIdx.x % N, grp = threadIdx.x / N;
  const float wa = alpha ? a.fp[FP_WA + n] : 0.f;
  float cs = 0.f;
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    const int r = grp * PP + i;
    float v = acc[i];
    if (alpha) v = fmaf(s.gs[r * 4 + 3], wa, v);
    if (act_col >= 0) {
      const float m = p0 + r < a.P ? a.acts[(size_t)(p0 + r) * ACTS_LD + act_col + n] : 0.f;
      v = m > 0.f ? v : 0.f;
    }
    s.dzs[r * F_ALD + n] = v;
    cs += v;
  }
  s.red[threadIdx.x] = cs;  // = red[grp * N + n]
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += NTHREADS) {
    float sum = 0.f;
    for (int gi = 0; gi < NTHREADS / N; ++gi) sum += s.red[gi * N + c];
    s.facc[bias_off + c] += sum;
  }
}

// One layer of the dgrad chain: d_a = dzs . Wg^T (Wg = a transposed weight
// [N][K]), then the epilogue above; dzs is rewritten in place and copied to
// the dz scratch at column dz_col.  The mask's stash rows are prefetched
// into L2 while the matmul runs.
template <int N>
__device__ __forceinline__ void dgrad_layer(const float* Wg, int K, BwdSmem& s, const BwdArgs& a,
                                            int p0, int act_col, bool alpha, int dz_col,
                                            int bias_off) {
  if (act_col >= 0) prefetch_rows(a.acts, act_col, N, p0, a.P);
  float acc[FT * N / NTHREADS];
#pragma unroll
  for (int i = 0; i < FT * N / NTHREADS; ++i) acc[i] = 0.f;
  gemm_f32<N>(acc, s.dzs, F_ALD, Wg, K, 0, K);
  __syncthreads();
  dgrad_epilogue<N>(acc, s, a, p0, act_col, alpha, bias_off);
  // the epilogue ended with a barrier: dzs is complete
  store_rows<FT, F_ALD, N>(s.dzs, a.dz + dz_col, ACTS_LD, p0, a.P);
}

// d_pe[:, col : col + NC] (= or +=) dzs . Wc^T, Wc = [NC][K].
template <int NC>
__device__ __forceinline__ void dpe_chunk(const float* Wc, int K, BwdSmem& s, int col, bool add) {
  constexpr int PP = FT * NC / NTHREADS;
  float acc[PP];
#pragma unroll
  for (int i = 0; i < PP; ++i) acc[i] = 0.f;
  gemm_f32<NC>(acc, s.dzs, F_ALD, Wc, K, 0, K);
  const int n = threadIdx.x % NC, grp = threadIdx.x / NC;
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    float* d = s.dpe + (grp * PP + i) * DPE_LD + col + n;
    *d = (add ? *d : 0.f) + acc[i];
  }
}

// d_pe[:, dpe_col : dpe_col + ncols] (= or +=) dzs . Wg^T, Wg = [ncols][K],
// in column passes of 64 (and one of 32 for an odd multiple of 32).
__device__ __forceinline__ void dpe_layer(const float* Wg, int K, int ncols, BwdSmem& s,
                                          int dpe_col, bool add) {
  int c0 = 0;
  for (; c0 + 64 <= ncols; c0 += 64) dpe_chunk<64>(Wg + (size_t)c0 * K, K, s, dpe_col + c0, add);
  if (c0 < ncols) dpe_chunk<32>(Wg + (size_t)c0 * K, K, s, dpe_col + c0, add);
}

__global__ void __launch_bounds__(NTHREADS, 1) nerf_mlp_bwd_dgrad_f32(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdSmem s(smem);
  const int P = a.P, kx = a.kx, kd = a.kd, ncol = kx + kd;
  const int tid = threadIdx.x;

  for (int c = tid; c < FP_NUMEL; c += NTHREADS) s.facc[c] = 0.f;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int p0 = tile * FT;
    prefetch_rows(a.acts, 7 * W, W, p0, P);  // the heads' stash rows, read after the PE
    prefetch_rows(a.acts, 9 * W, WH, p0, P);
    __syncthreads();  // the previous tile's last reads of xs, gs and dpe are done
    load_xd<FT>(s.xs, a.xd, p0, P);
    for (int i = tid; i < FT; i += NTHREADS) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p0 + i < P) v = __ldg(reinterpret_cast<const float4*>(a.g) + p0 + i);
      reinterpret_cast<float4*>(s.gs)[i] = v;
    }
    __syncthreads();
    pe_tile<FT, F_PLD>(s.pe, s.xs, kx, kd, a.nfx, a.nfd);
    __syncthreads();
    for (int i = tid; i < FT * (ncol / 4); i += NTHREADS) {
      const int p = i / (ncol / 4), c = (i % (ncol / 4)) * 4;
      if (p0 + p < P)
        *reinterpret_cast<float4*>(a.pe + (size_t)(p0 + p) * ncol + c) =
            *reinterpret_cast<const float4*>(s.pe + p * F_PLD + c);
    }
    __syncthreads();

    // d_hv, its bias grad, and the grads of the two small heads (rgb: K = 3
    // from hv; alpha: K = 1 from a7), one thread per column
    {
      const int j = tid;
      if (j < WH) {
        const float wr0 = a.fp[FP_WR + j], wr1 = a.fp[FP_WR + WH + j],
                    wr2 = a.fp[FP_WR + 2 * WH + j];
        float gbv = 0.f, gw0 = 0.f, gw1 = 0.f, gw2 = 0.f;
#pragma unroll 8
        for (int p = 0; p < FT; ++p) {
          const bool valid = p0 + p < P;
          const float hv = valid ? a.acts[(size_t)(p0 + p) * ACTS_LD + 9 * W + j] : 0.f;
          const float g0 = s.gs[p * 4], g1 = s.gs[p * 4 + 1], g2 = s.gs[p * 4 + 2];
          float d = fmaf(g2, wr2, fmaf(g1, wr1, g0 * wr0));
          d = hv > 0.f ? d : 0.f;
          s.dzs[p * F_ALD + j] = d;
          if (valid) a.dz[(size_t)(p0 + p) * ACTS_LD + 9 * W + j] = d;
          gbv += d;
          gw0 = fmaf(g0, hv, gw0);
          gw1 = fmaf(g1, hv, gw1);
          gw2 = fmaf(g2, hv, gw2);
        }
        s.facc[FP_BV + j] += gbv;
        s.facc[FP_WR + j] += gw0;
        s.facc[FP_WR + WH + j] += gw1;
        s.facc[FP_WR + 2 * WH + j] += gw2;
      }
      float gwa = 0.f;  // NTHREADS == W: one a7 column a thread
#pragma unroll 8
      for (int p = 0; p < FT; ++p) {
        const float a7 = p0 + p < P ? a.acts[(size_t)(p0 + p) * ACTS_LD + 7 * W + j] : 0.f;
        gwa = fmaf(s.gs[p * 4 + 3], a7, gwa);
      }
      s.facc[FP_WA + j] += gwa;
      if (j < 4) {
        float sum = 0.f;
        for (int p = 0; p < FT; ++p) sum += s.gs[p * 4 + j];
        s.facc[j < 3 ? FP_BR + j : FP_BA] += sum;
      }
    }
    __syncthreads();

    dpe_layer(a.wt[T_WVD], WH, kd, s, kx, false);                      // d_pe_d
    dgrad_layer<W>(a.wt[T_WVF], WH, s, a, p0, -1, false, 8 * W, FP_BF);  // d_feat
    dgrad_layer<W>(a.wt[T_WF], W, s, a, p0, 7 * W, true, 7 * W, 7 * W);   // d_z7
    dgrad_layer<W>(a.wt[T_W7], W, s, a, p0, 6 * W, false, 6 * W, 6 * W);  // d_z6
    dgrad_layer<W>(a.wt[T_W6], W, s, a, p0, 5 * W, false, 5 * W, 5 * W);  // d_z5
    dpe_layer(a.wt[T_W5A], W, kx, s, 0, false);                        // d_z5 W5a
#pragma unroll 1
    for (int l = 4; l >= 0; --l) {  // d_z4 from W5b, then d_z3..d_z0 from W4..W1
      const float* Wt = a.wt[l == 4 ? T_W5B : T_W1 + l];
      dgrad_layer<W>(Wt, W, s, a, p0, l * W, false, l * W, l * W);
    }
    dpe_layer(a.wt[T_W0], W, kx, s, 0, true);                          // + d_z0 W0
    __syncthreads();

    // d(xd) through the PE: one thread per (point, coordinate)
    for (int idx = tid; idx < FT * 6; idx += NTHREADS) {
      const int p = idx / 6, k = idx - p * 6;
      const bool is_x = k < 3;
      const int comp = is_x ? k : k - 3;
      const int L = is_x ? a.nfx : a.nfd;
      const float* dp = s.dpe + p * DPE_LD + (is_x ? 0 : kx);
      const float v = s.xs[p * 8 + k];
      float acc = dp[comp];
      for (int j = 0; j < L; ++j) {
        const float f = (float)(1 << j);
        float sn, cs;
        sincosf(v * f, &sn, &cs);
        acc = fmaf(f, dp[3 + 6 * j + comp] * cs - dp[6 + 6 * j + comp] * sn, acc);
      }
      if (p0 + p < P) a.dxd[(size_t)(p0 + p) * 8 + k] = acc;
    }
    for (int i = tid; i < FT * 2; i += NTHREADS)
      if (p0 + (i >> 1) < P) a.dxd[(size_t)(p0 + (i >> 1)) * 8 + 6 + (i & 1)] = 0.f;
  }
  __syncthreads();
  for (int c = tid; c < FP_NUMEL; c += NTHREADS)
    a.fp_part[(size_t)blockIdx.x * FP_NUMEL + c] = s.facc[c];
}

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

// The f32 dgrad (parts & 1) and the wgrad with the two reductions (parts &
// 2) of the mode's backward.
template <bool BF16>
int launch_bwd(const float* xd, const float* g, const void* wt, const float* fp, void* acts,
               void* dz, void* pe, float* dxd, float* fp_part, float* w_part, float* dw,
               float* dfp, int P, int kx, int kd, int nfx, int nfd, int n_blocks, int n_splits,
               int parts, cudaStream_t stream) {
  typedef typename Tile<BF16>::T_act AT;
  cudaError_t e;
  if (parts & 1) {
    if constexpr (BF16) {
      return (int)cudaErrorInvalidValue;  // the bf16 dgrad is nerf_mlp_dgrad.cu's
    } else {
      static bool attr_set = false;
      if (!attr_set) {
        e = cudaFuncSetAttribute(nerf_mlp_bwd_dgrad_f32,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::BYTES);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
      }
      BwdArgs a;
      a.xd = xd;
      a.g = g;
      a.fp = fp;
      {
        const float* base = static_cast<const float*>(wt);
        const size_t WW = (size_t)W * W;
        const size_t sizes[N_WT] = {(size_t)kx * W, WW, WW, WW, WW, (size_t)kx * W, WW, WW, WW,
                                    WW, (size_t)W * WH, (size_t)kd * WH};
        size_t off = 0;
        for (int i = 0; i < N_WT; ++i) {
          a.wt[i] = base + off;
          off += sizes[i];
        }
      }
      a.acts = static_cast<const float*>(acts);
      a.dz = static_cast<float*>(dz);
      a.pe = static_cast<float*>(pe);
      a.dxd = dxd;
      a.fp_part = fp_part;
      a.P = P;
      a.kx = kx;
      a.kd = kd;
      a.nfx = nfx;
      a.nfd = nfd;
      a.ntiles = (P + FT - 1) / FT;
      nerf_mlp_bwd_dgrad_f32<<<n_blocks, NTHREADS, BwdSmem::BYTES, stream>>>(a);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (!(parts & 2)) return 0;

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
// Points per tile of the f32 dgrad (the block loops over tiles).
int nerf_mlp_bwd_tile_f32() { return FT; }

// The backward of nerf_mlp_fwd on `stream`, from the forward's stash, but
// for the bf16 dgrad (nerf_mlp_dgrad.cu): parts 1 the f32 dgrad, 2 the
// wgrad and the two reductions (on the dz, pe and fp_part of a dgrad that
// ran before), 3 both.  Returns the first cudaGetLastError() that is not 0,
// else 0.
//   xd [P, 8], g [P, 4] f32; wt the transposed blob (f32 mode); fp the f32
//   blob; acts [P, ACTS_LD] the stash, dz [P, ACTS_LD] and pe [P, kx + kd]
//   scratch, in the compute dtype.
//   dxd [P, 8] out; fp_part [n_blocks, FP_NUMEL] and w_part [n_splits,
//   w_numel] f32 scratch; dw [w_numel] and dfp [FP_NUMEL] f32 out.
// n_blocks: dgrad blocks (each loops over tiles); n_splits: point splits of
// the wgrad.  Requires what nerf_mlp_fwd requires.
int nerf_mlp_bwd(const float* xd, const float* g, const void* wt, const float* fp, void* acts,
                 void* dz, void* pe, float* dxd, float* fp_part, float* w_part, float* dw,
                 float* dfp, int P, int kx, int kd, int nfx, int nfd, int bf16_mode, int n_blocks,
                 int n_splits, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_mode)
    return launch_bwd<true>(xd, g, wt, fp, acts, dz, pe, dxd, fp_part, w_part, dw, dfp, P, kx, kd,
                            nfx, nfd, n_blocks, n_splits, parts, s);
  return launch_bwd<false>(xd, g, wt, fp, acts, dz, pe, dxd, fp_part, w_part, dw, dfp, P, kx, kd,
                           nfx, nfd, n_blocks, n_splits, parts, s);
}

const char* nerf_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
