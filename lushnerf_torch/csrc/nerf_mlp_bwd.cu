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
// the stored activation (a > 0).  In f32 both halves' products are the
// split: three fp16 products of two parts each into an f32 accumulator
// (nerf_mlp_dgrad.cu, and the f32 wgrad below).
//
// The TPU kernel summed the weight grads in VMEM across its sequential
// grid.  Blocks on this card run in no order, so the backward is three
// kernels, all with fixed summation orders (two runs give the same bits):
//   1. dgrad (nerf_mlp_dgrad.cu, wgmma, both modes): a loop over point
//      tiles, one block per SM, writing the PE to a scratch `pe`, every d_z
//      to the scratch `dz`, the bias grads and the two small heads' weight
//      grads (K = 3 and 1) into per-block partials, and d(xd); in f32 also
//      the scale units of dz (`zs`, below);
//   2. wgrad: dW = dZ^T A for the 12 weight blocks of the weight blob in
//      one launch, per point split into f32 partials: bf16 one block per
//      128 x 128 output tile and split, A and dZ staged row-major with
//      cp.async and read transposed by ldmatrix.trans into mma.sync; f32 on
//      wgmma (below);
//   3. reduce (twice): the partials summed in split / block order.
// The remat backward (K3) is the stash backward on a stash that the
// forward kernel writes into scratch first (lushnerf_torch/ops/fused/
// nerf_mlp.py), so the two give the same bits.
// What bounds the wgrad: in bf16 operations (1,186,816 FLOP per point at
// the bf16 tensor rate) against its reads of dz, the stash and the PE; in
// f32 bytes (below).
//
// Layouts of the weight blob, the f32 blob and the stash:
// nerf_mlp_common.cuh.  The weight grad `dw` has the weight blob's layout
// in f32; the f32-blob grad `dfp` has the f32 blob's layout (bias grads and
// the two heads' weight grads).

#include "hopper.cuh"
#include "nerf_mlp_common.cuh"

// The f32 wgrad's shared memory: at file scope, so that every address in it
// is a constant.
extern __shared__ __align__(1024) unsigned char wsmem[];

namespace {

using namespace nerf_mlp;
using namespace hopper;

// ---------------------------------------------------------------------------
// wgrad: dW[o][i] = sum_p dZ[p][o] A[p][i], split over the points
// ---------------------------------------------------------------------------

constexpr int N_JOBS = 12;
constexpr int MAX_TILES = 48;
constexpr int WG_KT = 32;            // points per stage
constexpr int WG_LD_B = 128 + 8;     // bf16 stage row: 68 words, ldmatrix conflict-free

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

// ---------------------------------------------------------------------------
// the f32 wgrad: the split on wgmma
// ---------------------------------------------------------------------------
//
// Replaces, in f32 mode, the weight-grad half of `_bwd_math` (the `grads`
// of `dotT(a, d_z)` at Precision.HIGHEST, lushnerf_tpu/ops/fused/
// nerf_mlp.py:554-575, summed over the point tiles by `_acc_grads` :576).
//
// What bounds it: bytes.  Per point it reads 9,728 B of dz, 9,216 B of f32
// stash (a0..a7, feat) and 4 (kx + kd) B of PE: 3.8 ms at P = 655,360,
// against 2.4 ms for the split's three fp16 products of 778 GFLOP at the
// tensor rate.  The design also writes and reads back one f32 partial of
// the weight grads per point split (2.4 MB each).
//
// The split: each product dZ^T A is hi(Z) hi(A) + lo(Z) hi(A) + hi(Z)
// lo(A) in one f32 accumulator, hi = fp16(x) and lo = fp16(x - hi).  The
// activations and the PE are split as they are (|a| < 65504, as K1 f32
// splits them).  dz is not: the cotangents reaching a scene MLP lie below
// fp16's smallest normal, and the accumulator sums over the points, whose
// rows the dgrad scaled one by one.  So the dgrad writes, for each 128-point
// tile, each dz block (d_z0..d_z7, d_feat, d_hv) and each of its three PE
// warps, the scale unit U of the rows it stored (`zs` [tiles][10][3]): the
// largest 2^-r over the nonzero rows, r the power of two that puts the row's
// largest |value| in [2^14, 2^15), or 0 if every row is zero; every |dz|
// of those rows is then below 2^15 U.  A work item takes the largest U over
// the tiles its split touches and splits dz / U: its largest value lies in
// [2^14, 2^15), and a value 2^k below it keeps ~22 bits down to k = 17 and
// an absolute error of 2^-25 U beneath.  Its partial is the accumulator
// times U (exact).  The scales are powers of two taken from the data, so g
// 2^k gives 2^k times every grad, bit for bit.
//
// Design: a persistent grid (one block an SM) over work items, each an
// output tile of 128 rows o (a layer's outputs) by all of its I <= 256
// columns i (its inputs) and one point split: the 17 tiles of width 256
// for every split first, then the 5 narrow ones (W0, W5a: I = kx, Wvd: I
// = kd; N = I rounded up to 64, zero columns past I).  A warpgroup of
// converters reads each stage of 32 points of dz (128 columns) and of A
// (N columns) in f32 from global memory, as whole 512-byte and 1 KB row
// pieces, splits them and writes both parts into shared memory in the
// MN-major 128-byte swizzle that wgmma reads (points as K, o or i as MN:
// dz and A are read as they lie, [points][columns]; the transposed layout
// is open to 16-bit types only); two consumer warpgroups, 64 rows o each,
// run three m64nNk16 per 16 points through a ring of four 48 KB stages on
// mbarriers and store their tile's partial.  With the split's K at ~5,000
// points at the flagship sizes (132 splits), the tensor core's own
// accumulation error stays well inside the f32 limit (0.3 of it, PERF.md).
// What holds it is the converters' global loads (their stage is ~2x the
// matmuls'): built without the matmuls it runs ~5.5 ms at P = 655,360,
// without the loads ~3.4 (scripts/wgrad_ablate.py).  L2 prefetches (by
// the converters or the consumers), cp.async into a staging ring and finer
// load pipelines measured slower, a ring of TMA-loaded f32 stages no
// faster (PERF.md).

namespace f32w {
constexpr int KS = 32;                 // points a stage
constexpr int KG = KS / 8;             // 8-point atoms a stage along K
constexpr int ATOM = 1024;             // [8 points][64 columns] fp16, 128-byte swizzle
constexpr int Z_PART = 2 * KG * ATOM;  // dz's 128 columns, one part (8 KB)
constexpr int A_PART = 4 * KG * ATOM;  // up to 256 columns of A, one part (16 KB)
constexpr int S_ZH = 0, S_ZL = Z_PART, S_AH = 2 * Z_PART, S_AL = S_AH + A_PART;
constexpr int STAGE_B = S_AL + A_PART;  // 48 KB
constexpr int NST = 4;                  // ring stages
constexpr int NCONS = 256;              // two consumer warpgroups
constexpr int NCONV = 128;              // and a warpgroup of converters
constexpr int NTHR = NCONS + NCONV;
constexpr int SM_SCALE = NST * STAGE_B;    // [NST] f32: the U of the item a stage belongs to
constexpr int SM_RED = SM_SCALE + NST * 4;  // [2][4] f32: the converter warps' largest U
constexpr int SM_BARS = SM_RED + 8 * 4;    // mbarriers: FULL + s, EMPTY + s
enum { FULL = 0, EMPTY = NST, N_BARS = 2 * NST };
constexpr int SMEM = SM_BARS + N_BARS * 8;
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may use");
constexpr int BAR_CONV = 1;   // named barrier of the converters
constexpr int N_TILES = 22;   // 17 of width 256, then 5 narrow
constexpr int ZT = 128;       // points a tile of the dgrad, whose scale units zs holds
constexpr int ZB = 10;        // dz blocks in zs: d_z0..d_z7, d_feat, d_hv
constexpr int ZW = 3;         // entries a tile and block: the dgrad's PE warps
// block 0's cycles, by thread 0 of the consumers and of the converters
// (nerf_mlp.WGRAD_F32_CLOCKS): waiting for a full stage, issuing and
// waiting for the matmuls, storing partials, all; issuing a stage's loads,
// waiting for a free stage, the items' scales, splitting and storing a
// stage (with the wait for its loads), all
enum { C_FULL, C_MM, C_EPI, C_ALL, V_LOAD, V_EMPTY, V_SCALE, V_WORK, V_ALL, N_CLK };

struct WTile {
  long long out_off;  // element (o0, 0) of the tile's block in the weight layout
  int ldw;            // the block's row length there
  int z_col;          // dz column of the tile's row o0
  int zb;             // dz block (its scale units in zs)
  int a_pe, a_col;    // A from the PE scratch (1) or the stash (0), from column a_col
};

struct Args {
  const float* dz;     // [P, ACTS_LD]
  const float* acts;   // [P, ACTS_LD] the f32 stash
  const float* pe;     // [P, pe_ld]
  const float* zs;     // [ceil(P / ZT)][ZB][ZW] the dgrad's scale units
  float* part;         // [n_splits][w_numel]
  long long* clk;      // [N_CLK] or null
  long long part_stride;
  int P, pts_per_split, pe_ld, n_splits, n_items, kx, kd;
  WTile tiles[N_TILES];
};

__device__ __forceinline__ uint64_t* wbar(int i) {
  return reinterpret_cast<uint64_t*>(wsmem + SM_BARS) + i;
}
__device__ __forceinline__ float* wf32(int off) { return reinterpret_cast<float*>(wsmem + off); }
__device__ __forceinline__ float pow2(int r) { return __int_as_float((127 + r) << 23); }

// Item `it`: every split's wide tiles, then every split's narrow ones (W0,
// W5a: kx columns, Wvd: kd).  Returns the tile's columns I.
__device__ __forceinline__ int item_of(const Args& a, int it, int& tile, int& split) {
  constexpr int NW = 17, NN = N_TILES - NW;
  if (it < NW * a.n_splits) {
    split = it / NW;
    tile = it % NW;
    return W;
  }
  it -= NW * a.n_splits;
  split = it / NN;
  tile = NW + it % NN;
  return tile < N_TILES - 1 ? a.kx : a.kd;
}

__device__ __forceinline__ int split_stages(const Args& a, int split, int& k0, int& k1) {
  k0 = split * a.pts_per_split;
  k1 = min(a.P, k0 + a.pts_per_split);
  return k1 > k0 ? (k1 - k0 + KS - 1) / KS : 0;
}

template <bool PROF> struct Clock {
  long long c[N_CLK];
  long long t;
  bool on;
  __device__ __forceinline__ Clock(const Args& a) : t(0), on(PROF && blockIdx.x == 0 && a.clk) {
    for (int i = 0; i < N_CLK; ++i) c[i] = 0;
  }
  __device__ __forceinline__ void start() {
    if constexpr (PROF) t = clock64();
  }
  __device__ __forceinline__ void stop(int i) {
    if constexpr (PROF) c[i] += clock64() - t;
  }
};

template <int N>
__device__ __forceinline__ void mma_mn(float (&acc)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) wgmma_m64n256k16<N / 2, true, true>(acc, da, db, 1);
  else if constexpr (N == 128) wgmma_m64n128k16<N / 2, true, true>(acc, da, db, 1);
  else wgmma_m64n64k16<N / 2, true, true>(acc, da, db, 1);
}

// A consumer warpgroup's part of one item: its 64 rows o of the tile by N
// columns over the split's stages, then its partial times U.
template <int N, bool PROF>
__device__ __forceinline__ void consume(const Args& a, const WTile& t, int I, int split, int& kst,
                                        Clock<PROF>& ck) {
  constexpr int R = N / 2;
  const int wg = threadIdx.x >> 7;
  int k0, k1;
  const int nst = split_stages(a, split, k0, k1);
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  float down = 1.f;
  auto release = [&](int k) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(wbar(EMPTY + k % NST));
  };

#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    const int k = kst + st, s = k % NST;
    ck.start();
    mbar_wait(wbar(FULL + s), (k / NST) & 1);
    ck.stop(C_FULL);
    ck.start();
    if (st == 0) down = wf32(SM_SCALE)[s];
    const unsigned char* base = wsmem + s * STAGE_B;
    wgmma_fence();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      const int off = ks * 2 * ATOM;
      const uint64_t zh = wgmma_desc_mn(base + S_ZH + wg * KG * ATOM + off, KG * ATOM, ATOM);
      const uint64_t zl = wgmma_desc_mn(base + S_ZL + wg * KG * ATOM + off, KG * ATOM, ATOM);
      const uint64_t ah = wgmma_desc_mn(base + S_AH + off, KG * ATOM, ATOM);
      const uint64_t al = wgmma_desc_mn(base + S_AL + off, KG * ATOM, ATOM);
      mma_mn<N>(acc, zh, ah);
      mma_mn<N>(acc, zl, ah);
      mma_mn<N>(acc, zh, al);
    }
    wgmma_commit();
    if (st > 0) {  // the stage before is read
      wgmma_wait<1>();
      release(k - 1);
    }
    ck.stop(C_MM);
  }
  ck.start();
  wgmma_wait<0>();
  if (nst > 0) release(kst + nst - 1);
  wgmma_fence_regs(acc);
  kst += nst;
  // acc[4 j + 2 rr + c]: row 16 warp + lane / 4 + 8 rr, column 8 j + 2 (lane % 4) + c
  const int lane = threadIdx.x & 31, col0 = 2 * (lane & 3);
  float* out = a.part + (size_t)split * a.part_stride + t.out_off +
               (size_t)(64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2)) * t.ldw;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (8 * j >= I) break;  // (I is a multiple of 32: the warp takes the branch as one)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      __stcs(reinterpret_cast<float2*>(out + (size_t)(8 * rr) * t.ldw + 8 * j + col0),
             make_float2(acc[4 * j + 2 * rr] * down, acc[4 * j + 2 * rr + 1] * down));
  }
  ck.stop(C_EPI);
}

// 8 consecutive columns (c % 8 == 0) of point row k, times sc, in their fp16
// parts into the stage's hi and lo copies of an MN-major operand.
__device__ __forceinline__ void put_parts(unsigned char* hi, unsigned char* lo, int k, int c,
                                          const float4 (&v)[2], float sc) {
  const float x[8] = {v[0].x * sc, v[0].y * sc, v[0].z * sc, v[0].w * sc,
                      v[1].x * sc, v[1].y * sc, v[1].z * sc, v[1].w * sc};
  uint32_t ph[4], pl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ph[i] = pack_f16(x[2 * i], x[2 * i + 1]);
    const float2 h = unpack_f16(ph[i]);
    pl[i] = pack_f16(x[2 * i] - h.x, x[2 * i + 1] - h.y);
  }
  const int off = ((c >> 6) * KG + (k >> 3)) * ATOM + (k & 7) * 128 + ((((c >> 3) & 7) ^ (k & 7)) << 4);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(ph[0], ph[1], ph[2], ph[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(pl[0], pl[1], pl[2], pl[3]);
}

// The converters' part of one item: the split's scale, then each stage of
// 32 points: dz's 128 columns of the tile (times 1 / U) and A's N columns
// (zero past I and past the split), split into the ring.  A thread's share
// of a stage is NZ + NA pieces of 8 columns of a row (two float4 each); it
// issues all of their loads before it waits for the stage to be free.
template <int N, bool PROF>
__device__ __forceinline__ void convert(const Args& a, const WTile& t, int I, int split, int& kst,
                                        int& nit, Clock<PROF>& ck) {
  constexpr int NZ = KS * 16 / NCONV;       // 8-column pieces of dz a thread a stage
  constexpr int NA = KS * (N / 8) / NCONV;  // and of A
  const int u = threadIdx.x - NCONS;
  int k0, k1;
  const int nst = split_stages(a, split, k0, k1);
  if (nst == 0) return;
  ck.start();
  // U: the largest scale unit over the dgrad tiles the split touches
  const int t0 = k0 / ZT, n = ((k1 - 1) / ZT - t0 + 1) * ZW;
  float m = 0.f;
  for (int e = u; e < n; e += NCONV)
    m = fmaxf(m, __ldg(a.zs + ((size_t)(t0 + e / ZW) * ZB + t.zb) * ZW + e % ZW));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float* red = wf32(SM_RED) + (nit & 1) * 4;
  if ((u & 31) == 0) red[u >> 5] = m;
  named_bar(BAR_CONV, NCONV);
  m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  ++nit;
  // U = 2^e (or 0: every d_z of the split is zero, any scale will do)
  const int e = m > 0.f ? ((__float_as_int(m) >> 23) & 255) - 127 : 0;
  const float up = pow2(-e), down = pow2(e);
  ck.stop(V_SCALE);
  const float* asrc = t.a_pe ? a.pe : a.acts;
  const int a_ld = t.a_pe ? a.pe_ld : ACTS_LD;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int st = 0; st < nst; ++st, ++kst) {
    const int s = kst % NST, p0 = k0 + st * KS;
    ck.start();
    float4 zv[NZ][2], av[NA][2];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      const int q = u + NCONV * i, k = q >> 4, c = (q & 15) * 8;
      const bool ok = p0 + k < k1;
      const float4* src = reinterpret_cast<const float4*>(a.dz + (size_t)(p0 + k) * ACTS_LD + t.z_col + c);
      zv[i][0] = ok ? __ldg(src) : zero;
      zv[i][1] = ok ? __ldg(src + 1) : zero;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int q = u + NCONV * i, k = q / (N / 8), c = (q % (N / 8)) * 8;
      const bool ok = p0 + k < k1 && c < I;
      const float4* src = reinterpret_cast<const float4*>(asrc + (size_t)(p0 + k) * a_ld + t.a_col + c);
      av[i][0] = ok ? __ldg(src) : zero;
      av[i][1] = ok ? __ldg(src + 1) : zero;
    }
    ck.stop(V_LOAD);
    ck.start();
    mbar_wait(wbar(EMPTY + s), ((kst / NST) & 1) ^ 1);
    ck.stop(V_EMPTY);
    ck.start();
    unsigned char* base = wsmem + s * STAGE_B;
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      const int q = u + NCONV * i;
      put_parts(base + S_ZH, base + S_ZL, q >> 4, (q & 15) * 8, zv[i], up);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int q = u + NCONV * i;
      put_parts(base + S_AH, base + S_AL, q / (N / 8), (q % (N / 8)) * 8, av[i], 1.f);
    }
    if (u == 0) wf32(SM_SCALE)[s] = down;
    fence_proxy_async();
    mbar_arrive(wbar(FULL + s));
    ck.stop(V_WORK);
  }
}

template <bool PROF>
__global__ void __launch_bounds__(NTHR, 1)
    nerf_mlp_bwd_wgrad_f32_sm90(const __grid_constant__ Args a) {
  if (smem_u32(wsmem) & 1023) __trap();  // the swizzled operands need 1024-byte alignment
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(wbar(FULL + s), NCONV);
      mbar_init(wbar(EMPTY + s), NCONS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  Clock<PROF> ck(a);
  const long long t_all = PROF ? clock64() : 0;
  int kst = 0;  // stages of the ring taken so far
  if (threadIdx.x < NCONS) {
#pragma unroll 1
    for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
      int tile, split;
      const int I = item_of(a, it, tile, split);
      const WTile t = a.tiles[tile];
      if (I > 128) consume<256>(a, t, I, split, kst, ck);
      else if (I > 64) consume<128>(a, t, I, split, kst, ck);
      else consume<64>(a, t, I, split, kst, ck);
    }
    if constexpr (PROF) {
      if (ck.on && threadIdx.x == 0) {
        ck.c[C_ALL] = clock64() - t_all;
        for (int i = C_FULL; i <= C_ALL; ++i) a.clk[i] = ck.c[i];
      }
    }
  } else {
    int nit = 0;
#pragma unroll 1
    for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
      int tile, split;
      const int I = item_of(a, it, tile, split);
      const WTile t = a.tiles[tile];
      if (I > 128) convert<256>(a, t, I, split, kst, nit, ck);
      else if (I > 64) convert<128>(a, t, I, split, kst, nit, ck);
      else convert<64>(a, t, I, split, kst, nit, ck);
    }
    if constexpr (PROF) {
      if (ck.on && threadIdx.x == NCONS) {
        ck.c[V_ALL] = clock64() - t_all;
        for (int i = V_LOAD; i <= V_ALL; ++i) a.clk[i] = ck.c[i];
      }
    }
  }
}
}  // namespace f32w

// out[n] = sum over r of in[r][n], in order of r
__global__ void nerf_mlp_bwd_reduce(const float* in, int R, long long N, float* out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += in[(size_t)r * N + n];
  out[n] = s;
}

// The 12 weight blocks of the weight blob.
void make_jobs(WJob (&jobs)[N_JOBS], int kx, int kd) {
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
  const WJob all[N_JOBS] = {
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
  for (int j = 0; j < N_JOBS; ++j) jobs[j] = all[j];
}

// The bf16 wgrad's 128 x 128 tiles of those blocks.
int fill_jobs(WgradArgs<bf16>& a, int kx, int kd) {
  make_jobs(a.jobs, kx, kd);
  int n = 0;
  for (int j = 0; j < N_JOBS; ++j)
    for (int o0 = 0; o0 < a.jobs[j].O; o0 += 128)
      for (int i0 = 0; i0 < a.jobs[j].I; i0 += 128) {
        if (n >= MAX_TILES) return -1;
        a.tile_job[n] = (unsigned char)j;
        a.tile_o0[n] = (short)o0;
        a.tile_i0[n] = (short)i0;
        ++n;
      }
  return n;
}

// The f32 wgrad's tiles: 128 rows of a block by all of its columns, the
// blocks of width 256 first.
int fill_tiles_f32(f32w::Args& a, int kx, int kd) {
  WJob jobs[N_JOBS];
  make_jobs(jobs, kx, kd);
  int n = 0;
  for (int wide = 1; wide >= 0; --wide)
    for (int j = 0; j < N_JOBS; ++j) {
      if ((jobs[j].I == W) != (wide == 1)) continue;
      for (int o0 = 0; o0 < jobs[j].O; o0 += 128) {
        if (n >= f32w::N_TILES) return -1;
        f32w::WTile& t = a.tiles[n++];
        t.out_off = jobs[j].out_off + (long long)o0 * jobs[j].ldw;
        t.ldw = jobs[j].ldw;
        t.z_col = jobs[j].z_col + o0;
        t.zb = jobs[j].z_col / W;
        t.a_pe = jobs[j].a_pe;
        t.a_col = jobs[j].a_col;
      }
    }
  return n == f32w::N_TILES ? n : -1;
}

int pts_per_split(int P, int n_splits) {
  return ((P + n_splits - 1) / n_splits + WG_KT - 1) / WG_KT * WG_KT;
}

int launch_wgrad_bf16(const void* acts, const void* dz, const void* pe, float* w_part, int P,
                      int kx, int kd, int n_splits, cudaStream_t stream) {
  WgradArgs<bf16> wa;
  wa.dz = static_cast<const bf16*>(dz);
  wa.acts = static_cast<const bf16*>(acts);
  wa.pe = static_cast<const bf16*>(pe);
  wa.part = w_part;
  wa.part_stride = w_numel(kx, kd);
  wa.P = P;
  wa.pts_per_split = pts_per_split(P, n_splits);
  wa.pe_ld = kx + kd;
  const int ntiles = fill_jobs(wa, kx, kd);
  if (ntiles < 0) return (int)cudaErrorInvalidValue;
  nerf_mlp_bwd_wgrad_bf16<<<dim3(ntiles, n_splits), NTHREADS, 0, stream>>>(wa);
  return (int)cudaGetLastError();
}

int launch_wgrad_f32(const void* acts, const void* dz, const void* pe, const float* zs,
                     float* w_part, long long* clk, int P, int kx, int kd, int n_splits,
                     int n_wblocks, cudaStream_t stream) {
  if (zs == nullptr || n_wblocks <= 0) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(f32w::nerf_mlp_bwd_wgrad_f32_sm90<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, f32w::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(f32w::nerf_mlp_bwd_wgrad_f32_sm90<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, f32w::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  f32w::Args wa;
  wa.dz = static_cast<const float*>(dz);
  wa.acts = static_cast<const float*>(acts);
  wa.pe = static_cast<const float*>(pe);
  wa.zs = zs;
  wa.part = w_part;
  wa.clk = clk;
  wa.part_stride = w_numel(kx, kd);
  wa.P = P;
  wa.pts_per_split = pts_per_split(P, n_splits);
  wa.pe_ld = kx + kd;
  wa.n_splits = n_splits;
  if (fill_tiles_f32(wa, kx, kd) < 0) return (int)cudaErrorInvalidValue;
  wa.n_items = f32w::N_TILES * n_splits;
  wa.kx = kx;
  wa.kd = kd;
  const int grid = n_wblocks < wa.n_items ? n_wblocks : wa.n_items;
  if (clk != nullptr)
    f32w::nerf_mlp_bwd_wgrad_f32_sm90<true><<<grid, f32w::NTHR, f32w::SMEM, stream>>>(wa);
  else
    f32w::nerf_mlp_bwd_wgrad_f32_sm90<false><<<grid, f32w::NTHR, f32w::SMEM, stream>>>(wa);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long nerf_mlp_bwd_w_numel(int kx, int kd) { return w_numel(kx, kd); }
long long nerf_mlp_bwd_fp_numel() { return FP_NUMEL; }
long long nerf_mlp_bwd_acts_ld() { return ACTS_LD; }
// The f32 wgrad's scale units: points a tile, dz blocks, entries a tile and
// block; and the cycle counts of its instrumented instantiation.
int nerf_mlp_bwd_zs_shape(int i) {
  const int shape[4] = {f32w::ZT, f32w::ZB, f32w::ZW, f32w::N_CLK};
  return i >= 0 && i < 4 ? shape[i] : -1;
}
// The backward of nerf_mlp_fwd on `stream` after its dgrad
// (nerf_mlp_dgrad.cu): the wgrad and the two reductions on the dgrad's dz,
// pe and fp_part.  Returns the first cudaGetLastError() that is not 0,
// else 0.
//   acts [P, ACTS_LD] the stash, dz [P, ACTS_LD] and pe [P, kx + kd]
//   scratch, in the compute dtype; zs (f32 only) the dgrad's scale units
//   [ceil(P / 128)][10][3]; fp_part [n_blocks, FP_NUMEL] and w_part
//   [n_splits, w_numel] f32 scratch; dw [w_numel] and dfp [FP_NUMEL] f32
//   out; clk (f32 only) null or [N_CLK] int64 (the instrumented wgrad).
// n_blocks: the dgrad's blocks (rows of fp_part); n_splits: point splits of
// the wgrad; n_wblocks: the f32 wgrad's persistent grid (at most one block
// an SM).  Requires what nerf_mlp_fwd requires.
int nerf_mlp_bwd(const void* acts, const void* dz, const void* pe, const float* zs, float* fp_part,
                 float* w_part, float* dw, float* dfp, long long* clk, int P, int kx, int kd,
                 int bf16_mode, int n_blocks, int n_splits, int n_wblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = bf16_mode ? launch_wgrad_bf16(acts, dz, pe, w_part, P, kx, kd, n_splits, s)
                     : launch_wgrad_f32(acts, dz, pe, zs, w_part, clk, P, kx, kd, n_splits,
                                        n_wblocks, s);
  if (rc != 0) return rc;
  const long long wn = w_numel(kx, kd);
  nerf_mlp_bwd_reduce<<<(unsigned)((wn + 255) / 256), 256, 0, s>>>(w_part, n_splits, wn, dw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nerf_mlp_bwd_reduce<<<(FP_NUMEL + 255) / 256, 256, 0, s>>>(fp_part, n_blocks, FP_NUMEL, dfp);
  return (int)cudaGetLastError();
}

const char* nerf_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
