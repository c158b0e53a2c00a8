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
//      one launch, per point split into f32 partials, on wgmma with dZ and
//      A read as they lie (MN-major): bf16 from TMA-loaded stages, f32
//      from the split (below);
//   3. reduce (twice): the partials summed in split / block order.
// The remat backward (K3) is the stash backward on a stash that the
// forward kernel writes into scratch first (lushnerf_torch/ops/fused/
// nerf_mlp.py), so the two give the same bits.
// What bounds the wgrad: in both modes its reads of dz, the stash and the
// PE (below).
//
// Layouts of the weight blob, the f32 blob and the stash:
// nerf_mlp_common.cuh.  The weight grad `dw` has the weight blob's layout
// in f32; the f32-blob grad `dfp` has the f32 blob's layout (bias grads and
// the two heads' weight grads).

#include <algorithm>

#include "hopper.cuh"
#include "nerf_mlp_common.cuh"

// The wgrads' shared memory: at file scope, so that every address in it
// is a constant.
extern __shared__ __align__(1024) unsigned char wsmem[];

namespace {

using namespace nerf_mlp;
using namespace hopper;

// ---------------------------------------------------------------------------
// wgrad: dW[o][i] = sum_p dZ[p][o] A[p][i], split over the points
// ---------------------------------------------------------------------------
//
// Both modes share the output tiles: 128 rows o (a layer's outputs) by all
// of a block's I <= 256 columns i (its inputs), the N_WIDE tiles of width
// W first (17 at width 256), then the narrow ones (W0, W5a: I = kx, Wvd:
// I = kd; 5 at width 256).  At width 128 the views layer's rows are its
// 128 lanes (nerf_mlp_common.cuh), so each of the 12 blocks is one tile: 9
// wide, 3 narrow.  A
// persistent grid takes (tile, point split) work in split-major order, the
// wide tiles of every split first: the f32 wgrad item by item (`item_of`),
// block b taking items b, b + grid, ..., so that both o-halves of a
// weight block's A columns are read close in time; the bf16 wgrad a
// weight block's two halves at once on the two blocks of a cluster
// (`bf16w::unit_of`; at width 128 every block's one tile in two 64-row
// halves).  Each tile sums its split's points in one fixed
// order into f32 registers and stores its partial; the reductions sum the
// partials in split order.

constexpr int N_JOBS = 12;
constexpr int N_WIDE = 8 * (W / 128) + 1;          // W1..W4, W5b, W6, W7, Wf; Wvf
constexpr int N_TILES = N_WIDE + 2 * (W / 128) + 1;  // then W0, W5a; Wvd

struct WJob {
  long long out_off;  // the block's first element in the weight blob
  int O, I;           // rows (outputs of the layer) and columns (its inputs)
  int z_col;          // dZ column in the dz scratch
  int a_pe;           // A from the pe scratch (1) or from acts (0)
  int a_col;          // A column
  int ldw;            // row length of the matrix in the blob
};

struct WTile {
  long long out_off;  // element (o0, 0) of the tile's block in the weight layout
  int ldw;            // the block's row length there
  int z_col;          // dz column of the tile's row o0
  int zb;             // dz block (f32: its scale units in zs)
  int a_pe, a_col;    // A from the PE scratch (1) or the stash (0), from column a_col
};

// Item `it` of the f32 wgrad (or of another `a` with n_splits, kx, kd):
// every split's wide tiles, then every split's narrow ones.  Returns the
// tile's columns I.
template <typename Args>
__host__ __device__ __forceinline__ int item_of(const Args& a, int it, int& tile, int& split) {
  constexpr int NN = N_TILES - N_WIDE;
  if (it < N_WIDE * a.n_splits) {
    split = it / N_WIDE;
    tile = it % N_WIDE;
    return W;
  }
  it -= N_WIDE * a.n_splits;
  split = it / NN;
  tile = N_WIDE + it % NN;
  return tile < N_TILES - 1 ? a.kx : a.kd;
}

// The points [k0, k1) of a split and its stages of KS points (every split
// but the last is a whole number of them).
template <int KS, typename Args>
__device__ __forceinline__ int split_stages(const Args& a, int split, int& k0, int& k1) {
  k0 = split * a.pts_per_split;
  k1 = min(a.P, k0 + a.pts_per_split);
  return k1 > k0 ? (k1 - k0 + KS - 1) / KS : 0;
}

// N cycle counts of block 0 in an instrumented instantiation (PROF).
template <bool PROF, int N> struct Clocks {
  long long c[N];
  long long t;
  bool on;
  __device__ __forceinline__ explicit Clocks(const long long* clk)
      : t(0), on(PROF && blockIdx.x == 0 && clk) {
    for (int i = 0; i < N; ++i) c[i] = 0;
  }
  __device__ __forceinline__ void start() {
    if constexpr (PROF) t = clock64();
  }
  __device__ __forceinline__ void stop(int i) {
    if constexpr (PROF) c[i] += clock64() - t;
  }
};

// A consumer warpgroup's 64 rows of an item's f32 partial (times `down`),
// from row `row0` of the tile: acc[4 j + 2 rr + c] is row 16 warp + lane /
// 4 + 8 rr, column 8 j + 2 (lane % 4) + c of the accumulator of an m64nNk16.
template <int N>
__device__ __forceinline__ void store_partial(float* part, const WTile& t, int I, int row0,
                                              const float (&acc)[N / 2], float down) {
  const int lane = threadIdx.x & 31, col0 = 2 * (lane & 3);
  const int row = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float* out = part + t.out_off + (size_t)row * t.ldw;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (8 * j >= I) break;  // (I is a multiple of 32: the warp takes the branch as one)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      __stcs(reinterpret_cast<float2*>(out + (size_t)(8 * rr) * t.ldw + 8 * j + col0),
             make_float2(acc[4 * j + 2 * rr] * down, acc[4 * j + 2 * rr + 1] * down));
  }
}

// ---------------------------------------------------------------------------
// the bf16 wgrad: TMA-fed wgmma on MN-major bf16 stages, two-block clusters
// ---------------------------------------------------------------------------
//
// Replaces, in bf16 mode, the weight-grad half of `_bwd_math` (`dotT(a,
// d_z)` on bf16 inputs with f32 accumulation, lushnerf_tpu/ops/fused/
// nerf_mlp.py:554-568, summed over the point tiles by `_acc_grads` :576).
//
// What bounds it: bytes.  Per point it reads 4,864 B of dz, 4,608 B of
// stash (a0..a7, feat) and 2 (kx + kd) B of PE: 1.89 ms at P = 655,360,
// against 0.79 ms for its 778 GFLOP at the bf16 tensor rate.  The design
// also writes and reads back one f32 partial of the weight grads per point
// split (2.4 MB each).
//
// Design: dz, the stash and the PE lie [points][columns] in bf16, which is
// wgmma's MN-major layout of a 16-bit operand with the points as K, so no
// thread touches an operand.  Each block's producer thread loads its
// stages by TMA (2-D maps over dz, the stash and the PE; boxes of 64 points
// x 64 columns in the 128-byte swizzle, zeros past P and past the PE's
// columns) into a ring of four 48 KB stages on mbarriers; two consumer
// warpgroups, 64 rows o each, run m64nNk16 (N = I rounded up to 64) with
// dZ^T and A read from the stage through `wgmma_desc_mn` and the transpose
// flags, and store the partial.  The grid is persistent, in clusters of two
// blocks (one an SM) that take the same unit of work at once: the two
// 128-row o-halves of a weight block (or the two 64-row halves of Wvf's and
// Wvd's 128 rows) over one point split.  Each block loads its own dz boxes;
// the A boxes, which both halves read, are loaded once and multicast into
// both blocks' stages (each producer issues half of them), so that A leaves
// device memory once: two blocks that each loaded A drifted apart and read
// much of it twice (PERF.md).  A stage is free when the consumers of both
// blocks have read it.  Units go split by split, the 9 wide ones (I = W)
// of every split first, then the 3 narrow ones (W0, W5a: I = kx; Wvd: I =
// kd).  Every split but the last is a whole number of stages, so a box
// never reaches into the next split.
// At width 128 every weight block is one 128-row tile, so no two tiles
// share their A and a pair of tiles would have nothing to multicast: each
// unit is one tile in the two 64-row halves (one warpgroup of each block
// idle), as Wvf and Wvd are at width 256, so that A is still read once a
// unit.  (One block a tile without the cluster, as the f32 wgrad runs,
// would read A twice as often per tile row.)

namespace bf16w {
constexpr int KS = 64;                    // points a stage: one box deep
constexpr int ATOM = 1024;                // [8 points][64 columns] bf16, 128-byte swizzle
constexpr int BOX_B = KS / 8 * ATOM;      // a box, [64 points][64 columns] (8 KB)
constexpr int S_Z = 0, S_A = 2 * BOX_B;   // dz's 128 columns, then up to 256 of A
constexpr int STAGE_B = S_A + 4 * BOX_B;  // 48 KB
constexpr int NST = 4;                    // ring stages
constexpr int NCONS = 256;                // two consumer warpgroups
constexpr int NTHR = NCONS + 128;         // and a producer warpgroup (one thread issues)
constexpr int CLUSTER = 2;                // blocks a cluster
constexpr int N_UNITS_WIDE = 9, N_UNITS_NARROW = 3;  // units a split
constexpr int SM_BARS = NST * STAGE_B;    // mbarriers: FULL + s, EMPTY + s
enum { FULL = 0, EMPTY = NST, N_BARS = 2 * NST };
constexpr int SMEM = SM_BARS + N_BARS * 8;
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may use");
// block 0's cycles (nerf_mlp.WGRAD_BF16_CLOCKS): consumer thread 0 waiting
// for a full stage, issuing and waiting for the matmuls, storing partials,
// all; the producer thread waiting for a free stage, all
enum { C_FULL, C_MM, C_EPI, C_ALL, L_EMPTY, L_ALL, N_CLK };

struct Args {
  float* part;     // [n_splits][w_numel]
  long long* clk;  // [N_CLK] or null
  long long part_stride;
  int P, pts_per_split, n_splits, n_units, kx, kd;
  WTile tiles[N_TILES];
};

// Unit `u` of a cluster's loop, as block `rank` of the cluster takes it:
// its tile, the split, and whether the two blocks share the tile's 128
// rows (half = 1: block r takes rows 64 r.., with its first warpgroup)
// rather than each take a tile of the pair (width 256 only).  Returns the
// tile's columns I.
template <typename A>
__host__ __device__ __forceinline__ int unit_of(const A& a, int u, int rank, int& tile,
                                                int& split, int& half) {
  int pair;
  if (u < N_UNITS_WIDE * a.n_splits) {
    split = u / N_UNITS_WIDE;
    pair = u % N_UNITS_WIDE;  // W1..W4, W5b, W6, W7, Wf; then Wvf (tile 16)
  } else {
    u -= N_UNITS_WIDE * a.n_splits;
    split = u / N_UNITS_NARROW;
    pair = N_UNITS_WIDE + u % N_UNITS_NARROW;  // W0, W5a; then Wvd (tile 21)
  }
  if constexpr (W == 256) {
    half = pair == N_UNITS_WIDE - 1 || pair == N_UNITS_WIDE + N_UNITS_NARROW - 1;
    tile = 2 * pair - (pair < N_UNITS_WIDE ? 0 : 1) + (half ? 0 : rank);
    return pair < N_UNITS_WIDE ? W : half ? a.kd : a.kx;
  } else {  // width 128: each block one tile, taken in halves
    half = 1;
    tile = pair;
    return pair < N_UNITS_WIDE ? W : pair == N_UNITS_WIDE + N_UNITS_NARROW - 1 ? a.kd : a.kx;
  }
}

__device__ __forceinline__ uint64_t* wbar(int i) {
  return reinterpret_cast<uint64_t*>(wsmem + SM_BARS) + i;
}

template <int N>
__device__ __forceinline__ void mma_mn(float (&acc)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) wgmma_m64n256k16<N / 2, false, true>(acc, da, db, 1);
  else if constexpr (N == 128) wgmma_m64n128k16<N / 2, false, true>(acc, da, db, 1);
  else wgmma_m64n64k16<N / 2, false, true>(acc, da, db, 1);
}

// Stage k read by this warp: one arrival on its free barrier in each
// block of the cluster.
__device__ __forceinline__ void release(int k, uint32_t rank) {
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(wbar(EMPTY + k % NST));
    mbar_arrive_cluster(wbar(EMPTY + k % NST), rank ^ 1);
  }
}

// A consumer warpgroup's part of one unit: its 64 rows o (at dz box `zb`
// of the stage) by N columns over the split's stages, then its partial from
// row `row0` of the tile; or, with `idle` (the other warpgroup of a shared
// tile), only each stage's release.
template <int N, bool PROF>
__device__ __forceinline__ void consume(const Args& a, const WTile& t, int I, int split, int zb,
                                        int row0, bool idle, uint32_t rank, int& kst,
                                        Clocks<PROF, N_CLK>& ck) {
  constexpr int R = N / 2;
  int k0, k1;
  const int nst = split_stages<KS>(a, split, k0, k1);
  if (idle) {
#pragma unroll 1
    for (int st = 0; st < nst; ++st, ++kst) {
      mbar_wait(wbar(FULL + kst % NST), (kst / NST) & 1);
      release(kst, rank);
    }
    return;
  }
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    const int k = kst + st, s = k % NST;
    ck.start();
    mbar_wait(wbar(FULL + s), (k / NST) & 1);
    ck.stop(C_FULL);
    ck.start();
    const unsigned char* base = wsmem + s * STAGE_B;
    wgmma_fence();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {  // a 16-point step is two atoms along K
      const int off = ks * 2 * ATOM;
      mma_mn<N>(acc, wgmma_desc_mn(base + S_Z + zb * BOX_B + off, BOX_B, ATOM),
                wgmma_desc_mn(base + S_A + off, BOX_B, ATOM));
    }
    wgmma_commit();
    if (st > 0) {  // the stage before is read
      wgmma_wait<1>();
      release(k - 1, rank);
    }
    ck.stop(C_MM);
  }
  ck.start();
  wgmma_wait<0>();
  if (nst > 0) release(kst + nst - 1, rank);
  wgmma_fence_regs(acc);
  kst += nst;
  store_partial<N>(a.part + (size_t)split * a.part_stride, t, I, row0, acc, 1.f);
  ck.stop(C_EPI);
}

// The producer thread: each unit's stages into the ring as the consumers of
// both blocks free it, its own dz boxes (two, or one of a shared tile) and
// its half of the A boxes, multicast to both blocks.
template <bool PROF>
__device__ __forceinline__ void produce(const CUtensorMap* tm_dz, const CUtensorMap* tm_acts,
                                        const CUtensorMap* tm_pe, const Args& a, uint32_t rank,
                                        Clocks<PROF, N_CLK>& ck) {
  int kst = 0;  // stages of the ring filled so far
#pragma unroll 1
  for (int u = cluster_index(); u < a.n_units; u += cluster_count()) {
    int tile, split, half, k0, k1;
    const int nb = (unit_of(a, u, rank, tile, split, half) + 63) / 64;
    const WTile& t = a.tiles[tile];
    const CUtensorMap* tm_a = t.a_pe ? tm_pe : tm_acts;
    const int nz = half ? 1 : 2, z_col = t.z_col + (half ? 64 * rank : 0);
    const int nst = split_stages<KS>(a, split, k0, k1);
#pragma unroll 1
    for (int st = 0; st < nst; ++st, ++kst) {
      const int s = kst % NST, p0 = k0 + st * KS;
      ck.start();
      mbar_wait(wbar(EMPTY + s), ((kst / NST) & 1) ^ 1);
      ck.stop(L_EMPTY);
      uint64_t* full = wbar(FULL + s);
      unsigned char* base = wsmem + s * STAGE_B;
      mbar_arrive_expect_tx(full, (nz + nb) * BOX_B);
      for (int b = 0; b < nz; ++b)
        tma_load_2d(base + S_Z + b * BOX_B, tm_dz, z_col + 64 * b, p0, full);
      for (int b = rank; b < nb; b += CLUSTER)
        tma_load_2d_multicast(base + S_A + b * BOX_B, tm_a, t.a_col + 64 * b, p0, full, 3);
    }
  }
}

template <bool PROF>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NTHR, 1)
    nerf_mlp_bwd_wgrad_bf16_sm90(const __grid_constant__ CUtensorMap tm_dz,
                                 const __grid_constant__ CUtensorMap tm_acts,
                                 const __grid_constant__ CUtensorMap tm_pe,
                                 const __grid_constant__ Args a) {
  if (smem_u32(wsmem) & 1023) __trap();  // the swizzled operands need 1024-byte alignment
  const uint32_t rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(wbar(FULL + s), 1);
      mbar_init(wbar(EMPTY + s), CLUSTER * NCONS / 32);
    }
    mbar_fence_init();
  }
  cluster_sync();  // both blocks' barriers are set up before either signals the other's
  Clocks<PROF, N_CLK> ck(a.clk);
  const long long t_all = PROF ? clock64() : 0;
  if (threadIdx.x < NCONS) {
    const int wg = threadIdx.x >> 7;
    int kst = 0;  // stages of the ring taken so far
#pragma unroll 1
    for (int u = cluster_index(); u < a.n_units; u += cluster_count()) {
      int tile, split, half;
      const int I = unit_of(a, u, rank, tile, split, half);
      const WTile t = a.tiles[tile];
      // a tile of its own: warpgroup wg takes rows 64 wg.. (dz box wg); a
      // shared tile: warpgroup 0 takes the block's 64 rows (its one box)
      const int zb = half ? 0 : wg, row0 = half ? 64 * rank : 64 * wg;
      const bool idle = half && wg == 1;
      if (I > 128) consume<256>(a, t, I, split, zb, row0, idle, rank, kst, ck);
      else if (I > 64) consume<128>(a, t, I, split, zb, row0, idle, rank, kst, ck);
      else consume<64>(a, t, I, split, zb, row0, idle, rank, kst, ck);
    }
    if constexpr (PROF) {
      if (ck.on && threadIdx.x == 0) {
        ck.c[C_ALL] = clock64() - t_all;
        for (int i = C_FULL; i <= C_ALL; ++i) a.clk[i] = ck.c[i];
      }
    }
  } else if (threadIdx.x == NCONS) {
    produce(&tm_dz, &tm_acts, &tm_pe, a, rank, ck);
    if constexpr (PROF) {
      if (ck.on) {
        ck.c[L_ALL] = clock64() - t_all;
        for (int i = L_EMPTY; i <= L_ALL; ++i) a.clk[i] = ck.c[i];
      }
    }
  }
  cluster_sync();  // no block leaves while the other may still signal its barriers
}
}  // namespace bf16w

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
// PE is split as it is (|pe| <= max(1, |x|)).  The activations take a scale
// per point split and stash block like dz's below, from the units K1 f32
// writes beside its stash (`au` [tiles][9][8]: per 128-point tile, block
// a0..a7 / feat and consumer warp of K1, the largest 2^k over its rows, k
// the least k >= 0 that puts the row's largest |a| below 2^15, as K1's
// own split takes it): the item splits A / U_A, U_A the largest unit over
// the tiles its split touches, so that no fp16 part overflows, and its
// partial takes U_A back.  Every unit is 1 where |a| < 2^15, and then the
// bits are those without the scale.  dz is not split as it is: the
// cotangents reaching a scene MLP lie below
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
// times U U_A (exact).  The scales are powers of two taken from the data, so g
// 2^k gives 2^k times every grad, bit for bit.
//
// Design: a persistent grid (one block an SM) over work items, each an
// output tile of 128 rows o (a layer's outputs) by all of its I <= 256
// columns i (its inputs) and one point split: the wide tiles (I = W: 17
// at width 256, 9 at 128) for every split first, then the narrow ones
// (W0, W5a: I = kx, Wvd: I = kd; 5 at 256, 3 at 128; N = I rounded up to
// 64, zero columns past I).  A warpgroup of
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
constexpr int SM_SCALE = NST * STAGE_B;    // [NST] f32: U U_A of the item a stage belongs to
constexpr int SM_RED = SM_SCALE + NST * 4;  // [2][2][4] f32: the converter warps' largest U, U_A
constexpr int SM_BARS = SM_RED + 16 * 4;   // mbarriers: FULL + s, EMPTY + s
enum { FULL = 0, EMPTY = NST, N_BARS = 2 * NST };
constexpr int SMEM = SM_BARS + N_BARS * 8;
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may use");
constexpr int BAR_CONV = 1;   // named barrier of the converters
constexpr int ZT = 128;       // points a tile of the dgrad, whose scale units zs holds
constexpr int ZB = 10;        // dz blocks in zs: d_z0..d_z7, d_feat, d_hv
constexpr int ZW = 3;         // entries a tile and block: the dgrad's PE warps
constexpr int AT = 128;       // points a tile of K1, whose scale units au holds
constexpr int AB = UNIT_BLOCKS, AW = UNIT_WARPS;  // au's stash blocks and entries a block
// block 0's cycles, by thread 0 of the consumers and of the converters
// (nerf_mlp.WGRAD_F32_CLOCKS): waiting for a full stage, issuing and
// waiting for the matmuls, storing partials, all; issuing a stage's loads,
// waiting for a free stage, the items' scales, splitting and storing a
// stage (with the wait for its loads), all
enum { C_FULL, C_MM, C_EPI, C_ALL, V_LOAD, V_EMPTY, V_SCALE, V_WORK, V_ALL, N_CLK };

struct Args {
  const float* dz;     // [P, ACTS_LD]
  const float* acts;   // [P, ACTS_LD] the f32 stash
  const float* pe;     // [P, pe_ld]
  const float* zs;     // [ceil(P / ZT)][ZB][ZW] the dgrad's scale units
  const float* au;     // [ceil(P / AT)][AB][AW] K1's scale units of the stash
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

template <bool PROF> using Clock = Clocks<PROF, N_CLK>;

template <int N>
__device__ __forceinline__ void mma_mn(float (&acc)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) wgmma_m64n256k16<N / 2, true, true>(acc, da, db, 1);
  else if constexpr (N == 128) wgmma_m64n128k16<N / 2, true, true>(acc, da, db, 1);
  else wgmma_m64n64k16<N / 2, true, true>(acc, da, db, 1);
}

// A consumer warpgroup's part of one item: its 64 rows o of the tile by N
// columns over the split's stages, then its partial times U U_A.
template <int N, bool PROF>
__device__ __forceinline__ void consume(const Args& a, const WTile& t, int I, int split, int& kst,
                                        Clock<PROF>& ck) {
  constexpr int R = N / 2;
  const int wg = threadIdx.x >> 7;
  int k0, k1;
  const int nst = split_stages<KS>(a, split, k0, k1);
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
  store_partial<N>(a.part + (size_t)split * a.part_stride, t, I, 64 * wg, acc, down);
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

// The converters' part of one item: the split's scales, then each stage of
// 32 points: dz's 128 columns of the tile (times 1 / U) and A's N columns
// (times 1 / U_A; zero past I and past the split), split into the ring.  A thread's share
// of a stage is NZ + NA pieces of 8 columns of a row (two float4 each); it
// issues all of their loads before it waits for the stage to be free.
template <int N, bool PROF>
__device__ __forceinline__ void convert(const Args& a, const WTile& t, int I, int split, int& kst,
                                        int& nit, Clock<PROF>& ck) {
  constexpr int NZ = KS * 16 / NCONV;       // 8-column pieces of dz a thread a stage
  constexpr int NA = KS * (N / 8) / NCONV;  // and of A
  const int u = threadIdx.x - NCONS;
  int k0, k1;
  const int nst = split_stages<KS>(a, split, k0, k1);
  if (nst == 0) return;
  ck.start();
  // U: the largest scale unit over the dgrad tiles the split touches; U_A
  // (1 for the PE): K1's over its tiles, of A's stash block
  const int t0 = k0 / ZT, n = ((k1 - 1) / ZT - t0 + 1) * ZW;
  float m = 0.f, ma = 1.f;
  for (int e = u; e < n; e += NCONV)
    m = fmaxf(m, __ldg(a.zs + ((size_t)(t0 + e / ZW) * ZB + t.zb) * ZW + e % ZW));
  if (!t.a_pe) {
    const int ta = k0 / AT, na = ((k1 - 1) / AT - ta + 1) * AW, ab = t.a_col / W;
    for (int e = u; e < na; e += NCONV)
      ma = fmaxf(ma, __ldg(a.au + ((size_t)(ta + e / AW) * AB + ab) * AW + e % AW));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
  }
  float* red = wf32(SM_RED) + (nit & 1) * 8;
  if ((u & 31) == 0) {
    red[u >> 5] = m;
    red[4 + (u >> 5)] = ma;
  }
  named_bar(BAR_CONV, NCONV);
  m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  ma = fmaxf(fmaxf(red[4], red[5]), fmaxf(red[6], red[7]));
  ++nit;
  // U = 2^e (or 0: every d_z of the split is zero, any scale will do); U_A
  // = 2^ea >= 1
  const int e = m > 0.f ? ((__float_as_int(m) >> 23) & 255) - 127 : 0;
  const int ea = ((__float_as_int(ma) >> 23) & 255) - 127;
  const float up = pow2(-e), aup = pow2(-ea), down = pow2(e) * pow2(ea);
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
    if (ea == 0) {  // (the warp group takes the branch as one: no multiply on ordinary input)
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int q = u + NCONV * i;
        put_parts(base + S_AH, base + S_AL, q / (N / 8), (q % (N / 8)) * 8, av[i], 1.f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int q = u + NCONV * i;
        put_parts(base + S_AH, base + S_AL, q / (N / 8), (q % (N / 8)) * 8, av[i], aup);
      }
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
  Clock<PROF> ck(a.clk);
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

// out[n] = sum over r of in[r][n], in order of r; with `add`, out[n] plus
// that sum (the sums of the earlier point chunks first)
__global__ void nerf_mlp_bwd_reduce(const float* in, int R, long long N, float* out, int add) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = add ? out[n] : 0.f;
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

// The wgrad's tiles (both modes): 128 rows of a block by all of its
// columns, the wide blocks first (those whose A is the stash, I = W; the
// narrow ones read the PE, whose kx or kd may equal W at width 128).
int fill_tiles(WTile (&tiles)[N_TILES], int kx, int kd) {
  WJob jobs[N_JOBS];
  make_jobs(jobs, kx, kd);
  int n = 0;
  for (int wide = 1; wide >= 0; --wide)
    for (int j = 0; j < N_JOBS; ++j) {
      if ((jobs[j].a_pe == 0) != (wide == 1)) continue;
      for (int o0 = 0; o0 < jobs[j].O; o0 += 128) {
        if (n >= N_TILES) return -1;
        WTile& t = tiles[n++];
        t.out_off = jobs[j].out_off + (long long)o0 * jobs[j].ldw;
        t.ldw = jobs[j].ldw;
        t.z_col = jobs[j].z_col + o0;
        t.zb = jobs[j].z_col / W;
        t.a_pe = jobs[j].a_pe;
        t.a_col = jobs[j].a_col;
      }
    }
  return n == N_TILES ? n : -1;
}

// Points of each split but the last: P / n_splits rounded up to whole
// stages of `ks` points.
int pts_per_split(int P, int n_splits, int ks) {
  return ((P + n_splits - 1) / n_splits + ks - 1) / ks * ks;
}

int launch_wgrad_bf16(const void* acts, const void* dz, const void* pe, float* w_part,
                      long long* clk, int P, int kx, int kd, int n_splits, int n_wblocks,
                      cudaStream_t stream) {
  using namespace bf16w;
  if (n_wblocks < CLUSTER || n_splits <= 0) return (int)cudaErrorInvalidValue;
  static int max_clusters = 0;  // clusters that fit on the card at once
  if (max_clusters == 0) {
    cudaError_t e = cudaFuncSetAttribute(nerf_mlp_bwd_wgrad_bf16_sm90<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nerf_mlp_bwd_wgrad_bf16_sm90<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_wblocks / CLUSTER * CLUSTER);
    cfg.blockDim = dim3(NTHR);
    cfg.dynamicSmemBytes = SMEM;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(&max_clusters, nerf_mlp_bwd_wgrad_bf16_sm90<false>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (max_clusters <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap tm_dz, tm_acts, tm_pe;
  int rc = make_map_2d_bf16(&tm_dz, dz, P, ACTS_LD, ACTS_LD * 2, KS, 64);
  if (rc == 0) rc = make_map_2d_bf16(&tm_acts, acts, P, ACTS_LD, ACTS_LD * 2, KS, 64);
  if (rc == 0) rc = make_map_2d_bf16(&tm_pe, pe, P, kx + kd, (kx + kd) * 2, KS, 64);
  if (rc != 0) return rc;
  Args wa;
  wa.part = w_part;
  wa.clk = clk;
  wa.part_stride = w_numel(kx, kd);
  wa.P = P;
  wa.pts_per_split = pts_per_split(P, n_splits, KS);
  wa.n_splits = n_splits;
  wa.n_units = (N_UNITS_WIDE + N_UNITS_NARROW) * n_splits;
  wa.kx = kx;
  wa.kd = kd;
  if (fill_tiles(wa.tiles, kx, kd) < 0) return (int)cudaErrorInvalidValue;
  const int clusters = std::min(std::min(max_clusters, n_wblocks / CLUSTER), wa.n_units);
  const int grid = CLUSTER * clusters;
  if (clk != nullptr)
    nerf_mlp_bwd_wgrad_bf16_sm90<true><<<grid, NTHR, SMEM, stream>>>(tm_dz, tm_acts, tm_pe, wa);
  else
    nerf_mlp_bwd_wgrad_bf16_sm90<false><<<grid, NTHR, SMEM, stream>>>(tm_dz, tm_acts, tm_pe, wa);
  return (int)cudaGetLastError();
}

int launch_wgrad_f32(const void* acts, const void* dz, const void* pe, const float* zs,
                     const float* au, float* w_part, long long* clk, int P, int kx, int kd,
                     int n_splits, int n_wblocks, cudaStream_t stream) {
  if (zs == nullptr || au == nullptr || n_wblocks <= 0) return (int)cudaErrorInvalidValue;
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
  wa.au = au;
  wa.part = w_part;
  wa.clk = clk;
  wa.part_stride = w_numel(kx, kd);
  wa.P = P;
  wa.pts_per_split = pts_per_split(P, n_splits, f32w::KS);
  wa.pe_ld = kx + kd;
  wa.n_splits = n_splits;
  if (fill_tiles(wa.tiles, kx, kd) < 0) return (int)cudaErrorInvalidValue;
  wa.n_items = N_TILES * n_splits;
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
int nerf_mlp_bwd_width() { return W; }
long long nerf_mlp_bwd_fp_numel() { return FP_NUMEL; }
long long nerf_mlp_bwd_acts_ld() { return ACTS_LD; }
// The wgrads' constants: the f32 wgrad's scale units of dz (points a tile,
// dz blocks, entries a tile and block), the cycle counts of the f32 and the
// bf16 instantiations, their points a stage, and the stash's scale units
// (blocks, entries a tile and block).
int nerf_mlp_bwd_consts(int i) {
  const int c[9] = {f32w::ZT, f32w::ZB, f32w::ZW, f32w::N_CLK, bf16w::N_CLK, f32w::KS, bf16w::KS,
                    f32w::AB, f32w::AW};
  return i >= 0 && i < 9 ? c[i] : -1;
}
// A wgrad's work in the order of its persistent grid (bf16: each unit as
// block 0 of the cluster takes it, then as block 1), 9 values an entry into
// out: tile, split, rows o, columns I, the offset of the entry's first row
// in the weight grad, its row length, the dz column of that row, A from the
// PE (1) or the stash (0), A's first column.  Returns the entry count, or
// -1.
int nerf_mlp_bwd_wgrad_items(int bf16_mode, int n_splits, int kx, int kd, long long* out) {
  WTile tiles[N_TILES];
  if (n_splits <= 0 || fill_tiles(tiles, kx, kd) < 0) return -1;
  const struct { int n_splits, kx, kd; } a = {n_splits, kx, kd};
  const int per = bf16_mode ? bf16w::N_UNITS_WIDE + bf16w::N_UNITS_NARROW : N_TILES;
  const int ranks = bf16_mode ? bf16w::CLUSTER : 1;
  int n = 0;
  for (int it = 0; it < per * n_splits; ++it)
    for (int r = 0; r < ranks; ++r) {
      int tile, split, half = 0;
      const int I = bf16_mode ? bf16w::unit_of(a, it, r, tile, split, half)
                              : item_of(a, it, tile, split);
      const WTile& t = tiles[tile];
      const int row0 = half ? 64 * r : 0;
      const long long e[9] = {tile, split, half ? 64 : 128, I, t.out_off + (long long)row0 * t.ldw,
                              t.ldw, t.z_col + row0, t.a_pe, t.a_col};
      for (int k = 0; k < 9; ++k) out[9 * n + k] = e[k];
      ++n;
    }
  return n;
}
// The wgrad of nerf_mlp_fwd's backward on `stream`, for P points (a point
// chunk) after their dgrad (nerf_mlp_dgrad.cu), on its dz and pe: each
// point split's partial of the weight grads into its row of w_part.
// Returns cudaGetLastError().
//   acts [P, ACTS_LD] the stash, dz [P, ACTS_LD] and pe [P, kx + kd]
//   scratch, in the compute dtype; zs (f32 only) the dgrad's scale units
//   [ceil(P / 128)][10][3], au (f32 only) K1's scale units of the stash
//   [ceil(P / 128)][9][8]; w_part [n_splits, w_numel] f32 scratch; clk null
//   or [N_CLK] int64 of the mode (the instrumented wgrad).
// n_splits: point splits of the wgrad; n_wblocks: its persistent grid (at
// most one block an SM).  Requires the PE that the dgrad requires (kx, kd
// in {32, 64, 96, 128}, kx + kd <= PE_PAD_MAX: a narrow tile's N = I
// rounded up to 64, at most 128) and P > 0.
int nerf_mlp_bwd_wgrad(const void* acts, const void* dz, const void* pe, const float* zs,
                       const float* au, float* w_part, long long* clk, int P, int kx, int kd,
                       int bf16_mode, int n_splits, int n_wblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_mode ? launch_wgrad_bf16(acts, dz, pe, w_part, clk, P, kx, kd, n_splits, n_wblocks,
                                       s)
                   : launch_wgrad_f32(acts, dz, pe, zs, au, w_part, clk, P, kx, kd, n_splits,
                                      n_wblocks, s);
}

// The two fixed-order reductions that end a point chunk's backward, on
// `stream`: dw [w_numel] = the w_rows rows of w_part summed in order, dfp
// [FP_NUMEL] = the fp_rows rows of the dgrad's fp_part [fp_rows, FP_NUMEL]
// likewise; with `add` (a later chunk) each added to what dw and dfp hold.
// Returns the first cudaGetLastError() that is not 0, else 0.
int nerf_mlp_bwd_reduce_all(const float* fp_part, int fp_rows, const float* w_part, int w_rows,
                            float* dw, float* dfp, int kx, int kd, int add, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long wn = w_numel(kx, kd);
  nerf_mlp_bwd_reduce<<<(unsigned)((wn + 255) / 256), 256, 0, s>>>(w_part, w_rows, wn, dw, add);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nerf_mlp_bwd_reduce<<<(FP_NUMEL + 255) / 256, 256, 0, s>>>(fp_part, fp_rows, FP_NUMEL, dfp, add);
  return (int)cudaGetLastError();
}

const char* nerf_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
