// The dgrad of the fused NeRF-MLP backward for Hopper (sm_90a): d(xd),
// every d_z (into the `dz` scratch the wgrad reads), the PE (into the `pe`
// scratch), and per-block partials of the bias grads and of the two small
// heads' weight grads.  The wgrad and the two fixed-order reductions that
// finish the backward are in nerf_mlp_bwd.cu.  Two kernels: the bf16 dgrad
// (this header), and the f32 dgrad, "the split" (its own section below),
// which shares the layer helpers, the d(xd) stages and the PE store.
//
// Replaces, in bf16 mode, the Pallas TPU kernels `_bwd_stash_kernel` and
// `_bwd_kernel` of lushnerf_tpu/ops/fused/nerf_mlp.py (`_bwd_math`): the
// stash backward (K2) runs it on the forward's stash, the remat backward
// (K3) on a stash that the forward kernel (K1) writes into scratch just
// before.  The arithmetic and its rounding points are those listed at the
// top of nerf_mlp_bwd.cu.
//
// What bounds it: bytes.  Per point it reads 4,352 B of stash (a0..a7 and
// hv), 48 B of xd and g, and writes 4,864 B of dz, the PE and d(xd): about
// 1.9 ms at P = 655,360 on the card's 3.35 TB/s, against 0.79 ms for its
// 1,186,816 FLOP a point at the bf16 peak.  The design also reads d_z5
// back (512 B a point).
//
// Design: one block per SM loops over 128-point tiles.  Two consumer
// warpgroups each own 64 points of the tile; a producer warpgroup feeds
// them: one thread issues every copy (weights and masks in, d_z out), and
// three warps write the PE scratch, which nothing in this kernel reads.
// setmaxnreg hands the producer's registers to the consumers at run time,
// but ptxas still fits every path into the 168 registers a thread that a
// 384-thread launch gets, so the consumer code is shaped to fit them: a
// layer's two 128-column accumulators (128 registers), one copy of the
// layer code for all nine 256-wide layers (a copy per layer spilled and
// missed the instruction cache every tile), shared memory at constant
// addresses, and rolled loops around sincosf.
//   * Matmuls on wgmma (m64nNk16, both operands in shared memory, sums in
//     registers).  A is the tile's d_z in K-major 128-byte-swizzled chunks
//     of 64 columns; B a 64-deep chunk of a transposed weight, which the
//     producer copies with bulk copies from the blob that pack_params_bwd
//     lays out chunk-major in that same swizzled layout, through a ring of
//     four 16 KB stages on mbarriers (a 256-wide layer's chunk is two
//     stages: rows 0..127 and 128..255, one m64n128k16 each).
//   * Two 64 KB tile buffers take turns: a layer reads its A from one and
//     writes its d_z over the other, where the layer's stash columns (its
//     relu mask) already are.  Each 16 KB chunk of A goes back to the
//     producer as soon as both warpgroups' wgmmas have read it, and the
//     producer loads the next layer's stash columns into it (TMA, a 2-D
//     tensor map over the stash): a mask arrives while the layer before
//     it runs.  The epilogue reads each mask from there and writes the
//     rounded d_z over it in place, in the layout the next layer's wgmma
//     reads, and hands the tile to the producer, whose TMA stores (a map
//     over the dz scratch, one bulk group a chunk) copy it out; only the
//     chunk's next load, in the producer, waits for them.
//   * d_pe in registers: d_pe_x is the W0 pass and then the W5a pass on
//     d_z5, which the producer loads back from the dz scratch into the
//     buffer d_z0's layer frees; it goes to shared memory once, in f32, for
//     the d(xd) stage; the Wvd pass's d_pe_d goes through the staging
//     buffer for the view lanes, 32 columns at a time.
//   * The heads' grads read hv and a7 from the tile buffers: a thread per
//     hv column and half tile, a thread per a7 column.
//   * Fixed summation orders, no atomics: each bias column sum adds the
//     thread's two rows, then the warp's 8 row groups by shuffles, then
//     the 8 warps in order, per tile in tile order, per block into its own
//     partial; nerf_mlp_bwd.cu sums the partials in block order.
// Both dgrads are compiled for the width W of nerf_mlp_common.cuh.  At
// width 128 (the views layer padded to 128 lanes) a W-wide layer's chunk
// is one weight piece and its d_z one 64-register accumulator and one
// epilogue half (`matmul_chunks`), two chunks deep; the tile buffers, the
// ring and the staging keep their places and sizes (half of each buffer
// idle), each stage of the producer's stores is two chunks, and half the
// consumer threads sum a7's columns and the bias columns.

#include "hopper.cuh"
#include "nerf_mlp_common.cuh"

// The block's shared memory: at file scope, so that every address in it is a
// constant and costs the consumers no registers.
extern __shared__ __align__(1024) unsigned char dsmem[];

// A PE part of 128 channels (kx or kd = 128) takes d_pe passes of 64
// accumulators a thread (WIDE_PE): both dgrads built as
// nerf_mlp_dgrad_wide.cu (NERF_MLP_WIDE_PE 1, no stage stamps), and only
// then, so that the others keep their code and their build time.
#ifndef NERF_MLP_WIDE_PE
#define NERF_MLP_WIDE_PE 0
#endif
constexpr bool WIDE_PE = NERF_MLP_WIDE_PE != 0;

namespace {

using namespace nerf_mlp;
using namespace hopper;

constexpr int T = 128;                // points per tile
constexpr int NCONS = 256;            // two consumer warpgroups
constexpr int NTHR = NCONS + 128;     // and a producer warpgroup (one thread issues)
constexpr int CONS_REGS = 224;        // registers a consumer thread holds after setmaxnreg
constexpr int PROD_REGS = 56;         // and a producer thread: 2 x 128 x 224 + 128 x 56 <= 64K
constexpr int CHUNK_B = T * 128;      // [128 rows][64 bf16] of a tile buffer: 16 KB
constexpr int BUF_B = 4 * CHUNK_B;    // a tile buffer: [128][256] bf16
constexpr int HALF = 128;             // output columns of one weight piece of a 256-wide layer
constexpr int WST_B = HALF * 128;     // a weight piece: up to [128 rows][64 bf16], 16 KB
constexpr int N_WST = 4;              // weight ring stages: two 64-deep chunks of a 256-wide layer
constexpr int BAR_CONS = 1;           // named barrier of the 256 consumer threads
constexpr int NCH = W / 64;           // chunks of a W-wide d_z in a tile buffer
// the staging's bytes: two layers' column sums [2][8 warps][W] f32, and
// dxd_views's [T][32] f32 (16 KB, the column sums' size at width 256)
constexpr int STAGE_B = 2 * 8 * W * 4 > T * 32 * 4 ? 2 * 8 * W * 4 : T * 32 * 4;

// shared memory (byte offsets; the tile buffers and the ring are 1024-aligned)
constexpr int SM_BUF = 0;
constexpr int SM_RING = SM_BUF + 2 * BUF_B;
constexpr int SM_STAGE = SM_RING + N_WST * WST_B;      // [2][8 warps][W] f32 column sums
constexpr int SM_FACC = SM_STAGE + STAGE_B;            // [FP_NUMEL] f32
constexpr int SM_XS = SM_FACC + FP_NUMEL * 4;          // [T][8] f32
constexpr int SM_GS = SM_XS + T * 8 * 4;               // [T][4] f32
constexpr int SM_BARS = SM_GS + T * 4 * 4;             // [N_BARS] mbarriers
// mbarriers by index: a weight stage loaded (W_FULL + s) and read by all 8
// consumer warps (W_EMPTY + s); chunk c of tile buffer b loaded with stash
// (or dz) columns (M_FULL + 4 b + c) and no longer read by either
// warpgroup (B_FREE + 4 b + c); a d_z written into tile buffer b, for the
// producer to store (D_READY + b); the producer's store of buffer X has
// read it (X_READ: d_hv, d_z0)
enum { W_FULL = 0, W_EMPTY = W_FULL + N_WST, M_FULL = W_EMPTY + N_WST, B_FREE = M_FULL + 8,
       D_READY = B_FREE + 8, X_READ = D_READY + 2, N_BARS };
constexpr int SMEM = SM_BARS + N_BARS * 8;
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may use");

// blocks of the transposed blob, in its order
enum { T_W0, T_W1, T_W2, T_W3, T_W4, T_W5A, T_W5B, T_W6, T_W7, T_WF, T_WVF, T_WVD, N_WT };

struct DgradArgs {
  const float* xd;  // [P, 8]
  const float* g;   // [P, 4]
  const float* fp;  // the f32 blob
  const bf16* wt;   // the transposed blob, chunk-major and swizzled
  long long wt_off[N_WT];
  bf16* pe;          // [P, kx + kd]
  float* dxd;        // [P, 8]
  float* fp_part;    // [gridDim.x, FP_NUMEL]
  long long* stamps; // [block 0's tiles][N_STAMPS] or null
  int P, kx, kd, nfx, nfd, ntiles;
};

// Stage stamps (the labels are nerf_mlp.DGRAD_STAGES): consumer thread 0's
// clock64() at the end of each stage of block 0's tiles.
constexpr int N_STAMPS = 34;
template <bool ON> struct Stamper {
  long long* out;
  int i;
  __device__ __forceinline__ void mark() {
    if constexpr (ON) {
      if (out != nullptr) out[i] = clock64();
    }
    ++i;
  }
};

__device__ __forceinline__ uint64_t* bar(int i) {
  return reinterpret_cast<uint64_t*>(dsmem + SM_BARS) + i;
}
__device__ __forceinline__ unsigned char* buf(int b) { return dsmem + SM_BUF + b * BUF_B; }
template <typename E> __device__ __forceinline__ E* at(int off) {
  return reinterpret_cast<E*>(dsmem + off);
}

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// The consumer side of a weight ring at byte RING whose barriers are at
// BARS (full: 0 .. N_WST - 1, empty: N_WST ..): piece k sits in stage k %
// N_WST.
template <int BARS, int RING> struct RingT {
  int k;  // the next piece
  __device__ __forceinline__ uint64_t* ring_bar(int i) const {
    return reinterpret_cast<uint64_t*>(dsmem + BARS) + i;
  }
  __device__ __forceinline__ const unsigned char* wait(int piece) const {
    const int s = piece % N_WST;
    mbar_wait(ring_bar(s), (piece / N_WST) & 1);
    return dsmem + RING + s * WST_B;
  }
  __device__ __forceinline__ void release(int piece) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(ring_bar(N_WST + piece % N_WST));
  }
};
static_assert(W_FULL == 0 && W_EMPTY == N_WST, "the ring's barriers");
using Ring = RingT<SM_BARS, SM_RING>;

// The producer, before chunk c of a tile buffer is loaded again: its store
// of that chunk, bulk group c of the last NCH it committed (one a chunk,
// in chunk order), has read it.
__device__ __forceinline__ void wait_store_read(int c) {
  if constexpr (NCH == 4) {
    if (c == 0) bulk_wait_read<3>();
    else if (c == 1) bulk_wait_read<2>();
    else if (c == 2) bulk_wait_read<1>();
    else bulk_wait_read<0>();
  } else {
    if (c == 0) bulk_wait_read<1>();
    else bulk_wait_read<0>();
  }
}

// a0 | a1 = A[wg rows, 0 : 64 nk] . B^T over a 256-wide block's next 2 nk
// weight pieces (chunk c: its rows 0..127, then 128..255); A is a tile
// buffer.  The sums start from zeros set here, so that both accumulators
// are dead before the call.  With free_b >= 0, chunk c of A goes back to
// the producer (b_free) once this warpgroup's wgmmas have read it.
__device__ __forceinline__ void matmul_wide(float (&a0)[HALF / 2], float (&a1)[HALF / 2],
                                            const unsigned char* A, int nk, Ring& ring,
                                            int free_b) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) a0[i] = a1[i] = 0.f;
  auto free_chunk = [&](int c) {
    if (free_b >= 0 && (threadIdx.x & 127) == 0) mbar_arrive(bar(B_FREE + 4 * free_b + c));
  };
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const unsigned char* B0 = ring.wait(ring.k);
    const unsigned char* B1 = ring.wait(ring.k + 1);
    wgmma_fence();
    wgmma_fence_regs(a0);
    wgmma_fence_regs(a1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = wgmma_desc(A + c * CHUNK_B + wg * 64 * 128 + ks * 32);
      wgmma_m64n128k16(a0, da, wgmma_desc(B0 + ks * 32), 1);
      wgmma_m64n128k16(a1, da, wgmma_desc(B1 + ks * 32), 1);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      ring.release(ring.k - 2);
      ring.release(ring.k - 1);
      free_chunk(c - 1);
    }
    ring.k += 2;
  }
  wgmma_wait<0>();
  ring.release(ring.k - 2);
  ring.release(ring.k - 1);
  free_chunk(nk - 1);
  wgmma_fence_regs(a0);
  wgmma_fence_regs(a1);
}

// acc = A[wg rows, 0 : 64 nk] . B^T over a 128-wide block's next nk weight
// pieces, one a chunk (width 128), as matmul_wide with one accumulator.
__device__ __forceinline__ void matmul_chunks(float (&acc)[HALF / 2], const unsigned char* A,
                                              int nk, Ring& ring, int free_b) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
  auto free_chunk = [&](int c) {
    if (free_b >= 0 && (threadIdx.x & 127) == 0) mbar_arrive(bar(B_FREE + 4 * free_b + c));
  };
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const unsigned char* B = ring.wait(ring.k);
    wgmma_fence();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n128k16(acc, wgmma_desc(A + c * CHUNK_B + wg * 64 * 128 + ks * 32),
                       wgmma_desc(B + ks * 32), 1);
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      ring.release(ring.k - 1);
      free_chunk(c - 1);
    }
    ++ring.k;
  }
  wgmma_wait<0>();
  ring.release(ring.k - 1);
  free_chunk(nk - 1);
  wgmma_fence_regs(acc);
}

// acc += A[wg rows, 0 : 64 nk] . B^T over the next nk weight pieces of N
// rows (a d_pe pass: N = kx or kd; R = 48 accumulators a thread up to N =
// 96, 64 at N = 128).
template <int N, int R>
__device__ __forceinline__ void matmul_n(float (&acc)[R], const unsigned char* A, int nk,
                                         Ring& ring) {
  const int wg = threadIdx.x >> 7;
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const unsigned char* B = ring.wait(ring.k);
    wgmma_fence();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = wgmma_desc(A + c * CHUNK_B + wg * 64 * 128 + ks * 32);
      const uint64_t db = wgmma_desc(B + ks * 32);
      if constexpr (N == 32) wgmma_m64n32k16(acc, da, db, 1);
      else if constexpr (N == 64) wgmma_m64n64k16(acc, da, db, 1);
      else if constexpr (N == 96) wgmma_m64n96k16(acc, da, db, 1);
      else wgmma_m64n128k16(acc, da, db, 1);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      ring.release(ring.k - 1);
    }
    ++ring.k;
  }
  wgmma_wait<0>();
  ring.release(ring.k - 1);
  wgmma_fence_regs(acc);
}

__device__ __forceinline__ void matmul_narrow(float (&acc)[48], int N, const unsigned char* A,
                                              int nk, Ring& ring) {
  if (N == 32) matmul_n<32>(acc, A, nk, ring);
  else if (N == 64) matmul_n<64>(acc, A, nk, ring);
  else matmul_n<96>(acc, A, nk, ring);
}
__device__ __forceinline__ void matmul_narrow(float (&acc)[64], int, const unsigned char* A,
                                              int nk, Ring& ring) {
  matmul_n<128>(acc, A, nk, ring);
}

// A d_pe pass's accumulators a thread for its N = kx or kd columns: 48 up
// to 96, 64 at 128 (a pass of its own, so that the narrower PEs keep their
// code).
template <int R> struct PeAcc {
  static constexpr int value = R;
};

// This thread's rows of the tile in the accumulator fragment: r0 and r0 + 8;
// its columns: 8 j + 2 q and 8 j + 2 q + 1.
struct Frag {
  int r0, q, warp8;
  __device__ __forceinline__ Frag() {
    const int t = threadIdx.x, lane = t & 31;
    warp8 = t >> 5;
    r0 = (t >> 7) * 64 + ((t >> 5) & 3) * 16 + (lane >> 2);
    q = lane & 3;
  }
};

// The epilogue of half h (columns 128 h ..) of a 256-wide layer: v = acc
// (+ r(g_alpha) Wa), times the relu mask that buffer `out` holds (no mask
// for d_feat), written rounded over it in place; the column sums of v into
// the staging buffer `stage`.
__device__ __forceinline__ void epilogue_half(const float (&acc)[HALF / 2], int h,
                                              unsigned char* out, bool mask, bool alpha,
                                              const float* fp, const float* gs, float* stage) {
  const Frag f;
  const int lane = threadIdx.x & 31;
  float ga0 = 0.f, ga1 = 0.f;  // r(g_alpha) of the thread's two rows
  if (alpha) {
    ga0 = rnd<true>(gs[f.r0 * 4 + 3]);
    ga1 = rnd<true>(gs[(f.r0 + 8) * 4 + 3]);
  }
  // four groups of 4 fragment column pairs (32 columns), so that only 8
  // column sums are live beside the accumulators
#pragma unroll
  for (int g = 0; g < HALF / 32; ++g) {
    float cs[8];  // this thread's two rows' sum of each of its 8 columns
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * g + jj;
      const int col = HALF * h + 8 * j + 2 * f.q;
      const int o0 = (col >> 6) * CHUNK_B + (int)swz128(f.r0, col & 63);
      const int o1 = (col >> 6) * CHUNK_B + (int)swz128(f.r0 + 8, col & 63);
      float v00 = acc[4 * j], v01 = acc[4 * j + 1], v10 = acc[4 * j + 2], v11 = acc[4 * j + 3];
      if (alpha) {
        const float2 wa = __ldg(reinterpret_cast<const float2*>(fp + FP_WA + col));
        v00 = fmaf(ga0, wa.x, v00);
        v01 = fmaf(ga0, wa.y, v01);
        v10 = fmaf(ga1, wa.x, v10);
        v11 = fmaf(ga1, wa.y, v11);
      }
      __nv_bfloat162* d0 = reinterpret_cast<__nv_bfloat162*>(out + o0);
      __nv_bfloat162* d1 = reinterpret_cast<__nv_bfloat162*>(out + o1);
      if (mask) {
        const float2 m0 = __bfloat1622float2(*d0), m1 = __bfloat1622float2(*d1);
        v00 = m0.x > 0.f ? v00 : 0.f;
        v01 = m0.y > 0.f ? v01 : 0.f;
        v10 = m1.x > 0.f ? v10 : 0.f;
        v11 = m1.y > 0.f ? v11 : 0.f;
      }
      *d0 = __floats2bfloat162_rn(v00, v01);
      *d1 = __floats2bfloat162_rn(v10, v11);
      cs[2 * jj] = v00 + v10;
      cs[2 * jj + 1] = v01 + v11;
    }
    // the sums over the warp's 8 row groups (lane bits 2..4): each step
    // sends half of the values to the partner lane and keeps the other
    // half, so the 8 columns end 1 to a lane after 4 + 2 + 1 shuffles (each
    // column's sum pairs the lanes xor 16, then 8, then 4)
#pragma unroll
    for (int o = 16, n = 4; o >= 4; o >>= 1, n >>= 1) {
      const bool up = lane & o;
#pragma unroll
      for (int k = 0; k < n; ++k) {
        const float send = up ? cs[k] : cs[n + k];
        const float keep = up ? cs[n + k] : cs[k];
        cs[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
    const int i = (lane >> 2) & 7;  // this lane's value: 2 jj + (column & 1)
    stage[f.warp8 * W + HALF * h + 8 * (4 * g + (i >> 1)) + 2 * f.q + (i & 1)] = cs[0];
  }
}

// The end of a 256-wide layer whose d_z is in a tile buffer: the
// consumers' barrier, after which thread 0 hands the tile to the producer
// (`ready`, bf16), which stores it to the dz scratch; and the column sums
// added to facc[bias_off].
__device__ __forceinline__ void layer_end(const float* stage, float* facc, int bias_off,
                                          uint64_t* ready) {
  fence_proxy_async();
  named_bar(BAR_CONS, NCONS);
  if (ready != nullptr && threadIdx.x == 0) mbar_arrive(ready);
  const int c = threadIdx.x;
  if (W != NCONS && c >= W) return;  // (width 128: a thread a column, half the threads)
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) s += stage[w * W + c];
  facc[bias_off + c] += s;
}

// d(xd) lanes 3..5 from the Wvd pass's fragment (N = kd columns: the
// identity lanes, then [sin, cos] blocks of 3 for L bands), through sbuf
// ([T][32] f32, column c of row r at c ^ (r % 32)) 32 columns at a time:
// one thread per (point, coordinate) adds its identity term, then band by
// band its sin and its cos column's terms.  A rolled loop, so that sincosf
// is not inlined once per fragment value.
template <int R>
__device__ __forceinline__ void dxd_views(const float (&acc)[R], int N, int L, const float* xs,
                                          float* sbuf, float* dxd, int p0, int P) {
  const Frag f;
  float s[2] = {0.f, 0.f};  // items threadIdx.x and threadIdx.x + NCONS of the T * 3
#pragma unroll
  for (int b = 0; b < R / 16; ++b) {
    if (32 * b >= N) break;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = f.r0 + 8 * rr, c = 8 * jj + 2 * f.q + h;
          sbuf[r * 32 + (c ^ (r & 31))] = acc[4 * (4 * b + jj) + 2 * rr + h];
        }
    named_bar(BAR_CONS, NCONS);
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = threadIdx.x + it * NCONS, p = idx / 3, k = idx - 3 * p;
      if (idx >= T * 3) break;
      const float x = p0 + p < P ? xs[p * 8 + 3 + k] : 0.f;
      auto col = [&](int c) { return sbuf[p * 32 + ((c - 32 * b) ^ (p & 31))]; };
      auto here = [&](int c) { return c >= 32 * b && c < 32 * b + 32; };
      if (here(k)) s[it] += col(k);
#pragma unroll 1
      for (int band = 0; band < L; ++band) {
        const int c_sin = 3 + 6 * band + k, c_cos = c_sin + 3;
        if (here(c_sin) || here(c_cos)) {
          const float fr = (float)(1 << band);
          float sn, cs;
          sincosf(x * fr, &sn, &cs);
          if (here(c_sin)) s[it] += fr * col(c_sin) * cs;
          if (here(c_cos)) s[it] += -(fr * col(c_cos) * sn);
        }
      }
    }
    named_bar(BAR_CONS, NCONS);
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int idx = threadIdx.x + it * NCONS, p = idx / 3, k = idx - 3 * p;
    if (idx < T * 3 && p0 + p < P) dxd[(size_t)(p0 + p) * 8 + 3 + k] = s[it];
  }
}

// The row of the f32 d_pe_x tile [T][ld] in shared memory: kx plus 4 up
// to kx = 96; at kx = 128 the row itself, so that the tile fits the bf16
// dgrad's 64 KB tile buffer (its rows then share their banks: slower, and
// only at kx = 128).
constexpr int DPE_LD = 100;
__device__ __forceinline__ int dpe_ld(int kx) { return kx <= 96 ? DPE_LD : 128; }

// This warpgroup's rows of a d_pe fragment of N columns into dpe [T][ld].
template <int R>
__device__ __forceinline__ void dpe_to_smem(const float (&acc)[R], int N, float* dpe,
                                            int ld = DPE_LD) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (8 * j < N) {
      const int col = 8 * j + 2 * f.q;
      *reinterpret_cast<float2*>(dpe + f.r0 * ld + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dpe + (f.r0 + 8) * ld + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// d(xd) lanes 0..2 and the padding lanes 6, 7 from d_pe_x in dpe ([T][ld]): one
// thread per (point, coordinate), the bands in order, as nerf_mlp_bwd.cu's
// f32 kernel sums them.
__device__ __forceinline__ void dxd_from_smem(const float* dpe, int ld, int L, const float* xs,
                                              float* dxd, int p0, int P) {
  for (int idx = threadIdx.x; idx < T * 3; idx += NCONS) {
    const int p = idx / 3, k = idx - 3 * p;
    if (p0 + p >= P) continue;
    const float* dp = dpe + p * ld;
    const float v = xs[p * 8 + k];
    float acc = dp[k];
    for (int j = 0; j < L; ++j) {
      const float f = (float)(1 << j);
      float sn, cs;
      sincosf(v * f, &sn, &cs);
      acc = fmaf(f, dp[3 + 6 * j + k] * cs - dp[6 + 6 * j + k] * sn, acc);
    }
    dxd[(size_t)(p0 + p) * 8 + k] = acc;
    if (k == 0) *reinterpret_cast<float2*>(dxd + (size_t)(p0 + p) * 8 + 6) = make_float2(0.f, 0.f);
  }
}

template <typename E> __device__ __forceinline__ E to_elem(float v);
template <> __device__ __forceinline__ bf16 to_elem<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float to_elem<float>(float v) { return v; }

// The PE of one tile's points into the pe scratch (nothing in the dgrad
// reads it; the wgrad does), by three warps (`warp` 0..2) while the
// consumers run, as pe_tile computes each value.  Warp w takes the tile's
// points w, w + 3, .. in batches of 32: lane l loads point l's coordinates
// once, and the shuffles hand them to the lanes that need them; the
// batch's (point, band, coordinate) items run 32 at a time, one sincosf
// each for its sin and its cos lane, then its identity lanes and zero
// padding.  Every shuffle runs on all 32 lanes: the loops are uniform.
template <typename E>
__device__ __forceinline__ void pe_tile_store(const float* xd, E* pe, int P, int kx, int kd,
                                              int nfx, int nfd, int tile, int warp) {
  const int lane = threadIdx.x & 31;
  const int ncol = kx + kd, n = 3 * (nfx + nfd);
  const int first = tile * T + warp, np_all = max(0, (min(tile * T + T, P) - first + 2) / 3);
  for (int b0 = 0; b0 < np_all; b0 += 32) {
    const int np = min(32, np_all - b0);
    float x[6];  // this lane's point's coordinates
    {
      const int p = first + 3 * (b0 + lane);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 u = lane < np ? __ldg(reinterpret_cast<const float4*>(xd + (size_t)p * 8)) : z;
      const float2 v = lane < np ? __ldg(reinterpret_cast<const float2*>(xd + (size_t)p * 8 + 4)) : make_float2(0.f, 0.f);
      x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w, x[4] = v.x, x[5] = v.y;
    }
    // coordinate ci of the batch's point q, from its lane
    auto coord = [&](int q, int ci) {
      float r = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float t = __shfl_sync(0xffffffffu, x[k], q);
        r = k == ci ? t : r;
      }
      return r;
    };
    for (int r0 = 0; r0 < np * n; r0 += 32) {
      const int it = r0 + lane, q = min(it / n, np - 1), r = it - (it / n) * n;
      const int slot = r / 3, c = r - 3 * slot;
      const bool is_x = slot < nfx;
      const int band = is_x ? slot : slot - nfx;
      const float v = coord(q, (is_x ? 0 : 3) + c);
      if (it < np * n) {
        float sn, cs;
        sincosf(v * (float)(1 << band), &sn, &cs);
        E* d = pe + (size_t)(first + 3 * (b0 + q)) * ncol + (is_x ? 0 : kx) + 3 + 6 * band + c;
        d[0] = to_elem<E>(sn);
        d[3] = to_elem<E>(cs);
      }
    }
    // a point's other lanes: pe_x's identity lanes and zero padding, then
    // pe_d's
    const int zx = kx - 3 - 6 * nfx, nfix = 6 + zx + kd - 3 - 6 * nfd;
    for (int r0 = 0; r0 < np * nfix; r0 += 32) {
      const int it = r0 + lane, q = min(it / nfix, np - 1), j = it - (it / nfix) * nfix;
      const bool is_x = j < 3 + zx;
      const int local = is_x ? (j < 3 ? j : 3 + 6 * nfx + j - 3) : (j < 6 + zx ? j - 3 - zx : 3 + 6 * nfd + j - 6 - zx);
      const float v = coord(q, (is_x ? 0 : 3) + min(local, 2));
      if (it < np * nfix)
        pe[(size_t)(first + 3 * (b0 + q)) * ncol + (is_x ? 0 : kx) + local] = to_elem<E>(local < 3 ? v : 0.f);
    }
  }
}

// The bf16 dgrad's PE warps (the producer warpgroup's warps 1..3): every
// tile of the block.
__device__ __forceinline__ void pe_store(const DgradArgs& a) {
  const int warp = ((threadIdx.x - NCONS) >> 5) - 1;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x)
    pe_tile_store(a.xd, a.pe, a.P, a.kx, a.kd, a.nfx, a.nfd, tile, warp);
}

// d_hv = (g_rgb Wr) * [hv > 0] over hv in buffer X (written back in place),
// and the heads' grads.  d_hv and its grads: thread t takes column t % 128
// over half t / 128 of the tile's points, in order, and the two halves'
// sums meet in `part` ([2][4][WH] f32), added in half order.  The a7
// column sums: a thread per column, the 128 points in order.  The sums of
// g: warp j < 4 over column j, each lane 4 points, then the lanes by
// shuffles.
__device__ __forceinline__ void heads(unsigned char* X, const unsigned char* Y, const float* gs,
                                      const float* fp, float* facc, float* part) {
  const int t = threadIdx.x, j = t & (WH - 1), half = t >> 7;
  {
    const float wr0 = fp[FP_WR + j], wr1 = fp[FP_WR + WH + j], wr2 = fp[FP_WR + 2 * WH + j];
    float gbv = 0.f, gw0 = 0.f, gw1 = 0.f, gw2 = 0.f;
    unsigned char* col = X + (j >> 6) * CHUNK_B;
#pragma unroll 4
    for (int p = half * (T / 2); p < (half + 1) * (T / 2); ++p) {
      bf16* e = reinterpret_cast<bf16*>(col + swz128(p, j & 63));
      const float hv = __bfloat162float(*e);
      const float g0 = rnd<true>(gs[p * 4]), g1 = rnd<true>(gs[p * 4 + 1]),
                  g2 = rnd<true>(gs[p * 4 + 2]);
      float d = fmaf(g2, wr2, fmaf(g1, wr1, g0 * wr0));
      d = hv > 0.f ? d : 0.f;
      *e = __float2bfloat16_rn(d);
      gbv += d;
      gw0 = fmaf(g0, hv, gw0);
      gw1 = fmaf(g1, hv, gw1);
      gw2 = fmaf(g2, hv, gw2);
    }
    float* pp = part + half * 4 * WH;
    pp[j] = gbv;
    pp[WH + j] = gw0;
    pp[2 * WH + j] = gw1;
    pp[3 * WH + j] = gw2;
  }
  if (W == NCONS || t < W) {  // one a7 column a thread (width 128: half the threads)
    float gwa = 0.f;
    const unsigned char* col = Y + (t >> 6) * CHUNK_B;
#pragma unroll 4
    for (int p = 0; p < T; ++p) {
      const float a7 = __bfloat162float(*reinterpret_cast<const bf16*>(col + swz128(p, t & 63)));
      gwa = fmaf(rnd<true>(gs[p * 4 + 3]), a7, gwa);
    }
    facc[FP_WA + t] += gwa;
  }
  named_bar(BAR_CONS, NCONS);
  if (t < WH) {
    facc[FP_BV + t] += part[t] + part[4 * WH + t];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      facc[FP_WR + i * WH + t] += part[(1 + i) * WH + t] + part[(5 + i) * WH + t];
    const int w = t >> 5, lane = t & 31;  // warp w < 4: the sum of g's column w
    float sum = ((gs[lane * 4 + w] + gs[(lane + 32) * 4 + w]) + gs[(lane + 64) * 4 + w]) +
                gs[(lane + 96) * 4 + w];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) facc[w < 3 ? FP_BR + w : FP_BA] += sum;
  }
}

template <bool PROF>
__device__ __forceinline__ void consumer(const DgradArgs& a) {
  const int tid = threadIdx.x;
  float* stage = at<float>(SM_STAGE);
  float* facc = at<float>(SM_FACC);
  float* xs = at<float>(SM_XS);
  float* gs = at<float>(SM_GS);
  unsigned char* X = buf(0);
  unsigned char* Y = buf(1);
  const int P = a.P;
  Ring ring{0};
  uint32_t pm = 0;  // bit 4 b + c: parity of chunk c of buffer b's next m_full wait
  uint32_t px = 0;  // parity of the next x_read wait
  int sb = 0;       // staging buffer of the next layer
  auto wait_chunks = [&](int b, int n) {
    for (int c = 0; c < n; ++c) {
      const int i = 4 * b + c;
      mbar_wait(bar(M_FULL + i), (pm >> i) & 1);
      pm ^= 1u << i;
    }
  };
  auto free_chunks = [&](int b, int n) {  // a warpgroup's reads of them are done
    if ((tid & 127) == 0)
      for (int c = 0; c < n; ++c) mbar_arrive(bar(B_FREE + 4 * b + c));
  };
  auto wait_x_read = [&]() {
    mbar_wait(bar(X_READ), px);
    px ^= 1u;
  };

  // this thread's share of a tile's xd and g (zeros past P), fetched into
  // registers while the previous tile ends: half row tid & 1 of point
  // tid / 2, and g of point tid (tid < T)
  float4 nx, ng;
  auto fetch = [&](int q0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int p = q0 + (tid >> 1);
    nx = p < P ? __ldg(reinterpret_cast<const float4*>(a.xd + (size_t)p * 8) + (tid & 1)) : zero;
    ng = tid < T && q0 + tid < P ? __ldg(reinterpret_cast<const float4*>(a.g) + q0 + tid) : zero;
  };
  fetch(blockIdx.x * T);

  for (int c = tid; c < FP_NUMEL; c += NCONS) facc[c] = 0.f;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int p0 = tile * T;
    Stamper<PROF> st{PROF && blockIdx.x == 0 && tid == 0
                         ? a.stamps + (size_t)(tile / gridDim.x) * N_STAMPS : nullptr, 0};
    // A W-wide layer: d_z from tile buffer `in` (nk chunks, each given
    // back to the producer as soon as it is read if give_back) into tile
    // buffer `out`, whose stash columns, the relu mask, the producer loaded
    // while the previous layer ran (waited here if wait_mask); with
    // wait_x, `out` is `in` and the producer's store of it must have read
    // it first.  Three stamps: the end of its matmul, of those waits, and
    // of the layer.
    auto wide = [&](int in, int nk, bool give_back, int out, bool wait_mask, bool mask,
                    bool alpha, bool wait_x, int bias_off) {
      float a0[HALF / 2], a1[HALF / 2];
      if constexpr (W == 256) matmul_wide(a0, a1, buf(in), nk, ring, give_back ? in : -1);
      else matmul_chunks(a0, buf(in), nk, ring, give_back ? in : -1);
      st.mark();
      if (wait_mask) wait_chunks(out, NCH);
      if (wait_x) wait_x_read();
      st.mark();
      unsigned char* o = buf(out);
      epilogue_half(a0, 0, o, mask, alpha, a.fp, gs, stage + sb * 8 * W);
      if constexpr (W == 256) epilogue_half(a1, 1, o, mask, alpha, a.fp, gs, stage + sb * 8 * W);
      layer_end(stage + sb * 8 * W, facc, bias_off, bar(D_READY + out));
      sb ^= 1;
      st.mark();
    };

    named_bar(BAR_CONS, NCONS);  // the previous tile's reads of xs and gs are done
    st.mark();
    reinterpret_cast<float4*>(xs + (tid >> 1) * 8)[tid & 1] = nx;
    if (tid < T) reinterpret_cast<float4*>(gs)[tid] = ng;
    named_bar(BAR_CONS, NCONS);
    st.mark();

    // heads: hv in X (chunks 0, 1), a7 in Y; then d_hv goes to the producer
    wait_chunks(1, NCH);
    wait_chunks(0, 2);
    heads(X, Y, gs, a.fp, facc, stage);
    fence_proxy_async();
    named_bar(BAR_CONS, NCONS);
    if (tid == 0) mbar_arrive(bar(D_READY));
    st.mark();

    // d_pe_d = d_hv Wvd, and the view lanes of d(xd)
    auto pe_d_pass = [&](auto r) {
      float acc_d[decltype(r)::value];
#pragma unroll
      for (int i = 0; i < decltype(r)::value; ++i) acc_d[i] = 0.f;
      matmul_narrow(acc_d, a.kd, X, 2, ring);
      st.mark();
      dxd_views(acc_d, a.kd, a.nfd, xs, stage, a.dxd, p0, P);
    };
    if (!WIDE_PE || a.kd <= 96) pe_d_pass(PeAcc<48>{});
    else if constexpr (WIDE_PE) pe_d_pass(PeAcc<64>{});
    st.mark();

    // The nine W-wide layers through one copy of the code (a copy per
    // layer missed the instruction cache every tile): l = 8 is d_feat =
    // d_hv Wvf (no mask), in place over d_hv in X once its store has read
    // it; l = 7 d_z7 (mask a7, in Y since the heads; plus g_alpha Wa); then
    // d_z6 (W7) .. d_z0 (W1), alternating buffers, each layer's A going back
    // to the producer for the mask of the next, and d_z0's A (d_z1 in Y) for
    // d_z5, reloaded from the dz scratch.
#pragma unroll 1
    for (int l = 8; l >= 0; --l) {
      const int in = (l & 1) || l == 8 ? 0 : 1;
      wide(in, l == 8 ? 2 : NCH, l < 8, l == 8 ? 0 : in ^ 1, l < 7, l < 8, l == 7, l == 8, l * W);
    }

    if (tile + (int)gridDim.x < a.ntiles) fetch(p0 + (int)gridDim.x * T);

    // d_pe_x = d_z0 W0 + d_z5 W5a (d_z0 in X, d_z5 in Y); Y then goes to the
    // next tile's a7, and X holds d_pe_x in f32 for d(xd), then the next hv
    auto pe_x_pass = [&](auto r) {
      float acc_x[decltype(r)::value];
#pragma unroll
      for (int i = 0; i < decltype(r)::value; ++i) acc_x[i] = 0.f;
#pragma unroll 1
      for (int b = 0; b < 2; ++b) {
        if (b == 1) wait_chunks(1, NCH);
        matmul_narrow(acc_x, a.kx, buf(b), NCH, ring);
      }
      free_chunks(1, NCH);
      wait_x_read();  // the producer's store of d_z0 from X
      dpe_to_smem(acc_x, a.kx, reinterpret_cast<float*>(X), WIDE_PE ? dpe_ld(a.kx) : DPE_LD);
    };
    if (!WIDE_PE || a.kx <= 96) pe_x_pass(PeAcc<48>{});
    else if constexpr (WIDE_PE) pe_x_pass(PeAcc<64>{});
    named_bar(BAR_CONS, NCONS);
    st.mark();
    dxd_from_smem(reinterpret_cast<const float*>(X), WIDE_PE ? dpe_ld(a.kx) : DPE_LD, a.nfx, xs,
                  a.dxd, p0, P);
    fence_proxy_async();  // before the next TMA load into X
    named_bar(BAR_CONS, NCONS);
    free_chunks(0, 2);
    st.mark();
  }
  named_bar(BAR_CONS, NCONS);
  for (int c = tid; c < FP_NUMEL; c += NCONS)
    a.fp_part[(size_t)blockIdx.x * FP_NUMEL + c] = facc[c];
}

// ---------------------------------------------------------------------------
// producer
// ---------------------------------------------------------------------------

__device__ __forceinline__ void producer(const CUtensorMap* tm_acts, const CUtensorMap* tm_dz,
                                         const DgradArgs& a) {
  unsigned char* ring = dsmem + SM_RING;
  int k = 0;  // weight pieces issued
  // bit 4 b + c: parity of chunk c of buffer b's next b_free wait.  Parity 1
  // passes on a fresh barrier: every chunk starts free except X's chunks 2
  // and 3, which d_feat fills before the first layer that gives them back.
  uint32_t pf = 0xF3u;
  uint32_t pr = 0;  // bit b: parity of buffer b's next d_ready wait
  // rows [row0, row0 + rows) of chunk c of block blk (N rows a chunk)
  auto piece = [&](int blk, int c, int N, int row0, int rows) {
    const int s = k % N_WST;
    mbar_wait(bar(W_EMPTY + s), ((k / N_WST) & 1) ^ 1);
    mbar_arrive_expect_tx(bar(W_FULL + s), rows * 128);
    bulk_g2s(ring + s * WST_B, a.wt + a.wt_off[blk] + ((size_t)c * N + row0) * 64, rows * 128,
             bar(W_FULL + s));
    ++k;
  };
  // chunk c of columns from `col` of the stash (or, with reload, of the dz
  // scratch) into chunk c of tile buffer b, once the consumers give it back
  // and, with after_store, the buffer's store (the last NCH groups) has
  // read it
  auto load = [&](int b, int c, int col, int p0, bool after_store, bool reload) {
    const int i = 4 * b + c;
    mbar_wait(bar(B_FREE + i), (pf >> i) & 1);
    pf ^= 1u << i;
    if (reload && c == 0) {
      bulk_wait<4>();  // every store but the last four is complete
      fence_proxy_async_global();
    }
    if (after_store) wait_store_read(c);
    const CUtensorMap* map = reload ? tm_dz : tm_acts;
    mbar_arrive_expect_tx(bar(M_FULL + i), CHUNK_B);
    tma_load_2d(buf(b) + c * CHUNK_B, map, col + 64 * c, p0, bar(M_FULL + i));
  };
  // the d_z in tile buffer b (nch chunks) to the dz scratch at column col,
  // once the consumers have written it: one bulk group a chunk
  auto store = [&](int b, int col, int nch, int p0) {
    mbar_wait(bar(D_READY + b), (pr >> b) & 1);
    pr ^= 1u << b;
    for (int c = 0; c < nch; ++c) {
      tma_store_2d(tm_dz, buf(b) + c * CHUNK_B, col + 64 * c, p0);
      bulk_commit();
    }
  };
  auto signal_x_read = [&]() {
    bulk_wait_read<0>();
    mbar_arrive(bar(X_READ));
  };
  // A W-wide layer that reads tile buffer `in`: its first two chunks'
  // pieces, then the store of the previous layer's d_z (in `in`, nch chunks
  // at column prev_col; x_read signalled after it with signal), then the
  // other pieces; with give_back, then the next layer's mask (stash
  // columns from col, or d_z5 with reload) into `in`, chunk by chunk as the
  // consumers give it back.  No piece waits behind a store.
  auto wide = [&](int blk, int nk, int in, int prev_col, int nch, bool signal, bool give_back,
                  int col, bool reload, int p0) {
    for (int c = 0; c < 2; ++c) {
      piece(blk, c, W, 0, HALF);
      if constexpr (W == 256) piece(blk, c, W, HALF, HALF);
    }
    store(in, prev_col, nch, p0);
    if (signal) signal_x_read();
    for (int c = 2; c < nk; ++c) {
      piece(blk, c, W, 0, HALF);
      if constexpr (W == 256) piece(blk, c, W, HALF, HALF);
    }
    if (give_back)
      for (int c = 0; c < nk; ++c) load(in, c, col, p0, true, reload);
  };
  auto narrow = [&](int blk, int nk, int N) {
    for (int c = 0; c < nk; ++c) piece(blk, c, N, 0, N);
  };
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int p0 = tile * T;
    // a7 into Y (stored from last as d_z1, complete since the reload); the
    // previous tile's d_z0 store from X read, then hv into X
    narrow(T_WVD, 2, a.kd);
    for (int c = 0; c < NCH; ++c) load(1, c, 7 * W, p0, false, false);
    if (tile != (int)blockIdx.x) signal_x_read();
    for (int c = 0; c < 2; ++c) load(0, c, 9 * W, p0, false, false);
    // the consumers' nine W-wide layers: l = 8 reads d_hv (Wvf; its
    // store signalled), l = 7 d_feat (Wf; a6 into X), l = 6 d_z7 (W7; a5
    // into Y), .. l = 0 d_z1 (W1; d_z5 back into Y)
#pragma unroll 1
    for (int l = 8; l >= 0; --l) {
      const int in = (l & 1) || l == 8 ? 0 : 1, blk = l + (l >= 4 ? T_W5B - 4 : T_W1);
      wide(blk, l == 8 ? 2 : NCH, in, (l + 1) * W, l == 8 ? 2 : NCH, l == 8, l < 8,
           l > 0 ? (l - 1) * W : 5 * W, l == 0, p0);
    }
    narrow(T_W0, NCH, a.kx);
    store(0, 0, NCH, p0);  // d_z0
    narrow(T_W5A, NCH, a.kx);
  }
  signal_x_read();  // the last tile's d_z0
  bulk_wait<0>();
}

template <bool PROF>
__global__ void __launch_bounds__(NTHR, 1)
    nerf_mlp_dgrad_sm90(const __grid_constant__ CUtensorMap tm_acts,
                        const __grid_constant__ CUtensorMap tm_dz,
                        const __grid_constant__ DgradArgs a) {
  if (smem_u32(dsmem) & 1023) __trap();  // the swizzled operands need 1024-byte alignment
  if (threadIdx.x == 0) {
    for (int i = 0; i < N_BARS; ++i) {
      const bool warps = i >= W_EMPTY && i < M_FULL, wgs = i >= B_FREE && i < D_READY;
      mbar_init(bar(i), warps ? NCONS / 32 : wgs ? 2 : 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= NCONS) {
    regs_dec<PROD_REGS>();
    if (threadIdx.x == NCONS) producer(&tm_acts, &tm_dz, a);
    else if (threadIdx.x >= NCONS + 32) pe_store(a);
  } else {
    regs_inc<CONS_REGS>();
    consumer<PROF>(a);
  }
}

// ---------------------------------------------------------------------------
// the f32 dgrad: the split
// ---------------------------------------------------------------------------
//
// Replaces, in f32 mode, the same Pallas kernels as the bf16 dgrad above
// (`_bwd_math` of `_bwd_stash_kernel`, lushnerf_tpu/ops/fused/
// nerf_mlp.py:608, run in f32 at Precision.HIGHEST).
//
// What bounds it: bytes.  Per point it reads 8,704 B of f32 stash (a0..a7
// and hv) and 48 B of xd and g, and writes 9,728 B of dz, 384 B of PE and
// 32 B of d(xd): 3.7 ms at P = 655,360, against 2.4 ms for one pass of the
// split's three fp16 products at the tensor rate.
//
// The split: the chain of d_z is linear in each point's g, with the relu
// masks fixed by the stash, so each row of a d_z (a point) may carry its
// own power of two.  The tile buffer holds every d_z row times 2^s (s per
// row, carried in registers from layer to layer: `Rows`), split in two
// fp16 parts hi = fp16(x) and lo = fp16(x - hi), with s chosen in each
// epilogue so that the row's largest |x| lies in [2^14, 2^15): its parts
// hold x within ~2^-22 of it down to 2^-17 of the row's largest value,
// whatever the range of g (the loss's mean over rays sends much of the
// cotangent below fp16's smallest normal).  The weights' parts are those of
// W^T 2^SPLIT_SHIFT (pack_params_bwd, |w| < 4094).  A product is hi(A)
// hi(W) + lo(A) hi(W) + hi(A) lo(W) in one f32 accumulator, which holds
// 2^(s + SPLIT_SHIFT) times the layer's sum; the epilogue masks v = acc
// 2^-SPLIT_SHIFT (d_z7's g_alpha term added first), sums its true values
// (v 2^-s, exact) into the bias grads, and splits v at the row's new scale
// over the buffer.  d_pe and d(xd) are true values too; dz holds (hi + lo)
// 2^-s, the split's value of each d_z.  Every scale is a power of two, so
// the kernel is equivariant: g 2^k gives 2^k times every output, bit for
// bit.
//
// Design: one block per SM loops over 128-point tiles; two consumer
// warpgroups, 64 points each, run every product on wgmma (m64n256k16 for
// the 256-wide layers, m64nNk16 for the d_pe passes); one producer thread
// streams the split blob's pieces through the ring; three PE warps do the
// rest off the consumers' path.  Shared memory: one tile buffer,
// [128][256] in both parts (128 KB: the hi chunks, then the lo chunks),
// each layer's d_z written over its input once its warpgroup's wgmmas have
// read it (each warpgroup reads and writes only its own 64 rows); a ring of
// four 16 KB stages, which holds one 64-deep chunk of a 256-wide layer (hi
// rows 0..127, hi 128..255, lo, lo; the hi pair in neighbouring stages for
// one m64n256k16) or two of a d_pe pass (hi, lo); the column-sum staging;
// the relu masks as bits, two layers' worth; the bias sums.  The PE warps
// read each stash column block once and make its mask bits, so that the
// consumers load nothing from the stash (a float2 mask load a fragment
// pair would hold 16 more registers beside the 128 of the accumulator, and
// its latency would sit in every epilogue); they store each layer's d_z to
// dz out of the buffer while the next layer's matmul runs (the consumers'
// own stores, 64 float2 stores a thread a layer, cost 2.6 of 9.8 ms,
// PERF.md), write d_hv to dz and the PE to its scratch, and sum the heads'
// grads in their registers; beside each block of dz they write its scale
// units for the f32 wgrad (`zs`: per tile and PE warp, the largest 1 / 2^s
// of the rows stored, which the consumers set to 0 for a zero row; for d_hv
// the unit of its largest |value|).  d_pe_x = d_z0 W0 + d_z5 W5a: the W5a
// pass runs right after d_z5's epilogue and its true f32 partial goes to a
// per-block global scratch, which the same threads read back after the W0
// pass and add in that order.  The PE warps' work is most of a tile's time (their
// cycle counts, DGRAD_OFF_PATH_F32): they, and the one-chunk ring, hold
// the kernel.
//
// The f32 dgrad is compiled for the width W of nerf_mlp_common.cuh.  At
// width 128 (the views layer padded to 128 lanes) every W-wide layer is one
// m64n128k16 a step over a chunk of two pieces (hi, lo), two chunks deep;
// the tile buffer, the ring and the mask slots keep their places and
// sizes (half of the buffer and of each mask row idle), the column sums
// and the bias sums take W columns; a PE warp reads a stash row of a
// W-wide block as one float4 a lane and stores two d_z rows a step, 16
// lanes each.

constexpr int F_LO = 4 * CHUNK_B;               // the lo parts follow the hi parts
constexpr int F_RING = 2 * F_LO;                // after the tile buffer (128 KB)
constexpr int F_STAGE = F_RING + N_WST * WST_B;  // [2][8 warps][W] f32 column sums
// the staging's bytes: the column sums, and dxd_views's [T][32] f32 (16 KB,
// the column sums' size at width 256)
constexpr int F_STAGE_B = 2 * 8 * W * 4 > T * 32 * 4 ? 2 * 8 * W * 4 : T * 32 * 4;
constexpr int F_MASK = F_STAGE + F_STAGE_B;      // [2][T][8] u32: relu mask bits
constexpr int F_FACC = F_MASK + 2 * T * 8 * 4;   // [FP_BV] f32: the bias sums
constexpr int F_INV = F_FACC + FP_BV * 4;        // [T] f32: each row's 1 / 2^s
constexpr int F_BARS = F_INV + T * 4;
// mbarriers: a ring stage loaded (FW_FULL + s) and read by the 8 consumer
// warps (FW_EMPTY + s); a mask slot written by the 96 PE threads (FM_FULL +
// s) and read by the 8 consumer warps (FM_FREE + s); a layer's d_z split
// into the tile buffer (FD_READY, consumer thread 0) and stored from it to
// dz by the 96 PE threads (FD_READ)
enum { FW_FULL = 0, FW_EMPTY = FW_FULL + N_WST, FM_FULL = FW_EMPTY + N_WST, FM_FREE = FM_FULL + 2,
       FD_READY = FM_FREE + 2, FD_READ, F_N_BARS };
constexpr int SMEM_F32 = F_BARS + F_N_BARS * 8;
static_assert(SMEM_F32 <= 232448, "shared memory over the 227 KB a block may use");
constexpr int SPLIT_SHIFT = 4;                  // the weights' parts are those of W^T 2^4
constexpr float SPLIT_ACC = 1 << SPLIT_SHIFT;
constexpr int ROW_EXP = 15;                     // a row's largest |x| in [2^14, 2^15)
constexpr int ZS_BLOCKS = 10;                   // dz blocks with scale units: d_z0..d_z7, d_feat, d_hv
constexpr int PE_THR = 96;                      // the PE warps: 9, 10 and 11
constexpr int BAR_WG0 = 2;                      // named barriers 2, 3: consumer warpgroup 0, 1
constexpr int BAR_PE = 4;                       // the PE warps
constexpr int N_STAMPS_F32 = N_STAMPS + 1;      // and the W5a pass
// at width W: a d_z is F_NA chunks of 64 columns, a W-wide layer's
// accumulator F_ACC values a thread, a stash row of a W-wide block F_NQ
// float4s a lane of a PE warp
constexpr int F_NA = W / 64;
constexpr int F_ACC = W / 2;
constexpr int F_NQ = W / 128;
// then, off the consumers' path, PE thread 0's cycles a tile: waiting for
// a free mask slot, waiting for a d_z to store, making masks, storing d_z,
// encoding the PE (nerf_mlp.DGRAD_OFF_PATH_F32)
enum { PW_FREE, PW_READY, PW_MASKS, PW_DZ, PW_PE, N_PW };
constexpr int STAMP_ROW_F32 = N_STAMPS_F32 + N_PW;

struct DgradArgsF {
  const float* xd;     // [P, 8]
  const float* g;      // [P, 4]
  const float* fp;     // the f32 blob
  const __half* wt;    // the split transposed blob
  long long wt_off[N_WT];
  const float* acts;   // [P, ACTS_LD] the f32 stash
  float* dz;           // [P, ACTS_LD]
  float* pe;           // [P, kx + kd]
  float* dxd;          // [P, 8]
  float* fp_part;      // [gridDim.x, FP_NUMEL]
  float* dpe5;         // [gridDim.x, T, kx]: the W5a pass's partial
  float* zs;           // [ntiles][ZS_BLOCKS][3]: dz's scale units (the wgrad's)
  long long* stamps;   // [block 0's tiles][STAMP_ROW_F32] or null
  int P, kx, kd, nfx, nfd, ntiles;
};

__device__ __forceinline__ uint64_t* fbar(int i) {
  return reinterpret_cast<uint64_t*>(dsmem + F_BARS) + i;
}
__device__ __forceinline__ uint32_t* mask_slot(int s) {
  return reinterpret_cast<uint32_t*>(dsmem + F_MASK) + s * T * 8;
}
__device__ __forceinline__ float pow2(int r) { return __int_as_float((127 + r) << 23); }
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static_assert(FW_FULL == 0 && FW_EMPTY == N_WST, "the f32 ring's barriers");
using RingF = RingT<F_BARS, F_RING>;

// One 64-deep chunk, fp16: four m64nNk16 steps.
template <int N, int R>
__device__ __forceinline__ void mma_chunk(float (&acc)[R], const unsigned char* A,
                                          const unsigned char* B) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t da = wgmma_desc(A + ks * 32), db = wgmma_desc(B + ks * 32);
    if constexpr (N == 256) wgmma_m64n256k16<R, true>(acc, da, db, 1);
    else if constexpr (N == 128) wgmma_m64n128k16<R, true>(acc, da, db, 1);
    else if constexpr (N == 96) wgmma_m64n96k16<R, true>(acc, da, db, 1);
    else if constexpr (N == 64) wgmma_m64n64k16<R, true>(acc, da, db, 1);
    else wgmma_m64n32k16<R, true>(acc, da, db, 1);
  }
}

// acc = A[wg rows, 0 : 64 nk] . B^T in the split, A the tile buffer: per
// chunk one wgmma group hi(A) hi(B) + lo(A) hi(B) on its hi piece(s), then
// one group hi(A) lo(B) on its lo piece(s); each group's pieces go back to
// the ring as soon as it is done, one group kept in flight.  N = 256: a
// part of a chunk is two neighbouring pieces (rows 0..127, 128..255), read
// by one m64n256k16; else one piece of N rows.
template <int N, int R>
__device__ __forceinline__ void matmul_split(float (&acc)[R], int nk, RingF& ring) {
  constexpr int NP = N == 256 ? 2 : 1;
  const int wg_off = (threadIdx.x >> 7) * 64 * 128;
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const unsigned char* Ah = dsmem + c * CHUNK_B + wg_off;
    const unsigned char* Bh = ring.wait(ring.k);
    if (NP == 2) ring.wait(ring.k + 1);
    wgmma_fence();
    wgmma_fence_regs(acc);
    mma_chunk<N>(acc, Ah, Bh);
    mma_chunk<N>(acc, Ah + F_LO, Bh);
    wgmma_commit();
    if (c > 0) {  // the chunk before: its lo group is done
      wgmma_wait<1>();
      for (int i = 0; i < NP; ++i) ring.release(ring.k - NP + i);
    }
    const unsigned char* Bl = ring.wait(ring.k + NP);
    if (NP == 2) ring.wait(ring.k + NP + 1);
    wgmma_fence();
    wgmma_fence_regs(acc);
    mma_chunk<N>(acc, Ah, Bl);
    wgmma_commit();
    wgmma_wait<1>();  // this chunk's hi group is done
    for (int i = 0; i < NP; ++i) ring.release(ring.k + i);
    ring.k += 2 * NP;
  }
  wgmma_wait<0>();
  for (int i = 0; i < NP; ++i) ring.release(ring.k - NP + i);
  wgmma_fence_regs(acc);
}

// A d_pe pass of N = kx or kd columns over nk chunks: acc[48] up to N =
// 96, acc[64] at 128.
__device__ __forceinline__ void matmul_split_narrow(float (&acc)[48], int N, int nk, RingF& ring) {
  if (N == 32) matmul_split<32>(acc, nk, ring);
  else if (N == 64) matmul_split<64>(acc, nk, ring);
  else matmul_split<96>(acc, nk, ring);
}
__device__ __forceinline__ void matmul_split_narrow(float (&acc)[64], int, int nk, RingF& ring) {
  matmul_split<128>(acc, nk, ring);
}

// This thread's two rows (r0, r0 + 8): the tile buffer holds each row's d_z
// times sc, inv = 1 / sc (powers of two).
struct Rows {
  float sc[2], inv[2];
};

// The power of two r that puts a row's largest |value| mx in [2^14, 2^15)
// (0 for a zero row), from mx's exponent bits.
__device__ __forceinline__ int row_shift(float mx) {
  if (!(mx > 0.f)) return 0;
  const int e = ((__float_as_int(mx) >> 23) & 255) - 126;  // mx = m 2^e, m in [0.5, 1)
  return min(max(ROW_EXP - e, -100), 100);
}

// The largest |value| of each of this thread's rows over the row's four
// threads (lanes xor 1, 2), and the scale that follows from it: rs is
// updated, `up` (2^r per row) returned for the split store, 0 for a row
// that is all zeros (its parts are zeros either way), which marks it.
// A row's whole scale (rs.sc, 2^cur) stays within 2^+-100, the clamp of
// row_shift and of the scale units (`dz_scale_units`): on a cotangent so
// small that a row needs more (a denormal g, say), each layer's r would
// add up past f32's range, sc reach inf and g * sc give inf or NaN; the
// row is left under-scaled instead (its parts lose bits only below 2^-100
// of the true values).
__device__ __forceinline__ void rescale(float (&mx)[2], Rows& rs, float (&up)[2]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const int cur = ((__float_as_int(rs.sc[rr]) >> 23) & 255) - 127;
    const int r = min(max(row_shift(mx[rr]), -100 - cur), 100 - cur);
    const float f = pow2(r);
    up[rr] = mx[rr] > 0.f ? f : 0.f;
    rs.sc[rr] *= f;
    rs.inv[rr] *= pow2(-r);
  }
}


// The fragment v (R = N / 2 values: rows r0 | r0 + 8 of columns 8 j + 2 q,
// + 1) times up[row], split in its fp16 parts over this thread's rows of
// the tile buffer's hi and lo chunks (stmatrix, two 8x8 matrices of each
// part a 16-column step).
template <int R>
__device__ __forceinline__ void split_store(const float (&v)[R], const float (&up)[2]) {
  const Frag f;
  const int lane = threadIdx.x & 31, rr = lane & 7, hi = lane >> 4;
  const int row = f.r0 - (lane >> 2) + ((lane >> 3) & 1) * 8 + rr;
  unsigned char* base = dsmem + row * 128;
#pragma unroll
  for (int j = 0; j < R / 4; j += 2) {  // columns 8 j .. 8 j + 15
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // pair i: row r0 + 8 (i & 1) of column block j + (i >> 1)
      const float x = v[4 * j + 2 * i] * up[i & 1], y = v[4 * j + 2 * i + 1] * up[i & 1];
      ph[i] = pack_f16(x, y);
      const float2 h = unpack_f16(ph[i]);
      pl[i] = pack_f16(x - h.x, y - h.y);
    }
    const int off = (j >> 3) * CHUNK_B + ((((j & 7) + hi) ^ rr) << 4);
    stsm_x4(base + off, ph[0], ph[1], ph[2], ph[3]);
    stsm_x4(base + F_LO + off, pl[0], pl[1], pl[2], pl[3]);
  }
}

// The column sums of 8 columns of the warp's 16 rows (cs: this thread's two
// rows' sum of each of its 8 columns, 2 jj + h for column 8 (4 g + jj) +
// 2 q + h) into the staging row of the warp, as epilogue_half sums them.
__device__ __forceinline__ void stage_colsums(float (&cs)[8], int g, float* stage) {
  const Frag f;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16, n = 4; o >= 4; o >>= 1, n >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const float send = upper ? cs[k] : cs[n + k];
      const float keep = upper ? cs[n + k] : cs[k];
      cs[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  const int i = (lane >> 2) & 7;
  stage[f.warp8 * W + 8 * (4 * g + (i >> 1)) + 2 * f.q + (i & 1)] = cs[0];
}

// d_hv = (g_rgb Wr) * [hv > 0] in the fragment of a 128-wide layer, its
// rows' scale chosen, split into chunks 0 and 1 of the tile buffer.  (The
// PE warps write its true values to dz and sum its grads.)
__device__ __forceinline__ void d_hv_split(const DgradArgsF& a, int p0, const uint32_t* bits,
                                           Rows& rs) {
  const Frag f;
  float4 gg[2];
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = p0 + f.r0 + 8 * rr;
    gg[rr] = p < a.P ? __ldg(reinterpret_cast<const float4*>(a.g) + p) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[64];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * f.q;
    const float2 w0 = __ldg(reinterpret_cast<const float2*>(a.fp + FP_WR + col));
    const float2 w1 = __ldg(reinterpret_cast<const float2*>(a.fp + FP_WR + WH + col));
    const float2 w2 = __ldg(reinterpret_cast<const float2*>(a.fp + FP_WR + 2 * WH + col));
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const uint32_t word = bits[(f.r0 + 8 * rr) * 8 + (j >> 2)] >> (8 * (j & 3) + 2 * f.q);
      const float4 q = gg[rr];
      const float d0 = fmaf(q.z, w2.x, fmaf(q.y, w1.x, q.x * w0.x));
      const float d1 = fmaf(q.z, w2.y, fmaf(q.y, w1.y, q.x * w0.y));
      v[4 * j + 2 * rr] = (word & 1u) ? d0 : 0.f;
      v[4 * j + 2 * rr + 1] = (word & 2u) ? d1 : 0.f;
      mx[rr] = fmaxf(mx[rr], fmaxf(fabsf(v[4 * j + 2 * rr]), fabsf(v[4 * j + 2 * rr + 1])));
    }
  }
  rs.sc[0] = rs.sc[1] = rs.inv[0] = rs.inv[1] = 1.f;
  float up[2];
  rescale(mx, rs, up);
  split_store(v, up);
}

// d_z7's g_alpha term in its accumulator: acc += 2^(s + SHIFT) g_alpha Wa
// (as exact as adding g_alpha 2^s Wa to acc 2^-SHIFT: a power-of-two scale).
__device__ __forceinline__ void add_alpha(float (&acc)[F_ACC], const Rows& rs, const DgradArgsF& a,
                                          int p0) {
  const Frag f;
  float ga[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = p0 + f.r0 + 8 * rr;
    ga[rr] = p < a.P ? __ldg(a.g + (size_t)p * 4 + 3) * rs.sc[rr] * SPLIT_ACC : 0.f;
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 wa = __ldg(reinterpret_cast<const float2*>(a.fp + FP_WA + 8 * j + 2 * f.q));
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      acc[4 * j + 2 * rr] = fmaf(ga[rr], wa.x, acc[4 * j + 2 * rr]);
      acc[4 * j + 2 * rr + 1] = fmaf(ga[rr], wa.y, acc[4 * j + 2 * rr + 1]);
    }
  }
}

// The epilogue of a 256-wide layer from its accumulator (2^(s +
// SPLIT_SHIFT) times d_a), up to its split store: v = acc 2^-SHIFT times
// the mask bits, ORed with `ones` (all ones for d_feat, which has no
// mask), in place; the column sums of its true values (v / 2^s) into
// `stage`; the rows' new scale (rs), and `up`, the factor that takes v to
// it.  No branch on the layer, so that one copy serves all nine.
__device__ __forceinline__ void epilogue_wide(float (&acc)[F_ACC], Rows& rs, const uint32_t* bits,
                                              uint32_t ones, float* stage, float (&up)[2]) {
  const Frag f;
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < W / 32; ++g) {  // 32 columns: one mask word a row
    const uint32_t word[2] = {bits[f.r0 * 8 + g] | ones, bits[(f.r0 + 8) * 8 + g] | ones};
    float cs[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * g + jj;
      float t[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const uint32_t m = word[rr] >> (8 * jj + 2 * f.q);
        float x = acc[4 * j + 2 * rr] * (1.f / SPLIT_ACC), y = acc[4 * j + 2 * rr + 1] * (1.f / SPLIT_ACC);
        x = (m & 1u) ? x : 0.f;
        y = (m & 2u) ? y : 0.f;
        acc[4 * j + 2 * rr] = x;
        acc[4 * j + 2 * rr + 1] = y;
        mx[rr] = fmaxf(mx[rr], fmaxf(fabsf(x), fabsf(y)));
        t[rr][0] = x * rs.inv[rr];
        t[rr][1] = y * rs.inv[rr];
      }
      cs[2 * jj] = t[0][0] + t[1][0];
      cs[2 * jj + 1] = t[0][1] + t[1][1];
    }
    stage_colsums(cs, g, stage);
  }
  rescale(mx, rs, up);
}

// A d_pe pass's fragment to true values: acc 2^-(s + SHIFT) per row.
template <int R> __device__ __forceinline__ void to_true(float (&acc)[R], const Rows& rs) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] *= rs.inv[(i >> 1) & 1] * (1.f / SPLIT_ACC);
}

// This thread's W5a partial of d_pe_x (N columns) to or from the block's
// scratch rows, at its fragment positions: the same thread reads back what
// it wrote.
template <bool LOAD, int R>
__device__ __forceinline__ void dpe5_io(float (&acc)[R], int N, float* dpe5) {
  const Frag f;
  float* base = dpe5 + (size_t)blockIdx.x * T * N;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (8 * j >= N) break;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float2* p = reinterpret_cast<float2*>(base + (size_t)(f.r0 + 8 * rr) * N + 8 * j + 2 * f.q);
      if (LOAD) {
        const float2 v = *p;
        acc[4 * j + 2 * rr] += v.x;
        acc[4 * j + 2 * rr + 1] += v.y;
      } else {
        *p = make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      }
    }
  }
}

template <bool PROF>
__device__ __forceinline__ void consumer_f32(const DgradArgsF& a) {
  const int tid = threadIdx.x, wg = tid >> 7;
  float* stage = reinterpret_cast<float*>(dsmem + F_STAGE);
  float* facc = reinterpret_cast<float*>(dsmem + F_FACC);
  const int P = a.P;
  RingF ring{0};
  int mk = 0;  // mask slots taken
  int sb = 0;  // staging buffer of the next layer
  auto take_mask = [&]() -> const uint32_t* {
    mbar_wait(fbar(FM_FULL + (mk & 1)), (mk >> 1) & 1);
    return mask_slot(mk & 1);
  };
  auto give_mask = [&]() {
    if ((tid & 31) == 0) mbar_arrive(fbar(FM_FREE + (mk & 1)));
    ++mk;
  };
  int dr = 0;  // d_z stores of the PE warps waited for
  auto wait_dz_read = [&]() {  // the PE warps have read the last d_z out of the buffer
    mbar_wait(fbar(FD_READ), dr & 1);
    ++dr;
  };
  float* inv_rows = reinterpret_cast<float*>(dsmem + F_INV);
  for (int c = tid; c < FP_BV; c += NCONS) facc[c] = 0.f;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int p0 = tile * T;
    Stamper<PROF> st{PROF && blockIdx.x == 0 && tid == 0
                         ? a.stamps + (size_t)(tile / gridDim.x) * STAMP_ROW_F32 : nullptr, 0};
    const float* xs = a.xd + (size_t)p0 * 8;
    Rows rs;
    named_bar(BAR_CONS, NCONS);  // the previous tile's reads of the buffer are done
    st.mark();
    st.mark();  // (no loads: the "load" stage is empty)

    d_hv_split(a, p0, take_mask(), rs);
    give_mask();
    fence_proxy_async();
    named_bar(BAR_WG0 + wg, 128);
    st.mark();

    // d_pe_d = d_hv Wvd, and the view lanes of d(xd)
    auto pe_d_pass = [&](auto r) {
      float acc_d[decltype(r)::value];
      matmul_split_narrow(acc_d, a.kd, WH / 64, ring);
      st.mark();
      to_true(acc_d, rs);
      dxd_views(acc_d, a.kd, a.nfd, xs, stage, a.dxd, p0, P);
    };
    if (!WIDE_PE || a.kd <= 96) pe_d_pass(PeAcc<48>{});
    else if constexpr (WIDE_PE) pe_d_pass(PeAcc<64>{});
    st.mark();

    // the nine 256-wide layers through one copy of the code: l = 8 is d_feat
    // = d_hv Wvf (no mask), l = 7 d_z7 (plus g_alpha Wa), then d_z6 .. d_z0;
    // after d_z5 its W5a pass
#pragma unroll 1
    for (int l = 8; l >= 0; --l) {
      {
        float acc[F_ACC];
        matmul_split<W>(acc, l == 8 ? WH / 64 : F_NA, ring);
        st.mark();
        named_bar(BAR_WG0 + wg, 128);  // every warp of the warpgroup has read its A
        // d_feat has no mask: any slot's bits, ORed with all ones
        const uint32_t* bits = l < 8 ? take_mask() : mask_slot(0);
        st.mark();
        if (l == 7) add_alpha(acc, rs, a, p0);
        float up[2];
        epilogue_wide(acc, rs, bits, l < 8 ? 0u : 0xffffffffu, stage + sb * 8 * W, up);
        if (l < 8) {
          give_mask();
          wait_dz_read();  // before the split store overwrites d_z_(l + 1)
        }
        split_store(acc, up);
        if ((tid & 3) == 0) {  // the rows' 1 / 2^s (0: a zero row), for the PE warps' dz stores
          const Frag f;
          inv_rows[f.r0] = up[0] != 0.f ? rs.inv[0] : 0.f;
          inv_rows[f.r0 + 8] = up[1] != 0.f ? rs.inv[1] : 0.f;
        }
      }
      // the split store is complete: it goes to the next wgmma and, as dz,
      // to the PE warps (FD_READY)
      layer_end(stage + sb * 8 * W, facc, l * W, fbar(FD_READY));
      sb ^= 1;
      st.mark();
      if (l == 5) {
        auto w5a_pass = [&](auto r) {
          float acc5[decltype(r)::value];
          matmul_split_narrow(acc5, a.kx, F_NA, ring);
          to_true(acc5, rs);
          dpe5_io<false>(acc5, a.kx, a.dpe5);
        };
        if (!WIDE_PE || a.kx <= 96) w5a_pass(PeAcc<48>{});
        else if constexpr (WIDE_PE) w5a_pass(PeAcc<64>{});
        st.mark();
      }
    }

    // d_pe_x = d_z0 W0 + d_z5 W5a, then d(xd) through the buffer
    auto pe_x_pass = [&](auto r) {
      float acc_x[decltype(r)::value];
      matmul_split_narrow(acc_x, a.kx, F_NA, ring);
      to_true(acc_x, rs);
      dpe5_io<true>(acc_x, a.kx, a.dpe5);
      wait_dz_read();              // the PE warps have stored d_z0
      named_bar(BAR_CONS, NCONS);  // both warpgroups' wgmmas have read the buffer
      dpe_to_smem(acc_x, a.kx, reinterpret_cast<float*>(dsmem),
                  WIDE_PE ? dpe_ld(a.kx) : DPE_LD);
    };
    if (!WIDE_PE || a.kx <= 96) pe_x_pass(PeAcc<48>{});
    else if constexpr (WIDE_PE) pe_x_pass(PeAcc<64>{});
    named_bar(BAR_CONS, NCONS);
    st.mark();
    dxd_from_smem(reinterpret_cast<const float*>(dsmem), WIDE_PE ? dpe_ld(a.kx) : DPE_LD,
                  a.nfx, xs, a.dxd, p0, P);
    st.mark();
  }
  __syncthreads();  // every thread of the block: the PE warps' sums may use the buffer
  for (int c = tid; c < FP_BV; c += NCONS) a.fp_part[(size_t)blockIdx.x * FP_NUMEL + c] = facc[c];
}

// The PE warps of the f32 dgrad, per tile: the relu masks as bits in the
// consumers' order (hv, a7, a6, .., a0) into the two mask slots, each stash
// row read once as float4s (a lane's 4 columns as a nibble, ORed over 8
// lanes into a 32-column word); with hv, d_hv (true values) to dz, its bias
// grad and the rgb head's weight grads, and the sums of g; with a7, the
// alpha head's weight grad; the tile's PE to its scratch; and each 256-wide
// layer's d_z to dz, read out of the tile buffer ((hi + lo) / 2^s of each
// value, whole 1 KB rows) while the next layer's matmul runs.  The order
// (masks 0, 1, the PE, then each d_z followed by the mask two layers on)
// keeps one mask ahead of the consumers.  Warp w takes rows w, w + 3, ..;
// each thread sums its columns over its rows in order, tile after tile,
// and the three warps' sums meet at the end in warp order.
template <bool PROF>
__device__ __forceinline__ void pe_warps_f32(const DgradArgsF& a) {
  const int u = threadIdx.x - (NCONS + 32), warp = u >> 5, lane = u & 31;
  const bool on = PROF && blockIdx.x == 0 && u == 0;
  long long pw[N_PW], t0 = 0;  // thread 0's cycles by PW_* in this tile
  auto clk_begin = [&]() {
    if constexpr (PROF) {
      if (on) t0 = clock64();
    }
  };
  auto clk_end = [&](int i) {
    if constexpr (PROF) {
      if (on) pw[i] += clock64() - t0;
    }
  };
  const int P = a.P;
  float gbv[4] = {0.f, 0.f, 0.f, 0.f}, gw[3][4], gwa[4 * F_NQ], gsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4 * F_NQ; ++i) gwa[i] = 0.f;
  float4 wr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wr[k] = __ldg(reinterpret_cast<const float4*>(a.fp + FP_WR + k * WH) + lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) gw[k][c] = 0.f;
  }
  // one row's 4 columns as 4 bits, ORed with the 7 lanes beside: lane 8 i
  // then holds the word of columns 32 i .. 32 i + 31
  auto word_of = [&](float4 v) {
    uint32_t w = ((v.x > 0.f) | ((v.y > 0.f) << 1) | ((v.z > 0.f) << 2) | ((v.w > 0.f) << 3))
                 << (4 * (lane & 7));
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    w |= __shfl_xor_sync(0xffffffffu, w, 4);
    return w;
  };
  int mk = 0;  // masks made
  int dn = 0;  // d_z stored
  // mask m of the tile at p0 (0: hv, with d_hv and the heads' sums; m: a_(8
  // - m))
  auto make_mask = [&](int m, int p0) {
    const int s = mk & 1;
    clk_begin();
    mbar_wait(fbar(FM_FREE + s), ((mk >> 1) & 1) ^ 1);  // the consumers have read the slot
    clk_end(PW_FREE);
    clk_begin();
    uint32_t* bits = mask_slot(s);
    if (m == 0) {  // hv: 128 columns, a float4 a lane
      float mz = 0.f;  // the largest |d_hv| of the warp's rows
#pragma unroll 1
      for (int i0 = warp; i0 < T; i0 += 12) {
        float4 hv[4], g4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = i0 + 3 * r;
          const bool ok = p < T && p0 + p < P;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          hv[r] = ok ? __ldg(reinterpret_cast<const float4*>(a.acts + (size_t)(p0 + p) * ACTS_LD + 9 * W) + lane) : z;
          g4[r] = ok ? __ldg(reinterpret_cast<const float4*>(a.g) + p0 + p) : z;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = i0 + 3 * r;
          if (p >= T) break;
          const float4 q = g4[r], h = hv[r];
          const float hs[4] = {h.x, h.y, h.z, h.w};
          const float w0[4] = {wr[0].x, wr[0].y, wr[0].z, wr[0].w};
          const float w1[4] = {wr[1].x, wr[1].y, wr[1].z, wr[1].w};
          const float w2[4] = {wr[2].x, wr[2].y, wr[2].z, wr[2].w};
          float d[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            d[c] = fmaf(q.z, w2[c], fmaf(q.y, w1[c], q.x * w0[c]));
            d[c] = hs[c] > 0.f ? d[c] : 0.f;
            mz = fmaxf(mz, fabsf(d[c]));
            gbv[c] += d[c];
            gw[0][c] = fmaf(q.x, hs[c], gw[0][c]);
            gw[1][c] = fmaf(q.y, hs[c], gw[1][c]);
            gw[2][c] = fmaf(q.z, hs[c], gw[2][c]);
          }
          gsum[0] += q.x;
          gsum[1] += q.y;
          gsum[2] += q.z;
          gsum[3] += q.w;
          if (p0 + p < P)
            reinterpret_cast<float4*>(a.dz + (size_t)(p0 + p) * ACTS_LD + 9 * W)[lane] =
                make_float4(d[0], d[1], d[2], d[3]);
          const uint32_t w = word_of(h);
          if ((lane & 7) == 0) bits[p * 8 + (lane >> 3)] = w;
        }
      }
      mz = warp_max(mz);
      if (lane == 0)  // d_hv's rows carry no scale here: the unit of its largest value
        a.zs[((size_t)(p0 / T) * ZS_BLOCKS + 9) * 3 + warp] = mz > 0.f ? pow2(-row_shift(mz)) : 0.f;
    } else {  // a_l, l = 8 - m: W columns, F_NQ float4 a lane, 8 rows in flight
      const int col = (8 - m) * W;
#pragma unroll 1
      for (int i0 = warp; i0 < T; i0 += 24) {
        float4 v[8][F_NQ];
        float ga[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int p = i0 + 3 * r;
          const bool ok = p < T && p0 + p < P;
          const float4* row = reinterpret_cast<const float4*>(a.acts + (size_t)(p0 + p) * ACTS_LD + col);
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          v[r][0] = ok ? __ldg(row + lane) : z;
          if constexpr (F_NQ == 2) v[r][F_NQ - 1] = ok ? __ldg(row + 32 + lane) : z;
          ga[r] = ok && m == 1 ? __ldg(a.g + (size_t)(p0 + p) * 4 + 3) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int p = i0 + 3 * r;
          if (p >= T) break;
          if (m == 1) {
#pragma unroll
            for (int h = 0; h < F_NQ; ++h) {
              gwa[4 * h] = fmaf(ga[r], v[r][h].x, gwa[4 * h]);
              gwa[4 * h + 1] = fmaf(ga[r], v[r][h].y, gwa[4 * h + 1]);
              gwa[4 * h + 2] = fmaf(ga[r], v[r][h].z, gwa[4 * h + 2]);
              gwa[4 * h + 3] = fmaf(ga[r], v[r][h].w, gwa[4 * h + 3]);
            }
          }
#pragma unroll
          for (int h = 0; h < F_NQ; ++h) {
            const uint32_t w = word_of(v[r][h]);
            if ((lane & 7) == 0) bits[p * 8 + 4 * h + (lane >> 3)] = w;
          }
        }
      }
    }
    mbar_arrive(fbar(FM_FULL + s));  // each PE thread: its writes are done
    ++mk;
    clk_end(PW_MASKS);
  };
  // the d_z in the tile buffer to dz at column col0, once the consumers have
  // split it there: a warp a row (width 128: two rows, 16 lanes each, the
  // rows p and p + 3), lane l the 8 columns of 16-byte piece l % 8 of
  // chunk l / 8 of its row
  const float* inv_rows = reinterpret_cast<const float*>(dsmem + F_INV);
  auto store_dz = [&](int col0, int p0) {
    clk_begin();
    mbar_wait(fbar(FD_READY), dn & 1);
    clk_end(PW_READY);
    clk_begin();
    constexpr int ROWS = 4 / F_NA;  // rows a warp step
    const int c = F_NA == 4 ? lane >> 3 : (lane >> 3) & 1, k = lane & 7;
    const int sub = F_NA == 4 ? 0 : lane >> 4;
    float um = 0.f;  // the largest 1 / 2^s of the warp's nonzero rows
#pragma unroll 4
    for (int p = warp + 3 * sub; p < T; p += 3 * ROWS) {
      if (p0 + p >= P) break;
      const int off = c * CHUNK_B + p * 128 + ((k ^ (p & 7)) << 4);
      const uint4 h = *reinterpret_cast<const uint4*>(dsmem + off);
      const uint4 l = *reinterpret_cast<const uint4*>(dsmem + F_LO + off);
      const float sc = inv_rows[p];
      um = fmaxf(um, sc);
      const uint32_t hw[4] = {h.x, h.y, h.z, h.w}, lw[4] = {l.x, l.y, l.z, l.w};
      float o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack_f16(hw[i]), y = unpack_f16(lw[i]);
        o[2 * i] = (x.x + y.x) * sc;
        o[2 * i + 1] = (x.y + y.y) * sc;
      }
      float4* dst = reinterpret_cast<float4*>(a.dz + (size_t)(p0 + p) * ACTS_LD + col0 + 64 * c + 8 * k);
      __stcs(dst, make_float4(o[0], o[1], o[2], o[3]));
      __stcs(dst + 1, make_float4(o[4], o[5], o[6], o[7]));
    }
    um = warp_max(um);
    if (lane == 0) a.zs[((size_t)(p0 / T) * ZS_BLOCKS + col0 / W) * 3 + warp] = um;
    mbar_arrive(fbar(FD_READ));
    ++dn;
    clk_end(PW_DZ);
  };
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int p0 = tile * T;
#pragma unroll
    for (int i = 0; i < N_PW; ++i) pw[i] = 0;
    make_mask(0, p0);
    make_mask(1, p0);
    clk_begin();
    pe_tile_store(a.xd, a.pe, P, a.kx, a.kd, a.nfx, a.nfd, tile, warp);
    clk_end(PW_PE);
#pragma unroll 1
    for (int e = 0; e < 9; ++e) {  // d_feat, d_z7 .. d_z0
      store_dz((8 - e) * W, p0);
      if (e + 2 <= 8) make_mask(e + 2, p0);
    }
    if constexpr (PROF) {
      if (on)
        for (int i = 0; i < N_PW; ++i)
          a.stamps[(size_t)(tile / gridDim.x) * STAMP_ROW_F32 + N_STAMPS_F32 + i] = pw[i];
    }
  }
  __syncthreads();  // the consumers are done with the buffer
  // the three warps' sums through the buffer: [3][FP_NUMEL - FP_BV], zero
  // where a lane writes nothing (the padding lanes of ba and br)
  constexpr int NH = FP_NUMEL - FP_BV;
  float* hp = reinterpret_cast<float*>(dsmem);
  for (int i = u; i < 3 * NH; i += PE_THR) hp[i] = 0.f;
  named_bar(BAR_PE, PE_THR);
  float* mine = hp + warp * NH - FP_BV;  // indexed by f32-blob offset
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mine[FP_BV + 4 * lane + c] = gbv[c];
#pragma unroll
    for (int k = 0; k < 3; ++k) mine[FP_WR + k * WH + 4 * lane + c] = gw[k][c];
    mine[FP_WA + 4 * lane + c] = gwa[c];
    if constexpr (F_NQ == 2) mine[FP_WA + 128 + 4 * lane + c] = gwa[4 * (F_NQ - 1) + c];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) mine[FP_BR + k] = gsum[k];
    mine[FP_BA] = gsum[3];
  }
  named_bar(BAR_PE, PE_THR);
  for (int i = u; i < NH; i += PE_THR)
    a.fp_part[(size_t)blockIdx.x * FP_NUMEL + FP_BV + i] = (hp[i] + hp[NH + i]) + hp[2 * NH + i];
}

// The f32 producer: one thread streams the split blob's pieces in the
// consumers' order.
__device__ __forceinline__ void producer_f32(const DgradArgsF& a) {
  unsigned char* ring = dsmem + F_RING;
  int k = 0;
  // part (0 hi, 1 lo) rows [row0, row0 + rows) of chunk c of block blk (N rows)
  auto piece = [&](int blk, int c, int N, int part, int row0, int rows) {
    const int s = k % N_WST;
    mbar_wait(fbar(FW_EMPTY + s), ((k / N_WST) & 1) ^ 1);
    mbar_arrive_expect_tx(fbar(FW_FULL + s), rows * 128);
    bulk_g2s(ring + s * WST_B, a.wt + a.wt_off[blk] + ((size_t)c * 2 * N + (size_t)part * N + row0) * 64,
             rows * 128, fbar(FW_FULL + s));
    ++k;
  };
  auto wide = [&](int blk, int nk) {
    for (int c = 0; c < nk; ++c)
      for (int part = 0; part < 2; ++part) {
        piece(blk, c, W, part, 0, HALF);
        if (W > HALF) piece(blk, c, W, part, HALF, HALF);
      }
  };
  auto narrow = [&](int blk, int nk, int N) {
    for (int c = 0; c < nk; ++c) {
      piece(blk, c, N, 0, 0, N);
      piece(blk, c, N, 1, 0, N);
    }
  };
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    narrow(T_WVD, WH / 64, a.kd);
    wide(T_WVF, WH / 64);
#pragma unroll 1
    for (int l = 7; l >= 0; --l) {  // d_z_l from the block after it: Wf, W7, W6, W5b, W4 .. W1
      wide(l == 7 ? T_WF : l >= 4 ? T_W5B + (l - 4) : T_W1 + l, F_NA);
      if (l == 5) narrow(T_W5A, F_NA, a.kx);
    }
    narrow(T_W0, F_NA, a.kx);
  }
}

template <bool PROF>
__global__ void __launch_bounds__(NTHR, 1)
    nerf_mlp_dgrad_f32_sm90(const __grid_constant__ DgradArgsF a) {
  if (smem_u32(dsmem) & 1023) __trap();  // the swizzled operands need 1024-byte alignment
  if (threadIdx.x == 0) {
    for (int i = 0; i < F_N_BARS; ++i)
      mbar_init(fbar(i), i == FM_FULL || i == FM_FULL + 1 || i == FD_READ ? PE_THR
                         : (i >= FW_EMPTY && i < FM_FULL) || i == FM_FREE || i == FM_FREE + 1
                             ? NCONS / 32 : 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < NCONS) {
    consumer_f32<PROF>(a);
  } else if (threadIdx.x < NCONS + 32) {
    if (threadIdx.x == NCONS) producer_f32(a);
    __syncthreads();
  } else {
    pe_warps_f32<PROF>(a);
  }
}

// The backward's PE: each part padded to 32 channels, at most 128, both
// within PE_PAD_MAX, and the frequencies' channels within them; this build
// takes the PEs with a part of 128 channels (WIDE_PE, without stage
// stamps) or the others.
bool valid_pe(int kx, int kd, int nfx, int nfd, const long long* stamps) {
  auto width = [](int k) { return k == 32 || k == 64 || k == 96 || k == 128; };
  const bool wide = kx == 128 || kd == 128;
  return width(kx) && width(kd) && kx + kd <= PE_PAD_MAX && nfx >= 0 && nfd >= 0 &&
         3 + 6 * nfx <= kx && 3 + 6 * nfd <= kd && wide == WIDE_PE &&
         !(wide && stamps != nullptr);
}

}  // namespace

extern "C" {

// The columns of a row of stage stamps (the f32 dgrad's ends with its PE
// warps' N_PW cycle counts).
int nerf_mlp_dgrad_n_stamps(int f32) { return f32 ? STAMP_ROW_F32 : N_STAMPS; }
int nerf_mlp_dgrad_tile() { return T; }
int nerf_mlp_dgrad_width() { return W; }

// The bf16 dgrad on `stream`; returns 0 or the first CUDA error code.
//   xd [P, 8], g [P, 4] f32; wt: the transposed blob, chunk-major and
//   swizzled (pack_params_bwd in bf16); fp the f32 blob; acts [P, ACTS_LD]
//   the stash; dz [P, ACTS_LD] and pe [P, kx + kd] scratch (bf16); dxd
//   [P, 8] out; fp_part [n_blocks, FP_NUMEL] f32; stamps null or
//   [ceil(ntiles / n_blocks)][N_STAMPS] int64.
// Requires kx, kd in {32, 64, 96, 128}, kx + kd <= PE_PAD_MAX (160),
// 3 + 6 nfx <= kx, 3 + 6 nfd <= kd, P > 0, all pointers 16-byte aligned;
// kx or kd 128 in the nerf_mlp_dgrad_wide build (and no stamps), neither
// in this one.
int nerf_mlp_dgrad_bf16(const float* xd, const float* g, const void* wt, const float* fp,
                        void* acts, void* dz, void* pe, float* dxd, float* fp_part,
                        long long* stamps, int P, int kx, int kd, int nfx, int nfd, int n_blocks,
                        void* stream) {
  if (!valid_pe(kx, kd, nfx, nfd, stamps) || P <= 0) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(nerf_mlp_dgrad_sm90<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if constexpr (!WIDE_PE) {  // (the WIDE_PE build has no instrumented instantiation)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(nerf_mlp_dgrad_sm90<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    }
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tm_acts, tm_dz;
  int rc = make_map_2d_bf16(&tm_acts, acts, P, ACTS_LD, ACTS_LD * 2, T, 64);
  if (rc == 0) rc = make_map_2d_bf16(&tm_dz, dz, P, ACTS_LD, ACTS_LD * 2, T, 64);
  if (rc != 0) return rc;
  DgradArgs a;
  a.xd = xd;
  a.g = g;
  a.fp = fp;
  a.wt = static_cast<const bf16*>(wt);
  {
    const long long WW = (long long)W * W;
    const long long sizes[N_WT] = {(long long)kx * W, WW, WW, WW, WW, (long long)kx * W, WW, WW,
                                   WW, WW, (long long)W * WH, (long long)kd * WH};
    long long off = 0;
    for (int i = 0; i < N_WT; ++i) {
      a.wt_off[i] = off;
      off += sizes[i];
    }
  }
  a.pe = static_cast<bf16*>(pe);
  a.dxd = dxd;
  a.fp_part = fp_part;
  a.stamps = stamps;
  a.P = P;
  a.kx = kx;
  a.kd = kd;
  a.nfx = nfx;
  a.nfd = nfd;
  a.ntiles = (P + T - 1) / T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!WIDE_PE) {
    if (stamps != nullptr) {
      nerf_mlp_dgrad_sm90<true><<<n_blocks, NTHR, SMEM, s>>>(tm_acts, tm_dz, a);
      return (int)cudaGetLastError();
    }
  }
  nerf_mlp_dgrad_sm90<false><<<n_blocks, NTHR, SMEM, s>>>(tm_acts, tm_dz, a);
  return (int)cudaGetLastError();
}

// The f32 dgrad (the split) on `stream`; returns 0 or the first CUDA error
// code.  As nerf_mlp_dgrad_bf16, but: wt the split transposed blob
// (pack_params_bwd in f32: fp16 parts of W^T 2^4), acts the f32 stash, dz
// and pe f32 scratch; dpe5 [n_blocks, 128, kx] f32 scratch; zs
// [ntiles][ZS_BLOCKS][3] f32 out, dz's scale units (the f32 wgrad's: entry
// (t, b, w) the largest 1 / 2^s over the nonzero rows that PE warp w stored
// of block b in tile t, 0 if none; 2^s puts a row's largest |value| in
// [2^14, 2^15)); stamps null or [ceil(ntiles / n_blocks)][STAMP_ROW_F32]
// int64.
int nerf_mlp_dgrad_f32(const float* xd, const float* g, const void* wt, const float* fp,
                       const float* acts, float* dz, float* pe, float* dxd, float* fp_part,
                       float* dpe5, float* zs, long long* stamps, int P, int kx, int kd, int nfx,
                       int nfd, int n_blocks, void* stream) {
  if (!valid_pe(kx, kd, nfx, nfd, stamps) || P <= 0) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(nerf_mlp_dgrad_f32_sm90<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F32);
    if constexpr (!WIDE_PE) {  // (the WIDE_PE build has no instrumented instantiation)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(nerf_mlp_dgrad_f32_sm90<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F32);
    }
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  DgradArgsF a;
  a.xd = xd;
  a.g = g;
  a.fp = fp;
  a.wt = static_cast<const __half*>(wt);
  {
    const long long WW = (long long)W * W;
    const long long sizes[N_WT] = {(long long)kx * W, WW, WW, WW, WW, (long long)kx * W, WW, WW,
                                   WW, WW, (long long)W * WH, (long long)kd * WH};
    long long off = 0;
    for (int i = 0; i < N_WT; ++i) {
      a.wt_off[i] = off;
      off += 2 * sizes[i];  // each block's hi and lo parts
    }
  }
  a.acts = acts;
  a.dz = dz;
  a.pe = pe;
  a.dxd = dxd;
  a.fp_part = fp_part;
  a.dpe5 = dpe5;
  a.zs = zs;
  a.stamps = stamps;
  a.P = P;
  a.kx = kx;
  a.kd = kd;
  a.nfx = nfx;
  a.nfd = nfd;
  a.ntiles = (P + T - 1) / T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!WIDE_PE) {
    if (stamps != nullptr) {
      nerf_mlp_dgrad_f32_sm90<true><<<n_blocks, NTHR, SMEM_F32, s>>>(a);
      return (int)cudaGetLastError();
    }
  }
  nerf_mlp_dgrad_f32_sm90<false><<<n_blocks, NTHR, SMEM_F32, s>>>(a);
  return (int)cudaGetLastError();
}

const char* nerf_mlp_dgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
