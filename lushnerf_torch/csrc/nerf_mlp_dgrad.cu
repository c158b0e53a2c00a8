// The bf16 dgrad of the fused NeRF-MLP backward for Hopper (sm_90a): d(xd),
// every d_z (rounded to bf16, into the `dz` scratch the wgrad reads), the
// PE (into the `pe` scratch), and per-block partials of the bias grads and
// of the two small heads' weight grads.  The wgrad and the two fixed-order
// reductions that finish the backward are in nerf_mlp_bwd.cu.
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

#include "hopper.cuh"
#include "nerf_mlp_common.cuh"

// The block's shared memory: at file scope, so that every address in it is a
// constant and costs the consumers no registers.
extern __shared__ __align__(1024) unsigned char dsmem[];

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

// shared memory (byte offsets; the tile buffers and the ring are 1024-aligned)
constexpr int SM_BUF = 0;
constexpr int SM_RING = SM_BUF + 2 * BUF_B;
constexpr int SM_STAGE = SM_RING + N_WST * WST_B;      // [2][8 warps][256] f32 column sums
constexpr int SM_FACC = SM_STAGE + 2 * 8 * W * 4;      // [FP_NUMEL] f32
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

// The consumer side of the weight ring: piece k sits in stage k % N_WST.
struct Ring {
  int k;  // the next piece
  __device__ __forceinline__ const unsigned char* wait(int piece) const {
    const int s = piece % N_WST;
    mbar_wait(bar(W_FULL + s), (piece / N_WST) & 1);
    return dsmem + SM_RING + s * WST_B;
  }
  __device__ __forceinline__ void release(int piece) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar(W_EMPTY + piece % N_WST));
  }
};

// The producer, before chunk c of a tile buffer is loaded again: its store
// of that chunk, bulk group c of the last four it committed (one a chunk,
// in chunk order), has read it.
__device__ __forceinline__ void wait_store_read(int c) {
  if (c == 0) bulk_wait_read<3>();
  else if (c == 1) bulk_wait_read<2>();
  else if (c == 2) bulk_wait_read<1>();
  else bulk_wait_read<0>();
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

// acc += A[wg rows, 0 : 64 nk] . B^T over the next nk weight pieces of N
// rows (a d_pe pass: N = kx or kd).
template <int N>
__device__ __forceinline__ void matmul_n(float (&acc)[48], const unsigned char* A, int nk,
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
      else wgmma_m64n96k16(acc, da, db, 1);
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
// (`ready`), which stores it to the dz scratch; and the column sums added
// to facc[bias_off].
__device__ __forceinline__ void layer_end(const float* stage, float* facc, int bias_off,
                                          uint64_t* ready) {
  fence_proxy_async();
  named_bar(BAR_CONS, NCONS);
  if (threadIdx.x == 0) mbar_arrive(ready);
  const int c = threadIdx.x;
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
      const float x = xs[p * 8 + 3 + k];
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

constexpr int DPE_LD = 100;  // row of the f32 d_pe_x tile: kx <= 96, plus 4

// This warpgroup's rows of a d_pe fragment of N columns into dpe [T][DPE_LD].
template <int R>
__device__ __forceinline__ void dpe_to_smem(const float (&acc)[R], int N, float* dpe) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (8 * j < N) {
      const int col = 8 * j + 2 * f.q;
      *reinterpret_cast<float2*>(dpe + f.r0 * DPE_LD + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dpe + (f.r0 + 8) * DPE_LD + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// d(xd) lanes 0..2 and the padding lanes 6, 7 from d_pe_x in dpe: one
// thread per (point, coordinate), the bands in order, as nerf_mlp_bwd.cu's
// f32 kernel sums them.
__device__ __forceinline__ void dxd_from_smem(const float* dpe, int kx, int L, const float* xs,
                                              float* dxd, int p0, int P) {
  for (int idx = threadIdx.x; idx < T * 3; idx += NCONS) {
    const int p = idx / 3, k = idx - 3 * p;
    if (p0 + p >= P) continue;
    const float* dp = dpe + p * DPE_LD;
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

// The PE of the block's points into the pe scratch, by the producer
// warpgroup's warps 1..3 while the consumers run (nothing in this kernel
// reads it), as pe_tile computes each value: a warp per point, a lane per
// (band, coordinate) whose sincosf gives both its sin and its cos lane,
// then the identity lanes and the zero padding.
__device__ __forceinline__ void pe_store(const DgradArgs& a) {
  const int warp = ((threadIdx.x - NCONS) >> 5) - 1, lane = threadIdx.x & 31;
  const int ncol = a.kx + a.kd, nb = a.nfx + a.nfd;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += gridDim.x) {
    const int end = min(tile * T + T, a.P);
    for (int p = tile * T + warp; p < end; p += 3) {
      const float* x = a.xd + (size_t)p * 8;
      bf16* row = a.pe + (size_t)p * ncol;
      for (int r = lane; r < 3 * nb; r += 32) {
        const int slot = r / 3, c = r - 3 * slot;
        const bool is_x = slot < a.nfx;
        const int band = is_x ? slot : slot - a.nfx;
        float sn, cs;
        sincosf(__ldg(x + (is_x ? 0 : 3) + c) * (float)(1 << band), &sn, &cs);
        bf16* d = row + (is_x ? 0 : a.kx) + 3 + 6 * band + c;
        d[0] = __float2bfloat16_rn(sn);
        d[3] = __float2bfloat16_rn(cs);
      }
      for (int c = lane; c < ncol; c += 32) {
        const bool is_x = c < a.kx;
        const int local = is_x ? c : c - a.kx;
        if (local < 3) row[c] = __float2bfloat16_rn(__ldg(x + (is_x ? 0 : 3) + local));
        else if (local >= 3 + 6 * (is_x ? a.nfx : a.nfd)) row[c] = __float2bfloat16_rn(0.f);
      }
    }
  }
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
  float gwa = 0.f;  // one a7 column a thread
  const unsigned char* col = Y + (t >> 6) * CHUNK_B;
#pragma unroll 4
  for (int p = 0; p < T; ++p) {
    const float a7 = __bfloat162float(*reinterpret_cast<const bf16*>(col + swz128(p, t & 63)));
    gwa = fmaf(rnd<true>(gs[p * 4 + 3]), a7, gwa);
  }
  facc[FP_WA + t] += gwa;
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
    // A 256-wide layer: d_z from tile buffer `in` (nk chunks, each given
    // back to the producer as soon as it is read if give_back) into tile
    // buffer `out`, whose stash columns, the relu mask, the producer loaded
    // while the previous layer ran (waited here if wait_mask); with
    // wait_x, `out` is `in` and the producer's store of it must have read
    // it first.  Three stamps: the end of its matmul, of those waits, and
    // of the layer.
    auto wide = [&](int in, int nk, bool give_back, int out, bool wait_mask, bool mask,
                    bool alpha, bool wait_x, int bias_off) {
      float a0[HALF / 2], a1[HALF / 2];
      matmul_wide(a0, a1, buf(in), nk, ring, give_back ? in : -1);
      st.mark();
      if (wait_mask) wait_chunks(out, 4);
      if (wait_x) wait_x_read();
      st.mark();
      unsigned char* o = buf(out);
      epilogue_half(a0, 0, o, mask, alpha, a.fp, gs, stage + sb * 8 * W);
      epilogue_half(a1, 1, o, mask, alpha, a.fp, gs, stage + sb * 8 * W);
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
    wait_chunks(1, 4);
    wait_chunks(0, 2);
    heads(X, Y, gs, a.fp, facc, stage);
    fence_proxy_async();
    named_bar(BAR_CONS, NCONS);
    if (tid == 0) mbar_arrive(bar(D_READY));
    st.mark();

    // d_pe_d = d_hv Wvd, and the view lanes of d(xd)
    {
      float acc_d[48];
#pragma unroll
      for (int i = 0; i < 48; ++i) acc_d[i] = 0.f;
      matmul_narrow(acc_d, a.kd, X, 2, ring);
      st.mark();
      dxd_views(acc_d, a.kd, a.nfd, xs, stage, a.dxd, p0, P);
    }
    st.mark();

    // The nine 256-wide layers through one copy of the code (a copy per
    // layer missed the instruction cache every tile): l = 8 is d_feat =
    // d_hv Wvf (no mask), in place over d_hv in X once its store has read
    // it; l = 7 d_z7 (mask a7, in Y since the heads; plus g_alpha Wa); then
    // d_z6 (W7) .. d_z0 (W1), alternating buffers, each layer's A going back
    // to the producer for the mask of the next, and d_z0's A (d_z1 in Y) for
    // d_z5, reloaded from the dz scratch.
#pragma unroll 1
    for (int l = 8; l >= 0; --l) {
      const int in = (l & 1) || l == 8 ? 0 : 1;
      wide(in, l == 8 ? 2 : 4, l < 8, l == 8 ? 0 : in ^ 1, l < 7, l < 8, l == 7, l == 8, l * W);
    }

    if (tile + (int)gridDim.x < a.ntiles) fetch(p0 + (int)gridDim.x * T);

    // d_pe_x = d_z0 W0 + d_z5 W5a (d_z0 in X, d_z5 in Y); Y then goes to the
    // next tile's a7, and X holds d_pe_x in f32 for d(xd), then the next hv
    {
      float acc_x[48];
#pragma unroll
      for (int i = 0; i < 48; ++i) acc_x[i] = 0.f;
#pragma unroll 1
      for (int b = 0; b < 2; ++b) {
        if (b == 1) wait_chunks(1, 4);
        matmul_narrow(acc_x, a.kx, buf(b), 4, ring);
      }
      free_chunks(1, 4);
      wait_x_read();  // the producer's store of d_z0 from X
      dpe_to_smem(acc_x, a.kx, reinterpret_cast<float*>(X));
    }
    named_bar(BAR_CONS, NCONS);
    st.mark();
    dxd_from_smem(reinterpret_cast<const float*>(X), a.kx, a.nfx, xs, a.dxd, p0, P);
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
  // and, with after_store, the buffer's store (the last four groups) has
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
  // A 256-wide layer that reads tile buffer `in`: its first two chunks'
  // pieces, then the store of the previous layer's d_z (in `in`, nch chunks
  // at column prev_col; x_read signalled after it with signal), then the
  // other pieces; with give_back, then the next layer's mask (stash
  // columns from col, or d_z5 with reload) into `in`, chunk by chunk as the
  // consumers give it back.  No piece waits behind a store.
  auto wide = [&](int blk, int nk, int in, int prev_col, int nch, bool signal, bool give_back,
                  int col, bool reload, int p0) {
    for (int c = 0; c < 2; ++c) {
      piece(blk, c, W, 0, HALF);
      piece(blk, c, W, HALF, HALF);
    }
    store(in, prev_col, nch, p0);
    if (signal) signal_x_read();
    for (int c = 2; c < nk; ++c) {
      piece(blk, c, W, 0, HALF);
      piece(blk, c, W, HALF, HALF);
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
    for (int c = 0; c < 4; ++c) load(1, c, 7 * W, p0, false, false);
    if (tile != (int)blockIdx.x) signal_x_read();
    for (int c = 0; c < 2; ++c) load(0, c, 9 * W, p0, false, false);
    // the consumers' nine 256-wide layers: l = 8 reads d_hv (Wvf; its
    // store signalled), l = 7 d_feat (Wf; a6 into X), l = 6 d_z7 (W7; a5
    // into Y), .. l = 0 d_z1 (W1; d_z5 back into Y)
#pragma unroll 1
    for (int l = 8; l >= 0; --l) {
      const int in = (l & 1) || l == 8 ? 0 : 1, blk = l + (l >= 4 ? T_W5B - 4 : T_W1);
      wide(blk, l == 8 ? 2 : 4, in, (l + 1) * W, l == 8 ? 2 : 4, l == 8, l < 8,
           l > 0 ? (l - 1) * W : 5 * W, l == 0, p0);
    }
    narrow(T_W0, 4, a.kx);
    store(0, 0, 4, p0);  // d_z0
    narrow(T_W5A, 4, a.kx);
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

bool valid_pe_width(int k) { return k == 32 || k == 64 || k == 96; }

}  // namespace

extern "C" {

int nerf_mlp_dgrad_n_stamps() { return N_STAMPS; }
int nerf_mlp_dgrad_tile() { return T; }

// The bf16 dgrad on `stream`; returns 0 or the first CUDA error code.
//   xd [P, 8], g [P, 4] f32; wt: the transposed blob, chunk-major and
//   swizzled (pack_params_bwd in bf16); fp the f32 blob; acts [P, ACTS_LD]
//   the stash; dz [P, ACTS_LD] and pe [P, kx + kd] scratch (bf16); dxd
//   [P, 8] out; fp_part [n_blocks, FP_NUMEL] f32; stamps null or
//   [ceil(ntiles / n_blocks)][N_STAMPS] int64.
// Requires kx, kd in {32, 64, 96}, kx + kd <= 128, 3 + 6 nfx <= kx,
// 3 + 6 nfd <= kd, P > 0, all pointers 16-byte aligned.
int nerf_mlp_dgrad_bf16(const float* xd, const float* g, const void* wt, const float* fp,
                        void* acts, void* dz, void* pe, float* dxd, float* fp_part,
                        long long* stamps, int P, int kx, int kd, int nfx, int nfd, int n_blocks,
                        void* stream) {
  if (!valid_pe_width(kx) || !valid_pe_width(kd) || kx + kd > PE_MAX || P <= 0)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(nerf_mlp_dgrad_sm90<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nerf_mlp_dgrad_sm90<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
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
  if (stamps != nullptr)
    nerf_mlp_dgrad_sm90<true><<<n_blocks, NTHR, SMEM, s>>>(tm_acts, tm_dz, a);
  else
    nerf_mlp_dgrad_sm90<false><<<n_blocks, NTHR, SMEM, s>>>(tm_acts, tm_dz, a);
  return (int)cudaGetLastError();
}

const char* nerf_mlp_dgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
