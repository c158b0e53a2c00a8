// The forward layer sequence of the fused NeRF-MLP for Hopper (sm_90a),
// shared by the forward kernel K1 (nerf_mlp_fwd.cu: the PE from xd, [P, 4]
// out, optionally the activation stash) in both its modes and the
// matmul-only kernel K5 (nerf_pe_mm.cu: the PE loaded from a pre-encoded
// [P, 128] array, [P, 128] out).  In bf16 (MODE_FWD, MODE_MM) each
// computes, per point, the scene MLP on the bf16-rounded PE with f32 sums,
// f32 bias and relu, every activation rounded to bf16 where the next layer
// reads it, and the alpha and rgb heads (nerf_mlp_fwd.cu lists the
// function).  K1's f32 mode (MODE_F32, "the split", below the bf16
// consumers) runs the same sequence with each operand in two fp16 parts
// and three products for each, so that its products are f32-grade.
//
// What bounds it: operations output only, 1,186,816 FLOP a point at the
// bf16 tensor rate; with the stash, bytes (4,864 more a point).  Inside an
// SM the wall is the weights: a 128-point tile needs all 1.2 MB of them,
// ~29 bytes a cycle at the SM's share of the tensor rate, so every tile
// streams them from L2.
//
// Design: a persistent grid, one block an SM, each block looping over
// 128-point tiles.  384 threads a block:
//   * two consumer warpgroups, each owning 64 points of the tile, run every
//     matmul on wgmma, both operands in shared memory, the sums in
//     registers from the bias on: m64n256k16 for the 256-wide layers (one
//     128-register accumulator; a chunk's two weight pieces at once, so A
//     is read once), m64n128k16 for the views layer.  A is the tile's
//     activation buffer ([128][256] bf16, four K-major 128-byte-swizzled
//     chunks of 64 columns) or its PE tile; since the sums stay in
//     registers until all of K is consumed, each layer's epilogue (relu in
//     the bf16 conversion, stmatrix stores) writes its output over its
//     input in place, so one buffer holds every activation in turn.  The
//     alpha head is summed in the epilogue of layer 7 (before the feature
//     layer overwrites a7), the rgb head in the views layer's, each in a
//     fixed order (the thread's columns in order, then the 4 threads of a
//     row by two shuffles), so two runs give the same bits;
//   * one producer thread streams the weights through a ring of N_WST 16 KB
//     stages on mbarriers, one bulk copy a stage.  pack_params lays the
//     bf16 blob out as 16 KB pieces ([128 rows][64 columns] of W as
//     [out][in], the swizzled layout wgmma reads) in the order the consumers
//     take them, so the producer walks the blob piece by piece; a stage is
//     refilled once all 8 consumer warps have released it.  A two-block
//     cluster that multicast each piece to both blocks halved the L2 reads
//     but not the time: at this tile time L2's bandwidth does not hold the
//     ring (PERF.md);
//   * three warps write the PE tile ([128][128] bf16: pe_x at columns [0,
//     in_ch), pe_d at [dx, dx + d_ch), zeros elsewhere; dx = kx, pe_x
//     padded to 32 channels, where kx + kd <= 128, else dx = in_ch, the JAX
//     kernels' tight packing: nerf_mlp.pe_geometry; sincosf with full range
//     reduction, never the fast intrinsics) chunk by chunk: a chunk of the
//     next tile as soon as this tile's last layer reading it is done (the
//     pe_x chunks after layer 5, the pe_d chunks after the views layer), so
//     the PE overlaps the matmuls and one PE tile suffices.  K5's warps
//     load the pre-encoded rows instead;
//   * the stash: after each layer's epilogue the warpgroup's 64 rows go out
//     by TMA stores (a tensor map over the [P][2432] stash, 128-byte
//     swizzle, rows past P clipped), issued by the warpgroup's first
//     thread; only the next epilogue's writes wait for the store's reads.
// Shared memory: the activation buffer 64 KB, the PE tile 32 KB, the ring
// 8 x 16 KB, barriers: 224.2 KB of the 227 KB.  Every address is a
// constant (the buffer is at file scope), so it costs no registers: ptxas
// fits each thread of a 384-thread block into 168 registers.
//
// The split differs in its shared memory and its blob: the activation
// buffer holds both parts (128 KB), one PE slot of one chunk in both parts
// (32 KB), and the ring has 4 stages, one chunk of a 256-wide layer: 224.2
// KB again, no room for a second slot.  Where pe_x and pe_d each lie in
// one chunk (nx = nd = 1, the shipped PE) the slot takes the tile's pe_x
// chunk for layers 0 and 5 and then its pe_d chunk for the views layer
// (which reads it first, so that the next tile's pe_x can be written
// while the views layer's feat chunks run).  Any other PE runs the MULTI
// instantiation: the slot is filled once for each PE chunk a layer reads
// (W0's nx, W5's nx again, the views layer's nd; pe_x once for both
// where nx = 1), and a layer that reads two PE chunks in a row drains its
// wgmma groups and waits for the slot's next fill between them.  Its
// blob (fp16, `pack_params` in f32) holds the same matrices, the views
// layer's PE chunks first, each chunk of 64 columns as its hi pieces, then
// its lo pieces, padded with zero pieces to a multiple of 4; the epilogue
// stores the f32 stash from registers.
//
// Both K1 modes are compiled for the width W of nerf_mlp_common.cuh.  At
// width 128 every layer's N is 128 (the views layer's 64 columns padded to
// 128), so each layer takes the views layer's m64n128k16 path: in bf16 a
// chunk is one piece (`matmul_layer`), in the split two (hi, lo); an
// activation is two chunks, and the buffers keep their places (half of the
// activation buffer idles).  K5 (MODE_MM) is compiled for width 256 only.
//
// Weight blob (bf16, pieces of 8192 elements in order, padded with a zero
// piece to an even count so that a chunk's two pieces sit in neighbouring
// ring stages): for each layer its
// matrix [N][K] (N = W, or 128 for the views layer), K chunk-major in
// chunks of 64 columns, each chunk [N][64] in the 128-byte swizzle (a chunk
// of a 256-wide layer is two pieces: rows 0..127, then 128..255; at width
// 128 every chunk is one piece).  K
// columns: W0 over the PE tile's first nx chunks; W1..W4; W5 over a4, then
// the PE tile's first nx chunks; W6, W7, Wf; Wv over feat, then the PE
// tile's nd chunks from chunk d0 (nx = ceil(in_ch / 64), d0 = dx / 64, nd =
// ceil((dx + d_ch) / 64) - d0; a column of the PE tile that the layer does
// not read has a zero weight).

#pragma once

#include <cuda_fp16.h>
#include <string.h>

#include "hopper.cuh"
#include "nerf_mlp_common.cuh"

// The block's shared memory: at file scope, so that every address in it is
// a constant and costs the consumers no registers.
extern __shared__ __align__(1024) unsigned char fsm[];

namespace fwd90 {

using namespace nerf_mlp;
using namespace hopper;

constexpr int T = 128;              // points per tile
constexpr int NCONS = 256;          // two consumer warpgroups
constexpr int NTHR = NCONS + 128;   // and a producer warpgroup
constexpr int PRODUCER = NCONS;     // the thread that issues the weight copies
constexpr int PE0 = NCONS + 32;     // the PE warps: 9, 10 and 11
constexpr int PE_THREADS = NTHR - PE0;
constexpr int CHUNK_B = T * 128;    // [128 rows][64 bf16] of a tile buffer: 16 KB
constexpr int BUF_B = 4 * CHUNK_B;  // the activation buffer: [128][256] bf16
constexpr int PE_CHUNKS = 2;        // the PE tile: [128][128] bf16
constexpr int PIECE_B = 128 * 128;  // a weight piece: [128 rows][64 bf16], 16 KB
constexpr int PIECE_ELEMS = PIECE_B / 2;
constexpr int N_WST = 8;            // weight ring stages
constexpr int BAR_WG = 1;           // named barriers 1, 2: consumer warpgroup 0, 1
constexpr int BAR_PE = 3;           // named barrier of the PE warps

// shared memory (byte offsets; the buffers and the ring are 1024-aligned)
constexpr int SM_ACT = 0;
constexpr int SM_PE = SM_ACT + BUF_B;
constexpr int SM_RING = SM_PE + PE_CHUNKS * CHUNK_B;
constexpr int SM_BARS = SM_RING + N_WST * PIECE_B;
// mbarriers by index: a ring stage loaded (W_FULL + s) and released by the
// 8 consumer warps (W_EMPTY + s); PE chunk c written
// (PE_FULL + c) and read by both warpgroups' last layer reading it in the
// tile (PE_FREE + c)
enum { W_FULL = 0, W_EMPTY = W_FULL + N_WST, PE_FULL = W_EMPTY + N_WST,
       PE_FREE = PE_FULL + PE_CHUNKS, N_BARS = PE_FREE + PE_CHUNKS };
constexpr int SM_CLK = SM_BARS + N_BARS * 8;  // the stage clock's sums
// Stage stamps of the instrumented instantiation (nerf_mlp.FWD_STAGES),
// per tile of block 0, in consumer thread 0's cycles: the waits for the PE
// chunks, for weight pieces, matmuls (the rest of the tile), the waits for
// the last stash store's reads, epilogues (with the heads), stash store
// issue, the output rows; then, off that path, the PE warps' work.
enum { ST_PE_WAIT, ST_W_WAIT, ST_MM, ST_STASH_WAIT, ST_EPI, ST_STASH, ST_OUT, ST_PE_WORK, N_ST };
constexpr int SMEM = SM_CLK + N_ST * 8;
static_assert(SMEM <= 232448, "shared memory over the 227 KB a block may use");

// The f32 mode's shared memory (the split): the activation buffer in two
// bf16 parts (the hi chunks, then the lo chunks), one PE slot of one chunk
// in two parts, a ring of S_N_WST stages; the barriers and the stage clock
// where the bf16 layout has them.
constexpr int S_ACT_LO = BUF_B;            // the lo parts of the activation buffer
constexpr int S_SM_PE = SM_ACT + 2 * BUF_B;  // the PE slot: its hi chunk, then its lo chunk
constexpr int S_PE_LO = CHUNK_B;
constexpr int S_SM_RING = S_SM_PE + 2 * CHUNK_B;
constexpr int S_N_WST = 4;                 // one chunk of a 256-wide layer: hi and lo pieces
constexpr int SPLIT_SHIFT = 4;             // the weights' parts are those of w 2^SPLIT_SHIFT
constexpr float SPLIT_ACC = 1 << SPLIT_SHIFT;  // and so the accumulator's scale
// The split at width W: a W-wide activation is S_NA chunks of 64 columns;
// a chunk of a W-wide layer's weight is S_NP pieces of 128 rows a part
// (one m64n256k16 over two neighbouring pieces at 256, one m64n128k16 over
// one at 128, as the views layer's 128 lanes at both widths)
constexpr int S_NA = W / 64;
constexpr int S_NP = W / 128;
static_assert(S_SM_RING + S_N_WST * PIECE_B == SM_BARS, "the split layout ends where the ring does");
// mbarriers of the split: ring stages loaded / released as above; the PE
// slot written (S_PE_FULL) and released by the 8 consumer warps (S_PE_FREE)
enum { S_W_FULL = 0, S_W_EMPTY = S_N_WST, S_PE_FULL = 2 * S_N_WST, S_PE_FREE, S_N_BARS };
static_assert(S_N_BARS <= N_BARS, "the split's barriers fit the bf16 layout's room");

// K1 bf16: PE from xd, [P, 4] out; K5: PE loaded, [P, 128] out; K1 f32:
// as K1 bf16, every product split in three fp16 products
enum { MODE_FWD, MODE_MM, MODE_F32 };

struct Args {
  const float* in;    // MODE_FWD: xd [P, 8]; MODE_MM: the packed PE [P, 128]
  const float* fp;    // the f32 blob (biases, heads)
  const bf16* w;      // the weight blob, pieces in order
  float* out;         // [P, 4] (MODE_FWD, MODE_F32) or [P, 128] (MODE_MM)
  float* acts;        // MODE_F32: the f32 stash [P][ACTS_LD] or null
  float* units;       // MODE_F32 with the stash: its scale units [ntiles][UNIT_BLOCKS][UNIT_WARPS]
  long long* stamps;  // [tiles of block 0][N_ST] or null
  int P, dx, nfx, nfd;  // pe_d's first column; MODE_MM: nfx / nfd are the packed PE's lanes
  int ntiles, n_pieces, nx, d0, nd;
  int stash;          // 1: write the stash through the tensor map
};

__device__ __forceinline__ uint64_t* bar(int i) {
  return reinterpret_cast<uint64_t*>(fsm + SM_BARS) + i;
}
__device__ __forceinline__ long long* clk_sums() { return reinterpret_cast<long long*>(fsm + SM_CLK); }

// A layer of the sequence: its K chunks are n_act chunks of the activation
// buffer, then n_pe chunks of the PE tile from chunk pe_c0.
struct Layer {
  int n_act, n_pe, pe_c0, bias;
};
__device__ __forceinline__ Layer layer(int l, const Args& a) {
  Layer L;
  L.n_act = l == 0 ? 0 : W / 64;
  L.n_pe = l == 0 || l == 5 ? a.nx : l == 9 ? a.nd : 0;
  L.pe_c0 = l == 9 ? a.d0 : 0;
  L.bias = l < 8 ? l * W : l == 8 ? FP_BF : FP_BV;
  return L;
}
__device__ __forceinline__ const unsigned char* a_chunk(const Layer& L, int c) {
  return c < L.n_act ? fsm + SM_ACT + c * CHUNK_B : fsm + SM_PE + (L.pe_c0 + c - L.n_act) * CHUNK_B;
}

// The tiles of this block: blockIdx.x, + gridDim.x, ...
struct Sched {
  int tile, ntiles;
  __device__ __forceinline__ Sched(const Args& a) : tile(blockIdx.x), ntiles(a.ntiles) {}
  __device__ __forceinline__ bool more() const { return tile < ntiles; }
  __device__ __forceinline__ void next() { tile += gridDim.x; }
  __device__ __forceinline__ int p0() const { return tile * T; }
};

// Stage clock of the instrumented instantiation: thread `on` adds the
// clock64() cycles of each measured region to its stage's sum in shared
// memory.
template <bool PROF> struct Clock {
  bool on;
  long long t;
  __device__ __forceinline__ void begin() {
    if constexpr (PROF) {
      if (on) t = clock64();
    }
  }
  __device__ __forceinline__ void end(int s) {
    if constexpr (PROF) {
      if (on) clk_sums()[s] += clock64() - t;
    }
  }
};

// ---------------------------------------------------------------------------
// consumers
// ---------------------------------------------------------------------------

// The consumer side of a weight ring of NW stages (N_WST: bf16, S_N_WST:
// the split): piece k sits in stage k % NW; barriers W_FULL + s (= s) and
// W_EMPTY + s (= NW + s) in both layouts.
template <int NW> struct RingT {
  int k;  // the next piece
  __device__ __forceinline__ const unsigned char* wait(int piece) const {
    const int s = piece % NW;
    mbar_wait(bar(s), (piece / NW) & 1);
    return fsm + (NW == N_WST ? SM_RING : S_SM_RING) + s * PIECE_B;
  }
  __device__ __forceinline__ void release(int piece) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar(NW + piece % NW));
  }
};
using Ring = RingT<N_WST>;
static_assert(W_FULL == 0 && W_EMPTY == N_WST && S_W_FULL == 0 && S_W_EMPTY == S_N_WST,
              "the rings' barriers");

template <int R>
__device__ __forceinline__ void mma_piece(float (&acc)[R], const unsigned char* A,
                                          const unsigned char* B) {
  wgmma_fence();
  wgmma_fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_m64n128k16(acc, wgmma_desc(A + ks * 32), wgmma_desc(B + ks * 32), 1);
  wgmma_commit();
}

// This thread's rows of the tile in the accumulator fragment: r0 and r0 + 8;
// its columns: 8 j + 2 q and 8 j + 2 q + 1.
struct Frag {
  int r0, q;
  __device__ __forceinline__ Frag() {
    const int t = threadIdx.x, lane = t & 31;
    r0 = (t >> 7) * 64 + ((t >> 5) & 3) * 16 + (lane >> 2);
    q = lane & 3;
  }
};

// An accumulator of N / 2 columns (N = 128: a 256-wide layer, 64: the
// views layer) set to the layer's bias, so that the epilogue adds nothing:
// v = bias + the products, the sum in another order than the plain
// version's (products, then bias).
template <int N>
__device__ __forceinline__ void init_bias(float (&acc)[N], const float* fp, int bias) {
  const Frag f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(fp + bias + 8 * j + 2 * f.q));
    acc[4 * j] = b.x;
    acc[4 * j + 1] = b.y;
    acc[4 * j + 2] = b.x;
    acc[4 * j + 3] = b.y;
  }
}

// acc = bias + A[wg rows] . W^T over a 256-wide layer's chunks: a chunk's
// two pieces (rows 0..127 and 128..255 of W) sit in neighbouring ring
// stages (a tile's pieces are an even number, so a chunk starts at an even
// piece), so one m64n256k16 wgmma a 16-deep step takes both, reading A
// once.  One wgmma group a chunk; a chunk's pieces go back to the ring as
// soon as its group is done, with one group kept in flight.
template <bool PROF>
__device__ __forceinline__ void matmul_wide(float (&acc)[128], const Layer& L, const float* fp,
                                            Ring& ring, Clock<PROF>& clk) {
  const int wg_off = (threadIdx.x >> 7) * 64 * 128;
  init_bias(acc, fp, L.bias);
  const int nk = L.n_act + L.n_pe;
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    const unsigned char* A = a_chunk(L, c) + wg_off;
    clk.begin();
    const unsigned char* B = ring.wait(ring.k);
    ring.wait(ring.k + 1);  // the stage after B's
    clk.end(ST_W_WAIT);
    wgmma_fence();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n256k16(acc, wgmma_desc(A + ks * 32), wgmma_desc(B + ks * 32), 1);
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      ring.release(ring.k - 2);
      ring.release(ring.k - 1);
    }
    ring.k += 2;
  }
  wgmma_wait<0>();
  ring.release(ring.k - 2);
  ring.release(ring.k - 1);
  wgmma_fence_regs(acc);
}

// acc = bv + A[wg rows] . Wv^T over the views layer's chunks, one piece
// each.
template <bool PROF>
__device__ __forceinline__ void matmul_narrow(float (&acc)[64], const Layer& L, const float* fp,
                                              Ring& ring, Clock<PROF>& clk) {
  const int wg_off = (threadIdx.x >> 7) * 64 * 128;
  init_bias(acc, fp, L.bias);
  const int nk = L.n_act + L.n_pe;
#pragma unroll 1
  for (int c = 0; c < nk; ++c) {
    clk.begin();
    const unsigned char* B = ring.wait(ring.k);
    clk.end(ST_W_WAIT);
    mma_piece(acc, a_chunk(L, c) + wg_off, B);
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

// Two f32 values rounded to bf16 (relu: negatives to 0) and packed, the
// first in the low half (the lower column).
template <bool RELU> __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  if constexpr (RELU) asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  else asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// A layer's output from its accumulator of N / 2 columns (which holds bias
// + products): v = relu(acc) (RELU) or acc, rounded to bf16 and, with
// `write`, written over the activation buffer.  head 1: alpha's sums (rows
// r0, r0 + 8) add r(v) . Wa; head 2: rgb's (channel k of row r0 + 8 rr at
// hs[2 k + rr]) add r(v) . Wr[k].
template <bool RELU, int N, int NH>
__device__ __forceinline__ void epilogue(const float (&acc)[N], const float* fp, bool write,
                                         int head, float (&hs)[NH]) {
  const Frag f;
  // stmatrix: lane l gives row l % 8 of matrix l / 8 = (rows +8 if l / 8 is
  // odd, columns +8 if l >= 16) of the warp's 16 rows and 16 columns
  const int lane = threadIdx.x & 31, rr = lane & 7, hi = lane >> 4;
  const int row = f.r0 - (lane >> 2) + ((lane >> 3) & 1) * 8 + rr;
  unsigned char* base = fsm + SM_ACT + row * 128;
#pragma unroll
  for (int j = 0; j < N / 4; j += 2) {  // columns 8 j .. 8 j + 15
    uint32_t p[4];  // rows r0 | r0 + 8 of columns 8 j + 2 q, then of 8 (j + 1) + 2 q
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = pack_bf16<RELU>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    if (write)  // swz128(row, col & 63) in chunk col >> 6, col = 8 (j + hi); row % 8 = rr
      stsm_x4(base + (j >> 3) * CHUNK_B + ((((j & 7) + hi) ^ rr) << 4), p[0], p[1], p[2], p[3]);
    if (head != 0) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * (j + jj) + 2 * f.q;
        const float2 u0 = unpack_bf16(p[2 * jj]), u1 = unpack_bf16(p[2 * jj + 1]);
#pragma unroll
        for (int k = 0; k < NH / 2; ++k) {
          const int off = head == 1 ? FP_WA : FP_WR + k * WH;
          const float2 w = __ldg(reinterpret_cast<const float2*>(fp + off + col));
          hs[2 * k] = fmaf(u0.y, w.y, fmaf(u0.x, w.x, hs[2 * k]));
          hs[2 * k + 1] = fmaf(u1.y, w.y, fmaf(u1.x, w.x, hs[2 * k + 1]));
        }
      }
    }
  }
}

// A W-wide layer's matmul (layers 0..8): matmul_wide at width 256; at
// width 128 a chunk is one piece, as the views layer's, and so is its
// matmul.
template <int R, bool PROF>
__device__ __forceinline__ void matmul_layer(float (&acc)[R], const Layer& L, const float* fp,
                                             Ring& ring, Clock<PROF>& clk) {
  if constexpr (R == 128) matmul_wide(acc, L, fp, ring, clk);
  else matmul_narrow(acc, L, fp, ring, clk);
}

// A head's sums over the 4 threads of each row (lanes xor 1, then xor 2):
// each of them ends with the row's whole sum, in a fixed order.
template <int NH> __device__ __forceinline__ void row_sum(float (&hs)[NH]) {
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    hs[i] += __shfl_xor_sync(0xffffffffu, hs[i], 1);
    hs[i] += __shfl_xor_sync(0xffffffffu, hs[i], 2);
  }
}

// The tile's output rows r0 and r0 + 8 (those before P): [rgb, alpha]
// (MODE_FWD, from thread q = 0), or the 128-lane row [rgb0 + alpha, rgb1,
// rgb2, 0, ...] (MODE_MM, each of the row's 4 threads 32 of its lanes).
template <int MODE>
__device__ __forceinline__ void write_out(const Args& a, int p0, const float (&rgb)[6],
                                          const float (&alpha)[2]) {
  const Frag f;
  const float* fp = a.fp;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = p0 + f.r0 + 8 * rr;
    if (p >= a.P) continue;
    const float r0 = rgb[rr] + fp[FP_BR], r1 = rgb[2 + rr] + fp[FP_BR + 1],
                r2 = rgb[4 + rr] + fp[FP_BR + 2], al = alpha[rr] + fp[FP_BA];
    if constexpr (MODE != MODE_MM) {
      if (f.q == 0) reinterpret_cast<float4*>(a.out)[p] = make_float4(r0, r1, r2, al);
    } else {
      float4* row = reinterpret_cast<float4*>(a.out + (size_t)p * 128) + 8 * f.q;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 8; ++i) row[i] = (f.q == 0 && i == 0) ? make_float4(r0 + al, r1, r2, 0.f) : z;
    }
  }
}

template <int MODE, bool PROF>
__device__ __forceinline__ void consumer(const Args& a, const CUtensorMap* tm) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const bool stash = MODE == MODE_FWD && a.stash != 0;
  Ring ring{0};
  Clock<PROF> clk{PROF && blockIdx.x == 0 && threadIdx.x == 0, 0};
  int it = 0;
#pragma unroll 1
  for (Sched s(a); s.more(); s.next(), ++it) {
    const int p0 = s.p0();
    const uint32_t par = it & 1;
    long long t_tile = 0;
    if constexpr (PROF) t_tile = clock64();
    float alpha[2] = {0.f, 0.f};
    // The ten layers through one copy of the code: 0..8 are W wide (8 is
    // the feature layer, no relu), 9 is the views layer (128 wide).
#pragma unroll 1
    for (int l = 0; l < 10; ++l) {
      const Layer L = layer(l, a);
      // the PE chunks this layer is the first in the tile to read
      clk.begin();
      for (int c = L.pe_c0; c < L.pe_c0 + L.n_pe; ++c)
        if (l == 0 || c >= a.nx) mbar_wait(bar(PE_FULL + c), par);
      clk.end(ST_PE_WAIT);
      // before the epilogue: the last stash store has read the buffer, every
      // warp of the warpgroup its A; then the PE chunks this warpgroup has
      // read for the last time in the tile go back to the PE warps
      auto epilogue_begin = [&]() {
        clk.begin();
        if (stash && t == 0) bulk_wait_read<0>();
        named_bar(BAR_WG + wg, 128);
        clk.end(ST_STASH_WAIT);
        if (t == 0 && (l == 5 || l == 9))
          for (int c = 0; c < PE_CHUNKS; ++c) {
            const bool in_d = c >= a.d0 && c < a.d0 + a.nd;
            if (l == 9 ? in_d : (c < a.nx && !in_d)) mbar_arrive(bar(PE_FREE + c));
          }
        clk.begin();
      };
      if (l < 9) {
        float acc[W / 2];
        matmul_layer(acc, L, a.fp, ring, clk);
        epilogue_begin();
        if (l == 8) {  // the feature layer: no relu
          epilogue<false>(acc, a.fp, true, 0, alpha);
        } else {
          epilogue<true>(acc, a.fp, true, l == 7 ? 1 : 0, alpha);
          if (l == 7) row_sum(alpha);
        }
      } else {
        float acc[64];
        matmul_narrow(acc, L, a.fp, ring, clk);
        if (ring.k & 1) {  // the tile's padding piece
          ring.wait(ring.k);
          ring.release(ring.k);
          ++ring.k;
        }
        epilogue_begin();
        float rgb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        epilogue<true>(acc, a.fp, stash, 2, rgb);  // hv: written only for the stash
        row_sum(rgb);
        clk.end(ST_EPI);
        clk.begin();
        write_out<MODE>(a, p0, rgb, alpha);
        clk.end(ST_OUT);
        clk.begin();
      }
      fence_proxy_async();  // the writes, for the next wgmma and the TMA store
      named_bar(BAR_WG + wg, 128);
      clk.end(ST_EPI);
      if (stash && t == 0) {
        clk.begin();
        const int nch = l < 9 ? W / 64 : 2;
        for (int c = 0; c < nch; ++c)
          tma_store_2d(tm, fsm + SM_ACT + c * CHUNK_B + wg * 64 * 128, l * W + 64 * c, p0 + 64 * wg);
        bulk_commit();
        clk.end(ST_STASH);
      }
    }
    if constexpr (PROF) {
      if (clk.on) {
        long long* sums = clk_sums();
        const long long total = clock64() - t_tile;
        long long rest = total;
        for (int i = 0; i < ST_PE_WORK; ++i)
          if (i != ST_MM) rest -= sums[i];
        sums[ST_MM] = rest;
        for (int i = 0; i < ST_PE_WORK; ++i) {
          a.stamps[(size_t)it * N_ST + i] = sums[i];
          sums[i] = 0;
        }
      }
    }
  }
  if (stash && t == 0) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// the f32 mode: each product as three fp16 products
// ---------------------------------------------------------------------------
//
// Every f32 operand x is split in two fp16 parts, hi = fp16(x s) and lo =
// fp16(x s - hi): s = 1 for the PE (|pe| <= max(1, |x|)), s = 2^SPLIT_SHIFT
// for the weights (|w| < 4094, checked by pack_params), so that a weight's
// lo part stays a normal number down to |w| = 2^-7, and for an activation
// row s = 2^-k, k the least k >= 0 that puts the row's largest |value|
// below 2^15 (ROW_SCALE_BITS), so that no part overflows fp16's 65504
// whatever the activations reach (k = 0, as is every row of an ordinary
// input, gives the bits without the scale): hi + lo is x s within ~2^-22 of
// it, or 2^-25 absolute below that.  The f32 accumulator has the range the
// parts lack: a layer's accumulator rows that sum a scaled row's products
// hold 2^-k times their sum, from their bias on (init_bias's value times
// 2^-k), and the epilogue takes them back by 2^k; layer 5 (a4, then the
// unscaled PE chunk) takes them back before its PE chunk, and the views
// layer (the PE chunk, then feat) scales its accumulator by 2^-k after its
// PE chunk, each only where some row of the warpgroup is scaled (one
// branch a warpgroup: ordinary tiles wait for no wgmma there).  All these
// scales are powers of two, so exact.  The epilogue finds a row's largest
// value over its quad of threads (two shuffles); beside the stash it writes
// each tile's, block's and warp's largest 2^k (`units`), from which the
// f32 wgrad scales its A (nerf_mlp_bwd.cu); the stash holds the unscaled
// values.  A product a . w is taken as hi(a)
// hi(w) + lo(a) hi(w) + hi(a) lo(w), all three into the one f32
// accumulator, which holds 2^SPLIT_SHIFT times the layer's sum from that
// times its bias on (an exact scale); the epilogue takes it back.  lo . lo
// is ~2^-22 of the product.  Two bf16 parts (x within ~2^-17) came within
// 0.80-0.84 of the stash's 1e-5 limit on the card with three products and
// 0.73-0.80 with four (PERF.md).  The
// activation buffer holds both parts of each activation, the PE slot both
// parts of one PE chunk, and the weight blob both parts of each weight: a
// chunk of a 256-wide layer is four pieces (hi rows 0..127, hi rows
// 128..255, lo, lo), which sit in the four stages of the ring; a chunk of
// the views layer, and of every layer at width 128, two (hi, lo).  Bias,
// relu, the heads and the stash are f32: the epilogue splits relu(acc)
// again for the next layer and stores the f32 value itself to the stash.

// A layer of the split: nk chunks of K, the PE slot at chunk pe_at (-1:
// none) and the activation buffer's S_NA chunks in order around it; the PE
// slot goes back to the PE warps once chunk pe_rel is read (-1: not in
// this layer).  Layers 0 and 5 read pe_x (5 after a4), layer 9 pe_d before
// feat, so that the slot is free for the next tile's pe_x while the views
// layer runs.
// Where the accumulator's scale changes between the activation chunks and
// the PE chunk (scale_at: the first chunk of the new scale; -1: nowhere).
struct LayerS {
  int nk, pe_at, pe_rel, scale_at, bias;
};
__device__ __forceinline__ LayerS layer_split(int l) {
  LayerS L;
  L.nk = l == 0 ? 1 : l == 5 || l == 9 ? S_NA + 1 : S_NA;
  L.pe_at = l == 0 || l == 9 ? 0 : l == 5 ? S_NA : -1;
  L.pe_rel = l == 5 ? S_NA : l == 9 ? 0 : -1;
  L.scale_at = l == 5 ? S_NA : l == 9 ? 1 : -1;
  L.bias = l < 8 ? l * W : l == 8 ? FP_BF : FP_BV;
  return L;
}

// A layer of the MULTI instantiation (any PE but nx = nd = 1): nk chunks
// of K, n_pe PE chunks from chunk pe_at and the activation buffer's S_NA
// chunks in order around them (layers 0 and 5 read pe_x's nx chunks, 5
// after a4; layer 9 pe_d's nd chunks before feat; the others none); each
// PE chunk waits for a new fill of the slot (fill) and goes back to the PE
// warps once read (rel), but where nx = 1 layers 0 and 5 share one fill of
// pe_x (layer 0 keeps it, layer 5 takes it without a fill).  scale_at as
// LayerS's.
struct LayerM {
  int nk, pe_at, n_pe, scale_at, bias;
  bool fill, rel;
  __device__ __forceinline__ bool is_pe(int c) const { return c >= pe_at && c < pe_at + n_pe; }
};
__device__ __forceinline__ LayerM layer_multi(int l, const Args& a) {
  LayerM L;
  const bool share = a.nx == 1;
  L.n_pe = l == 0 || l == 5 ? a.nx : l == 9 ? a.nd : 0;
  L.nk = (l == 0 ? 0 : S_NA) + L.n_pe;
  L.pe_at = l == 5 ? S_NA : 0;
  L.scale_at = l == 5 ? S_NA : l == 9 ? a.nd : -1;
  L.fill = !(share && l == 5);
  L.rel = !(share && l == 0);
  L.bias = l < 8 ? l * W : l == 8 ? FP_BF : FP_BV;
  return L;
}
template <bool MULTI> __device__ __forceinline__ auto layer_of(int l, const Args& a) {
  if constexpr (MULTI) return layer_multi(l, a);
  else return layer_split(l);
}
// What matmul_split asks of either kind of layer: whether its first chunk
// is a PE chunk, whether chunk c is one, whether reading chunk c gives the
// slot back.
__device__ __forceinline__ bool pe_first(const LayerS& L) { return L.pe_at == 0; }
__device__ __forceinline__ bool pe_first(const LayerM& L) { return L.n_pe > 0 && L.pe_at == 0; }
__device__ __forceinline__ bool is_pe_chunk(const LayerS& L, int c) { return c == L.pe_at; }
__device__ __forceinline__ bool is_pe_chunk(const LayerM& L, int c) { return L.is_pe(c); }
__device__ __forceinline__ bool gives_pe_back(const LayerS& L, int c) { return c == L.pe_rel; }
__device__ __forceinline__ bool gives_pe_back(const LayerM& L, int c) {
  return L.rel && L.is_pe(c);
}

// The accumulator's rows r0 (entries 4 j, 4 j + 1) and r0 + 8 (4 j + 2, 4 j
// + 3) times f.x and f.y.
template <int R>
__device__ __forceinline__ void scale_rows(float (&acc)[R], float2 f) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] *= (i & 2) ? f.y : f.x;
}

// 2^-k for a row whose largest |value| is m: k the least k >= 0 that puts
// m 2^-k below 2^ROW_SCALE_BITS (nerf_mlp.row_scale_exponents).
__device__ __forceinline__ float row_down(float m) {
  const int e = ((__float_as_int(m) >> 23) & 255) - 127;  // floor(log2 m), m normal
  return e >= ROW_SCALE_BITS ? __int_as_float((127 + ROW_SCALE_BITS - 1 - e) << 23) : 1.f;
}

// bar.sync on named barrier `id` over `count` threads, returning whether p
// holds for any of them.
__device__ __forceinline__ bool named_bar_any(int id, int count, bool p) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred q, o;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred o, %2, %3, q;\n"
      "selp.u32 %0, 1, 0, o;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)p), "r"(id), "r"(count)
      : "memory");
  return r != 0;
}
// The hi part of chunk c's A (its lo part follows at S_PE_LO or S_ACT_LO).
__device__ __forceinline__ const unsigned char* a_chunk_split(const LayerS& L, int c) {
  if (c == L.pe_at) return fsm + S_SM_PE;
  return fsm + SM_ACT + (L.pe_at == 0 ? c - 1 : c) * CHUNK_B;
}
__device__ __forceinline__ const unsigned char* a_chunk_split(const LayerM& L, int c) {
  if (L.is_pe(c)) return fsm + S_SM_PE;
  return fsm + SM_ACT + (L.pe_at == 0 ? c - L.n_pe : c) * CHUNK_B;
}

// One 16-deep fp16 step: m64n256k16 over a chunk's two neighbouring
// pieces (NP = 2) or m64n128k16 over one (NP = 1).
template <int NP, int R>
__device__ __forceinline__ void mma_step(float (&acc)[R], const unsigned char* A,
                                         const unsigned char* B) {
  if constexpr (NP == 2) wgmma_m64n256k16<R, true>(acc, wgmma_desc(A), wgmma_desc(B), 1);
  else wgmma_m64n128k16<R, true>(acc, wgmma_desc(A), wgmma_desc(B), 1);
}


__device__ __forceinline__ void pe_release() {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar(S_PE_FREE));
}

// acc = bias + A[wg rows] . W^T in the split, over the layer's chunks: per
// chunk one wgmma group hi(A) hi(W) + lo(A) hi(W) on its hi pieces, then
// one group hi(A) lo(W) on its lo pieces; each group's pieces go back to
// the ring as soon as it is done, one group kept in flight.  rs: the row
// scales 2^-k of the layer's input activations.  The rows start at
// SPLIT_ACC times the bias, times rs where the layer's first chunk is an
// activation chunk; with `rescale`, before chunk L.scale_at, once the
// groups before are done, they are multiplied by 1 / rs (layer 5, before
// its PE chunk) or rs (the views layer, after its PE chunks).  MULTI
// (LayerM): before a PE chunk that takes a new fill of the slot, the
// groups of a PE chunk just before it are drained and the slot given back,
// then the fill is waited for (`fills`: the fills this thread has taken).
template <int NP, bool MULTI = false, int R, bool PROF, typename Lay>
__device__ __forceinline__ void matmul_split(float (&acc)[R], const Lay& L, const float* fp,
                                             RingT<S_N_WST>& ring, Clock<PROF>& clk, float2 rs,
                                             bool rescale, int& fills) {
  static_assert(R == 64 * NP, "an accumulator of 64 NP columns a thread");
  const int wg_off = (threadIdx.x >> 7) * 64 * 128;
  init_bias(acc, fp, L.bias);
  scale_rows(acc, pe_first(L) ? make_float2(SPLIT_ACC, SPLIT_ACC)
                              : make_float2(SPLIT_ACC * rs.x, SPLIT_ACC * rs.y));
#pragma unroll 1
  for (int c = 0; c < L.nk; ++c) {
    if (rescale && c == L.scale_at) {  // (a warpgroup takes the branch as one)
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
      scale_rows(acc, pe_first(L) ? rs : make_float2(1.f / rs.x, 1.f / rs.y));
    }
    bool drained = false;
    if constexpr (MULTI) {
      if (L.fill && L.is_pe(c)) {
        if (c > 0 && L.is_pe(c - 1)) {  // the slot holds the chunk before: drain, give it back
          wgmma_wait<0>();
          for (int i = 0; i < NP; ++i) ring.release(ring.k - NP + i);
          pe_release();
          drained = true;
        }
        clk.begin();
        mbar_wait(bar(S_PE_FULL), fills & 1);
        ++fills;
        clk.end(ST_PE_WAIT);
      }
    }
    const unsigned char* Ah = a_chunk_split(L, c) + wg_off;
    const unsigned char* Al = Ah + (is_pe_chunk(L, c) ? S_PE_LO : S_ACT_LO);
    clk.begin();
    const unsigned char* Bh = ring.wait(ring.k);
    if (NP == 2) ring.wait(ring.k + 1);
    clk.end(ST_W_WAIT);
    wgmma_fence();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_step<NP>(acc, Ah + ks * 32, Bh + ks * 32);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_step<NP>(acc, Al + ks * 32, Bh + ks * 32);
    wgmma_commit();
    if (c > 0 && !drained) {  // the chunk before: its lo group is done
      wgmma_wait<1>();
      for (int i = 0; i < NP; ++i) ring.release(ring.k - NP + i);
      if (gives_pe_back(L, c - 1)) pe_release();
    }
    clk.begin();
    const unsigned char* Bl = ring.wait(ring.k + NP);
    if (NP == 2) ring.wait(ring.k + NP + 1);
    clk.end(ST_W_WAIT);
    wgmma_fence();
    wgmma_fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_step<NP>(acc, Ah + ks * 32, Bl + ks * 32);
    wgmma_commit();
    wgmma_wait<1>();  // this chunk's hi group is done
    for (int i = 0; i < NP; ++i) ring.release(ring.k + i);
    ring.k += 2 * NP;
  }
  wgmma_wait<0>();
  for (int i = 0; i < NP; ++i) ring.release(ring.k - NP + i);
  if (gives_pe_back(L, L.nk - 1)) pe_release();
  wgmma_fence_regs(acc);
}

// Columns 8 j .. 8 j + 15 of this thread's rows of a layer's output v[8]
// (rows r0 | r0 + 8 of columns 8 j + 2 q, then of 8 (j + 1) + 2 q) as their
// fp16 parts hi = fp16(v) and lo = fp16(v - hi) over the activation
// buffer's hi and lo chunks (stmatrix: lane l gives row l % 8 of matrix l /
// 8 = rows +8 if l / 8 is odd, columns +8 if l >= 16, of the warp's 16 rows
// and 16 columns).
__device__ __forceinline__ void put_split(const float (&v)[8], int j) {
  const Frag f;
  const int lane = threadIdx.x & 31, rr = lane & 7, hi = lane >> 4;
  const int row = f.r0 - (lane >> 2) + ((lane >> 3) & 1) * 8 + rr;
  uint32_t ph[4], pl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ph[i] = pack_f16(v[2 * i], v[2 * i + 1]);
    const float2 h = unpack_f16(ph[i]);
    pl[i] = pack_f16(v[2 * i] - h.x, v[2 * i + 1] - h.y);
  }
  unsigned char* base = fsm + SM_ACT + row * 128 + (j >> 3) * CHUNK_B + ((((j & 7) + hi) ^ rr) << 4);
  stsm_x4(base, ph[0], ph[1], ph[2], ph[3]);
  stsm_x4(base + S_ACT_LO, pl[0], pl[1], pl[2], pl[3]);
}

// The largest of x over each of this thread's rows' quad of threads.
__device__ __forceinline__ float2 quad_max(float2 x) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    x.x = fmaxf(x.x, __shfl_xor_sync(0xffffffffu, x.x, o));
    x.y = fmaxf(x.y, __shfl_xor_sync(0xffffffffu, x.y, o));
  }
  return x;
}

// The largest acc (relu layers: a row's largest relu(acc)) or |acc| of each
// of this thread's rows (r0: entries 4 j, 4 j + 1; r0 + 8: 4 j + 2, 4 j +
// 3), in four chains a row; the warp takes the branch as one.  A relu
// layer's is taken on the floats' bits as signed integers, two values a
// three-way max (a DPX instruction): the bits order the non-negative
// floats, and every negative one lies below the chains' start, 0 (+0.f).
// The feature layer's takes one max a value (|x| is free in it).
template <int N>
__device__ __forceinline__ float2 row_max(const float (&acc)[N], bool relu) {
  if (relu) {
    int m[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // chain c of row r at 4 r + c
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      m[j & 3] = __vimax3_s32(m[j & 3], __float_as_int(acc[4 * j]), __float_as_int(acc[4 * j + 1]));
      m[4 + (j & 3)] = __vimax3_s32(m[4 + (j & 3)], __float_as_int(acc[4 * j + 2]),
                                    __float_as_int(acc[4 * j + 3]));
    }
    return quad_max(make_float2(__int_as_float(max(max(m[0], m[1]), max(m[2], m[3]))),
                                __int_as_float(max(max(m[4], m[5]), max(m[6], m[7])))));
  }
  float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = ((i >> 1) & 1) * 4 + ((i >> 2) & 3);
    m[c] = fmaxf(m[c], fabsf(acc[i]));
  }
  return quad_max(make_float2(fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3])),
                              fmaxf(fmaxf(m[4], m[5]), fmaxf(m[6], m[7]))));
}

// A layer's output in the split from its accumulator of N / 2 columns
// (SPLIT_ACC times bias + the products, times 2^-k of its rows' input
// scale, whose 2^k is `up`): v = relu(acc up / SPLIT_ACC) (relu) or acc up
// / SPLIT_ACC, in f32; with `write` its rows' scales dn = 2^-k (row_down of
// the row's largest |v|) and the parts hi = fp16(v dn) and lo = fp16(v dn
// - hi) written over the activation buffer's hi and lo chunks.  The heads
// sum v in f32 as `epilogue` sums its rounded values (head 1: alpha, head
// 2: rgb).
template <int N, int NH>
__device__ __forceinline__ void epilogue_split(const float (&acc)[N], const float* fp, bool relu,
                                               bool write, int head, float (&hs)[NH], float2 up,
                                               float2& dn) {
  const Frag f;
  const float2 u = make_float2(up.x * (1.f / SPLIT_ACC), up.y * (1.f / SPLIT_ACC));  // exact
  dn = make_float2(1.f, 1.f);
  if (write) {  // u is a positive power of two: the largest |v| is the largest |acc| times u
    const float2 m = row_max(acc, relu);
    dn = make_float2(row_down(m.x * u.x), row_down(m.y * u.y));
  }
  const float2 sc = make_float2(u.x * dn.x, u.y * dn.y);  // exact
  // the heads read v itself: again from acc where a row of the warp is scaled
  const bool again = head != 0 && __any_sync(0xffffffffu, dn.x < 1.f || dn.y < 1.f);
#pragma unroll
  for (int j = 0; j < N / 4; j += 2) {  // columns 8 j .. 8 j + 15
    float v[8];  // rows r0 | r0 + 8 of columns 8 j + 2 q, then of 8 (j + 1) + 2 q
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = acc[4 * j + i] * ((i & 2) ? sc.y : sc.x);  // v dn, exactly
      if (relu) v[i] = fmaxf(v[i], 0.f);
    }
    if (write) put_split(v, j);
    if (head != 0) {
      if (again) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = acc[4 * j + i] * ((i & 2) ? u.y : u.x);
          if (relu) v[i] = fmaxf(v[i], 0.f);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * (j + jj) + 2 * f.q;
#pragma unroll
        for (int k = 0; k < NH / 2; ++k) {
          const int off = head == 1 ? FP_WA : FP_WR + k * WH;
          const float2 w = __ldg(reinterpret_cast<const float2*>(fp + off + col));
          hs[2 * k] = fmaf(v[4 * jj + 1], w.y, fmaf(v[4 * jj], w.x, hs[2 * k]));
          hs[2 * k + 1] = fmaf(v[4 * jj + 3], w.y, fmaf(v[4 * jj + 2], w.x, hs[2 * k + 1]));
        }
      }
    }
  }
}

// The scale units of the tile's block l (a0..a7, feat) for this warp's 16
// rows: the largest 2^k = 1 / dn over its rows before P (1 where none); a
// warp none of whose rows is scaled (every ordinary one) only votes.
__device__ __forceinline__ void put_units(const Args& a, int p0, int l, float2 dn) {
  const Frag f;
  float u = 1.f;
  if (__any_sync(0xffffffffu, dn.x < 1.f || dn.y < 1.f)) {
    u = fmaxf(p0 + f.r0 < a.P ? 1.f / dn.x : 1.f, p0 + f.r0 + 8 < a.P ? 1.f / dn.y : 1.f);
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, o));
  }
  if ((threadIdx.x & 31) == 0)
    a.units[((size_t)(p0 / T) * UNIT_BLOCKS + l) * UNIT_WARPS + (threadIdx.x >> 5)] = u;
}

// The f32 stash of this thread's two rows (those before P) from an
// accumulator of N / 2 columns: the epilogue's v at columns col0 + 8 j +
// 2 q, straight from the registers (no shared memory is left to stage it),
// as streaming float2 stores: a warp instruction writes 8 rows x 32 bytes,
// whole sectors, and the stash's 9,728 bytes a point do not push the
// weights out of L2.
template <int N>
__device__ __forceinline__ void stash_split(const float (&acc)[N], const Args& a, int p0,
                                            int col0, bool relu, float2 up) {
  const Frag f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = p0 + f.r0 + 8 * rr;
    if (p >= a.P) continue;
    float2* row = reinterpret_cast<float2*>(a.acts + (size_t)p * ACTS_LD + col0 + 2 * f.q);
    const float u = (rr ? up.y : up.x) * (1.f / SPLIT_ACC);  // exact
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      float x = acc[4 * j + 2 * rr] * u, y = acc[4 * j + 2 * rr + 1] * u;
      if (relu) {
        x = fmaxf(x, 0.f);
        y = fmaxf(y, 0.f);
      }
      __stcs(row + 4 * j, make_float2(x, y));
    }
  }
}

template <bool PROF, bool MULTI>
__device__ __forceinline__ void consumer_split(const Args& a) {
  const int wg = threadIdx.x >> 7;
  RingT<S_N_WST> ring{0};
  Clock<PROF> clk{PROF && blockIdx.x == 0 && threadIdx.x == 0, 0};
  int it = 0;
  int fills = 0;  // MULTI: the PE slot's fills taken (the parity of the next S_PE_FULL wait)
#pragma unroll 1
  for (Sched s(a); s.more(); s.next(), ++it) {
    const int p0 = s.p0();
    long long t_tile = 0;
    if constexpr (PROF) t_tile = clock64();
    float alpha[2] = {0.f, 0.f};
    // the row scales 2^-k of the layer's input activations (rows r0, r0 +
    // 8), and whether any row of the warpgroup's has k > 0
    float2 rs = make_float2(1.f, 1.f);
    bool any = false;
#pragma unroll 1
    for (int l = 0; l < 10; ++l) {
      const auto L = layer_of<MULTI>(l, a);
      if (!MULTI && (l == 0 || l == 9)) {  // the slot's pe_x (phase 0), then its pe_d (phase 1)
        clk.begin();
        mbar_wait(bar(S_PE_FULL), l == 9 ? 1 : 0);
        clk.end(ST_PE_WAIT);
      }
      // the epilogue's 2^k of the accumulator's rows: 1 for layer 0 (the PE)
      // and layer 5 (taken back before its PE chunk)
      const float2 one = make_float2(1.f, 1.f);
      float2 dn = one;
      if (l < 9) {
        float acc[64 * S_NP];
        matmul_split<S_NP, MULTI>(acc, L, a.fp, ring, clk, rs, any, fills);
        const float2 up = l == 0 || l == 5 ? one : make_float2(1.f / rs.x, 1.f / rs.y);
        clk.begin();
        named_bar(BAR_WG + wg, 128);  // every warp of the warpgroup has read its A
        clk.end(ST_STASH_WAIT);
        clk.begin();
        epilogue_split(acc, a.fp, l != 8, true, l == 7 ? 1 : 0, alpha, up, dn);  // 8: feat, no relu
        if (l == 7) row_sum(alpha);
        clk.end(ST_EPI);
        if (a.acts != nullptr) {
          clk.begin();
          stash_split(acc, a, p0, l * W, l != 8, up);
          if (a.units != nullptr) put_units(a, p0, l, dn);
          clk.end(ST_STASH);
        }
      } else {
        float acc[64];
        matmul_split<1, MULTI>(acc, L, a.fp, ring, clk, rs, any, fills);
        const float2 up = make_float2(1.f / rs.x, 1.f / rs.y);
        while (ring.k % S_N_WST) {  // the tile's padding pieces
          ring.wait(ring.k);
          ring.release(ring.k);
          ++ring.k;
        }
        clk.begin();
        float rgb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        epilogue_split(acc, a.fp, true, false, 2, rgb, up, dn);  // hv: the stash reads the registers
        row_sum(rgb);
        clk.end(ST_EPI);
        clk.begin();
        write_out<MODE_F32>(a, p0, rgb, alpha);
        clk.end(ST_OUT);
        if (a.acts != nullptr) {
          clk.begin();
          stash_split(acc, a, p0, 9 * W, true, up);
          clk.end(ST_STASH);
        }
      }
      rs = dn;
      clk.begin();
      fence_proxy_async();  // the writes, for the next wgmma
      any = named_bar_any(BAR_WG + wg, 128, dn.x < 1.f || dn.y < 1.f);
      clk.end(ST_EPI);
    }
    if constexpr (PROF) {
      if (clk.on) {
        long long* sums = clk_sums();
        const long long total = clock64() - t_tile;
        long long rest = total;
        for (int i = 0; i < ST_PE_WORK; ++i)
          if (i != ST_MM) rest -= sums[i];
        sums[ST_MM] = rest;
        for (int i = 0; i < ST_PE_WORK; ++i) {
          a.stamps[(size_t)it * N_ST + i] = sums[i];
          sums[i] = 0;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// producer and PE warps
// ---------------------------------------------------------------------------

template <int NW>
__device__ __forceinline__ void producer(const Args& a) {
  unsigned char* ring = fsm + (NW == N_WST ? SM_RING : S_SM_RING);
  int k = 0;  // pieces issued
#pragma unroll 1
  for (Sched s(a); s.more(); s.next()) {
#pragma unroll 1
    for (int i = 0; i < a.n_pieces; ++i, ++k) {
      const int st = k % NW;
      mbar_wait(bar(NW + st), ((k / NW) & 1) ^ 1);
      mbar_arrive_expect_tx(bar(st), PIECE_B);
      bulk_g2s(ring + st * PIECE_B, a.w + (size_t)i * PIECE_ELEMS, PIECE_B, bar(st));
    }
  }
}

// Chunk c of the PE tile for the points from p0 (zeros past P): pe_x at
// columns [0, in_ch), pe_d at [dx, dx + d_ch), zeros elsewhere; MODE_F32
// writes it to the PE slot in two fp16 parts (those of the activations).
// MODE_FWD and MODE_F32 compute it from xd: PE thread t < 64 owns points 2 t and 2 t + 1, loads their
// coordinates at once and gives each (point, band, coordinate) of the chunk
// one sincosf for its sin and its cos column, and the identity columns; all
// PE threads write the zero columns.  MODE_MM reads it from the packed PE
// rows (pe_x lanes [0, nfx), pe_d lanes [nfx, nfx + nfd)).
template <int MODE>
__device__ __forceinline__ void pe_chunk(const Args& a, int c, int p0) {
  const int t = threadIdx.x - PE0;
  unsigned char* dst = MODE == MODE_F32 ? fsm + S_SM_PE : fsm + SM_PE + c * CHUNK_B;
  auto put = [&](int p, int col, float v) {  // col: the tile's column, in chunk c
    const uint32_t o = swz128(p, col & 63);
    if constexpr (MODE == MODE_F32) {
      const __half h = __float2half_rn(v);
      *reinterpret_cast<__half*>(dst + o) = h;
      *reinterpret_cast<__half*>(dst + S_PE_LO + o) = __float2half_rn(v - __half2float(h));
    } else {
      *reinterpret_cast<bf16*>(dst + o) = __float2bfloat16_rn(v);
    }
  };
  if constexpr (MODE != MODE_MM) {
    static_assert(2 * 64 == T, "two points a PE thread");
    if (t < 64) {
      float x[2][6];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = p0 + 2 * t + i;
#pragma unroll
        for (int k = 0; k < 6; ++k) x[i][k] = p < a.P ? __ldg(a.in + (size_t)p * 8 + k) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = 2 * t + i;
#pragma unroll
        for (int k = 0; k < 6; ++k) {  // the identity columns
          const int col = (k < 3 ? 0 : a.dx) + k % 3;
          if ((col >> 6) == c) put(p, col, x[i][k]);
        }
      }
      const int ns = 3 * (a.nfx + a.nfd);  // trig slots a point
#pragma unroll 2
      for (int s = 0; s < ns; ++s) {
        const bool is_x = s < 3 * a.nfx;
        const int ss = is_x ? s : s - 3 * a.nfx, j = ss / 3, k = ss - 3 * j;
        const int c_sin = (is_x ? 0 : a.dx) + 3 + 6 * j + k, c_cos = c_sin + 3;
        const bool w_sin = (c_sin >> 6) == c, w_cos = (c_cos >> 6) == c;
        if (!w_sin && !w_cos) continue;
        const float f = (float)(1 << j);  // an exact power-of-two scale
        const int ci = is_x ? k : 3 + k;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = x[i][0];  // x[i][ci] by selects, so that x stays in registers
#pragma unroll
          for (int m = 1; m < 6; ++m) v = m == ci ? x[i][m] : v;
          float sn, cs;
          sincosf(v * f, &sn, &cs);
          if (w_sin) put(2 * t + i, c_sin, sn);
          if (w_cos) put(2 * t + i, c_cos, cs);
        }
      }
    }
#pragma unroll 4
    for (int idx = t; idx < T * 64; idx += PE_THREADS) {  // the zero columns
      const int p = idx >> 6, col = 64 * c + (idx & 63);
      const bool is_x = col < a.dx;
      const int local = is_x ? col : col - a.dx;
      if (local >= 3 + 6 * (is_x ? a.nfx : a.nfd)) put(p, col, 0.f);
    }
  } else {
    constexpr int BATCH = 16;  // loads in flight a thread
#pragma unroll 1
    for (int base = t; base < T * 64; base += BATCH * PE_THREADS) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int idx = base + u * PE_THREADS, p = idx >> 6, col = 64 * c + (idx & 63);
        const bool is_x = col < a.dx;
        const int local = is_x ? col : col - a.dx;
        v[u] = 0.f;
        if (idx < T * 64 && local < (is_x ? a.nfx : a.nfd) && p0 + p < a.P)
          v[u] = __ldg(a.in + (size_t)(p0 + p) * 128 + (is_x ? 0 : a.nfx) + local);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int idx = base + u * PE_THREADS;
        if (idx < T * 64) put(idx >> 6, 64 * c + (idx & 63), v[u]);
      }
    }
  }
}

template <int MODE, bool PROF>
__device__ __forceinline__ void pe_writer(const Args& a) {
  const int t = threadIdx.x - PE0;
  const int nch = max(a.nx, a.d0 + a.nd);
  const bool on = PROF && blockIdx.x == 0 && t == 0;
  int it = 0;
#pragma unroll 1
  for (Sched s(a); s.more(); s.next(), ++it) {
    long long work = 0;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      mbar_wait(bar(PE_FREE + c), (it & 1) ^ 1);  // the tile before has read the chunk
      const long long t0 = on ? clock64() : 0;
      pe_chunk<MODE>(a, c, s.p0());
      fence_proxy_async();  // for the consumers' wgmma reads
      named_bar(BAR_PE, PE_THREADS);
      if (t == 0) mbar_arrive(bar(PE_FULL + c));
      if (on) work += clock64() - t0;
    }
    if constexpr (PROF) {
      if (on) a.stamps[(size_t)it * N_ST + ST_PE_WORK] = work;
    }
  }
}

// The split's PE warps: per tile the slot takes the pe_x chunk (chunk 0 of
// the PE tile, for layers 0 and 5), then the pe_d chunk (chunk d0, for the
// views layer), each once the consumers have released the slot's contents
// before it.  The slot's barriers complete twice a tile, so phase 0 of
// each pair is pe_x's and phase 1 pe_d's.  MULTI: the fills of LayerM's
// order, W0's nx chunks, W5's nx (one fill of chunk 0 for both where nx =
// 1), then the views layer's nd from chunk d0; fill n waits for the slot's
// release n - 1 (phase parity n & 1).
template <bool PROF, bool MULTI>
__device__ __forceinline__ void pe_writer_split(const Args& a) {
  const int t = threadIdx.x - PE0;
  const bool on = PROF && blockIdx.x == 0 && t == 0;
  const int n_x = MULTI && a.nx > 1 ? 2 * a.nx : 1;  // pe_x's fills a tile
  const int n_fill = MULTI ? n_x + a.nd : 2;
  int it = 0;
#pragma unroll 1
  for (Sched s(a); s.more(); s.next(), ++it) {
    long long work = 0;
#pragma unroll 1
    for (int ph = 0; ph < n_fill; ++ph) {
      // the slot's last contents have been read (MULTI: n_fill fills a tile)
      mbar_wait(bar(S_PE_FREE), (MULTI ? (it * n_fill + ph) & 1 : ph) ^ 1);
      const long long t0 = on ? clock64() : 0;
      pe_chunk<MODE_F32>(a, MULTI ? (ph < n_x ? ph % a.nx : a.d0 + ph - n_x) : ph == 0 ? 0 : a.d0,
                         s.p0());
      fence_proxy_async();  // for the consumers' wgmma reads
      named_bar(BAR_PE, PE_THREADS);
      if (t == 0) mbar_arrive(bar(S_PE_FULL));
      if (on) work += clock64() - t0;
    }
    if constexpr (PROF) {
      if (on) a.stamps[(size_t)it * N_ST + ST_PE_WORK] = work;
    }
  }
}

template <int MODE, bool PROF, bool MULTI>
__device__ __forceinline__ void fwd_block(const CUtensorMap* tm_acts, const Args& a) {
  if (smem_u32(fsm) & 1023) __trap();  // the swizzled operands need 1024-byte alignment
  constexpr bool SPLIT = MODE == MODE_F32;
  if (threadIdx.x == 0) {
    if constexpr (SPLIT) {
      for (int i = 0; i < S_N_BARS; ++i)
        mbar_init(bar(i), (i >= S_W_EMPTY && i < S_PE_FULL) || i == S_PE_FREE ? NCONS / 32 : 1);
    } else {
      for (int i = 0; i < N_BARS; ++i)
        mbar_init(bar(i), i >= W_EMPTY && i < PE_FULL ? NCONS / 32 : i >= PE_FREE ? 2 : 1);
    }
    for (int i = 0; i < N_ST; ++i) clk_sums()[i] = 0;
    mbar_fence_init();
  }
  __syncthreads();
  if constexpr (SPLIT) {
    if (threadIdx.x < NCONS) consumer_split<PROF, MULTI>(a);
    else if (threadIdx.x == PRODUCER) producer<S_N_WST>(a);
    else if (threadIdx.x >= PE0) pe_writer_split<PROF, MULTI>(a);
  } else {
    if (threadIdx.x < NCONS) consumer<MODE, PROF>(a, tm_acts);
    else if (threadIdx.x == PRODUCER) producer<N_WST>(a);
    else if (threadIdx.x >= PE0) pe_writer<MODE, PROF>(a);
  }
}

template <int MODE, bool PROF>
__global__ void __launch_bounds__(NTHR, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_acts, const __grid_constant__ Args a) {
  fwd_block<MODE, PROF, false>(&tm_acts, a);
}

// K1 f32 for a PE of more than one 64-column chunk a part (the split's
// MULTI consumers and PE warps).
template <bool PROF>
__global__ void __launch_bounds__(NTHR, 1)
    fwd_split_multi_kernel(const __grid_constant__ CUtensorMap tm_acts,
                           const __grid_constant__ Args a) {
  fwd_block<MODE_F32, PROF, true>(&tm_acts, a);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// PE chunks of W0 / W5 (from chunk 0), the first PE chunk of Wv and their
// number, for pe_x of in_ch channels at column 0 and pe_d of d_ch from
// column dx (nerf_mlp.pe_geometry).
inline void pe_chunks(int in_ch, int d_ch, int dx, int* nx, int* d0, int* nd) {
  *nx = (in_ch + 63) / 64;
  *d0 = dx / 64;
  *nd = (dx + d_ch + 63) / 64 - *d0;
}
// Weight pieces a tile (W / 128 a chunk of the nine W-wide layers -- W0 nx
// chunks, W1..W4 4 W / 64, W5 W / 64 + nx, W6, W7, Wf 3 W / 64 -- and one a
// chunk of Wv, W / 64 + nd); elements of the weight blob.
inline int n_pieces(int nx, int nd) {
  constexpr int NA = W / 64, NP = W / 128;  // chunks of an activation, pieces of a chunk
  const int n = NP * (nx + 4 * NA + NA + nx + 3 * NA) + NA + nd;
  return n + (n & 1);  // a zero piece pads an odd count
}
// The split's pieces a tile: 2 S_NP a chunk of the W-wide layers (W0 nx
// chunks, W1..W4 4 S_NA, W5 S_NA + nx, W6, W7, Wf 3 S_NA), two a chunk of
// Wv (S_NA + nd), padded with zero pieces to a whole number of ring rounds
// (so that each tile's first chunk starts at stage 0).
inline int n_pieces_split(int nx, int nd) {
  const int n = 2 * S_NP * (nx + 4 * S_NA + S_NA + nx + 3 * S_NA) + 2 * (S_NA + nd);
  return (n + S_N_WST - 1) / S_N_WST * S_N_WST;
}
// Elements of the weight blob of either mode (MODE_F32: the split's).
inline long long blob_numel(int in_ch, int d_ch, int dx, bool split) {
  int nx, d0, nd;
  pe_chunks(in_ch, d_ch, dx, &nx, &d0, &nd);
  return (long long)(split ? n_pieces_split(nx, nd) : n_pieces(nx, nd)) * PIECE_ELEMS;
}

template <int MODE, bool MULTI>
inline cudaError_t set_smem(cudaError_t e) {
  constexpr bool HAS_PROF = MODE != MODE_MM;  // the instrumented instantiation is K1's only
  auto set = [&](const void* k) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  };
  if constexpr (MULTI) {
    set((const void*)fwd_split_multi_kernel<false>);
    set((const void*)fwd_split_multi_kernel<true>);
  } else {
    set((const void*)fwd_sm90_kernel<MODE, false>);
    set((const void*)fwd_sm90_kernel<MODE, HAS_PROF>);
  }
  return e;
}

template <int MODE, bool MULTI>
inline void launch_grid(const CUtensorMap& tm, const Args& a, int n_blocks, cudaStream_t stream) {
  if constexpr (MULTI) {
    if (a.stamps != nullptr)
      fwd_split_multi_kernel<true><<<n_blocks, NTHR, SMEM, stream>>>(tm, a);
    else
      fwd_split_multi_kernel<false><<<n_blocks, NTHR, SMEM, stream>>>(tm, a);
  } else if (a.stamps != nullptr) {
    fwd_sm90_kernel<MODE, MODE != MODE_MM><<<n_blocks, NTHR, SMEM, stream>>>(tm, a);
  } else {
    fwd_sm90_kernel<MODE, false><<<n_blocks, NTHR, SMEM, stream>>>(tm, a);
  }
}

// Launches the kernel on n_blocks blocks (at most one an SM: n_blocks <=
// the SM count); returns 0 or a CUDA error code.  `acts` null or the
// [P, ACTS_LD] stash: bf16 (MODE_FWD) or f32 (MODE_F32).  The PE: pe_x of
// in_ch = 3 + 6 nfx channels at column 0, pe_d of d_ch = 3 + 6 nfd from
// column dx (MODE_MM: nfx and nfd lanes), in_ch <= dx and dx + d_ch <=
// PE_LANES.  MODE_F32 holds one PE chunk at a time: a PE of more than one
// chunk a part runs its MULTI instantiation.
template <int MODE>
inline int launch(Args a, void* acts, int n_blocks, cudaStream_t stream) {
  static_assert(MODE != MODE_MM || W == 256, "K5 is compiled for width 256");
  const int in_ch = MODE == MODE_MM ? a.nfx : 3 + 6 * a.nfx;
  const int d_ch = MODE == MODE_MM ? a.nfd : 3 + 6 * a.nfd;
  if (a.P <= 0 || a.nfx < 0 || a.nfd < 0 || a.dx < in_ch || a.dx + d_ch > PE_LANES ||
      n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  static int attr_rc = -1;
  if (attr_rc < 0) {
    cudaError_t e = set_smem<MODE, false>(cudaSuccess);
    if constexpr (MODE == MODE_F32) e = set_smem<MODE, true>(e);
    attr_rc = (int)e;
  }
  if (attr_rc != 0) return attr_rc;
  if (a.stamps != nullptr && MODE == MODE_MM) return (int)cudaErrorInvalidValue;
  pe_chunks(in_ch, d_ch, a.dx, &a.nx, &a.d0, &a.nd);
  CUtensorMap tm;
  memset(&tm, 0, sizeof(tm));
  if (acts != nullptr && MODE == MODE_FWD) {
    const int rc = make_map_2d_bf16(&tm, acts, a.P, ACTS_LD, ACTS_LD * 2, 64, 64);
    if (rc != 0) return rc;
  }
  a.stash = acts != nullptr;
  a.acts = MODE == MODE_F32 ? static_cast<float*>(acts) : nullptr;
  if (MODE == MODE_F32 && (a.acts == nullptr) != (a.units == nullptr))
    return (int)cudaErrorInvalidValue;  // the f32 stash comes with its scale units
  a.ntiles = (a.P + T - 1) / T;
  a.n_pieces = MODE == MODE_F32 ? n_pieces_split(a.nx, a.nd) : n_pieces(a.nx, a.nd);
  if (MODE == MODE_F32 && (a.nx != 1 || a.nd != 1))
    launch_grid<MODE, MODE == MODE_F32>(tm, a, n_blocks, stream);
  else
    launch_grid<MODE, false>(tm, a, n_blocks, stream);
  return (int)cudaGetLastError();
}

}  // namespace fwd90
