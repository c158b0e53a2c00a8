// The two halves of the fused NeRF-MLP forward as kernels of their own, for
// the kernel-cost split of lushnerf_torch/scripts/tune_kernel.py: the packed
// positional encoding alone (pe_only) and the scene MLP alone on a
// pre-encoded PE (mm_only).  Hopper (sm_90a).
//
// pe_only replaces the Pallas TPU kernel `pe_kernel` / `pe_only` of
// scripts/tune_kernel.py (`_pe_forward(xd, C)[1]` of
// lushnerf_tpu/ops/fused/nerf_mlp.py):
//   xd [P, 8] f32 -> pe [P, 128] f32 in the JAX packed layout at the
//   tuning script's fixed 10 xyz and 4 viewdir frequencies: lanes [0, 63)
//   the xyz PE [x, sin 2^0 x, cos 2^0 x, ..., cos 2^9 x], lanes [63, 90)
//   the viewdir PE, the rest zero.
//   Each trig lane is sinf(a + phase) with phase 0 (sin) or the f32 pi/2
//   (cos), as `_pe_forward` computes it: the rounding of a + pi/2 is part
//   of the function (it moves a cos lane by up to half an ulp of a, 3e-5 at
//   |a| ~ 800), so this kernel gives the TPU kernel's values lane for lane.
//   sinf with its full range reduction, never the fast intrinsic: a reaches
//   2^9 |x|.
//   What bounds it: bytes, 32 in and 512 out per point (0.160 ms at P =
//   983,040); its 84 sinf a point are ~half of that in issue slots.
//   Design: a persistent grid of 128-thread blocks over tiles of 64 points.
//   A block reads its tile's xd once (one 16-byte load a thread, issued a
//   tile ahead), then its
//   threads take the tile's 64 x 42 (point, coordinate, frequency) items,
//   21 each, every lane busy on one code path: each item is one angle a =
//   2^j x, whose sin lane and shifted cos lane it writes into the tile's
//   rows in shared memory, beside the 6 identity lanes a point; the zero
//   lanes [90, 128) are written once a block.  The tile's 64 rows, 32 KB
//   of contiguous output, then leave in one bulk copy that one thread
//   issues, so that no thread spends an instruction on the stores; the
//   next tile waits only for the copy to have read the rows.  Several
//   blocks an SM overlap one tile's copy with another's sines.

// mm_only replaces the Pallas TPU kernel `mm_kernel` / `mm_only` of
// scripts/tune_kernel.py (`_fwd_activations(pe, w, bfloat16)`):
//   pe [P, 128] f32 (the layout above) + the bf16 weight blob and the f32
//   blob of nerf_mlp_fwd.cu -> out [P, 128] f32: lane 0 = rgb0 + alpha,
//   lanes 1, 2 = rgb1, rgb2, all other lanes zero (the TPU kernel's
//   `concat(rgb[:, :4], 0) + alpha`, whose padded lanes are zero).
//   It is the bf16 forward kernel's design (nerf_mlp_fwd_sm90.cuh: wgmma,
//   a weight ring fed by bulk copies, a persistent grid) with the PE warps
//   loading the pre-encoded tile instead of computing it: lanes [0, NX) go
//   to columns [0, NX), lanes [NX, NX + ND) to columns [kx, kx + ND) (the
//   port's separately padded layout), each
//   rounded to bf16 as the forward kernel rounds its PE; then the same
//   layer sequence and heads, and 128-lane output rows.
//   What bounds it: operations, 1,186,816 FLOP per point, as the forward
//   kernel; its bytes (1,024 per point) are a quarter of that time.
//
// Layouts of the weight blob (bf16, the forward kernel's) and the f32 blob:
// nerf_mlp_fwd_sm90.cuh and nerf_mlp_common.cuh.

#include <algorithm>

#include "nerf_mlp_fwd_sm90.cuh"

namespace {

using namespace nerf_mlp;

constexpr int LANES = 128;                   // the packed PE and output row
constexpr int NX = 3 + 6 * 10, ND = 3 + 6 * 4;  // xyz and viewdir PE lanes
constexpr float HALF_PI_F = 1.5707963267948966f;  // float32(pi / 2), the cos phase

// ---------------------------------------------------------------------------
// pe_only
// ---------------------------------------------------------------------------

constexpr int PE_T = 64;                          // points a tile
constexpr int PE_NT = 128;                        // threads a block
constexpr int PE_ANGLES = 3 * 10 + 3 * 4;         // (coordinate, frequency) a point
constexpr int PE_ITEMS = PE_T * PE_ANGLES / PE_NT;  // items a thread a tile: 21
static_assert(PE_T * PE_ANGLES % PE_NT == 0, "every thread takes as many items");
static_assert(PE_T * 6 % PE_NT == 0 && PE_T * 2 == PE_NT, "identity lanes, xd loads");

__global__ void __launch_bounds__(PE_NT) pe_only_kernel(const float* __restrict__ xd,
                                                         float* __restrict__ out, int P) {
  __shared__ __align__(16) float rows[PE_T * LANES];  // the tile's PE rows
  __shared__ __align__(16) float xs[PE_T * 8];        // and its xd rows
  const int t = threadIdx.x;
  for (int i = t; i < PE_T * (LANES - NX - ND); i += PE_NT)  // the zero lanes, once
    rows[(i / (LANES - NX - ND)) * LANES + NX + ND + i % (LANES - NX - ND)] = 0.f;
  const int ntiles = (P + PE_T - 1) / PE_T;
  // this thread's 16 bytes of a tile's xd rows (zeros past P)
  auto xd_of = [&](int tile) {
    const long long p = (long long)tile * PE_T + t / 2;
    return tile < ntiles && p < P ? __ldg(reinterpret_cast<const float4*>(xd + p * 8) + (t & 1))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 v = xd_of(blockIdx.x);
#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * PE_T;
    const int n = (int)min((long long)PE_T, P - p0);
    if (t == 0) hopper::bulk_wait_read<0>();  // the tile before's copy has read `rows`
    __syncthreads();
    reinterpret_cast<float4*>(xs)[t] = v;
    __syncthreads();
    v = xd_of(tile + gridDim.x);  // the next tile's, in flight while this one computes
#pragma unroll 3
    for (int k = 0; k < PE_ITEMS; ++k) {
      const int i = t + PE_NT * k, p = i / PE_ANGLES, q = i - PE_ANGLES * p;
      const bool dir = q >= 30;                   // viewdir angles after the xyz ones
      const int qq = dir ? q - 30 : q, j = qq / 3, c = qq - 3 * j;
      const float a = xs[p * 8 + (dir ? 3 : 0) + c] * __int_as_float((127 + j) << 23);  // exact
      float* row = rows + p * LANES + (dir ? NX : 0) + 3 + 6 * j + c;
      row[0] = sinf(a);
      row[3] = sinf(a + HALF_PI_F);
    }
#pragma unroll
    for (int k = 0; k < PE_T * 6 / PE_NT; ++k) {  // the identity lanes
      const int i = t + PE_NT * k, p = i / 6, m = i - 6 * p;
      rows[p * LANES + (m < 3 ? m : NX + m - 3)] = xs[p * 8 + m];
    }
    hopper::fence_proxy_async();  // the rows, for the bulk copy
    __syncthreads();
    if (t == 0) {
      hopper::bulk_s2g(out + p0 * LANES, rows, n * LANES * 4);
      hopper::bulk_commit();
    }
  }
  if (t == 0) hopper::bulk_wait<0>();
}

}  // namespace

extern "C" {

// Launches pe_only on `stream`; returns cudaGetLastError() (0 = OK).
// Requires P > 0, xd [P, 8] and out [P, 128] f32, 16-byte aligned.
int nerf_pe_only(const float* xd, float* out, int P, void* stream) {
  static int max_blocks = 0;  // the persistent grid: as many blocks as fit on the card
  if (max_blocks == 0) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pe_only_kernel, PE_NT, 0);
    if (e != cudaSuccess) return (int)e;
    if (n_sm * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    max_blocks = n_sm * per_sm;
  }
  const int grid = (int)std::min<long long>(max_blocks, ((long long)P + PE_T - 1) / PE_T);
  pe_only_kernel<<<grid, PE_NT, 0, static_cast<cudaStream_t>(stream)>>>(xd, out, P);
  return (int)cudaGetLastError();
}

// Launches mm_only (bf16) on `n_blocks` blocks (1 .. the SM count) on
// `stream`; returns 0 or a CUDA error code.
// w: the bf16 weight blob for (kx, kd), fp: the f32 blob
// (nerf_pe_mm_w_numel / _fp_numel give their sizes).  Requires P > 0,
// kx and kd multiples of 32 with kx + kd <= 128, NX <= kx, ND <= kd; all
// pointers 16-byte aligned.
int nerf_mm_only(const float* pe, const void* w, const float* fp, float* out, int P, int kx,
                 int kd, int n_blocks, void* stream) {
  if (NX > kx || ND > kd) return (int)cudaErrorInvalidValue;
  fwd90::Args a;
  memset(&a, 0, sizeof(a));
  a.in = pe;
  a.fp = fp;
  a.w = static_cast<const bf16*>(w);
  a.out = out;
  a.P = P;
  a.dx = kx;  // the port's separately padded layout: pe_d from column kx
  a.nfx = NX;
  a.nfd = ND;
  return fwd90::launch<fwd90::MODE_MM>(a, nullptr, n_blocks, static_cast<cudaStream_t>(stream));
}

long long nerf_pe_mm_w_numel(int kx, int kd) { return fwd90::blob_numel(NX, ND, kx, false); }
long long nerf_pe_mm_fp_numel() { return FP_NUMEL; }

const char* nerf_pe_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
