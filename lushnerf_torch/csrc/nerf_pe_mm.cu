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
//   2^9 |x|.  One warp writes one point's 128-lane row, 16 bytes a lane.
//   What bounds it: bytes, 32 in and 512 out per point.
//
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

#include "nerf_mlp_fwd_sm90.cuh"

namespace {

using namespace nerf_mlp;

constexpr int LANES = 128;                   // the packed PE and output row
constexpr int NX = 3 + 6 * 10, ND = 3 + 6 * 4;  // xyz and viewdir PE lanes
constexpr float HALF_PI_F = 1.5707963267948966f;  // float32(pi / 2), the cos phase

// ---------------------------------------------------------------------------
// pe_only
// ---------------------------------------------------------------------------

// Lane l of point row `x` ([8] floats) in the packed layout.
__device__ __forceinline__ float pe_lane(const float* x, int l) {
  int local = l;
  if (l >= NX) {
    local = l - NX;
    if (local >= ND) return 0.f;
    x += 3;
  }
  if (local < 3) return __ldg(x + local);
  const int j = (local - 3) / 6, r = (local - 3) % 6;
  const float a = __ldg(x + r % 3) * (float)(1 << j);  // exact power-of-two scale
  return sinf(r < 3 ? a : a + HALF_PI_F);
}

__global__ void __launch_bounds__(256) pe_only_kernel(const float* __restrict__ xd,
                                                      float* __restrict__ out, int P) {
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const float* x = xd + p * 8;
  float4 v;
  v.x = pe_lane(x, 4 * lane + 0);
  v.y = pe_lane(x, 4 * lane + 1);
  v.z = pe_lane(x, 4 * lane + 2);
  v.w = pe_lane(x, 4 * lane + 3);
  reinterpret_cast<float4*>(out + p * LANES)[lane] = v;
}

}  // namespace

extern "C" {

// Launches pe_only on `stream`; returns cudaGetLastError() (0 = OK).
// Requires P > 0, xd [P, 8] and out [P, 128] f32, 16-byte aligned.
int nerf_pe_only(const float* xd, float* out, int P, void* stream) {
  const long long threads = (long long)P * 32;
  const int grid = (int)((threads + 255) / 256);
  pe_only_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(xd, out, P);
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
  a.kx = kx;
  a.kd = kd;
  a.nfx = NX;
  a.nfd = ND;
  return fwd90::launch<fwd90::MODE_MM>(a, nullptr, n_blocks, static_cast<cudaStream_t>(stream));
}

long long nerf_pe_mm_w_numel(int kx, int kd) { return fwd90::blob_numel(kx, kd); }
long long nerf_pe_mm_fp_numel() { return FP_NUMEL; }

const char* nerf_pe_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
