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
//   It is the forward kernel's tile loop with the PE stage replaced by a
//   load of the pre-encoded tile: lanes [0, NX) go to columns [0, NX),
//   lanes [NX, NX + ND) to columns [kx, kx + ND) (the port's separately
//   padded layout), each rounded to bf16 as the forward kernel rounds its
//   PE; then the shared layer sequence (forward_tile) and heads.
//   What bounds it: operations, 1,186,816 FLOP per point, as the forward
//   kernel; its bytes (640 per point) are a quarter of that time.
//
// Layouts of the weight blob and the f32 blob: nerf_mlp_common.cuh.

#include "nerf_mlp_common.cuh"

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

// ---------------------------------------------------------------------------
// mm_only
// ---------------------------------------------------------------------------

struct MMArgs {
  const float* pe;    // [P, 128]
  const float* fp;    // biases and heads
  const bf16* w[10];  // W0..W7, Wf, Wv inside the weight blob
  float* out;         // [P, 128]
  int P, kx, kd;
};

// Rows [p0, p0 + T) of the pre-encoded pe [P][128] into the PE tile
// [T][LD] (bf16): column c < kx reads lane c (zero from NX on), column
// kx + i reads lane NX + i (zero from ND on); rows past P are zero.
template <int T, int LD>
__device__ __forceinline__ void load_pe_rows(bf16* pe_s, const float* pe, int p0, int P, int kx,
                                             int kd) {
  const int ncol = kx + kd;
  for (int idx = threadIdx.x; idx < T * ncol; idx += NTHREADS) {
    const int p = idx / ncol, c = idx - p * ncol;
    const int lane = c < kx ? (c < NX ? c : -1) : (c - kx < ND ? NX + c - kx : -1);
    float v = 0.f;
    if (lane >= 0 && p0 + p < P) v = __ldg(pe + (size_t)(p0 + p) * LANES + lane);
    put(pe_s + p * LD + c, v);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) mm_only_kernel(MMArgs args) {
  typedef Tile<true> TL;
  constexpr int T = TL::T, ALD = TL::ACT_LD, PLD = TL::PE_LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* pe = act + T * ALD;
  float* o4 = reinterpret_cast<float*>(pe + T * PLD);  // [T][4] rgb, alpha (the input-row slot)
  bf16* wst = reinterpret_cast<bf16*>(o4 + T * 8);      // weight ring

  const int p0 = blockIdx.x * T;
  const int P = args.P;
  const float* fp = args.fp;

  load_pe_rows<T, PLD>(pe, args.pe, p0, P, args.kx, args.kd);
  __syncthreads();
  forward_tile<true, bf16>(args.w, fp, args.kx, args.kd, act, pe, wst, nullptr, p0, P,
                           [&] { head_alpha<T, ALD>(act, fp, o4, T); });
  head_rgb<T, ALD>(act, fp, o4, T);
  __syncthreads();
  // 128-lane rows, 16 bytes a thread: [rgb0 + alpha, rgb1, rgb2, 0], then zeros
  for (int i = threadIdx.x; i < T * (LANES / 4); i += NTHREADS) {
    const int p = i / (LANES / 4), q = i % (LANES / 4);
    if (p0 + p >= P) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q == 0) v = make_float4(o4[p * 4] + o4[p * 4 + 3], o4[p * 4 + 1], o4[p * 4 + 2], 0.f);
    reinterpret_cast<float4*>(args.out + (size_t)(p0 + p) * LANES)[q] = v;
  }
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

// Launches mm_only (bf16) on `stream`; returns cudaGetLastError().
// w: the bf16 weight blob for (kx, kd), fp: the f32 blob
// (nerf_mlp_fwd_w_numel / _fp_numel give their sizes).  Requires P > 0,
// kx and kd multiples of 32 with kx + kd <= 128, NX <= kx, ND <= kd; all
// pointers 16-byte aligned.
int nerf_mm_only(const float* pe, const void* w, const float* fp, float* out, int P, int kx,
                 int kd, void* stream) {
  constexpr int SMEM = fwd_smem<true>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(mm_only_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  MMArgs a;
  a.pe = pe;
  a.fp = fp;
  a.out = out;
  a.P = P;
  a.kx = kx;
  a.kd = kd;
  fill_offsets<bf16>(a.w, w, kx, kd);
  const int grid = (P + Tile<true>::T - 1) / Tile<true>::T;
  mm_only_kernel<<<grid, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

long long nerf_pe_mm_w_numel(int kx, int kd) { return w_numel(kx, kd); }
long long nerf_pe_mm_fp_numel() { return FP_NUMEL; }

const char* nerf_pe_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
