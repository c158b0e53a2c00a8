// Fused NeRF-MLP forward for Hopper (sm_90a): positional encoding + the
// 8x256 scene MLP with skip at layer 4 + alpha / feature / views / rgb heads.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// lushnerf_tpu/ops/fused/nerf_mlp.py (launched by `_fwd_call`, entry
// `eval_points_fused`), with its activation stash: given a stash pointer the
// kernel also writes a0..a7, feat and hv for the backward kernel
// (nerf_mlp_bwd.cu), as the TPU kernel does with emit_acts.  The PE is not
// stashed (the TPU kernel's emit_pe): the backward recomputes it from xd.
//
// Per point (xd = [x, y, z, dx, dy, dz, 0, 0]):
//   pe_x = posenc(xyz, nfx), pe_d = posenc(dir, nfd)   (identity, then
//          [sin(2^j v), cos(2^j v)] blocks; sinf/cosf, never the fast
//          intrinsics: arguments reach |x| ~ 800 in NDC at nfx = 10)
//   a0 = relu(pe_x W0 + b0); a_l = relu(a_{l-1} W_l + b_l), l = 1..4
//   a5 = relu(pe_x W5a + a4 W5b + b5)      (skip concat as one K = 64+256
//                                           accumulation; the plain version
//                                           adds two partial products, so
//                                           the sums differ in order only)
//   a6, a7 as a1; alpha = a7 Wa + ba; feat = a7 Wf + bf
//   hv = relu(feat Wvf + pe_d Wvd + bv); rgb = hv Wr + br
//   out[p] = [rgb, alpha]                  ([P, 4] float32)
//
// Two modes, chosen per launch:
//   bf16: every matmul input (PE, activations, weights) is rounded to bf16,
//         products accumulate in f32, bias and relu in f32 -- the rounding
//         points of the TPU kernel's bfloat16 mode.  Tensor cores
//         (mma.sync m16n8k16, bf16 in, f32 accumulate).  The stash holds the
//         bf16 values the next layer reads.
//   f32:  IEEE float32 FMAs throughout (no TF32); f32 stash.
//
// What bounds it: compute without the stash.  1,186,816 FLOP per point
// against 48 bytes of input and output, far above the card's ~295 FLOP/byte
// ridge; the weights (1.19 MB in bf16) are re-read from L2 by every tile.
// With the stash it writes 4,864 more bytes per point in bf16, which puts
// the bound on the bytes.  The TPU kernel kept all weights resident in
// VMEM; an SM has 227 KB of shared memory, so here a tile of 128 points
// keeps its activations in shared memory (one bf16 buffer, rewritten in
// place once a layer's accumulators are complete) and streams each layer's
// weights through a two-stage cp.async ring in K-chunks of 32, so the next
// chunk's load overlaps the current chunk's mma.  Eight warps split each
// layer's output as 2 (points) x 4 (neurons).  The two heads with 1 and 3
// outputs are warp-reduced dot products.  The stash rows are copied out of
// shared memory after each layer, 16 bytes a thread.  wgmma/TMA and a
// persistent schedule are later work.
//
// Layouts of the weight blob, the f32 blob and the stash: nerf_mlp_common.cuh.

#include "nerf_mlp_common.cuh"

namespace {

using namespace nerf_mlp;

template <typename WT> struct Args {
  const float* xd;   // [P, 8]
  const float* fp;   // biases and heads
  const WT* w[10];   // W0..W7, Wf, Wv inside the weight blob
  float* out;        // [P, 4]
  WT* acts;          // [P, ACTS_LD] stash, or null
  int P, kx, kd, nfx, nfd;
};

template <bool BF16, typename WT>
__global__ void __launch_bounds__(NTHREADS, 1) nerf_mlp_fwd_kernel(Args<WT> args) {
  typedef Tile<BF16> TL;
  typedef typename TL::T_act AT;
  constexpr int T = TL::T, ALD = TL::ACT_LD, PLD = TL::PE_LD;
  extern __shared__ __align__(16) unsigned char smem[];
  AT* act = reinterpret_cast<AT*>(smem);
  AT* pe = act + T * ALD;
  float* xs = reinterpret_cast<float*>(pe + T * PLD);
  WT* wst = reinterpret_cast<WT*>(xs + T * 8);  // weight ring (bf16 only)

  const int p0 = blockIdx.x * T;
  const int P = args.P;
  const float* fp = args.fp;

  load_xd<T>(xs, args.xd, p0, P);
  __syncthreads();
  pe_tile<T, PLD>(pe, xs, args.kx, args.kd, args.nfx, args.nfd);
  __syncthreads();
  float* out = args.out + (size_t)p0 * 4;
  forward_tile<BF16, WT>(args.w, fp, args.kx, args.kd, act, pe, wst, args.acts, p0, P,
                         [&] { head_alpha<T, ALD>(act, fp, out, P - p0); });
  head_rgb<T, ALD>(act, fp, out, P - p0);
}

template <bool BF16, typename WT>
int launch(const float* xd, const void* w, const float* fp, float* out, void* acts, int P,
           int kx, int kd, int nfx, int nfd, cudaStream_t stream) {
  typedef Tile<BF16> TL;
  constexpr int SMEM = fwd_smem<BF16>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(nerf_mlp_fwd_kernel<BF16, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  Args<WT> a;
  a.xd = xd;
  a.fp = fp;
  a.out = out;
  a.acts = static_cast<WT*>(acts);
  a.P = P;
  a.kx = kx;
  a.kd = kd;
  a.nfx = nfx;
  a.nfd = nfd;
  fill_offsets<WT>(a.w, w, kx, kd);
  const int grid = (P + TL::T - 1) / TL::T;
  nerf_mlp_fwd_kernel<BF16, WT><<<grid, NTHREADS, SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of elements of the weight blob and of the f32 blob for (kx, kd),
// and the stash's row length; the Python packer checks its layout against
// these.
long long nerf_mlp_fwd_w_numel(int kx, int kd) { return w_numel(kx, kd); }
long long nerf_mlp_fwd_fp_numel() { return FP_NUMEL; }
long long nerf_mlp_fwd_acts_ld() { return ACTS_LD; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = OK).
// `acts` is null, or a [P, ACTS_LD] stash in the compute dtype.
// Requires P > 0, kx and kd multiples of 32 with kx + kd <= 128,
// 3 + 6 * nfx <= kx and 3 + 6 * nfd <= kd; all pointers 16-byte aligned.
int nerf_mlp_fwd(const float* xd, const void* w, const float* fp, float* out, void* acts,
                 int P, int kx, int kd, int nfx, int nfd, int bf16_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_mode)
    return launch<true, bf16>(xd, w, fp, out, acts, P, kx, kd, nfx, nfd, s);
  return launch<false, float>(xd, w, fp, out, acts, P, kx, kd, nfx, nfd, s);
}

const char* nerf_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
