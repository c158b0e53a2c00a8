// Fused NeRF-MLP forward for Hopper (sm_90a): positional encoding + the
// 8xW scene MLP with skip at layer 4 + alpha / feature / views / rgb heads,
// W the build's width (nerf_mlp_common.cuh: 256 or 128).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// lushnerf_tpu/ops/fused/nerf_mlp.py (launched by `_fwd_call`, entry
// `eval_points_fused`), with its activation stash: given a stash pointer the
// kernel also writes a0..a7, feat and hv for the backward kernels, as the
// TPU kernel does with emit_acts.  The PE is not stashed (the TPU kernel's
// emit_pe): the backward recomputes it from xd.
//
// Per point (xd = [x, y, z, dx, dy, dz, 0, 0]):
//   pe_x = posenc(xyz, nfx), pe_d = posenc(dir, nfd)   (identity, then
//          [sin(2^j v), cos(2^j v)] blocks; full range reduction, never the
//          fast intrinsics: arguments reach |x| ~ 800 in NDC at nfx = 10)
//   a0 = relu(pe_x W0 + b0); a_l = relu(a_{l-1} W_l + b_l), l = 1..4
//   a5 = relu(pe_x W5a + a4 W5b + b5)      (skip concat as one K = 256+64
//                                           accumulation; the plain version
//                                           adds two partial products, so
//                                           the sums differ in order only)
//   a6, a7 as a1; alpha = a7 Wa + ba; feat = a7 Wf + bf
//   hv = relu(feat Wvf + pe_d Wvd + bv); rgb = hv Wr + br
//   out[p] = [rgb, alpha]                  ([P, 4] float32)
//
// Two modes, chosen per launch, one design (nerf_mlp_fwd_sm90.cuh: wgmma,
// a weight ring fed by bulk copies, a persistent grid whose PE warps
// overlap the matmuls, the heads in the epilogues), shared with the
// matmul-only kernel of nerf_pe_mm.cu:
//   bf16: every matmul input (PE, activations, weights) is rounded to bf16,
//         products accumulate in f32, bias and relu in f32 -- the rounding
//         points of the TPU kernel's bfloat16 mode.  The stash holds the
//         bf16 values the next layer reads, written by TMA stores.  The
//         flagship path.
//   f32:  f32-grade products on the tensor cores, as the TPU kernel's f32
//         mode runs the MXU at Precision.HIGHEST: each operand split in two
//         fp16 parts (the weights' scaled by 2^4, an activation row's by the
//         power of two that keeps its largest value below 2^15, so that any
//         activation the f32 sums reach has parts) and each product taken as
//         three fp16 products of the parts into one f32 accumulator (the
//         split); bias, relu and the heads in f32;
//         the f32 stash (relu of each accumulator) stored from registers.
//         What the ten shipped scene configs run (mlp_backend = pallas,
//         mlp_compute_dtype left at float32).
//
// What bounds it: compute without the stash, 1,186,816 FLOP per point
// (the shipped PE, 63 / 27 channels) against 48 bytes of input and output,
// far above the card's ~295 FLOP/byte ridge (in f32 three fp16 passes of
// it, at the bf16 rate).  With the stash it
// writes 4,864 more bytes per point in bf16, which puts the bound on the
// bytes; 9,728 in f32, which does not.  At width 128: 314,880 FLOP and
// 2,560 (bf16) or 5,120 (f32) stash bytes a point, so that the stash puts
// both modes' bound on the bytes.  The TPU kernel kept all weights
// resident in VMEM; an SM has 227 KB of shared memory, so here every tile
// streams them from L2 (nerf_mlp_fwd_sm90.cuh).
//
// Layouts of the f32 blob and the stash: nerf_mlp_common.cuh; of the two
// weight blobs: nerf_mlp_fwd_sm90.cuh.

#include "nerf_mlp_fwd_sm90.cuh"

extern "C" {

// Number of elements of the weight blob in the mode's layout for the PE
// of nfx / nfd frequencies with pe_d from column dx, of the f32 blob, the
// stash's row length, the kernel's points a tile, the stage stamps'
// columns and the PE tile's columns; the Python side checks its layouts
// and geometry against these.
long long nerf_mlp_fwd_w_numel(int dx, int nfx, int nfd, int bf16_mode) {
  return fwd90::blob_numel(3 + 6 * nfx, 3 + 6 * nfd, dx, !bf16_mode);
}
long long nerf_mlp_fwd_fp_numel() { return nerf_mlp::FP_NUMEL; }
long long nerf_mlp_fwd_acts_ld() { return nerf_mlp::ACTS_LD; }
int nerf_mlp_fwd_tile() { return fwd90::T; }
int nerf_mlp_fwd_width() { return nerf_mlp::W; }
int nerf_mlp_fwd_n_stages() { return fwd90::N_ST; }
int nerf_mlp_fwd_pe_lanes() { return nerf_mlp::PE_LANES; }
// The f32 stash's scale units: blocks, entries a tile and block, and the
// bits below which a row's fp16 parts hold its values (i = 0, 1, 2).
int nerf_mlp_fwd_units(int i) {
  const int c[3] = {nerf_mlp::UNIT_BLOCKS, nerf_mlp::UNIT_WARPS, nerf_mlp::ROW_SCALE_BITS};
  return i >= 0 && i < 3 ? c[i] : -1;
}

// Launches the kernel on `stream` and returns 0 or a CUDA error code.
// `acts` is null, or a [P, ACTS_LD] stash in the compute dtype; `units`
// (f32 with a stash, else null) its scale units [ceil(P / 128)]
// [UNIT_BLOCKS][UNIT_WARPS] f32 (nerf_mlp_common.cuh); `n_blocks`
// blocks (1 .. the SM count), `stamps` null or [tiles of block 0][n_stages]
// int64 for the stage cycles of the instrumented instantiation.
// The PE: nfx / nfd frequencies, pe_x at column 0 and pe_d from column dx
// of the PE tile (nerf_mlp.pe_geometry), 3 + 6 nfx <= dx and dx + 3 + 6 nfd
// <= PE_LANES.  Requires P > 0; all pointers 16-byte aligned.
int nerf_mlp_fwd(const float* xd, const void* w, const float* fp, float* out, void* acts,
                 float* units, long long* stamps, int P, int dx, int nfx, int nfd,
                 int bf16_mode, int n_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fwd90::Args a;
  memset(&a, 0, sizeof(a));
  a.in = xd;
  a.fp = fp;
  a.w = static_cast<const nerf_mlp::bf16*>(w);
  a.out = out;
  a.units = bf16_mode ? nullptr : units;
  a.stamps = stamps;
  a.P = P;
  a.dx = dx;
  a.nfx = nfx;
  a.nfd = nfd;
  if (bf16_mode) return fwd90::launch<fwd90::MODE_FWD>(a, acts, n_blocks, s);
  return fwd90::launch<fwd90::MODE_F32>(a, acts, n_blocks, s);
}

const char* nerf_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
