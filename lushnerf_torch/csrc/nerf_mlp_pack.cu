// The fused NeRF-MLP's weight packs, one launch a pack, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package lays out its weights with XLA
// ops inside its jitted step.  The port packs each MLP's parameters again
// after every Adam step (`pack_params`, `pack_params_bwd` in
// ops/fused/nerf_mlp.py): in torch that is ~220 small launches a pack and,
// in f32, a host read of each matrix's range check, which drains the queue
// (10 a forward pack, 12 a backward pack).  This kernel writes the same blobs,
// bit for bit, in one launch, and leaves the range check on the device.
//
// Layout contract.  The layout is decided in Python alone: `pack_maps`
// runs the torch path's layout code (`fwd_mats_sm90` / `bwd_mats`,
// `swizzle128`, the hi-then-lo order of each 64-column chunk, the zero
// pieces that pad) on a stand-in MLP whose parameters hold codes instead
// of weights.  Element i of a blob is then given by its code c = map[i]:
//   c == 0   a zero fill (+0);
//   c != 0   a = |c| - 1 names parameter a >> OFF_BITS (in the order of
//            mlp.parameters(), at most MAX_PARAMS) at its flat offset
//            a & (2^OFF_BITS - 1); the sign picks the form:
//     weight blob, f32 (fp16 out): x = w 2^SPLIT_SHIFT, c > 0 its hi part
//              __float2half_rn(x), c < 0 its lo part __float2half_rn(x - hi)
//              (`split_f16`); every weight it reads with |x| >= FP16_MAX,
//              NaN or inf raises the range flag;
//     weight blob, bf16 (bf16 out): __float2bfloat16_rn(w), no range check;
//     f32 blob (biases and heads, f32 out): c > 0 w, c < 0 w rounded to
//              bf16 (the heads in bf16 mode).
// The range flag is a device word the caller owns: a pack that finds a
// weight out of range raises it to its generation `gen` (atomicMax), so
// the word needs no reset between packs; the caller copies it to the host
// behind an event and compares it with the pack's generation.
//
// Bound: bytes.  Each element reads its 4-byte code and writes 2 (4 in
// the f32 blob); the parameters (2.4 MB at width 256) are read from L2 by
// the gathers.  The forward pack of the shipped MLP is ~9.7 MB: ~2.9 us at
// 3.35 TB/s.  One thread an element, a grid-stride loop: coalesced codes
// and stores, the gathers' scatter is served by L2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_PARAMS = 32;
constexpr int OFF_BITS = 17;
constexpr int SPLIT_SHIFT = 4;  // mirrors SPLIT_SHIFT in nerf_mlp_fwd_sm90.cuh
constexpr float FP16_MAX = 65504.0f;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 2048;

struct Params {
  const float* p[MAX_PARAMS];
};

__device__ __forceinline__ float fetch(const float* const* p, int c) {
  const int a = abs(c) - 1;
  return p[a >> OFF_BITS][a & ((1 << OFF_BITS) - 1)];
}

__global__ void __launch_bounds__(THREADS)
nerf_mlp_pack_kernel(Params prm, const int* __restrict__ wmap, int n_w, void* __restrict__ w_out,
                     const int* __restrict__ fmap, int n_fp, float* __restrict__ fp_out, int bf16,
                     int* __restrict__ flag, int gen) {
  __shared__ const float* p[MAX_PARAMS];
#pragma unroll
  for (int k = 0; k < MAX_PARAMS; ++k)  // static indices: the struct stays in the param space
    if (threadIdx.x == k) p[k] = prm.p[k];
  __syncthreads();
  bool bad = false;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n_w + n_fp; i += gridDim.x * THREADS) {
    if (i < n_w) {
      const int c = wmap[i];
      const float w = c ? fetch(p, c) : 0.0f;
      if (bf16) {
        static_cast<__nv_bfloat16*>(w_out)[i] = __float2bfloat16_rn(w);
      } else {
        const float x = w * (float)(1 << SPLIT_SHIFT);
        bad |= !(fabsf(x) < FP16_MAX);
        const __half hi = __float2half_rn(x);
        static_cast<__half*>(w_out)[i] = c >= 0 ? hi : __float2half_rn(x - __half2float(hi));
      }
    } else {
      const int c = fmap[i - n_w];
      const float w = c ? fetch(p, c) : 0.0f;
      fp_out[i - n_w] = c < 0 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
    }
  }
  if (bad) atomicMax(flag, gen);
}

}  // namespace

extern "C" {

// One pack: the weight blob of n_w elements by the codes wmap into w_out
// (fp16 for f32, bf16 for bf16), and, where n_fp > 0, the f32 blob of n_fp
// elements by fmap into fp_out, in one launch on `stream`.  params: the
// host array of the n_params parameter pointers (contiguous float32 on the
// device); flag: the device word the range flag raises to gen > 0.
// Returns cudaGetLastError() (0 = OK).
int nerf_mlp_pack(const void* const* params, int n_params, const int* wmap, int n_w, void* w_out,
                  const int* fmap, int n_fp, float* fp_out, int bf16, int* flag, int gen,
                  void* stream) {
  if (n_params < 1 || n_params > MAX_PARAMS || n_w < 0 || n_fp < 0 || gen < 1)
    return (int)cudaErrorInvalidValue;
  Params prm{};
  for (int k = 0; k < n_params; ++k) prm.p[k] = static_cast<const float*>(params[k]);
  const long long n = (long long)n_w + n_fp;
  if (n == 0) return 0;
  if (n > 0x7fffffffLL - MAX_BLOCKS * THREADS) return (int)cudaErrorInvalidValue;  // int index
  const long long blocks = (n + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  nerf_mlp_pack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      prm, wmap, n_w, w_out, fmap, n_fp, fp_out, bf16, flag, gen);
  return (int)cudaGetLastError();
}

// The layout constants the Python side mirrors: 0 MAX_PARAMS, 1 OFF_BITS,
// 2 SPLIT_SHIFT.
int nerf_mlp_pack_consts(int i) {
  return i == 0 ? MAX_PARAMS : i == 1 ? OFF_BITS : i == 2 ? SPLIT_SHIFT : -1;
}

const char* nerf_mlp_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
