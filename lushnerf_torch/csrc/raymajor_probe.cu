// Per-ray primitives of a ray-major fused renderer, for Hopper (sm_90a).
// Each works on per-sample values laid out ray by ray: row t * S + s is
// sample s of ray t.
//
// They replace the Pallas TPU probe kernels of
// scripts/probe_raymajor_mosaic.py, which tested whether Mosaic could build
// these primitives (two compiled to wrong values on the v5e):
//   excl_cumsum   `probe_p1_batched_cumsum.kern` and `probe_p1b_batched_dot.kern`
//                 (both an exclusive cumsum over S by a strictly lower
//                 triangular [S, S] matmul): x [T*S, c] -> y[t, s, :] =
//                 sum of x[t, k, :] over k < s.  One warp per ray: for each
//                 channel a shuffle scan over chunks of 32 samples with a
//                 running carry, so any S works.
//   transpose     `probe_p2_vector_transpose.kern`: [T*S, 1] -> [T, S].  In a
//                 row-major layout both are the same bytes: a copy, one
//                 thread per value, 16 bytes a thread.  The last n % 4
//                 floats, where there are any, go to the thread after the
//                 last 16-byte value, in an instantiation of their own: a
//                 tail test in every thread cost ~2% of the copy, and
//                 several loads in flight a thread on a grid sized to the
//                 SMs cost more (PERF.md).
//   searchsorted  `probe_p3_searchsorted.kern`: cdf [T, S], u [T*SI, 1] ->
//                 the count of cdf[t, :] <= u, as float, for any row,
//                 sorted or not, with ties.  One warp per ray (8 rays a
//                 block) stages the cdf row in shared memory with 16-byte
//                 loads (NaN past S, which no compare counts) and checks
//                 whether it is non-decreasing.  If it is, the count is
//                 the row's upper bound of u, found by a branchless binary
//                 search (log2 S steps; the same number exactly, as
//                 [row[k] <= u] is then 1 up to that index and 0 after).
//                 Otherwise each lane holds UPL of the ray's u in registers
//                 and walks the row as float4 broadcasts, one 16-byte
//                 shared load for 4 x UPL compares.
//   masked_dists  `probe_p4_masked_roll.kern`: z [T*S, 1] -> z[k+1] - z[k],
//                 0 at each ray's last sample.  One thread per sample.
// What bounds them: bytes (each reads and writes a few bytes per sample
// and does one to S operations on it); at the renderer's shapes (5120 rays
// x 64 or 128 samples) they move 1-4 MB, so a launch's fixed cost is most
// of their time.  The searchsorted count's S compares per u (84 M at 5120
// x 128, ~2.5 instructions each) take longer than its bytes, so a sorted
// row, the renderer's case, takes the log2 S steps of the binary search.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256) excl_cumsum_kernel(const float* __restrict__ x,
                                                          float* __restrict__ y, int T, int S,
                                                          int c) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= T) return;
  const size_t base = (size_t)t * S * c;
  for (int ch = 0; ch < c; ++ch) {
    float carry = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const float v = s < S ? __ldg(x + base + (size_t)s * c + ch) : 0.f;
      float incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += n;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      if (s < S) y[base + (size_t)s * c + ch] = carry + excl;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

template <bool TAIL>
__global__ void __launch_bounds__(256) copy_kernel(const float4* __restrict__ x,
                                                   float4* __restrict__ y, long long n4,
                                                   const float* __restrict__ xt,
                                                   float* __restrict__ yt, int tail) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    y[i] = __ldg(x + i);
  } else if (TAIL && i == n4) {
    for (int t = 0; t < tail; ++t) yt[t] = __ldg(xt + t);
  }
}

constexpr int SS_RAYS = 8;  // rays (warps) per searchsorted block

template <int UPL>
__global__ void __launch_bounds__(32 * SS_RAYS) searchsorted_kernel(const float* __restrict__ cdf,
                                                                    const float* __restrict__ u,
                                                                    float* __restrict__ out,
                                                                    int T, int S, int SI) {
  extern __shared__ float4 rows4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * SS_RAYS + warp;
  if (t >= T) return;
  const int S4 = (S + 3) >> 2;
  float4* row4 = rows4 + (size_t)warp * S4;
  float* row = reinterpret_cast<float*>(row4);
  const float* src = cdf + (size_t)t * S;
  if ((S & 3) == 0) {  // the row starts 16-byte aligned
    for (int k = lane; k < S4; k += 32) row4[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
  } else {
    for (int k = lane; k < 4 * S4; k += 32) row[k] = k < S ? __ldg(src + k) : __int_as_float(0x7fffffff);
  }
  __syncwarp();
  const float* ut = u + (size_t)t * SI;
  float* ot = out + (size_t)t * SI;
  bool sorted = true;  // false for a NaN too
  for (int k = lane; k + 1 < S; k += 32) sorted &= row[k] <= row[k + 1];
  if (__all_sync(0xffffffffu, sorted)) {
    int top = 1;
    while (top * 2 <= S) top *= 2;
    for (int i = lane; i < SI; i += 32) {
      const float v = __ldg(ut + i);
      int n = 0;  // row[0 : n] <= v
      for (int step = top; step > 0; step >>= 1)
        if (n + step <= S && row[n + step - 1] <= v) n += step;
      ot[i] = (float)n;
    }
    return;
  }
  for (int i0 = 0; i0 < SI; i0 += 32 * UPL) {
    float v[UPL];
    int n[UPL];
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int i = i0 + 32 * j + lane;
      v[j] = i < SI ? __ldg(ut + i) : 0.f;
      n[j] = 0;
    }
#pragma unroll 4
    for (int k = 0; k < S4; ++k) {
      const float4 c = row4[k];  // one broadcast load for the warp
#pragma unroll
      for (int j = 0; j < UPL; ++j)
        n[j] += (c.x <= v[j]) + (c.y <= v[j]) + (c.z <= v[j]) + (c.w <= v[j]);
    }
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int i = i0 + 32 * j + lane;
      if (i < SI) ot[i] = (float)n[j];
    }
  }
}

__global__ void __launch_bounds__(256) masked_dists_kernel(const float* __restrict__ z,
                                                           float* __restrict__ d, long long n,
                                                           int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  d[i] = (i % S == S - 1) ? 0.f : __ldg(z + i + 1) - __ldg(z + i);
}

int blocks(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Each launches its kernel on `stream` and returns cudaGetLastError()
// (0 = OK).  Arrays are contiguous float32, 16-byte aligned; T, S, c, SI,
// n > 0.

int raymajor_excl_cumsum(const float* x, float* y, int T, int S, int c, void* stream) {
  excl_cumsum_kernel<<<blocks((long long)T * 32, 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, y, T, S, c);
  return (int)cudaGetLastError();
}

int raymajor_transpose(const float* x, float* y, long long n, void* stream) {
  const long long n4 = n / 4;
  const int tail = (int)(n - 4 * n4);
  const int grid = blocks(n4 + (tail > 0), 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  if (tail > 0)
    copy_kernel<true><<<grid, 256, 0, st>>>(x4, y4, n4, x + 4 * n4, y + 4 * n4, tail);
  else
    copy_kernel<false><<<grid, 256, 0, st>>>(x4, y4, n4, x + 4 * n4, y + 4 * n4, tail);
  return (int)cudaGetLastError();
}

// Requires SS_RAYS rows of round_up(S, 4) floats <= 48 KB of shared memory.
int raymajor_searchsorted(const float* cdf, const float* u, float* out, int T, int S, int SI,
                          void* stream) {
  const size_t smem = (size_t)SS_RAYS * ((S + 3) / 4) * sizeof(float4);
  const int grid = (T + SS_RAYS - 1) / SS_RAYS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (SI > 64)
    searchsorted_kernel<4><<<grid, 32 * SS_RAYS, smem, st>>>(cdf, u, out, T, S, SI);
  else if (SI > 32)
    searchsorted_kernel<2><<<grid, 32 * SS_RAYS, smem, st>>>(cdf, u, out, T, S, SI);
  else
    searchsorted_kernel<1><<<grid, 32 * SS_RAYS, smem, st>>>(cdf, u, out, T, S, SI);
  return (int)cudaGetLastError();
}

int raymajor_masked_dists(const float* z, float* d, long long n, int S, void* stream) {
  masked_dists_kernel<<<blocks(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(z, d, n, S);
  return (int)cudaGetLastError();
}

const char* raymajor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
