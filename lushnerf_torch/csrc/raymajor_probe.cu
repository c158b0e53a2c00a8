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
//                 sum of x[t, k, :] over k < s.  For c a power of two up to
//                 128, one pass: x is n = T*S*c floats in rays of L = S*c,
//                 float f of channel f % c, a float4 a thread (every load
//                 issued at once).  A group takes whole rays, 128 floats a
//                 warp a pass: one warp alone where its 128 floats hold a
//                 ray (the renderer's S <= 125 at c 1: no barrier), else
//                 the block's 8 warps; a group's first float4 may start
//                 inside the ray before it, and a ray may start anywhere
//                 in a float4 (c 1 or 2, L not a multiple of 4).  Each
//                 thread scans its 4 floats by channel, restarting at a
//                 ray start; then a segmented scan over the threads'
//                 totals: threads P = max(c / 4, 1) apart hold the same
//                 channels, so the shuffle steps are P * 2^k, and a thread
//                 starts a segment where a ray starts in it (P = 1) or
//                 where it lies in its ray's first sample (P > 1); each
//                 lane finds its segment's first lane from a ballot of the
//                 flags, so the steps shuffle values only.  A block's
//                 warps combine through shared memory; a ray longer than a
//                 pass carries its sums to the group's next pass.  Where a
//                 thread's place in its ray lies needs one division, a
//                 multiply and a shift (`Divider`).  Any other c takes the
//                 general kernel: one warp per ray, for each channel a
//                 shuffle scan over chunks of 32 samples with a carry.
//                 More floats a thread (8, 16), or several passes a warp
//                 with their loads issued first, measured slower (PERF.md).
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
//                 0 at each ray's last sample.  A thread takes 4 samples as
//                 one float4 and z[k+1] of its last from the next lane (the
//                 warp's last lane, or the last whole float4, loads it,
//                 beside its float4); a multiply and a shift find where its
//                 samples lie in their ray.  The last n % 4 samples go to
//                 the thread after the last float4, as in the copy.
// Both take 32-bit index arithmetic up to n = INDEX32_MAX in
// ops/fused/raymajor.py and a 64-bit instantiation beyond it (the wrapper
// chooses).
// What bounds them: bytes (each reads and writes a few bytes per sample
// and does one to S operations on it); at the renderer's shapes (5120 rays
// x 64 or 128 samples) they move 1-4 MB, so a launch's fixed cost is most
// of their time: Tensor.clone of 16 bytes takes ~1.9 us of the ~2.2-2.6 of
// a clone of these bytes (PERF.md).  The cumsum's scan adds a chain of
// shuffles after its loads; the dists are within ~10% of the clone.  The searchsorted count's S compares per u (84 M at 5120
// x 128, ~2.5 instructions each) take longer than its bytes, so a sorted
// row, the renderer's case, takes the log2 S steps of the binary search.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// The general cumsum: one warp per ray, channel by channel, chunks of 32
// samples with a running carry.
template <typename I>
__global__ void __launch_bounds__(256) excl_cumsum_kernel(const float* __restrict__ x,
                                                          float* __restrict__ y, I T, int S,
                                                          int c) {
  const I t = ((I)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= T) return;
  const I base = t * S * c;
  for (int ch = 0; ch < c; ++ch) {
    float carry = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const float v = s < S ? __ldg(x + base + (I)s * c + ch) : 0.f;
      float incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += n;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
      if (s < S) y[base + (I)s * c + ch] = carry + excl;
      carry += __shfl_sync(FULL, incl, 31);
    }
  }
}

// x / d for 0 <= x < 2^31 as a multiply and a shift: m = floor(2^s / d) + 1,
// s = 31 + ceil(log2 d) (`divider` in ops/fused/raymajor.py); the 64-bit
// instantiations divide.
struct Divider {
  unsigned m;
  int s;
};

__device__ __forceinline__ int rem(int x, int d, Divider dv) {
  return x - (int)(((unsigned long long)(unsigned)x * dv.m) >> dv.s) * d;
}
__device__ __forceinline__ long long rem(long long x, long long d, Divider) { return x % d; }

constexpr int CS_WARPS = 8;  // a vector cumsum block

// The vector cumsum for C channels (a power of two up to 128), 4 floats (a
// float4) a thread, in blocks of CS_WARPS warps.  A group of G warps (G =
// 1: each warp alone, its rays fitting one pass; G = CS_WARPS: the block)
// takes rays_per_block rays of L = S * C floats (n floats from float 0),
// 128 * G floats a pass.  CM channels lie in a thread's 4 floats (float k is
// channel k % CM of its row), and threads P apart hold the same channels.
// A ray starts only at a float k % CM == 0 of a thread.
template <typename I, int C, int G>
__global__ void __launch_bounds__(32 * CS_WARPS) excl_cumsum_vec_kernel(
    const float* __restrict__ x, float* __restrict__ y, I n, I L, Divider dl, int rays_per_block) {
  static_assert(G == 1 || G == CS_WARPS, "a group is one warp or the whole block");
  constexpr int F = 4, CM = C < F ? C : F, P = C < F ? 1 : C / F;
  __shared__ float wsum[G][P][CM];  // each warp's inclusive sums, its last P lanes
  __shared__ unsigned wflag[G];     // each warp's ballot of segment starts
  __shared__ float carry_s[P][CM];  // the block's sums so far, for a ray past one pass
  const int lane = threadIdx.x & 31, warp = G == 1 ? 0 : threadIdx.x >> 5;
  const int tid = 32 * warp + lane;  // the thread in its group
  const I group = G == 1 ? (I)blockIdx.x * CS_WARPS + (threadIdx.x >> 5) : (I)blockIdx.x;
  const int r = lane & (P - 1);  // this thread's channel class
  // the lanes of this class: bits r, r + P, ... (P = 32: bit r alone)
  const unsigned cbits = (FULL / (unsigned)((1ull << P) - 1)) << r;
  const unsigned below = (1u << lane) - 1;
  const I start = group * rays_per_block * L;
  if (start >= n) return;  // a warp past the last group (G = 1)
  const I end = min(start + (I)rays_per_block * L, n);
  const I q_end = (end + F - 1) / F;
  float carry[CM];  // G = 1: the warp's sums so far
#pragma unroll
  for (int k = 0; k < CM; ++k) carry[k] = 0.f;
  if (G > 1 && tid < P) {
#pragma unroll
    for (int k = 0; k < CM; ++k) carry_s[tid][k] = 0.f;
  }
  for (I q0 = start / F; q0 < q_end; q0 += 32 * G) {
    const I q = q0 + tid, f0 = F * q;
    float v[F];
    if (f0 + F - 1 < n) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(x) + q);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < F; ++k) v[k] = f0 + k < n ? __ldg(x + f0 + k) : 0.f;
    }
    // this thread's floats by channel, restarting where a ray starts
    const I p0 = rem(f0, L, dl);  // float f0's place in its ray
    bool head[F];
    if (L >= F) {  // a ray starts at float h of this thread, if h < F
      const I h = p0 == 0 ? 0 : L - p0;
#pragma unroll
      for (int k = 0; k < F; ++k) head[k] = h == k;
    } else {
      I p = p0;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        head[k] = p == 0;
        p = p + 1 == L ? 0 : p + 1;
      }
    }
    float run[CM], loc[F];
#pragma unroll
    for (int k = 0; k < CM; ++k) run[k] = 0.f;
    bool seen = false, after[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      if (k % CM == 0) {
#pragma unroll
        for (int i = 0; i < CM; ++i) run[i] = head[k] ? 0.f : run[i];
        seen |= head[k];
      }
      after[k] = seen;
      loc[k] = run[k % CM];
      run[k % CM] += v[k];
    }
    const bool first_row = p0 < C;  // in its ray's first sample: P > 1 starts a segment here
    const unsigned flags = __ballot_sync(FULL, seen || first_row);
    const unsigned starts = flags & cbits;
    const int seg = starts & (below | (1u << lane)) ? 31 - __clz(starts & (below | (1u << lane)))
                                                    : -1;
    const int from = seg > 0 ? seg : 0;  // the lowest lane this lane's sum takes
    float a[CM];
#pragma unroll
    for (int k = 0; k < CM; ++k) a[k] = run[k];
#pragma unroll
    for (int o = P; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < CM; ++k) {
        const float u = __shfl_up_sync(FULL, a[k], o);
        if (lane - o >= from) a[k] += u;
      }
    }
    float e[CM];  // the inclusive sums of the lane P below
#pragma unroll
    for (int k = 0; k < CM; ++k) e[k] = __shfl_up_sync(FULL, a[k], P);
    const bool e_starts = (starts & below) != 0;
    float pre[CM];  // the group's sums for this class before this warp
#pragma unroll
    for (int k = 0; k < CM; ++k) pre[k] = carry[k];
    if constexpr (G > 1) {
      if (lane >= 32 - P) {
#pragma unroll
        for (int k = 0; k < CM; ++k) wsum[warp][r][k] = a[k];
      }
      if (lane == 0) wflag[warp] = flags;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CM; ++k) pre[k] = carry_s[r][k];
#pragma unroll
      for (int w = 0; w < G - 1; ++w) {
        if (w < warp) {
          const bool fw = (wflag[w] & cbits) != 0;
#pragma unroll
          for (int k = 0; k < CM; ++k) pre[k] = fw ? wsum[w][r][k] : pre[k] + wsum[w][r][k];
        }
      }
    }
    float out[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int ch = k % CM;
      const float in = e_starts ? e[ch] : (lane >= P ? pre[ch] + e[ch] : pre[ch]);
      out[k] = after[k] || first_row ? loc[k] : in + loc[k];
    }
    if (q < q_end) {
      if (f0 >= start && f0 + F - 1 < end) {
        reinterpret_cast<float4*>(y)[q] = make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k)
          if (f0 + k >= start && f0 + k < end) y[f0 + k] = out[k];
      }
    }
    if (q0 + 32 * G < q_end) {  // a ray goes on in the next pass: carry the last lanes' sums
      float next[CM];
#pragma unroll
      for (int k = 0; k < CM; ++k) next[k] = seg >= 0 ? a[k] : pre[k] + a[k];
      if constexpr (G == 1) {
#pragma unroll
        for (int k = 0; k < CM; ++k) carry[k] = __shfl_sync(FULL, next[k], 32 - P + r);
      } else {
        __syncthreads();
        if (warp == G - 1 && lane >= 32 - P) {
#pragma unroll
          for (int k = 0; k < CM; ++k) carry_s[r][k] = next[k];
        }
      }
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

// 4 samples a thread, one float4; the last n % 4 go to the thread after
// the last whole float4, one at a time.
template <typename I, bool TAIL>
__global__ void __launch_bounds__(256) masked_dists_kernel(const float* __restrict__ z,
                                                           float* __restrict__ d, I n, int S,
                                                           Divider ds) {
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;  // this thread's float4
  const int lane = threadIdx.x & 31;
  const I n4 = n / 4, f0 = 4 * i;
  // z[f0 + 4], where the next lane does not hold it: the warp's last lane
  // and the last whole float4 load it, with their float4
  const bool own = (lane == 31 || i + 1 == n4) && f0 + 4 < n;
  const float next_own = own ? __ldg(z + f0 + 4) : 0.f;
  const float4 t = i < n4 ? __ldg(reinterpret_cast<const float4*>(z) + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  const float shuffled = __shfl_down_sync(FULL, t.x, 1);  // the next lane's first
  const float v[5] = {t.x, t.y, t.z, t.w, own ? next_own : shuffled};
  if (i < n4) {
    int p = (int)rem(f0, (I)S, ds);  // z[f0]'s sample in its ray
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = p == S - 1 ? 0.f : v[k + 1] - v[k];
      p = p + 1 == S ? 0 : p + 1;
    }
    reinterpret_cast<float4*>(d)[i] = make_float4(o[0], o[1], o[2], o[3]);
  } else if (TAIL && i == n4) {
    int p = (int)rem(f0, (I)S, ds);
    for (I f = f0; f < n; ++f) {
      d[f] = p == S - 1 ? 0.f : __ldg(z + f + 1) - __ldg(z + f);
      p = p + 1 == S ? 0 : p + 1;
    }
  }
}

int blocks(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

template <typename I, int G>
int excl_cumsum_vec_launch(const float* x, float* y, long long T, int S, int c,
                           int rays_per_block, Divider dl, cudaStream_t st) {
  const I n = (I)T * S * c, L = (I)S * c;
  const long long groups = (T + rays_per_block - 1) / rays_per_block;
  const int grid = (int)((groups + CS_WARPS / G - 1) / (CS_WARPS / G));
  switch (c) {
#define LUSH_CUMSUM_CASE(C)                                                           \
  case C:                                                                             \
    excl_cumsum_vec_kernel<I, C, G><<<grid, 32 * CS_WARPS, 0, st>>>(x, y, n, L, dl,   \
                                                                    rays_per_block);  \
    break;
    LUSH_CUMSUM_CASE(1)
    LUSH_CUMSUM_CASE(2)
    LUSH_CUMSUM_CASE(4)
    LUSH_CUMSUM_CASE(8)
    LUSH_CUMSUM_CASE(16)
    LUSH_CUMSUM_CASE(32)
    LUSH_CUMSUM_CASE(64)
    LUSH_CUMSUM_CASE(128)
#undef LUSH_CUMSUM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename I>
int excl_cumsum_launch(const float* x, float* y, long long T, int S, int c, int group,
                       int rays_per_block, Divider dl, cudaStream_t st) {
  if (rays_per_block <= 0) {
    excl_cumsum_kernel<I><<<blocks(T * 32, 256), 256, 0, st>>>(x, y, (I)T, S, c);
    return (int)cudaGetLastError();
  }
  if (group == 1) return excl_cumsum_vec_launch<I, 1>(x, y, T, S, c, rays_per_block, dl, st);
  if (group == CS_WARPS)
    return excl_cumsum_vec_launch<I, CS_WARPS>(x, y, T, S, c, rays_per_block, dl, st);
  return (int)cudaErrorInvalidValue;
}

template <typename I>
int masked_dists_launch(const float* z, float* d, long long n, int S, Divider ds,
                        cudaStream_t st) {
  const int grid = blocks(n / 4 + (n % 4 > 0), 256);
  if (n % 4)
    masked_dists_kernel<I, true><<<grid, 256, 0, st>>>(z, d, (I)n, S, ds);
  else
    masked_dists_kernel<I, false><<<grid, 256, 0, st>>>(z, d, (I)n, S, ds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches its kernel on `stream` and returns cudaGetLastError()
// (0 = OK).  Arrays are contiguous float32, 16-byte aligned; T, S, c, SI,
// n > 0.  index64 != 0 takes the kernels' 64-bit index arithmetic.

// The argument lists below, as a number, for a tool that loads another
// checkout's build (a build without this function takes the earlier
// ones: no rays_per_block or index64).
int raymajor_abi(void) { return 2; }

// rays_per_block > 0: the vector kernel (c a power of two up to 128) in
// groups of `group` warps (1 or 8, the block), each taking rays_per_block
// rays; 0: the general kernel.  (div_m, div_s) divide by S * c
// (`divider`).
int raymajor_excl_cumsum(const float* x, float* y, int T, int S, int c, int group,
                         int rays_per_block, unsigned div_m, int div_s, int index64,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Divider dl{div_m, div_s};
  return index64 ? excl_cumsum_launch<long long>(x, y, T, S, c, group, rays_per_block, dl, st)
                 : excl_cumsum_launch<int>(x, y, T, S, c, group, rays_per_block, dl, st);
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

// (div_m, div_s) divide by S.
int raymajor_masked_dists(const float* z, float* d, long long n, int S, unsigned div_m,
                          int div_s, int index64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Divider ds{div_m, div_s};
  return index64 ? masked_dists_launch<long long>(z, d, n, S, ds, st)
                 : masked_dists_launch<int>(z, d, n, S, ds, st);
}

const char* raymajor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
