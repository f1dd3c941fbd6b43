// Whole-walk Bingo kernel for Hopper (sm_90a): B walks of L steps, one launch.
//
// Replaces the TPU kernel repro/kernels/walk_fused.py:walk_fused_pallas
// (whole-walk entry, its _kernel and the in-register sampler
// repro/kernels/walk_sample.py:sample_rows / uniform_pick).  Plain version:
// repro_torch/kernels/walk_fused.py:walk_fused_ref, which this kernel equals
// bit for bit.
//
// Design: one warp per walker, the L-step loop inside the kernel.  Per step
// the warp reads deg[cur], does the alias pick over the Kin inter-group
// lanes, computes the chosen group's digits of bias[cur, 0:deg] in 32-lane
// chunks, counts members with __ballot_sync/__popc, and picks the
// ceil(u2*|G|)-th member from the popc prefix counts.  Bases > 2 add the
// digit acceptance coin and an exact integer-prefix ITS; the fp decimal
// group runs the ITS over frac sequentially in one lane (left to right, the
// order the plain version spells out; the decimal group carries mass < 1/lambda
// and is off the hot path).  The PPR coin is u5.  Path column t+1 is written
// straight to the (B, L+1) output.  Uniforms are the counter hash
// uniforms_at(seed, b, t) in uint32 arithmetic, or fed (L, B, ucols) floats.
//
// Bound on this card: a step reads deg[cur], one prob and one alias entry,
// the bias row (deg words, two integer ops each to find the group's members)
// and the picked nbr word.  Counted with each word read once over the rows
// a batch touches, the work is a small fraction of what the steps read,
// because many walkers cross the same hub rows; at the main path's size it
// is bound by those integer ops (chip_smoke.py computes it per run).  This
// first kernel reads rows straight from global memory with no prefetch:
// each step is a chain of dependent loads (deg -> prob/alias -> bias ->
// nbr), so it is latency bound and relies on many resident warps (one per
// walker) to cover the latency.  Row prefetch (cp.async/TMA) and
// cohort-style overlap are later work.
//
// Exactness: every float is an exact integer or a single IEEE rounding
// (u0*Kin, u2*gsize, u*deg, x01*total, u3*(B-1)); the integer ITS compares
// exact integer prefix sums; the fp ITS adds in lane order.  Built with
// -fmad=false so no multiply-add is contracted.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// uniforms_at(seed, wid, t), column c: float32 in [0, 1).
__device__ __forceinline__ float hash_uniform(uint32_t h_wt, int c) {
  uint32_t h = fmix32(h_wt ^ (static_cast<uint32_t>(c) * 0x846CA68Bu));
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ unsigned lanemask_le(int lane) {
  return 0xFFFFFFFFu >> (31 - lane);
}

// Inclusive warp prefix sum.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int digit_of(const int* brow, int s, int d,
                                        int shift, int dmask) {
  return s < d ? (brow[s] >> shift) & dmask : 0;
}

__global__ void __launch_bounds__(kThreads)
walk_fused_kernel(const float* __restrict__ prob, const int* __restrict__ alias,
                  const int* __restrict__ bias, const int* __restrict__ nbr,
                  const int* __restrict__ deg, const float* __restrict__ frac,
                  const int* __restrict__ starts, const float* __restrict__ u,
                  int* __restrict__ path, int B, int V, int C, int Kin, int L,
                  int base_log2, float stop_prob, int uniform, int has_frac,
                  int ucols, uint32_t seed) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long wglobal =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (wglobal >= B) return;
  const int b = static_cast<int>(wglobal);
  int* out = path + static_cast<size_t>(b) * (L + 1);
  const int start = starts[b];
  if (lane == 0) out[0] = start;

  const int dmask = (1 << base_log2) - 1;
  const int num_radix = has_frac ? Kin - 1 : Kin;
  const uint32_t h_w = fmix32(seed ^ (static_cast<uint32_t>(b) * 0x9E3779B1u));
  int cur = start;
  bool alive = true;

  for (int t = 0; t < L; ++t) {
    if (!alive) {
      for (int c = t + 1 + lane; c <= L; c += kWarp) out[c] = -1;
      break;
    }
    float uu[6];
    if (ucols > 0) {
      const float* ut = u + (static_cast<size_t>(t) * B + b) * ucols;
#pragma unroll
      for (int c = 0; c < 6; ++c) uu[c] = ut[c];
    } else {
      const uint32_t h_wt = fmix32(h_w ^ (static_cast<uint32_t>(t) * 0x7FEB352Du));
#pragma unroll
      for (int c = 0; c < 6; ++c) uu[c] = hash_uniform(h_wt, c);
    }
    const int safe = min(max(cur, 0), V - 1);
    const size_t row = static_cast<size_t>(safe) * C;
    const int d = deg[safe];
    int nxt = -1;

    if (uniform) {
      if (d > 0) {
        const int slot = min(static_cast<int>(uu[2] * static_cast<float>(d)), d - 1);
        nxt = nbr[row + slot];
      }
    } else {
      // stage (i): alias pick over the Kin lanes
      const int i = min(static_cast<int>(uu[0] * static_cast<float>(Kin)), Kin - 1);
      const size_t krow = static_cast<size_t>(safe) * Kin;
      const float p = prob[krow + i];
      const int a = alias[krow + i];
      const int k = uu[1] < p ? i : a;
      const int kc = min(k, num_radix - 1);
      const bool is_dec = has_frac && k == num_radix;
      bool ok;
      int slot = 0;
      const int* brow = bias + row;
      if (!is_dec) {
        // stage (ii): members of group kc, counted by ballot/popc
        const int shift = kc * base_log2;
        int gsize = 0;
        for (int base = 0; base < d; base += kWarp) {
          const int dig = digit_of(brow, base + lane, d, shift, dmask);
          gsize += __popc(__ballot_sync(0xFFFFFFFFu, dig != 0));
        }
        ok = gsize > 0;
        if (ok) {
          const int target =
              min(static_cast<int>(uu[2] * static_cast<float>(gsize)), gsize - 1) + 1;
          int seen = 0;
          for (int base = 0; base < d; base += kWarp) {
            const int dig = digit_of(brow, base + lane, d, shift, dmask);
            const unsigned m = __ballot_sync(0xFFFFFFFFu, dig != 0);
            const int c = __popc(m);
            if (seen + c >= target) {
              const int want = target - seen;
              const unsigned f = __ballot_sync(
                  0xFFFFFFFFu, dig != 0 && __popc(m & lanemask_le(lane)) == want);
              slot = base + __ffs(f) - 1;
              break;
            }
            seen += c;
          }
          if (base_log2 > 1) {
            // digit-proportional acceptance, exact integer-prefix ITS fallback
            const int dig_c = digit_of(brow, slot, d, shift, dmask);
            const bool accept = uu[3] * static_cast<float>(dmask) <
                                static_cast<float>(dig_c);
            if (!accept) {
              int total = 0;
              for (int base = 0; base < d; base += kWarp) {
                int dig = digit_of(brow, base + lane, d, shift, dmask);
                total += __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(dig));
              }
              const float x = uu[4] * static_cast<float>(total);
              int count = (static_cast<float>(total) <= x) ? C - d : 0;
              int off = 0;
              for (int base = 0; base < d; base += kWarp) {
                const int dig = digit_of(brow, base + lane, d, shift, dmask);
                const int c = off + warp_scan(dig, lane);
                count += __popc(__ballot_sync(
                    0xFFFFFFFFu, base + lane < d && static_cast<float>(c) <= x));
                off = __shfl_sync(0xFFFFFFFFu, c, kWarp - 1);
              }
              slot = min(count, C - 1);
            }
          }
        }
      } else {
        // decimal group: ITS over the frac row, left to right in lane 0
        int sl = 0, okd = 0;
        if (lane == 0) {
          const float* frow = frac + row;
          float total = d > 0 ? frow[0] : 0.0f;
          for (int j = 1; j < d; ++j) total = total + frow[j];
          const float x = uu[4] * total;
          float c = 0.0f;
          int count = 0;
          for (int j = 0; j < d; ++j) {
            c = j == 0 ? frow[0] : c + frow[j];
            count += c <= x;
          }
          if (d == 0) count += (0.0f <= x) ? C : 0;   // c stays 0 on every lane
          else if (total <= x) count += C - d;        // lanes past deg add 0
          sl = min(count, C - 1);
          okd = total > 0.0f;
        }
        slot = __shfl_sync(0xFFFFFFFFu, sl, 0);
        ok = __shfl_sync(0xFFFFFFFFu, okd, 0) != 0;
      }
      if (ok) nxt = nbr[row + slot];
    }

    alive = d > 0;
    if (stop_prob > 0.0f) alive = alive && uu[5] >= stop_prob;
    if (lane == 0) out[t + 1] = alive ? nxt : -1;
    alive = alive && nxt >= 0;
    if (alive) cur = nxt;
  }
}

}  // namespace

extern "C" int walk_fused_launch(const float* prob, const int* alias,
                                 const int* bias, const int* nbr,
                                 const int* deg, const float* frac,
                                 const int* starts, const float* u, int* path,
                                 int B, int V, int C, int Kin, int L,
                                 int base_log2, float stop_prob, int uniform,
                                 int has_frac, int ucols, int seed,
                                 cudaStream_t stream) {
  if (B > 0) {
    const long long threads = static_cast<long long>(B) * kWarp;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    walk_fused_kernel<<<blocks, kThreads, 0, stream>>>(
        prob, alias, bias, nbr, deg, frac, starts, u, path, B, V, C, Kin, L,
        base_log2, stop_prob, uniform, has_frac, ucols,
        static_cast<uint32_t>(seed));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
