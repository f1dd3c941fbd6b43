// Whole-walk Bingo kernel for Hopper (sm_90a): B walks of L steps, one launch,
// and its segment entry, the per-round kernel of the walker relay.
//
// Replaces the TPU kernel repro/kernels/walk_fused.py:walk_fused_pallas, both
// entries (whole walks, and segment=True), its _kernel and the in-register
// sampler repro/kernels/walk_sample.py:sample_rows / uniform_pick.  Plain
// versions: repro_torch/kernels/walk_fused.py:walk_fused_ref and
// walk_segment_ref, which this kernel equals bit for bit.
//
// Design: one warp per walker, the L-step loop inside the kernel.  Per step
// the warp reads deg[cur] and draws from row cur with the shared per-step
// sampler of walk_sample.cuh (alias pick over the Kin inter-group lanes,
// then the ballot/popc member pick over the chosen group's digits of
// bias[cur, 0:deg]; bases > 2 add the digit acceptance coin and an exact
// integer-prefix ITS; the fp decimal group, mass < 1/lambda, runs its ITS
// in one lane, left to right).  The PPR coin is u5.  Path column t+1 is written
// straight to the (B, L+1) output.  Uniforms are the counter hash
// uniforms_at(seed, b, t) in uint32 arithmetic, or fed (L, B, ucols) floats.
//
// Segment entry (kSegment, walk_segment_launch): walker b enters at step
// t0[b] (start vertex at column t0, earlier columns -1; t0 > L or a
// negative start is a free slot and writes only -1), hashes with wid[b] in
// place of b (the relay's slot -> walker id map), and stops when it samples
// a remote neighbour, encoded -(g + 2) in nbr: it writes (g, t + 1) to
// frontier[b] (-1, -1 otherwise).  The TPU kernel walks every lane in
// lockstep and wakes a walker at step t0; with one warp per walker the
// walker's loop simply starts at t0.  The whole-walk instantiation is the
// same code as before the segment entry existed.
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
// Exactness: see walk_sample.cuh; the hash is uint32 arithmetic.  Built with
// -fmad=false so no multiply-add is contracted.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_sample.cuh"

namespace {

using walk_sample::kWarp;
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

template <bool kSegment>
__global__ void __launch_bounds__(kThreads)
walk_fused_kernel(const float* __restrict__ prob, const int* __restrict__ alias,
                  const int* __restrict__ bias, const int* __restrict__ nbr,
                  const int* __restrict__ deg, const float* __restrict__ frac,
                  const int* __restrict__ starts, const int* __restrict__ t0s,
                  const int* __restrict__ wids, const float* __restrict__ u,
                  int* __restrict__ path, int* __restrict__ frontier, int B,
                  int V, int C, int Kin, int L, int base_log2, float stop_prob,
                  int uniform, int has_frac, int ucols, uint32_t seed) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long wglobal =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (wglobal >= B) return;
  const int b = static_cast<int>(wglobal);
  int* out = path + static_cast<size_t>(b) * (L + 1);
  const int start = starts[b];
  int t_begin = 0;
  uint32_t key = static_cast<uint32_t>(b);
  if (kSegment) {
    const int t0 = t0s[b];
    key = static_cast<uint32_t>(wids[b]);
    if (lane == 0) {
      frontier[2 * b] = -1;
      frontier[2 * b + 1] = -1;
    }
    if (start < 0 || t0 < 0 || t0 > L) {   // free slot: nothing to walk
      for (int c = lane; c <= L; c += kWarp) out[c] = -1;
      return;
    }
    for (int c = lane; c < t0; c += kWarp) out[c] = -1;
    t_begin = t0;
  }
  if (lane == 0) out[t_begin] = start;

  const uint32_t h_w = fmix32(seed ^ (key * 0x9E3779B1u));
  int cur = start;
  bool alive = true;

  for (int t = t_begin; t < L; ++t) {
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
    const walk_sample::Pick pk =
        uniform ? walk_sample::uniform_row(nbr + row, d, uu[2])
                : walk_sample::sample_row(
                      prob + static_cast<size_t>(safe) * Kin,
                      alias + static_cast<size_t>(safe) * Kin, bias + row,
                      nbr + row, has_frac ? frac + row : nullptr, d, C, Kin,
                      base_log2, has_frac != 0, uu[0], uu[1], uu[2], uu[3],
                      uu[4], lane);
    const int nxt = pk.nxt;

    alive = d > 0;
    if (stop_prob > 0.0f) alive = alive && uu[5] >= stop_prob;
    if (kSegment) {
      // a remote neighbour -(g + 2) ends the segment with a frontier record
      if (lane == 0) {
        out[t + 1] = alive && nxt >= 0 ? nxt : -1;
        if (alive && nxt <= -2) {
          frontier[2 * b] = -nxt - 2;
          frontier[2 * b + 1] = t + 1;
        }
      }
    } else {
      if (lane == 0) out[t + 1] = alive ? nxt : -1;
    }
    alive = alive && nxt >= 0;
    if (alive) cur = nxt;
  }
}

template <bool kSegment>
int launch(const float* prob, const int* alias, const int* bias,
           const int* nbr, const int* deg, const float* frac,
           const int* starts, const int* t0s, const int* wids, const float* u,
           int* path, int* frontier, int B, int V, int C, int Kin, int L,
           int base_log2, float stop_prob, int uniform, int has_frac,
           int ucols, int seed, cudaStream_t stream) {
  if (B > 0) {
    const long long threads = static_cast<long long>(B) * kWarp;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    walk_fused_kernel<kSegment><<<blocks, kThreads, 0, stream>>>(
        prob, alias, bias, nbr, deg, frac, starts, t0s, wids, u, path,
        frontier, B, V, C, Kin, L, base_log2, stop_prob, uniform, has_frac,
        ucols, static_cast<uint32_t>(seed));
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch<false>(prob, alias, bias, nbr, deg, frac, starts, nullptr,
                       nullptr, u, path, nullptr, B, V, C, Kin, L, base_log2,
                       stop_prob, uniform, has_frac, ucols, seed, stream);
}

// Segment entry: t0 (B,), wid (B,) int32 in; frontier (B, 2) int32 out.
extern "C" int walk_segment_launch(const float* prob, const int* alias,
                                   const int* bias, const int* nbr,
                                   const int* deg, const float* frac,
                                   const int* starts, const int* t0,
                                   const int* wid, const float* u, int* path,
                                   int* frontier, int B, int V, int C, int Kin,
                                   int L, int base_log2, float stop_prob,
                                   int uniform, int has_frac, int ucols,
                                   int seed, cudaStream_t stream) {
  return launch<true>(prob, alias, bias, nbr, deg, frac, starts, t0, wid, u,
                      path, frontier, B, V, C, Kin, L, base_log2, stop_prob,
                      uniform, has_frac, ucols, seed, stream);
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
