// Whole-walk Bingo kernel for Hopper (sm_90a): B walks of L steps, one launch,
// and its segment entry, the per-round kernel of the walker relay.
//
// Replaces the TPU kernel repro/kernels/walk_fused.py:walk_fused_pallas, both
// entries (whole walks, and segment=True), its _kernel and the in-register
// sampler repro/kernels/walk_sample.py:sample_rows / uniform_pick.  Plain
// versions: repro_torch/kernels/walk_fused.py:walk_fused_ref and
// walk_segment_ref, which this kernel equals bit for bit.
//
// Design: a walker is walked by a tile of 8 lanes (four walkers a warp),
// the L-step loop inside the kernel, with the shared sampler of
// walk_sample.cuh: the degree, the alias entry and the first 32 slots of
// the bias and nbr rows load together as soon as the row is known, the rest
// of a row of up to 256 slots at once when the degree is, and each bias
// word is ranked once, from registers.  The whole walk runs a persistent
// grid (as many blocks as are resident at once): a tile's first walker is
// its own index, and each time a walker stops the tile takes the next from
// a shared count (`taken`, one atomicAdd), so tiles whose walkers stop
// early or cross light rows take more, and the tail is one walker long.
// Its uniform pick (simple) needs one degree and one neighbour word a
// step, so a walker there is one thread.  The segment entry runs a tile a
// slot.  A step's uniforms are hashed one column a lane, the next step's
// while this step's row loads are in flight, and shuffled to the tile.
// The PPR coin is u5.  Path column t+1 is written straight to the (B, L+1)
// output.  Uniforms are the counter hash uniforms_at(seed, b, t) in uint32
// arithmetic, or fed (L, B, ucols) floats.
//
// Segment entry (kSegment, walk_segment_launch): walker b enters at step
// t0[b] (start vertex at column t0, earlier columns -1; t0 > L or a
// negative start is a free slot and writes only -1), hashes with wid[b] in
// place of b (the relay's slot -> walker id map), and stops when it samples
// a remote neighbour, encoded -(g + 2) in nbr: it writes (g, t + 1) to
// frontier[b] (-1, -1 otherwise).  The TPU kernel walks every lane in
// lockstep and wakes a walker at step t0; here a tile starts the walker's
// loop at t0.
//
// Bound on this card: a step reads deg[cur], one prob and one alias entry,
// the bias row (deg words, two integer ops each to find the group's members)
// and the picked nbr word.  Counted with each word read once over the rows
// a batch touches, the work is a small fraction of what the steps read,
// because many walkers cross the same hub rows; at the main path's size it
// is bound by those integer ops (chip_smoke.py computes it per run).  What
// the steps do read is about 134 bias words each on the main path (hub
// rows carry most steps), mostly from L2, behind a chain of dependent loads
// (the row -> its degree -> the rest of the row -> the next row).  The
// sampler cuts that chain to one round trip for a row of at most 32 slots
// and two for a row of up to 256, reads each bias word once, and the
// tiles put four walkers in each warp to cover the rest.
//
// Exactness: see walk_sample.cuh; the hash is uint32 arithmetic.  Built with
// -fmad=false so no multiply-add is contracted.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_sample.cuh"

namespace {

using walk_sample::kFull;
using walk_sample::kTile;
using walk_sample::Tile;
constexpr int kThreads = walk_sample::kBlock;

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

// T lanes a walker: kTile, or 1 for the whole walk's uniform pick.
template <bool kSegment, int T>
__global__ void __launch_bounds__(kThreads)
walk_fused_kernel(const float* __restrict__ prob, const int* __restrict__ alias,
                  const int* __restrict__ bias, const int* __restrict__ nbr,
                  const int* __restrict__ deg, const float* __restrict__ frac,
                  const int* __restrict__ starts, const int* __restrict__ t0s,
                  const int* __restrict__ wids, const float* __restrict__ u,
                  int* __restrict__ path, int* __restrict__ frontier,
                  int* __restrict__ taken, int B, int V, int C, int Kin, int L,
                  int base_log2, float stop_prob, int uniform, int has_frac,
                  int ucols, uint32_t seed) {
  const Tile<T> tl(threadIdx.x & (walk_sample::kWarp - 1));
  const int l = tl.l;
  const unsigned tmask = T == 32 ? kFull : ((1u << T) - 1u) << tl.base;
  const int tiles = static_cast<int>(gridDim.x * blockDim.x / T);
  int b = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / T);
  bool first = true;
  int* out = path;
  int t = 0, cur = 0;
  uint32_t h_w = 0;
  bool active = false;
  float mine = 0.0f;        // this lane's uniform column of the next step

  // Column c = min(lane, 5) of walker b's uniforms at step tt.
  auto column = [&](int tt) {
    const int c = l < 6 ? l : 0;
    if (ucols > 0) return u[(static_cast<size_t>(tt) * B + b) * ucols + c];
    return hash_uniform(fmix32(h_w ^ (static_cast<uint32_t>(tt) * 0x7FEB352Du)), c);
  };
  // The tile's next walker with a step to take (its first is walker
  // `tile`, the rest come from the shared count `taken`, so a tile that
  // finishes early takes more): fills the columns the walker never steps
  // into and sets (b, out, t, cur, h_w, mine); active false when no walker
  // is left.
  auto next_walker = [&]() {
    active = false;
    for (;;) {
      if (!first) {
        if (kSegment) return;               // a tile a slot: no second
        int nb = 0;
        if (l == 0) nb = tiles + atomicAdd(taken, 1);
        b = T == 1 ? nb : __shfl_sync(tmask, nb, tl.base);
      }
      first = false;
      if (b >= B) return;
      out = path + static_cast<size_t>(b) * (L + 1);
      const int start = starts[b];
      t = 0;
      uint32_t key = static_cast<uint32_t>(b);
      if (kSegment) {
        const int t0 = t0s[b];
        key = static_cast<uint32_t>(wids[b]);
        if (l == 0) {
          frontier[2 * b] = -1;
          frontier[2 * b + 1] = -1;
        }
        if (start < 0 || t0 < 0 || t0 > L) {   // free slot: nothing to walk
          for (int c = l; c <= L; c += T) out[c] = -1;
          continue;
        }
        for (int c = l; c < t0; c += T) out[c] = -1;
        t = t0;
      }
      if (l == 0) out[t] = start;
      if (t >= L) continue;
      cur = start;
      h_w = fmix32(seed ^ (key * 0x9E3779B1u));
      if (T > 1) mine = column(t);
      active = true;
      return;
    }
  };
  next_walker();

  while (__any_sync(kFull, active)) {
    // this step's uniforms: lane c of the tile drew column c, shared here
    float uu[6];
    const long long safe = min(max(cur, 0), V - 1);
    int d = 0;
    walk_sample::Pick pk;
    if constexpr (T == 1) {
      const float* ut = u + (static_cast<size_t>(t) * B + b) * ucols;
      const uint32_t h_wt = fmix32(h_w ^ (static_cast<uint32_t>(t) * 0x7FEB352Du));
#pragma unroll
      for (int c = 0; c < 6; ++c)
        uu[c] = (c != 2 && c != 5) ? 0.0f
              : !active ? 0.0f : ucols > 0 ? ut[c] : hash_uniform(h_wt, c);
      if (active) d = deg[safe];
      pk = walk_sample::uniform_row(nbr + safe * C, active ? d : 0, uu[2]);
    } else {
#pragma unroll
      for (int j = 0; j < 6; ++j) uu[j] = tl.bcast(mine, j);
      // the next step's column is drawn while this step's row loads fly
      auto ahead = [&] { if (active && t + 1 < L) mine = column(t + 1); };
      if (uniform) {
        if (active) d = deg[safe];
        ahead();
        pk = walk_sample::uniform_row(nbr + safe * C, d, uu[2]);
      } else {
        pk = walk_sample::sample_tile<T>(
            tl, active, safe, prob, alias, bias, nbr, frac, deg, C, Kin,
            base_log2, has_frac != 0, uu[0], uu[1], uu[2], uu[3], uu[4], ahead,
            d);
      }
    }
    if (active) {
      const int nxt = pk.nxt;
      bool alive = d > 0;
      if (stop_prob > 0.0f) alive = alive && uu[5] >= stop_prob;
      if (kSegment) {
        // a remote neighbour -(g + 2) ends the segment with a frontier record
        if (l == 0) {
          out[t + 1] = alive && nxt >= 0 ? nxt : -1;
          if (alive && nxt <= -2) {
            frontier[2 * b] = -nxt - 2;
            frontier[2 * b + 1] = t + 1;
          }
        }
      } else {
        if (l == 0) out[t + 1] = alive ? nxt : -1;
      }
      alive = alive && nxt >= 0;
      ++t;
      if (alive) cur = nxt;
      else for (int c = t + 1 + l; c <= L; c += T) out[c] = -1;
      if (!alive || t >= L) next_walker();
    }
  }
}

// Blocks of one instantiation resident on each SM (asked once a process).
template <bool kSegment, int T>
int blocks_per_sm() {
  static const int n = [] {
    int m = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &m, walk_fused_kernel<kSegment, T>, kThreads, 0);
    return m;
  }();
  return n;
}

// The whole walk runs a persistent grid (walkers handed out through
// taken); the segment entry a tile a slot, since a relay round's slots are
// mostly free or cross to another shard within a few steps: neither one
// atomicAdd a slot nor a fixed stride over the slots on a persistent grid
// made the relay's launches faster (PERF.md).
template <bool kSegment, int T>
void launch_tiles(const float* prob, const int* alias, const int* bias,
                  const int* nbr, const int* deg, const float* frac,
                  const int* starts, const int* t0s, const int* wids,
                  const float* u, int* path, int* frontier, int* taken, int B,
                  int V, int C, int Kin, int L, int base_log2, float stop_prob,
                  int uniform, int has_frac, int ucols, uint32_t seed,
                  cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (static_cast<long long>(B) * T + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * blocks_per_sm<kSegment, T>();
  const unsigned blocks = static_cast<unsigned>(kSegment || need < most ? need : most);
  walk_fused_kernel<kSegment, T><<<blocks > 0 ? blocks : 1, kThreads, 0, stream>>>(
      prob, alias, bias, nbr, deg, frac, starts, t0s, wids, u, path, frontier,
      taken, B, V, C, Kin, L, base_log2, stop_prob, uniform, has_frac, ucols,
      seed);
}

template <bool kSegment>
int launch(const float* prob, const int* alias, const int* bias,
           const int* nbr, const int* deg, const float* frac,
           const int* starts, const int* t0s, const int* wids, const float* u,
           int* path, int* frontier, int* taken, int B, int V, int C, int Kin,
           int L, int base_log2, float stop_prob, int uniform, int has_frac,
           int ucols, int seed, cudaStream_t stream) {
  if (B > 0) {
    const uint32_t s = static_cast<uint32_t>(seed);
    if (uniform && !kSegment)
      launch_tiles<false, 1>(prob, alias, bias, nbr, deg, frac, starts, t0s,
                             wids, u, path, frontier, taken, B, V, C, Kin, L,
                             base_log2, stop_prob, 1, has_frac, ucols, s,
                             stream);
    else
      launch_tiles<kSegment, kTile>(prob, alias, bias, nbr, deg, frac,
                                    starts, t0s, wids, u, path, frontier,
                                    taken, B, V, C, Kin, L, base_log2,
                                    stop_prob, uniform, has_frac, ucols, s,
                                    stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taken: one int32, zero at the launch (the count of walkers handed out
// past the tiles' first ones).
extern "C" int walk_fused_launch(const float* prob, const int* alias,
                                 const int* bias, const int* nbr,
                                 const int* deg, const float* frac,
                                 const int* starts, const float* u, int* path,
                                 int* taken, int B, int V, int C, int Kin,
                                 int L, int base_log2, float stop_prob,
                                 int uniform, int has_frac, int ucols,
                                 int seed, cudaStream_t stream) {
  return launch<false>(prob, alias, bias, nbr, deg, frac, starts, nullptr,
                       nullptr, u, path, nullptr, taken, B, V, C, Kin, L,
                       base_log2, stop_prob, uniform, has_frac, ucols, seed,
                       stream);
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
                      path, frontier, nullptr, B, V, C, Kin, L, base_log2,
                      stop_prob, uniform, has_frac, ucols, seed, stream);
}

// Blocks of 256 threads resident on each SM, per entry (segment 0/1) and
// pick (uniform 0/1): what the whole walk sizes its persistent grid by.
extern "C" int walk_fused_occupancy(int segment, int uniform) {
  if (segment) return blocks_per_sm<true, kTile>();
  return uniform ? blocks_per_sm<false, 1>() : blocks_per_sm<false, kTile>();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
