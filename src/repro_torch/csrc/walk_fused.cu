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
// word is ranked once, from registers.  Both entries run a persistent grid
// (as many blocks as are resident at once): a tile's first walker is its
// own index, and each time a walker stops the tile takes the next from a
// shared count (one atomicAdd), so tiles whose walkers stop early or cross
// light rows take more, and the tail is one walker long.  A uniform pick
// (simple) needs one degree and one neighbour word a step, so a walker
// there is one thread.  A step's uniforms are hashed one column a lane,
// the next step's while this step's row loads are in flight, and shuffled
// to the tile.  The PPR coin is u5.  Path column t+1 is written straight
// to the (B, L+1) output.  Uniforms are the counter hash uniforms_at(seed,
// b, t) in uint32 arithmetic, or fed (L, B, ucols) floats.
//
// Segment entry (kSegment, walk_segment_launch): walker b enters at step
// t0[b] (start vertex at column t0, earlier columns -1; t0 < 0, t0 > L or
// a negative start is a free slot and writes only -1), hashes with wid[b]
// in place of b (the relay's slot -> walker id map), and stops when it
// samples a remote neighbour, encoded -(g + 2) in nbr: it writes (g, t + 1)
// to frontier[b] (-1, -1 otherwise).  The TPU kernel walks every lane in
// lockstep and wakes a walker at step t0.  A relay launch is a different
// shape from a whole walk: 98,304 slots a shard on the smoke's relay,
// mostly free or leaving the shard within a few steps.  So the entry is
// two kernels.  segment_prep_kernel gives each warp 32 slots: one ballot
// finds the live ones and one atomicAdd a warp appends them to a list;
// the grid writes the flat (B, L+1) path block all -1 with coalesced
// 16-byte streaming stores (evict first, so that the walkers' rows stay in
// L2), grid-stride, and the (-1, -1) frontier pairs.  Its counters need no
// memset: the walk kernel's last block leaves them zero.  The walk kernel
// then hands only the live slots to tiles (kSegTile lanes biased, a thread
// simple) on the persistent grid, through the same atomic count as the
// whole walk; a walker keeps its own slot, wid and t0 and writes only its
// start at column t0, the columns it steps into and its frontier record.
// So a free slot costs no tile and no instruction of the walk.  The first
// live slots go a warp's worth to each block's first warp, then its
// second, so the few live slots of a late round spread over every SM; and
// the walk kernel is a programmatic dependent launch of the prep kernel
// (its blocks start as the prep drains and wait for the list with
// griddepcontrol.wait).  The biased width (8 lanes, 2 blocks an SM) is the
// faster of 8 and 16 lanes on tools/walk_ab.py's relay-shaped launches
// (PERF.md).
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
constexpr int kSegTile = 8;         // lanes a walker of a biased segment
constexpr int kSegMinBlocks = 2;    // its __launch_bounds__ blocks per SM

// Resident blocks per SM that ptxas must allow for an instantiation.
constexpr int min_blocks(bool segment, int T) {
  return segment && T > 1 ? kSegMinBlocks : 1;
}

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

// T lanes a walker: kTile (kSegTile in a segment), or 1 for the uniform
// pick.  work: the whole walk's work[0] counts the walkers handed out past
// the tiles' first ones; a segment's work[0] is the live-slot count,
// work[1] that count of handed-out walkers, work[2] the blocks done and
// work[3..] the live slots (segment_prep_kernel); the last block out sets
// the three counters back to zero for the next launch.
template <bool kSegment, int T>
__global__ void __launch_bounds__(kThreads, min_blocks(kSegment, T))
walk_fused_kernel(const float* __restrict__ prob, const int* __restrict__ alias,
                  const int* __restrict__ bias, const int* __restrict__ nbr,
                  const int* __restrict__ deg, const float* __restrict__ frac,
                  const int* __restrict__ starts, const int* __restrict__ t0s,
                  const int* __restrict__ wids, const float* __restrict__ u,
                  int* __restrict__ path, int* __restrict__ frontier,
                  int* __restrict__ work, int B, int V, int C, int Kin, int L,
                  int base_log2, float stop_prob, int has_frac, int ucols,
                  uint32_t seed) {
  const Tile<T> tl(threadIdx.x & (walk_sample::kWarp - 1));
  const int l = tl.l;
  const unsigned tmask = T == 32 ? kFull : ((1u << T) - 1u) << tl.base;
  const int tiles = static_cast<int>(gridDim.x * blockDim.x / T);
  if constexpr (kSegment)          // segment_prep_kernel's list is complete
    asm volatile("griddepcontrol.wait;" ::: "memory");
  const int n = kSegment ? work[0] : B;          // walkers to hand out
  int* taken = kSegment ? work + 1 : work;
  // the tile's first walker: in a segment, warp w of block k takes the
  // 32 / T consecutive entries from (w * gridDim + k) * 32 / T, so the few
  // live slots of a late round spread over every SM, and a warp's tiles
  // (or a simple warp's lanes) read neighbouring slots
  int idx = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / T);
  if constexpr (kSegment) {
    const int w = static_cast<int>(threadIdx.x) / walk_sample::kWarp;
    const int sub = (static_cast<int>(threadIdx.x) % walk_sample::kWarp) / T;
    idx = (w * static_cast<int>(gridDim.x) + static_cast<int>(blockIdx.x)) *
              (walk_sample::kWarp / T) + sub;
  }
  int b = 0;
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
  // The tile's next walker with a step to take (its first is number
  // `tile`, the rest come from the shared count, so a tile that finishes
  // early takes more): sets (b, out, t, cur, h_w, mine) and writes the
  // start; active false when no walker is left.  A whole walk writes, on
  // a stop, the columns it never steps into; a segment's -1 row was
  // written by segment_prep_kernel.
  auto next_walker = [&]() {
    active = false;
    for (;;) {
      if (!first) {
        int nb = 0;
        if (l == 0) nb = tiles + atomicAdd(taken, 1);
        idx = T == 1 ? nb : __shfl_sync(tmask, nb, tl.base);
      }
      first = false;
      if (idx >= n) return;
      b = kSegment ? work[3 + idx] : idx;
      out = path + static_cast<size_t>(b) * (L + 1);
      const int start = starts[b];
      t = 0;
      uint32_t key = static_cast<uint32_t>(b);
      if (kSegment) {                 // a live slot: start >= 0, 0 <= t0 <= L
        t = t0s[b];
        key = static_cast<uint32_t>(wids[b]);
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
      pk = walk_sample::sample_tile<T>(
          tl, active, safe, prob, alias, bias, nbr, frac, deg, C, Kin,
          base_log2, has_frac != 0, uu[0], uu[1], uu[2], uu[3], uu[4], ahead,
          d);
    }
    if (active) {
      const int nxt = pk.nxt;
      bool alive = d > 0;
      if (stop_prob > 0.0f) alive = alive && uu[5] >= stop_prob;
      if (kSegment) {
        // the row is -1 already; a remote neighbour -(g + 2) ends the
        // segment with a frontier record
        if (l == 0 && alive) {
          if (nxt >= 0) {
            out[t + 1] = nxt;
          } else if (nxt <= -2) {
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
      else if (!kSegment) for (int c = t + 1 + l; c <= L; c += T) out[c] = -1;
      if (!alive || t >= L) next_walker();
    }
  }
  if constexpr (kSegment) {
    __syncthreads();
    if (threadIdx.x == 0 &&
        atomicAdd(work + 2, 1) == static_cast<int>(gridDim.x) - 1) {
      work[0] = 0;
      work[1] = 0;
      work[2] = 0;
    }
  }
}

// A segment's 32 slots a warp: the live ones (start >= 0, 0 <= t0 <= L)
// appended to work[3..] with one atomicAdd on work[0] and the slots'
// frontier pairs (-1, -1); and the whole flat (B, L+1) path block set to
// -1 in 16-byte streaming stores (evict first, so that the walkers' rows
// stay in L2), grid-stride, so that the grid's stores at any moment fall
// in one window of the block.  Its counters need no memset: the walk
// kernel's last block leaves them zero.
__global__ void __launch_bounds__(kThreads)
segment_prep_kernel(const int* __restrict__ starts, const int* __restrict__ t0s,
                    int* __restrict__ path, int* __restrict__ frontier,
                    int* __restrict__ work, int B, int L) {
  // the walk kernel may start now: it waits for this grid to complete
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t threads = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t count = static_cast<size_t>(B) * (L + 1);
  const int4 fill = make_int4(-1, -1, -1, -1);
  for (size_t i = 4 * tid; i + 3 < count; i += 4 * threads)
    __stcs(reinterpret_cast<int4*>(path + i), fill);
  if (tid < (count & 3)) path[(count & ~size_t{3}) + tid] = -1;
  const int lane = threadIdx.x & (walk_sample::kWarp - 1);
  const int b0 = static_cast<int>(tid / walk_sample::kWarp) * walk_sample::kWarp;
  if (b0 >= B) return;
  const int b = b0 + lane;
  bool live = false;
  if (b < B) {
    const int t0 = t0s[b];
    live = starts[b] >= 0 && t0 >= 0 && t0 <= L;
    *reinterpret_cast<int2*>(frontier + 2 * static_cast<size_t>(b)) = make_int2(-1, -1);
  }
  const unsigned m = __ballot_sync(kFull, live);
  int base = 0;
  if (lane == 0 && m != 0u) base = atomicAdd(work, __popc(m));
  base = __shfl_sync(kFull, base, 0);
  if (live) work[3 + base + __popc(m & ((1u << lane) - 1u))] = b;
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

// A persistent grid: as many blocks as are resident at once, or fewer
// when B walkers need fewer.  A segment's walk kernel is launched as a
// programmatic dependent of segment_prep_kernel, so its blocks start while
// the prep kernel drains and wait (griddepcontrol.wait) for its list.
template <bool kSegment, int T>
cudaError_t launch_tiles(const float* prob, const int* alias, const int* bias,
                         const int* nbr, const int* deg, const float* frac,
                         const int* starts, const int* t0s, const int* wids,
                         const float* u, int* path, int* frontier, int* work,
                         int B, int V, int C, int Kin, int L, int base_log2,
                         float stop_prob, int has_frac, int ucols,
                         uint32_t seed, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (static_cast<long long>(B) * T + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * blocks_per_sm<kSegment, T>();
  const unsigned blocks = static_cast<unsigned>(need < most ? need : most);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks > 0 ? blocks : 1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kSegment ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, walk_fused_kernel<kSegment, T>, prob, alias,
                            bias, nbr, deg, frac, starts, t0s, wids, u, path,
                            frontier, work, B, V, C, Kin, L, base_log2,
                            stop_prob, has_frac, ucols, seed);
}

template <bool kSegment>
int launch(const float* prob, const int* alias, const int* bias,
           const int* nbr, const int* deg, const float* frac,
           const int* starts, const int* t0s, const int* wids, const float* u,
           int* path, int* frontier, int* work, int B, int V, int C, int Kin,
           int L, int base_log2, float stop_prob, int uniform, int has_frac,
           int ucols, int seed, cudaStream_t stream) {
  if (B > 0) {
    const uint32_t s = static_cast<uint32_t>(seed);
    if (kSegment) {
      const unsigned warps = (static_cast<unsigned>(B) + walk_sample::kWarp - 1) /
                             walk_sample::kWarp;
      segment_prep_kernel<<<(warps * walk_sample::kWarp + kThreads - 1) / kThreads,
                            kThreads, 0, stream>>>(starts, t0s, path, frontier,
                                                   work, B, L);
    }
    constexpr int kBiased = kSegment ? kSegTile : kTile;
    cudaError_t e;
    if (uniform)
      e = launch_tiles<kSegment, 1>(prob, alias, bias, nbr, deg, frac, starts,
                                    t0s, wids, u, path, frontier, work, B, V, C,
                                    Kin, L, base_log2, stop_prob, has_frac,
                                    ucols, s, stream);
    else
      e = launch_tiles<kSegment, kBiased>(prob, alias, bias, nbr, deg, frac,
                                          starts, t0s, wids, u, path, frontier,
                                          work, B, V, C, Kin, L, base_log2,
                                          stop_prob, has_frac, ucols, s,
                                          stream);
    if (e != cudaSuccess) return static_cast<int>(e);
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

// Segment entry: t0 (B,), wid (B,) int32 in; frontier (B, 2) int32 out;
// work (B + 3,) int32 scratch whose first three entries (the live-slot
// count, the count of walkers handed out, the blocks done) are zero at the
// launch and are left zero by it, then the live slots.
extern "C" int walk_segment_launch(const float* prob, const int* alias,
                                   const int* bias, const int* nbr,
                                   const int* deg, const float* frac,
                                   const int* starts, const int* t0,
                                   const int* wid, const float* u, int* path,
                                   int* frontier, int* work, int B, int V,
                                   int C, int Kin, int L, int base_log2,
                                   float stop_prob, int uniform, int has_frac,
                                   int ucols, int seed, cudaStream_t stream) {
  return launch<true>(prob, alias, bias, nbr, deg, frac, starts, t0, wid, u,
                      path, frontier, work, B, V, C, Kin, L, base_log2,
                      stop_prob, uniform, has_frac, ucols, seed, stream);
}

// Blocks of 256 threads resident on each SM, per entry (segment 0/1) and
// pick (uniform 0/1): what the persistent grids are sized by.
extern "C" int walk_fused_occupancy(int segment, int uniform) {
  if (segment)
    return uniform ? blocks_per_sm<true, 1>() : blocks_per_sm<true, kSegTile>();
  return uniform ? blocks_per_sm<false, 1>() : blocks_per_sm<false, kTile>();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
