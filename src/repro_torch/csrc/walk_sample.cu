// Per-step Bingo sampling kernels for Hopper (sm_90a): one sample per walker.
//
// Replaces the TPU kernels repro/kernels/walk_sample.py:walk_sample_pallas
// (the two-stage sample on gathered rows) and walk_sample_uniform_pallas (the
// degree-based unbiased pick).  Plain versions:
// repro_torch/kernels/walk_sample.py:walk_sample_ref / walk_sample_uniform_ref,
// which these kernels equal bit for bit.
//
// Design: walk_sample_kernel runs the shared sampler of walk_sample.cuh, a
// tile of 8 lanes a walker (four a warp), on a persistent grid: a tile
// samples walkers b = tile, tile + tiles, ..., and loads the next walker's
// row index and uniforms while the current row's first loads (the degree,
// the alias entry, the first 32 slots of bias and nbr) are in flight, so
// the rows[b] link of the chain is off the critical path after the first.
// With rows == nullptr the tables are (B, .) rows gathered by the caller,
// the TPU kernel's signature; with rows they are the full (V, .) state
// tables and walker b reads row rows[b] in place, so no (B, C) gather is
// ever written to device memory (at B = 262,144 and C = 256 each gathered
// int32 table is 256 MiB).  The uniform pick needs one degree word and one
// neighbour word per walker: one thread per walker.
//
// Bound on this card: a sample reads deg[r], one prob and one alias entry,
// the bias row up to deg (two integer ops per word to find the group's
// members) and one nbr word; the uniform pick reads deg[r] and one nbr word.
// Counted with each word read once over the distinct rows a batch touches
// (chip_smoke.py computes it per run), the biased sample is bound by those
// integer ops and the uniform pick by bytes.  What holds a sample back is
// its chain of dependent loads (rows -> deg, alias entry, first 32 bias
// and nbr slots -> the rest of a long row -> nbr past slot 31):
// walk_sample.cuh issues each link's loads together, and the uniform
// pick's chain (rows -> deg -> nbr) is covered by resident warps.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_sample.cuh"

namespace {

using walk_sample::kFull;
using walk_sample::kTile;
using walk_sample::kWarp;
using walk_sample::Tile;
constexpr int kThreads = walk_sample::kBlock;

__global__ void __launch_bounds__(kThreads)
walk_sample_kernel(const float* __restrict__ prob, const int* __restrict__ alias,
                   const int* __restrict__ bias, const int* __restrict__ nbr,
                   const int* __restrict__ deg, const float* __restrict__ frac,
                   const float* __restrict__ u, const int* __restrict__ rows,
                   int* __restrict__ nxt_out, int* __restrict__ slot_out,
                   int B, int C, int Kin, int base_log2, int has_frac,
                   int ucols) {
  const Tile<kTile> tl(threadIdx.x & (kWarp - 1));
  const long long tiles = static_cast<long long>(gridDim.x) * blockDim.x / kTile;
  long long b = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kTile;
  // the walker's row index and uniforms, loaded one walker ahead
  auto fetch = [&](long long w, long long& r, float (&uw)[5]) {
    r = 0;
#pragma unroll
    for (int c = 0; c < 5; ++c) uw[c] = 0.0f;
    if (w < B) {
      r = rows != nullptr ? rows[w] : w;
      const float* ub = u + w * ucols;
#pragma unroll
      for (int c = 0; c < 5; ++c)
        if (c < ucols) uw[c] = ub[c];
    }
  };
  long long r;
  float uw[5];
  fetch(b, r, uw);
  while (__any_sync(kFull, b < B)) {
    long long r_next;
    float u_next[5];
    int d;
    // the next walker's row index and uniforms load with this row's
    const walk_sample::Pick pk = walk_sample::sample_tile<kTile>(
        tl, b < B, r, prob, alias, bias, nbr, frac, deg, C, Kin, base_log2,
        has_frac != 0, uw[0], uw[1], uw[2], uw[3], uw[4],
        [&] { fetch(b + tiles, r_next, u_next); }, d);
    if (b < B && tl.l == 0) {
      nxt_out[b] = pk.nxt;
      slot_out[b] = pk.slot;
    }
    b += tiles;
    r = r_next;
#pragma unroll
    for (int c = 0; c < 5; ++c) uw[c] = u_next[c];
  }
}

int sample_blocks_per_sm() {
  static const int n = [] {
    int m = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m, walk_sample_kernel,
                                                  kThreads, 0);
    return m;
  }();
  return n;
}

__global__ void __launch_bounds__(kThreads)
walk_sample_uniform_kernel(const int* __restrict__ nbr,
                           const int* __restrict__ deg,
                           const float* __restrict__ u,
                           const int* __restrict__ rows,
                           int* __restrict__ nxt_out,
                           int* __restrict__ slot_out, int B, int C,
                           int ucols) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= B) return;
  const int b = static_cast<int>(g);
  const int r = rows != nullptr ? rows[b] : b;
  const walk_sample::Pick pk = walk_sample::uniform_row(
      nbr + static_cast<size_t>(r) * C, deg[r], u[static_cast<size_t>(b) * ucols]);
  nxt_out[b] = pk.nxt;
  slot_out[b] = pk.slot;
}

}  // namespace

extern "C" int walk_sample_launch(const float* prob, const int* alias,
                                  const int* bias, const int* nbr,
                                  const int* deg, const float* frac,
                                  const float* u, const int* rows, int* nxt,
                                  int* slot, int B, int C, int Kin,
                                  int base_log2, int has_frac, int ucols,
                                  cudaStream_t stream) {
  if (B > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long need = (static_cast<long long>(B) * kTile + kThreads - 1) / kThreads;
    const long long most = static_cast<long long>(sms) * sample_blocks_per_sm();
    const unsigned blocks = static_cast<unsigned>(need < most ? need : most);
    walk_sample_kernel<<<blocks > 0 ? blocks : 1, kThreads, 0, stream>>>(
        prob, alias, bias, nbr, deg, frac, u, rows, nxt, slot, B, C, Kin,
        base_log2, has_frac, ucols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int walk_sample_uniform_launch(const int* nbr, const int* deg,
                                          const float* u, const int* rows,
                                          int* nxt, int* slot, int B, int C,
                                          int ucols, cudaStream_t stream) {
  if (B > 0) {
    const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
    walk_sample_uniform_kernel<<<blocks, kThreads, 0, stream>>>(
        nbr, deg, u, rows, nxt, slot, B, C, ucols);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 256 threads of the biased kernel resident on each SM: what the
// launch sizes its persistent grid by.
extern "C" int walk_sample_occupancy() { return sample_blocks_per_sm(); }

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
