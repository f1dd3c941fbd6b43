// Per-step Bingo sampling kernels for Hopper (sm_90a): one sample per walker.
//
// Replaces the TPU kernels repro/kernels/walk_sample.py:walk_sample_pallas
// (the two-stage sample on gathered rows) and walk_sample_uniform_pallas (the
// degree-based unbiased pick).  Plain versions:
// repro_torch/kernels/walk_sample.py:walk_sample_ref / walk_sample_uniform_ref,
// which these kernels equal bit for bit.
//
// Design: walk_sample_kernel runs one warp per walker over the shared
// per-step sampler of walk_sample.cuh.  With rows == nullptr the tables are
// (B, .) rows gathered by the caller, the TPU kernel's signature; with rows
// they are the full (V, .) state tables and walker b reads row rows[b] in
// place, so no (B, C) gather is ever written to device memory (at B = 262,144
// and C = 256 each gathered int32 table is 256 MiB).  The uniform pick needs
// one degree word and one neighbour word per walker: one thread per walker.
//
// Bound on this card: a sample reads deg[r], one prob and one alias entry,
// the bias row up to deg (two integer ops per word to find the group's
// members) and one nbr word; the uniform pick reads deg[r] and one nbr word.
// Counted with each word read once over the distinct rows a batch touches
// (chip_smoke.py computes it per run), the biased sample is bound by those
// integer ops and the uniform pick by bytes.  Each sample is a chain of
// dependent loads (rows -> deg -> prob/alias -> bias -> nbr) with no prefetch,
// covered only by many resident warps; row prefetch is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk_sample.cuh"

namespace {

using walk_sample::kWarp;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
walk_sample_kernel(const float* __restrict__ prob, const int* __restrict__ alias,
                   const int* __restrict__ bias, const int* __restrict__ nbr,
                   const int* __restrict__ deg, const float* __restrict__ frac,
                   const float* __restrict__ u, const int* __restrict__ rows,
                   int* __restrict__ nxt_out, int* __restrict__ slot_out,
                   int B, int C, int Kin, int base_log2, int has_frac,
                   int ucols) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long wglobal =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (wglobal >= B) return;
  const int b = static_cast<int>(wglobal);
  const int r = rows != nullptr ? rows[b] : b;
  const size_t row = static_cast<size_t>(r) * C;
  const size_t krow = static_cast<size_t>(r) * Kin;
  const float* ub = u + static_cast<size_t>(b) * ucols;
  const float u3 = ucols > 3 ? ub[3] : 0.0f;
  const float u4 = ucols > 4 ? ub[4] : 0.0f;
  const walk_sample::Pick pk = walk_sample::sample_row(
      prob + krow, alias + krow, bias + row, nbr + row,
      has_frac ? frac + row : nullptr, deg[r], C, Kin, base_log2,
      has_frac != 0, ub[0], ub[1], ub[2], u3, u4, lane);
  if (lane == 0) {
    nxt_out[b] = pk.nxt;
    slot_out[b] = pk.slot;
  }
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
    const long long threads = static_cast<long long>(B) * kWarp;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    walk_sample_kernel<<<blocks, kThreads, 0, stream>>>(
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

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
