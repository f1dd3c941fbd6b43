// Batched alias-table kernel for Hopper (sm_90a): Vose tables over K-entry rows.
//
// Replaces the TPU kernel repro/kernels/alias_build.py:alias_build_pallas.
// Plain version: repro_torch/kernels/alias_build.py:alias_build_ref (the
// port's core/alias.py:build_alias), which this kernel equals bit for bit:
// prob equal as floats, alias equal.
//
// Design: a row to a group of G lanes, E entries a lane (K <= 4: 4 x 1,
// <= 8: 4 x 2, <= 16: 4 x 4, <= 32: 8 x 4, <= 64: 16 x 4), so a warp holds
// 32 / G rows (8 at K = 16) and runs alias_row.cuh's Vose row on all of
// them at once, the row the update kernel (update_fused.cu) runs for each
// row it rebuilds.  Lane i of a group loads entries i + e * G of its row,
// so a warp's loads cover its rows' contiguous floats, and writes prob and
// alias once an entry after the loop.  The TPU kernel retires one small
// entry per row and step across a (Vt, K) tile with lane-wise argmax
// passes; here a round of a row costs two shuffles and a few mask
// operations, shared by the warp's rows.
//
// Bound on this card: bytes.  The (V, K) weights read once and the (V, K)
// prob and alias tables written once, against 3.35 TB/s.  The rounds are
// the work: up to K - 1 a row, each a chain of dependent warp instructions.
// Built with -fmad=false (see alias_row.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "alias_row.cuh"

namespace {

constexpr int kThreads = 256;

template <int G, int E>
__global__ void __launch_bounds__(kThreads)
alias_build_kernel(const float* __restrict__ w, float* __restrict__ prob,
                   int* __restrict__ alias, int V, int K) {
  constexpr int kRows = 32 / G;              // rows a warp
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (warp * kRows >= V) return;             // whole warp past the table
  const long long r = warp * kRows + lane / G;
  const bool live = r < V;
  const int gi = lane & (G - 1);
  const size_t o = static_cast<size_t>(live ? r : 0) * K;
  float wv[E], pv[E];
  int av[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = gi + e * G;
    wv[e] = live && j < K ? w[o + j] : 0.0f;
  }
  alias_row::vose_row<G, E>(wv, K, pv, av);
  if (!live) return;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = gi + e * G;
    if (j < K) {
      prob[o + j] = pv[e];
      alias[o + j] = av[e];
    }
  }
}

template <int G, int E>
void launch(const float* w, float* prob, int* alias, int V, int K,
            cudaStream_t stream) {
  const long long warps = (static_cast<long long>(V) + 32 / G - 1) / (32 / G);
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  alias_build_kernel<G, E><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(w, prob, alias, V, K);
}

}  // namespace

extern "C" int alias_build_launch(const float* w, float* prob, int* alias,
                                  int V, int K, cudaStream_t stream) {
  if (K < 1 || K > alias_row::kMaxInter)
    return static_cast<int>(cudaErrorInvalidValue);
  if (V > 0) {
    if (K <= 4) launch<4, 1>(w, prob, alias, V, K, stream);
    else if (K <= 8) launch<4, 2>(w, prob, alias, V, K, stream);
    else if (K <= 16) launch<4, 4>(w, prob, alias, V, K, stream);
    else if (K <= 32) launch<8, 4>(w, prob, alias, V, K, stream);
    else launch<16, 4>(w, prob, alias, V, K, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
