// Batched alias-table kernel for Hopper (sm_90a): Vose tables over K-entry rows.
//
// Replaces the TPU kernel repro/kernels/alias_build.py:alias_build_pallas.
// Plain version: repro_torch/kernels/alias_build.py:alias_build_ref (the
// port's core/alias.py:build_alias), which this kernel equals bit for bit:
// prob equal as floats, alias equal.
//
// Design: one thread per row, running the row loop of alias_row.cuh, the one
// the update kernel (update_fused.cu) runs for each row it rebuilds, in
// alias._build_row's float order.  The TPU kernel retires one small entry
// per row and step across a (Vt, K) tile with lane-wise argmax passes; on
// this card a row's K <= 64 entries fit one thread, whose scaled weights and
// retired flags live in a local-memory array (dynamically indexed, so not in
// registers); the row's weights are read from, and its prob and alias
// entries written to, device memory directly.
//
// Bound on this card: bytes.  The (V, K) weights read once and the (V, K)
// prob and alias tables written once, against 3.35 TB/s; Vose's K^2 compare
// steps per row are the work.  A warp's 32 rows are 32 strided rows, so
// each load instruction touches 32 rows' sectors; L1 serves the rest of
// each row.  Built with -fmad=false (see alias_row.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "alias_row.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
alias_build_kernel(const float* __restrict__ w, float* __restrict__ prob,
                   int* __restrict__ alias, int V, int K) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= V) return;
  const size_t o = static_cast<size_t>(r) * K;
  alias_row::vose_row(w + o, K, prob + o, alias + o);
}

}  // namespace

extern "C" int alias_build_launch(const float* w, float* prob, int* alias,
                                  int V, int K, cudaStream_t stream) {
  if (K < 1 || K > alias_row::kMaxInter)
    return static_cast<int>(cudaErrorInvalidValue);
  if (V > 0) {
    const unsigned blocks = static_cast<unsigned>((V + kThreads - 1) / kThreads);
    alias_build_kernel<<<blocks, kThreads, 0, stream>>>(w, prob, alias, V, K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
