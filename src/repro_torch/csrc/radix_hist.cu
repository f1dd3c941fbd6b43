// Radix-histogram kernel for Hopper (sm_90a): Eq. 4's base-2 counters.
//
// Replaces the TPU kernel repro/kernels/radix_hist.py:radix_hist_pallas.
// Plain version: repro_torch/kernels/radix_hist.py:radix_hist_ref, which this
// kernel equals bit for bit (integer sums are order-free).
//
// For each vertex r and digit position k < K: digitsum[r, k], the sum of the
// base-2 digits (bias[r, s] >> k) & 1 over the slots s < deg[r], and
// gsize[r, k], the count of those digits that are nonzero.  In base 2 the two
// coincide; both are computed as the reference defines them and both written.
//
// Design: one warp per row.  The TPU kernel keeps a (Vt, C) tile in VMEM and
// reduces all C lanes under a mask; here a warp reads only the slots below
// min(deg, C), 32 consecutive words at a time (one 128-byte transaction).
// For each k the warp takes __reduce_add_sync of the digits (the digit sum)
// and __popc(__ballot_sync(digit != 0)) (the count); both are uniform across
// the warp, and lane k keeps column k in a register, so no (V, C, K) digit
// tensor exists anywhere.  Lanes 0..K-1 write the row's two K-word outputs.
//
// Bound on this card: bytes.  deg, the bias words below each degree and the
// two (V, K) outputs, each moved once, against 3.35 TB/s; the integer work is
// about three operations per word and digit.  A row of degree d costs
// ceil(d / 32) iterations of K ballots and reductions, so the short rows of a
// power-law graph cost one iteration each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int* __restrict__ bias, const int* __restrict__ deg,
                  int* __restrict__ digitsum, int* __restrict__ gsize, int V,
                  int C, int K) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long wglobal =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (wglobal >= V) return;
  const int r = static_cast<int>(wglobal);
  const int d = min(deg[r], C);
  const int* row = bias + static_cast<size_t>(r) * C;
  int dsum = 0, cnt = 0;
  for (int base = 0; base < d; base += kWarp) {
    const int s = base + lane;
    const int b = s < d ? row[s] : 0;
    for (int k = 0; k < K; ++k) {
      const int dig = (b >> k) & 1;
      const int sum = static_cast<int>(
          __reduce_add_sync(kFull, static_cast<unsigned>(dig)));
      const int nz = __popc(__ballot_sync(kFull, dig != 0));
      if (lane == k) {
        dsum += sum;
        cnt += nz;
      }
    }
  }
  if (lane < K) {
    const size_t o = static_cast<size_t>(r) * K + lane;
    digitsum[o] = dsum;
    gsize[o] = cnt;
  }
}

}  // namespace

extern "C" int radix_hist_launch(const int* bias, const int* deg, int* digitsum,
                                 int* gsize, int V, int C, int K,
                                 cudaStream_t stream) {
  if (K < 1 || K > kWarp) return static_cast<int>(cudaErrorInvalidValue);
  if (V > 0) {
    const long long threads = static_cast<long long>(V) * kWarp;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    radix_hist_kernel<<<blocks, kThreads, 0, stream>>>(bias, deg, digitsum,
                                                       gsize, V, C, K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
