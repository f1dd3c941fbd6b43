// Batched-update Bingo kernel for Hopper (sm_90a): one §5.2 round, one launch.
//
// Replaces the TPU kernel repro/kernels/update_fused.py:update_fused_pallas
// (its _kernel and _vose_rows).  Plain version:
// repro_torch/core/updates.py:batched_update, which this kernel equals bit
// for bit for every batch.
//
// Design: one block per affected row.  The ordering prepass (stable sorts,
// segmented ranks, the sorted affected-vertex list U) runs in torch ops; it
// hands each row its insert and delete lanes as contiguous segments of the
// sorted lane arrays, so a row may receive any number of lanes.  The block
// owns its row, so there are no races between blocks:
//   1. load nbr/bias/frac of the row into shared memory;
//   2. append the inserts at deg + rank (lanes past capacity are dropped);
//   3. locate each delete, one warp per lane, as the (rank+1)-th match of its
//      value in the post-insert row (ballot + popc);
//   4. two-phase delete-and-swap (paper Fig. 10(b)): the j-th surviving tail
//      slot moves into the j-th front hole, ranks from ballot prefix counts;
//   5. rebuild per radix group, one warp per group: gsize and digitsum by
//      warp reductions, the Eq. 9 class (alpha*deg as a float32 product),
//      gmem compaction by prefix counts over members (DENSE groups stay
//      empty in adaptive mode), ginv in baseline mode;
//   6. one thread sums wdec left to right and builds the Kin-entry alias row
//      with Vose's loop in exactly alias._build_row's order (alias_row.cuh,
//      shared with alias_build.cu);
//   7. every row and per-row output is written in place at the row's index.
// Per-lane delete flags go to del_ok; the round's stats are torch ops.
//
// Bound on this card: bytes.  Per affected row the round must read deg and
// the nbr/bias (frac in fp mode) slots below the old degree, and write those
// below the larger of the old and new degree, each group's member list up
// to its kept length (ginv in baseline mode) and the O(K) counters and
// alias row, against 3.35 TB/s; the integer work per byte is small.  The
// design moves each row through shared memory once (one read, one write)
// and rebuilds gmem without reading the old one.  It moves more than the
// bound counts: all C slots of nbr, bias and frac (frac in integer mode
// too) and all Cg slots of gmem.  The per-row Vose loop (Kin^2 steps in
// one thread) is serial.
//
// Built with -fmad=false: the alias row's float arithmetic must not be
// contracted, so that it equals the plain version's.

#include <cstdint>
#include <cuda_runtime.h>

#include "alias_row.cuh"

namespace {

using alias_row::kMaxInter;
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int EMPTY = 0, DENSE = 1, ONE = 2, SPARSE = 3, REGULAR = 4;

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

__device__ __forceinline__ unsigned lanemask_le(int lane) {
  return 0xFFFFFFFFu >> (31 - lane);
}

__device__ __forceinline__ int classify(int g, int d, int adaptive, float alpha,
                                        float beta) {
  if (!adaptive) return g > 0 ? REGULAR : EMPTY;
  if (g == 0) return EMPTY;
  const float gf = static_cast<float>(g);
  const float df = static_cast<float>(d);
  if (gf > alpha * df) return DENSE;
  if (g == 1) return ONE;
  if (gf < beta * df) return SPARSE;
  return REGULAR;
}

__global__ void __launch_bounds__(kThreads)
update_fused_kernel(const int* __restrict__ U, const int* __restrict__ ins_lo,
                    const int* __restrict__ ins_hi, const int* __restrict__ v_s,
                    const int* __restrict__ wi_s, const float* __restrict__ wf_s,
                    const int* __restrict__ del_lo, const int* __restrict__ del_hi,
                    const int* __restrict__ dv_s, const int* __restrict__ rank_d,
                    int* __restrict__ del_ok, int* __restrict__ nbr,
                    int* __restrict__ bias, float* __restrict__ frac,
                    int* __restrict__ deg, int* __restrict__ gmem,
                    int* __restrict__ ginv, int* __restrict__ gsize,
                    int* __restrict__ digitsum, float* __restrict__ wdec,
                    int8_t* __restrict__ gtype, float* __restrict__ prob,
                    int* __restrict__ alias, int V, int C, int K, int Cg,
                    int Kin, int base_log2, int adaptive, float alpha,
                    float beta) {
  extern __shared__ int smem[];
  int* s_nbr = smem;
  int* s_bias = smem + C;
  float* s_frac = reinterpret_cast<float*>(smem + 2 * C);
  int* s_del = smem + 3 * C;
  int* s_hole = smem + 4 * C;
  __shared__ int s_dsum[kMaxInter];
  __shared__ int s_front;

  const int r = blockIdx.x;
  const int vtx = U[r];
  if (vtx >= V) return;                       // sentinel row: nothing to do
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const size_t row = static_cast<size_t>(vtx) * C;
  const int deg0 = deg[vtx];

  // 1. load the row
  for (int s = tid; s < C; s += blockDim.x) {
    s_nbr[s] = nbr[row + s];
    s_bias[s] = bias[row + s];
    s_frac[s] = frac[row + s];
    s_del[s] = 0;
  }
  __syncthreads();

  // 2. inserts at deg + rank
  const int ilo = ins_lo[r];
  const int nins = ins_hi[r] - ilo;
  for (int j = tid; j < nins; j += blockDim.x) {
    const int slot = deg0 + j;
    if (slot < C) {
      s_nbr[slot] = v_s[ilo + j];
      s_bias[slot] = wi_s[ilo + j];
      s_frac[slot] = wf_s[ilo + j];
    }
  }
  const int d1 = min(deg0 + nins, C);
  __syncthreads();

  // 3. delete locate: the (rank+1)-th match in the post-insert row
  const int dlo = del_lo[r];
  const int ndel = del_hi[r] - dlo;
  for (int j = warp; j < ndel; j += nwarps) {
    const int tv = dv_s[dlo + j];
    const int want = rank_d[dlo + j] + 1;
    int seen = 0, found = -1;
    for (int base = 0; base < d1; base += kWarp) {
      const int s = base + lane;
      const bool m = s < d1 && s_nbr[s] == tv;
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, m);
      const int c = __popc(mask);
      if (seen + c >= want) {
        const unsigned f = __ballot_sync(
            0xFFFFFFFFu, m && __popc(mask & lanemask_le(lane)) == want - seen);
        found = base + __ffs(f) - 1;
        break;
      }
      seen += c;
    }
    if (lane == 0) {
      del_ok[dlo + j] = found >= 0;
      if (found >= 0) s_del[found] = 1;
    }
  }
  __syncthreads();

  // 4. two-phase delete-and-swap, in warp 0
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < d1; base += kWarp) {
      const int s = base + lane;
      n += __popc(__ballot_sync(0xFFFFFFFFu, s < d1 && s_del[s]));
    }
    const int front = d1 - n;
    int hb = 0;                               // phase 1: rank the front holes
    for (int base = 0; base < front; base += kWarp) {
      const int s = base + lane;
      const bool h = s < front && s_del[s];
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, h);
      if (h) s_hole[hb + __popc(mask & lanemask_lt(lane))] = s;
      hb += __popc(mask);
    }
    __syncwarp();
    int sb = 0;                               // phase 2: surviving tail -> holes
    for (int base = front - front % kWarp; base < d1; base += kWarp) {
      const int s = base + lane;
      const bool st = s >= front && s < d1 && !s_del[s];
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, st);
      if (st) {
        const int tgt = s_hole[sb + __popc(mask & lanemask_lt(lane))];
        s_nbr[tgt] = s_nbr[s];
        s_bias[tgt] = s_bias[s];
        s_frac[tgt] = s_frac[s];
      }
      sb += __popc(mask);
    }
    if (lane == 0) s_front = front;
  }
  __syncthreads();
  const int front = s_front;
  for (int s = tid; s < C; s += blockDim.x) {
    if (s >= front) {
      s_nbr[s] = -1;
      s_bias[s] = 0;
      s_frac[s] = 0.0f;
    }
    nbr[row + s] = s_nbr[s];
    bias[row + s] = s_bias[s];
    frac[row + s] = s_frac[s];
  }
  if (tid == 0) deg[vtx] = front;
  __syncthreads();

  // 5. rebuild, one warp per radix group
  const int dmask = (1 << base_log2) - 1;
  const bool has_ginv = ginv != nullptr;
  for (int k = warp; k < K; k += nwarps) {
    const int shift = k * base_log2;
    int cnt = 0, dsum = 0;
    for (int base = 0; base < front; base += kWarp) {
      const int s = base + lane;
      const int dig = s < front ? (s_bias[s] >> shift) & dmask : 0;
      cnt += __popc(__ballot_sync(0xFFFFFFFFu, dig != 0));
      dsum += static_cast<int>(
          __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(dig)));
    }
    const int gt = classify(cnt, front, adaptive, alpha, beta);
    const size_t krow = static_cast<size_t>(vtx) * K + k;
    if (lane == 0) {
      s_dsum[k] = dsum;
      gsize[krow] = cnt;
      digitsum[krow] = dsum;
      gtype[krow] = static_cast<int8_t>(gt);
    }
    const int nkeep = (adaptive && gt == DENSE) ? 0 : min(cnt, Cg);
    int* grow = gmem + krow * Cg;
    for (int p = nkeep + lane; p < Cg; p += kWarp) grow[p] = -1;
    if (nkeep > 0 || has_ginv) {
      const int limit = has_ginv ? C : front;
      int pb = 0;
      for (int base = 0; base < limit; base += kWarp) {
        const int s = base + lane;
        const int dig = s < front ? (s_bias[s] >> shift) & dmask : 0;
        const bool mem = dig != 0;
        const unsigned mask = __ballot_sync(0xFFFFFFFFu, mem);
        const int pos = pb + __popc(mask & lanemask_lt(lane));
        if (mem && pos < nkeep) grow[pos] = s;
        if (has_ginv && s < C) ginv[krow * C + s] = mem ? pos : -1;
        pb += __popc(mask);
      }
    }
  }
  __syncthreads();

  // 6. wdec (left to right) and the alias row (alias._build_row's order)
  if (tid == 0) {
    float wd = s_frac[0];
    for (int s = 1; s < C; ++s) wd = wd + s_frac[s];
    wdec[vtx] = wd;
    const int n = Kin;
    float w[kMaxInter], pr[kMaxInter];
    int al[kMaxInter];
    for (int k = 0; k < K; ++k)
      w[k] = static_cast<float>(s_dsum[k]) * ldexpf(1.0f, k * base_log2);
    if (n > K) w[K] = wd;                     // decimal group (fp mode)
    alias_row::vose_row(w, n, pr, al);
    const size_t arow = static_cast<size_t>(vtx) * n;
    for (int j = 0; j < n; ++j) {
      prob[arow + j] = pr[j];
      alias[arow + j] = al[j];
    }
  }
}

}  // namespace

extern "C" int update_fused_launch(
    const int* U, const int* ins_lo, const int* ins_hi, const int* v_s,
    const int* wi_s, const float* wf_s, const int* del_lo, const int* del_hi,
    const int* dv_s, const int* rank_d, int* del_ok, int* nbr, int* bias,
    float* frac, int* deg, int* gmem, int* ginv, int* gsize, int* digitsum,
    float* wdec, int8_t* gtype, float* prob, int* alias, int B, int V, int C,
    int K, int Cg, int Kin, int base_log2, int adaptive, float alpha,
    float beta, cudaStream_t stream) {
  if (Kin > kMaxInter || K > kMaxInter) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(5) * C * sizeof(int);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        update_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B > 0) {
    update_fused_kernel<<<B, kThreads, shmem, stream>>>(
        U, ins_lo, ins_hi, v_s, wi_s, wf_s, del_lo, del_hi, dv_s, rank_d,
        del_ok, nbr, bias, frac, deg, gmem, ginv, gsize, digitsum, wdec, gtype,
        prob, alias, V, C, K, Cg, Kin, base_log2, adaptive, alpha, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
