// Flash-attention forward for Hopper (sm_90a), on the CUDA cores in float32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (causal, sliding-window or non-causal GQA attention
// with an online softmax) for float32 inputs; bfloat16 inputs go to the
// tensor-core kernel of csrc/flash_attention_sm90.cu.  Plain version:
// repro_torch/kernels/flash_attention.py:flash_attention_ref, which runs the
// same algorithm tile by tile; the two agree to float rounding (the dot
// products sum in another order), not bit for bit, so this source is built
// without -fmad=false.
//
// q (B, H, S, D), k and v (B, Hkv, T, D), all float32; out (B, H, S, D)
// float32; D in {64, 128}; H a multiple of Hkv.  Query row i sits at
// position qpos = i + T - S; key kpos is seen when kpos < T, kpos <= qpos
// (causal) and kpos > qpos - window (window > 0).
//
// Design: one block of 8 warps per (b * H + h, 64-row query tile).  The query
// tile, scaled, stays in shared memory; K and V tiles of
// 64 x D stream through shared memory (K rows padded by 4 floats, so that a
// warp's 16-byte row reads fall in distinct banks).  Warp w owns query rows
// 8w..8w+7: lane j scores keys j and j + 32 of the tile for its 8 rows, the
// running max and denominator are warp reductions, the probabilities go
// through shared memory, and lane j accumulates output columns j + 32i.
// Accumulation is float32 and exponentials are expf.  Query head h reads KV
// head h / (H / Hkv), so repeated KV never exists in memory.  Masked scores
// are -1e30, as in the reference; KV tiles wholly outside the causal/window
// band are skipped, which is exact (a fully masked tile before the first
// valid one is wiped by exp(-1e30 - m) = 0, one after the last adds 0), and
// makes a windowed pass O(S * window).  Tiles of the last query rows, which
// see the most keys under a causal mask, are scheduled first.  A row with no
// valid key at all is outside the contract (the reference gives NaN there).
//
// Bound on this card: operations.  4 D float operations per unmasked
// (query, key) pair, at the float32 rate outside the tensor cores (TF32
// would weaken the float32 contract); the bytes (q, k, v and out once) are
// far below.  Each score and output update is a shared-memory read per
// multiply-add or two.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = kBlockQ / kWarps;   // query rows per warp
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
struct Tiles {
  static constexpr int kStrideK = D + 4;
  static constexpr size_t kFloats =
      static_cast<size_t>(kBlockQ) * D + static_cast<size_t>(kBlockK) * kStrideK +
      static_cast<size_t>(kBlockK) * D + static_cast<size_t>(kBlockQ) * kBlockK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int H,
                       int Hkv, int S, int Tk, int causal, int window,
                       float scale) {
  constexpr int kChunks = D / 4;          // 4-element chunks per row
  constexpr int kCols = D / kWarp;        // output columns per lane
  constexpr int kStrideK = Tiles<D>::kStrideK;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBlockQ * D;
  float* Vs = Ks + kBlockK * kStrideK;
  float* Ps = Vs + kBlockK * D;

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int r0 = (tid / kWarp) * kRows;
  const float* qb = q + static_cast<size_t>(bh) * S * D;
  const float* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const float* vb = v + static_cast<size_t>(kvh) * Tk * D;

  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int r = c / kChunks, d = (c % kChunks) * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (i0 + r < S) load4(qb + static_cast<size_t>(i0 + r) * D + d, x);
    *reinterpret_cast<float4*>(Qs + r * D + d) =
        make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  }

  // the KV tiles that meet the band of this query tile
  const int off = Tk - S;
  const int last = min(i0 + kBlockQ, S) - 1;
  const int kend = causal ? min(Tk, last + off + 1) : Tk;
  const int kbeg = window > 0 ? max(0, i0 + off - window + 1) : 0;
  const int t_lo = kbeg / kBlockK;
  const int t_hi = kend > kbeg ? (kend + kBlockK - 1) / kBlockK : t_lo;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[r][i] = 0.0f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int j0 = t * kBlockK;
    __syncthreads();                      // the last tile's readers are done
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int r = c / kChunks, d = (c % kChunks) * 4;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j0 + r < Tk) {
        load4(kb + static_cast<size_t>(j0 + r) * D + d, x);
        load4(vb + static_cast<size_t>(j0 + r) * D + d, y);
      }
      *reinterpret_cast<float4*>(Ks + r * kStrideK + d) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(Vs + r * D + d) = make_float4(y[0], y[1], y[2], y[3]);
    }
    __syncthreads();

    // scores of keys lane and lane + 32 for the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * kStrideK + d);
      const float4 kc = *reinterpret_cast<const float4*>(Ks + (lane + kWarp) * kStrideK + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + r) * D + d);
        s[r][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
        s[r][1] += qv.x * kc.x + qv.y * kc.y + qv.z * kc.z + qv.w * kc.w;
      }
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = i0 + r0 + r + off;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = j0 + lane + e * kWarp;
        const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        if (!ok) s[r][e] = kNegInf;
      }
      const float mn = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - mn);
      const float p1 = expf(s[r][1] - mn);
      const float corr = expf(m[r] - mn);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = mn;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[r][i] *= corr;
      Ps[(r0 + r) * kBlockK + lane] = p0;
      Ps[(r0 + r) * kBlockK + lane + kWarp] = p1;
    }
    __syncwarp();

    // acc += P V over the tile's keys, four at a time
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < kCols; ++i) vv[jj][i] = Vs[(j + jj) * D + lane + i * kWarp];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + (r0 + r) * kBlockK + j);
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[r][i] += p.x * vv[0][i] + p.y * vv[1][i] + p.z * vv[2][i] + p.w * vv[3][i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = i0 + r0 + r;
    if (row >= S) continue;
    float* o = out + (static_cast<size_t>(bh) * S + row) * D;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kCols; ++i) store1(o + lane + i * kWarp, acc[r][i] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Hkv, int S, int Tk, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t shmem = Tiles<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(B) * H, (S + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<D><<<grid, kThreads, shmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, S, Tk,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int Hkv, int S,
                                      int Tk, int D, int causal, int window,
                                      float scale, cudaStream_t stream) {
  if (Hkv < 1 || H % Hkv != 0 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  return D == 64 ? launch<64>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, stream)
                 : launch<128>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, stream);
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
