// Flash-attention forward on Hopper's tensor cores (sm_90a), float32 to
// float32 accuracy: three TF32 products (3xTF32) for each of Q K^T and P V.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (causal, sliding-window or non-causal GQA attention
// with an online softmax) for float32 inputs; bfloat16 inputs go to
// csrc/flash_attention_sm90.cu.  Plain version:
// repro_torch/kernels/flash_attention.py:flash_attention_ref32, the same
// algorithm in float32 over KV tiles of 64; the two agree within 2e-5 entry
// by entry (tile sizes, summation order and the dropped lo x lo products
// differ), not bit for bit, so this source is built without -fmad=false.
//
// q (B, H, S, D), k and v (B, Hkv, T, D), all float32; out (B, H, S, D)
// float32; D in {64, 80, 128} (``flash_attention_kernel``) and D in {256,
// 384, 512} (``flash_attention_slice_kernel``, below: Q split in registers,
// and past 256 the output columns split over blocks); H a multiple of Hkv.  Query row
// i sits at position qpos = i + T - S; key kpos is seen when kpos < T, kpos
// <= qpos (causal) and kpos > qpos - window (window > 0).
//
// 3xTF32.  A tensor core reads a TF32 operand (10 mantissa bits), so each
// float32 operand x is split once into hi = rna(x) (cvt.rna.tf32.f32) and
// lo = rna(x - hi), and a product is lo*hi + hi*lo + hi*hi, accumulated in
// float32, small terms first: x - hi is exact, lo carries x to about 2^-22
// of |x|, and the dropped lo*lo term is below that, where one TF32 product
// alone is off by about 2^-11, which misses the 2e-5 limit.
//
// Design.  One block per (b * H + h, 64-row query tile), heaviest tiles
// first: a consumer warpgroup (warps 0-3) and a producer warpgroup (warp 4
// issues the TMA loads from one lane, warps 5-7 split tiles).  The query
// tile is loaded once by TMA (64-byte swizzled panels of 16 columns); the
// consumers split it in place (hi) and into a lo copy.  K and V tiles of
// kBlockK keys stream through a ring of kStages stages: TMA lands K in the
// stage swizzled as Q, and V row-major beside it; the splitters write K's
// hi in place and its lo beside it, and V's hi and lo transposed (V^T,
// K-major, swizzled), since TF32 wgmma takes no transposed operand: each
// tile is split once, off the consumers' path.  Per stage, "full" (TMA
// bytes), "ready" (the 96 splitters) and "empty" (the 128 consumers)
// barriers.  The consumers compute S = Q K^T with wgmma m64n{kBlockK}k8
// (both operands from shared memory, K-major): Qlo Khi, Qhi Klo, then
// Qhi Khi over D / 8 steps each; mask only a tile that crosses the band's
// edge or T, run the online softmax in the exp2 domain with the scale
// folded into the exponent, split P in registers, and accumulate
// O += P V with wgmma m64n{D}k8, P from registers (Plo Vhi, Phi Vlo,
// Phi Vhi).  P's register fragment is S's accumulator fragment: a thread
// holds keys 2c and 2c+1 of each 8-key step, which the A fragment takes as
// columns c and c+4, so V^T's key order within each 8 keys is permuted to
// match (0, 2, 4, 6, 1, 3, 5, 7).  (P V on mma.sync m16n8k8 from a
// row-major V, each warp reading the whole tile, was 6 % slower at
// hubert-xlarge's widths and 13 % at Mixtral's window, at 255 registers:
// tools/walk_ab.py --flash, PERF.md.)  m and l stay in registers; l sums the
// float32 p.  The epilogue writes acc / max(l, 1e-30) for rows < S.  KV
// tiles wholly outside the causal/window band are skipped, which is exact
// (a fully masked tile before the first valid one is wiped by
// exp(-1e30 - m) = 0, one after the last adds 0).  A row with no valid key
// at all is outside the contract (the reference gives NaN there).
//
// Shared memory (227 KB a block at most): Q hi and lo, 64 x D x 4 bytes
// each; a stage holds five kBlockK x D x 4-byte tiles (K hi in place, K lo,
// V as landed, V^T hi, V^T lo).  D = 64: kBlockK 64, 2 stages: 32 + 2 x 80
// = 192 KB.  D = 80: kBlockK 32, 3 stages: 40 + 3 x 50 = 190 KB.  D = 128:
// kBlockK 32, 2 stages: 64 + 2 x 80 = 224 KB.  So one block per SM.
//
// Bound on this card: operations, 3 x 4 D FLOPs per unmasked (query, key)
// pair at the dense TF32 tensor-core rate (the least time for
// float32-accurate products on tensor cores); the bytes (q, k, v and out
// once) are far below.  What this first tensor-core version leaves: one
// consumer warpgroup, so the softmax waits for S and the next S for P V;
// S reads both operands from shared memory (at 32 keys, more bytes per
// product than shared memory delivers at the peak rate); no persistent
// schedule.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;               // query rows per block
constexpr int kConsumers = 128;           // one warpgroup
constexpr int kSplitters = 96;            // producer warps 5-7
constexpr int kThreads = 256;
constexpr int kPanel = 16;                // f32 columns of a 64-byte panel
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = -1;         // returned when a tensor map fails

template <int D>
struct Geometry;
template <>
struct Geometry<64> {
  static constexpr int kBlockK = 64, kStages = 2;
};
template <>
struct Geometry<80> {
  static constexpr int kBlockK = 32, kStages = 3;
};
template <>
struct Geometry<128> {
  static constexpr int kBlockK = 32, kStages = 2;
};

template <int D>
struct Smem {
  static constexpr int kBlockK = Geometry<D>::kBlockK;
  static constexpr int kStages = Geometry<D>::kStages;
  static constexpr int kQ = kBlockQ * D * 4;          // Q hi (or lo)
  static constexpr int kTile = kBlockK * D * 4;       // one K or V tile
  static constexpr int kQPanel = kBlockQ * 64;        // bytes of a Q panel
  static constexpr int kKPanel = kBlockK * 64;        // bytes of a K panel
  static constexpr int kVPanel = D * 64;              // of a V^T panel (16 keys)
  // a stage: K (hi in place), K lo, V as landed, V^T hi, V^T lo
  static constexpr int kK = 0, kKlo = kTile, kV = 2 * kTile, kVhi = 3 * kTile,
                       kVlo = 4 * kTile, kStage = 5 * kTile;
  static constexpr int kQhi = 0, kQlo = kQ, kStage0 = 2 * kQ;
  static constexpr int kBar = kStage0 + kStages * kStage;
  // barriers: Q; full, ready and empty per stage; and room to round the
  // dynamic base up to 1024 bytes
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
  static_assert(kQ % 512 == 0 && kTile % 512 == 0 && kKPanel % 512 == 0 &&
                    kVPanel % 512 == 0,
                "every panel starts on the 512-byte period of the swizzle");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Make this thread's shared-memory writes visible to the async proxy
// (wgmma and TMA) once a barrier orders them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The consumer warpgroup's own barrier.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// wgmma descriptor of a K-major operand in 64-byte swizzled panels: start
// address, stride byte offset 512 (the next group of 8 rows), layout type 2
// (64B swizzle); the leading byte offset is not read for this layout.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma's asynchronous window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D16 D8(0), D8(8)
#define D32 D16, D8(16), D8(24)
#define D40 D32, D8(32)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define R40                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
#define R64                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// S (64 x N, f32) (+)= A (64 x 8) B (8 x N), tf32 from shared memory, both
// K-major; the sum starts from zero unless ``accumulate``.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
      ", %16, %17, p, 1, 1;\n\t}"
      : D16
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", %32, %33, p, 1, 1;\n\t}"
      : D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x N, f32) += A (64 x 8, tf32 in registers) B (8 x N), B from shared
// memory, K-major (also S (64 x 16) += Q (64 x 8) K^T (8 x 16), Q from
// registers, in the slice kernel).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %13, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " R8
      ", {%8, %9, %10, %11}, %12, p, 1, 1;\n\t}"
      : D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %45, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " R40
      ", {%40, %41, %42, %43}, %44, p, 1, 1;\n\t}"
      : D40
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8
#undef D16
#undef D32
#undef D40
#undef D64
#undef R8
#undef R16
#undef R32
#undef R40
#undef R64

// x rounded to TF32, to nearest with ties away from zero, as a 32-bit word.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// (hi, lo) of x: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Split four floats in place (hi) and into lo at the same offset.
__device__ __forceinline__ void split4(float4* p, float4* lo) {
  const float4 x = *p;
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  *p = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  *lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// Split a landed tile of ``bytes`` in place (hi) and into lo at ``lo``
// (elementwise, so the swizzle needs no address arithmetic).
__device__ __forceinline__ void split_tile(uint8_t* x, uint8_t* lo, int bytes,
                                           int tid) {
  float4* hi = reinterpret_cast<float4*>(x);
  float4* lo4 = reinterpret_cast<float4*>(lo);
  for (int i = tid; i < bytes / 16; i += kSplitters) split4(hi + i, lo4 + i);
}

// V (row-major kBlockK x DV, as landed) into V^T hi and lo, K-major in
// 64-byte swizzled panels of 16 key positions (DV x 64 bytes each), key
// 8j + 2e + h at position 8j + 4h + e.  An item is four keys of one parity
// of an 8-key step by four columns: four 16-byte reads, eight 16-byte
// writes.
template <int DV, int kBlockK>
__device__ __forceinline__ void split_v(const float* v, uint8_t* vhi, uint8_t* vlo,
                                        int tid) {
  constexpr int kQuads = DV / 4, kVPanel = DV * 64;
  for (int i = tid; i < kQuads * (kBlockK / 4); i += kSplitters) {
    const int q = i % kQuads, g = i / kQuads;        // columns 4q.., group g
    const int j = g / 2, h = g % 2;                  // 8-key step j, parity h
    float x[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 r = *reinterpret_cast<const float4*>(v + (8 * j + 2 * e + h) * DV + 4 * q);
      x[e][0] = r.x;
      x[e][1] = r.y;
      x[e][2] = r.z;
      x[e][3] = r.w;
    }
    const int pos = 8 * j + 4 * h;                   // 4 positions, one chunk
    const int panel = (pos / kPanel) * kVPanel, chunk = (pos % kPanel) / 4;
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int n = 4 * q + dd;                      // the row of V^T
      const int off = panel + n * 64 + ((chunk ^ ((n >> 1) & 3)) * 16);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e][dd], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(vhi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(vlo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// One KV tile's scores into P.  ``sc`` is S's accumulator fragment: this
// thread's rows qpos[0] and qpos[1] (r and r + 8), keys j0 + 8 (i / 4) + col
// + (i & 1).  Scaled into the exp2 domain, masked only where the tile
// crosses the band's edge or the end of the keys (``edge``); the online
// softmax's m and l updated, ``corr`` the factor on O; P split into the A
// fragments of the kBlockK / 8 steps of P V: step j takes (row r, key 2c),
// (r + 8, 2c), (r, 2c + 1), (r + 8, 2c + 1).
template <int kBlockK>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBlockK / 2], bool edge,
                                             int j0, const int (&qpos)[2], int col,
                                             int Tk, int causal, int window,
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             uint32_t (&phi)[kBlockK / 8][4],
                                             uint32_t (&plo)[kBlockK / 8][4]) {
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) {
    float x = sc[i] * scale_log2;
    if (edge) {
      const int kpos = j0 + 8 * (i / 4) + col + (i & 1);
      const int qp = qpos[(i >> 1) & 1];
      const bool ok = kpos < Tk && (!causal || kpos <= qp) &&
                      (window <= 0 || kpos > qp - window);
      if (!ok) x = kNegInf;
    }
    sc[i] = x;
  }
  // online softmax of rows r (h = 0) and r + 8 (h = 1)
  float mx[2] = {kNegInf, kNegInf}, psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(mx[h]));
    corr[h] = exp2f(m[h] - mn);
    m[h] = mn;
  }
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * j + (a == 1 ? 2 : a == 2 ? 1 : a);
      const float p = exp2f(sc[i] - m[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += p;
      split(p, phi[j][a], plo[j][a]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       float* __restrict__ out, int H, int Hkv, int S, int Tk,
                       int causal, int window, float scale_log2) {
  using L = Smem<D>;
  constexpr int kBlockK = L::kBlockK, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(base_ptr);
  const uint32_t sQ = base + L::kQhi, sQlo = base + L::kQlo;
  const uint32_t sStage = base + L::kStage0;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8, bar_ready = bar_full + 8 * kStages,
                 bar_empty = bar_ready + 8 * kStages;      // + 8 * stage

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x / 32;

  // the KV tiles that meet the band of this query tile
  const int off = Tk - S;
  const int last = min(i0 + kBlockQ, S) - 1;
  const int kend = causal ? min(Tk, last + off + 1) : Tk;
  const int kbeg = window > 0 ? max(0, i0 + off - window + 1) : 0;
  const int t_lo = kbeg / kBlockK;
  const int t_hi = kend > kbeg ? (kend + kBlockK - 1) / kBlockK : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_ready + 8 * s, kSplitters);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                        // TMA, from one lane
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int p = 0; p < D / kPanel; ++p)
        tma_load(sQ + p * L::kQPanel, &tm_q, bar_q, p * kPanel, i0, bh);
      for (int t = t_lo; t < t_hi; ++t) {
        const int it = t - t_lo, s = it % kStages;
        const uint32_t st = sStage + s * L::kStage;
        if (it >= kStages) mbar_wait(bar_empty + 8 * s, (it / kStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::kTile);
        for (int p = 0; p < D / kPanel; ++p)
          tma_load(st + L::kK + p * L::kKPanel, &tm_k, bar_full + 8 * s,
                   p * kPanel, t * kBlockK, kvh);
        tma_load(st + L::kV, &tm_v, bar_full + 8 * s, 0, t * kBlockK, kvh);
      }
    }
    return;
  }
  if (warp > 4) {                         // the splitters
    const int tid = threadIdx.x - 5 * 32;
    for (int t = t_lo; t < t_hi; ++t) {
      const int it = t - t_lo, s = it % kStages;
      mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
      uint8_t* st = base_ptr + L::kStage0 + s * L::kStage;
      split_tile(st + L::kK, st + L::kKlo, L::kTile, tid);
      split_v<D, kBlockK>(reinterpret_cast<const float*>(st + L::kV), st + L::kVhi,
                          st + L::kVlo, tid);
      fence_async_smem();
      mbar_arrive(bar_ready + 8 * s);
    }
    return;
  }

  // a consumer: warp w holds query rows 16 w .. 16 w + 15 of the tile; this
  // thread holds rows r and r + 8 and, of each 8-column block, columns
  // 2 (lane % 4) and the next
  const int lane = threadIdx.x % 32;
  const int row = i0 + warp * 16 + lane / 4;
  const int qpos[2] = {row + off, row + 8 + off};
  const int col = 2 * (lane % 4);

  mbar_wait(bar_q, 0);
  for (int i = threadIdx.x; i < L::kQ / 16; i += kConsumers)
    split4(reinterpret_cast<float4*>(base_ptr + L::kQhi) + i,
           reinterpret_cast<float4*>(base_ptr + L::kQlo) + i);
  fence_async_smem();
  consumers_sync();

  float o[D / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo, s = it % kStages;
    const uint32_t st = sStage + s * L::kStage;
    const int j0 = t * kBlockK;

    // S = Qlo Khi + Qhi Klo + Qhi Khi over D / 8 steps of 8
    float sc[kBlockK / 2];
    mbar_wait(bar_ready + 8 * s, (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint32_t qa = term == 0 ? sQlo : sQ;
      const uint32_t kb = st + (term == 1 ? L::kKlo : L::kK);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t step = (kk % 2) * 32;   // 8 columns into the panel
        wgmma_ss(sc, sw64_desc(qa + (kk / 2) * L::kQPanel + step),
                 sw64_desc(kb + (kk / 2) * L::kKPanel + step), term + kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask only a tile that crosses the band's edge or the end of the keys
    const bool edge = j0 + kBlockK > Tk || (causal && j0 + kBlockK - 1 > i0 + off) ||
                      (window > 0 && j0 <= last + off - window);
    float corr[2];
    uint32_t phi[kBlockK / 8][4], plo[kBlockK / 8][4];
    softmax_tile<kBlockK>(sc, edge, j0, qpos, col, Tk, causal, window, scale_log2,
                          m, l, corr, phi, plo);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += Plo Vhi + Phi Vlo + Phi Vhi over kBlockK / 8 steps of 8 keys
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint32_t vb = st + (term == 1 ? L::kVlo : L::kVhi);
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j)
        wgmma_rs(o, term == 0 ? plo[j] : phi[j],
                 sw64_desc(vb + (j / 2) * L::kVPanel + (j % 2) * 32));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * s);
  }

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= S) continue;
    float* dst = out + (static_cast<size_t>(bh) * S + r) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[4 * n + 2 * h] / den[h], o[4 * n + 2 * h + 1] / den[h]);
  }
}

// D = 256, 384 and 512 (``flash_attention_slice_kernel``).  The layout
// above cannot hold so wide a head: at 256 its Q hi and lo panels alone
// would take 128 KB, a stage five 32 x 256 x 4-byte tiles.  Here Q stays as
// it landed (float32, 64-byte swizzled panels of 16 columns, 64 x D x 4
// bytes, half of a hi and lo copy): each consumer thread reads its A
// fragment of an 8-column step from it, splits it into hi and lo in
// registers and runs S = Qlo Khi + Qhi Klo + Qhi Khi as wgmma m64n16k8 with
// Q from registers.  A wgmma reads its A registers until it is waited for,
// so S goes in groups of kGroup = 8 steps (64 columns), each waited for
// before the next group's Q is split: without the wait, ptxas gave a
// group's registers to the next group's Q while its products were still
// in flight (wrong sums at a 128-column slice, right ones at 256, on an
// H100; PERF.md).  S sums into four accumulators (the small terms
// and the large, even steps and odd apart), each taking at most D / 8
// rounded wgmma sums, and adds them at the end.  K streams whole (kBlockK
// x D, split by the splitters in place and into lo), V as a kBlockK x DV
// slice of columns (V^T hi and lo, as above).  K and V have barriers of
// their own (full, ready, empty), so with one stage the next tile's K lands
// and is split while the consumers run P V, and its V while they run S.
//
// A block owns DV output columns of a (head, 64-row query tile), computes S
// over the whole of D and accumulates P V over its columns only, in
// 128-column m64n128k8 chunks: DV = 256 at D = 256 (one block a tile, S
// once; 250 registers a thread, no spills), DV = 128 at 384 and 512 (the
// shared memory below has no room for 256 columns of V there), so S is
// computed D / 128 times: 3 x (2 D (D / 128) + 2 x 128) FLOPs a (query,
// key) pair at 512, against the 3 x 4 D of the bound.
//
// Shared memory (232,448 bytes a block at most): Q 64 x D x 4; a stage K
// and K lo 2 x 16 x D x 4, V, V^T hi and lo 3 x 16 x DV x 4.  D = 256:
// 64 + 2 x (32 + 48) = 224 KB (230,504 bytes with the barriers and the
// 1,024-byte alignment), 2 stages.  D = 384: 96 + 72 = 168 KB, 1 stage (2
// would need 240).  D = 512: 128 + 88 = 216 KB, 1 stage.  32 keys a tile
// would not fit at 256 with DV = 256, nor at 512.  Bound as above; what this
// first version leaves: S m64n16k8 is the smallest wgmma worth issuing, Q
// is split again for every KV tile (4 shared loads and 6 conversions a
// thread an 8-column step), each group of S waits for its products, and at
// 384 and 512 S is computed D / 128 times.
template <int D, int DV>
struct Slice {
  static constexpr int kBlockK = 16;                   // keys a tile
  static constexpr int kSlices = D / DV;
  static constexpr int kQ = kBlockQ * D * 4;           // Q as landed
  static constexpr int kKTile = kBlockK * D * 4;
  static constexpr int kVTile = kBlockK * DV * 4;
  static constexpr int kQPanel = kBlockQ * 64;         // bytes of a Q panel
  static constexpr int kKPanel = kBlockK * 64;         // bytes of a K panel
  static constexpr int kVPanel = DV * 64;              // of a V^T panel (16 keys)
  // a stage: K (hi in place), K lo, V as landed, V^T hi, V^T lo
  static constexpr int kK = 0, kKlo = kKTile, kV = 2 * kKTile, kVhi = kV + kVTile,
                       kVlo = kVhi + kVTile, kStage = kVlo + kVTile;
  static constexpr int kStage0 = kQ;
  // barriers: Q; per stage K full, ready, empty and V full, ready, empty;
  // and room to round the dynamic base up to 1024 bytes
  static constexpr int kStages =
      kStage0 + 2 * kStage + 8 * (1 + 6 * 2) + 1024 <= 232448 ? 2 : 1;
  static constexpr int kBar = kStage0 + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (1 + 6 * kStages) + 1024;
  static_assert(D % DV == 0 && DV % 128 == 0 && kBlockK == 16,
                "128-column chunks of O, one V^T panel a tile");
  static_assert(kBytes <= 232448, "a block's shared memory");
  static_assert(kQPanel % 512 == 0 && kKTile % 512 == 0 && kKPanel % 512 == 0 &&
                    kVTile % 512 == 0,
                "every panel starts on the 512-byte period of the swizzle");
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_slice_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             float* __restrict__ out, int H, int Hkv, int S,
                             int Tk, int causal, int window, float scale_log2) {
  using L = Slice<D, DV>;
  constexpr int kBlockK = L::kBlockK, kStages = L::kStages;
  constexpr int kGroup = 8;                 // 8-column steps of S a wait
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(base_ptr);
  const uint32_t sQ = base, sStage = base + L::kStage0;
  const uint32_t bar_q = base + L::kBar;
  // K full, ready, empty; V full, ready, empty; each + 8 * stage
  const uint32_t bar_kf = bar_q + 8, bar_kr = bar_kf + 8 * kStages,
                 bar_ke = bar_kr + 8 * kStages, bar_vf = bar_ke + 8 * kStages,
                 bar_vr = bar_vf + 8 * kStages, bar_ve = bar_vr + 8 * kStages;

  const int bh = blockIdx.x / L::kSlices;
  const int c0 = (blockIdx.x % L::kSlices) * DV;   // the block's first column
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x / 32;

  // the KV tiles that meet the band of this query tile
  const int off = Tk - S;
  const int last = min(i0 + kBlockQ, S) - 1;
  const int kend = causal ? min(Tk, last + off + 1) : Tk;
  const int kbeg = window > 0 ? max(0, i0 + off - window + 1) : 0;
  const int t_lo = kbeg / kBlockK;
  const int t_hi = kend > kbeg ? (kend + kBlockK - 1) / kBlockK : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_kf + 8 * s, 1);
      mbar_init(bar_kr + 8 * s, kSplitters);
      mbar_init(bar_ke + 8 * s, kConsumers);
      mbar_init(bar_vf + 8 * s, 1);
      mbar_init(bar_vr + 8 * s, kSplitters);
      mbar_init(bar_ve + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                        // TMA, from one lane
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int p = 0; p < D / kPanel; ++p)
        tma_load(sQ + p * L::kQPanel, &tm_q, bar_q, p * kPanel, i0, bh);
      for (int t = t_lo; t < t_hi; ++t) {
        const int it = t - t_lo, s = it % kStages;
        const uint32_t st = sStage + s * L::kStage, reuse = (it / kStages - 1) & 1;
        if (it >= kStages) mbar_wait(bar_ke + 8 * s, reuse);
        mbar_expect_tx(bar_kf + 8 * s, L::kKTile);
        for (int p = 0; p < D / kPanel; ++p)
          tma_load(st + L::kK + p * L::kKPanel, &tm_k, bar_kf + 8 * s, p * kPanel,
                   t * kBlockK, kvh);
        if (it >= kStages) mbar_wait(bar_ve + 8 * s, reuse);
        mbar_expect_tx(bar_vf + 8 * s, L::kVTile);
        tma_load(st + L::kV, &tm_v, bar_vf + 8 * s, c0, t * kBlockK, kvh);
      }
    }
    return;
  }
  if (warp > 4) {                         // the splitters
    const int tid = threadIdx.x - 5 * 32;
    for (int t = t_lo; t < t_hi; ++t) {
      const int it = t - t_lo, s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      uint8_t* st = base_ptr + L::kStage0 + s * L::kStage;
      mbar_wait(bar_kf + 8 * s, parity);
      split_tile(st + L::kK, st + L::kKlo, L::kKTile, tid);
      fence_async_smem();
      mbar_arrive(bar_kr + 8 * s);
      mbar_wait(bar_vf + 8 * s, parity);
      split_v<DV, kBlockK>(reinterpret_cast<const float*>(st + L::kV),
                           st + L::kVhi, st + L::kVlo, tid);
      fence_async_smem();
      mbar_arrive(bar_vr + 8 * s);
    }
    return;
  }

  // a consumer: warp w holds query rows 16 w .. 16 w + 15 of the tile; this
  // thread holds rows r and r + 8 and, of each 8-column block, columns
  // 2 (lane % 4) and the next; of Q's 8-column steps it reads columns
  // lane % 4 and lane % 4 + 4 of rows r and r + 8 (the A fragment), word
  // lane % 4 of 16-byte chunk (2 e or 2 e + 1) ^ swz of a row's 64 bytes
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const int row = i0 + r0;
  const int qpos[2] = {row + off, row + 8 + off};
  const int col = 2 * (lane % 4);
  const int swz = (r0 >> 1) & 3;
  const float* q_words = reinterpret_cast<const float*>(base_ptr) + r0 * 16 + lane % 4;

  // O in 128-column chunks, each the accumulator of one m64n128k8
  float o[DV / 128][64];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < DV / 128; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[c][i] = 0.0f;
  mbar_wait(bar_q, 0);

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo, s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const uint32_t st = sStage + s * L::kStage;
    const int j0 = t * kBlockK;

    // S = Qlo Khi + Qhi Klo + Qhi Khi, kGroup 8-column steps of D at a
    // time, into four accumulators: the small terms and the large, the even
    // steps and the odd apart, so no accumulator takes more than D / 8 of
    // the sums (each wgmma rounds its sum into the accumulator) and four
    // products are in flight.  A wgmma reads its A registers until it is
    // waited for, so each group's products are waited for before the next
    // group's Q is split into registers.
    float small[2][kBlockK / 2], large[2][kBlockK / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i)
      small[0][i] = small[1][i] = large[0][i] = large[1][i] = 0.0f;
    mbar_wait(bar_kr + 8 * s, parity);
    for (int k0 = 0; k0 < D / 8; k0 += kGroup) {
      uint32_t hi[kGroup][4], lo[kGroup][4];
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        const int k8 = k0 + e;                       // columns 8 k8 ..
        const float* qp = q_words + (k8 / 2) * (L::kQPanel / 4);
        const int w0 = ((2 * (k8 % 2)) ^ swz) * 4, w1 = ((2 * (k8 % 2) + 1) ^ swz) * 4;
        split(qp[w0], hi[e][0], lo[e][0]);          // row r, column c
        split(qp[128 + w0], hi[e][1], lo[e][1]);    // row r + 8
        split(qp[w1], hi[e][2], lo[e][2]);          // row r, column c + 4
        split(qp[128 + w1], hi[e][3], lo[e][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        const int k8 = k0 + e;
        const uint32_t kb = st + L::kK + (k8 / 2) * L::kKPanel + (k8 % 2) * 32;
        wgmma_rs(small[e % 2], lo[e], sw64_desc(kb));
        wgmma_rs(large[e % 2], hi[e], sw64_desc(kb));
        wgmma_rs(small[e % 2], hi[e], sw64_desc(kb + (L::kKlo - L::kK)));
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    float sc[kBlockK / 2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      fence_regs(small[e]);
      fence_regs(large[e]);
    }
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i)
      sc[i] = (small[0][i] + small[1][i]) + (large[0][i] + large[1][i]);
    mbar_arrive(bar_ke + 8 * s);

    const bool edge = j0 + kBlockK > Tk || (causal && j0 + kBlockK - 1 > i0 + off) ||
                      (window > 0 && j0 <= last + off - window);
    float corr[2];
    uint32_t phi[kBlockK / 8][4], plo[kBlockK / 8][4];
    softmax_tile<kBlockK>(sc, edge, j0, qpos, col, Tk, causal, window, scale_log2,
                          m, l, corr, phi, plo);
#pragma unroll
    for (int c = 0; c < DV / 128; ++c)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[c][i] *= corr[(i >> 1) & 1];

    // O += Plo Vhi + Phi Vlo + Phi Vhi over the tile's kBlockK / 8 steps, a
    // 128-column chunk (128 rows of V^T, 64 bytes each) at a time
    mbar_wait(bar_vr + 8 * s, parity);
#pragma unroll
    for (int c = 0; c < DV / 128; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint32_t vb = st + (term == 1 ? L::kVlo : L::kVhi);
#pragma unroll
      for (int c = 0; c < DV / 128; ++c)
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j)
          wgmma_rs(o[c], term == 0 ? plo[j] : phi[j],
                   sw64_desc(vb + c * 128 * 64 + (j / 2) * L::kVPanel + (j % 2) * 32));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DV / 128; ++c) fence_regs(o[c]);
    mbar_arrive(bar_ve + 8 * s);
  }

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= S) continue;
    float* dst = out + (static_cast<size_t>(bh) * S + r) * D + c0 + col;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const float* oc = o[n / 16];
      const int j = 4 * (n % 16) + 2 * h;
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(oc[j] / den[h],
                                                            oc[j + 1] / den[h]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over (D, rows, heads) f32, read in boxes of ``box_cols``
// columns x ``box_rows`` rows of one head: 16-column panels 64-byte
// swizzled, or whole rows unswizzled; reads past ``rows`` fill zeros.
bool make_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads,
              int box_cols, int box_rows, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(rows) * D * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Hkv, int S, int Tk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int kBlockK = Geometry<D>::kBlockK;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, S, B * H, kPanel, kBlockQ, true) ||
      !make_map(&tk, k, D, Tk, B * Hkv, kPanel, kBlockK, true) ||
      !make_map(&tv, v, D, Tk, B * Hkv, D, kBlockK, false))
    return kEncodeFailed;
  const size_t shmem = Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(B) * H, (S + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<D><<<grid, kThreads, shmem, stream>>>(
      tq, tk, tv, static_cast<float*>(out), H, Hkv, S, Tk, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch_slice(const void* q, const void* k, const void* v, void* out, int B,
                 int H, int Hkv, int S, int Tk, int causal, int window, float scale,
                 cudaStream_t stream) {
  using L = Slice<D, DV>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, S, B * H, kPanel, kBlockQ, true) ||
      !make_map(&tk, k, D, Tk, B * Hkv, kPanel, L::kBlockK, true) ||
      !make_map(&tv, v, D, Tk, B * Hkv, DV, L::kBlockK, false))
    return kEncodeFailed;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_slice_kernel<D, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a (head, column slice) pair per x, the slices of a head side by side
  const dim3 grid(static_cast<unsigned>(B) * H * L::kSlices, (S + kBlockQ - 1) / kBlockQ);
  flash_attention_slice_kernel<D, DV><<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<float*>(out), H, Hkv, S, Tk, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int H, int Hkv, int S,
                                      int Tk, int D, int causal, int window,
                                      float scale, cudaStream_t stream) {
  if (Hkv < 1 || H % Hkv != 0 ||
      (D != 64 && D != 80 && D != 128 && D != 256 && D != 384 && D != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (Tk == 0)        // no key: every row is 0 / max(0, 1e-30)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * H * S * D * sizeof(float), stream));
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, stream);
    case 80:
      return launch<80>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, stream);
    case 256:
      return launch_slice<256, 256>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale,
                               stream);
    case 384:
      return launch_slice<384, 128>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale,
                               stream);
    default:
      return launch_slice<512, 128>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale,
                               stream);
  }
}

extern "C" const char* kernels_error_string(int code) {
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
