// Flash-attention forward on Hopper's tensor cores (sm_90a), bfloat16 and
// float16.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (causal, sliding-window or non-causal GQA attention
// with an online softmax) for 16-bit inputs; float32 inputs go to
// csrc/flash_attention.cu.  Plain version:
// repro_torch/kernels/flash_attention.py:flash_attention_ref on bfloat16 or
// float16 tensors (``_plain16``), which rounds where this kernel rounds: the
// scores are float32 sums of 16-bit products, p = exp2(s * scale * log2(e) -
// m) in float32, l sums the float32 p, P is rounded to the input's type
// before P V, and P V accumulates in float32, over KV tiles of kBlockK keys.
// The two differ in the order of the float32 sums only.
//
// q (B, H, S, D), k and v (B, Hkv, T, D), all bfloat16 or all float16; out
// (B, H, S, D) in their type; D in {64, 128, 256, 384, 512}; H a multiple of
// Hkv.
// Query row i sits at position qpos = i + T - S; key kpos is seen when
// kpos < T, kpos <= qpos (causal) and kpos > qpos - window (window > 0).
//
// Design.  One block per (b * H + h, slice of DV output columns, 128-row
// query tile), heaviest tiles first: two consumer warpgroups of 64 query rows each and one producer
// warpgroup, which hands its registers to the consumers (setmaxnreg: 40
// a thread there, 232 in a consumer).  The producer's first thread loads
// the query tile once and streams K
// and V tiles of kBlockK x D through a ring of kStages stages with TMA
// (cp.async.bulk.tensor, 3-D maps over (D, T, B * Hkv), so a ragged tail
// reads zeros and never the next head), 128-byte swizzled in 64-column
// panels; each stage has a K barrier, a V barrier and an "empty" barrier
// that every consumer thread arrives on once it is done with the stage.
// A consumer warpgroup computes S = Q K^T over the whole of D with wgmma
// m64n{kBlockK}k16 (Q and K read from shared memory, K-major, a 64-column
// panel at a time), keeps S in registers, applies
// the mask only on tiles that cross the band's edge or T, runs the online
// softmax in the exp2 domain with the scale folded into the exponent (q is
// never rounded after scaling), rounds P to the input's type in registers
// (the accumulator's fragment is the A operand's register fragment) and
// accumulates O += P V with wgmma m64nNk16 over 128-column (or 64-column)
// chunks of its DV columns, V read from shared memory MN-major through the
// transpose bit.  m and l stay in registers; l is the sum of the float32 p.  The
// epilogue writes acc / max(l, 1e-30) for rows < S.  KV tiles wholly
// outside the causal/window band are skipped, which is exact (see
// csrc/flash_attention.cu).
//
// Past D = 256 the output columns are split over blocks (DV = D / 2: 192
// at 384, 256 at 512): a 64 x DV float32 O accumulator takes DV / 2
// registers a consumer thread, and 64 x 384 (192 registers) beside S and P
// would not fit the 232 a consumer has.  Each block of a (head, query tile)
// computes the same S over the whole of D and accumulates P V over its own
// columns only, so S is computed D / DV = 2 times: 6 D FLOPs a (query, key)
// pair against the 4 D of the function.  (The other design, one block whose
// two warpgroups each own half of O's columns and share P through shared
// memory, computes S once, but its 64 query rows a block would halve the
// reuse of every K and V tile, and the two warpgroups would wait on each
// other every tile.)
//
// Shared memory (227 KB, 232,448 bytes, a block at most): Q 128 x D x 2
// bytes; a stage holds a K tile of kBlockK x D and a V tile of kBlockK x DV,
// 2 bytes each.  D <= 128: kBlockK 128, 2 stages (D = 128: 32 + 2 x 64 =
// 160 KB).  D = 256: kBlockK 64, 2 stages: 64 + 2 x 64 = 192 KB (128 keys
// would need 64 + 2 x 128); S is then m64n64k16 (32 registers a thread)
// beside the 64 x 256 float32 O accumulator of each warpgroup (128
// registers a thread).  D = 512: Q alone is 128 KB, so kBlockK 32: a stage
// is 32 KB of K and 16 KB of V, and 128 + 2 x 48 = 224 KB (229,376 bytes,
// 230,456 with the barriers and the 1,024-byte alignment); 64 keys would
// need 128 + 2 x 96.  D = 384: kBlockK 32, 96 + 2 x 36 = 168 KB.  S is
// m64n32k16 there (16 registers a thread).
//
// Bound on this card: operations, 4 D FLOPs per unmasked (query, key) pair
// at the dense 16-bit tensor-core rate.  What this first tensor-core
// version leaves: each warpgroup waits for its own S product before the
// softmax and for P V before the next tile (no ping-pong between the two
// warpgroups, no overlap of softmax and wgmma inside one), and blocks are
// not persistent.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 128;              // query rows per block
constexpr int kStages = 2;                // K/V ring depth
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 128; // and the producer warpgroup
// Registers a thread after setmaxnreg: the producer warpgroup gives up
// what the consumers take (2 x 128 x 232 + 128 x 40 = 64,512 of the SM's
// 65,536); at launch every thread has 168 (65,536 / 384, rounded down to
// 8), too few for D = 256's 128 O registers beside S and P
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPanel = 64;                // 16-bit columns of a 128-byte panel
constexpr float kNegInf = -1e30f;
constexpr int kEncodeFailed = -1;         // returned when a tensor map fails

// D: the head dim, the depth of S; DV: the output columns of one block.
template <int D, int DV>
struct Smem {
  static_assert(D % DV == 0 && DV % kPanel == 0 && DV <= 256, "column slices");
  static constexpr int kBlockK = D > 256 ? 32 : D > 128 ? 64 : 128;  // keys a tile
  static constexpr int kPanels = D / kPanel;          // of Q and of K
  static constexpr int kVPanels = DV / kPanel;        // of V: the block's columns
  static constexpr int kQPanel = kBlockQ * 128;       // bytes of a Q panel
  static constexpr int kKPanel = kBlockK * 128;       // bytes of a K or V panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKTile = kPanels * kKPanel;    // one K tile
  static constexpr int kVTile = kVPanels * kKPanel;   // one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBar = kV + kStages * kVTile;
  // barriers: Q, K full x kStages, V full x kStages, empty x kStages; and
  // room to round the dynamic base up to 1024 bytes (the swizzle's period)
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
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

// wgmma descriptor of a 128-byte swizzled operand: start address, leading
// byte offset (the next 64-column panel of an MN-major operand), stride byte
// offset (the next group of 8 rows), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"
#define R64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"

// The wgmma instructions of one 16-bit input type (``TY``: "bf16.bf16" or
// "f16.f16").
#define FLASH_WGMMA(NAME, TY)                                                  \
  struct NAME {                                                                \
    /* S (64 x 128, f32) (+)= A (64 x 16) B (16 x 128): A and B from shared    \
       memory, both K-major; the sum starts from zero unless accumulate */    \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,     \
                                              uint64_t db, int accumulate) {   \
      asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"         \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY " " R64   \
                   ", %64, %65, p, 1, 1, 0, 0;\n\t}"                            \
                   : D64                                                       \
                   : "l"(da), "l"(db), "r"(accumulate));                       \
    }                                                                          \
    /* S (64 x 64) (+)= A (64 x 16) B (16 x 64), as above */                   \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,     \
                                              uint64_t db, int accumulate) {   \
      asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"         \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY " " R32    \
                   ", %32, %33, p, 1, 1, 0, 0;\n\t}"                            \
                   : D32                                                       \
                   : "l"(da), "l"(db), "r"(accumulate));                       \
    }                                                                          \
    /* S (64 x 32) (+)= A (64 x 16) B (16 x 32), as above */                   \
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,     \
                                              uint64_t db, int accumulate) {   \
      asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"         \
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY " " R16    \
                   ", %16, %17, p, 1, 1, 0, 0;\n\t}"                            \
                   : D16                                                       \
                   : "l"(da), "l"(db), "r"(accumulate));                       \
    }                                                                          \
    /* O (64 x 128, f32) += A (64 x 16, registers) B (16 x 128): B from        \
       shared memory, MN-major (the transpose bit) */                          \
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a, \
                                              uint64_t db) {                   \
      asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"         \
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY " " R64   \
                   ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"              \
                   : D64                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                     "r"(1));                                                  \
    }                                                                          \
    /* O (64 x 64) += A (64 x 16) B (16 x 64), as above */                     \
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, \
                                              uint64_t db) {                   \
      asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"         \
                   "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY " " R32    \
                   ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"              \
                   : D32                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                     "r"(1));                                                  \
    }                                                                          \
  };

FLASH_WGMMA(WgmmaBf16, "bf16.bf16")
FLASH_WGMMA(WgmmaF16, "f16.f16")
#undef FLASH_WGMMA

#undef D8
#undef D16
#undef D32
#undef D64
#undef R16
#undef R32
#undef R64

// What differs between the two 16-bit types: the wgmma type, the tensor
// map's element type and the rounding of two floats into one 32-bit word.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using Mma = WgmmaBf16;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Elem<__half> {
  using Mma = WgmmaF16;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            T* __restrict__ out, int H, int Hkv, int S, int Tk,
                            int causal, int window, float scale_log2) {
  using L = Smem<D, DV>;
  using Mma = typename Elem<T>::Mma;
  constexpr int kBlockK = L::kBlockK;
  // O columns of one P V wgmma
  constexpr int kChunk = DV < 128 ? DV : DV % 128 == 0 ? 128 : 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages,
                 bar_e = bar_v + 8 * kStages;     // + 8 * stage

  const int bh = blockIdx.x / (D / DV);
  const int c0 = (blockIdx.x % (D / DV)) * DV;   // the block's first column
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
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(sQ + p * L::kQPanel, &tm_q, bar_q, p * kPanel, i0, bh);
      for (int t = t_lo; t < t_hi; ++t) {
        const int it = t - t_lo, s = it % kStages;
        if (it >= kStages) mbar_wait(bar_e + 8 * s, (it / kStages - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, L::kKTile);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sK + s * L::kKTile + p * L::kKPanel, &tm_k, bar_k + 8 * s,
                   p * kPanel, t * kBlockK, kvh);
        mbar_expect_tx(bar_v + 8 * s, L::kVTile);
        for (int p = 0; p < L::kVPanels; ++p)
          tma_load(sV + s * L::kVTile + p * L::kKPanel, &tm_v, bar_v + 8 * s,
                   c0 + p * kPanel, t * kBlockK, kvh);
      }
    }
    return;
  }

  // a consumer: warpgroup wg holds query rows 64 wg .. 64 wg + 63 of the tile;
  // this thread holds rows r and r + 8 and, of each 8-column block, columns
  // 2 (lane % 4) and the next
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int lane = threadIdx.x % 32;
  const int row = i0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int qpos[2] = {row + off, row + 8 + off};
  const int col = 2 * (lane % 4);
  const uint32_t q_rows = sQ + wg * 64 * 128;

  // O in chunks of kChunk columns: chunk c is the accumulator of the c-th
  // P V wgmma, and its fragment order is that of one m64n{DV}k16 accumulator
  float o[DV / kChunk][kChunk / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < DV / kChunk; ++c)
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) o[c][i] = 0.0f;

  mbar_wait(bar_q, 0);
  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo, s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int j0 = t * kBlockK;

    // S = Q K^T over D / 16 steps of 16
    float sc[kBlockK / 2];
    mbar_wait(bar_k + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;   // 16 columns into the panel
      const uint64_t da = sw128_desc(q_rows + (kk / 4) * L::kQPanel + step, 16, 1024);
      const uint64_t db =
          sw128_desc(sK + s * L::kKTile + (kk / 4) * L::kKPanel + step, 16, 1024);
      Mma::ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale into the exp2 domain; mask only a tile that crosses the band's
    // edge or the end of the keys
    const bool edge = j0 + kBlockK > Tk || (causal && j0 + kBlockK - 1 > i0 + off) ||
                      (window > 0 && j0 <= last + off - window);
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
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = exp2f(m[h] - mn);
      m[h] = mn;
    }
    uint32_t pa[kBlockK / 4];   // P in T: the A fragments of the P V steps
#pragma unroll
    for (int i = 0; i < kBlockK / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - m[h]);
      const float p1 = exp2f(sc[i + 1] - m[h]);
      psum[h] += p0 + p1;
      pa[i / 2] = Elem<T>::pack(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
#pragma unroll
    for (int c = 0; c < DV / kChunk; ++c)
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) o[c][i] *= corr[(i >> 1) & 1];

    // O += P V over kBlockK / 16 steps of 16 keys, a chunk of D at a time
    mbar_wait(bar_v + 8 * s, parity);
#pragma unroll
    for (int c = 0; c < DV / kChunk; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DV / kChunk; ++c)
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint64_t db = sw128_desc(sV + s * L::kVTile +
                                           c * (kChunk / kPanel) * L::kKPanel +
                                           kk * 16 * 128,
                                       L::kKPanel, 1024);
        Mma::rs(o[c], pa + 4 * kk, db);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DV / kChunk; ++c) fence_regs(o[c]);
    mbar_arrive(bar_e + 8 * s);
  }

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) den[h] = fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= S) continue;
    T* dst = out + (static_cast<size_t>(bh) * S + r) * D + c0 + col;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int c = n / (kChunk / 8), j = 4 * (n % (kChunk / 8)) + 2 * h;
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          Elem<T>::pack(o[c][j] / den[h], o[c][j + 1] / den[h]);
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

// A 3-D map over (D, rows, heads) of 16-bit ``type``, read in boxes of 64
// columns x ``box_rows`` rows of one head, 128-byte swizzled; reads past
// ``rows`` fill zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int D,
              int rows, int heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kPanel),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H,
           int Hkv, int S, int Tk, int causal, int window, float scale_log2,
           cudaStream_t stream) {
  constexpr CUtensorMapDataType type = Elem<T>::kMap;
  constexpr int kBlockK = Smem<D, DV>::kBlockK;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, type, q, D, S, B * H, kBlockQ) ||
      !make_map(&tk, type, k, D, Tk, B * Hkv, kBlockK) ||
      !make_map(&tv, type, v, D, Tk, B * Hkv, kBlockK))
    return kEncodeFailed;
  const size_t shmem = Smem<D, DV>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_sm90_kernel<T, D, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // a (head, column slice) pair per x, the slices of a head side by side
  const dim3 grid(static_cast<unsigned>(B) * H * (D / DV),
                  (S + kBlockQ - 1) / kBlockQ);
  flash_attention_sm90_kernel<T, D, DV><<<grid, kThreads, shmem, stream>>>(
      tq, tk, tv, static_cast<T*>(out), H, Hkv, S, Tk, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, void* out, int B,
                 int H, int Hkv, int S, int Tk, int D, int causal, int window,
                 float scale_log2, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64, 64>(q, k, v, out, B, H, Hkv, S, Tk, causal, window,
                               scale_log2, stream);
    case 128:
      return launch<T, 128, 128>(q, k, v, out, B, H, Hkv, S, Tk, causal, window,
                                 scale_log2, stream);
    case 256:
      return launch<T, 256, 256>(q, k, v, out, B, H, Hkv, S, Tk, causal, window,
                                 scale_log2, stream);
    case 384:
      return launch<T, 384, 192>(q, k, v, out, B, H, Hkv, S, Tk, causal, window,
                                 scale_log2, stream);
    default:
      return launch<T, 512, 256>(q, k, v, out, B, H, Hkv, S, Tk, causal, window,
                                 scale_log2, stream);
  }
}

}  // namespace

// ``f16``: the tensors are float16 (else bfloat16).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out, int B, int H,
                                           int Hkv, int S, int Tk, int D, int f16,
                                           int causal, int window,
                                           float scale_log2, cudaStream_t stream) {
  if (Hkv < 1 || H % Hkv != 0 ||
      (D != 64 && D != 128 && D != 256 && D != 384 && D != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  if (Tk == 0)        // no key: every row is 0 / max(0, 1e-30)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(B) * H * S * D * 2, stream));
  return f16 ? launch_width<__half>(q, k, v, out, B, H, Hkv, S, Tk, D, causal,
                                    window, scale_log2, stream)
             : launch_width<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, Tk, D,
                                           causal, window, scale_log2, stream);
}

extern "C" const char* kernels_error_string(int code) {
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
