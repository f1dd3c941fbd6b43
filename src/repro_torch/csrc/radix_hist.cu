// Radix-histogram kernel for Hopper (sm_90a): Eq. 4's base-2 counters.
//
// Replaces the TPU kernel repro/kernels/radix_hist.py:radix_hist_pallas.
// Plain version: repro_torch/kernels/radix_hist.py:radix_hist_ref, which this
// kernel equals bit for bit (integer sums are order-free).
//
// For each vertex r and digit position k < K: digitsum[r, k], the sum of the
// base-2 digits (bias[r, s] >> k) & 1 over the slots s < deg[r], and
// gsize[r, k], the count of those digits that are nonzero.  In base 2 a digit
// is 0 or 1, so it is its own nonzero flag and the two tables are the same
// integers: the kernel counts once and writes the count to both.
//
// Design: a warp takes 32 consecutive rows, one coalesced load of their
// degrees.  A row of degree at most kShort is counted by its own lane from
// registers: its words arrive as 16-byte vectors when the rows are 16-byte
// aligned (C % 4 == 0), all issued together, and are added four at a time
// into six bit planes (bit k of plane i is bit i of digit k's count:
// carry-save adders count all 32 digit positions at once, add4, 3.5 logic
// ops a word), spread once into byte-packed counts (spread) and read out a
// byte a digit.  The rows longer than kShort go kGroup = 8 lanes a row,
// four rows a round, lowest lanes first: a lane loads every 8th 16-byte
// word of its group's row (a pass of 256 slots issued together), counts
// them the same way, and the group sums its byte counts in three butterfly
// steps that leave each lane four digits (reduce_group).  A warp whose 32
// rows are all hubs thus takes eight rounds, not 32 rows one after the
// other.  The warp's 32 x K counts are staged in shared memory,
// digit-major with a pitch of 33 words (the lanes' stores hit 32 banks),
// and written to both tables as 16-byte stores: the warp's rows are
// consecutive, so its 32 x K words of each table are one contiguous,
// 128-byte-aligned run.  kShort = 32, bit planes and the staged stores are
// what tools/walk_ab.py measured fastest on an H100 against 8 or 16 slots
// a lane, byte counters added a word at a time, a long row by the whole
// warp (a ballot a digit), a persistent grid and each lane storing its
// counts from registers (partial sectors: 1.5x slower); PERF.md.
//
// Bound on this card: bytes.  deg, the bias words below each degree and the
// two (V, K) outputs, each moved once, against 3.35 TB/s; at 2^20 rows and
// K = 16 the outputs are 134 MB of the 161 MB, so the store stream is the
// floor.  A short row's words are whole sectors of its own (rows are 1 KB
// apart at C = 256), so the reads move more than the bound counts: a sector
// of 32 bytes for every 8 words begun.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kShort = 32;          // rows of degree <= kShort: a lane each
constexpr int kVecs = kShort / 4;   // 16-byte loads of a short row, at most
constexpr int kGroup = 8;           // lanes a long row
constexpr int kPassVecs = 8;        // 16-byte words a lane loads a pass
constexpr int kPassWords = 4 * kGroup * kPassVecs;   // a long row's pass
static_assert(kGroup == 8, "reduce_group scatters 16 halves over 8 lanes");
constexpr int kPitch = kWarp + 1;   // staged words of one digit (32 rows + 1)

// Carry-save adder: a + b + c = 2 hi + lo, bit by bit (two logic ops).
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  hi = (a & b) | (u & c);
  lo = u ^ c;
}

// Four words' 32 base-2 digits added into bit-sliced counts: bit k of p[i]
// is bit i of digit k's count, so one logic op counts a digit position in
// all 32 at once.  Three carry-save adders and a ripple of the fours'
// carry through planes 2-5, 14 operations for the four words; six planes
// hold counts up to 63.
__device__ __forceinline__ void add4(uint32_t (&p)[6], uint32_t a, uint32_t b,
                                     uint32_t c, uint32_t d) {
  uint32_t twos_ab, twos_cd, fours;
  csa(twos_ab, p[0], p[0], a, b);
  csa(twos_cd, p[0], p[0], c, d);
  csa(fours, p[1], p[1], twos_ab, twos_cd);
#pragma unroll
  for (int i = 2; i < 6; ++i) {
    const uint32_t carry = p[i] & fours;
    p[i] ^= fours;
    fours = carry;
  }
}

// The bit-sliced counts as byte-packed ones: byte q of acc[j] is the count
// of digit 8q + j (bit i of it from bit 8q + j of p[i]; 48 shift-and-or
// pairs).
__device__ __forceinline__ void spread(const uint32_t (&p)[6],
                                       uint32_t (&acc)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t a = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      a |= (i >= j ? p[i] << (i - j) : p[i] >> (j - i)) & (0x01010101u << i);
    acc[j] = a;
  }
}

// The byte counters of a group's kGroup lanes summed, the sums
// scattered: acc's 32 digit bytes are widened to 16-bit halves (h[m] holds
// digits m and m + 16), then three butterfly steps each send half of the
// halves to the partner lane and add the half it keeps, so lane gl ends
// with h[2 gl] and h[2 gl + 1] of the group's sum, added into tot as
// digits 2 gl, 2 gl + 1, 2 gl + 16 and 2 gl + 17.  A byte holds at most
// kPassWords / kGroup = 32 counts, a half at most kPassWords.
__device__ __forceinline__ void reduce_group(const uint32_t (&acc)[8],
                                             uint32_t (&tot)[4], int gl) {
  uint32_t h[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = acc[j] & 0x00FF00FFu;                   // digits j, j + 16
    h[8 + j] = (acc[j] >> 8) & 0x00FF00FFu;        // digits j + 8, j + 24
  }
#pragma unroll
  for (int n = 16, s = kGroup / 2; s > 0; n /= 2, s /= 2) {
    const bool up = (gl & s) != 0;                 // keeps the upper half
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const uint32_t send = up ? h[i] : h[i + n / 2];
      const uint32_t keep = up ? h[i + n / 2] : h[i];
      h[i] = keep + __shfl_xor_sync(kFull, send, s);
    }
  }
  tot[0] += h[0] & 0xFFFFu;
  tot[1] += h[1] & 0xFFFFu;
  tot[2] += h[0] >> 16;
  tot[3] += h[1] >> 16;
}

// Word s of a row, 0 at or past the degree d.
__device__ __forceinline__ uint32_t masked(int word, int s, int d) {
  return s < d ? static_cast<uint32_t>(word) : 0u;
}

__device__ __forceinline__ uint32_t load_below(const int* row, int s, int d) {
  return s < d ? static_cast<uint32_t>(__ldcs(row + s)) : 0u;
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int* __restrict__ bias, const int* __restrict__ deg,
                  int* __restrict__ digitsum, int* __restrict__ gsize, int V,
                  int C, int K, int vec_in) {
  __shared__ int stage[kWarps][kWarp * kPitch];   // [digit][row], a warp each
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + w) * kWarp;
  if (row0 >= V) return;
  const int nrows = static_cast<int>(min(static_cast<long long>(kWarp), V - row0));
  int* st = stage[w];
  const int d = lane < nrows ? max(0, min(deg[row0 + lane], C)) : 0;
  const int* row = bias + static_cast<size_t>(row0 + lane) * C;

  // short rows: each lane its own, from registers
  const bool mine = d <= kShort;
  const int ds = mine ? d : 0;
  const int dmax = __reduce_max_sync(kFull, ds);
  uint32_t p[6] = {0, 0, 0, 0, 0, 0};
  if (vec_in) {
    int4 v[kVecs];
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      if (4 * q < dmax)
        v[q] = 4 * q < ds ? __ldcs(reinterpret_cast<const int4*>(row) + q)
                          : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      if (4 * q < dmax) add4(p, masked(v[q].x, 4 * q, ds),
                             masked(v[q].y, 4 * q + 1, ds),
                             masked(v[q].z, 4 * q + 2, ds),
                             masked(v[q].w, 4 * q + 3, ds));
  } else {
    for (int s = 0; s < dmax; s += 4)
      add4(p, load_below(row, s, ds), load_below(row, s + 1, ds),
           load_below(row, s + 2, ds), load_below(row, s + 3, ds));
  }
  if (mine) {
    uint32_t acc[8];
    spread(p, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (8 * q + j < K)
          st[(8 * q + j) * kPitch + lane] = (acc[j] >> (8 * q)) & 0xFF;
  }

  // long rows: kGroup lanes a row, kWarp / kGroup rows a round, lowest
  // lanes first; each lane counts every kGroup-th 16-byte word of its
  // group's row, then the group sums the counts (reduce_group)
  const int grp = lane / kGroup, gl = lane % kGroup;
  for (unsigned longs = __ballot_sync(kFull, !mine); longs != 0;) {
    int src = -1;
#pragma unroll
    for (int g = 0; g < kWarp / kGroup; ++g) {
      if (longs == 0) break;
      if (g == grp) src = __ffs(longs) - 1;
      longs &= longs - 1;
    }
    const int dg = __shfl_sync(kFull, d, src < 0 ? 0 : src) * (src >= 0);
    const int dmaxg = __reduce_max_sync(kFull, dg);
    const int* lrow = bias + static_cast<size_t>(row0 + max(src, 0)) * C;
    uint32_t tot[4] = {0, 0, 0, 0};
    for (int base = 0; base < dmaxg; base += kPassWords) {
      // lane gl: slots base + 32 i + 4 gl .. + 3 for i < kPassVecs
      uint32_t q[6] = {0, 0, 0, 0, 0, 0};
      if (vec_in) {
        int4 v[kPassVecs];
#pragma unroll
        for (int i = 0; i < kPassVecs; ++i) {
          const int s = base + 4 * (gl + kGroup * i);
          if (base + 4 * kGroup * i < dmaxg)
            v[i] = s < dg ? __ldcs(reinterpret_cast<const int4*>(lrow + s))
                          : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < kPassVecs; ++i) {
          const int s = base + 4 * (gl + kGroup * i);
          if (base + 4 * kGroup * i < dmaxg)
            add4(q, masked(v[i].x, s, dg), masked(v[i].y, s + 1, dg),
                 masked(v[i].z, s + 2, dg), masked(v[i].w, s + 3, dg));
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPassVecs; ++i) {
          const int s = base + 4 * (gl + kGroup * i);
          if (base + 4 * kGroup * i < dmaxg)
            add4(q, load_below(lrow, s, dg), load_below(lrow, s + 1, dg),
                 load_below(lrow, s + 2, dg), load_below(lrow, s + 3, dg));
        }
      }
      uint32_t part[8];
      spread(q, part);
      reduce_group(part, tot, gl);
    }
    if (src >= 0) {
      // lane gl holds digits 2 gl, 2 gl + 1, 2 gl + 16 and 2 gl + 17
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 2 * gl + (e & 1) + 16 * (e >> 1);
        if (k < K) st[k * kPitch + src] = static_cast<int>(tot[e]);
      }
    }
  }
  __syncwarp();

  // the warp's rows are one run of nrows * K words in each table, 16-byte
  // aligned: word i is (row i / K, digit i % K); lane l starts at 4l
  const int n = nrows * K;
  int* dsum = digitsum + row0 * K;
  int* gsz = gsize + row0 * K;
  int r = (4 * lane) / K, k = (4 * lane) % K;
  const int dr = (4 * kWarp) / K, dk = (4 * kWarp) % K;
  for (int i = 4 * lane; i + 3 < n; i += 4 * kWarp) {
    int x[4];
    int rr = r, kk = k;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = st[kk * kPitch + rr];
      if (++kk == K) {
        kk = 0;
        ++rr;
      }
    }
    const int4 v = make_int4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<int4*>(dsum + i) = v;
    *reinterpret_cast<int4*>(gsz + i) = v;
    r += dr;
    k += dk;
    if (k >= K) {
      k -= K;
      ++r;
    }
  }
  // the run's last n % 4 words
  for (int i = (n & ~3) + lane; i < n; i += kWarp) {
    const int x = st[(i % K) * kPitch + i / K];
    dsum[i] = x;
    gsz[i] = x;
  }
}

}  // namespace

extern "C" int radix_hist_launch(const int* bias, const int* deg, int* digitsum,
                                 int* gsize, int V, int C, int K,
                                 cudaStream_t stream) {
  if (K < 1 || K > kWarp) return static_cast<int>(cudaErrorInvalidValue);
  if (V > 0) {
    const int vec_in =
        C % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
    // the wrapper's outputs (torch.empty) start on 16 bytes: the stores
    // assume it
    if ((reinterpret_cast<uintptr_t>(digitsum) |
         reinterpret_cast<uintptr_t>(gsize)) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const long long warps = (static_cast<long long>(V) + kWarp - 1) / kWarp;
    const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
    radix_hist_kernel<<<blocks, kThreads, 0, stream>>>(
        bias, deg, digitsum, gsize, V, C, K, vec_in);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
