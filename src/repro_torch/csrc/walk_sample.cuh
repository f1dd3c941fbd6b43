// The per-step Bingo sampler as warp-level device functions, shared by the
// whole-walk kernel (walk_fused.cu) and the per-step kernels (walk_sample.cu).
//
// Port of the in-register sampler repro/kernels/walk_sample.py:sample_rows /
// uniform_pick; plain version repro_torch/kernels/walk_sample.py, which these
// functions equal bit for bit.
//
// sample_row is called by all 32 lanes of a warp for one walker and returns
// the same Pick on every lane: the alias pick over the Kin inter-group lanes,
// then the chosen group's digits of bias[0:deg] in 32-lane chunks, members
// counted with __ballot_sync/__popc and the ceil(u2*|G|)-th member found from
// the popc prefix counts.  Bases > 2 add the digit acceptance coin and an
// exact integer-prefix ITS; the fp decimal group runs the ITS over frac in
// lane 0, left to right (the order the plain version spells out).
//
// Exactness: every float is an exact integer or a single IEEE rounding
// (u0*Kin, u2*gsize, u*deg, x01*total, u3*(B-1)); the integer ITS compares
// exact integer prefix sums; the fp ITS adds in lane order.  Sources that
// include this header are built with -fmad=false.

#pragma once

#include <cstdint>

namespace walk_sample {

constexpr int kWarp = 32;

struct Pick {
  int nxt;    // sampled neighbour, -1 on an empty sampling space
  int slot;   // its adjacency slot, -1 on an empty sampling space
  bool ok;
};

__device__ __forceinline__ unsigned lanemask_le(int lane) {
  return 0xFFFFFFFFu >> (31 - lane);
}

// Inclusive warp prefix sum.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int digit_of(const int* brow, int s, int d,
                                        int shift, int dmask) {
  return s < d ? (brow[s] >> shift) & dmask : 0;
}

// Two-stage sample from one row: prow/arow the Kin alias entries, brow/nrow
// the C-slot bias and neighbour row (frow the frac row when has_frac), d the
// degree, u0..u4 the walker's uniforms (u3, u4 read only for base > 2 or fp).
// Warp-uniform: every lane passes the same arguments and gets the same Pick.
__device__ __forceinline__ Pick sample_row(
    const float* prow, const int* arow, const int* brow, const int* nrow,
    const float* frow, int d, int C, int Kin, int base_log2, bool has_frac,
    float u0, float u1, float u2, float u3, float u4, int lane) {
  const int dmask = (1 << base_log2) - 1;
  const int num_radix = has_frac ? Kin - 1 : Kin;
  // stage (i): alias pick over the Kin lanes
  const int i = min(static_cast<int>(u0 * static_cast<float>(Kin)), Kin - 1);
  const float p = prow[i];
  const int a = arow[i];
  const int k = u1 < p ? i : a;
  const int kc = min(k, num_radix - 1);
  const bool is_dec = has_frac && k == num_radix;
  bool ok;
  int slot = 0;
  if (!is_dec) {
    // stage (ii): members of group kc, counted by ballot/popc
    const int shift = kc * base_log2;
    int gsize = 0;
    for (int base = 0; base < d; base += kWarp) {
      const int dig = digit_of(brow, base + lane, d, shift, dmask);
      gsize += __popc(__ballot_sync(0xFFFFFFFFu, dig != 0));
    }
    ok = gsize > 0;
    if (ok) {
      const int target =
          min(static_cast<int>(u2 * static_cast<float>(gsize)), gsize - 1) + 1;
      int seen = 0;
      for (int base = 0; base < d; base += kWarp) {
        const int dig = digit_of(brow, base + lane, d, shift, dmask);
        const unsigned m = __ballot_sync(0xFFFFFFFFu, dig != 0);
        const int c = __popc(m);
        if (seen + c >= target) {
          const int want = target - seen;
          const unsigned f = __ballot_sync(
              0xFFFFFFFFu, dig != 0 && __popc(m & lanemask_le(lane)) == want);
          slot = base + __ffs(f) - 1;
          break;
        }
        seen += c;
      }
      if (base_log2 > 1) {
        // digit-proportional acceptance, exact integer-prefix ITS fallback
        const int dig_c = digit_of(brow, slot, d, shift, dmask);
        const bool accept =
            u3 * static_cast<float>(dmask) < static_cast<float>(dig_c);
        if (!accept) {
          int total = 0;
          for (int base = 0; base < d; base += kWarp) {
            int dig = digit_of(brow, base + lane, d, shift, dmask);
            total += __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(dig));
          }
          const float x = u4 * static_cast<float>(total);
          int count = (static_cast<float>(total) <= x) ? C - d : 0;
          int off = 0;
          for (int base = 0; base < d; base += kWarp) {
            const int dig = digit_of(brow, base + lane, d, shift, dmask);
            const int c = off + warp_scan(dig, lane);
            count += __popc(__ballot_sync(
                0xFFFFFFFFu, base + lane < d && static_cast<float>(c) <= x));
            off = __shfl_sync(0xFFFFFFFFu, c, kWarp - 1);
          }
          slot = min(count, C - 1);
        }
      }
    }
  } else {
    // decimal group: ITS over the frac row, left to right in lane 0
    int sl = 0, okd = 0;
    if (lane == 0) {
      float total = d > 0 ? frow[0] : 0.0f;
      for (int j = 1; j < d; ++j) total = total + frow[j];
      const float x = u4 * total;
      float c = 0.0f;
      int count = 0;
      for (int j = 0; j < d; ++j) {
        c = j == 0 ? frow[0] : c + frow[j];
        count += c <= x;
      }
      if (d == 0) count += (0.0f <= x) ? C : 0;   // c stays 0 on every lane
      else if (total <= x) count += C - d;        // lanes past deg add 0
      sl = min(count, C - 1);
      okd = total > 0.0f;
    }
    slot = __shfl_sync(0xFFFFFFFFu, sl, 0);
    ok = __shfl_sync(0xFFFFFFFFu, okd, 0) != 0;
  }
  Pick r;
  r.ok = ok;
  r.slot = ok ? slot : -1;
  r.nxt = ok ? nrow[slot] : -1;
  return r;
}

// Degree-based unbiased pick: slot = min(floor(u2*deg), deg-1).  One thread.
__device__ __forceinline__ Pick uniform_row(const int* nrow, int d, float u2) {
  Pick r;
  r.ok = d > 0;
  r.slot = r.ok ? min(static_cast<int>(u2 * static_cast<float>(d)), d - 1) : -1;
  r.nxt = r.ok ? nrow[r.slot] : -1;
  return r;
}

}  // namespace walk_sample
