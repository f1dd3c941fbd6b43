// Vose's alias construction for one weight row, run by a group of lanes,
// shared by update_fused.cu (the rebuild of each affected row of a round)
// and alias_build.cu (the batched build over every row of a table).
//
// The result is repro/core/alias.py:_build_row's, in its float order, which
// the plain version repro_torch/core/alias.py:build_alias follows: the row
// total summed left to right; scaled[j] = (w[j] * n) / max(total, 1e-30), or
// 0 when the total is not positive; then rounds, each retiring the first
// small entry s (not retired, scaled < 1) against the first large one l (not
// retired, scaled >= 1) with prob[s] = scaled[s], alias[s] = l and
// scaled[l] = scaled[l] + (scaled[s] - 1).  Entries never retired keep prob 1
// and alias j.  The serial loop runs n rounds; once a round finds no pair the
// later ones change nothing, so the loop here stops at that round.
//
// Layout: a group of G lanes (G = 4, 8, 16 or 32, aligned within the warp)
// owns one row of n <= G * E entries; lane i of the group holds entries
// i + e * G, e < E, in registers.  The total is a chain of n shuffles in the
// serial order, so its float adds are the serial loop's.  Two ballots an
// entry slot give the row's small and large sets as bit masks (bit j for
// entry j); a round then needs no vote: s and l are the masks' lowest bits,
// the same entries the serial scan picks, scaled[s] and scaled[l] come by
// two shuffles, and the masks change in registers (s leaves the small set;
// l leaves the large set once its scaled value is no longer >= 1 and joins
// the small set if it is < 1).  Every lane of the warp calls with the same
// n (the ballots and shuffles are warp-wide), every array is indexed by
// unrolled constants, so nothing lives in local memory.  Every source that
// includes this header is built with -fmad=false, so that no multiply and
// add are contracted and the tables equal the plain version's bit for bit.

#pragma once

#include <type_traits>

namespace alias_row {

constexpr int kMaxInter = 64;   // longest row: K radix groups + 1 decimal group
constexpr unsigned kFull = 0xFFFFFFFFu;

// This lane's group's bits of a warp-wide ballot.
template <int G>
__device__ __forceinline__ unsigned group_bits(unsigned ballot, int gbase) {
  return G == 32 ? ballot : (ballot >> gbase) & ((1u << (G & 31)) - 1u);
}

// Index of the lowest set bit of a non-zero mask.
__device__ __forceinline__ unsigned lowest(unsigned m) {
  return static_cast<unsigned>(__ffs(m) - 1);
}
__device__ __forceinline__ unsigned lowest(unsigned long long m) {
  return static_cast<unsigned>(__ffsll(static_cast<long long>(m)) - 1);
}

// Row of n entries; w[e] is this lane's entry i + e * G (entries past n are
// ignored).  Writes prob and alias of the same entries.
template <int G, int E>
__device__ __forceinline__ void vose_row(const float (&w)[E], int n,
                                         float (&prob)[E], int (&alias)[E]) {
  static_assert(G == 4 || G == 8 || G == 16 || G == 32, "G lanes a row");
  using Mask = std::conditional_t<(G * E > 32), unsigned long long, unsigned>;
  static_assert(G * E <= 64, "at most 64 entries a row");
  const int lane = threadIdx.x & 31;
  const int gi = lane & (G - 1);             // lane within the group
  const int gbase = lane - gi;               // first lane of the group
  // left-to-right total, each lane running the same chain of adds
  float total = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    for (int g = 0; g < G && e * G + g < n; ++g) {
      const float x = __shfl_sync(kFull, w[e], g, G);
      total = e == 0 && g == 0 ? x : total + x;
    }
  }
  const float nf = static_cast<float>(n);
  const float den = fmaxf(total, 1e-30f);
  float sc[E];
  Mask small = 0, large = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * G + gi;
    sc[e] = total > 0.0f ? (w[e] * nf) / den : 0.0f;
    prob[e] = 1.0f;
    alias[e] = j;
    const bool live = j < n;
    small |= static_cast<Mask>(group_bits<G>(
                 __ballot_sync(kFull, live && sc[e] < 1.0f), gbase))
             << (e * G);
    large |= static_cast<Mask>(group_bits<G>(
                 __ballot_sync(kFull, live && sc[e] >= 1.0f), gbase))
             << (e * G);
  }
  while (true) {
    const bool pair = small != 0 && large != 0;
    if (!__any_sync(kFull, pair)) break;     // every group of the warp is done
    const unsigned s = pair ? lowest(small) : 0u;
    const unsigned l = pair ? lowest(large) : 0u;
    const unsigned es = s / G, el = l / G;   // their slots, uniform in a group
    float vs = sc[0], vl = sc[0];            // this lane's value in those slots
#pragma unroll
    for (int e = 1; e < E; ++e) {
      vs = es == e ? sc[e] : vs;
      vl = el == e ? sc[e] : vl;
    }
    const float scs = __shfl_sync(kFull, vs, s % G, G);
    const float scl = __shfl_sync(kFull, vl, l % G, G);
    const float nl = scl + (scs - 1.0f);
    const bool is_s = pair && gi == s % G, is_l = pair && gi == l % G;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool hs = is_s && es == e, hl = is_l && el == e;
      prob[e] = hs ? scs : prob[e];
      alias[e] = hs ? static_cast<int>(l) : alias[e];
      sc[e] = hl ? nl : sc[e];
    }
    if (pair) {
      small &= small - 1;                    // s was its lowest bit
      if (!(nl >= 1.0f)) large &= large - 1; // l was its lowest bit
      if (nl < 1.0f) small |= static_cast<Mask>(1) << l;
    }
  }
}

}  // namespace alias_row
