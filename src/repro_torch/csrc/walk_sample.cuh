// The per-step Bingo sampler as tile-level device functions, shared by the
// whole-walk kernel (walk_fused.cu) and the per-step kernels (walk_sample.cu).
//
// Port of the in-register sampler repro/kernels/walk_sample.py:sample_rows /
// uniform_pick; plain version repro_torch/kernels/walk_sample.py, which these
// functions equal bit for bit.
//
// Design (Hopper, for the latency of a chain of dependent loads).  A walker
// is sampled by a tile of kTile = 8 lanes, so a warp carries four walkers,
// each tile at its own walker and step.  A lane holds a row 16 bytes (four
// slots) at a time: chunk j of lane l is slots 4(j*kTile + l) .. + 3, so
// chunk 0 of the tile is the row's first 32 slots, its first tile.
// sample_tile issues every load that depends only on the row together, as
// soon as the row is known: deg[r], the alias entry prob/alias[r, i] (i
// comes from u0, which needs no load) and the first tile of bias[r] and
// nbr[r] (the row has C slots, so these are in bounds; they are masked by
// deg afterwards).  Once deg is known, the rest of a row of up to kWin =
// 256 slots loads at once, up to seven more chunks a lane.  The words stay
// in registers: each is ranked once, its group digit one bit of the lane's
// membership mask; the group size, the target member and its slot come
// from the masks' popcounts (per-chunk counts packed one byte a chunk, one
// prefix sum over the tile), and the acceptance coin and the integer ITS
// read the same registers.  The picked neighbour comes from the staged
// nbr words by a shuffle when its slot is below 32, else by one load.  So
// a row of at most 32 slots costs one round trip to memory, and a row of
// up to 256 slots two (three when the pick lies past slot 31 of the nbr
// row).  Rows past 256 slots (a capacity above the main path's) rank
// window by window and re-read their words.  Loops over a row run to the
// warp's largest degree, so every lane takes part in every ballot and
// shuffle.  The geometry (8 lanes, a 32-slot first tile of bias and nbr,
// registers, no register cap) is the fastest that tools/walk_ab.py
// measured on an H100 against 16 lanes, smaller first tiles and no nbr
// prefetch; with the previous step body, cp.async staging into shared
// memory and register caps were slower too (PERF.md).
//
// The fp decimal group runs its ITS over frac in the tile's first lane,
// left to right (the order the plain version spells out).
//
// Exactness: every float is an exact integer or a single IEEE rounding
// (u0*Kin, u2*gsize, u*deg, x01*total, u3*(B-1)); the member pick counts
// bits (order-free); the integer ITS compares exact integer prefix sums; the
// fp ITS adds in slot order.  So the tile width and the order of the loads
// cannot change a result.  Sources that include this header are built with
// -fmad=false.

#pragma once

#include <cstdint>

namespace walk_sample {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTile = 8;                // lanes a walker of the biased sampler
constexpr int kBlock = 256;             // threads a block
constexpr int kWin = 256;               // slots of a row ranked per window

struct Pick {
  int nxt;    // sampled neighbour, -1 on an empty sampling space
  int slot;   // its adjacency slot, -1 on an empty sampling space
  bool ok;
};

// A tile of T lanes of a warp.  Every collective runs over the full warp
// (all lanes converged); a tile reads its own bits and lanes.
template <int T>
struct Tile {
  int l;      // lane within the tile
  int base;   // the tile's first lane in the warp
  __device__ explicit Tile(int lane) : l(lane & (T - 1)), base(lane & ~(T - 1)) {}
  // the tile's T bits of a warp ballot
  __device__ unsigned bits(unsigned ballot) const {
    return T == 32 ? ballot : (ballot >> base) & ((1u << T) - 1u);
  }
  template <class X>
  __device__ X bcast(X v, int src) const {
    return __shfl_sync(kFull, v, base + src);
  }
  __device__ int sum(int v) const {
#pragma unroll
    for (int o = T / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, T);
    return v;
  }
  // inclusive prefix sum over the tile
  template <class X>
  __device__ X scan(X x) const {
#pragma unroll
    for (int o = 1; o < T; o <<= 1) {
      const X y = __shfl_up_sync(kFull, x, o, T);
      if (l >= o) x += y;
    }
    return x;
  }
};

// Position of the n-th set bit (1-based n, 1 <= n <= popc(x)) of x.
__device__ __forceinline__ int nth_set(unsigned x, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(x & ((1u << s) - 1u));
    if (n > c) {
      n -= c;
      x >>= s;
      pos += s;
    }
  }
  return pos;
}

// Words p[0..3] (n of them real, the rest 0), one 16-byte load when vec.
__device__ __forceinline__ int4 load4(const int* p, bool vec, int n) {
  if (vec) return *reinterpret_cast<const int4*>(p);
  int4 v = make_int4(0, 0, 0, 0);
  if (n > 0) v.x = p[0];
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}

// Word c (0..3) of v.
__device__ __forceinline__ int word(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Two-stage sample of row r by a T-lane tile: prob/alias the (., Kin) alias
// tables, bias/nbr the (., C) rows (frac when has_frac), deg the degrees;
// u0..u4 the walker's uniforms (u3, u4 read only for base > 2 or fp).
// in_flight() runs while the row's first loads are in flight (the
// caller's next loads or hash).  Every lane of the warp calls it; a tile
// with active false loads nothing and gets an empty Pick.  Returns the Pick
// on every lane of the tile, and the row's degree in d.
//
// Lane l holds Q = kWin / (4T) chunks of a window: chunk j is the four
// slots from 4(j*T + l), loaded 16 bytes at a time when C is a multiple of
// 4.  Bit 4j + c of the lane's mask is slot 4(j*T + l) + c.  In slot order
// the chunks run j by j, lane by lane, so the group's members before a
// lane's chunk j are the tile's members in chunks j' < j plus those of
// chunk j in lanes below: one byte a chunk, summed over the tile at once.
template <int T, class F>
__device__ __forceinline__ Pick sample_tile(
    const Tile<T>& tl, bool active, long long r, const float* prob,
    const int* alias, const int* bias, const int* nbr, const float* frac,
    const int* deg, int C, int Kin, int base_log2, bool has_frac, float u0,
    float u1, float u2, float u3, float u4, F&& in_flight, int& d) {
  constexpr int Q = kWin / (4 * T);
  constexpr int kHead = 4 * T;          // the first tile: chunk 0 of window 0
  static_assert(Q >= 1 && Q <= 8 && kHead < 256,
                "a chunk's member count and its tile prefix fit in a byte");
  using Packed = long long;             // one byte a chunk
  const int l = tl.l;
  const int dmask = (1 << base_log2) - 1;
  const int num_radix = has_frac ? Kin - 1 : Kin;
  const int* brow = bias + r * C;
  const int* nrow = nbr + r * C;
  // rows 16-byte aligned: a chunk is one load
  const bool vec = (C & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(bias) |
                     reinterpret_cast<uintptr_t>(nbr)) & 15) == 0;
  auto slot_of = [&](int wb, int j) { return wb + 4 * (j * T + l); };

  // every load that depends only on the row, issued together: the degree,
  // the alias entry (i comes from u0) and the first tile of bias and nbr
  const int i = min(static_cast<int>(u0 * static_cast<float>(Kin)), Kin - 1);
  float p = 0.0f;
  int a = 0;
  int4 bh = make_int4(0, 0, 0, 0), nh = make_int4(0, 0, 0, 0);
  d = 0;
  if (active) {
    d = deg[r];
    p = prob[r * Kin + i];
    a = alias[r * Kin + i];
    const int s = slot_of(0, 0);
    if (s < C) {
      bh = load4(brow + s, vec, C - s);
      nh = load4(nrow + s, vec, C - s);
    }
  }
  in_flight();
  // stage (i): alias pick over the Kin lanes
  const int k = u1 < p ? i : a;
  const int kc = min(k, num_radix - 1);
  const bool is_dec = active && has_frac && k == num_radix;
  const int shift = kc * base_log2;
  const unsigned gbits = static_cast<unsigned>(dmask) << shift;  // its digit
  const int dm = active && !is_dec ? d : 0;       // slots this tile ranks
  const int dmax = __reduce_max_sync(kFull, dm);

  // this lane's chunks of window wb below dm (the first tile is staged)
  int4 w[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) w[j] = make_int4(0, 0, 0, 0);
  auto load_window = [&](int wb) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int s = slot_of(wb, j);
      if (wb == 0 && j == 0) w[0] = bh;
      else w[j] = s < dm ? load4(brow + s, vec, dm - s) : make_int4(0, 0, 0, 0);
    }
  };
  // stage (ii): rank window wb into this lane's membership mask m, the
  // tile's inclusive prefix of its per-chunk counts (incl) and their totals
  // (tot), one byte a chunk
  struct Ranked {
    unsigned m;
    Packed incl, tot;
  };
  auto ranked = [&](int wb) {
    load_window(wb);
    Ranked x{0u, 0, 0};
    Packed counts = 0;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (slot_of(wb, j) + c < dm &&
            (static_cast<unsigned>(word(w[j], c)) & gbits))
          x.m |= 1u << (4 * j + c);
      counts |= static_cast<Packed>(__popc((x.m >> (4 * j)) & 0xFu)) << (8 * j);
    }
    x.incl = tl.scan(counts);
    x.tot = tl.bcast(x.incl, T - 1);
    return x;
  };
  auto members = [](Packed tot) {
    int n = 0;
#pragma unroll
    for (int j = 0; j < Q; ++j) n += static_cast<int>((tot >> (8 * j)) & 0xFF);
    return n;
  };

  Ranked rk{0u, 0, 0};
  int gsize = 0;
  for (int wb = 0; wb < dmax; wb += kWin) {
    rk = ranked(wb);
    gsize += members(rk.tot);
  }
  bool ok = gsize > 0;
  const int target =
      min(static_cast<int>(u2 * static_cast<float>(gsize)), gsize - 1) + 1;
  int wbase = 0, want = target;
  if (dmax > kWin) {         // rows past one window: rank the target's again
    int seen = 0;
    bool found = false;
    for (int wb = 0; wb < dmax; wb += kWin) {
      const Ranked x = ranked(wb);
      const int c = members(x.tot);
      if (!found && seen + c >= target) {
        found = true;
        wbase = wb;
        want = target - seen;
        rk = x;
      }
      seen += c;
    }
  }
  // the target's chunk (the same on every lane of the tile), its lane, its bit
  int jt = Q - 1;
  {
    int seen = 0, before = 0;
    bool found = false;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int c = static_cast<int>((rk.tot >> (8 * j)) & 0xFF);
      if (!found && seen + c >= want) {
        found = true;
        jt = j;
        before = seen;
      }
      seen += c;
    }
    want -= before;
  }
  const unsigned mj = (rk.m >> (4 * jt)) & 0xFu;
  const int incl = static_cast<int>((rk.incl >> (8 * jt)) & 0xFF);
  const int excl = incl - __popc(mj);
  const unsigned hit = tl.bits(__ballot_sync(kFull, excl < want && incl >= want));
  const int src = hit ? __ffs(hit) - 1 : 0;
  const unsigned ms = tl.bcast(mj, src);
  const int wn = want - tl.bcast(excl, src);
  const int pos = hit ? nth_set(ms, wn) : 0;
  int slot = wbase + 4 * (jt * T + src) + pos;

  if (base_log2 > 1) {
    // digit-proportional acceptance, exact integer-prefix ITS fallback; the
    // words of a row of one window are still in registers
    int4 wt = w[0];
#pragma unroll
    for (int j = 1; j < Q; ++j)
      if (j == jt) wt = w[j];
    int bw = tl.bcast(word(wt, pos), src);
    if (dmax > kWin) bw = ok ? brow[slot] : 0;
    const int dig_c = (bw >> shift) & dmask;
    const bool its = ok && !(u3 * static_cast<float>(dmask) <
                             static_cast<float>(dig_c));
    if (__any_sync(kFull, its)) {
      const int dits = its ? d : 0;
      const int imax = __reduce_max_sync(kFull, dits);
      auto digit = [&](int wb, int j, int c) {
        return slot_of(wb, j) + c < dits ? (word(w[j], c) >> shift) & dmask : 0;
      };
      int total = 0;
      for (int wb = 0; wb < imax; wb += kWin) {
        if (dmax > kWin) load_window(wb);
#pragma unroll
        for (int j = 0; j < Q; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) total += digit(wb, j, c);
      }
      total = tl.sum(total);
      const float x = u4 * static_cast<float>(total);
      // slots below dits whose inclusive digit prefix is at most x
      int below = 0, off = 0;
      for (int wb = 0; wb < imax; wb += kWin) {
        if (dmax > kWin) load_window(wb);
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          int dg[4], sum = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dg[c] = digit(wb, j, c);
            sum += dg[c];
          }
          const int inc = tl.scan(sum);
          int cum = off + inc - sum;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            cum += dg[c];
            below += slot_of(wb, j) + c < dits && static_cast<float>(cum) <= x;
          }
          off += tl.bcast(inc, T - 1);
        }
      }
      const int cnt = tl.sum(below) +
                      ((static_cast<float>(total) <= x) ? C - d : 0);
      if (its) slot = min(cnt, C - 1);
    }
  }
  if (has_frac) {
    // decimal group: ITS over the frac row, left to right in lane 0
    int sl = 0, okd = 0;
    if (is_dec && l == 0) {
      const float* frow = frac + r * C;
      float total = d > 0 ? frow[0] : 0.0f;
      for (int j = 1; j < d; ++j) total = total + frow[j];
      const float x = u4 * total;
      float c = 0.0f;
      int cnt = 0;
      for (int j = 0; j < d; ++j) {
        c = j == 0 ? frow[0] : c + frow[j];
        cnt += c <= x;
      }
      if (d == 0) cnt += (0.0f <= x) ? C : 0;     // c stays 0 on every lane
      else if (total <= x) cnt += C - d;          // lanes past deg add 0
      sl = min(cnt, C - 1);
      okd = total > 0.0f;
    }
    sl = tl.bcast(sl, 0);
    okd = tl.bcast(okd, 0);
    if (is_dec) {
      slot = sl;
      ok = okd != 0;
    }
  }
  // the neighbour: from the staged first tile by a shuffle, else one load
  int nxt = tl.bcast(word(nh, slot & 3), (slot >> 2) & (T - 1));
  if (ok && slot >= kHead) nxt = nrow[slot];
  Pick res;
  res.ok = ok;
  res.slot = ok ? slot : -1;
  res.nxt = ok ? nxt : -1;
  return res;
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
