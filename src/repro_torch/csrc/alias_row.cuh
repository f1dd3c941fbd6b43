// Vose's alias construction for one weight row, shared by update_fused.cu
// (the rebuild of each affected row of a round) and alias_build.cu (the
// batched build over every row of a table).
//
// The loop is repro/core/alias.py:_build_row's, in its float order, which the
// plain version repro_torch/core/alias.py:build_alias follows: the row total
// summed left to right; scaled[j] = (w[j] * n) / max(total, 1e-30), or 0 when
// the total is not positive; then n rounds, each retiring the first small
// entry s (scaled < 1) against the first large one l (scaled >= 1) with
// prob[s] = scaled[s], alias[s] = l and scaled[l] = scaled[l] + (scaled[s] - 1).
// Entries never retired keep prob 1 and alias j.  Every source that includes
// this header is built with -fmad=false, so that no multiply and add are
// contracted and the tables equal the plain version's bit for bit.

#pragma once

namespace alias_row {

constexpr int kMaxInter = 64;   // longest row: K radix groups + 1 decimal group

// w (n,) in, prob and alias (n,) out; n <= kMaxInter.  The pointers may be
// global or local memory; the loop reads w twice and writes prob and alias
// once per entry plus once per retired entry.
__device__ __forceinline__ void vose_row(const float* w, int n, float* prob,
                                         int* alias) {
  float sc[kMaxInter];
  bool done[kMaxInter];
  float total = w[0];
  for (int j = 1; j < n; ++j) total = total + w[j];
  for (int j = 0; j < n; ++j) {
    sc[j] = total > 0.0f ? (w[j] * static_cast<float>(n)) / fmaxf(total, 1e-30f)
                         : 0.0f;
    prob[j] = 1.0f;
    alias[j] = j;
    done[j] = false;
  }
  for (int it = 0; it < n; ++it) {
    int s = -1, l = -1;
    for (int j = 0; j < n; ++j) {
      if (done[j]) continue;
      if (sc[j] < 1.0f) {
        if (s < 0) s = j;
      } else if (l < 0) {
        l = j;
      }
    }
    if (s >= 0 && l >= 0) {
      prob[s] = sc[s];
      alias[s] = l;
      sc[l] = sc[l] + (sc[s] - 1.0f);
      done[s] = true;
    }
  }
}

}  // namespace alias_row
