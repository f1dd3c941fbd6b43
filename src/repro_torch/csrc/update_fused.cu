// Batched-update Bingo kernels for Hopper (sm_90a): one §5.2 round.
//
// Replaces the TPU kernel repro/kernels/update_fused.py:update_fused_pallas
// (its _kernel and _vose_rows) and the elementwise part of its ordering
// prepass.  Plain versions: repro_torch/kernels/update_fused.py:plan_round's
// torch ops for the three prep kernels, repro_torch/core/updates.py:
// batched_update for the round, which these kernels equal bit for bit for
// every batch and every state the engine can reach.
//
// A round is prep_lanes -> one torch sort -> first_flags -> torch cumsum
// -> prep_rows -> update_fused, all in stream order with no host sync:
//   prep_lanes_kernel   per lane: validity, one int64 sort key (vertex,
//                       then inserts before deletes, then an insert's lane
//                       index or a delete's value + 1; a lane that is
//                       neither sorts last as vertex V), the split bias,
//                       and the reject counts into the round's stats
//                       buffer.  Sorted, each vertex's lanes are one
//                       segment: its inserts in lane order, then its
//                       deletes by value (duplicates in lane order), the
//                       reference's two sorts' orders in one;
//   first_flags_kernel  per sorted key: 1 if it is the first of a vertex
//                       (their running count places each distinct vertex:
//                       U, compacted, without a second sort);
//   prep_rows_kernel    per sorted lane j and row r: an insert's payload
//                       gathered through the sort's order, a delete's value
//                       and duplicate rank from its key; row r's vertex
//                       U[r] (the key whose running count first reaches
//                       r + 1, by binary search; V past the last) and its
//                       insert and delete segments [lo, hi), by binary
//                       search, so a row may receive any number of lanes;
//   update_fused_kernel a persistent grid (as many blocks as fit the card),
//                       each warp taking U's rows in turn (an atomic row
//                       counter in the stats buffer) and staging a row in
//                       its own shared memory:
//     1. load nbr/bias (frac in fp mode) below the old degree;
//     2. append the inserts at deg + rank (lanes past capacity drop);
//     3. locate each delete as the (rank+1)-th match of its value in the
//        post-insert row (ballot + popc), marking a bit of the row's mask;
//     4. two-phase delete-and-swap (paper Fig. 10(b)): the j-th surviving
//        tail slot moves into the j-th front hole, ranks by prefix counts;
//     5. write the slots below the post-insert degree (the slots above
//        already hold -1 / 0 / +0.0: every build, round and streaming
//        delete keeps them so);
//     6. rebuild the groups: each lane takes its slot's bias word once a
//        32-slot tile, and a ballot and a warp reduce a group count and sum
//        the group, the counters of group k kept by lane k (and k - 32);
//        the Eq. 9 class (alpha*deg as a float32 product); the member list
//        compacted by prefix counts (DENSE groups empty in adaptive mode);
//        ginv in baseline mode below the post-insert degree;
//     7. wdec: 0 in integer mode (every frac is +0.0), in fp mode the
//        left-to-right sum over the slots below the new degree (the slots
//        above add +0.0 to a non-negative sum: no change);
//     8. the Kin-entry alias row, alias_row.cuh's warp-wide Vose row (the
//        one alias_build.cu runs), written once an entry;
//     9. the round's stats (inserts and deletes applied, the group-type
//        transitions) counted in shared memory, then one atomicAdd a
//        counter a block.
//
// Member lists: in baseline mode a group's list is exactly its gsize
// entries, then -1, in every reachable state, so the kernel writes -1 only
// up to the larger of the old and new sizes.  In adaptive mode a list is
// not determined by gsize and gtype: a streaming insert that makes a group
// DENSE leaves its old list in place, a DENSE group that a streaming delete
// empties keeps it (no rebuild on DENSE -> EMPTY), and a later streaming
// append writes over its first entries only, so a group of any type may
// hold stale entries anywhere below Cg.  The kernel writes all K x Cg list
// entries of the row there (16-byte stores of -1, then the members), as the
// plain version does.
//
// Bound on this card: bytes.  Per affected row the round must read deg and
// the nbr/bias (frac in fp mode) slots below the old degree, and write those
// below the larger of the old and new degree, each group's member list up to
// its kept length (ginv in baseline mode) and the O(K) counters and alias
// row, against 3.35 TB/s.  The kernel moves the row slots the bound counts,
// and in adaptive mode all K x Cg list entries (see above).
//
// Built with -fmad=false: the alias row's and the fp split's float
// arithmetic must not be contracted, so that they equal the plain version's.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "alias_row.cuh"

namespace {

using alias_row::kFull;
using alias_row::kMaxInter;
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;                 // rows a block
constexpr int kPrepThreads = 256;
constexpr int EMPTY = 0, DENSE = 1, ONE = 2, SPARSE = 3, REGULAR = 4;
// stats buffer: ins_applied, del_applied, transitions (5 x 5, old*5 + new),
// rejected (6 reasons); the reasons' order is core/updates.py's R_*
constexpr int kStats = 33;
constexpr int kTrans = 2, kRej = 27;
// after the stats: the next row to take and the blocks done (both zero
// before a launch and again after it: the last block out rewinds them)
constexpr int kNextRow = kStats, kBlocksDone = kStats + 1;
constexpr int R_VERTEX = 1, R_ABSENT = 3, R_CAPACITY = 4;

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

// 2^e as a float, exact for 0 <= e < 128 (a group's B^k, k * log2 B < 64)
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

template <typename T>
__device__ __forceinline__ int lower_bound(const T* a, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A lane's sort key: its vertex, then inserts before deletes, then the
// insert's lane index or the delete's value + 1 (vertex < 2^30).
constexpr int kVertexShift = 33;
__device__ __forceinline__ long long lane_key(long long vertex, bool del,
                                              long long low) {
  return (vertex << kVertexShift) | (static_cast<long long>(del) << 32) | low;
}

// Block sum of three per-thread counts, then one atomicAdd each.
__device__ __forceinline__ void block_add3(int a, int b, int c, int* dst_a,
                                           int* dst_b, int* dst_c) {
  __shared__ int s[3];
  if (threadIdx.x < 3) s[threadIdx.x] = 0;
  __syncthreads();
  a = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(a)));
  b = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(b)));
  c = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(c)));
  if ((threadIdx.x & (kWarp - 1)) == 0) {
    if (a) atomicAdd(&s[0], a);
    if (b) atomicAdd(&s[1], b);
    if (c) atomicAdd(&s[2], c);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s[0]) atomicAdd(dst_a, s[0]);
    if (s[1]) atomicAdd(dst_b, s[1]);
    if (s[2]) atomicAdd(dst_c, s[2]);
  }
}

__global__ void __launch_bounds__(kPrepThreads)
prep_lanes_kernel(const uint8_t* __restrict__ is_insert,
                  const int* __restrict__ u, const int* __restrict__ v,
                  const int* __restrict__ w_i, const float* __restrict__ w_f,
                  const uint8_t* __restrict__ active, int B, int V, float lam,
                  long long* __restrict__ key, int* __restrict__ w_int,
                  float* __restrict__ w_frac, int* __restrict__ stats) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  int n_vert = 0, n_ins = 0, n_del = 0;
  if (b < B) {
    const int uu = u[b], vv = v[b];
    const bool act = active == nullptr || active[b] != 0;
    const bool ok = uu >= 0 && uu < V && vv >= 0;
    const bool ins = is_insert[b] != 0 && act && ok;
    const bool del = is_insert[b] == 0 && act && ok;
    key[b] = ins || del ? lane_key(uu, del, del ? vv + 1LL : b)
                        : lane_key(V, false, b);
    if (w_f != nullptr) {                     // fp mode: radix.decompose_fp
      const float s = w_f[b] * lam;
      const float ip = floorf(s);
      w_int[b] = static_cast<int>(ip);
      w_frac[b] = s - ip;
    } else {
      w_int[b] = w_i[b];
      w_frac[b] = 0.0f;
    }
    n_vert = act && !ok;
    n_ins = ins;
    n_del = del;
  }
  block_add3(n_vert, n_ins, n_del, stats + kRej + R_VERTEX,
             stats + kRej + R_CAPACITY, stats + kRej + R_ABSENT);
}

__global__ void __launch_bounds__(kPrepThreads)
first_flags_kernel(const long long* __restrict__ key_s, int B, int V,
                   int* __restrict__ flags) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) {
    const long long x = key_s[b] >> kVertexShift;
    flags[b] = x < V && (b == 0 || x != key_s[b - 1] >> kVertexShift);
  }
}

__global__ void __launch_bounds__(kPrepThreads)
prep_rows_kernel(const long long* __restrict__ key_s,
                 const int* __restrict__ cum,
                 const long long* __restrict__ ord,
                 const int* __restrict__ v, const int* __restrict__ w_int,
                 const float* __restrict__ w_frac, int B, int V,
                 int* __restrict__ U, int* __restrict__ ins_lo,
                 int* __restrict__ ins_hi,
                 int* __restrict__ v_s, int* __restrict__ wi_s,
                 float* __restrict__ wf_s, int* __restrict__ del_lo,
                 int* __restrict__ del_hi, int* __restrict__ dv_s,
                 int* __restrict__ rank_d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  // lane j of the sorted order: an insert's payload, a delete's value and
  // duplicate rank (fill values elsewhere)
  const long long k = key_s[j];
  const bool real = (k >> kVertexShift) < V;
  const bool del = (k >> 32) & 1;
  const bool ins = real && !del;
  const long long o = ins ? ord[j] : 0;
  v_s[j] = ins ? v[o] : -1;
  wi_s[j] = ins ? w_int[o] : 0;
  wf_s[j] = ins ? w_frac[o] : 0.0f;
  dv_s[j] = real && del ? static_cast<int>((k & 0xFFFFFFFFLL) - 1) : -1;
  rank_d[j] = real && del ? j - lower_bound(key_s, B, k) : 0;
  // row j: the (j+1)-th distinct vertex, V past the last; its inserts
  // then its deletes, one segment of the sorted keys
  const int x = j < cum[B - 1]
      ? static_cast<int>(key_s[lower_bound(cum, B, j + 1)] >> kVertexShift)
      : V;
  U[j] = x;
  ins_lo[j] = lower_bound(key_s, B, lane_key(x, false, 0));
  ins_hi[j] = del_lo[j] = lower_bound(key_s, B, lane_key(x, true, 0));
  del_hi[j] = lower_bound(key_s, B, lane_key(x + 1, false, 0));
}

// Shared memory of one warp's row, in 32-bit words.
__host__ __device__ __forceinline__ int row_words(int C, int fp) {
  return (2 + fp) * C + (C + 31) / 32 + (C + 1) / 2;
}

// E: alias-row entries a lane (Kin > 32 takes two; then also K > 32 groups
// are kept two a lane).
template <int E>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
update_fused_kernel(const int* __restrict__ U, const int* __restrict__ ins_lo,
                    const int* __restrict__ ins_hi, const int* __restrict__ v_s,
                    const int* __restrict__ wi_s, const float* __restrict__ wf_s,
                    const int* __restrict__ del_lo, const int* __restrict__ del_hi,
                    const int* __restrict__ dv_s, const int* __restrict__ rank_d,
                    int* __restrict__ stats, int* __restrict__ nbr,
                    int* __restrict__ bias, float* __restrict__ frac,
                    int* __restrict__ deg, int* __restrict__ gmem,
                    int* __restrict__ ginv, int* __restrict__ gsize,
                    int* __restrict__ digitsum, float* __restrict__ wdec,
                    int8_t* __restrict__ gtype, float* __restrict__ prob,
                    int* __restrict__ alias, int B, int V, int C, int K,
                    int Cg, int Kin, int base_log2, int adaptive, int fp,
                    float alpha, float beta) {
  extern __shared__ int smem[];
  __shared__ int s_stats[kStats];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  for (int i = threadIdx.x; i < kStats; i += blockDim.x) s_stats[i] = 0;
  __syncthreads();

  while (true) {                              // a row a turn, to U's end
    int r = 0;
    if (lane == 0) r = atomicAdd(&stats[kNextRow], 1);
    r = __shfl_sync(kFull, r, 0);
    const int vtx = r < B ? U[r] : V;
    if (vtx >= V) break;                      // the sentinels follow

    int* s_nbr = smem + warp * row_words(C, fp);
    int* s_bias = s_nbr + C;
    float* s_frac = reinterpret_cast<float*>(s_bias + C);   // fp mode only
    unsigned* s_del = reinterpret_cast<unsigned*>(s_bias + (1 + fp) * C);
    short* s_hole = reinterpret_cast<short*>(s_del + (C + 31) / 32);
    const size_t row = static_cast<size_t>(vtx) * C;
    const int deg0 = deg[vtx];

    // 1. the live slots of the row
    for (int s = lane; s < deg0; s += kWarp) {
      s_nbr[s] = nbr[row + s];
      s_bias[s] = bias[row + s];
      if (fp) s_frac[s] = frac[row + s];
    }
    for (int i = lane; i < (C + 31) / 32; i += kWarp) s_del[i] = 0u;

    // 2. inserts at deg + rank
    const int ilo = ins_lo[r];
    const int nins = ins_hi[r] - ilo;
    for (int j = lane; j < nins && deg0 + j < C; j += kWarp) {
      s_nbr[deg0 + j] = v_s[ilo + j];
      s_bias[deg0 + j] = wi_s[ilo + j];
      if (fp) s_frac[deg0 + j] = wf_s[ilo + j];
    }
    const int d1 = min(deg0 + nins, C);
    __syncwarp();

    // 3. delete locate: the (rank+1)-th match in the post-insert row
    const int dlo = del_lo[r];
    const int ndel = del_hi[r] - dlo;
    int n_found = 0;
    for (int j = 0; j < ndel; ++j) {
      const int tv = dv_s[dlo + j];
      const int want = rank_d[dlo + j] + 1;
      int seen = 0;
      for (int base = 0; base < d1; base += kWarp) {
        const int s = base + lane;
        const bool m = s < d1 && s_nbr[s] == tv;
        const unsigned mask = __ballot_sync(kFull, m);
        const int c = __popc(mask);
        if (seen + c >= want) {
          const unsigned f = __ballot_sync(
              kFull, m && __popc(mask & lanemask_le(lane)) == want - seen);
          const int found = base + __ffs(f) - 1;
          if (lane == 0) s_del[found >> 5] |= 1u << (found & 31);
          ++n_found;
          break;
        }
        seen += c;
      }
    }
    __syncwarp();

    // 4. two-phase delete-and-swap (the found deletes marked distinct slots)
    const int front = d1 - n_found;
    int hb = 0;                               // phase 1: rank the front holes
    for (int base = 0; base < front; base += kWarp) {
      const int s = base + lane;
      const bool h = s < front && ((s_del[base >> 5] >> lane) & 1u);
      const unsigned mask = __ballot_sync(kFull, h);
      if (h) s_hole[hb + __popc(mask & lanemask_lt(lane))] = static_cast<short>(s);
      hb += __popc(mask);
    }
    __syncwarp();
    int sb = 0;                               // phase 2: surviving tail -> holes
    for (int base = front & ~(kWarp - 1); base < d1; base += kWarp) {
      const int s = base + lane;
      const bool st = s >= front && s < d1 && !((s_del[base >> 5] >> lane) & 1u);
      const unsigned mask = __ballot_sync(kFull, st);
      if (st) {
        const int tgt = s_hole[sb + __popc(mask & lanemask_lt(lane))];
        s_nbr[tgt] = s_nbr[s];
        s_bias[tgt] = s_bias[s];
        if (fp) s_frac[tgt] = s_frac[s];
      }
      sb += __popc(mask);
    }
    __syncwarp();

    // 5. write the slots below the post-insert degree
    for (int s = lane; s < d1; s += kWarp) {
      const bool keep = s < front;
      nbr[row + s] = keep ? s_nbr[s] : -1;
      bias[row + s] = keep ? s_bias[s] : 0;
      if (fp) frac[row + s] = keep ? s_frac[s] : 0.0f;
    }

    // 6. rebuild: counters of group k (and k + 32) in lane k
    const int dmask = (1 << base_log2) - 1;
    int cnt0 = 0, dsum0 = 0, cnt1 = 0, dsum1 = 0;
    for (int base = 0; base < front; base += kWarp) {
      const int s = base + lane;
      const int b = s < front ? s_bias[s] : 0;
      for (int k = 0; k < K; ++k) {
        const int dig = (b >> (k * base_log2)) & dmask;
        const int c = __popc(__ballot_sync(kFull, dig != 0));
        const int ds = static_cast<int>(
            __reduce_add_sync(kFull, static_cast<unsigned>(dig)));
        if (lane == k) { cnt0 += c; dsum0 += ds; }
        if (E == 2 && lane + 32 == k) { cnt1 += c; dsum1 += ds; }
      }
    }
    const bool has_ginv = ginv != nullptr;
    if (adaptive) {         // all of the row's list entries -1, then members
      int* g = gmem + static_cast<size_t>(vtx) * K * Cg;
      const int n = K * Cg;
      if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        int4* g4 = reinterpret_cast<int4*>(g);
        for (int i = lane; i < n / 4; i += kWarp)
          g4[i] = make_int4(-1, -1, -1, -1);
      } else {
        for (int i = lane; i < n; i += kWarp) g[i] = -1;
      }
      __syncwarp();
    }
    // group k's class, counters and list extent; the type transition
    // counted; returns the kept entries and (baseline mode) the entries
    // to write in keep/ext
    auto finish = [&](int k, int cnt, int dsum, int& keep, int& ext) {
      const size_t krow = static_cast<size_t>(vtx) * K + k;
      const int gt = classify(cnt, front, adaptive, alpha, beta);
      const int og = gtype[krow];
      keep = (adaptive && gt == DENSE) ? 0 : min(cnt, Cg);
      ext = adaptive ? 0 : max(min(gsize[krow], Cg), keep);
      if (og != gt) atomicAdd(&s_stats[kTrans + og * 5 + gt], 1);
      gsize[krow] = cnt;
      digitsum[krow] = dsum;
      gtype[krow] = static_cast<int8_t>(gt);
    };
    int keep0 = 0, ext0 = 0, keep1 = 0, ext1 = 0;
    if (lane < K) finish(lane, cnt0, dsum0, keep0, ext0);
    if (E == 2 && lane + 32 < K) finish(lane + 32, cnt1, dsum1, keep1, ext1);
    for (int k = 0; k < K; ++k) {
      const int src = k & (kWarp - 1);
      const int nk = __shfl_sync(kFull, k < 32 ? keep0 : keep1, src);
      const int ek = __shfl_sync(kFull, k < 32 ? ext0 : ext1, src);
      const size_t krow = static_cast<size_t>(vtx) * K + k;
      int* grow = gmem + krow * Cg;
      const int shift = k * base_log2;
      const int limit = has_ginv ? d1 : front;
      int pb = 0;
      for (int base = 0; base < limit && (has_ginv || pb < nk); base += kWarp) {
        const int s = base + lane;
        const int dig = s < front ? (s_bias[s] >> shift) & dmask : 0;
        const bool mem = dig != 0;
        const unsigned mask = __ballot_sync(kFull, mem);
        const int pos = pb + __popc(mask & lanemask_lt(lane));
        if (mem && pos < nk) grow[pos] = s;
        if (has_ginv && s < d1) ginv[krow * C + s] = mem ? pos : -1;
        pb += __popc(mask);
      }
      for (int p = nk + lane; p < ek; p += kWarp) grow[p] = -1;   // baseline
    }

    // 7. wdec
    float wd = 0.0f;
    if (fp) {
      if (lane == 0)
        for (int s = 0; s < front; ++s) wd = wd + s_frac[s];
      wd = __shfl_sync(kFull, wd, 0);
    }

    // 8. the alias row over K radix groups (+ the decimal group)
    float wv[E], pv[E];
    int av[E];
    wv[0] = lane < K ? static_cast<float>(dsum0) * pow2(lane * base_log2)
                     : (lane == K ? wd : 0.0f);
    if constexpr (E == 2)
      wv[1] = lane + 32 < K ? static_cast<float>(dsum1) *
                                  pow2((lane + 32) * base_log2)
                            : (lane + 32 == K ? wd : 0.0f);
    alias_row::vose_row<32, E>(wv, Kin, pv, av);
    const size_t arow = static_cast<size_t>(vtx) * Kin;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (lane + 32 * e < Kin) {
        prob[arow + lane + 32 * e] = pv[e];
        alias[arow + lane + 32 * e] = av[e];
      }
    }

    // 9. per-row counters and stats
    if (lane == 0) {
      deg[vtx] = front;
      wdec[vtx] = wd;
      const int applied = d1 - deg0;
      if (applied) {
        atomicAdd(&s_stats[0], applied);
        atomicAdd(&s_stats[kRej + R_CAPACITY], -applied);
      }
      if (n_found) {
        atomicAdd(&s_stats[1], n_found);
        atomicAdd(&s_stats[kRej + R_ABSENT], -n_found);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kStats; i += blockDim.x)
    if (s_stats[i]) atomicAdd(&stats[i], s_stats[i]);
  if (threadIdx.x == 0 &&          // every row taken: rewind for a relaunch
      atomicAdd(&stats[kBlocksDone], 1) == static_cast<int>(gridDim.x) - 1) {
    atomicExch(&stats[kNextRow], 0);
    atomicExch(&stats[kBlocksDone], 0);
  }
}

unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// Rows a block for capacity C: as many warps as fit 48 KB of shared
// memory, at most kMaxWarps; 0 if one row does not fit the card's opt-in
// maximum.
int rows_per_block(int C, int fp) {
  const size_t per = static_cast<size_t>(row_words(C, fp)) * sizeof(int);
  if (per * kMaxWarps <= 48 * 1024) return kMaxWarps;
  if (per <= 48 * 1024) return static_cast<int>((48 * 1024) / per);
  return per <= 227 * 1024 ? 1 : 0;
}

}  // namespace

// Lanes -> a sort key each and split biases; w_f non-null in fp mode (w_i
// ignored), active null for all lanes active.  Adds the reject counts to
// stats (kStats + 2 int32, zeroed by the caller; the last two are the
// round kernel's row counters).
extern "C" int update_prep_lanes_launch(
    const uint8_t* is_insert, const int* u, const int* v, const int* w_i,
    const float* w_f, const uint8_t* active, long long* key, int* w_int,
    float* w_frac, int* stats, int B, int V, float lam, cudaStream_t stream) {
  if (V >= (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0)
    prep_lanes_kernel<<<blocks_for(B, kPrepThreads), kPrepThreads, 0,
                        stream>>>(is_insert, u, v, w_i, w_f, active, B, V, lam,
                                  key, w_int, w_frac, stats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int update_first_flags_launch(const long long* key_s, int* flags,
                                         int B, int V, cudaStream_t stream) {
  if (B > 0)
    first_flags_kernel<<<blocks_for(B, kPrepThreads), kPrepThreads, 0,
                         stream>>>(key_s, B, V, flags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int update_prep_rows_launch(
    const long long* key_s, const int* cum, const long long* ord,
    const int* v, const int* w_int, const float* w_frac, int* U, int* ins_lo,
    int* ins_hi, int* v_s, int* wi_s, float* wf_s, int* del_lo, int* del_hi,
    int* dv_s, int* rank_d, int B, int V, cudaStream_t stream) {
  if (B > 0)
    prep_rows_kernel<<<blocks_for(B, kPrepThreads), kPrepThreads, 0,
                       stream>>>(key_s, cum, ord, v, w_int, w_frac, B, V, U,
                                 ins_lo, ins_hi, v_s, wi_s, wf_s, del_lo,
                                 del_hi, dv_s, rank_d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int update_fused_launch(
    const int* U, const int* ins_lo, const int* ins_hi, const int* v_s,
    const int* wi_s, const float* wf_s, const int* del_lo, const int* del_hi,
    const int* dv_s, const int* rank_d, int* stats, int* nbr, int* bias,
    float* frac, int* deg, int* gmem, int* ginv, int* gsize, int* digitsum,
    float* wdec, int8_t* gtype, float* prob, int* alias, int B, int V, int C,
    int K, int Cg, int Kin, int base_log2, int adaptive, int fp, float alpha,
    float beta, cudaStream_t stream) {
  if (Kin > kMaxInter || K > Kin || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = rows_per_block(C, fp);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = static_cast<size_t>(rows) * row_words(C, fp) * sizeof(int);
  auto kernel = Kin > 32 ? update_fused_kernel<2> : update_fused_kernel<1>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      rows * kWarp, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = std::min(blocks_for(B, rows),
                                 static_cast<unsigned>(std::max(1, per_sm * sms)));
  if (B > 0)
    kernel<<<grid, rows * kWarp, shmem, stream>>>(
        U, ins_lo, ins_hi, v_s, wi_s, wf_s, del_lo, del_hi, dv_s, rank_d,
        stats, nbr, bias, frac, deg, gmem, ginv, gsize, digitsum, wdec, gtype,
        prob, alias, B, V, C, K, Cg, Kin, base_log2, adaptive, fp, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
