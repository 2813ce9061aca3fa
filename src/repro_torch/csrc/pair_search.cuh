// pair_search.cuh: a group-cooperative lower / upper bound over a sorted
// range of int32 pairs, shared by hash_probe.cu and frontier_dedup.cu.
//
// Rows (hi[r], lo[r]) order lexicographically as signed int32 values; a
// null hi column means every hi is 0 (single-int keys). A group is G
// consecutive lanes of one warp (G a power of two, 8 to 32) that search for
// the same key together. Every round each lane loads one evenly spaced
// pivot, so the G loads of a round are in flight at once, and a ballot over
// the group's lanes counts the pivots that order below the key (at or below
// it, for an upper bound). The pivots' votes are a prefix, so the count
// names the gap that holds the bound: a round narrows [a, b) (G + 1)-fold.
// Once b - a <= G a last round reads R * G rows from a in R coalesced
// loads of G consecutive rows.
//
// Every lane of the group must call these functions with the same
// arguments and the same mask, and none may return early: the ballots and
// shuffles name exactly the group's lanes.

#pragma once

#include <cuda_runtime.h>

namespace pair_search {

__device__ __forceinline__ bool pair_less(int ah, int al, int bh, int bl) {
  return ah < bh || (ah == bh && al < bl);
}

// the lanes of this thread's group of G, as a warp mask
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two up to 32");
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// Whether row r orders below the key, or at or below it when upper.
__device__ __forceinline__ bool row_before(const int* __restrict__ hi,
                                           const int* __restrict__ lo, int r, int kh,
                                           int kl, bool upper) {
  const int vh = hi ? hi[r] : 0;  // both loads issued before the compare
  const int vl = lo[r];
  return upper ? !pair_less(kh, kl, vh, vl) : pair_less(vh, vl, kh, kl);
}

// Narrow [a, b) by (G + 1)-ary rounds until b - a <= G, keeping the
// invariant: the rows before a are before the key, those from b on are not.
// Lane gl loads pivot a + (gl + 1) * (b - a) / (G + 1), formed in 64 bits (a
// partition may hold more than 2^31 / 33 rows).
template <int G>
__device__ __forceinline__ void narrow(const int* __restrict__ hi, const int* __restrict__ lo,
                                       int& a, int& b, int kh, int kl, bool upper,
                                       unsigned mask, int gl) {
  while (b - a > G) {
    const long long span = (long long)(b - a);
    const bool before = row_before(hi, lo, a + (int)(span * (gl + 1) / (G + 1)), kh, kl, upper);
    const int k = __popc(__ballot_sync(mask, before) & mask);
    // pivots k (the last before the key) and k + 1 bound the gap
    const int na = k > 0 ? a + (int)(span * k / (G + 1)) + 1 : a;
    const int nb = k < G ? a + (int)(span * (k + 1) / (G + 1)) : b;
    a = na;
    b = nb;
  }
}

// The bound after narrow(): the rows of [a, min(a + R * G, lim)) that order
// before the key, counted with R ballots (lane gl reads rows a + gl,
// a + G + gl, ...: R coalesced loads), plus a. lim >= b may reach past b
// (no row from b on is before the key); *equal, when given, receives the
// number of rows of that window equal to the key.
template <int G, int R>
__device__ __forceinline__ int last_round(const int* __restrict__ hi,
                                          const int* __restrict__ lo, int a, int lim, int kh,
                                          int kl, bool upper, unsigned mask, int gl,
                                          int* equal = nullptr) {
  bool before[R], same[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = a + q * G + gl;
    before[q] = same[q] = false;
    if (r < lim) {
      const int vh = hi ? hi[r] : 0;
      const int vl = lo[r];
      before[q] = upper ? !pair_less(kh, kl, vh, vl) : pair_less(vh, vl, kh, kl);
      same[q] = vh == kh && vl == kl;
    }
  }
  int k = 0, e = 0;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    k += __popc(__ballot_sync(mask, before[q]) & mask);
    if (equal) e += __popc(__ballot_sync(mask, same[q]) & mask);
  }
  if (equal) *equal = e;
  return a + k;
}

// The first row of [a, b) not before the key (b if none): the lower bound,
// or with upper the upper bound.
template <int G>
__device__ __forceinline__ int bound(const int* __restrict__ hi, const int* __restrict__ lo,
                                     int a, int b, int kh, int kl, bool upper, unsigned mask,
                                     int gl) {
  narrow<G>(hi, lo, a, b, kh, kl, upper, mask, gl);
  return last_round<G, 1>(hi, lo, a, b, kh, kl, upper, mask, gl);
}

}  // namespace pair_search
