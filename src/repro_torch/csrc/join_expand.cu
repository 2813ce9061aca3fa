// join_expand: merge-join Build-phase expansion (paper §3.2).
//
// Replaces the Pallas TPU kernel join_expand_pallas
// (src/repro/kernels/join_expand.py). For output slots [base, base+count) of
// a grouped cross product it writes the gather indices
//     li = lstarts[g] + w / rlens[g],   ri = rstarts[g] + w % rlens[g]
// where g is the group holding slot t (the last g with cum[g] <= t, so
// empty groups are skipped) and w = t - cum[g]. Slots before 0 or at or past
// cum[G] get -1 in both outputs. cum is the int64 offset array (cum[0] = 0).
// llens is not read: w < llens[g] * rlens[g], so w / rlens and w % rlens
// also cover the unit runs that the reference treats apart.
//
// What bounds it on the H100: latency. Each slot writes 8 bytes and reads a
// few bytes of group parameters; at the main path's 4096-slot batches the
// chain of dependent round trips to L2 sets the time, not bytes. A binary
// search per thread over cum in global memory is a chain of log2(G)
// dependent loads (16 at 40,000 groups): about 4 us a launch on an H100
// (PERF.md, the kernel table's row 1).
//
// Design: a block covers a tile of TILE = THREADS * ITEMS consecutive slots.
//   1. Both ends of the tile's group range are found by one search each,
//      warp 0 and warp 1 at once: every round the warp loads 64 evenly
//      spaced cum entries inside the current interval and counts its votes
//      with ballots, so a round narrows the interval 65-fold (three rounds
//      at 40,000 groups). A warp of scattered loads is cheaper than a block
//      of them, and needs no block barrier. g_lo is the last g with cum[g]
//      <= the tile's first valid slot, g_hi the first g with cum[g] >= the
//      tile's end. cum[G] is loaded beside the searches.
//   2. Every non-empty group g in (g_lo, g_hi) starts inside the tile: it
//      writes its start position cum[g] - tile_start, and its rlens,
//      lstarts and rstarts, at that position of shared-memory arrays; the
//      first valid position holds g_lo's. Distinct non-empty groups start at
//      distinct slots, so each position has at most one writer and no
//      atomics are needed. Empty groups (equal cum entries, in runs of any
//      length, at a tile's first slot too) are read and never written. The
//      parameters are loaded beside cum, so this is one round trip.
//   3. An inclusive max-scan of the start positions (ITEMS consecutive
//      slots per thread, a warp shuffle scan, one exchange of warp totals)
//      gives every slot the start of its group, i.e. the group
//      searchsorted(cum, t, right=True) - 1, whose parameters it reads from
//      shared memory: no global load after step 2.
//   4. Each slot divides its w by its group's rlens in 32 bits (in 64 only
//      when w passes 2^31); the slots of a thread are independent, so their
//      shared-memory reads and arithmetic overlap.
//   5. The (li, ri) pairs go through shared memory once more, so that each
//      warp stores 32 consecutive slots: 128 contiguous bytes per store.
// Two shapes are compiled, and the wrapper picks one from count: the
// per-slot work of a 4096-slot batch is too much for one SM, so up to
// 65,536 slots 64-slot tiles are fastest (a batch spreads over many
// blocks, each of which runs its own two searches at once); from 131,072
// slots the searches of so many blocks cost more than they spread, and
// 2,048-slot tiles are fastest (PERF.md's sweep, kernel_sweep.py).
// The shared arrays are padded by one word per 32 slots, so the blocked
// (ITEMS consecutive per thread) and striped accesses are both free of bank
// conflicts. cum and slot numbers stay int64 (totals beyond 2^31 work);
// positions inside a tile are int32.

#include <cuda_runtime.h>

namespace {

constexpr int PROBES = 64;  // cum entries a searching warp loads per round
// the two compiled shapes (see above)
constexpr int THREADS_SMALL = 64, TILE_SMALL = 64;
constexpr int THREADS_LARGE = 256, TILE_LARGE = 2048;

__device__ __forceinline__ int pad(int pos) { return pos + (pos >> 5); }

// Interior position k of the open interval (lo, hi) for PROBES probes, or
// -1 when probe k has none this round. Positions increase with k, so the
// votes of a monotone predicate are a prefix of the probes. Group indices
// fit in 32 bits (G is an int), so only the product is wide.
__device__ __forceinline__ int probe_pos(int lo, int hi, int k) {
  const int n = hi - lo - 1;
  if (n <= PROBES) return k < n ? lo + 1 + k : -1;
  return lo + 1 + (int)(((unsigned long long)k * (unsigned)n) / PROBES);
}

// The warp's search of cum[0..G] for x, with cum[0] < x (or <= x when
// le) and cum[G] >= x (or > x): with le, the last index i with cum[i] <= x;
// else the first index i with cum[i] >= x. Lane l probes l, l + 32, ...
__device__ int warp_search(const long long* __restrict__ cum, int G, long long x, bool le) {
  constexpr int PER_LANE = PROBES / 32;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    long long c[PER_LANE];
    bool on[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int p = probe_pos(lo, hi, i * 32 + lane);
      on[i] = p >= 0;
      c[i] = on[i] ? cum[p] : 0;
    }
    int votes = 0;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      votes += __popc(__ballot_sync(0xffffffffu, on[i] && (le ? c[i] <= x : c[i] < x)));
    const int n = hi - lo - 1;
    const int active = n < PROBES ? n : PROBES;
    const int new_lo = votes > 0 ? probe_pos(lo, hi, votes - 1) : lo;
    const int new_hi = votes < active ? probe_pos(lo, hi, votes) : hi;
    lo = new_lo;
    hi = new_hi;
  }
  return le ? lo : hi;
}

template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
join_expand_kernel(const int* __restrict__ lstarts, const int* __restrict__ rstarts,
                   const int* __restrict__ rlens, const long long* __restrict__ cum, int G,
                   long long base, long long count, int* __restrict__ li,
                   int* __restrict__ ri) {
  static_assert(THREADS >= 64, "two warps search");
  constexpr int TILE = THREADS * ITEMS;
  constexpr int PADDED = TILE + TILE / 32;
  constexpr int WARPS = THREADS / 32;
  // start positions and three group parameters; in step 5 the first two
  // arrays hold li and ri
  extern __shared__ int smem[];
  int* s_start = smem;
  int* s_rl = smem + PADDED;
  int* s_ls = smem + 2 * PADDED;
  int* s_rs = smem + 3 * PADDED;
  __shared__ int warp_max[WARPS];
  __shared__ int g_lo, g_hi;
  __shared__ long long w_first;  // w of the tile's first valid slot

  const int tid = threadIdx.x;
  const long long j0 = (long long)blockIdx.x * TILE;
  const long long t0 = base + j0;  // the tile's first slot
  const int len = (int)(count - j0 < TILE ? count - j0 : TILE);
  const int v_lo = (int)min((long long)len, max(0LL, -t0));
  const long long x_lo = t0 + v_lo;
  const long long total = cum[G];  // in flight during the searches
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) s_start[pad(k * THREADS + tid)] = -1;

  // 1. the two searches (for a tile with a valid slot, cum[0] = 0 <= x_lo
  // < total; a search of a tile without one ends all the same, unused)
  if (tid < 32) {
    const int g = warp_search(cum, G, x_lo, true);
    if (tid == 0) g_lo = g;
  } else if (tid < 64) {
    const int g = warp_search(cum, G, t0 + len, false);
    if (tid == 32) g_hi = g;
  }
  __syncthreads();
  const int v_hi = (int)min((long long)len, max(0LL, total - t0));
  if (v_lo >= v_hi) {  // no valid slot in the tile (G = 0 included)
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int pos = k * THREADS + tid;
      if (pos < len) li[j0 + pos] = ri[j0 + pos] = -1;
    }
    return;
  }
  const int lo = g_lo, hi = g_hi;

  // 2. the first group and the group starts, with their parameters
  if (tid == 0) {
    const int p = pad(v_lo);
    s_start[p] = v_lo;
    s_rl[p] = rlens[lo];
    s_ls[p] = lstarts[lo];
    s_rs[p] = rstarts[lo];
    w_first = x_lo - cum[lo];
  }
  for (int g = lo + 1 + tid; g < hi; g += THREADS) {
    const long long c0 = cum[g], c1 = cum[g + 1];
    const int rl = rlens[g], ls = lstarts[g], rs = rstarts[g];
    if (c1 > c0) {
      const int pos = (int)(c0 - t0);
      const int p = pad(pos);
      s_start[p] = pos;
      s_rl[p] = rl;
      s_ls[p] = ls;
      s_rs[p] = rs;
    }
  }
  __syncthreads();

  // 3. inclusive max-scan of the start positions
  int start[ITEMS];
  int m = -1;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    m = max(m, s_start[pad(tid * ITEMS + k)]);
    start[k] = m;
  }
  const int lane = tid & 31, warp = tid >> 5;
  int x = m;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = max(x, y);
  }
  int carry = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) carry = -1;
  if (lane == 31) warp_max[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) carry = max(carry, warp_max[w]);

  // 4. every slot on its own: w from its group's start, then the division
  int out_l[ITEMS], out_r[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int pos = tid * ITEMS + k;
    const int p = max(carry, start[k]);
    const int pp = pad(max(p, v_lo));
    const int r = max(s_rl[pp], 1);
    const long long w = (long long)(pos - p) + (p == v_lo ? w_first : 0LL);
    int a, b;
    if (w < 2147483648LL) {
      const unsigned n = (unsigned)w;
      a = (int)(n / (unsigned)r);
      b = (int)n - a * r;
    } else {
      a = (int)(w / r);
      b = (int)(w - (long long)a * r);
    }
    const bool valid = pos >= v_lo && pos < v_hi;
    out_l[k] = valid ? s_ls[pp] + a : -1;
    out_r[k] = valid ? s_rs[pp] + b : -1;
  }
  __syncthreads();

  // 5. through shared memory to striped, coalesced stores
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    s_start[pad(tid * ITEMS + k)] = out_l[k];
    s_rl[pad(tid * ITEMS + k)] = out_r[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int pos = k * THREADS + tid;
    if (pos < len) {
      li[j0 + pos] = s_start[pad(pos)];
      ri[j0 + pos] = s_rl[pad(pos)];
    }
  }
}

template <int THREADS, int TILE>
int launch(const int* lstarts, const int* rstarts, const int* rlens, const long long* cum,
           int G, long long base, long long count, int* li, int* ri, cudaStream_t st) {
  constexpr int SMEM = 4 * (TILE + TILE / 32) * (int)sizeof(int);
  static bool sized = false;  // above 48 KB a kernel must ask for its shared memory
  if (SMEM > 48 * 1024 && !sized) {
    const cudaError_t e = cudaFuncSetAttribute(join_expand_kernel<THREADS, TILE / THREADS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  join_expand_kernel<THREADS, TILE / THREADS>
      <<<(unsigned int)((count + TILE - 1) / TILE), THREADS, SMEM, st>>>(
          lstarts, rstarts, rlens, cum, G, base, count, li, ri);
  return (int)cudaGetLastError();
}

}  // namespace

// tile: TILE_SMALL or TILE_LARGE, which the wrapper picks from count; any
// other value returns cudaErrorInvalidValue without launching. llens is
// part of the contract and not read (see above).
extern "C" int join_expand_launch(const int* lstarts, const int* llens,
                                  const int* rstarts, const int* rlens,
                                  const long long* cum, int G, long long base,
                                  long long count, int* li, int* ri, int tile,
                                  void* stream) {
  (void)llens;
  if (count <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (tile == TILE_SMALL)
    return launch<THREADS_SMALL, TILE_SMALL>(lstarts, rstarts, rlens, cum, G, base, count, li,
                                             ri, st);
  if (tile == TILE_LARGE)
    return launch<THREADS_LARGE, TILE_LARGE>(lstarts, rstarts, rlens, cum, G, base, count, li,
                                             ri, st);
  return (int)cudaErrorInvalidValue;
}
