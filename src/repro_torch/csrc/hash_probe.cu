// hash_probe: locate each probe key's match run in the hash join's
// radix-partitioned build layout.
//
// Replaces the Pallas TPU kernel hash_probe_pallas
// (src/repro/kernels/hash_join.py). The build keys (hi, lo) are grouped by
// partition id and sorted by key inside each partition; part_starts[p] is
// the first row of partition p. For probe key (qhi, qlo) of partition q
// the kernel writes
//     lo = number of build rows ordering below (q, qhi, qlo)
//     hi = number of build rows ordering at or below it
// so rows [lo, hi) carry exactly that key. The probe's partition id is
// computed here, as the build's were: mix = qlo, or for pair keys
// qlo ^ (qhi * 0x85EBCA6B) with INT32_MIN mapped to 0; then
// q = ((uint32(mix) * 0x9E3779B1) >> 16) & (P - 1).
//
// What bounds it on the H100: memory latency, not bytes. Each probe reads
// its key and writes two ints (16 bytes with a pair key); what sets the
// time is the chain of dependent L2 round trips. One thread per key, with a
// binary search for each bound, made about 26 of them for a 4096-key probe
// of a 3.9M-row build in 1024 partitions (two part_starts loads and two
// searches of about 12 steps), and its 16 blocks left most SMs idle.
//
// Design: a group of G lanes per probe key (G a power of two from 8 to 32;
// the library compiles GROUP, which kernel_sweep.py chose from G = 8, 16
// and 32 built from this source), 256 / G keys a block, so a 4096-key batch
// fills 4096 * G / 256 blocks.
//   1. Every lane loads the key (one broadcast load), and lanes 0 and 1 of
//      the group load part_starts[q] and part_starts[q + 1] (one sector),
//      which a shuffle hands to the group.
//   2. The lower bound by pair_search::narrow: (G + 1)-ary rounds of G
//      pivot loads in flight at once, until at most G rows are left
//      (3,800 rows: two rounds at G = 16).
//   3. One last round reads 2G rows from there in two coalesced loads,
//      clipped at the partition's end: a ballot of "below the key" gives
//      lo, a ballot of "equal to the key" the run's length. The window
//      holds at least G rows from lo, so only a run of G or more rows that
//      fills it goes on to a k-ary upper-bound search of [start + 2G, end).
//   4. Lanes 0 and 1 write lo and hi.
// About 5 dependent round trips instead of 26; each round touches G sectors
// instead of one, which a latency-bound kernel can afford at the engine's
// batches of at most 4,096 keys (at 65,536 keys and more the one-thread
// kernel's fewer sectors win: PERF.md). Rows of lower partitions all come
// first, so these positions equal the TPU kernel's counts exactly. The TPU
// kernel avoided gathers by comparing every probe with every build row in
// VMEM tiles, O(C * N) work; the searches are O(C * G * log(N / P) /
// log(G + 1)).

#include <cuda_runtime.h>

#include "pair_search.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 16;  // lanes per probe key

template <int G>
__global__ void __launch_bounds__(THREADS)
hash_probe_kernel(const int* __restrict__ part_starts, int n_parts,
                  const int* __restrict__ shi, const int* __restrict__ slo,
                  const int* __restrict__ qhi, const int* __restrict__ qlo, int c,
                  int* __restrict__ lo_out, int* __restrict__ hi_out) {
  constexpr int KEYS = THREADS / G;
  constexpr int WINDOW = 2 * G;  // the last round's rows: G to search, G more of the run
  const unsigned mask = pair_search::group_mask<G>();
  const int gl = threadIdx.x & (G - 1);
  const long long key = (long long)blockIdx.x * KEYS + threadIdx.x / G;
  // a group past the batch's end searches for the last key and writes
  // nothing: its lanes take part in every ballot and shuffle like the rest
  const bool valid = key < c;
  const int i = valid ? (int)key : c - 1;
  const int ql = qlo[i];
  const int qh = qhi ? qhi[i] : 0;
  unsigned mix = (unsigned)ql;
  if (qhi) {
    mix ^= (unsigned)qh * 0x85EBCA6Bu;
    if (mix == 0x80000000u) mix = 0u;
  }
  const int p = (int)(((mix * 0x9E3779B1u) >> 16) & (unsigned)(n_parts - 1));
  const int ps = part_starts[p + (gl & 1)];
  int a = __shfl_sync(mask, ps, 0, G);
  const int end = __shfl_sync(mask, ps, 1, G);
  int b = end;
  pair_search::narrow<G>(shi, slo, a, b, qh, ql, false, mask, gl);
  int run;
  const int lo = pair_search::last_round<G, 2>(shi, slo, a, end, qh, ql, false, mask, gl, &run);
  int hi = lo + run;
  if (hi == a + WINDOW && hi < end) {
    // the run fills the window: its end lies in [a + WINDOW, end]
    int ua = a + WINDOW, ub = end;
    pair_search::narrow<G>(shi, slo, ua, ub, qh, ql, true, mask, gl);
    hi = pair_search::last_round<G, 1>(shi, slo, ua, ub, qh, ql, true, mask, gl);
  }
  if (valid && gl < 2) (gl == 0 ? lo_out : hi_out)[i] = gl == 0 ? lo : hi;
}

template <int G>
int launch(const int* part_starts, int n_parts, const int* shi, const int* slo,
           const int* qhi, const int* qlo, int c, int* lo, int* hi, cudaStream_t st) {
  constexpr int KEYS = THREADS / G;
  const unsigned int blocks = (unsigned int)(((long long)c + KEYS - 1) / KEYS);
  hash_probe_kernel<G><<<blocks, THREADS, 0, st>>>(part_starts, n_parts, shi, slo, qhi, qlo, c,
                                                   lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hash_probe_launch(const int* part_starts, int n_parts,
                                 const int* shi, const int* slo,
                                 const int* qhi, const int* qlo, int c,
                                 int* lo, int* hi, void* stream) {
  if (c <= 0) return (int)cudaGetLastError();
  return launch<GROUP>(part_starts, n_parts, shi, slo, qhi, qlo, c, lo, hi,
                       (cudaStream_t)stream);
}
