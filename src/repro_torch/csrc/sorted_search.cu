// sorted_search: vectorized binary search over sorted int32 keys — the
// property-path engine's successor-range lookup.
//
// Replaces the Pallas TPU kernel sorted_search_pallas
// (src/repro/kernels/sorted_search.py). For each query q it writes
//     left:  the number of keys < q
//     right: the number of keys <= q
// over n int32 keys sorted ascending. One launch computes one side, as the
// reference's function does.
//
// What bounds it on the H100: memory latency more than bytes. Each query
// reads 4 bytes and writes 4, and makes about log2(n) dependent loads of
// 32-byte sectors; over the 3.9M :knows sources that is 22 steps, whose top
// levels stay in L1/L2 across the threads of a block.
//
// Design: one thread per query over a grid-stride loop, and a branchless
// lower / upper bound over the n real keys: the step count is
// ceil(log2(n)) for every query, so the threads of a warp stay converged,
// and no key is padded. The TPU kernel compared every query with every key
// in (Q_BLOCK, K_TILE) tiles (O(m * n) comparisons, accumulated across a
// sequential grid) because gathers were the slow path there; it padded the
// keys with INT32_MAX, so for a query of INT32_MAX with side "right" it
// also counted the padding. This kernel counts real keys only, as numpy's
// searchsorted does.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool LEFT>
__global__ void sorted_search_kernel(const int* __restrict__ keys, int n,
                                     const int* __restrict__ queries, int m,
                                     int* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += gridDim.x * blockDim.x) {
    const int q = queries[i];
    if (n == 0) {
      out[i] = 0;
      continue;
    }
    // invariant: the answer lies in [base, base + len]
    int base = 0, len = n;
    while (len > 1) {
      const int half = len >> 1;
      const int k = keys[base + half];
      base = (LEFT ? k < q : k <= q) ? base + half : base;
      len -= half;
    }
    const int k = keys[base];
    out[i] = base + ((LEFT ? k < q : k <= q) ? 1 : 0);
  }
}

}  // namespace

extern "C" int sorted_search_launch(const int* keys, int n, const int* queries,
                                    int m, int left, int* out, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  int blocks = (m + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;
  if (left) {
    sorted_search_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        keys, n, queries, m, out);
  } else {
    sorted_search_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        keys, n, queries, m, out);
  }
  return (int)cudaGetLastError();
}
