// sorted_search: vectorized binary search over sorted int32 keys — the
// property-path engine's successor-range lookup.
//
// Replaces the Pallas TPU kernel sorted_search_pallas
// (src/repro/kernels/sorted_search.py). For each query q it writes
//     left:  the number of keys < q
//     right: the number of keys <= q
// over n int32 keys sorted ascending; one launch computes one side, as the
// reference's function does, or both (the path engine's successor range).
//
// What bounds it on the H100: the SMs' load pipelines more than bytes.
// Each query reads 4 bytes and writes 4 (8 for both sides); a plain binary
// search over the 3.9M :knows sources makes 22 dependent loads, and once
// the threads of a warp diverge every load costs one L1 request per
// thread. The 15.6 MB of keys stay in the 50 MB L2.
//
// Design:
//   * Top levels in shared memory. The keys are cut into buckets of
//     B = ceil(n / SAMPLES) keys; the first key of each bucket is a sample.
//     For n > SAMPLES a small pre-pass gathers the samples into a scratch
//     buffer once per launch; every block copies them (coalesced) into
//     shared memory. A query counts the samples its predicate holds for
//     (c, a branchless search at shared-memory latency), which puts its
//     answer in [(c-1)B + 1, min(cB, n)] (0 when c = 0), and finishes with
//     a binary search over that interval in global memory: ceil(log2 B)
//     steps (9 at n = 3.9M), none at all when n <= SAMPLES.
//   * A persistent grid: about as many blocks as fit on the SMs at once,
//     each walking chunks of QPT * THREADS queries, so the staging is paid
//     once per block, not once per 256 queries.
//   * QPT queries per thread, their steps interleaved, so each thread keeps
//     QPT independent loads in flight.
//   * Both sides in one launch: the left and right searches share their
//     loads while their intervals coincide (the query is not a key).
//
// The TPU kernel compared every query with every key in (Q_BLOCK, K_TILE)
// tiles and padded the keys with INT32_MAX, so for a query of INT32_MAX
// with side "right" it also counted the padding. This kernel counts real
// keys only, as numpy's searchsorted does.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int QPT = 4;           // queries per thread
constexpr int SAMPLES = 8192;    // shared-memory samples (32 KB)
constexpr int MAX_DEVICES = 64;

enum Mode { LEFT = 0, RIGHT = 1, BOTH = 2 };

__global__ void sorted_search_sample_kernel(const int* __restrict__ keys, int bucket,
                                            int ns, int* __restrict__ samples) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < ns) samples[j] = keys[(long long)j * bucket];
}

// answer in [lo, hi] -> narrow by one step of the binary search over keys
__device__ __forceinline__ void narrow(int& lo, int& hi, int k, int q, bool le) {
  const int mid = lo + ((hi - lo) >> 1);
  const bool p = le ? k <= q : k < q;
  lo = p ? mid + 1 : lo;
  hi = p ? hi : mid;
}

// the interval [lo, hi] that the bucket step leaves for a query: c samples
// satisfy its predicate
__device__ __forceinline__ void bucket_range(int c, int bucket, int ns, int n, int& lo,
                                             int& hi) {
  lo = c == 0 ? 0 : (c - 1) * bucket + 1;
  hi = c == 0 ? 0 : (c < ns ? c * bucket : n);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) sorted_search_kernel(
    const int* __restrict__ keys, int n, const int* __restrict__ samples, int bucket,
    int ns, int steps, const int* __restrict__ queries, int m, int* __restrict__ out0,
    int* __restrict__ out1) {
  __shared__ int s[SAMPLES];
  for (int j = threadIdx.x; j < ns; j += THREADS) s[j] = samples[j];
  __syncthreads();
  constexpr bool LE0 = MODE == RIGHT;  // the first search's predicate: k <= q
  const long long chunk = (long long)QPT * THREADS;
  for (long long base = blockIdx.x * chunk; base < m; base += gridDim.x * chunk) {
    int q[QPT], sl[QPT], sr[QPT];
    bool in[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const long long i = base + j * THREADS + threadIdx.x;
      in[j] = i < m;
      q[j] = in[j] ? queries[i] : 0;
      sl[j] = 0;
      sr[j] = 0;
    }
    // the bucket step: count the samples that satisfy each predicate
    for (int len = ns; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int kl = s[sl[j] + half];
        sl[j] = (LE0 ? kl <= q[j] : kl < q[j]) ? sl[j] + half : sl[j];
        if (MODE == BOTH) {
          const int kr = s[sr[j] + half];
          sr[j] = kr <= q[j] ? sr[j] + half : sr[j];
        }
      }
      len -= half;
    }
    int lo[QPT], hi[QPT], lo2[QPT], hi2[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      // no keys (ns = 0): every count is 0
      const int kl = ns ? s[sl[j]] : 0;
      const int cl = ns ? sl[j] + ((LE0 ? kl <= q[j] : kl < q[j]) ? 1 : 0) : 0;
      bucket_range(cl, bucket, ns, n, lo[j], hi[j]);
      if (!in[j]) hi[j] = lo[j];
      if (MODE == BOTH) {
        const int kr = ns ? s[sr[j]] : 0;
        bucket_range(ns ? sr[j] + (kr <= q[j] ? 1 : 0) : 0, bucket, ns, n, lo2[j], hi2[j]);
        if (!in[j]) hi2[j] = lo2[j];
      }
    }
    // the inner search over each interval, QPT queries' loads in flight
    for (int t = 0; t < steps; ++t) {
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const bool active = lo[j] < hi[j];
        const int mid = lo[j] + ((hi[j] - lo[j]) >> 1);
        int k = 0;
        if (active) {
          k = __ldg(keys + mid);
          narrow(lo[j], hi[j], k, q[j], LE0);
        }
        if (MODE == BOTH && lo2[j] < hi2[j]) {
          const int mid2 = lo2[j] + ((hi2[j] - lo2[j]) >> 1);
          // while both searches walk the same path they share its loads
          const int k2 = active && mid2 == mid ? k : __ldg(keys + mid2);
          narrow(lo2[j], hi2[j], k2, q[j], true);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      if (!in[j]) continue;
      const long long i = base + j * THREADS + threadIdx.x;
      out0[i] = lo[j];
      if (MODE == BOTH) out1[i] = lo2[j];
    }
  }
}

template <int MODE>
int grid_size(long long m) {
  // blocks that fit on the device at once, cached per device
  static int fit[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES || dev < 0) return -1;
  if (fit[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sorted_search_kernel<MODE>,
                                                  THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    fit[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const long long chunks = (m + (long long)QPT * THREADS - 1) / ((long long)QPT * THREADS);
  return (int)(chunks < fit[dev] ? chunks : fit[dev]);
}

template <int MODE>
int launch(const int* keys, int n, const int* samples, int bucket, int ns, int steps,
           const int* queries, int m, int* out0, int* out1, cudaStream_t stream) {
  const int blocks = grid_size<MODE>(m);
  if (blocks < 0) return (int)cudaErrorInvalidDevice;
  sorted_search_kernel<MODE><<<blocks, THREADS, 0, stream>>>(
      keys, n, samples, bucket, ns, steps, queries, m, out0, out1);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 left, 1 right (into out0), 2 both (left into out0, right into
// out1). scratch: SAMPLES int32 of device memory, used when n > SAMPLES.
extern "C" int sorted_search_launch(const int* keys, int n, const int* queries, int m,
                                    int mode, int* scratch, int* out0, int* out1,
                                    void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 0) n = 0;
  const int bucket = n > SAMPLES ? (int)(((long long)n + SAMPLES - 1) / SAMPLES) : 1;
  const int ns = (int)(((long long)n + bucket - 1) / bucket);
  // ceil(log2(bucket)) steps narrow an interval of at most bucket
  // candidates to one
  int steps = 0;
  while ((1LL << steps) < bucket) ++steps;
  const int* samples = keys;
  if (bucket > 1) {
    sorted_search_sample_kernel<<<(ns + 255) / 256, 256, 0, st>>>(keys, bucket, ns, scratch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    samples = scratch;
  }
  if (mode == LEFT)
    return launch<LEFT>(keys, n, samples, bucket, ns, steps, queries, m, out0, out1, st);
  if (mode == RIGHT)
    return launch<RIGHT>(keys, n, samples, bucket, ns, steps, queries, m, out0, out1, st);
  return launch<BOTH>(keys, n, samples, bucket, ns, steps, queries, m, out0, out1, st);
}
