// bloom_build / bloom_probe: the blocked bloom filter of sideways
// information passing — a join's build keys summarised as one uint32 word
// per block, two bits per key, tested by the probe side's scans.
//
// Replaces the Pallas TPU kernels bloom_build_pallas and bloom_probe_pallas
// (src/repro/kernels/bloom_filter.py). Address computation, bit for bit as
// the reference's vecops.bloom_hash:
//     h1 = uint32(key) * 0x9E3779B1,  h2 = uint32(key) * 0x85EBCA6B
//     word = (h1 >> 18) & (W - 1)
//     bits = (1 << (h1 & 31)) | (1 << ((h2 >> 13) & 31))
// build ORs bits into words[word]; probe is (words[word] & bits) == bits.
//
// What bounds them on the H100: build, bytes (4 per key read, the words
// written once: 1.37M keys into 2^20 words is 9.7 MB, ~3 us) and the
// atomics' throughput in L2, where the 4 MB of words stay; probe, one
// 32-byte sector per query at a random word (the words are L2-resident
// after the build), plus 5 bytes of key and result.
//
// Design: one thread per key. The TPU kernels had no scatter or gather
// they could afford, so the build was a one-hot (word x key) product per bit
// plane and the probe a one-hot sum over word tiles; here the build is an
// atomicOr into words the wrapper zeroed (OR is order-free, so the result
// is exact) and the probe is one 4-byte load per query.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void bloom_hash(int key, unsigned wmask,
                                           unsigned* word, unsigned* bits) {
  unsigned u = (unsigned)key;
  unsigned h1 = u * 0x9E3779B1u;
  unsigned h2 = u * 0x85EBCA6Bu;
  *word = (h1 >> 18) & wmask;
  *bits = (1u << (h1 & 31u)) | (1u << ((h2 >> 13) & 31u));
}

__global__ void bloom_build_kernel(const int* __restrict__ keys, long long n,
                                   unsigned wmask, unsigned* words) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned w, b;
    bloom_hash(keys[i], wmask, &w, &b);
    atomicOr(&words[w], b);
  }
}

__global__ void bloom_probe_kernel(const unsigned* __restrict__ words,
                                   unsigned wmask,
                                   const int* __restrict__ queries, int c,
                                   bool* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  unsigned w, b;
  bloom_hash(queries[i], wmask, &w, &b);
  out[i] = (words[w] & b) == b;
}

}  // namespace

extern "C" int bloom_build_launch(const int* keys, long long n, int n_words,
                                  unsigned* words, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bloom_build_kernel<<<(unsigned int)blocks, THREADS, 0,
                       (cudaStream_t)stream>>>(keys, n,
                                               (unsigned)(n_words - 1), words);
  return (int)cudaGetLastError();
}

extern "C" int bloom_probe_launch(const unsigned* words, int n_words,
                                  const int* queries, int c, bool* out,
                                  void* stream) {
  if (c <= 0) return (int)cudaGetLastError();
  int blocks = (c + THREADS - 1) / THREADS;
  bloom_probe_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      words, (unsigned)(n_words - 1), queries, c, out);
  return (int)cudaGetLastError();
}
