// radix_partition: multiplicative-hash partition ids and their histogram —
// the bucketing step of the hash join's build.
//
// Replaces the Pallas TPU kernel radix_partition_pallas
// (src/repro/kernels/radix_partition.py). For each int32 key
//     pid = ((uint32(key) * 0x9E3779B1) >> 16) & (n_parts - 1)
// and hist[p] counts the keys of partition p. Every key is real, INT32_MIN
// included (the TPU kernel used INT32_MIN as padding and gave it pid -1).
//
// What bounds it on the H100: bytes, 8 per key (the key read, the pid
// written); the histogram is at most 32 KB. At the build's 3.9M keys that
// is 31 MB, about 9 us at 3.35 TB/s.
//
// Design: a grid-stride loop, one key per thread per step. The TPU kernel
// counted with a (P, BLOCK) one-hot comparison matrix summed across a
// sequential grid; here each block counts into a shared-memory histogram
// and adds its nonzero bins to the global one with one atomicAdd each, so
// the global atomics are at most P per block. Inside a warp, lanes with the
// same pid are merged first (__match_any_sync) so a skewed key column (all
// NULL, or P = 1) costs one shared atomic per warp, not 32. Integer
// atomics make the histogram exact in any order. The loop bound is warp-
// uniform, so the full-mask match is taken by converged warps.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void radix_partition_kernel(const int* __restrict__ keys,
                                       long long n, int n_parts,
                                       int* __restrict__ pid,
                                       int* __restrict__ hist) {
  extern __shared__ int sh[];
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const unsigned mask = (unsigned)(n_parts - 1);
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    long long i = base + threadIdx.x;
    bool valid = i < n;
    int p = -1;
    if (valid) {
      unsigned h = ((unsigned)keys[i] * 0x9E3779B1u) >> 16;
      p = (int)(h & mask);
      pid[i] = p;
    }
    unsigned peers = __match_any_sync(0xffffffffu, p);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&sh[p], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x) {
    int c = sh[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

}  // namespace

extern "C" int radix_partition_launch(const int* keys, long long n,
                                      int n_parts, int* pid, int* hist,
                                      void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + THREADS - 1) / THREADS;
  // a few blocks per SM; each block flushes up to n_parts bins at its end
  if (blocks > 132 * 4) blocks = 132 * 4;
  radix_partition_kernel<<<(unsigned int)blocks, THREADS,
                           (size_t)n_parts * sizeof(int),
                           (cudaStream_t)stream>>>(keys, n, n_parts, pid, hist);
  return (int)cudaGetLastError();
}
