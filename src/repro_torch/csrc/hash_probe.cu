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
// What bounds it on the H100: memory latency more than bytes. Each probe
// reads its key and writes two ints (16 bytes with a pair key), and makes
// two binary searches of about log2(N/P) dependent loads of 32-byte sectors
// inside its partition. A 4096-key probe of a 3.9M-row build in 1024
// partitions is 2 x 12 steps per key.
//
// Design: one thread per probe key: two loads of part_starts, then a
// lower-bound and an upper-bound binary search on (hi, lo) within that
// partition's slice, the second starting from the first's answer. Rows of
// lower partitions all come first, so these positions equal the TPU
// kernel's counts exactly. The TPU kernel avoided gathers by comparing
// every probe with every build row in VMEM tiles, O(C * N) work; the
// searches are O(C * log(N / P)).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ bool pair_less(int ah, int al, int bh, int bl) {
  return ah < bh || (ah == bh && al < bl);
}

__global__ void hash_probe_kernel(const int* __restrict__ part_starts,
                                  int n_parts, const int* __restrict__ shi,
                                  const int* __restrict__ slo,
                                  const int* __restrict__ qhi,
                                  const int* __restrict__ qlo, int c,
                                  int* __restrict__ lo_out,
                                  int* __restrict__ hi_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const int ql = qlo[i];
  const int qh = qhi ? qhi[i] : 0;
  unsigned mix = (unsigned)ql;
  if (qhi) {
    mix ^= (unsigned)qh * 0x85EBCA6Bu;
    if (mix == 0x80000000u) mix = 0u;
  }
  const int p = (int)(((mix * 0x9E3779B1u) >> 16) & (unsigned)(n_parts - 1));
  const int end = part_starts[p + 1];
  int a = part_starts[p], b = end;
  while (a < b) {  // first row not below the key
    int m = a + ((b - a) >> 1);
    int vh = shi ? shi[m] : 0;
    if (pair_less(vh, slo[m], qh, ql)) {
      a = m + 1;
    } else {
      b = m;
    }
  }
  lo_out[i] = a;
  b = end;
  while (a < b) {  // first row above the key
    int m = a + ((b - a) >> 1);
    int vh = shi ? shi[m] : 0;
    if (!pair_less(qh, ql, vh, slo[m])) {
      a = m + 1;
    } else {
      b = m;
    }
  }
  hi_out[i] = a;
}

}  // namespace

extern "C" int hash_probe_launch(const int* part_starts, int n_parts,
                                 const int* shi, const int* slo,
                                 const int* qhi, const int* qlo, int c,
                                 int* lo, int* hi, void* stream) {
  if (c <= 0) return (int)cudaGetLastError();
  int blocks = (c + THREADS - 1) / THREADS;
  hash_probe_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      part_starts, n_parts, shi, slo, qhi, qlo, c, lo, hi);
  return (int)cudaGetLastError();
}
