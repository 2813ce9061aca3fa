// frontier_dedup: the delta-frontier mask of one property-path BFS round,
// and the relation dedup (empty visited set) of paths and DISTINCT
// aggregates.
//
// Replaces the Pallas TPU kernel frontier_dedup_pallas
// (src/repro/kernels/frontier_dedup.py). Candidates (hi[j], lo[j]) and the
// visited set (vhi, vlo) are int32 pairs, each sorted lexicographically as
// signed values. mask[j] = 1 iff candidate j differs from candidate j - 1
// (candidate 0 always passes that test) and does not occur in the visited
// set.
//
// What bounds it on the H100: bytes for the empty visited set (8 bytes of
// pair read and 1 byte written per candidate, plus the left neighbour,
// which the previous thread of the warp already brought into L1); memory
// latency for a non-empty one, where each first occurrence makes about
// log2(V) dependent loads of two 32-byte sectors.
//
// Design: one thread per candidate over a grid-stride loop. The adjacent
// test reads the left neighbour directly; position 0 is tested explicitly,
// with no sentinel, so a first candidate of (INT32_MIN, INT32_MIN) is kept
// (the TPU kernel used INT32_MIN as its neighbour padding and dropped it).
// Membership is a branchless lexicographic lower bound on the two int32
// columns, made only by first occurrences; no int64 composite is formed.
// The TPU kernel compared every candidate with every visited pair in
// (C_BLOCK, V_TILE) tiles (O(C * V)) to avoid gathers; the search is
// O(C * log V). The mask is written as bytes and viewed as torch.bool.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ bool pair_less(int ah, int al, int bh, int bl) {
  return ah < bh || (ah == bh && al < bl);
}

__global__ void frontier_dedup_kernel(const int* __restrict__ hi,
                                      const int* __restrict__ lo, long long c,
                                      const int* __restrict__ vhi,
                                      const int* __restrict__ vlo, int v,
                                      unsigned char* __restrict__ mask) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < c;
       j += (long long)gridDim.x * blockDim.x) {
    const int h = hi[j];
    const int l = lo[j];
    bool keep = !(j > 0 && hi[j - 1] == h && lo[j - 1] == l);
    if (keep && v > 0) {
      // invariant: the first visited pair not below (h, l) lies in
      // [base, base + len]
      int base = 0, len = v;
      while (len > 1) {
        const int half = len >> 1;
        const int m = base + half;
        base = pair_less(vhi[m], vlo[m], h, l) ? m : base;
        len -= half;
      }
      if (pair_less(vhi[base], vlo[base], h, l)) ++base;
      keep = !(base < v && vhi[base] == h && vlo[base] == l);
    }
    mask[j] = keep ? 1 : 0;
  }
}

}  // namespace

extern "C" int frontier_dedup_launch(const int* hi, const int* lo, long long c,
                                     const int* vhi, const int* vlo, int v,
                                     unsigned char* mask, void* stream) {
  if (c <= 0) return (int)cudaGetLastError();
  long long blocks = (c + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;
  frontier_dedup_kernel<<<(unsigned int)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(hi, lo, c, vhi, vlo, v, mask);
  return (int)cudaGetLastError();
}
