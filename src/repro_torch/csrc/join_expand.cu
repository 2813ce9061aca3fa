// join_expand: merge-join Build-phase expansion (paper §3.2).
//
// Replaces the Pallas TPU kernel join_expand_pallas
// (src/repro/kernels/join_expand.py). For output slots [base, base+count) of
// a grouped cross product it writes the gather indices
//     li = lstarts[g] + w / rlens[g],   ri = rstarts[g] + w % rlens[g]
// where g is the group holding slot t and w = t - cum[g]. Slots at or past
// cum[G] get -1 in both outputs.
//
// What bounds it on the H100: bytes. Each slot writes 8 bytes and reads a
// handful of bytes of group parameters that stay in L1/L2; there is no
// arithmetic to speak of. At the main path's 4096-slot batches the launch
// itself (a few microseconds) dominates.
//
// Design: one thread per output slot, with a 64-bit slot index. The TPU
// kernel found the group with a (G, BLOCK) comparison matrix and picked the
// group's parameters with one-hot selects, because gathers were the slow
// path there; that capped it at 2048 groups per call and forced the wrapper
// to chunk. Here each thread binary-searches the int64 cum array directly
// (upper bound, so empty groups are skipped), which takes any number of
// groups and any total, including totals beyond 2^31. Unit-length runs on
// either side skip the division, as the numpy reference does.

#include <cuda_runtime.h>

namespace {

__global__ void join_expand_kernel(const int* __restrict__ lstarts,
                                   const int* __restrict__ llens,
                                   const int* __restrict__ rstarts,
                                   const int* __restrict__ rlens,
                                   const long long* __restrict__ cum, int G,
                                   long long base, long long count,
                                   int* __restrict__ li, int* __restrict__ ri) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= count) return;
  long long t = base + j;
  if (G <= 0 || t < 0 || t >= cum[G]) {
    li[j] = -1;
    ri[j] = -1;
    return;
  }
  // invariant: cum[lo] <= t < cum[hi]
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    int mid = lo + ((hi - lo) >> 1);
    if (cum[mid] <= t) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  long long w = t - cum[lo];
  int ll = llens[lo];
  int rl = rlens[lo];
  long long a, b;
  if (ll == 1) {
    a = 0;
    b = w;
  } else if (rl == 1) {
    a = w;
    b = 0;
  } else if (w < 2147483647LL) {
    int wi = (int)w;
    a = wi / rl;
    b = wi % rl;
  } else {
    a = w / rl;
    b = w % rl;
  }
  li[j] = lstarts[lo] + (int)a;
  ri[j] = rstarts[lo] + (int)b;
}

}  // namespace

extern "C" int join_expand_launch(const int* lstarts, const int* llens,
                                  const int* rstarts, const int* rlens,
                                  const long long* cum, int G, long long base,
                                  long long count, int* li, int* ri,
                                  void* stream) {
  if (count <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (count + threads - 1) / threads;
  join_expand_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      lstarts, llens, rstarts, rlens, cum, G, base, count, li, ri);
  return (int)cudaGetLastError();
}
