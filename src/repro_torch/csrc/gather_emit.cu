// gather_emit: fused join emission (gather + NULL extension + secondary-key
// equality mask).
//
// Replaces the Pallas TPU kernel gather_emit_pallas
// (src/repro/kernels/gather_emit.py). For each output slot t it writes, into
// rows [0, nl + nr) of the destination block,
//     out[j][t]      = lsel[j] < 0 ? NULL : lcols[lsel[j]][li[t]]
//     out[nl + j][t] = NULL if rsel[j] < 0, the right side is empty or
//                      ri[t] < 0 (a virtual NULL row); else rcols[rsel[j]][ri[t]]
// and mask[t] = AND over pairs p of (ri[t] < 0 || lcols[pl][li[t]] == rv),
// with rv = 0 when the right side is empty.
//
// What bounds it on the H100: bytes. Each emitted cell is one 4-byte gather
// and one 4-byte coalesced store; the gathers from a large window are the
// slow half, since neighbouring slots hit neighbouring rows only when the
// join repeats them.
//
// Design: one thread per output slot loops over the emit rows. The TPU
// kernel streamed the whole source through VMEM and built each gather from
// one-hot comparison matrices, because random gathers were the slow path on
// that chip; here a gather is a plain load, so the source is read only at
// the rows the slots name. The destination is the pooled output batch at a
// column offset (the zero-copy path), so no intermediate block exists.
// lsel, rsel and pairs are small int32 device arrays that every thread reads
// through the cache.

#include <cuda_runtime.h>

namespace {

__global__ void gather_emit_kernel(const int* __restrict__ lcols,
                                   long long lstride,
                                   const int* __restrict__ rcols,
                                   long long rstride, int r_empty,
                                   const int* __restrict__ li,
                                   const int* __restrict__ ri, long long C,
                                   const int* __restrict__ lsel, int nl,
                                   const int* __restrict__ rsel, int nr,
                                   const int* __restrict__ pairs, int np,
                                   int* __restrict__ out, long long ostride,
                                   bool* __restrict__ mask) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= C) return;
  const long long l = li[t];
  const int r = ri != nullptr ? ri[t] : 0;
  const bool virt = r < 0;
  const long long rc = virt ? 0 : r;
  for (int j = 0; j < nl; ++j) {
    const int row = lsel[j];
    out[(long long)j * ostride + t] = row < 0 ? -1 : lcols[row * lstride + l];
  }
  for (int j = 0; j < nr; ++j) {
    const int row = rsel[j];
    int v = -1;
    if (row >= 0 && !r_empty && !virt) v = rcols[row * rstride + rc];
    out[(long long)(nl + j) * ostride + t] = v;
  }
  if (mask != nullptr) {
    bool m = true;
    for (int p = 0; p < np; ++p) {
      const int lv = lcols[pairs[2 * p] * lstride + l];
      const int rv = r_empty ? 0 : rcols[pairs[2 * p + 1] * rstride + rc];
      m = m && (virt || lv == rv);
    }
    mask[t] = m;
  }
}

}  // namespace

extern "C" int gather_emit_launch(const int* lcols, long long lstride,
                                  const int* rcols, long long rstride,
                                  int r_empty, const int* li, const int* ri,
                                  long long C, const int* lsel, int nl,
                                  const int* rsel, int nr, const int* pairs,
                                  int np, int* out, long long ostride,
                                  bool* mask, void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (C + threads - 1) / threads;
  gather_emit_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      lcols, lstride, rcols, rstride, r_empty, li, ri, C, lsel, nl, rsel, nr,
      pairs, np, out, ostride, mask);
  return (int)cudaGetLastError();
}
