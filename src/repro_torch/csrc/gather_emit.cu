// gather_emit: fused join emission (gather + NULL extension + secondary-key
// equality mask).
//
// Replaces the Pallas TPU kernel gather_emit_pallas
// (src/repro/kernels/gather_emit.py). With the emit plan's rows
// row[0, nl) from the left source and row[nl, nl + nr) from the right, it
// writes for each output slot t, into rows [0, nl + nr) of the destination,
//     out[j][t]      = row[j] < 0 ? NULL : lcols[row[j]][li[t]]          (j < nl)
//     out[j][t]      = NULL if row[j] < 0, the right side is empty or
//                      ri[t] < 0 (a virtual NULL row);
//                      else rcols[row[j]][ri[t]]                        (j >= nl)
// and mask[t] = AND over pairs p of (ri[t] < 0 || lcols[pl][li[t]] == rv),
// with rv = rcols[pr][ri[t]], or 0 when the right side is empty.
//
// What bounds it on the H100: latency, then bytes. Each emitted cell is one
// 4-byte gather and one 4-byte store; at the main path's 4096-slot batches
// the time is set by how many dependent round trips to L2/HBM a slot makes,
// not by its bytes.
//
// Design: the TPU kernel streamed the whole source through VMEM and built
// each gather from one-hot comparison matrices; here a gather is a plain
// load from the rows the slots name. The emit plan (rows, pairs, and for
// each pair the emitted row that already holds its left value) is a
// by-value kernel parameter, so no thread reads it from device memory, and
// every loop over it is unrolled with uniform predicates, to the caps below
// or, for a plan of at most 8 rows and 2 pairs (every plan of the LSQB,
// path and BSBM BI queries), to those. A thread handles one slot and issues
// every gather of it (li and ri first, then each emitted cell and each pair
// operand) before its first store, so a slot costs two round trips (its
// indices, then all its cells) instead of one per emitted row. A pair whose
// left row is also emitted reuses the emitted value; an emitted right value
// is never reused, because it is NULL where the right side is empty while
// the pair compares against 0 there. Stores are striped: a warp writes 32
// consecutive cells of a row, which coalesce at any out_offset (concat
// writes at arbitrary offsets), so no wider store is used. The destination
// is the pooled output batch at a column offset (the zero-copy path).
//
// A plan wider than the caps is split on the host into chunks within them,
// over the same li / ri: each chunk is one launch that writes its own rows
// of the destination, and its pairs reach the mask through the launch's
// mask_and flag: the first chunk writes the mask, a later one clears the
// slots its pairs reject (an AND, with no read; a separate instance, so a
// plan within the caps runs the same code as before), and a later one
// without pairs gets no mask at all.

#include <cuda_runtime.h>

#define GE_MAX_ROWS 16   // emitted rows, left and right together
#define GE_MAX_PAIRS 4   // equality pairs
#define GE_THREADS 128

struct EmitPlan {
  int n_left;                     // nl: rows [0, nl) come from the left
  int n_rows;                     // nl + nr
  int n_pairs;
  int row[GE_MAX_ROWS];           // source row per output row; -1 = NULL
  int pair_left[GE_MAX_PAIRS];
  int pair_right[GE_MAX_PAIRS];
  int pair_reuse[GE_MAX_PAIRS];   // an output row j < nl with the pair's
                                  // left row, or -1
};

namespace {

// ROWS and PAIRS (at most the caps) bound the unrolled loops: a plan of up
// to 8 rows and 2 pairs runs the short unroll, about a quarter faster than
// the one to the caps on the q6 plan (PERF.md, kernel_sweep.py). MASK_AND:
// AND the pairs into the mask instead of writing it.
template <int ROWS, int PAIRS, bool MASK_AND>
__global__ void __launch_bounds__(GE_THREADS)
gather_emit_kernel(const EmitPlan plan, const int* __restrict__ lcols, long long lstride,
                   const int* __restrict__ rcols, long long rstride, int r_empty,
                   const int* __restrict__ li, const int* __restrict__ ri, long long C,
                   int* __restrict__ out, long long ostride, bool* __restrict__ mask) {
  const long long t = (long long)blockIdx.x * GE_THREADS + threadIdx.x;
  if (t >= C) return;
  const long long l = li[t];
  const int rr = ri != nullptr ? ri[t] : 0;
  const bool virt = rr < 0;
  const long long r = virt ? 0 : rr;
  // every gather of the slot, before any store
  int v[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int row = plan.row[j];
    const bool left = j < plan.n_left;
    const bool on = j < plan.n_rows && row >= 0 && (left || !r_empty);
    const int* src = left ? lcols + (long long)row * lstride : rcols + (long long)row * rstride;
    int x = -1;
    if (on && (left || !virt)) x = src[left ? l : r];
    v[j] = x;
  }
  int pl[PAIRS], pr[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const bool on = p < plan.n_pairs;
    const int* lsrc = lcols + (long long)plan.pair_left[p] * lstride;
    const int* rsrc = rcols + (long long)plan.pair_right[p] * rstride;
    int a = 0, b = 0;
    if (on && plan.pair_reuse[p] < 0) a = lsrc[l];
    if (on && !r_empty && !virt) b = rsrc[r];
    pl[p] = a;
    pr[p] = b;
  }
  // the stores
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
    if (j < plan.n_rows) out[(long long)j * ostride + t] = v[j];
  if (mask == nullptr) return;
  bool m = true;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    if (p < plan.n_pairs) {
      int a = pl[p];
      const int reuse = plan.pair_reuse[p];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (reuse == j) a = v[j];
      m = m && (virt || a == pr[p]);
    }
  }
  if (!MASK_AND)
    mask[t] = m;
  else if (!m)
    mask[t] = false;
}

template <int ROWS, int PAIRS, bool MASK_AND = false>
void launch(const EmitPlan& plan, const int* lcols, long long lstride, const int* rcols,
            long long rstride, int r_empty, const int* li, const int* ri, long long C,
            int* out, long long ostride, bool* mask, cudaStream_t st) {
  const unsigned int blocks = (unsigned int)((C + GE_THREADS - 1) / GE_THREADS);
  gather_emit_kernel<ROWS, PAIRS, MASK_AND><<<blocks, GE_THREADS, 0, st>>>(
      plan, lcols, lstride, rcols, rstride, r_empty, li, ri, C, out, ostride, mask);
}

}  // namespace

// mask_and: the chunk ANDs its pairs into the mask (a later chunk of a plan
// past the caps) instead of writing it.
extern "C" int gather_emit_launch(const EmitPlan* plan, const int* lcols,
                                  long long lstride, const int* rcols,
                                  long long rstride, int r_empty, const int* li,
                                  const int* ri, long long C, int* out,
                                  long long ostride, bool* mask, int mask_and, void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool narrow = plan->n_rows <= 8 && plan->n_pairs <= 2;
  if (mask_and)
    launch<GE_MAX_ROWS, GE_MAX_PAIRS, true>(*plan, lcols, lstride, rcols, rstride, r_empty, li,
                                            ri, C, out, ostride, mask, st);
  else if (narrow)
    launch<8, 2>(*plan, lcols, lstride, rcols, rstride, r_empty, li, ri, C, out, ostride, mask, st);
  else
    launch<GE_MAX_ROWS, GE_MAX_PAIRS>(*plan, lcols, lstride, rcols, rstride, r_empty, li, ri, C,
                                      out, ostride, mask, st);
  return (int)cudaGetLastError();
}

extern "C" int gather_emit_limits(int* max_rows, int* max_pairs, int* plan_bytes) {
  *max_rows = GE_MAX_ROWS;
  *max_pairs = GE_MAX_PAIRS;
  *plan_bytes = (int)sizeof(EmitPlan);
  return 0;
}
