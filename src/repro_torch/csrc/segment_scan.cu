// segment_scan: segmented inclusive scan (sum / min / max) of float32 values
// over sorted int32 keys — the grouping engine's reduction.
//
// Replaces the Pallas TPU kernel segment_scan_pallas
// (src/repro/kernels/segment_reduce.py). out[i] combines the values of the
// maximal run of equal keys ending at i (count is a sum of ones, prepared
// by the wrapper).
//
// What bounds it on the H100: bytes, 12 per element (a key, a value and the
// output). On the main path the input is one batch of at most 4096 rows, so
// the launch, not the bytes, sets the time.
//
// Design: one block of 1024 threads walks the input in 1024-element tiles,
// the role the TPU's sequential grid played. Inside a tile each element
// carries (head flag, value) — the flag marks a key change — and a
// segmented scan runs with warp shuffles, then across the 32 warp totals
// through shared memory. A (last key, last value) carry in shared memory
// joins the run that crosses a tile edge, as the TPU kernel's scratch
// carry did. A multi-block decoupled look-back for large inputs is later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == 0) return __fadd_rn(a, b);
  if (isnan(a) || isnan(b)) return nanf("");
  if (op == 1) return fminf(a, b);
  return fmaxf(a, b);
}

__global__ void segment_scan_kernel(const int* __restrict__ keys,
                                    const float* __restrict__ vals,
                                    float* __restrict__ out, long long n,
                                    int op, float ident) {
  __shared__ float warp_v[32];
  __shared__ int warp_f[32];
  __shared__ int carry_key;
  __shared__ float carry_val;
  __shared__ int carry_valid;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) carry_valid = 0;
  __syncthreads();
  for (long long base = 0; base < n; base += TILE) {
    const long long i = base + tid;
    const bool in = i < n;
    const int k = in ? keys[i] : 0;
    float v = in ? vals[i] : ident;
    int f = (tid == 0 || !in || k != keys[i - 1]) ? 1 : 0;
    // warp-level segmented inclusive scan
    for (int d = 1; d < 32; d <<= 1) {
      const float v2 = __shfl_up_sync(FULL, v, d);
      const int f2 = __shfl_up_sync(FULL, f, d);
      if (lane >= d) {
        if (!f) v = combine(op, v2, v);
        f |= f2;
      }
    }
    if (lane == 31) {
      warp_v[warp] = v;
      warp_f[warp] = f;
    }
    __syncthreads();
    if (warp == 0) {
      float wv = warp_v[lane];
      int wf = warp_f[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const float v2 = __shfl_up_sync(FULL, wv, d);
        const int f2 = __shfl_up_sync(FULL, wf, d);
        if (lane >= d) {
          if (!wf) wv = combine(op, v2, wv);
          wf |= f2;
        }
      }
      warp_v[lane] = wv;
      warp_f[lane] = wf;
    }
    __syncthreads();
    if (warp > 0 && !f) v = combine(op, warp_v[warp - 1], v);
    if (in && carry_valid && k == carry_key) v = combine(op, carry_val, v);
    if (in) out[i] = v;
    __syncthreads();
    const long long last = (n - base < TILE ? n - base : TILE) - 1;
    if (tid == last) {
      carry_key = k;
      carry_val = v;
      carry_valid = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int segment_scan_launch(const int* keys, const float* vals,
                                   float* out, long long n, int op,
                                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const float ident = op == 0 ? 0.0f : (op == 1 ? INFINITY : -INFINITY);
  segment_scan_kernel<<<1, TILE, 0, (cudaStream_t)stream>>>(keys, vals, out, n,
                                                           op, ident);
  return (int)cudaGetLastError();
}
