// segment_scan: segmented inclusive scan (sum / min / max) of float64 values
// over sorted int32 keys — the grouping engine's reduction. The value plane
// is float64, as in the reference's default numpy backend.
//
// Replaces the Pallas TPU kernel segment_scan_pallas
// (src/repro/kernels/segment_reduce.py). out[i] combines the values of the
// maximal run of equal keys ending at i; count is a sum of ones, which the
// kernel makes itself when it is given no values.
//
// What bounds it on the H100: bytes, 20 per element (a 4-byte key, an
// 8-byte value and the 8-byte output; 12 for a count). On the main path the input is one batch of at
// most 4096 rows, so the launch and one block's latency, not the bytes,
// set the time.
//
// Design: each element carries (head flag, value), the flag marking a key
// change, and the scan combines (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 :
// v1 + v2) (min / max alike).
//   * ITEMS consecutive elements per thread, loaded with 16-byte vector
//     loads (int4 keys, double2 values) where the pointers are aligned (scalar loads otherwise and at
//     the ragged edge) and scanned in registers. A thread takes its first
//     head flag from the previous thread's last key (__shfl_up_sync); a
//     warp's first flag comes from the previous warp's last key through
//     shared memory, and is settled after the exchange below (it changes
//     only which elements take the warp's carry, never a value inside it).
//   * One pass per tile of THREADS * ITEMS = 4096 elements: one warp scan
//     of the thread aggregates, one exchange of the warp aggregates in
//     shared memory, which warp 0 scans; two barriers in all. A main-path
//     batch is one block with no tile loop.
//   * Above one tile, one block per tile, joined by a decoupled look-back.
//     A block takes its tile from a ticket counter (so every tile it waits
//     for has started) and publishes, before it waits for anything, its
//     status: the value goes to the tile's slot of a value array with a
//     relaxed store, then the state word with a release store, so a reader
//     that acquires the state reads the value after it (a double no longer
//     fits beside the state in one 64-bit word). The state is AGGREGATE
//     when the tile holds no head at all (one run through it, its value
//     the tile's total), else its inclusive PREFIX (the value of its
//     trailing run, which starts inside the tile). A tile whose first
//     key differs from the previous tile's last key needs no carry;
//     otherwise warp 0 reads 32 predecessors' states at a time (acquire),
//     then their values, and combines the aggregates back to the nearest
//     PREFIX.
//     A tile never upgrades its AGGREGATE to a PREFIX once it has its
//     carry: that would save a run across T tiles some of its ceil(T / 32)
//     window reads, but make the order of a float sum depend on timing.
//     As it is, every sum is taken in one fixed order, the same in every
//     run and in the plain version. The ticket, the states and the values
//     live in a zeroed scratch buffer that the wrapper allocates.
// Summation order: sequential within a thread, a shuffle tree over the
// threads of a warp, then over the warps, then across tiles (a tree over
// each window of 32 predecessors, the windows nearest first).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGGREGATE = 1ull, PREFIX = 2ull;

template <int OP>
__device__ __forceinline__ double combine(double a, double b) {
  if (OP == 0) return __dadd_rn(a, b);
  if (isnan(a) || isnan(b)) return nan("");
  return OP == 1 ? fmin(a, b) : fmax(a, b);
}

template <int OP>
__device__ __forceinline__ double identity() {
  return OP == 0 ? 0.0 : (OP == 1 ? INFINITY : -INFINITY);
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ double load_relaxed(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

// A tile's status: its value first, then its state with release order, so
// that a reader which acquires the state finds the value.
__device__ __forceinline__ void publish(unsigned long long* state, double* value,
                                        unsigned long long s, double v) {
  asm volatile("st.relaxed.gpu.global.f64 [%0], %1;" ::"l"(value), "d"(v) : "memory");
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(state), "l"(s) : "memory");
}

// Warp 0: the combined value of the runs that reach this tile from its
// predecessors, walking back 32 statuses at a time to the nearest PREFIX.
template <int OP>
__device__ double look_back(const unsigned long long* state, const double* value, int tile,
                            int lane) {
  double acc = 0.0;
  bool have = false;
  for (int hi = tile - 1;; hi -= 32) {
    const int j = hi - lane;
    unsigned long long s = PREFIX;
    double v = identity<OP>();
    if (j >= 0) {
      do {
        s = load_acquire(state + j);
      } while (s == 0);
      v = load_relaxed(value + j);
    }
    const unsigned prefixes = __ballot_sync(FULL, s == PREFIX);
    // lanes up to the nearest PREFIX count; the aggregates among them
    // hold no head, so their values simply combine
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    double x = lane <= stop ? v : identity<OP>();
    for (int o = 16; o > 0; o >>= 1) x = combine<OP>(x, __shfl_down_sync(FULL, x, o));
    x = __shfl_sync(FULL, x, 0);
    acc = have ? combine<OP>(x, acc) : x;
    have = true;
    if (prefixes) return acc;
  }
}

template <int OP>
__global__ void __launch_bounds__(THREADS) segment_scan_kernel(
    const int* __restrict__ keys, const double* __restrict__ vals, double* __restrict__ out,
    long long n, int tiles, unsigned long long* __restrict__ scratch) {
  __shared__ int s_first_key[WARPS], s_last_key[WARPS], s_flag[WARPS], s_carry_ok[WARPS];
  __shared__ double s_value[WARPS], s_carry[WARPS];
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int tile = 0;
  if (tiles > 1) {
    if (tid == 0) s_tile = (int)atomicAdd(scratch, 1ull);
    __syncthreads();
    tile = s_tile;
  }
  const long long t0 = (long long)tile * TILE;
  const long long i0 = t0 + (long long)tid * ITEMS;

  // load ITEMS keys and values; elements past n are heads and never stored
  int k[ITEMS];
  double v[ITEMS];
  const bool vec = i0 + ITEMS <= n &&
                   (((uintptr_t)keys | (uintptr_t)out | (uintptr_t)vals) & 15) == 0;
  if (vec) {
#pragma unroll
    for (int h = 0; h < ITEMS / 4; ++h) {
      const int4 a = reinterpret_cast<const int4*>(keys + i0)[h];
      k[4 * h] = a.x, k[4 * h + 1] = a.y, k[4 * h + 2] = a.z, k[4 * h + 3] = a.w;
    }
    if (vals) {
#pragma unroll
      for (int h = 0; h < ITEMS / 2; ++h) {
        const double2 b = reinterpret_cast<const double2*>(vals + i0)[h];
        v[2 * h] = b.x, v[2 * h + 1] = b.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) v[j] = 1.0;
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool in = i0 + j < n;
      k[j] = in ? keys[i0 + j] : 0;
      v[j] = in ? (vals ? vals[i0 + j] : 1.0) : identity<OP>();
    }
  }

  // head flags; lane 0's first flag is the warp edge's, settled below
  const int prev = __shfl_up_sync(FULL, k[ITEMS - 1], 1);
  bool head[ITEMS];
  head[0] = i0 >= n || (lane > 0 && k[0] != prev);
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) head[j] = i0 + j >= n || k[j] != k[j - 1];

  // the thread's own scan, in order
  int any = head[0];
#pragma unroll
  for (int j = 1; j < ITEMS; ++j) {
    v[j] = head[j] ? v[j] : combine<OP>(v[j - 1], v[j]);
    any |= head[j];
  }

  // the warp's scan of the thread aggregates
  double wv = v[ITEMS - 1];
  int wf = any;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double v2 = __shfl_up_sync(FULL, wv, d);
    const int f2 = __shfl_up_sync(FULL, wf, d);
    if (lane >= d) {
      if (!wf) wv = combine<OP>(v2, wv);
      wf |= f2;
    }
  }
  const double ev = __shfl_up_sync(FULL, wv, 1);
  const int ef = __shfl_up_sync(FULL, wf, 1);
  // the elements before this thread's first head take the lanes below;
  // those whose run reaches back to the warp's first element (through[j])
  // also take the warp's carry
  bool open = true;
  unsigned through = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    open = open && !head[j];
    if (open && lane > 0) v[j] = combine<OP>(ev, v[j]);
    if (open && (lane == 0 || !ef)) through |= 1u << j;
  }
  if (lane == 31) {
    s_value[warp] = wv;
    s_flag[warp] = wf;
    s_last_key[warp] = k[ITEMS - 1];
  }
  if (lane == 0) s_first_key[warp] = k[0];
  __syncthreads();

  if (warp == 0) {
    // each warp's first flag, and the scan over the warp aggregates
    int edge = 1, f = 1;
    double x = identity<OP>();
    if (lane < WARPS) {
      const long long first = t0 + (long long)lane * 32 * ITEMS;
      if (lane == 0)
        edge = tile == 0 || keys[t0] != keys[t0 - 1];
      else
        edge = first >= n || s_first_key[lane] != s_last_key[lane - 1];
      x = s_value[lane];
      f = s_flag[lane] | edge;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double x2 = __shfl_up_sync(FULL, x, d);
      const int f2 = __shfl_up_sync(FULL, f, d);
      if (lane >= d) {
        if (!f) x = combine<OP>(x2, x);
        f |= f2;
      }
    }
    const double xv = __shfl_up_sync(FULL, x, 1);  // the warps below, in this tile
    const int xf = __shfl_up_sync(FULL, f, 1);
    const double tile_v = __shfl_sync(FULL, x, WARPS - 1);
    const int tile_f = __shfl_sync(FULL, f, WARPS - 1);
    const int tile_edge = __shfl_sync(FULL, edge, 0);
    double carry = 0.0;
    if (tiles > 1) {
      unsigned long long* state = scratch + 1;
      double* value = reinterpret_cast<double*>(scratch + 1 + tiles);
      if (lane == 0) publish(state + tile, value + tile, tile_f ? PREFIX : AGGREGATE, tile_v);
      if (!tile_edge) carry = look_back<OP>(state, value, tile, lane);
    }
    if (lane < WARPS) {
      // what carries into warp `lane`: nothing past a head at its first
      // element; else the warps below, and the tile's carry if their runs
      // reach back to the tile's first element
      s_carry_ok[lane] = !edge;
      s_carry[lane] = lane == 0 ? carry : (xf ? xv : combine<OP>(carry, xv));
    }
  }
  __syncthreads();

  if (s_carry_ok[warp]) {
    const double c = s_carry[warp];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (through >> j & 1u) v[j] = combine<OP>(c, v[j]);
  }
  if (vec) {
#pragma unroll
    for (int h = 0; h < ITEMS / 2; ++h)
      reinterpret_cast<double2*>(out + i0)[h] = make_double2(v[2 * h], v[2 * h + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (i0 + j < n) out[i0 + j] = v[j];
  }
}

template <int OP>
void launch(const int* keys, const double* vals, double* out, long long n, int tiles,
            unsigned long long* scratch, cudaStream_t stream) {
  segment_scan_kernel<OP><<<tiles, THREADS, 0, stream>>>(keys, vals, out, n, tiles, scratch);
}

}  // namespace

// op: 0 sum (and count), 1 min, 2 max. vals may be null: every value is 1
// (count). scratch: 1 + 2 * tiles zeroed 64-bit words (a ticket counter, a
// state per tile, then a double value per tile) when n > TILE = 4096
// elements, else unused.
extern "C" int segment_scan_launch(const int* keys, const double* vals, double* out, long long n,
                                   int op, unsigned long long* scratch, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tiles > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (op == 0)
    launch<0>(keys, vals, out, n, (int)tiles, scratch, st);
  else if (op == 1)
    launch<1>(keys, vals, out, n, (int)tiles, scratch, st);
  else
    launch<2>(keys, vals, out, n, (int)tiles, scratch, st);
  return (int)cudaGetLastError();
}
