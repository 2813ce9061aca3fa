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
// is 31 MB, about 9 us at 3.35 TB/s. Reaching it takes many bytes in
// flight per SM (tens of KB at device-memory latency), so the design is
// about memory-level parallelism first.
//
// Design. The TPU kernel counted with a (P, BLOCK) one-hot comparison
// matrix summed across a sequential grid. Here a grid of at most a few
// blocks per SM walks the keys in steps of THREADS x VPT vectors of VEC
// keys: each thread issues all VPT key loads of a step before it uses any,
// and stores its pids as vectors of the same width. The keys may start at
// any 4-byte phase (a row view of a batch matrix): the few keys before the
// first aligned vector and after the last are done one by one, and the
// wrapper lays pid on the keys' phase so that one index is aligned for
// both. Each warp counts into one of `copies` private sub-histograms in
// shared memory (native shared atomicAdd; a thread first merges runs of
// equal pids among its VEC consecutive keys). Under skew (all keys equal,
// all NULL, P = 1) a warp whose step holds one pid adds it once
// (__all_sync). At the end each block sums its copies and adds the nonzero
// bins into hist, which the wrapper hands over zeroed (from a slab it
// zeroes once for many calls, so a call is one launch); a grid of one
// block stores hist straight from shared memory. Integer counts make the
// histogram exact in any order.
//
// Three instances, each with its blocks per SM compiled in. For the
// engine's large builds, 512 threads of four 16-byte vectors, one block
// per SM (32 KB of loads in flight an SM, and one flush of P atomics per
// SM). For smaller inputs, where a few blocks of large steps would leave
// most SMs idle, 256 threads of one key each, at most four blocks an SM.
// For a batch of at most 4,096 keys the same shape with no shared memory
// at all: each warp merges its equal pids (__match_any_sync) and adds them
// straight into hist, which saves zeroing and summing a shared histogram
// per block. kernel_sweep.py builds the other shapes from these templates,
// and its own variants (pids only, other merges and flushes) from the
// device functions below.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// how a step's pids are counted: shared sub-histograms (runs of equal
// pids, one add for a warp-uniform step), or merged per warp
// (__match_any_sync) straight into the zeroed hist
constexpr int HIST_ATOMIC = 0, HIST_GLOBAL = 1;
constexpr int INSTANCE_SMALL = 0, INSTANCE_BATCH = 1, INSTANCE_LARGE = 2;
constexpr int LARGE_THREADS = 512, LARGE_VEC = 4, LARGE_VPT = 4, LARGE_BLOCKS_PER_SM = 1;
constexpr int SMALL_THREADS = 256, SMALL_BLOCKS_PER_SM = 4;
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory, opted in

__device__ __forceinline__ int part_of(int key, unsigned pmask) {
  return (int)((((unsigned)key * 0x9E3779B1u) >> 16) & pmask);
}

template <int V>
__device__ __forceinline__ void load_vec(const int* p, int* v) {
  if constexpr (V == 4) {
    int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    int2 t = *reinterpret_cast<const int2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(int* p, const int* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// one shared atomic per run of equal pids among a thread's V keys
template <int V>
__device__ __forceinline__ void add_runs(int* h, const int* p) {
  int run = 1;
#pragma unroll
  for (int e = 1; e < V; ++e) {
    if (p[e] == p[e - 1]) {
      ++run;
    } else {
      atomicAdd(&h[p[e - 1]], run);
      run = 1;
    }
  }
  atomicAdd(&h[p[V - 1]], run);
}

// HIST_ATOMIC's count of a step: one add for a whole step of one pid, else
// the runs of each vector. `full`: the step is whole (block-uniform); else
// vector base + j * T exists only below nv.
template <int T, int V, int PER>
__device__ __forceinline__ void add_step(int* h, const int (&p)[PER][V], bool full,
                                         long long base, long long nv) {
  if (full) {
    const int p0 = __shfl_sync(FULL, p[0][0], 0);
    bool same = true;
#pragma unroll
    for (int j = 0; j < PER; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) same &= p[j][e] == p0;
    if (__all_sync(FULL, same)) {
      if ((threadIdx.x & 31) == 0) atomicAdd(&h[p0], 32 * PER * V);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (full || base + j * T < nv) add_runs<V>(h, p[j]);
}

// HIST_GLOBAL's count of a step: the warp's equal pids merged, one add each
template <int T, int V, int PER>
__device__ __forceinline__ void match_step(int* h, const int (&p)[PER][V], bool full,
                                           long long base, long long nv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool valid = full || base + j * T < nv;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const unsigned peers = __match_any_sync(FULL, valid ? p[j][e] : -1);
      if (valid && lane == __ffs(peers) - 1) atomicAdd(&h[p[j][e]], __popc(peers));
    }
  }
}

// The walk over the keys, writing every key's pid. Block 0 does the keys
// before the first aligned vector and after the last one by one, each
// counted by one(p); the rest go in grid-strided steps of T x PER vectors
// of V keys, a thread issuing all PER loads of a step before it uses any,
// each step counted by step(p, full, base, nv) as add_step takes it.
template <int T, int V, int PER, class One, class Step>
__device__ __forceinline__ void walk(const int* __restrict__ keys, long long n, long long head,
                                     unsigned pmask, int* __restrict__ pid, One one, Step step) {
  const long long nv = (n - head) / V;
  const long long tail = head + nv * V;
  if (blockIdx.x == 0 && threadIdx.x < 2 * V) {
    const long long i = threadIdx.x < head ? threadIdx.x : tail + threadIdx.x - head;
    if (threadIdx.x < head || i < n) {
      const int p = part_of(keys[i], pmask);
      pid[i] = p;
      one(p);
    }
  }
  const int* kv = keys + head;
  int* pv = pid + head;
  constexpr long long STEP = (long long)T * PER;  // vectors a block step
  const long long steps = (nv + STEP - 1) / STEP;
  for (long long s = blockIdx.x; s < steps; s += gridDim.x) {
    const long long base = s * STEP + threadIdx.x;
    const bool full = (s + 1) * STEP <= nv;  // block-uniform
    int p[PER][V];
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (full || base + j * T < nv) load_vec<V>(kv + (base + j * T) * V, p[j]);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) p[j][e] = part_of(p[j][e], pmask);
      if (full || base + j * T < nv) store_vec<V>(pv + (base + j * T) * V, p[j]);
    }
    step(p, full, base, nv);
  }
}

template <int T>
__device__ __forceinline__ void zero_shared(int4* sh4, int bins) {
  int* sh = reinterpret_cast<int*>(sh4);
  for (int i = threadIdx.x; i < bins / 4; i += T) sh4[i] = make_int4(0, 0, 0, 0);
  for (int i = (bins & ~3) + threadIdx.x; i < bins; i += T) sh[i] = 0;
  __syncthreads();
}

// bin i summed over a block's copies of the histogram
__device__ __forceinline__ int sum_copies(const int* sh, int i, int n_parts, int copies) {
  int c = sh[i];
  for (int k = 1; k < copies; ++k) c += sh[k * n_parts + i];
  return c;
}

template <int T, int V, int PER, int HIST>
__global__ void __launch_bounds__(T)
radix_partition_kernel(const int* __restrict__ keys, long long n, long long head,
                       int n_parts, int copies, int* __restrict__ pid,
                       int* __restrict__ hist) {
  extern __shared__ int4 sh4[];
  int* sh = reinterpret_cast<int*>(sh4);
  if (HIST == HIST_ATOMIC) zero_shared<T>(sh4, copies * n_parts);
  // the warp's sub-histogram, or (HIST_GLOBAL) the zeroed hist itself
  int* my = HIST == HIST_GLOBAL ? hist : sh + ((threadIdx.x >> 5) % copies) * n_parts;
  walk<T, V, PER>(keys, n, head, (unsigned)(n_parts - 1), pid,
                  [&](int p) { atomicAdd(&my[p], 1); },
                  [&](const int (&p)[PER][V], bool full, long long base, long long nv) {
                    if constexpr (HIST == HIST_ATOMIC) {
                      add_step<T, V, PER>(my, p, full, base, nv);
                    } else {
                      match_step<T, V, PER>(my, p, full, base, nv);
                    }
                  });
  if (HIST == HIST_GLOBAL) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n_parts; i += T) {
    const int c = sum_copies(sh, i, n_parts, copies);
    if (gridDim.x == 1) {
      hist[i] = c;
    } else if (c) {
      atomicAdd(&hist[i], c);
    }
  }
}

// A launch's checks, shared-memory opt-in and grid: `head` keys before the
// first aligned vector, one block per step of keys, at most blocks_per_sm
// an SM. pid must lie on the keys' V-vector phase. 0 or a cudaError.
template <int T, int V, int PER, class K>
int prepare(K kernel, const int* keys, long long n, int n_parts, int copies, size_t smem,
            int blocks_per_sm, const int* pid, long long* head, unsigned* blocks) {
  const uintptr_t align = V * sizeof(int);
  if (n < 0 || n_parts < 1 || (n_parts & (n_parts - 1)) || copies < 1 ||
      copies > T / 32 || smem > (size_t)SMEM_MAX ||
      ((uintptr_t)keys - (uintptr_t)pid) % align != 0)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long mis = (long long)(((uintptr_t)keys % align) / sizeof(int));
  *head = mis ? (V - mis < n ? V - mis : n) : 0;
  const long long step = (long long)T * PER * V;
  long long b = (n - *head + step - 1) / step;
  if (b < 1) b = 1;
  if (b > (long long)sms * blocks_per_sm) b = (long long)sms * blocks_per_sm;
  *blocks = (unsigned)b;
  return 0;
}

// hist must be zero
template <int T, int V, int PER, int HIST, int BLOCKS_PER_SM>
int launch(const int* keys, long long n, int n_parts, int copies, int* pid, int* hist,
           cudaStream_t stream) {
  const size_t smem = HIST == HIST_ATOMIC ? (size_t)copies * n_parts * sizeof(int) : 0;
  auto kernel = radix_partition_kernel<T, V, PER, HIST>;
  long long head = 0;
  unsigned blocks = 0;
  const int e = prepare<T, V, PER>(kernel, keys, n, n_parts, copies, smem, BLOCKS_PER_SM,
                                   pid, &head, &blocks);
  if (e) return e;
  kernel<<<blocks, T, smem, stream>>>(keys, n, head, n_parts, copies, pid, hist);
  return (int)cudaGetLastError();
}

}  // namespace

// hist must be zero; instance is one of INSTANCE_*
extern "C" int radix_partition_launch(const int* keys, long long n, int n_parts,
                                      int instance, int copies, int* pid, int* hist,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (instance) {
    case INSTANCE_LARGE:
      return launch<LARGE_THREADS, LARGE_VEC, LARGE_VPT, HIST_ATOMIC, LARGE_BLOCKS_PER_SM>(
          keys, n, n_parts, copies, pid, hist, st);
    case INSTANCE_BATCH:
      return launch<SMALL_THREADS, 1, 1, HIST_GLOBAL, SMALL_BLOCKS_PER_SM>(
          keys, n, n_parts, copies, pid, hist, st);
    case INSTANCE_SMALL:
      return launch<SMALL_THREADS, 1, 1, HIST_ATOMIC, SMALL_BLOCKS_PER_SM>(
          keys, n, n_parts, copies, pid, hist, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" void radix_partition_limits(int* large_threads, int* large_vec,
                                       int* large_blocks_per_sm, int* small_threads,
                                       int* small_blocks_per_sm, int* smem_max) {
  *large_threads = LARGE_THREADS;
  *large_vec = LARGE_VEC;
  *large_blocks_per_sm = LARGE_BLOCKS_PER_SM;
  *small_threads = SMALL_THREADS;
  *small_blocks_per_sm = SMALL_BLOCKS_PER_SM;
  *smem_max = SMEM_MAX;
}
