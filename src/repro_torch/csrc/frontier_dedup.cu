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
// What bounds it on the H100: bytes. Each candidate's pair is read once and
// its mask byte written once, and only the visited pairs inside the
// candidates' key range need reading, about once each. One thread per
// candidate with its own binary search of the visited set (about 19
// dependent two-sector steps at 480,000 pairs) was bound by latency
// instead, though neighbouring candidates search the same narrow window.
//
// Design: a block of THREADS covers a tile of TILE = THREADS * ITEMS
// consecutive candidates, ITEMS consecutive ones a thread; the wrapper
// picks the tile and the chunk S from the sizes (launch_shape; the sweep
// is kernel_sweep.py's).
//   1. Each thread loads its candidates with 16-byte loads when the two
//      columns share one 16-byte alignment phase (the tiles are laid on
//      that phase, so a column slice at any offset qualifies), else with
//      4-byte loads. The left neighbour of its first candidate comes from
//      the previous lane by a shuffle; lane 0 loads it. Position 0 passes
//      the adjacent test explicitly, with no sentinel, so a first candidate
//      of (INT32_MIN, INT32_MIN) is kept (the TPU kernel used INT32_MIN as
//      its neighbour padding and dropped it).
//   2. With a visited set, warps 0 and 1 find the tile's visited window
//      [vb, ve) at once: the lower bound of the tile's first candidate and
//      the upper bound of its last, each a warp-cooperative 33-ary search
//      (pair_search.cuh).
//   3. The block stages the window into shared memory in chunks of at most
//      S pairs (cp.async, 4 bytes each: vb is arbitrary), and each thread
//      answers its first occurrences against a chunk with a binary search
//      for the first and a galloping search forward for the rest. A window
//      longer than S is walked chunk by chunk.
//   4. A window longer than DIRECT_RATIO tiles would cost more to stage
//      than to search, and so does any window of a launch that the wrapper
//      gives no chunk (a small launch, or a visited set large against the
//      candidates): each thread then searches the window for its ITEMS
//      candidates at once, a branchless binary search with one load of
//      each search in flight a step.
//   5. The mask bytes of a thread go out as one ITEMS-byte store when
//      aligned (the wrapper lays the mask on the candidates' phase), else
//      byte by byte.
// Blocks walk the tiles with a stride, so any candidate count launches.
// The TPU kernel compared every candidate with every visited pair in
// (C_BLOCK, V_TILE) tiles (O(C * V)) to avoid gathers. The mask is written
// as bytes and viewed as torch.bool.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_search.cuh"

namespace {

constexpr long long MAX_BLOCKS = 1 << 20;
constexpr int PAIR_BYTES = 2 * sizeof(int);  // a staged visited pair
constexpr int SMEM_DEFAULT = 48 * 1024, SMEM_MAX = 232448;  // the H100's per-block limits
// the compiled tiles, (threads, candidates a thread): a small one for small
// launches, whose windows are searched, and a large one (kernel_sweep.py
// builds the other candidates from this source)
constexpr int SMALL_THREADS = 64, SMALL_ITEMS = 4;
constexpr int LARGE_THREADS = 256, LARGE_ITEMS = 8;
// a window longer than this many times the tile is searched, not staged
constexpr int DIRECT_RATIO = 8;

using pair_search::pair_less;

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// first x in [a, b) with staged pair x not below the key (b if none)
__device__ __forceinline__ int smem_lower(const int* s_hi, const int* s_lo, int a, int b,
                                          int kh, int kl) {
  while (a < b) {
    const int m = (a + b) >> 1;
    if (pair_less(s_hi[m], s_lo[m], kh, kl)) a = m + 1; else b = m;
  }
  return a;
}

// the same in [p, n), galloping forward from p: steps of 1, 2, 4, ...
// until a pair not below the key, then a binary search of the last step
__device__ __forceinline__ int smem_gallop(const int* s_hi, const int* s_lo, int p, int n,
                                           int kh, int kl) {
  int a = p, b = p, step = 1;
  while (b < n && pair_less(s_hi[b], s_lo[b], kh, kl)) {
    a = b + 1;
    b += step;
    step <<= 1;
  }
  return smem_lower(s_hi, s_lo, a, b < n ? b : n, kh, kl);
}

template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
frontier_dedup_kernel(const int* __restrict__ hi, const int* __restrict__ lo, long long c,
                      const int* __restrict__ vhi, const int* __restrict__ vlo, int v,
                      int chunk, unsigned char* __restrict__ mask) {
  static_assert(ITEMS == 4 || ITEMS == 8 || ITEMS == 16, "ITEMS: 4, 8 or 16");
  static_assert(THREADS >= 64 && THREADS % 32 == 0, "two warps search the window");
  constexpr int TILE = THREADS * ITEMS;
  extern __shared__ int smem[];  // a chunk of the window: S hi's, then S lo's
  int* s_hi = smem;
  int* s_lo = smem + chunk;
  __shared__ int window[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // tiles are laid on the columns' 16-byte phase when they share one
  const int phase = (int)(((uintptr_t)hi >> 2) & 3);
  const bool vec = phase == (int)(((uintptr_t)lo >> 2) & 3);
  const int shift = vec ? phase : 0;
  const long long n_tiles = (c + shift + TILE - 1) / TILE;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long j0 = t * TILE + (long long)tid * ITEMS - shift;
    const bool full = j0 >= 0 && j0 + ITEMS <= c;
    int h[ITEMS], l[ITEMS];
    if (vec && full) {
      const int4* h4 = reinterpret_cast<const int4*>(hi + j0);
      const int4* l4 = reinterpret_cast<const int4*>(lo + j0);
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q) {
        const int4 x = h4[q], y = l4[q];
        h[4 * q] = x.x; h[4 * q + 1] = x.y; h[4 * q + 2] = x.z; h[4 * q + 3] = x.w;
        l[4 * q] = y.x; l[4 * q + 1] = y.y; l[4 * q + 2] = y.z; l[4 * q + 3] = y.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const long long j = j0 + u;
        const bool in = j >= 0 && j < c;
        h[u] = in ? hi[j] : 0;
        l[u] = in ? lo[j] : 0;
      }
    }
    // the left neighbour of item 0: the previous lane's last item
    int nh = __shfl_up_sync(0xffffffffu, h[ITEMS - 1], 1);
    int nl = __shfl_up_sync(0xffffffffu, l[ITEMS - 1], 1);
    if (lane == 0 && j0 >= 1 && j0 <= c) {
      nh = hi[j0 - 1];
      nl = lo[j0 - 1];
    }
    unsigned keep = 0;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const long long j = j0 + u;
      const int ph = u == 0 ? nh : h[u - 1];
      const int pl = u == 0 ? nl : l[u - 1];
      const bool first = j == 0 || ph != h[u] || pl != l[u];
      if (j >= 0 && j < c && first) keep |= 1u << u;
    }

    if (v > 0) {
      if (warp < 2) {
        // the window: lower bound of the tile's first candidate (warp 0),
        // upper bound of its last (warp 1)
        const long long tf = t * TILE - shift;
        const long long jk = warp == 0 ? (tf > 0 ? tf : 0) : (tf + TILE < c ? tf + TILE : c) - 1;
        const int r = pair_search::bound<32>(vhi, vlo, 0, v, hi[jk], lo[jk],
                                                            warp == 1, 0xffffffffu, lane);
        if (lane == 0) window[warp] = r;
      }
      __syncthreads();
      const int vb = window[0], ve = window[1];
      // an empty window reads nothing: a tile past the set's last pair has
      // vb == ve == v, and vhi[v] lies past the set
      if (ve > vb && (chunk == 0 || ve - vb > DIRECT_RATIO * TILE)) {
        // a window far longer than the tile (or no chunk: the wrapper
        // expects such windows): staging it would read many pairs per
        // candidate, so each thread searches it for its ITEMS candidates
        // at once, one load of each search in flight a step
        int base[ITEMS];
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) base[u] = vb;
        for (int len = ve - vb; len > 1;) {
          const int half = len >> 1;
#pragma unroll
          for (int u = 0; u < ITEMS; ++u) {
            const int m = base[u] + half;
            base[u] = pair_less(vhi[m], vlo[m], h[u], l[u]) ? m : base[u];
          }
          len -= half;
        }
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
          const int vh = vhi[base[u]], vl = vlo[base[u]];
          // base[u] is the last pair below the candidate, or the window's
          // first, and lies in [vb, ve); the candidate occurs iff it is
          // that pair or the next
          bool seen = vh == h[u] && vl == l[u];
          if (!seen && pair_less(vh, vl, h[u], l[u]) && base[u] + 1 < ve)
            seen = vhi[base[u] + 1] == h[u] && vlo[base[u] + 1] == l[u];
          if (seen) keep &= ~(1u << u);
        }
      } else {
        for (int base = vb; base < ve; base += chunk) {
          const int n = ve - base < chunk ? ve - base : chunk;
          for (int k = tid; k < n; k += THREADS) {
            cp_async4(s_hi + k, vhi + base + k);
            cp_async4(s_lo + k, vlo + base + k);
          }
          cp_async_wait_all();
          __syncthreads();
          // the thread's live candidates merge against the chunk: a binary
          // search for the first, then galloping forward
          int p = -1;
#pragma unroll
          for (int u = 0; u < ITEMS; ++u) {
            if (!((keep >> u) & 1u) || p >= n) continue;
            p = p < 0 ? smem_lower(s_hi, s_lo, 0, n, h[u], l[u])
                      : smem_gallop(s_hi, s_lo, p, n, h[u], l[u]);
            if (p < n && s_hi[p] == h[u] && s_lo[p] == l[u]) keep &= ~(1u << u);
          }
          __syncthreads();  // the chunk is read before the next one lands
        }
      }
      __syncthreads();  // the window is read before the next tile's
    }

    unsigned char* out = mask + j0;
    if (full && ((uintptr_t)out & (ITEMS - 1)) == 0) {
      unsigned w[ITEMS / 4];
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q)
        w[q] = ((keep >> (4 * q)) & 1u) | (((keep >> (4 * q + 1)) & 1u) << 8)
               | (((keep >> (4 * q + 2)) & 1u) << 16) | (((keep >> (4 * q + 3)) & 1u) << 24);
      if constexpr (ITEMS == 4) {
        *reinterpret_cast<unsigned*>(out) = w[0];
      } else if constexpr (ITEMS == 8) {
        *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const long long j = j0 + u;
        if (j >= 0 && j < c) out[u] = (unsigned char)((keep >> u) & 1u);
      }
    }
  }
}

template <int THREADS, int ITEMS>
int launch(const int* hi, const int* lo, long long c, const int* vhi, const int* vlo, int v,
           int smem, unsigned char* mask, cudaStream_t st) {
  constexpr int TILE = THREADS * ITEMS;
  auto kernel = frontier_dedup_kernel<THREADS, ITEMS>;
  static int sized = SMEM_DEFAULT;  // above 48 KB a kernel must ask for its shared memory
  if (smem > sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  long long blocks = (c + 3 + TILE - 1) / TILE;  // the tiles, at most one more for the phase
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  kernel<<<(unsigned int)blocks, THREADS, (size_t)smem, st>>>(hi, lo, c, vhi, vlo, v,
                                                              smem / PAIR_BYTES, mask);
  return (int)cudaGetLastError();
}

}  // namespace

// threads, items: the block's threads and candidates a thread, one of the
// two compiled tiles (frontier_dedup_limits). smem: the dynamic shared
// memory, PAIR_BYTES a staged visited pair (the wrapper's CHUNK), or 0 for
// an empty visited set or where every window is to be searched, not
// staged. Both come from the wrapper's launch_shape. Other values return
// cudaErrorInvalidValue without launching.
extern "C" int frontier_dedup_launch(const int* hi, const int* lo, long long c,
                                     const int* vhi, const int* vlo, int v,
                                     unsigned char* mask, int threads, int items, int smem,
                                     void* stream) {
  if (c <= 0) return (int)cudaGetLastError();
  if (smem < 0 || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (threads == SMALL_THREADS && items == SMALL_ITEMS)
    return launch<SMALL_THREADS, SMALL_ITEMS>(hi, lo, c, vhi, vlo, v, smem, mask, st);
  if (threads == LARGE_THREADS && items == LARGE_ITEMS)
    return launch<LARGE_THREADS, LARGE_ITEMS>(hi, lo, c, vhi, vlo, v, smem, mask, st);
  return (int)cudaErrorInvalidValue;
}

// The compiled tiles and the limits the wrapper sizes its launches by,
// checked once when the library loads (kernels/frontier_dedup.py).
extern "C" int frontier_dedup_limits(int* small_threads, int* small_items, int* large_threads,
                                     int* large_items, int* pair_bytes, int* smem_max) {
  *small_threads = SMALL_THREADS;
  *small_items = SMALL_ITEMS;
  *large_threads = LARGE_THREADS;
  *large_items = LARGE_ITEMS;
  *pair_bytes = PAIR_BYTES;
  *smem_max = SMEM_MAX;
  return 0;
}
