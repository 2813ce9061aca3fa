// bloom_build / bloom_probe: the blocked bloom filter of sideways
// information passing — a join's build keys summarised as one uint32 word
// per block, two bits per key, tested by the probe side's scans.
//
// Replaces the Pallas TPU kernels bloom_build_pallas and bloom_probe_pallas
// (src/repro/kernels/bloom_filter.py). Address computation, bit for bit as
// the reference's vecops.bloom_hash:
//     h1 = uint32(key) * 0x9E3779B1,  h2 = uint32(key) * 0x85EBCA6B
//     word = (h1 >> 18) & (W - 1)
//     bits = (1 << (h1 & 31)) | (1 << ((h2 >> 13) & 31))
// build ORs bits into words[word]; probe is (words[word] & bits) == bits.
//
// What bounds them on the H100: build, bytes (4 per key read, the words
// written once: 1.37M keys into 2^20 words is 9.7 MB, ~3 us); probe, one
// 32-byte sector per query at a random word (the words are L2-resident
// after the build), plus 5 bytes of key and result. At a scan's batch of
// 4,096 rows the probe is far below the launch's own cost, so what the
// card loses is the launches around it.
//
// The TPU kernels had no scatter or gather they could afford, so the build
// was a one-hot (word x key) product per bit plane and the probe a one-hot
// sum over word tiles.
//
// Build design. h1 is 32 bits, so (h1 >> 18) has 14: whatever W, a key
// reaches only the first R = min(W, 2^14) words (at most 64 KB), and every
// key of a large build lands in those. One thread a key with a global
// atomicOr each (the first port) queued 1.37M atomics on 64 KB of L2. Here
// one launch of at most one block per SM does the whole build:
//   - each block ORs its keys into a private copy of the R words in shared
//     memory: keys in 16-byte vectors, UNROLL vectors in flight a thread;
//     a key equal to the one before it (the engine's build layouts are
//     sorted, so duplicates sit together) is skipped, and so is the atomic
//     where the word already holds the key's bits (OR is idempotent and
//     order-free, so the result stays exact);
//   - the same launch writes the words [R, W) as zeros with 16-byte
//     stores, and takes the key range: warp reductions, then one atomicMax
//     per block into a zeroed two-word result, min and max encoded so
//     that zero is their identity;
//   - the blocks OR their copies' nonzero words into the words with
//     coalesced global atomics (a warp's 32 words are one L2 line). Those
//     words must start at zero: the first block to take a ticket when it
//     starts zeroes them and raises a flag, which the others wait for
//     (acquire loads) before they merge; the ticket and the flag sit on
//     L2 lines apart from the range's. One block alone stores its copy.
// So every word is written in the launch, with no fill launch, and a call
// is one launch and one 8-byte read of the range. kernel_sweep.py builds
// the merges that lost from these device functions (a cluster's copies
// merged through distributed shared memory, with partials and a ticket a
// slice; a copy spread over a cluster, keys routed by remote atomics; the
// first block to reach a slice storing it; a control warp for the ticket;
// the state on one line): the first three wait on chains of fences and
// tickets or on remote atomics. Words zeroed before the launch would save
// about 2 us of the in-launch zeroing (PERF.md), at a fill launch a call.
//
// Probe design. The probe is one kernel, bloom_probe_kernel, that
// computes a scan batch's whole SIP mask: for every row i < n_rows
//     out[i] = mask_in[i] AND over the descriptor's terms of
//              (lo <= codes[i] <= hi and (no words or member(codes[i])))
// and out[i] = false for n_rows <= i < capacity. The terms (up to
// SIP_TERMS filters, each a codes column, its words or none, and its code
// range) travel by value in a fixed-size descriptor; a scan with more
// filters takes further launches over the same mask. The kernel is
// compiled for each count of terms, so a one-filter launch runs code as
// short as a plain probe's, and launched at one row a thread: a scan batch
// of 4,096 rows is latency-bound (a code load, then a word load), and more
// threads on more SMs shorten it. From WIDE_FROM rows a thread takes four
// rows, with a 16-byte load of each term's codes where the column is
// 16-byte aligned (a column view may sit at any 4-byte phase) and one
// 4-byte read and write of the mask where it is aligned. Every term's code
// loads are issued before its word loads. mask_in may equal out (in
// place) or be null (all true: the membership mask of bloom_probe(words,
// queries), one term over the whole int32 range).
//
// A term may carry a counter pair (the SIP filter's row for this batch,
// zeroed): the same launch adds the rows of [0, n_rows) that the term
// alone rejects, whatever mask_in holds, and sets the second word to 1
// where the term has words and a row fell inside its range (a bloom
// probe), as the reference counts a filter. A warp sums its rows and its
// first lane adds them with one atomic, so counting takes no launch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// build (kernel_sweep.py's choice of threads and vectors in flight)
constexpr int REACH = 1 << 14;  // words a key can reach: (h1 >> 18) has 14 bits
constexpr int BUILD_THREADS = 1024;
constexpr int UNROLL = 4;         // 16-byte key vectors in flight a thread
// zeroed state words a build takes: the range's two, then the start
// ticket and the flag that the reachable words are zero, each on a 128-byte
// line of its own, apart from the range's atomics (kernel_sweep.py's
// "shared line" variant: 0.5 us slower at the q6 shape)
constexpr int TICKET = 32;
constexpr int FLAG = 64;
constexpr int STATE_WORDS = 96;
constexpr int THREADS = 128;  // probe
// rows a thread (kernel_sweep.py's choice): one, and from WIDE_FROM rows
// WIDE_ITEMS with 16-byte code loads
constexpr int ITEMS = 1;
constexpr int WIDE_ITEMS = 4;
constexpr int WIDE_FROM = 1 << 18;
constexpr int SIP_TERMS = 4;  // filters one descriptor holds

// one SIP filter; 32 bytes, as the wrapper packs it (four 64-bit words)
struct SipTerm {
  const int* codes;
  const unsigned* words;  // null: range only
  unsigned long long wmask;
  int lo, hi;
};

// the terms, their count, then each term's counter pair or null (the
// wrapper's descriptor: five 64-bit words a term and one)
struct SipDesc {
  SipTerm t[SIP_TERMS];
  long long n_terms;
  unsigned long long* counts[SIP_TERMS];
};

// the lanes of the calling thread's warp that have rows below capacity
// (the others returned): the warp's first rows come first
__device__ __forceinline__ unsigned live_lanes(long long warp_r0, int items, int capacity) {
  const long long n = (capacity - warp_r0 + items - 1) / items;
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

__device__ __forceinline__ void bloom_hash(int key, unsigned wmask,
                                           unsigned* word, unsigned* bits) {
  unsigned u = (unsigned)key;
  unsigned h1 = u * 0x9E3779B1u;
  unsigned h2 = u * 0x85EBCA6Bu;
  *word = (h1 >> 18) & wmask;
  *bits = (1u << (h1 & 31u)) | (1u << ((h2 >> 13) & 31u));
}

// one key into the private copy and the range: skip the atomic where
// the word already holds the bits; the range as two maxima whose identity
// is 0 (the min as the max of ~(key biased to unsigned))
__device__ __forceinline__ void add_key(unsigned* s_words, int key, unsigned wmask,
                                        unsigned& lo_m, unsigned& hi_m) {
  unsigned w, b;
  bloom_hash(key, wmask, &w, &b);
  if ((s_words[w] & b) != b) atomicOr(s_words + w, b);
  const unsigned biased = (unsigned)key ^ 0x80000000u;
  lo_m = max(lo_m, ~biased);
  hi_m = max(hi_m, biased);
}

// The private copy of the R reachable words zeroed, and this block's part
// of the words [R, W) zeroed with 16-byte stores.
template <int T>
__device__ __forceinline__ void zero_copy_and_fill(int n_words, unsigned* __restrict__ words,
                                                   unsigned* s_words) {
  const int r_words = n_words < REACH ? n_words : REACH;
  if (n_words > r_words) {  // R = 2^14 here: words + R keeps the 16-byte phase
    uint4* z = reinterpret_cast<uint4*>(words + r_words);
    const long long nz = (long long)(n_words - r_words) >> 2;
    const long long n_threads = (long long)gridDim.x * T;
    for (long long i = (long long)blockIdx.x * T + threadIdx.x; i < nz; i += n_threads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < r_words; i += T) s_words[i] = 0u;
}

// This block's keys ORed into its private copy (zeroed, after a barrier)
// by its first K threads (whole warps), and their range as two maxima
// (add_key) over the thread's keys.
template <int K>
__device__ __forceinline__ void add_keys(const int* __restrict__ keys, long long n,
                                         int n_words, unsigned* s_words, unsigned& lo_m,
                                         unsigned& hi_m) {
  const unsigned wmask = (unsigned)n_words - 1u;
  const long long tid = (long long)blockIdx.x * K + threadIdx.x;
  const long long n_threads = (long long)gridDim.x * K;
  const unsigned lane = threadIdx.x & 31u;
  // keys before the first 16-byte boundary, the vectors, the tail
  long long head = (long long)(((16u - ((unsigned)(uintptr_t)keys & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const long long nv = (n - head) >> 2;
  const long long tail0 = head + 4 * nv;
  if (tid < head) add_key(s_words, keys[tid], wmask, lo_m, hi_m);
  if (tid < n - tail0) add_key(s_words, keys[tail0 + tid], wmask, lo_m, hi_m);
  const int4* kv = reinterpret_cast<const int4*>(keys + head);
  // lanes of a warp hold consecutive vectors, so the loop test is warp-uniform
  for (long long v0 = tid; v0 - lane < nv; v0 += (long long)UNROLL * n_threads) {
    int4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long v = v0 + u * n_threads;
      x[u] = v < nv ? __ldcs(kv + v) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      // the key before this vector's first is the last of the lane before
      const int prev = __shfl_up_sync(0xffffffffu, x[u].w, 1);
      if (v0 + u * n_threads < nv) {
        if (lane == 0 || x[u].x != prev) add_key(s_words, x[u].x, wmask, lo_m, hi_m);
        if (x[u].y != x[u].x) add_key(s_words, x[u].y, wmask, lo_m, hi_m);
        if (x[u].z != x[u].y) add_key(s_words, x[u].z, wmask, lo_m, hi_m);
        if (x[u].w != x[u].z) add_key(s_words, x[u].w, wmask, lo_m, hi_m);
      }
    }
  }
}

// The block's range into state[0..1]: warp reductions, then one atomic
// each from thread 0. s_red holds T / 16 words. Begins with a barrier.
template <int T>
__device__ __forceinline__ void block_range(unsigned lo_m, unsigned hi_m, unsigned* s_red,
                                            unsigned* state) {
  lo_m = __reduce_max_sync(0xffffffffu, lo_m);
  hi_m = __reduce_max_sync(0xffffffffu, hi_m);
  if ((threadIdx.x & 31u) == 0) {
    s_red[threadIdx.x >> 5] = lo_m;
    s_red[T / 32 + (threadIdx.x >> 5)] = hi_m;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    lo_m = threadIdx.x < T / 32 ? s_red[threadIdx.x] : 0u;
    hi_m = threadIdx.x < T / 32 ? s_red[T / 32 + threadIdx.x] : 0u;
    lo_m = __reduce_max_sync(0xffffffffu, lo_m);
    hi_m = __reduce_max_sync(0xffffffffu, hi_m);
    if (threadIdx.x == 0 && (lo_m | hi_m)) {
      atomicMax(state, lo_m);
      atomicMax(state + 1, hi_m);
    }
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// state: [0..1] the range, [TICKET] the start ticket, [FLAG] the flag that
// the reachable words are zero
template <int T>
__global__ void __launch_bounds__(T, 1)
bloom_build_kernel(const int* __restrict__ keys, long long n, int n_words,
                   unsigned* __restrict__ words, unsigned* __restrict__ state) {
  extern __shared__ unsigned s_words[];
  __shared__ unsigned s_red[T / 16];
  __shared__ unsigned s_ticket;
  const int r_words = n_words < REACH ? n_words : REACH;
  const bool alone = gridDim.x == 1;
  if (!alone && threadIdx.x == 0) s_ticket = atomicAdd(state + TICKET, 1u);
  zero_copy_and_fill<T>(n_words, words, s_words);
  __syncthreads();
  // the first block to start zeroes the reachable words and raises the flag
  const bool zeroes = !alone && s_ticket == 0;
  if (zeroes) {
    for (int i = threadIdx.x; i < r_words; i += T) words[i] = 0u;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicExch(state + FLAG, 1u);
    }
  }
  unsigned lo_m = 0u, hi_m = 0u;
  add_keys<T>(keys, n, n_words, s_words, lo_m, hi_m);
  block_range<T>(lo_m, hi_m, s_red, state);
  if (alone) {
    for (int i = threadIdx.x; i < r_words; i += T) words[i] = s_words[i];
    return;
  }
  // the others wait for the flag: the block that holds ticket 0 is running
  // and waits on nothing, so the wait ends
  if (!zeroes && threadIdx.x == 0)
    while (load_acquire(state + FLAG) == 0u) __nanosleep(32);
  __syncthreads();
  // a warp's 32 consecutive words are one L2 line
  for (int i = threadIdx.x; i < r_words; i += T) {
    const unsigned v = s_words[i];
    if (v) atomicOr(words + i, v);
  }
}

// one launch of the build: `blocks` blocks of T threads, each with the R
// words' copy in dynamic shared memory; state is STATE_WORDS zeroed words
template <int T>
int build_launch(const int* keys, long long n, int n_words, unsigned* words, unsigned* state,
                 int blocks, cudaStream_t stream) {
  if (n < 0 || n_words < 1 || (n_words & (n_words - 1)) || blocks < 1 || blocks > (1 << 16) ||
      state == nullptr)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;  // the shared-memory attribute, once a process
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(bloom_build_kernel<T>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         REACH * (int)sizeof(unsigned));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int r_words = n_words < REACH ? n_words : REACH;
  bloom_build_kernel<T><<<blocks, T, (size_t)r_words * sizeof(unsigned), stream>>>(
      keys, n, n_words, words, state);
  return (int)cudaGetLastError();
}

template <int NT, int IT>
__global__ void __launch_bounds__(THREADS)
bloom_probe_kernel(const SipDesc d, const unsigned char* mask_in,
                   unsigned char* out, int n_rows, int capacity) {
  const long long r0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * IT;
  if (r0 >= capacity) return;
  constexpr int NA = NT > 0 ? NT : 1;  // array extent (no zero-length arrays)
  const bool full = r0 + IT <= n_rows;
  // every term's codes for the thread's rows, all loads issued together
  int c[NA][IT];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int* p = d.t[k].codes + r0;
    bool vec = false;
    if constexpr (IT == 4) {
      if (full && ((uintptr_t)p & 15) == 0) {
        int4 v = *reinterpret_cast<const int4*>(p);
        c[k][0] = v.x; c[k][1] = v.y; c[k][2] = v.z; c[k][3] = v.w;
        vec = true;
      }
    }
    if (!vec) {
#pragma unroll
      for (int e = 0; e < IT; ++e) c[k][e] = r0 + e < n_rows ? p[e] : 0;
    }
  }
  // the rows' mask bytes, read while the codes arrive
  unsigned keep = 0;  // bit e: row r0 + e is kept
  const bool word_io = IT == 4 && r0 + IT <= capacity;
  if (mask_in == nullptr) {
    keep = (1u << IT) - 1;
  } else if (word_io && ((uintptr_t)(mask_in + r0) & 3) == 0) {
    unsigned m = *reinterpret_cast<const unsigned*>(mask_in + r0);
#pragma unroll
    for (int e = 0; e < IT; ++e) keep |= ((m >> (8 * e)) & 0xffu) ? 1u << e : 0u;
  } else {
#pragma unroll
    for (int e = 0; e < IT; ++e)
      if (r0 + e < capacity && mask_in[r0 + e]) keep |= 1u << e;
  }
#pragma unroll
  for (int e = 0; e < IT; ++e)
    if (r0 + e >= n_rows) keep &= ~(1u << e);
  // every term's filter words, all loads issued together
  unsigned w[NA][IT], b[NA][IT];
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const unsigned* words = d.t[k].words;
#pragma unroll
    for (int e = 0; e < IT; ++e) {
      unsigned wi;
      bloom_hash(c[k][e], (unsigned)d.t[k].wmask, &wi, &b[k][e]);
      w[k][e] = words ? __ldg(words + wi) : b[k][e];
    }
  }
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    unsigned rejected = 0;
    bool in_range = false;
#pragma unroll
    for (int e = 0; e < IT; ++e) {
      const bool in = c[k][e] >= d.t[k].lo && c[k][e] <= d.t[k].hi;
      if (!in || (w[k][e] & b[k][e]) != b[k][e]) {
        keep &= ~(1u << e);
        rejected += r0 + e < n_rows;
      }
      in_range |= in && r0 + e < n_rows;
    }
    unsigned long long* cnt = d.counts[k];
    if (cnt != nullptr) {  // the same for every thread of the launch
      const unsigned lanes = live_lanes(r0 - (long long)(threadIdx.x & 31) * IT, IT, capacity);
      rejected = __reduce_add_sync(lanes, rejected);
      in_range = __any_sync(lanes, in_range);
      if ((threadIdx.x & 31) == 0) {
        if (rejected) atomicAdd(cnt, (unsigned long long)rejected);
        if (in_range && d.t[k].words != nullptr) atomicMax(cnt + 1, 1ull);
      }
    }
  }
  if (word_io && ((uintptr_t)(out + r0) & 3) == 0) {
    unsigned m = 0;
#pragma unroll
    for (int e = 0; e < IT; ++e) m |= ((keep >> e) & 1u) << (8 * e);
    *reinterpret_cast<unsigned*>(out + r0) = m;
  } else {
#pragma unroll
    for (int e = 0; e < IT; ++e)
      if (r0 + e < capacity) out[r0 + e] = (keep >> e) & 1u;
  }
}

// one launch over the first d.n_terms terms: the instance compiled for
// that many, IT rows a thread
template <int IT>
int launch(const SipDesc& d, const unsigned char* mask_in, unsigned char* out,
           int n_rows, int capacity, cudaStream_t stream) {
  if (d.n_terms < 0 || d.n_terms > SIP_TERMS || n_rows < 0 ||
      n_rows > capacity)
    return (int)cudaErrorInvalidValue;
  if (capacity == 0) return (int)cudaGetLastError();
  const long long per_block = (long long)THREADS * IT;
  const unsigned blocks = (unsigned)((capacity + per_block - 1) / per_block);
  switch (d.n_terms) {
    case 0: bloom_probe_kernel<0, IT><<<blocks, THREADS, 0, stream>>>(d, mask_in, out, n_rows, capacity); break;
    case 1: bloom_probe_kernel<1, IT><<<blocks, THREADS, 0, stream>>>(d, mask_in, out, n_rows, capacity); break;
    case 2: bloom_probe_kernel<2, IT><<<blocks, THREADS, 0, stream>>>(d, mask_in, out, n_rows, capacity); break;
    case 3: bloom_probe_kernel<3, IT><<<blocks, THREADS, 0, stream>>>(d, mask_in, out, n_rows, capacity); break;
    default: bloom_probe_kernel<4, IT><<<blocks, THREADS, 0, stream>>>(d, mask_in, out, n_rows, capacity); break;
  }
  return (int)cudaGetLastError();
}

int probe(const SipDesc& d, const unsigned char* mask_in, unsigned char* out,
          int n_rows, int capacity, cudaStream_t stream) {
  return capacity >= WIDE_FROM
             ? launch<WIDE_ITEMS>(d, mask_in, out, n_rows, capacity, stream)
             : launch<ITEMS>(d, mask_in, out, n_rows, capacity, stream);
}

}  // namespace

// the build of n keys into n_words words (see the design above) over
// `blocks` blocks (the wrapper's launch_shape); the key range lands in
// state[0..1], encoded (the wrapper decodes it)
extern "C" int bloom_build_launch(const int* keys, long long n, int n_words,
                                  unsigned* words, unsigned* state, int blocks, void* stream) {
  return build_launch<BUILD_THREADS>(keys, n, n_words, words, state, blocks,
                                     (cudaStream_t)stream);
}

extern "C" void bloom_build_limits(int* threads, int* reach, int* state_words) {
  *threads = BUILD_THREADS;
  *reach = REACH;
  *state_words = STATE_WORDS;
}

// the membership mask of c queries: one term over the whole int32 range
extern "C" int bloom_probe_launch(const unsigned* words, int n_words,
                                  const int* queries, int c, bool* out,
                                  void* stream) {
  SipDesc d = {};
  d.t[0] = {queries, words, (unsigned long long)(n_words - 1), INT_MIN, INT_MAX};
  d.n_terms = 1;
  return probe(d, nullptr, reinterpret_cast<unsigned char*>(out), c, c,
               (cudaStream_t)stream);
}

// a scan batch's SIP mask: the SipDesc at desc, its terms over rows
// [0, n_rows) of out (capacity bytes), ANDed into mask_in (null: all true),
// each term's counts added into its counter pair where it has one.
// desc is untyped so that this function keeps external linkage.
extern "C" int sip_mask_launch(const void* desc, const bool* mask_in,
                               bool* out, int n_rows, int capacity,
                               void* stream) {
  return probe(*static_cast<const SipDesc*>(desc),
               reinterpret_cast<const unsigned char*>(mask_in),
               reinterpret_cast<unsigned char*>(out), n_rows, capacity,
               (cudaStream_t)stream);
}

extern "C" void sip_mask_limits(int* terms, int* desc_bytes) {
  *terms = SIP_TERMS;
  *desc_bytes = (int)sizeof(SipDesc);
}
