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
// written once: 1.37M keys into 2^20 words is 9.7 MB, ~3 us) and the
// atomics' throughput in L2, where the 4 MB of words stay; probe, one
// 32-byte sector per query at a random word (the words are L2-resident
// after the build), plus 5 bytes of key and result. At a scan's batch of
// 4,096 rows the probe is far below the launch's own cost, so what the
// card loses is the launches around it.
//
// Design. The build is one thread per key, an atomicOr into words the
// wrapper zeroed (OR is order-free, so the result is exact). The TPU
// kernels had no scatter or gather they could afford, so the build was a
// one-hot (word x key) product per bit plane and the probe a one-hot sum
// over word tiles. Here the probe is one kernel, bloom_probe_kernel, that
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

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BUILD_THREADS = 256;
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

struct SipDesc {
  SipTerm t[SIP_TERMS];
  long long n_terms;
};

__device__ __forceinline__ void bloom_hash(int key, unsigned wmask,
                                           unsigned* word, unsigned* bits) {
  unsigned u = (unsigned)key;
  unsigned h1 = u * 0x9E3779B1u;
  unsigned h2 = u * 0x85EBCA6Bu;
  *word = (h1 >> 18) & wmask;
  *bits = (1u << (h1 & 31u)) | (1u << ((h2 >> 13) & 31u));
}

__global__ void bloom_build_kernel(const int* __restrict__ keys, long long n,
                                   unsigned wmask, unsigned* words) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned w, b;
    bloom_hash(keys[i], wmask, &w, &b);
    atomicOr(&words[w], b);
  }
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
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int e = 0; e < IT; ++e)
      if (c[k][e] < d.t[k].lo || c[k][e] > d.t[k].hi || (w[k][e] & b[k][e]) != b[k][e])
        keep &= ~(1u << e);
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

extern "C" int bloom_build_launch(const int* keys, long long n, int n_words,
                                  unsigned* words, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + BUILD_THREADS - 1) / BUILD_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bloom_build_kernel<<<(unsigned int)blocks, BUILD_THREADS, 0,
                       (cudaStream_t)stream>>>(keys, n,
                                               (unsigned)(n_words - 1), words);
  return (int)cudaGetLastError();
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
// [0, n_rows) of out (capacity bytes), ANDed into mask_in (null: all true).
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
