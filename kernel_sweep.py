"""Sweep the compiled shapes of join_expand, gather_emit, expr_eval,
hash_probe, frontier_dedup, radix_partition, bloom_probe and bloom_build
on the card.

The port compiles one or a few instances of join_expand, gather_emit,
hash_probe, frontier_dedup, radix_partition and bloom_probe and picks one
from the input (join_expand: a tile for small windows and one for large;
gather_emit: a short unroll for narrow plans and one to the caps;
hash_probe: one group size; frontier_dedup: a small tile whose windows are
searched and a large one that stages them; radix_partition: a batch, a
small and a large instance by the key count; bloom_probe: one row a thread,
four for wide launches). This script compiles the candidates from the same
sources into its own libraries under ``build/kernel_sweep/`` — a small
``.cu`` for each that includes the source and exports each instance of its
``launch`` template — checks each instance against the plain PyTorch
version, and prints its device time per launch (``torch.profiler``, as
``chip_smoke.py`` measures). expr_eval's instance and block size are
launch arguments: every instance that takes a program is swept through the
wrapper's launch (``expr_eval._launch``, which ``expr_eval`` calls at
``launch_shape``'s choice) at 32 to 256 threads on six programs, at 4,096
and 2^20 rows. hash_probe's group size G (8, 16, 32 lanes a key) is swept
at 4,096, 65,536 and 2^20 keys over the 3,891,273-row build in 1,024
partitions, in one partition, and over a build whose keys repeat 1,000
times; frontier_dedup's tile T (threads times candidates a thread, 256 to
4,096) and shared-memory chunk S (none, or 1,024 to 16,384 visited pairs)
at 4,096 to 2^20 candidates against an empty visited set, one of about
480,000 pairs half inside the candidates' range, and one of 4,000,000
pairs dense in it (so a tile's window passes S). Then frontier_dedup's
launches in ``chip_smoke.py``'s paths phase (p1-p5 on the full-size LSQB
store) are recorded and replayed one by one at each compiled shape, with
their sizes and the visited pairs inside the candidates' range.
radix_partition is swept at 4,096 to 2^24 keys, 1 to 8,192 partitions
(and the engine's own pairs), uniform and skewed keys: the wrapper and
its time per call, each instance, the pids-only variant, torch.bincount
of the pids (the histogram half's yardstick); at a few inputs every
variant (vector width, vectors a thread, block size, histogram and flush
modes) and every blocks-per-SM and sub-histogram-copies shape. The SIP
step of a 4,096-row scan batch (one and two filters) is timed fused and
as the unfused sequence, per call and on the device, and bloom_probe at
one, two and four rows a thread. bloom_build is swept at 4,096 to 2^24
keys in random order, the hash join's grouped order, all equal and half
NULL: its wrapper, its kernel at 256 to 1,024 threads and 1 to 264 blocks,
and the merges that lost (BB_VARIANTS, built from bloom_filter.cu's device
functions). Every instance is checked against the plain version before it
is timed. The script also prints ``nvcc -Xptxas
-v`` and the local-memory (LDL / STL) and shared-memory (LDS / STS)
instruction counts of ``cuobjdump -sass`` for ``expr_eval.cu``,
``hash_probe.cu``, ``frontier_dedup.cu``, ``radix_partition.cu`` and
``bloom_filter.cu``.

With ``--parent DIR`` (an earlier checkout) it also builds and times that
checkout's one-thread-per-key ``hash_probe.cu``, one-thread-per-candidate
``frontier_dedup.cu``, one-key-a-thread ``radix_partition.cu`` (its
kernel, its kernel with the histogram's zero fill, and its wrapper per
call) and ``bloom_filter.cu`` (its probe, and the unfused SIP step around
it; its one-thread-a-key build, alone and with its wrapper's zero fill,
``aminmax`` and ``stack``, per call in turns with this tree's) on the same
inputs, and, where that checkout's ``expr_eval`` takes its
program by value (the float32 kernel), its ``expr_eval.cu`` on the
programs it takes; and it reports the same compiler output for the
parent's sources. ``--only`` runs some of the sweeps.

    python3 kernel_sweep.py [--parent DIR] [--only NAMES] [--json OUT]

Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import expr_eval as EE  # noqa: E402
from repro_torch.kernels import frontier_dedup as FD  # noqa: E402
from repro_torch.kernels import gather_emit as GE  # noqa: E402
from repro_torch.kernels import hash_join as HJ  # noqa: E402
from repro_torch.kernels import join_expand as JE  # noqa: E402

OUT_DIR = ROOT / "build" / "kernel_sweep"
# (threads, tile) candidates for join_expand
JE_SHAPES = ((64, 64), (64, 256), (128, 128), (128, 256), (128, 512), (128, 1024),
             (256, 256), (256, 1024), (256, 2048), (256, 4096), (512, 1024), (512, 2048),
             (512, 4096))
# (rows, pairs) unrolls of gather_emit
GE_UNROLLS = ((8, 2), (16, 4))
COUNTS = (4096, 16384, 65536, 131072, 262144, 524288, 1 << 20)
HP_KEYS = (4096, 65536, 1 << 20)  # hash_probe batch sizes
HP_GROUPS = (8, 16, 32)  # hash_probe's lanes a key
FD_CANDIDATES = (1 << 20, 524288, 262144, 65536, 4096)
FD_TILES = ((64, 4), (128, 4), (256, 4), (256, 8), (256, 16))  # (threads, candidates a thread)
FD_CHUNKS = (0, 1024, 4096, 16384)  # frontier_dedup's S in visited pairs (0: searched)
REPLAY_ITERS = 20  # launches timed for each recorded paths-phase launch
# radix_partition's compiled variants: (threads, keys a vector, vectors a
# thread, histogram mode, flush mode); histogram 0: pids only, 1: shared
# atomics (the wrapper's), 2: __match_any_sync merging, 3: the same merging
# into the zeroed histogram, no shared memory (the wrapper's batch
# instance); flush 0: atomics into the zeroed histogram (the wrapper's),
# 1: atomics into a scratch the last block copies out (a ticket), 2:
# per-block partials the last block sums. Modes 1 and 3 with flush 0 are
# radix_partition.cu's own template; the others are RP_VARIANT_KERNEL's.
RP_LARGE, RP_SMALL = (512, 4, 4, 1, 0), (256, 1, 1, 1, 0)  # the wrapper's instances
RP_VARIANTS = {"large": RP_LARGE, "small": RP_SMALL,
               "small, match_any": (256, 1, 1, 2, 0), "small, 4 keys a vector": (256, 4, 1, 1, 0),
               "small, pid only": (256, 1, 1, 0, 0), "large, pid only": (512, 4, 4, 0, 0),
               "VEC=1": (512, 1, 4, 1, 0), "VEC=2": (512, 2, 4, 1, 0),
               "VPT=1": (512, 4, 1, 1, 0), "VPT=2": (512, 4, 2, 1, 0),
               "VPT=8": (512, 4, 8, 1, 0), "256 threads": (256, 4, 4, 1, 0),
               "1024 threads": (1024, 4, 4, 1, 0), "match_any": (512, 4, 4, 2, 0),
               "ticket flush": (512, 4, 4, 1, 1), "partials flush": (512, 4, 4, 1, 2),
               "small, global atomics": (256, 1, 1, 3, 0), "small, 128 threads": (128, 1, 1, 1, 0),
               "small, 512 threads": (512, 1, 1, 1, 0), "large, global atomics": (512, 4, 4, 3, 0)}
RP_BLOCKS_PER_SM = (1, 2, 4, 8)
RP_COPIES = (1, 2, 4, 16)
RP_NS = (4096, 65536, 1 << 18, 1 << 20, 3_891_273, 1 << 24)
RP_PARTS = (1, 16, 1024, 8192)
RP_DISTS = ("uniform", "skewed")
# the engine's (build keys, partitions): P = n / 4,096 up to 1,024
# (core/operators/hash_join.py, _n_parts_for)
RP_ENGINE = ((4096, 1), (65536, 16), (1 << 18, 64), (1 << 20, 256), (3_891_273, 1024))
# the (n, P, keys) inputs every variant and launch shape runs on
RP_FOCUS = ((3_891_273, 1024, "uniform"), (3_891_273, 1024, "skewed"),
            (3_891_273, 1024, "sorted runs"), (3_891_273, 8192, "uniform"),
            (4096, 1, "uniform"), (4096, 1024, "uniform"), (4096, 8192, "skewed"),
            (65536, 8192, "skewed"), (65536, 16, "skewed"), (262144, 1, "uniform"),
            (1 << 24, 1024, "uniform"))
# bloom_build: key counts, key orders, this tree's threads and blocks, and
# the merges that lost (BB_VARIANT_KERNEL): "pre-zeroed" (the shipped merge
# into words zeroed by a fill before the launch: what the in-launch zeroing
# costs), "rotated" (each block merges from its own offset), "atomic poll"
# (the flag polled with atomics, not acquire loads), "shared line" (the
# ticket and the flag on the range's L2 line), "control warp" (a warp that
# reads no keys takes the ticket and zeroes or waits while the others read
# keys), "cluster" (a
# cluster's copies ORed through distributed shared memory into partials, a
# ticket a slice, the last cluster ORing the partials; no zeroed words),
# "spread" (one copy a cluster spread over its blocks, keys routed by
# remote atomics, the slices ORed into pre-zeroed words), "first writer"
# (the first block to reach each 128-word slice stores it, the others OR
# in after its flag)
BB_KEYS = (4096, 65536, 1 << 18, 1_369_041, 1 << 24)
BB_ORDERS = ("random", "grouped", "all equal", "half NULL")
BB_THREADS = (256, 512, 1024)
BB_BLOCKS = (1, 2, 8, 16, 32, 48, 64, 96, 128, 132, 264)
BB_VARIANTS = {"pre-zeroed": 0, "shared line": 8, "control warp": 9, "rotated": 1,
               "atomic poll": 7, "cluster 8x8": 2, "cluster 4x16": 3, "spread 15x8": 4,
               "spread 30x4": 5, "first writer": 6}
SIP_ROWS = 4096
SIP_ITEMS = (1, 2, 4)  # bloom_probe's rows a thread
SIP_QUERIES = (4096, 65536, 1 << 18, 1 << 20)  # bloom_probe(words, queries) sizes
# an earlier commit's kernels timed beside this tree's with --parent
PARENT_SOURCES = {"parent_ee": "expr_eval.cu", "parent_hp": "hash_probe.cu",
                  "parent_fd": "frontier_dedup.cu", "parent_rp": "radix_partition.cu",
                  "parent_bf": "bloom_filter.cu"}
SWEEPS = ("hash_probe", "frontier_dedup", "frontier_dedup_paths", "compiler", "expr_eval",
          "join_expand", "gather_emit", "radix_partition", "sip_step", "bloom_build")
REPORTED = ("expr_eval.cu", "hash_probe.cu", "frontier_dedup.cu", "radix_partition.cu",
            "bloom_filter.cu")  # compiler_report's sources
EE_THREADS = (32, 64, 128, 256)
EE_ROWS = (4096, 1 << 20)
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _instances_source() -> str:
    lines = [f'#include "{build.CSRC / "join_expand.cu"}"']
    for t, tl in JE_SHAPES:
        lines.append(
            f"extern \"C\" int je_{t}_{tl}(const int* ls, const int* rs, const int* rl, "
            f"const long long* cum, int G, long long base, long long count, int* li, int* ri, "
            f"void* st) {{ if (count <= 0) return 0; return launch<{t}, {tl}>(ls, rs, rl, cum, "
            f"G, base, count, li, ri, (cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


def _emit_source() -> str:
    lines = [f'#include "{build.CSRC / "gather_emit.cu"}"']
    for rows, pairs in GE_UNROLLS:
        lines.append(
            f"extern \"C\" int ge_{rows}_{pairs}(const EmitPlan* plan, const int* lc, "
            f"long long ls, const int* rc, long long rs, int re, const int* li, const int* ri, "
            f"long long C, int* out, long long os, bool* mask, void* st) {{ "
            f"launch<{rows}, {pairs}>(*plan, lc, ls, rc, rs, re, li, ri, C, out, os, mask, "
            f"(cudaStream_t)st); return (int)cudaGetLastError(); }}")
    return "\n".join(lines) + "\n"


def _probe_source() -> str:
    lines = [f'#include "{build.CSRC / "hash_probe.cu"}"']
    for g in HP_GROUPS:
        lines.append(
            f"extern \"C\" int hp_{g}(const int* ps, int np, const int* shi, const int* slo, "
            f"const int* qhi, const int* qlo, int c, int* lo, int* hi, void* st) {{ "
            f"if (c <= 0) return 0; return launch<{g}>(ps, np, shi, slo, qhi, qlo, c, lo, hi, "
            f"(cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


def _dedup_source() -> str:
    lines = [f'#include "{build.CSRC / "frontier_dedup.cu"}"']
    for t, it in FD_TILES:
        lines.append(
            f"extern \"C\" int fd_{t}_{it}(const int* hi, const int* lo, long long c, "
            f"const int* vhi, const int* vlo, int v, int smem, unsigned char* mask, void* st) {{ "
            f"if (c <= 0) return 0; return launch<{t}, {it}>(hi, lo, c, vhi, vlo, v, smem, mask, "
            f"(cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


# the radix_partition variants the library does not ship, built from
# radix_partition.cu's device functions: pids only, __match_any_sync
# merging into shared sub-histograms, and two flushes that need no zeroed
# histogram, each counted by a ticket that the last block resets
RP_VARIANT_KERNEL = r"""
constexpr int V_NONE = 0, V_ATOMIC = 1, V_MATCH = 2;
constexpr int F_DIRECT = 0, F_TICKET = 1, F_PARTIALS = 2;

template <int T, int V, int PER, int HIST, int FLUSH>
__global__ void __launch_bounds__(T)
radix_partition_variant_kernel(const int* __restrict__ keys, long long n, long long head, int n_parts,
               int copies, int* __restrict__ pid, int* __restrict__ hist,
               int* __restrict__ scratch, unsigned* ticket) {
  extern __shared__ int4 sh4[];
  int* sh = reinterpret_cast<int*>(sh4);
  __shared__ bool last;
  if (HIST != V_NONE) zero_shared<T>(sh4, copies * n_parts);
  int* my = sh + ((threadIdx.x >> 5) % copies) * n_parts;
  walk<T, V, PER>(keys, n, head, (unsigned)(n_parts - 1), pid,
                  [&](int p) { if (HIST != V_NONE) atomicAdd(&my[p], 1); },
                  [&](const int (&p)[PER][V], bool full, long long base, long long nv) {
                    if constexpr (HIST == V_ATOMIC) add_step<T, V, PER>(my, p, full, base, nv);
                    if constexpr (HIST == V_MATCH) match_step<T, V, PER>(my, p, full, base, nv);
                  });
  if (HIST == V_NONE) return;
  __syncthreads();
  for (int i = threadIdx.x; i < n_parts; i += T) {
    const int c = sum_copies(sh, i, n_parts, copies);
    if (gridDim.x == 1) hist[i] = c;
    else if (FLUSH == F_DIRECT) { if (c) atomicAdd(&hist[i], c); }
    else if (FLUSH == F_TICKET) { if (c) atomicAdd(&scratch[i], c); }
    else scratch[(long long)blockIdx.x * n_parts + i] = c;
  }
  if (FLUSH == F_DIRECT || gridDim.x == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n_parts; i += T) {
    int c = 0;
    if (FLUSH == F_TICKET) {
      c = __ldcg(&scratch[i]);
      if (c) scratch[i] = 0;
    } else {
      for (unsigned b = 0; b < gridDim.x; ++b) c += __ldcg(&scratch[(long long)b * n_parts + i]);
    }
    hist[i] = c;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// F_DIRECT needs hist zeroed; F_TICKET a scratch of n_parts zeros and
// F_PARTIALS one of n_parts ints a block, and both a zero ticket
template <int T, int V, int PER, int HIST, int FLUSH, int BLOCKS_PER_SM>
int variant_launch(const int* keys, long long n, int n_parts, int copies, int* pid, int* hist,
                   int* scratch, unsigned* ticket, cudaStream_t stream) {
  const size_t smem = HIST != V_NONE ? (size_t)copies * n_parts * sizeof(int) : 0;
  auto kernel = radix_partition_variant_kernel<T, V, PER, HIST, FLUSH>;
  long long head = 0;
  unsigned blocks = 0;
  const int e = prepare<T, V, PER>(kernel, keys, n, n_parts, copies, smem, BLOCKS_PER_SM,
                                   pid, &head, &blocks);
  if (e) return e;
  kernel<<<blocks, T, smem, stream>>>(keys, n, head, n_parts, copies, pid, hist, scratch,
                                      ticket);
  return (int)cudaGetLastError();
}
"""


# bloom_build's losing merges, built from bloom_filter.cu's device
# functions (zero_copy_and_fill, add_keys, block_range, bloom_hash)
BB_VARIANT_KERNEL = r"""
namespace cg = cooperative_groups;

// the shipped merge; pre-zeroed (ZERO = false: the caller zeroed the
// reachable words), rotated (ROTATE: block b merges from word b R / G),
// atomic-poll (POLL_ATOMIC) and shared-line (SHARED: the ticket and the
// flag in state[2], state[3], on the range's line) forms of it
template <int T, bool ZERO, bool ROTATE, bool POLL_ATOMIC, bool SHARED>
__global__ void __launch_bounds__(T, 1)
bloom_build_atomic_kernel(const int* __restrict__ keys, long long n, int n_words,
                          unsigned* __restrict__ words, unsigned* __restrict__ state) {
  extern __shared__ unsigned s_words[];
  __shared__ unsigned s_red[T / 16];
  __shared__ unsigned s_ticket;
  unsigned* ticket = state + (SHARED ? 2 : TICKET);
  unsigned* flag = state + (SHARED ? 3 : FLAG);
  const int r_words = n_words < REACH ? n_words : REACH;
  if (ZERO && threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u);
  zero_copy_and_fill<T>(n_words, words, s_words);
  __syncthreads();
  const bool zeroes = ZERO && s_ticket == 0;
  if (zeroes) {
    for (int i = threadIdx.x; i < r_words; i += T) words[i] = 0u;
    __syncthreads();
    if (threadIdx.x == 0) { __threadfence(); atomicExch(flag, 1u); }
  }
  unsigned lo_m = 0u, hi_m = 0u;
  add_keys<T>(keys, n, n_words, s_words, lo_m, hi_m);
  block_range<T>(lo_m, hi_m, s_red, state);
  if (ZERO && !zeroes && threadIdx.x == 0) {
    if (POLL_ATOMIC) {
      while (atomicAdd(flag, 0u) == 0u) __nanosleep(64);
      __threadfence();
    } else {
      while (load_acquire(flag) == 0u) __nanosleep(32);
    }
  }
  __syncthreads();
  const int start = ROTATE ? (int)(((long long)blockIdx.x * r_words / gridDim.x) & ~31LL) : 0;
  for (int j = threadIdx.x; j < r_words; j += T) {
    const int i = (j + start) & (r_words - 1);
    const unsigned v = s_words[i];
    if (v) atomicOr(words + i, v);
  }
}

// The control warp's part of a merge: take the start ticket; the block
// that takes ticket 0 zeroes the reachable words and raises the flag, the
// others wait for the flag (a block that holds ticket 0 is running and
// waits on nothing, so the wait ends). The other warps read keys meanwhile.
__device__ __forceinline__ void zero_or_wait(unsigned* __restrict__ words, int r_words,
                                             unsigned* state) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned ticket = 0;
  if (lane == 0) ticket = atomicAdd(state + TICKET, 1u);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  if (ticket == 0) {
    uint4* z = reinterpret_cast<uint4*>(words);  // R is 1, 2 or a multiple of 4
    for (int i = lane; i < r_words >> 2; i += 32) z[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = (r_words & ~3) + lane; i < r_words; i += 32) words[i] = 0u;
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(state + FLAG, 1u);
  } else if (lane == 0) {
    while (load_acquire(state + FLAG) == 0u) __nanosleep(32);
    __threadfence();
  }
  __syncwarp();
}

// control warp: the last warp reads no keys; it takes the ticket and
// zeroes or waits (zero_or_wait) while the others read keys
template <int T>
__global__ void __launch_bounds__(T, 1)
bloom_build_control_kernel(const int* __restrict__ keys, long long n, int n_words,
                           unsigned* __restrict__ words, unsigned* __restrict__ state) {
  extern __shared__ unsigned s_words[];
  __shared__ unsigned s_red[T / 16];
  const int r_words = n_words < REACH ? n_words : REACH;
  zero_copy_and_fill<T>(n_words, words, s_words);
  __syncthreads();
  unsigned lo_m = 0u, hi_m = 0u;
  if (threadIdx.x < T - 32) add_keys<T - 32>(keys, n, n_words, s_words, lo_m, hi_m);
  else zero_or_wait(words, r_words, state);
  block_range<T>(lo_m, hi_m, s_red, state);
  for (int i = threadIdx.x; i < r_words; i += T) {
    const unsigned v = s_words[i];
    if (v) atomicOr(words + i, v);
  }
}

// cluster: each cluster ORs its blocks' copies through distributed shared
// memory, block `rank` one slice, into its row of partial (or the words,
// with one cluster); the last cluster to write a slice (a ticket a slice
// in state[2 + rank]) ORs the slice's partials into the words
template <int T>
__global__ void __launch_bounds__(T)
bloom_build_cluster_kernel(const int* __restrict__ keys, long long n, int n_words,
                           unsigned* __restrict__ words, unsigned* __restrict__ partial,
                           unsigned* __restrict__ state) {
  extern __shared__ unsigned s_words[];
  __shared__ unsigned s_red[T / 16];
  __shared__ bool s_last;
  const cg::cluster_group cluster = cg::this_cluster();
  zero_copy_and_fill<T>(n_words, words, s_words);
  __syncthreads();
  unsigned lo_m = 0u, hi_m = 0u;
  add_keys<T>(keys, n, n_words, s_words, lo_m, hi_m);
  block_range<T>(lo_m, hi_m, s_red, state);
  cluster.sync();
  const int c_size = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n_clusters = (int)(gridDim.x / c_size);
  const int r_words = n_words < REACH ? n_words : REACH;
  const int w0 = (int)((long long)rank * r_words / c_size);
  const int w1 = (int)((long long)(rank + 1) * r_words / c_size);
  unsigned* dst = n_clusters == 1 ? words : partial + (long long)(blockIdx.x / c_size) * r_words;
  for (int i = w0 + threadIdx.x; i < w1; i += T) {
    unsigned v[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = c < c_size ? cluster.map_shared_rank(s_words, c)[i] : 0u;
    unsigned acc = 0u;
#pragma unroll
    for (int c = 0; c < 16; ++c) acc |= v[c];
    dst[i] = acc;
  }
  cluster.sync();
  if (n_clusters == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(state + 2 + rank, 1u) == (unsigned)(n_clusters - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = w0 + threadIdx.x; i < w1; i += T) {
    unsigned acc = 0u;
    for (int g = 0; g < n_clusters; ++g) acc |= __ldcg(partial + (long long)g * r_words + i);
    words[i] = acc;
  }
}

// spread: one copy a cluster, R / CS words a block; keys routed to their
// word's block by remote atomics; slices ORed into pre-zeroed words
template <int T, int CS>
__global__ void __launch_bounds__(T)
bloom_build_spread_kernel(const int* __restrict__ keys, long long n, int n_words,
                          unsigned* __restrict__ words, unsigned* __restrict__ state) {
  extern __shared__ unsigned s_slice[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int r_words = n_words < REACH ? n_words : REACH;
  const int slice = r_words / CS;
  const unsigned wmask = (unsigned)n_words - 1u;
  const long long tid = (long long)blockIdx.x * T + threadIdx.x;
  const long long n_threads = (long long)gridDim.x * T;
  if (n_words > r_words) {
    uint4* z = reinterpret_cast<uint4*>(words + r_words);
    const long long nz = (long long)(n_words - r_words) >> 2;
    for (long long i = tid; i < nz; i += n_threads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < slice; i += T) s_slice[i] = 0u;
  cluster.sync();
  const int shift = __ffs(slice) - 1;
  for (long long i = tid; i < n; i += n_threads) {  // aligned keys, one a thread
    unsigned w, b;
    bloom_hash(keys[i], wmask, &w, &b);
    atomicOr(cluster.map_shared_rank(s_slice, (int)(w >> shift)) + (w & (slice - 1)), b);
  }
  cluster.sync();
  const int base = (int)cluster.block_rank() * slice;
  for (int i = threadIdx.x; i < slice; i += T) {
    const unsigned v = s_slice[i];
    if (v) atomicOr(words + base + i, v);
  }
}

// first writer: the first block to reach each 128-word slice (a ticket a
// slice in state[2 + s]) stores it and raises its flag (state[2 + S + s]);
// the others OR in their nonzero words once the flag is up
template <int T>
__global__ void __launch_bounds__(T)
bloom_build_first_kernel(const int* __restrict__ keys, long long n, int n_words,
                         unsigned* __restrict__ words, unsigned* __restrict__ state) {
  extern __shared__ unsigned s_words[];
  __shared__ unsigned s_red[T / 16];
  zero_copy_and_fill<T>(n_words, words, s_words);
  __syncthreads();
  unsigned lo_m = 0u, hi_m = 0u;
  add_keys<T>(keys, n, n_words, s_words, lo_m, hi_m);
  block_range<T>(lo_m, hi_m, s_red, state);
  __syncthreads();
  const int r_words = n_words < REACH ? n_words : REACH;
  const int n_slices = r_words >= 128 ? r_words / 128 : 1;
  const int slice = r_words / n_slices;
  const unsigned lane = threadIdx.x & 31u;
  for (int j = threadIdx.x >> 5; j < n_slices; j += T / 32) {
    const int s = (j + blockIdx.x) % n_slices;
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(state + 2 + s, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    unsigned* dst = words + s * slice;
    const unsigned* src = s_words + s * slice;
    if (t == 0) {
      for (int i = lane; i < slice; i += 32) dst[i] = src[i];
      __threadfence();
      __syncwarp();
      if (lane == 0) atomicExch(state + 2 + n_slices + s, 1u);
    } else {
      if (lane == 0) while (atomicAdd(state + 2 + n_slices + s, 0u) == 0u) __nanosleep(64);
      __syncwarp();
      __threadfence();
      for (int i = lane; i < slice; i += 32) { const unsigned v = src[i]; if (v) atomicOr(dst + i, v); }
    }
  }
}

template <typename K>
int bb_smem(K kernel, int smem, bool non_portable) {
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && non_portable)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)e;
}

template <typename K, typename... A>
int bb_cluster_launch(K kernel, int clusters, int cs, int smem, cudaStream_t st, A... args) {
  int e = bb_smem(kernel, REACH * 4, cs > 8);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cs);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t r = cudaLaunchKernelEx(&cfg, kernel, args...);
  return r != cudaSuccess ? (int)r : (int)cudaGetLastError();
}

// variant v (BB_VARIANTS) at 1,024 threads; scratch: the cluster merge's
// partials; state: zeroed (2 + 2 * 128 words)
int bb_variant(int v, const int* k, long long n, int nw, unsigned* w, unsigned* scratch,
               unsigned* state, int blocks, cudaStream_t st) {
  const int r = nw < REACH ? nw : REACH;
  int e = 0;
  switch (v) {
    case 0:
      e = bb_smem(bloom_build_atomic_kernel<1024, false, false, false, false>, REACH * 4, false);
      if (!e) bloom_build_atomic_kernel<1024, false, false, false, false><<<blocks, 1024, r * 4, st>>>(k, n, nw, w, state);
      break;
    case 1:
      e = bb_smem(bloom_build_atomic_kernel<1024, true, true, false, false>, REACH * 4, false);
      if (!e) bloom_build_atomic_kernel<1024, true, true, false, false><<<blocks, 1024, r * 4, st>>>(k, n, nw, w, state);
      break;
    case 7:
      e = bb_smem(bloom_build_atomic_kernel<1024, true, false, true, false>, REACH * 4, false);
      if (!e) bloom_build_atomic_kernel<1024, true, false, true, false><<<blocks, 1024, r * 4, st>>>(k, n, nw, w, state);
      break;
    case 8:
      e = bb_smem(bloom_build_atomic_kernel<1024, true, false, false, true>, REACH * 4, false);
      if (!e) bloom_build_atomic_kernel<1024, true, false, false, true><<<blocks, 1024, r * 4, st>>>(k, n, nw, w, state);
      break;
    case 9:
      e = bb_smem(bloom_build_control_kernel<1024>, REACH * 4, false);
      if (!e) bloom_build_control_kernel<1024><<<blocks, 1024, r * 4, st>>>(k, n, nw, w, state);
      break;
    case 2: return bb_cluster_launch(bloom_build_cluster_kernel<1024>, 8, 8, r * 4, st, k, n, nw, w, scratch, state);
    case 3: return bb_cluster_launch(bloom_build_cluster_kernel<1024>, 4, 16, r * 4, st, k, n, nw, w, scratch, state);
    case 4: return bb_cluster_launch(bloom_build_spread_kernel<1024, 8>, 15, 8, r / 8 * 4, st, k, n, nw, w, state);
    case 5: return bb_cluster_launch(bloom_build_spread_kernel<1024, 4>, 30, 4, r / 4 * 4, st, k, n, nw, w, state);
    default:
      e = bb_smem(bloom_build_first_kernel<1024>, REACH * 4, false);
      if (!e) bloom_build_first_kernel<1024><<<blocks, 1024, r * 4, st>>>(k, n, nw, w, state);
  }
  return e ? e : (int)cudaGetLastError();
}
"""


def _bloom_source() -> str:
    lines = ["#include <cooperative_groups.h>", f'#include "{build.CSRC / "bloom_filter.cu"}"',
             "namespace {", BB_VARIANT_KERNEL, "}  // namespace"]
    for t in BB_THREADS:
        lines.append(
            f"extern \"C\" int bb_{t}(const int* k, long long n, int nw, unsigned* w, "
            f"unsigned* st, int blocks, void* s) {{ return build_launch<{t}>(k, n, nw, w, st, "
            f"blocks, (cudaStream_t)s); }}")
    lines.append(
        "extern \"C\" int bb_variant_launch(int v, const int* k, long long n, int nw, "
        "unsigned* w, unsigned* scratch, unsigned* st, int blocks, void* s) { return "
        "bb_variant(v, k, n, nw, w, scratch, st, blocks, (cudaStream_t)s); }")
    return "\n".join(lines) + "\n"


def _rp_small(v) -> bool:
    """Whether variant ``v`` launches as the small instance does (one-key
    and no-shared-memory shapes): its blocks per SM and one copy."""
    return v[1:3] == (1, 1) or v[:3] == (256, 4, 1) or v[3] == 3


def _rp_default_bps(v) -> int:
    """The blocks per SM a variant runs at unless swept."""
    from repro_torch.kernels import radix_partition as RP

    return RP.SMALL_BLOCKS_PER_SM if _rp_small(v) else RP.LARGE_BLOCKS_PER_SM


def _rp_instances():
    """Every (variant, blocks per SM) the sweep launches: each variant at
    its default, the wrapper's two shared-histogram shapes at each of
    RP_BLOCKS_PER_SM."""
    pairs = [(v, _rp_default_bps(v)) for v in RP_VARIANTS.values()]
    pairs += [(v, b) for v in (RP_LARGE, RP_SMALL) for b in RP_BLOCKS_PER_SM]
    return list(dict.fromkeys(pairs))


def _rp_name(v, bps) -> str:
    return "rp_" + "_".join(map(str, v)) + f"_b{bps}"


def _radix_source() -> str:
    lines = [f'#include "{build.CSRC / "radix_partition.cu"}"', "namespace {",
             RP_VARIANT_KERNEL, "}  // namespace"]
    for v, bps in _rp_instances():
        t, vec, per, hist, flush = v
        if flush == 0 and hist in (1, 3):  # radix_partition.cu's own modes
            mode = "HIST_ATOMIC" if hist == 1 else "HIST_GLOBAL"
            call = f"launch<{t}, {vec}, {per}, {mode}, {bps}>(k, n, np, copies, pid, hist, "
        else:
            call = (f"variant_launch<{t}, {vec}, {per}, {hist}, {flush}, {bps}>(k, n, np, "
                    f"copies, pid, hist, scratch, ticket, ")
        lines.append(
            f"extern \"C\" int {_rp_name(v, bps)}(const int* k, long long n, int np, "
            f"int copies, int* pid, int* hist, int* scratch, unsigned* ticket, void* st) {{ "
            f"return {call}(cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


def _sip_source() -> str:
    lines = [f'#include "{build.CSRC / "bloom_filter.cu"}"']
    for it in SIP_ITEMS:
        lines.append(
            f"extern \"C\" int sp_{it}(const void* d, const unsigned char* m, unsigned char* o, "
            f"int n, int cap, void* st) {{ return launch<{it}>(*static_cast<const SipDesc*>(d), "
            f"m, o, n, cap, (cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


def build_libraries(parent):
    """Compile the instance libraries (and the parent's kernel), one nvcc
    each, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {"je": _instances_source(), "ge": _emit_source(), "hp": _probe_source(),
            "fd": _dedup_source(), "rp": _radix_source(), "sp": _sip_source(),
            "bb": _bloom_source()}
    srcs = {}
    for name, text in jobs.items():
        srcs[name] = OUT_DIR / f"{name}_sweep.cu"
        srcs[name].write_text(text)
    if parent is not None:
        for name, src in PARENT_SOURCES.items():
            if name != "parent_ee" or _parent_by_value(parent):
                srcs[name] = Path(parent) / "src" / "repro_torch" / "csrc" / src
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-shared", str(src), "-o", str(OUT_DIR / f"{name}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in srcs.items()}
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    for t, tl in JE_SHAPES:
        getattr(libs["je"], f"je_{t}_{tl}").argtypes = [P, P, P, P, I, L, L, P, P, P]
    for rows, pairs in GE_UNROLLS:
        getattr(libs["ge"], f"ge_{rows}_{pairs}").argtypes = [P, P, L, P, L, I, P, P, L, P, L,
                                                              P, P]
    for g in HP_GROUPS:
        getattr(libs["hp"], f"hp_{g}").argtypes = [P, I, P, P, P, P, I, P, P, P]
    for t, it in FD_TILES:
        getattr(libs["fd"], f"fd_{t}_{it}").argtypes = [P, P, L, P, P, I, I, P, P]
    for v, bps in _rp_instances():
        getattr(libs["rp"], _rp_name(v, bps)).argtypes = [P, L, I, I, P, P, P, P, P]
    for it in SIP_ITEMS:
        getattr(libs["sp"], f"sp_{it}").argtypes = [P, P, P, I, I, P]
    for t in BB_THREADS:
        getattr(libs["bb"], f"bb_{t}").argtypes = [P, L, I, P, P, I, P]
    libs["bb"].bb_variant_launch.argtypes = [I, P, L, I, P, P, P, I, P]
    if "parent_ee" in libs:
        libs["parent_ee"].expr_eval_launch.argtypes = [P, P, P, L, P, P, P]
    if parent is not None:
        # one thread per key / candidate, no shape arguments
        libs["parent_hp"].hash_probe_launch.argtypes = [P, I, P, P, P, P, I, P, P, P]
        libs["parent_fd"].frontier_dedup_launch.argtypes = [P, P, L, P, P, I, P, P]
        # one key a thread, a histogram the caller zeroes; one query a thread
        libs["parent_rp"].radix_partition_launch.argtypes = [P, L, I, P, P, P]
        libs["parent_bf"].bloom_probe_launch.argtypes = [P, I, P, I, P, P]
        # one key a thread, atomics into words the caller zeroed
        libs["parent_bf"].bloom_build_launch.argtypes = [P, L, I, P, P]
    return libs


def _parent_by_value(parent) -> bool:
    """Whether the parent's expr_eval takes its program by value (the
    float32 kernel this tree's replaced); a later one is this tree's own."""
    path = Path(parent) / "src" / "repro_torch" / "kernels" / "expr_eval.py"
    return "def _prog_struct(" in path.read_text()


def compiler_report(parent):
    """``-Xptxas -v`` lines and SASS counts of local (LDL / STL) and shared
    (LDS / STS) loads and stores of REPORTED's sources, this tree's and the
    parent's."""
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    roots = {"this tree": build.CSRC}
    if parent is not None:
        roots["parent"] = Path(parent) / "src" / "repro_torch" / "csrc"
    out = {}
    for src_name in REPORTED:
        for name, root in roots.items():
            obj = OUT_DIR / f"{Path(src_name).stem}_{name.replace(' ', '_')}.o"
            cc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                 str(root / src_name), "-o", str(obj)],
                                capture_output=True, text=True, check=True)
            sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                                  text=True, check=True).stdout
            ops = [next((w for w in ln.split()[1:] if not w.startswith("@")), "").split(".")[0]
                   for ln in sass.splitlines() if ln.strip().startswith("/*")]
            key = f"{src_name} ({name})"
            out[key] = {"ptxas": [ln for ln in cc.stderr.splitlines() if "ptxas" in ln],
                        "sass": {op: sum(1 for o in ops if o == op)
                                 for op in ("LDL", "STL", "LDS", "STS", "LDG")}}
            CS.log(f"{key}: {json.dumps(out[key])}")
    return out


def _expand_fn(libs, which, args, base, count):
    ls, ll, rs, rl, cum = args
    li = torch.empty(count, dtype=torch.int32, device=ls.device)
    ri = torch.empty_like(li)
    st = build.stream_handle(li)
    g = int(ls.shape[0])
    f = getattr(libs["je"], f"je_{which[0]}_{which[1]}")

    def run():
        build.check(f(ls.data_ptr(), rs.data_ptr(), rl.data_ptr(), cum.data_ptr(), g,
                      base, count, li.data_ptr(), ri.data_ptr(), st), "join_expand")
        return li, ri
    return run


def sweep_join_expand(libs, rng, dev):
    q6 = CS._groups(rng, 40000, 4, 8, dev)
    wide = CS._groups(rng, 400_000, 4, 8, dev)  # about 4.5M slots: every window valid
    one = CS._group_tensors(np.asarray([8]), np.asarray([1 << 17]), dev)
    windows = [("4096 slots over 40,000 groups", q6, int(q6[4][-1]) // 2, 4096)]
    windows += [(f"{c} slots over 400,000 groups", wide, 0, c) for c in COUNTS[1:]]
    windows.append(("one group of 2^20 slots", one, 0, 1 << 20))
    variants = [(f"{t}x{tl}", (t, tl)) for t, tl in JE_SHAPES]
    res = {}
    for label, args, base, count in windows:
        want = JE.join_expand_plain(*args, base, count)
        row = {}
        for name, which in variants:
            fn = _expand_fn(libs, which, args, base, count)
            li, ri = fn()
            CS.require(torch.equal(li, want[0]) and torch.equal(ri, want[1]),
                       f"join_expand {name} disagrees with the plain version ({label})")
            tl = which[1]
            got = JE.join_expand_plain(*args, base, count, tile=tl)
            CS.require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                       f"join_expand_plain at tile {tl} disagrees ({label})")
            row[name] = CS.device_ms(fn, 200, kernel="join_expand")
        row["wrapper"] = CS.device_ms(lambda: JE.join_expand(*args, base, count), 200,
                                      kernel="join_expand")
        res[label] = row
        CS.log(f"join_expand {label}: {json.dumps(row)}")
    return res


def sweep_gather_emit(libs, rng, dev):
    nsrc, c = 1_000_000, 4096
    lcols = torch.from_numpy(rng.randint(0, 4, (3, nsrc)).astype(np.int32)).to(dev)
    rcols = torch.from_numpy(rng.randint(0, 4, (3, nsrc)).astype(np.int32)).to(dev)
    groups = CS._groups(rng, 40000, 4, 8, dev)
    jli, jri = JE.join_expand(*groups, int(groups[4][-1]) // 2, c)
    rli = torch.from_numpy(rng.randint(0, nsrc, c).astype(np.int32)).to(dev)
    rri = torch.from_numpy(np.where(rng.rand(c) < 0.1, -1, rng.randint(0, nsrc, c))
                           .astype(np.int32)).to(dev)
    bli = torch.from_numpy(rng.randint(0, nsrc, 1 << 20).astype(np.int32)).to(dev)
    bri = torch.from_numpy(rng.randint(-1, nsrc, 1 << 20).astype(np.int32)).to(dev)
    plan = GE.EmitPlan((0, 1, 2), (1, 2), ((0, 0),))
    res = {}
    for label, li, ri in (("join-shaped, 4096 slots", jli, jri),
                          ("random, 4096 slots", rli, rri), ("random, 2^20 slots", bli, bri)):
        want = GE.gather_emit_plain(lcols, rcols, li, ri, plan)
        n = int(li.shape[0])
        row = {}
        for rows, pairs in GE_UNROLLS:
            f = getattr(libs["ge"], f"ge_{rows}_{pairs}")
            out = torch.empty((plan.n_rows, n), dtype=torch.int32, device=dev)
            mask = torch.empty(n, dtype=torch.bool, device=dev)
            st = build.stream_handle(li)

            def run(f=f, out=out, mask=mask, st=st):
                build.check(f(plan.chunks[0][2], lcols.data_ptr(), lcols.stride(0),
                              rcols.data_ptr(), rcols.stride(0), 0, li.data_ptr(),
                              ri.data_ptr(), n, out.data_ptr(), out.stride(0),
                              mask.data_ptr(), st), "gather_emit")

            run()
            CS.require(torch.equal(out, want[0]) and torch.equal(mask, want[1]),
                       f"gather_emit {rows}x{pairs} disagrees with the plain version ({label})")
            row[f"unroll {rows} rows, {pairs} pairs"] = CS.device_ms(run, 200,
                                                                   kernel="gather_emit")
        res[label] = row
        CS.log(f"gather_emit {label}: {json.dumps(row)}")
    return res


def _load_parent_expr_eval(parent):
    """The parent's expr_eval wrapper module, for its by-value program."""
    import importlib.util

    path = Path(parent) / "src" / "repro_torch" / "kernels" / "expr_eval.py"
    spec = importlib.util.spec_from_file_location("parent_expr_eval", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_expr_eval(libs, rng, dev, parent):
    """Each program at each block size and row count through the wrapper,
    against the plain version bit for bit; the parent's float32 kernel on
    the programs within its caps, on the same inputs rounded to float32."""
    prog23, d = CS.all_opcode_program()
    progs = {"23-opcode program": prog23, "q6 FILTER": CS.q6_filter_program(d),
             "BIND(?x * 3)": CS.times3_program(d), "70-term BIND": CS.bind70_program(d),
             "100 registers": CS.many_register_program(100),
             "300 registers": CS.many_register_program(300)}
    pmod = _load_parent_expr_eval(parent) if "parent_ee" in libs else None
    res = {}
    for n in EE_ROWS:
        for label, prog in progs.items():
            ic = torch.from_numpy(rng.randint(-1, 21, (max(prog.n_icols, 1), n))
                                  .astype(np.int32)).to(dev)
            fc = torch.from_numpy(rng.choice(CS.NOT_F32, (max(prog.n_fcols, 1), n))).to(dev)
            want_v, want_e = EE.expr_eval_plain(prog, ic, fc)
            row = {}
            for inst in EE.INSTANCES:
                for t in EE_THREADS:
                    if not EE.fits(prog, t, inst) or (inst == "global" and t != EE.THREADS):
                        continue
                    fn = lambda t=t, inst=inst: EE._launch(  # noqa: E731
                        prog, ic, fc, t, inst)
                    v, e = fn()
                    CS.require(torch.equal(v.view(torch.int64), want_v.view(torch.int64))
                               and torch.equal(e, want_e),
                               f"expr_eval {inst} at {t} threads disagrees ({label}, n={n})")
                    row[f"{inst}, {t} threads"] = CS.device_ms(fn, 200, kernel="expr_eval")
            if pmod is not None and len(prog.instrs) <= pmod.MAX_INSTR \
                    and prog.n_regs <= pmod.MAX_REGS and len(prog.consts) <= pmod.MAX_CONSTS:
                s = pmod._prog_struct(prog)
                f32 = fc.to(torch.float32)
                val = torch.empty(n, dtype=torch.float32, device=dev)
                err = torch.empty(n, dtype=torch.bool, device=dev)
                f = libs["parent_ee"].expr_eval_launch

                def run(s=s, f32=f32, val=val, err=err, f=f, ic=ic):
                    build.check(f(ctypes.addressof(s), ic.data_ptr(), f32.data_ptr(), n,
                                  val.data_ptr(), err.data_ptr(), build.stream_handle(val)),
                                "parent expr_eval")

                run()
                CS.require(torch.equal(err, want_e) or prog.n_fcols > 0,
                           f"parent expr_eval's error plane differs ({label})")
                row["parent (float32, 256 threads)"] = CS.device_ms(run, 200,
                                                                   kernel="expr_eval")
            res[f"{label}, n={n}"] = row
            CS.log(f"expr_eval {label}, n={n}: {json.dumps(row)}")
    # q6's FILTER on inputs the L2 cache does not hold, as a query's batches
    # arrive: a 64 MB write between launches evicts them (not timed)
    prog, n = progs["q6 FILTER"], EE_ROWS[0]
    flush = torch.empty(1 << 23, dtype=torch.float64, device=dev)
    ic = torch.from_numpy(rng.randint(-1, 3000, (prog.n_icols, n)).astype(np.int32)).to(dev)
    fc = torch.full((1, n), float("nan"), dtype=torch.float64, device=dev)
    row = {"registers, wrapper": CS.device_ms(
        lambda: (flush.zero_(), EE.expr_eval(prog, ic, fc)), 200, kernel="expr_eval")}
    if pmod is not None:
        s, f32 = pmod._prog_struct(prog), fc.to(torch.float32)
        val = torch.empty(n, dtype=torch.float32, device=dev)
        err = torch.empty(n, dtype=torch.bool, device=dev)
        f = libs["parent_ee"].expr_eval_launch
        row["parent (float32, 256 threads)"] = CS.device_ms(
            lambda: (flush.zero_(), build.check(f(
                ctypes.addressof(s), ic.data_ptr(), f32.data_ptr(), n, val.data_ptr(),
                err.data_ptr(), build.stream_handle(val)), "parent expr_eval")), 200,
            kernel="expr_eval")
    res[f"q6 FILTER, n={n}, inputs out of L2"] = row
    CS.log(f"expr_eval q6 FILTER, n={n}, inputs out of L2: {json.dumps(row)}")
    return res


def _probe_build(rng, dev, label):
    """The 3,891,273-row build of chip_smoke's hash_probe check, laid out in
    1,024 partitions or in one, or a build whose keys repeat 1,000 times;
    and its key domain."""
    n = 3_891_273
    if label.startswith("keys repeated"):
        keys = np.repeat(np.arange(n // 1000 + 1, dtype=np.int32) * 3, 1000)[:n]
        return CS._layout(None, torch.from_numpy(keys).to(dev), 1024), keys, int(keys[-1]) + 1
    keys = rng.randint(0, 500_000, n).astype(np.int32)
    p = 1 if label.endswith("P=1") else 1024
    return CS._layout(None, torch.from_numpy(keys).to(dev), p), keys, 500_000


def sweep_hash_probe(libs, rng, dev):
    """Each group size G at each batch size on three builds, and the
    parent's kernel, each checked against the plain version first."""
    res = {}
    for blabel in ("3,891,273 rows, P=1024", "3,891,273 rows, P=1",
                   "keys repeated 1,000 times, P=1024"):
        (starts, _, skl), keys, dom = _probe_build(rng, dev, blabel)
        n_parts = int(starts.shape[0]) - 1
        for c in HP_KEYS:
            q = torch.from_numpy(np.concatenate([
                keys[rng.randint(0, len(keys), c // 2)],
                rng.randint(dom, 2 * dom, c - c // 2)]).astype(np.int32)).to(dev)
            want = HJ.hash_probe_plain(starts, None, skl, None, q)
            lo = torch.empty_like(q)
            hi = torch.empty_like(q)
            st = build.stream_handle(q)
            fns = {f"G={g}": (lambda f=getattr(libs["hp"], f"hp_{g}"): build.check(f(
                starts.data_ptr(), n_parts, None, skl.data_ptr(), None, q.data_ptr(), c,
                lo.data_ptr(), hi.data_ptr(), st), "hash_probe")) for g in HP_GROUPS}
            if "parent_hp" in libs:
                f = libs["parent_hp"].hash_probe_launch
                fns["parent"] = lambda f=f: build.check(f(
                    starts.data_ptr(), n_parts, None, skl.data_ptr(), None, q.data_ptr(), c,
                    lo.data_ptr(), hi.data_ptr(), st), "parent hash_probe")
            row = {}
            for name, fn in fns.items():
                lo.fill_(-7)
                hi.fill_(-7)
                fn()
                CS.require(torch.equal(lo, want[0]) and torch.equal(hi, want[1]),
                           f"hash_probe {name} disagrees with the plain version ({blabel}, {c})")
                row[name] = CS.device_ms(fn, 200, kernel="hash_probe")
            row["wrapper"] = CS.device_ms(lambda: HJ.hash_probe(starts, None, skl, None, q),
                                          200, kernel="hash_probe")
            res[f"{blabel}, {c} keys"] = row
            CS.log(f"hash_probe {blabel}, {c} keys: {json.dumps(row)}")
    return res


def sweep_frontier_dedup(libs, rng, dev):
    """Each compiled tile (threads x candidates a thread) and chunk S (or
    none, so that every window is searched) at 4,096 to 2^20 candidates
    against an empty visited set, one about half inside the candidates'
    range and one of 4,000,000 pairs dense in it (so windows pass S), and
    the parent's kernel, each checked against the plain version first."""
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    res = {}
    for c in FD_CANDIDATES:
        ch, cl = CS._sorted_pairs(rng.randint(0, 64, c), rng.randint(0, 70_000, c))
        cand = (torch.from_numpy(ch).to(dev), torch.from_numpy(cl).to(dev))
        ckey = np.unique(ch.astype(np.int64) << 32 | cl)
        others = np.unique(rng.randint(64, 128, 960_000).astype(np.int64) << 32
                           | rng.randint(0, 70_000, 960_000))
        v480 = np.sort(np.concatenate([rng.choice(ckey, min(240_000, len(ckey) // 2),
                                                  replace=False),
                                       rng.choice(others, 240_000, replace=False)]))
        vsets = {"empty visited": (none, none),
                 "visited, half in the candidates' range":
                     (torch.from_numpy((v480 >> 32).astype(np.int32)).to(dev),
                      torch.from_numpy((v480 & 0xFFFFFFFF).astype(np.int32)).to(dev)),
                 "visited dense in the candidates' range": CS.dense_visited(dev, 64, 62_500)}
        for vkind, (vh, vl) in vsets.items():
            v = int(vh.shape[0])
            vlabel = f"{vkind}, {v} pairs" if v else vkind
            want = FD.frontier_dedup_plain(*cand, vh, vl)
            mask = torch.empty(c, dtype=torch.bool, device=dev)
            st = build.stream_handle(mask)
            shapes = [(tile, 0) for tile in FD_TILES] if v == 0 else \
                [(tile, s) for tile in FD_TILES for s in FD_CHUNKS]
            fns = {}
            for (th, it), chunk in shapes:
                name = f"T={th * it} ({th}x{it})" + (f", S={chunk}" if chunk else
                                                     ", no chunk" if v else "")
                fns[name] = _dedup_fn(libs, (th, it), chunk, cand, (vh, vl), mask)
            if "parent_fd" in libs:
                f = libs["parent_fd"].frontier_dedup_launch
                fns["parent"] = lambda f=f: build.check(f(
                    cand[0].data_ptr(), cand[1].data_ptr(), c, vh.data_ptr(), vl.data_ptr(), v,
                    mask.data_ptr(), st), "parent frontier_dedup")
            row = {}
            for name, fn in fns.items():
                mask.fill_(True)
                fn()
                CS.require(torch.equal(mask, want), f"frontier_dedup {name} disagrees with the "
                                                    f"plain version ({c}, {vlabel})")
                row[name] = CS.device_ms(fn, 200, kernel="frontier_dedup")
            row["wrapper"] = CS.device_ms(lambda: FD.frontier_dedup(*cand, vh, vl), 200,
                                          kernel="frontier_dedup")
            res[f"{c} candidates, {vlabel}"] = row
            CS.log(f"frontier_dedup {c} candidates, {vlabel}: {json.dumps(row)}")
    return res


def _dedup_fn(libs, tile, chunk, cand, vis, mask):
    """One launch of the swept frontier_dedup instance ``tile`` staging
    ``chunk`` visited pairs (0: every window searched)."""
    f = getattr(libs["fd"], f"fd_{tile[0]}_{tile[1]}")
    c, v = int(cand[0].shape[0]), int(vis[0].shape[0])
    smem = FD.smem_bytes(chunk) if chunk else 0
    st = build.stream_handle(mask)
    return lambda: build.check(f(cand[0].data_ptr(), cand[1].data_ptr(), c, vis[0].data_ptr(),
                                 vis[1].data_ptr(), v, smem, mask.data_ptr(), st),
                               "frontier_dedup")


def record_paths_dedup(dev):
    """The inputs of every frontier_dedup launch of chip_smoke's paths phase
    (p1-p5 on the full-size LSQB store under EngineConfig()): per query, a
    list of (candidates, visited, the candidate columns' 16-byte phases),
    each tensor a copy."""
    import repro_torch
    from repro_torch.core.paths import engine as PE

    store = CS.load_full_store(dev, CS.FULL_SCALE, CS.SEED, {})
    engine = repro_torch.Engine(store, CS._config((None, None)), device=dev)
    calls, real = {}, PE.frontier_dedup

    def recording(ch, cl, vh, vl):
        phase = tuple((x.data_ptr() >> 2) & 3 for x in (ch, cl))
        calls[name].append(((ch.clone(), cl.clone()), (vh.clone(), vl.clone()), phase))
        return real(ch, cl, vh, vl)

    PE.frontier_dedup = recording
    try:
        for name, text in CS.PATH_QUERIES.items():
            calls[name] = []
            CS.run_query(engine, text)
    finally:
        PE.frontier_dedup = real
    del engine, store
    return calls


def _in_range(cand, vis):
    """The visited pairs between the first candidate and the last."""
    from repro_torch.core import vecops

    if int(vis[0].shape[0]) == 0:
        return 0
    kc = vecops._pair_comp(cand[0][[0, -1]], cand[1][[0, -1]])
    kv = vecops._pair_comp(*vis)
    lo = torch.searchsorted(kv, kc[:1])
    hi = torch.searchsorted(kv, kc[1:], right=True)
    return int(hi - lo)


def replay_paths_dedup(libs, dev):
    """Each recorded paths-phase launch replayed alone, its candidate
    columns at their recorded 16-byte phases: its sizes, the visited pairs
    inside the candidates' range, launch_shape's choice, and the device ms
    of this tree's wrapper, of the small tile searching every window, of
    the large tile staging CHUNK pairs (or, with no visited set, the large
    tile), and of the parent's kernel, each checked against the plain
    version first. Per query, the sums over its launches."""
    calls = record_paths_dedup(dev)
    res = {}
    for name, launches in calls.items():
        if not launches:
            continue
        rows = []
        for (ch, cl), vis, phase in launches:
            cand = (CS._at_offset(ch, phase[0]), CS._at_offset(cl, phase[1]))
            c, v = int(ch.shape[0]), int(vis[0].shape[0])
            want = FD.frontier_dedup_plain(*cand, *vis)
            mask = torch.empty(c, dtype=torch.bool, device=dev)
            fns = {"wrapper": lambda cand=cand, vis=vis: FD.frontier_dedup(*cand, *vis),
                   "small tile, searched": _dedup_fn(libs, FD.SMALL_TILE, 0, cand, vis, mask),
                   "large tile" + (f", S={FD.CHUNK}" if v else ""): _dedup_fn(
                       libs, FD.LARGE_TILE, FD.CHUNK if v else 0, cand, vis, mask)}
            if "parent_fd" in libs:
                f = libs["parent_fd"].frontier_dedup_launch
                fns["parent"] = lambda f=f, cand=cand, vis=vis, mask=mask, c=c, v=v: build.check(f(
                    cand[0].data_ptr(), cand[1].data_ptr(), c, vis[0].data_ptr(),
                    vis[1].data_ptr(), v, mask.data_ptr(), build.stream_handle(mask)),
                    "parent frontier_dedup")
            row = {"c": c, "v": v, "v_in_range": _in_range(cand, vis), "phases": list(phase),
                   "shape": list(FD.launch_shape(c, v))}
            for label, fn in fns.items():
                mask.fill_(True)
                got = fn()
                CS.require(torch.equal(got if label == "wrapper" else mask, want),
                           f"frontier_dedup {label} disagrees on {name}'s launch (c={c}, v={v})")
                row[label] = CS.device_ms(fn, REPLAY_ITERS, kernel="frontier_dedup")
            rows.append(row)
            CS.log(f"paths {name} frontier_dedup launch: {json.dumps(row)}")
        total = {k: sum(r[k] for r in rows) for k in rows[0] if k.startswith(("wrapper", "parent"))}
        res[name] = {"launches": rows, "sum_ms": total}
        CS.log(f"paths {name} frontier_dedup, {len(rows)} launches, summed ms: {json.dumps(total)}")
    return res


def _radix_keys(rng, n, dist):
    if dist == "uniform":
        return rng.randint(-(2 ** 31), 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    if dist == "sorted runs":  # a build's sorted subject column, runs of 1-40
        return CS._sorted_keys(rng, n, 40)
    # skewed: half NULL, the rest Zipf-distributed over 2M codes
    keys = (rng.zipf(1.3, n) % 2_000_000).astype(np.int32)
    keys[rng.rand(n) < 0.5] = -1
    return keys


class _RadixRun:
    """The launches of one radix_partition input: every swept variant and
    launch shape, the wrapper, the parent's kernel and torch.bincount of
    the pids, each checked against the plain version first."""

    def __init__(self, libs, dev, keys, n_parts):
        from repro_torch.kernels import radix_partition as RP

        self.libs, self.keys, self.p, self.n = libs, keys, n_parts, int(keys.shape[0])
        self.want = RP.radix_partition_plain(keys, n_parts)
        buf = torch.empty(self.n + RP.VEC - 1, dtype=torch.int32, device=dev)
        off = RP.pid_offset(keys.data_ptr(), buf.data_ptr())
        self.pid = buf[off: off + self.n]
        self.hist = torch.zeros(n_parts, dtype=torch.int32, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # the ticket flush's scratch (zero between launches), the partials'
        # rows, and their tickets
        self.acc = torch.zeros(RP.MAX_PARTS, dtype=torch.int32, device=dev)
        self.rows = torch.zeros(sms * max(RP_BLOCKS_PER_SM) * RP.MAX_PARTS, dtype=torch.int32,
                                device=dev)
        self.tickets = torch.zeros(2, dtype=torch.int32, device=dev)
        self.st = build.stream_handle(keys)

    def shape(self, v):
        """(blocks per SM, copies) for variant ``v`` as the wrapper would
        launch it: small shapes one copy, the others as many as the large
        instance keeps."""
        from repro_torch.kernels import radix_partition as RP

        bps = _rp_default_bps(v)
        if _rp_small(v):
            return bps, 1
        return bps, RP.copies_for(self.p, bps, v[0], max(1, min(RP.MAX_COPIES, 4096 // self.p)))

    def variant(self, v, bps, copies):
        f = getattr(self.libs["rp"], _rp_name(v, bps))
        scratch = self.rows if v[4] == 2 else self.acc
        ticket = self.tickets[v[4] - 1:] if v[4] else self.tickets
        return lambda: build.check(f(
            self.keys.data_ptr(), self.n, self.p, copies, self.pid.data_ptr(),
            self.hist.data_ptr(), scratch.data_ptr(), ticket.data_ptr(), self.st),
            "radix_partition")

    def parent(self):
        f = self.libs["parent_rp"].radix_partition_launch

        def run():
            self.hist.zero_()
            build.check(f(self.keys.data_ptr(), self.n, self.p, self.pid.data_ptr(),
                          self.hist.data_ptr(), self.st), "parent radix_partition")
        return run

    def parent_wrapper(self):
        f = self.libs["parent_rp"].radix_partition_launch

        def run():
            pid = torch.empty(self.n, dtype=torch.int32, device=self.keys.device)
            hist = torch.zeros(self.p, dtype=torch.int32, device=self.keys.device)
            build.check(f(self.keys.data_ptr(), self.n, self.p, pid.data_ptr(),
                          hist.data_ptr(), build.stream_handle(self.keys)),
                        "parent radix_partition")
            return pid, hist
        return run

    def check(self, name, fn, v=None):
        """Run ``fn`` once on a zeroed histogram (the direct flush adds into
        it) and compare; a pids-only variant's histogram is not compared."""
        self.pid.fill_(-7)
        self.hist.zero_()
        fn()
        ok = torch.equal(self.pid, self.want[0]) and (
            v is not None and v[3] == 0 or torch.equal(self.hist, self.want[1]))
        CS.require(ok, f"radix_partition {name} disagrees with the plain version "
                       f"(n={self.n}, P={self.p})")

    def time(self, fn, iters):
        return CS.device_ms(fn, iters, kernel="radix_partition")


def sweep_radix_partition(libs, rng, dev):
    """At every n, P and key distribution: the wrapper (its device time and
    its time per call), both of its instances at their launch shapes, the
    pids-only variant of the wrapper's instance, the parent's kernel (alone,
    and with its histogram's zero fill) and torch.bincount of the pids (the
    histogram half's library yardstick: not one call for the whole
    function). At RP_FOCUS's inputs every compiled variant at its launch
    shape, and the large and small instances at each blocks per SM and
    sub-histogram copies that fit."""
    from repro_torch.kernels import radix_partition as RP

    res = {"grid": {}, "variants": {}}
    inputs = [(n, p, d) for d in RP_DISTS for n in RP_NS for p in RP_PARTS]
    inputs += [(n, p, d) for d in RP_DISTS for n, p in RP_ENGINE if p not in RP_PARTS]
    for n, p, dist in inputs + [f for f in RP_FOCUS if f not in inputs]:
        keys = torch.from_numpy(_radix_keys(rng, n, dist)).to(dev)
        run = _RadixRun(libs, dev, keys, p)
        iters = 50 if n >= 1 << 20 else 200
        row = {}
        wrapper = lambda: RP.radix_partition(keys, p)  # noqa: E731
        got = wrapper()
        CS.require(torch.equal(got[0], run.want[0]) and torch.equal(got[1], run.want[1]),
                   f"radix_partition's wrapper disagrees (n={n}, P={p}, {dist})")
        row["wrapper"] = run.time(wrapper, iters)
        row["wrapper per call (events)"] = CS.call_ms(wrapper, iters)
        large = RP.launch_shape(n, p)[0] == RP.LARGE
        for name in ("large", "small", "small, global atomics",
                     "large, pid only" if large else "small, pid only"):
            v = RP_VARIANTS[name]
            fn = run.variant(v, *run.shape(v))
            run.check(name, fn, v)
            row[name] = run.time(fn, iters)
        if "parent_rp" in libs:
            run.check("parent", run.parent())
            row["parent"] = run.time(run.parent(), iters)
            row["parent with zero fill"] = CS.device_ms(run.parent(), iters)
            # the parent's wrapper (fresh pid, zeroed histogram, one launch)
            # and this tree's, per call with CUDA events, in turns
            turns = {"parent wrapper": run.parent_wrapper(), "wrapper": wrapper}
            for i, name in enumerate(("parent wrapper", "wrapper", "wrapper", "parent wrapper")):
                row[f"{name} per call (events), turn {i + 1}"] = CS.call_ms(turns[name], iters)
        pid = run.want[0]
        row["torch.bincount(pid) (histogram half only)"] = CS.device_ms(
            lambda: torch.bincount(pid, minlength=p), iters)
        if (n, p, dist) in RP_FOCUS:
            var = {}
            for name, v in RP_VARIANTS.items():
                fn = run.variant(v, *run.shape(v))
                run.check(name, fn, v)
                var[name] = run.time(fn, iters)
            for name in ("large", "small"):
                v = RP_VARIANTS[name]
                for bps in RP_BLOCKS_PER_SM:
                    fit = RP.copies_for(p, bps, v[0], v[0] // 32)
                    for copies in RP_COPIES:
                        if copies > fit:
                            continue
                        fn = run.variant(v, bps, copies)
                        label = f"{name}, {bps} blocks per SM, {copies} copies"
                        run.check(label, fn, v)
                        var[label] = run.time(fn, iters)
            # the wrapper on keys the L2 cache does not hold: a 64 MB write
            # between launches evicts them (not timed)
            flush = torch.empty(1 << 24, dtype=torch.int32, device=dev)
            var["wrapper, inputs out of L2"] = run.time(lambda: (flush.zero_(), wrapper()), iters)
            res["variants"][f"n={n}, P={p}, {dist}"] = var
            CS.log(f"radix_partition variants n={n}, P={p}, {dist}: {json.dumps(var)}")
        if (n, p, dist) in inputs:
            res["grid"][f"n={n}, P={p}, {dist}"] = row
        CS.log(f"radix_partition n={n}, P={p}, {dist}: {json.dumps(row)}")
        del run, keys
    return res


def sweep_sip_step(libs, rng, dev):
    """The SIP step of one 4,096-row scan batch with one and two filters:
    the fused call (one bloom_probe launch) against the unfused sequence
    of earlier trees (per filter two comparisons, their AND, the probe, its
    AND, a zeroed full-capacity mask, its slice copy and the in-place AND)
    with the parent's bloom_probe kernel, each from its first torch call to
    the mask: CUDA-event time per call, taken in turns (parent, fused,
    fused, parent), and the device time of all its ops."""
    from repro_torch.kernels import bloom_filter as BF

    n = SIP_ROWS
    words = [BF.bloom_build(torch.from_numpy(rng.randint(0, 300_000, m).astype(np.int32))
                            .to(dev))[0] for m in (1_369_041, 50_000)]
    res = {}
    for k in (1, 2):
        cols = torch.from_numpy(rng.randint(-1, 300_000, (k, n)).astype(np.int32)).to(dev)
        filters = [(cols[j], words[j], 0, 299_999) for j in range(k)]
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        fused = lambda: BF.sip_mask(mask, n, filters)  # noqa: E731
        want = BF.sip_mask_plain(mask.clone(), n, filters)
        CS.require(torch.equal(BF.sip_mask(mask.clone(), n, filters), want),
                   f"sip_mask disagrees with its plain version ({k} filters)")
        row = {}
        steps = {"fused": fused}
        if "parent_bf" in libs:
            f = libs["parent_bf"].bloom_probe_launch

            def parent(target, f=f):
                for codes, w, lo, hi in filters:
                    m = (codes >= lo) & (codes <= hi)
                    out = torch.empty(n, dtype=torch.bool, device=dev)
                    build.check(f(w.data_ptr(), int(w.shape[0]), codes.data_ptr(), n,
                                  out.data_ptr(), build.stream_handle(out)), "parent bloom_probe")
                    m &= out
                    full = torch.zeros(n, dtype=torch.bool, device=dev)
                    full[:n] = m
                    target.logical_and_(full)
                return target

            CS.require(torch.equal(parent(mask.clone()), want),
                       f"the parent's SIP step disagrees ({k} filters)")
            steps["parent"] = lambda: parent(mask)
        order = ["parent", "fused", "fused", "parent"] if "parent" in steps else ["fused"] * 2
        for i, name in enumerate(order):
            row[f"{name} per call (events), turn {i + 1}"] = CS.call_ms(steps[name], 200)
        for name, fn in steps.items():
            row[f"{name} device ms (all ops)"] = CS.device_ms(fn, 200)
        row["fused kernel device ms"] = CS.device_ms(fused, 200, kernel="bloom_probe")
        desc = BF._descriptor(filters)
        for it in SIP_ITEMS:
            fn = _sip_variant(libs, it, desc, mask, mask, n)
            got = mask.clone()
            _sip_variant(libs, it, desc, got, got, n)()
            CS.require(torch.equal(got, BF.sip_mask_plain(mask.clone(), n, filters)),
                       f"sip_mask at {it} rows a thread disagrees ({k} filters)")
            row[f"kernel device ms, {it} rows a thread"] = CS.device_ms(fn, 200,
                                                                       kernel="bloom_probe")
        res[f"{k} filter(s), {n} rows"] = row
        CS.log(f"SIP step, {k} filter(s), {n} rows: {json.dumps(row)}")
    # bloom_probe(words, queries): no mask, one filter over the int32 range
    for c in SIP_QUERIES:
        q = torch.from_numpy(rng.randint(-1, 300_000, c).astype(np.int32)).to(dev)
        want = BF.bloom_probe_plain(words[0], q)
        out = torch.empty(c, dtype=torch.bool, device=dev)
        desc = BF._descriptor([(q, words[0], -(2 ** 31), 2 ** 31 - 1)])
        row = {"wrapper": CS.device_ms(lambda: BF.bloom_probe(words[0], q), 200,
                                       kernel="bloom_probe")}
        CS.require(torch.equal(BF.bloom_probe(words[0], q), want),
                   f"bloom_probe disagrees with its plain version ({c} queries)")
        for it in SIP_ITEMS:
            fn = _sip_variant(libs, it, desc, None, out, c)
            out.fill_(True)
            fn()
            CS.require(torch.equal(out, want), f"bloom_probe at {it} rows a thread disagrees")
            row[f"{it} rows a thread"] = CS.device_ms(fn, 200, kernel="bloom_probe")
        if "parent_bf" in libs:
            f = libs["parent_bf"].bloom_probe_launch
            fn = lambda f=f: build.check(f(  # noqa: E731
                words[0].data_ptr(), int(words[0].shape[0]), q.data_ptr(), c, out.data_ptr(),
                build.stream_handle(out)), "parent bloom_probe")
            out.fill_(False)
            fn()
            CS.require(torch.equal(out, want), "the parent's bloom_probe disagrees")
            row["parent"] = CS.device_ms(fn, 200, kernel="bloom_probe")
        res[f"bloom_probe, {c} queries"] = row
        CS.log(f"bloom_probe, {c} queries: {json.dumps(row)}")
    return res


def _bloom_keys(rng, dev, n, order):
    """Keys in [0, 300,000) (wider past 2^18) in ``order``: random, the hash
    join's grouped layout (by radix partition at its partition count, then
    key), all equal, or half NULL."""
    if order == "all equal":
        return torch.full((n,), 12345, dtype=torch.int32, device=dev)
    keys = torch.from_numpy(rng.randint(0, max(300_000, n // 4), n).astype(np.int32)).to(dev)
    if order == "half NULL":
        keys[torch.from_numpy(rng.permutation(n)[: n // 2]).to(dev)] = -1
    if order == "grouped":
        from repro_torch.core.operators.hash_join import _n_parts_for

        keys = CS._engine_order(keys, _n_parts_for(n))
    return keys


def sweep_bloom_build(libs, rng, dev):
    """bloom_build at BB_KEYS keys in BB_ORDERS: the wrapper's kernel (device
    ms, kernel only) and its time per call; the parent's one-thread-a-key kernel
    (--parent) alone and with its wrapper's zero fill, aminmax and stack
    (device ms of all of them), and its wrapper's time per call, taken in
    turns with this tree's (parent, this, this, parent); in random order
    (and every order at the q6 shape) this tree's kernel at each of
    BB_THREADS and BB_BLOCKS; and the merges that lost (BB_VARIANTS). Every
    launch is checked against the plain version first."""
    from repro_torch.core import vecops as TV
    from repro_torch.kernels import bloom_filter as BF

    bb = libs["bb"]
    st = build.stream_handle(torch.empty(1, device=dev))
    scratch = torch.empty(16 * BF.REACH, dtype=torch.int32, device=dev)
    res = {}
    for n in BB_KEYS:
        for order in BB_ORDERS:
            keys = _bloom_keys(rng, dev, n, order)
            nw = TV.bloom_n_words(n)
            r = min(nw, BF.REACH)
            want = BF.bloom_build_plain(keys, nw)
            words = torch.empty(nw, dtype=torch.int32, device=dev)
            row = {"bound_ms": CS.bound(4 * n + 4 * nw, 12 * n)[0]}

            def checked(label, fn):
                CS.require(torch.equal(fn(), want), f"bloom_build {label} disagrees ({n}, {order})")
                return CS.device_ms(fn, 100, kernel="bloom_build")

            row["wrapper"] = checked("wrapper", lambda: BF.bloom_build(keys)[0])
            if "parent_bf" in libs:
                f = libs["parent_bf"].bloom_build_launch

                def parent_kernel():
                    build.check(f(keys.data_ptr(), n, nw, words.data_ptr(), st), "parent")
                    return words

                def parent_wrapper():
                    w = torch.zeros(nw, dtype=torch.int32, device=dev)
                    build.check(f(keys.data_ptr(), n, nw, w.data_ptr(), st), "parent")
                    lo, hi = torch.aminmax(keys)
                    return w, torch.stack([lo, hi])

                words.zero_()
                row["parent kernel"] = checked("parent", parent_kernel)
                CS.require(torch.equal(parent_wrapper()[0], want), "parent wrapper disagrees")
                row["parent with fill and range"] = CS.device_ms(parent_wrapper, 100)
                ours = lambda: BF.bloom_build(keys)  # noqa: E731
                theirs = lambda: parent_wrapper()[1].tolist()  # noqa: E731
                calls = [CS.call_ms(fn, 100) for fn in (theirs, ours, ours, theirs)]
                row["call ms (parent, this, this, parent)"] = calls
            if order == "random" or n == 1_369_041:
                for t in (BB_THREADS if order == "random" else (1024,)):
                    g = getattr(bb, f"bb_{t}")
                    for blocks in BB_BLOCKS:
                        if blocks > max(1, -(-n // 512)):
                            continue

                        def launch(g=g, blocks=blocks):
                            state = build.zeroed(dev, BF.STATE_WORDS, st)
                            build.check(g(keys.data_ptr(), n, nw, words.data_ptr(),
                                          state.data_ptr(), blocks, st), "bloom_build")
                            return words
                        row[f"{t} threads, {blocks} blocks"] = checked(f"{t}x{blocks}", launch)
                for name, v in BB_VARIANTS.items():
                    if v in (4, 5) and r < 64:
                        continue

                    def variant(v=v):
                        if v in (0, 4, 5):
                            words[:r].zero_()
                        state = build.zeroed(dev, 2 + 2 * 128, st)
                        build.check(bb.bb_variant_launch(
                            v, keys.data_ptr(), n, nw, words.data_ptr(), scratch.data_ptr(),
                            state.data_ptr(), BF.launch_shape(n), st), name)
                        return words
                    row[name] = checked(name, variant)
            res[f"{n} keys, {order}"] = row
            CS.log(f"bloom_build {n} keys, {order}: {json.dumps(row)}")
    return res


def _sip_variant(libs, items, desc, mask_in, out, n):
    """One launch of the swept probe instance at ``items`` rows a thread."""
    f = getattr(libs["sp"], f"sp_{items}")
    st = build.stream_handle(out)
    return lambda: build.check(f(ctypes.addressof(desc),
                                 None if mask_in is None else mask_in.data_ptr(),
                                 out.data_ptr(), n, int(out.shape[0]), st), "sip_mask")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="root of an earlier checkout whose expr_eval.cu is timed beside")
    ap.add_argument("--json", default=None, help="write the results here")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--only", default=",".join(SWEEPS),
                    help="comma-separated sweeps to run, of: " + ", ".join(SWEEPS))
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if set(only) - set(SWEEPS):
        ap.error(f"unknown sweeps {sorted(set(only) - set(SWEEPS))}")
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(card, flush=True)
    libs = build_libraries(args.parent)
    rng = np.random.RandomState(args.seed)
    runs = {"hash_probe": lambda: sweep_hash_probe(libs, rng, dev),
            "frontier_dedup": lambda: sweep_frontier_dedup(libs, rng, dev),
            "frontier_dedup_paths": lambda: replay_paths_dedup(libs, dev),
            "compiler": lambda: compiler_report(args.parent),
            "expr_eval": lambda: sweep_expr_eval(libs, rng, dev, args.parent),
            "join_expand": lambda: sweep_join_expand(libs, rng, dev),
            "gather_emit": lambda: sweep_gather_emit(libs, rng, dev),
            "radix_partition": lambda: sweep_radix_partition(libs, rng, dev),
            "sip_step": lambda: sweep_sip_step(libs, rng, dev),
            "bloom_build": lambda: sweep_bloom_build(libs, rng, dev)}
    res = {"card": card}
    for name in SWEEPS:
        if name in only:
            res[name] = runs[name]()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
