"""radix_partition: multiplicative-hash partition ids and their histogram.

``pid[i] = ((u32(keys[i]) * 0x9E3779B1) >> 16) & (n_parts - 1)`` and the
(n_parts,) int32 count of keys per partition — the bucketing step of the
hash join's build (``hash_join.hash_build``). ``n_parts`` is a power of
two, at most ``MAX_PARTS``.

Every int32 key is a real key, INT32_MIN included, as in the reference's
numpy oracle; the Pallas kernel maps INT32_MIN to pid -1 because that is
its padding. The hash join never partitions INT32_MIN (``mix_pair`` remaps
it, and dictionary codes are >= -1).

CUDA kernel: ``csrc/radix_partition.cu``: per-warp sub-histograms in
shared memory, and for large inputs a grid of one block per SM with 16-byte
key loads and pid stores. On the card ``pid`` is a view into a buffer 3
elements longer, laid on the keys' 16-byte phase (``pid_offset``), so that
a key view at any 4-byte phase takes vector loads and stores;
``launch_shape`` picks the instance (batch, small or large, each with its
blocks per SM compiled in) and the sub-histogram copies a block keeps.
The kernel adds into a histogram that starts at zero: the wrapper cuts it
from a slab of zeros (``build.zeroed``) that one fill makes ready for many
calls, so a call is one launch.
``radix_partition_plain`` is the same function in PyTorch; the wrapper
takes it for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Tuple

import torch

from repro_torch.core import vecops
from repro_torch.kernels import build

# the kernel keeps the histogram in shared memory (32 KB a copy at 8,192)
MAX_PARTS = 8192
# the compiled instances (csrc/radix_partition.cu), checked when the
# library loads: the large one's threads, keys a vector and blocks per SM,
# the small and batch ones' threads and blocks per SM
LARGE_THREADS = 512
VEC = 4
LARGE_BLOCKS_PER_SM = 1
SMALL_THREADS = 256
SMALL_BLOCKS_PER_SM = 4
# the instances (csrc/radix_partition.cu, INSTANCE_*) and when each runs
# (kernel_sweep.py's choice): batch up to BATCH_UPTO keys; small below
# LARGE_FROM keys, and below SMALL_P_UPTO_KEYS with at most SMALL_P_PARTS
# partitions; else large. Batch and small keep one histogram a block.
SMALL, BATCH, LARGE = 0, 1, 2
BATCH_UPTO = 4096
LARGE_FROM = 1 << 18
SMALL_P_PARTS, SMALL_P_UPTO_KEYS = 16, 1 << 20
MAX_COPIES = 4
# shared memory of one SM that the blocks on it divide between them, less
# what the card reserves for each block
SM_SMEM = 233_472
BLOCK_RESERVE = 1024
launches = 0


def radix_partition_plain(keys: torch.Tensor, n_parts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    pid = vecops.hash_partition(keys, n_parts)
    return pid, vecops.partition_histogram(pid, n_parts)


def launch_shape(n: int, n_parts: int) -> Tuple[int, int]:
    """(instance, sub-histogram copies a block). The large instance keeps
    up to MAX_COPIES copies, fewer as P grows (a copy is zeroed and summed
    by every block, and collisions are rarer), and only as many as fit in
    shared memory (one at 8,192 partitions)."""
    if n <= BATCH_UPTO:
        return BATCH, 1
    if n < LARGE_FROM or (n_parts <= SMALL_P_PARTS and n < SMALL_P_UPTO_KEYS):
        return SMALL, 1
    return LARGE, copies_for(n_parts, LARGE_BLOCKS_PER_SM, LARGE_THREADS,
                             max(1, min(MAX_COPIES, 4096 // n_parts)))


def copies_for(n_parts: int, blocks_per_sm: int, threads: int, want: int) -> int:
    """The largest power of two at most ``want``, one a warp, whose copies
    of ``n_parts`` bins fit ``blocks_per_sm`` blocks on one SM."""
    fit = (SM_SMEM // blocks_per_sm - BLOCK_RESERVE) // (4 * n_parts)
    copies = 1
    while copies * 2 <= min(want, threads // 32, fit):
        copies *= 2
    return copies


def pid_offset(keys_ptr: int, buf_ptr: int) -> int:
    """Where in a buffer at ``buf_ptr`` the pids start, so that they lie on
    the keys' 16-byte phase (in int32 elements)."""
    return ((keys_ptr - buf_ptr) >> 2) % VEC


@functools.lru_cache(maxsize=1)
def _check_limits(lib) -> None:
    got = [ctypes.c_int() for _ in range(6)]
    lib.radix_partition_limits(*[ctypes.byref(x) for x in got])
    want = (LARGE_THREADS, VEC, LARGE_BLOCKS_PER_SM, SMALL_THREADS, SMALL_BLOCKS_PER_SM,
            build.SMEM_MAX)
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"radix_partition: kernel shapes {[x.value for x in got]} != {want}")


def radix_partition(keys: torch.Tensor, n_parts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pid (n,) int32, histogram (n_parts,) int32) — see module docstring."""
    global launches
    t0 = time.perf_counter()
    if n_parts < 1 or n_parts & (n_parts - 1):
        raise ValueError(f"radix_partition: n_parts={n_parts} is not a power of two")
    if n_parts > MAX_PARTS:
        raise ValueError(f"radix_partition: n_parts={n_parts} exceeds {MAX_PARTS}")
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("radix_partition: keys must be a contiguous 1-D int32 tensor")
    if keys.device.type == "cpu":
        out = radix_partition_plain(keys, n_parts)
        build.ledger("radix_partition", "plain", t0)
        return out
    if keys.device.type != "cuda":
        raise ValueError(f"radix_partition: unsupported device {keys.device}")
    n = int(keys.shape[0])
    buf = torch.empty(n + VEC - 1, dtype=torch.int32, device=keys.device)
    off = pid_offset(keys.data_ptr(), buf.data_ptr())
    pid = buf[off: off + n]
    stream = build.stream_handle(keys)
    hist = build.zeroed(keys.device, n_parts, stream)
    lib = build.library()
    _check_limits(lib)
    build.check(lib.radix_partition_launch(
        keys.data_ptr(), n, n_parts, *launch_shape(n, n_parts), pid.data_ptr(),
        hist.data_ptr(), stream,
    ), "radix_partition")
    launches += 1
    build.ledger("radix_partition", "cuda", t0)
    return pid, hist
