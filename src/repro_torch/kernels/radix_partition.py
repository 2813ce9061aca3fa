"""radix_partition: multiplicative-hash partition ids and their histogram.

``pid[i] = ((u32(keys[i]) * 0x9E3779B1) >> 16) & (n_parts - 1)`` and the
(n_parts,) int32 count of keys per partition — the bucketing step of the
hash join's build (``hash_join.hash_build``). ``n_parts`` is a power of
two, at most ``MAX_PARTS``.

Every int32 key is a real key, INT32_MIN included, as in the reference's
numpy oracle; the Pallas kernel maps INT32_MIN to pid -1 because that is
its padding. The hash join never partitions INT32_MIN (``mix_pair`` remaps
it, and dictionary codes are >= -1).

CUDA kernel: ``csrc/radix_partition.cu``. ``radix_partition_plain`` is the
same function in PyTorch; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import vecops
from repro_torch.kernels import build

# the kernel keeps the histogram in one block's shared memory (32 KB)
MAX_PARTS = 8192
launches = 0


def radix_partition_plain(keys: torch.Tensor, n_parts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    pid = vecops.hash_partition(keys, n_parts)
    return pid, vecops.partition_histogram(pid, n_parts)


def radix_partition(keys: torch.Tensor, n_parts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pid (n,) int32, histogram (n_parts,) int32) — see module docstring."""
    global launches
    if n_parts < 1 or n_parts & (n_parts - 1):
        raise ValueError(f"radix_partition: n_parts={n_parts} is not a power of two")
    if n_parts > MAX_PARTS:
        raise ValueError(f"radix_partition: n_parts={n_parts} exceeds {MAX_PARTS}")
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("radix_partition: keys must be a contiguous 1-D int32 tensor")
    if keys.device.type == "cpu":
        return radix_partition_plain(keys, n_parts)
    if keys.device.type != "cuda":
        raise ValueError(f"radix_partition: unsupported device {keys.device}")
    n = int(keys.shape[0])
    pid = torch.empty(n, dtype=torch.int32, device=keys.device)
    hist = torch.zeros(n_parts, dtype=torch.int32, device=keys.device)
    lib = build.library()
    build.check(lib.radix_partition_launch(
        keys.data_ptr(), n, n_parts, pid.data_ptr(), hist.data_ptr(),
        build.stream_handle(keys),
    ), "radix_partition")
    launches += 1
    return pid, hist
