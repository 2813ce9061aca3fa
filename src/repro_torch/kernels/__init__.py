"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each module holds its kernels' wrappers, their plain versions and a plain
integer launch counter per kernel (``launches``; the bloom filter module
has ``build_launches`` and ``probe_launches``) that the wrapper bumps once
per kernel launch. A wrapper handed CPU tensors runs the plain version;
handed CUDA tensors it launches the kernel or raises. The kernels build
from ``repro_torch/csrc/*.cu`` at the first launch (see ``build``).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (
    bloom_filter,
    expr_eval,
    frontier_dedup,
    gather_emit,
    hash_join,
    join_expand,
    radix_partition,
    segment_scan,
    sorted_search,
)

# kernel name -> (module, name of its launch counter)
KERNEL_MODULES = {
    "join_expand": (join_expand, "launches"),
    "gather_emit": (gather_emit, "launches"),
    "expr_eval": (expr_eval, "launches"),
    "segment_scan": (segment_scan, "launches"),
    "radix_partition": (radix_partition, "launches"),
    "hash_probe": (hash_join, "launches"),
    "bloom_build": (bloom_filter, "build_launches"),
    "bloom_probe": (bloom_filter, "probe_launches"),
    "sorted_search": (sorted_search, "launches"),
    "frontier_dedup": (frontier_dedup, "launches"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(m, attr) for name, (m, attr) in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for m, attr in KERNEL_MODULES.values():
        setattr(m, attr, 0)
