"""Partitioned relations on the device: the radix layout of out-of-core
execution, as in the reference's ``core/partition.py``.

``PartitionedRelation`` holds rows fanned out by a partition hash, tracks
a byte budget for the device memory it holds, and spills whole partitions
to ``.npy`` files in ``spill_dir`` (mkstemp, ``np.save`` of the chunk
copied to the host, unlink when the partition is taken or the relation
closes), largest first. The grace hash join fans both inputs out once and
joins one partition at a time, each small enough for the resident radix
build; a skewed bucket that still exceeds the budget re-partitions with
the next level's multiplier, so a level-0 pile-up cannot survive to
level 1. Partitioned GROUP BY and DISTINCT aggregate one partition at a
time.

The partition hashes use multipliers disjoint from ``vecops.HASH_MULT`` /
``MIX_MULT``: inside each loaded grace partition the resident build hashes
with those, and a correlated grace hash would funnel each partition's rows
into a handful of its buckets. They are uint32 arithmetic written in int64
masked to 32 bits, and equal the reference's ids bit for bit at every
level (NULL_ID == -1 hashes as 0xFFFFFFFF, INT32_MIN as 0x80000000).

The fan-out is plain tensor code: one stable sort of the partition ids,
one gather, one device-to-host copy of the partitions' boundaries (their
histogram, as a search of the sorted ids), then one copied chunk per
non-empty partition.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import vecops

# per-recursion-level partition multipliers; level k uses
# _LEVEL_MULTS[k % 4] (0x9E3779B1, vecops' own, only at level 3, after two
# fan-outs have decorrelated the key stream)
_LEVEL_MULTS = (0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0x9E3779B1)

_MULTI_FOLD_MULT = 0x01000193  # FNV-1a prime for column folding

_I32 = torch.int32


def _level_hash(acc: torch.Tensor, n_parts: int, level: int) -> torch.Tensor:
    mult = _LEVEL_MULTS[level % len(_LEVEL_MULTS)]
    h = vecops._mul32(acc, mult) >> 16
    return (h & (n_parts - 1)).to(_I32)


def partition_ids(key_hi: Optional[torch.Tensor], key_lo: torch.Tensor,
                  n_parts: int, level: int = 0) -> torch.Tensor:
    """Partition id per row from (hi, lo) packed key halves, the hash
    join's key form. ``n_parts`` must be a power of two."""
    return _level_hash(vecops._u32(vecops.mix_pair(key_hi, key_lo)), n_parts, level)


def partition_ids_multi(cols: Sequence[torch.Tensor], n_parts: int,
                        level: int = 0) -> torch.Tensor:
    """Partition id from raw key columns (equal tuples land in the same
    partition; cross-tuple collisions cost balance only). Used by the
    grace join and partitioned GROUP BY / DISTINCT."""
    acc = vecops._u32(cols[0])
    for c in cols[1:]:
        acc = vecops._mul32(acc, _MULTI_FOLD_MULT) ^ vecops._u32(c)
    return _level_hash(acc, n_parts, level)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * 4  # int32 rows, as the reference's nbytes


def _fan_out(cols: torch.Tensor, pids: torch.Tensor,
             n_parts: int) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """(rows grouped by partition, host counts, host starts). The
    partitions' boundaries come from a search of the sorted ids and reach
    the host in one copy (``torch.bincount`` would read its input's range
    back first)."""
    sorted_pids, order = torch.sort(pids, stable=True)
    scattered = cols[:, order]
    bounds = torch.arange(n_parts + 1, dtype=pids.dtype, device=pids.device)
    starts = torch.searchsorted(sorted_pids, bounds).cpu().numpy()
    return scattered, np.diff(starts), starts


class PartitionedRelation:
    """Rows of an ``(n_vars, n)`` int32 device relation fanned out into
    ``n_parts`` buckets, with a budget-driven spill lifecycle.

    Each partition is a list of device chunks plus a list of spill files.
    When the resident bytes exceed ``budget_bytes`` the largest resident
    partitions spill until residency is back under half the budget (half,
    so steady appends don't spill once a batch). ``take(p)`` loads a
    partition back onto the device and frees it at once, files unlinked;
    ``close()`` is idempotent and unlinks everything, and operators call
    it from their ``_close`` hook so that executor teardown reaches it
    even when a query fails mid-drain."""

    def __init__(self, n_vars: int, n_parts: int, device: torch.device,
                 spill_dir: Optional[str] = None, budget_bytes: Optional[int] = None,
                 pool=None):
        self.n_vars = n_vars
        self.n_parts = n_parts
        self.device = device
        self.spill_dir = spill_dir
        self.budget_bytes = budget_bytes
        self.pool = pool
        self._chunks: List[List[torch.Tensor]] = [[] for _ in range(n_parts)]
        self._files: List[List[str]] = [[] for _ in range(n_parts)]
        self.part_rows = np.zeros(n_parts, dtype=np.int64)
        self._resident_bytes = 0
        self._closed = False
        self.spill_bytes = 0
        self.spill_files = 0

    # -- ingest ------------------------------------------------------------

    def append(self, cols: torch.Tensor, pids: torch.Tensor) -> None:
        """Scatter ``cols`` (n_vars, n) into partitions by ``pids``."""
        if int(cols.shape[1]) == 0:
            return
        scattered, counts, starts = _fan_out(cols, pids, self.n_parts)
        for p in np.nonzero(counts)[0]:
            # a chunk owns its memory: a view would keep the whole
            # scattered block alive, and a spill would free nothing
            chunk = scattered[:, starts[p]: starts[p + 1]].clone()
            self._chunks[p].append(chunk)
            self.part_rows[p] += chunk.shape[1]
            self._resident_bytes += _nbytes(chunk)
        if self.pool is not None:
            self.pool.bytes_copied += _nbytes(scattered)
        self._maybe_spill()

    # -- spill lifecycle ---------------------------------------------------

    def _maybe_spill(self) -> None:
        if (
            self.budget_bytes is None
            or self.spill_dir is None
            or self._resident_bytes <= self.budget_bytes
        ):
            return
        target = self.budget_bytes // 2
        sizes = sorted(
            ((sum(_nbytes(c) for c in self._chunks[p]), p)
             for p in range(self.n_parts) if self._chunks[p]),
            reverse=True,
        )
        for nbytes, p in sizes:
            if self._resident_bytes <= target:
                break
            self._spill_partition(p, nbytes)

    def _spill_partition(self, p: int, nbytes: int) -> None:
        chunks = self._chunks[p]
        block = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=1)
        fd, path = tempfile.mkstemp(suffix=".npy", dir=self.spill_dir)
        os.close(fd)
        self._files[p].append(path)
        np.save(path, block.cpu().numpy())
        self._chunks[p] = []
        self._resident_bytes -= nbytes
        self.spill_bytes += _nbytes(block)
        self.spill_files += 1

    # -- consumption -------------------------------------------------------

    def load(self, p: int) -> torch.Tensor:
        """Partition ``p`` as one (n_vars, rows) device block (spilled
        rows first, then resident ones, in append order). Frees nothing."""
        blocks = [torch.from_numpy(np.load(path)).to(self.device) for path in self._files[p]]
        blocks.extend(self._chunks[p])
        if not blocks:
            return torch.zeros((self.n_vars, 0), dtype=_I32, device=self.device)
        if len(blocks) == 1:
            return blocks[0]
        return torch.cat(blocks, dim=1)

    def take(self, p: int) -> torch.Tensor:
        """``load(p)``, then free the partition (its files unlinked)."""
        block = self.load(p)
        self._free_partition(p)
        return block

    def _free_partition(self, p: int) -> None:
        for path in self._files[p]:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        self._files[p] = []
        self._resident_bytes -= sum(_nbytes(c) for c in self._chunks[p])
        self._chunks[p] = []

    # -- teardown ----------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    @property
    def total_rows(self) -> int:
        return int(self.part_rows.sum())

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for p in range(self.n_parts):
            self._free_partition(p)

    def __del__(self):  # safety net; close() is the contract
        try:
            self.close()
        except Exception:
            pass


def fan_in(child, rel: PartitionedRelation, vars_: Sequence[int],
           key_vars: Sequence[int]) -> int:
    """Drain a batch operator into ``rel``: each batch's ``vars_`` columns
    by the partition ids of its ``key_vars``. Returns the rows appended."""
    vars_ = tuple(vars_)
    total = 0
    while (b := child.next_batch()) is not None:
        cb = b.compact()
        if cb.n_rows:
            cols = cb.columns[[cb.col_index(v) for v in vars_], : cb.n_rows]
            rel.append(cols, partition_ids_multi([cols[vars_.index(k)] for k in key_vars],
                                                 rel.n_parts))
            total += cb.n_rows
        cb.release()
    return total


def split_block(cols: torch.Tensor, pids: torch.Tensor,
                n_parts: int) -> List[Tuple[int, torch.Tensor]]:
    """One-shot fan-out of a block into ``[(pid, sub_block), ...]`` without
    a PartitionedRelation: the grace join's recursive re-partition, whose
    sub-blocks are consumed at once (views of one scattered block)."""
    scattered, counts, starts = _fan_out(cols, pids, n_parts)
    return [(int(p), scattered[:, starts[p]: starts[p + 1]]) for p in np.nonzero(counts)[0]]
