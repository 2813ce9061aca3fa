"""Vectorized data-plane helpers on device tensors (main-path subset of
the reference's ``core/vecops.py``).

These are the per-batch computations the operators run outside the
kernels: run detection, group probing, group output offsets, composite
group keys, the run-end pick around the segmented scan, the hash join's
and the bloom filter's address arithmetic, and the property-path engine's
pair keys and visited-set merge. Each matches its numpy
counterpart in the reference on the same inputs.

uint32 arithmetic is written in int64 masked to 32 bits (torch's uint32
support is thin); ``_mul32`` splits the multiplier so that no product
leaves int64.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

_I32 = torch.int32
_I64 = torch.int64
_U32 = 0xFFFFFFFF


def run_boundaries(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Runs of equal values in a sorted key column: (values, starts,
    lengths), all int32; run i occupies keys[starts[i] : starts[i] + lengths[i]]."""
    n = int(keys.shape[0])
    if n == 0:
        e = torch.zeros(0, dtype=_I32, device=keys.device)
        return e, e, e
    is_start = torch.ones(n, dtype=torch.bool, device=keys.device)
    is_start[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(is_start).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    return keys[starts].to(_I32), starts.to(_I32), (ends - starts).to(_I32)


def probe_groups(lvals: torch.Tensor, rvals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match left runs against right runs by key (both sorted ascending,
    unique within each side): (left_run_idx, right_run_idx) int32 for every
    matching pair — the paper's 'input groups'."""
    if int(rvals.shape[0]) == 0:
        e = torch.zeros(0, dtype=_I32, device=lvals.device)
        return e, e
    pos = torch.searchsorted(rvals, lvals)
    hit = rvals[pos.clamp(max=rvals.shape[0] - 1)] == lvals
    li = torch.nonzero(hit).flatten()
    return li.to(_I32), pos[li].to(_I32)


def group_output_offsets(llens: torch.Tensor, rlens: torch.Tensor) -> torch.Tensor:
    """int64 cum[i] = total output rows of groups < i; cum[-1] = grand
    total. Output rows of group g = llens[g] * rlens[g]."""
    counts = llens.to(torch.int64) * rlens.to(torch.int64)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def lexsort(keys) -> torch.Tensor:
    """np.lexsort: permutation sorting by the LAST key first (stable)."""
    keys = list(keys)
    n = int(keys[0].shape[0])
    order = torch.arange(n, device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def pack_group_keys(key_cols: torch.Tensor,
                    spans: Optional[Sequence[int]] = None) -> Optional[torch.Tensor]:
    """Pack a (k, n) block of int32 group-key columns (NULL_ID == -1
    allowed) into one int64 composite key whose order and equality match
    the lexicographic order of the columns.

    ``spans=None`` (grouping): per-column ranges max+2; falls back to a
    dense rank when the range product would overflow 63 bits.

    Fixed ``spans`` (multi-variable hash-join keys, sized from the build
    side with one spare sentinel slot per column): values at or above a
    span clamp to its last slot, so out-of-range probe values never match
    a build key. Returns None when the span product reaches 2^62 (the join
    then hashes its primary key and verifies the rest pairwise)."""
    k, n = key_cols.shape
    if k < 1:
        raise ValueError("pack_group_keys needs at least one column")
    if spans is not None:
        if len(spans) != k:
            raise ValueError("pack_group_keys: one span per column")
        if math.prod(int(s) for s in spans) >= 1 << 62:
            return None
        packed = (key_cols[0].to(_I64) + 1).clamp_(max=int(spans[0]) - 1)
        for c, s in zip(key_cols[1:], spans[1:]):
            packed = packed * int(s) + (c.to(_I64) + 1).clamp_(max=int(s) - 1)
        return packed
    packed = key_cols[0].to(torch.int64) + 1
    span = (int(key_cols[0].max()) if n else -1) + 2
    for c in key_cols[1:]:
        r = (int(c.max()) if n else -1) + 2
        if span * r >= 1 << 62:
            order = lexsort(tuple(key_cols.flip(0)))
            srt = key_cols[:, order]
            change = torch.zeros(n, dtype=torch.bool, device=key_cols.device)
            if n:
                change[0] = True
                for row in srt:
                    change[1:] |= row[1:] != row[:-1]
            out = torch.empty(n, dtype=torch.int64, device=key_cols.device)
            out[order] = torch.cumsum(change.to(torch.int64), 0) - 1
            return out
        packed = packed * r + (c.to(torch.int64) + 1)
        span *= r
    return packed


def segment_reduce(keys: torch.Tensor, values: Optional[torch.Tensor],
                   func: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(run_keys int32, per-run aggregates float64) over sorted keys: one
    segment_scan launch, then the last element of each run. ``values`` is
    None for COUNT(*)."""
    # imported here: the kernel modules import this module
    from repro_torch.kernels.segment_scan import segment_scan

    n = int(keys.shape[0])
    if n == 0:
        return keys.to(_I32), torch.zeros(0, dtype=torch.float64, device=keys.device)
    if func == "count" or values is None:
        scan = segment_scan(keys.contiguous(), None, "count")  # the kernel makes the ones
    else:
        scan = segment_scan(keys.contiguous(), values.to(torch.float64).contiguous(), func)
    run_end = torch.ones(n, dtype=torch.bool, device=keys.device)
    run_end[:-1] = keys[1:] != keys[:-1]
    return keys[run_end].to(_I32), scan[run_end]


# ---------------------------------------------------------------------------
# hash partitioning and the radix-partitioned hash join's keys
# ---------------------------------------------------------------------------
#
# A join key is an int32 (hi, lo) pair compared lexicographically: single-
# variable keys pass hi=None (all zero) and lo = the code column (NULL_ID ==
# -1 is an ordinary value); multi-variable keys pack through
# pack_group_keys(spans=...) into a non-negative int64 split as
# hi = packed >> 31, lo = packed & 0x7FFFFFFF, so hi >= 0.

HASH_MULT = 0x9E3779B1  # Fibonacci hashing
MIX_MULT = 0x85EBCA6B  # murmur3 fmix constant
_INT32_MIN = -(1 << 31)


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u * c) mod 2^32 for int64 ``u`` in [0, 2^32): the multiplier is
    split in 16-bit halves so every partial product stays below 2^48."""
    lo = u * (c & 0xFFFF)
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an int32 tensor, as int64."""
    return x.to(_I64) & _U32


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) back to the int32 with that bit pattern."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(_I32)


def hash_partition(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Multiplicative-hash partition id per key (n_parts a power of two):
    ``((u32(key) * 0x9E3779B1) >> 16) & (n_parts - 1)``, int32."""
    h = _mul32(_u32(keys), HASH_MULT) >> 16
    return (h & (n_parts - 1)).to(_I32)


def partition_histogram(part_ids: torch.Tensor, n_parts: int) -> torch.Tensor:
    return torch.bincount(part_ids.to(_I64), minlength=n_parts).to(_I32)


def mix_pair(key_hi: Optional[torch.Tensor], key_lo: torch.Tensor) -> torch.Tensor:
    """Fold an (hi, lo) key pair into one int32 hash input; identity for
    single-column keys. A mixed value of INT32_MIN becomes 0, as in the
    reference (INT32_MIN is the Pallas partition kernel's padding)."""
    if key_hi is None:
        return key_lo.to(_I32)
    mixed = _as_i32(_u32(key_lo) ^ _mul32(_u32(key_hi), MIX_MULT))
    return torch.where(mixed == _INT32_MIN, torch.zeros_like(mixed), mixed)


def _pair_comp(key_hi: Optional[torch.Tensor], key_lo: torch.Tensor) -> torch.Tensor:
    """int64 composite preserving the lexicographic order of int32 (hi, lo)
    pairs compared as signed values; non-negative when hi >= 0 (the hash
    join's keys), and below 2^32 for single-column keys. The reference's
    numpy pair key ``(hi << 32) | lo`` assumes non-negative pairs; on those
    the two order alike."""
    lo64 = key_lo.to(_I64) + (1 << 31)
    if key_hi is None:
        return lo64
    return (key_hi.to(_I64) << 32) | lo64


def _pid_shift(n_parts: int) -> int:
    """Bits left for the key below the partition id in a (pid, key) int64."""
    return 63 - max(int(n_parts - 1).bit_length(), 1)


def hash_build_order(pid: torch.Tensor, key_hi: Optional[torch.Tensor],
                     key_lo: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Build-side permutation (int32): rows grouped by partition id, key-
    sorted within each partition. One stable sort of the (pid, key) int64
    composite when it fits (always for single-column keys); oversized pair
    keys take three stable sorts."""
    n = int(key_lo.shape[0])
    if n == 0:
        return torch.zeros(0, dtype=_I32, device=key_lo.device)
    packed = _pair_comp(key_hi, key_lo)
    shift = _pid_shift(n_parts)
    if key_hi is None or int(packed.max()) < (1 << shift):
        comp = (pid.to(_I64) << shift) | packed
        return torch.sort(comp, stable=True).indices.to(_I32)
    return lexsort((key_lo, key_hi, pid)).to(_I32)


# ---------------------------------------------------------------------------
# blocked bloom filter (sideways information passing)
# ---------------------------------------------------------------------------
#
# One uint32 word per block; each key sets two bits of one word, from two
# multiplicative hashes of the raw int32 code (NULL_ID hashes like any other
# value). Words travel as int32 tensors holding the uint32 bit pattern.


def bloom_n_words(n_keys: int) -> int:
    """Power-of-two word count targeting ~16 bits per key, capped at 2^20."""
    n = 1
    while n * 2 < max(n_keys, 1) and n < (1 << 20):
        n *= 2
    return n


def bloom_hash(keys: torch.Tensor, n_words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(word index int64, bit pattern as int64 in [0, 2^32)) per key, bit
    for bit the reference's ``vecops.bloom_hash``."""
    u = _u32(keys)
    h1 = _mul32(u, HASH_MULT)
    h2 = _mul32(u, MIX_MULT)
    word = (h1 >> 18) & (n_words - 1)
    one = torch.ones_like(h1)
    bits = (one << (h1 & 31)) | (one << ((h2 >> 13) & 31))
    return word, bits


# ---------------------------------------------------------------------------
# sorted (hi, lo) pair sets (property-path BFS rounds, DESIGN.md §8)
# ---------------------------------------------------------------------------


def merge_sorted_pairs(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
                       b_lo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two lexicographically sorted, mutually disjoint pair sets into
    one sorted pair set (the visited-set growth step): each element is
    scattered to its own index plus the number of the other set's elements
    below it. The result never aliases ``b``, whose callers pass views of
    recycled buffers."""
    na, nb = int(a_hi.shape[0]), int(b_hi.shape[0])
    if nb == 0:
        return a_hi, a_lo
    if na == 0:
        return b_hi.clone(), b_lo.clone()
    ka, kb = _pair_comp(a_hi, a_lo), _pair_comp(b_hi, b_lo)
    dev = a_hi.device
    pa = torch.arange(na, device=dev) + torch.searchsorted(kb, ka)
    pb = torch.arange(nb, device=dev) + torch.searchsorted(ka, kb)
    out_hi = torch.empty(na + nb, dtype=_I32, device=dev)
    out_lo = torch.empty(na + nb, dtype=_I32, device=dev)
    out_hi[pa] = a_hi
    out_hi[pb] = b_hi
    out_lo[pa] = a_lo
    out_lo[pb] = b_lo
    return out_hi, out_lo
