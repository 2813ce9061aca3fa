"""Vectorized data-plane helpers on device tensors (main-path subset of
the reference's ``core/vecops.py``).

These are the per-batch computations the operators run outside the four
kernels: run detection, group probing, group output offsets, composite
group keys, and the run-end pick around the segmented scan. Each matches
its numpy counterpart in the reference on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.segment_scan import segment_scan

_I32 = torch.int32


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


def pack_group_keys(key_cols: torch.Tensor) -> torch.Tensor:
    """Pack a (k, n) block of int32 group-key columns (NULL_ID == -1
    allowed) into one int64 composite key whose order and equality match
    the lexicographic order of the columns; falls back to a dense rank when
    the range product would overflow 63 bits (reference semantics for
    ``spans=None``)."""
    k, n = key_cols.shape
    if k < 1:
        raise ValueError("pack_group_keys needs at least one column")
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
    n = int(keys.shape[0])
    if n == 0:
        return keys.to(_I32), torch.zeros(0, dtype=torch.float64, device=keys.device)
    if func == "count" or values is None:
        vals = torch.ones(n, dtype=torch.float32, device=keys.device)
    else:
        vals = values.to(torch.float32).contiguous()
    op = "sum" if func == "count" else func
    scan = segment_scan(keys.contiguous(), vals, op)
    run_end = torch.ones(n, dtype=torch.bool, device=keys.device)
    run_end[:-1] = keys[1:] != keys[:-1]
    return keys[run_end].to(_I32), scan[run_end].to(torch.float64)
