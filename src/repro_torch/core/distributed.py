"""Distributed BARQ: hash-exchange joins and grouping over torch.distributed
(the reference's ``core/distributed.py``, with a process group in place of
its device mesh).

The classic Volcano exchange recipe: hash-partition both relations on the
join key (the ``radix_partition`` kernel), exchange the buckets with
``all_to_all_single``, then join locally on every rank (the
``sorted_search`` kernel finds each key's run, ``join_expand`` expands the
materialising join). Keys are co-located after the exchange, so local
results make up the global one; counts reduce with one ``all_reduce``.

Every rank calls the function ``make_*`` returns on its own shard, a
(C, n_local) int32 relation with the key in row 0, and gets the reference's
outputs. Shapes are static: a rank sends each peer at most
``cap = ceil(n_local * cap_factor / P)`` rows; rows past that are counted
in the overflow counter (monitoring surfaces it; production would re-run
with more slack) and not sent. Padding rows (``shard_relation`` fills with
INT32_MAX) are hashed and routed like any row, as in the reference, so the
overflow counts agree with it. Nothing here reads a device value on the
host: the outputs are tensors.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.core.partition import next_pow2
from repro_torch.kernels.join_expand import join_expand
from repro_torch.kernels.radix_partition import radix_partition
from repro_torch.kernels.sorted_search import sorted_search_range

SENTINEL = 2**31 - 1  # INT32_MAX: padding keys sort last
_I32, _I64 = torch.int32, torch.int64


def engine_group(device=None, init_method: Optional[str] = None):
    """The process group the exchange runs over: the current default group
    if one exists, else a new one. ``device=None`` is the CUDA card (raises
    where there is none) and takes NCCL; ``device="cpu"`` takes gloo. A new
    group reads its rank and world size from ``RANK`` / ``WORLD_SIZE`` (a
    launcher's environment; ``init_method`` defaults to ``env://`` then),
    else it is one rank, over ``init_method`` or an in-process store."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"engine_group: the default group runs {dist.get_backend()}, "
                               f"not {backend} for {dev}")
        return dist.group.WORLD
    if "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    else:
        rank, world = 0, 1
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index)))
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return dist.group.WORLD


def group_device(group) -> torch.device:
    """Where a rank of ``group`` keeps its tensors: its card under NCCL,
    else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def bucket_cap(n_local: int, cap_factor: float, n_parts: int) -> int:
    """Rows a rank sends each peer at most."""
    return int(math.ceil(n_local * cap_factor / n_parts))


# ---------------------------------------------------------------------------
# exchange
# ---------------------------------------------------------------------------


def _bucket(rows: torch.Tensor, keys: torch.Tensor, n_parts: int, cap: int):
    """A rank's step before the exchange: ``(buf_rows (C, n_parts, cap),
    buf_keys (n_parts, cap), overflow)``. Row i goes to bucket
    ``hash(keys[i]) & (n_parts - 1)`` at any ``n_parts``, as in the
    reference (with 3 ranks nothing goes to rank 1), at its position among
    that bucket's rows in input order; the rows at positions ``>= cap`` are
    counted in ``overflow`` (a 0-d int64 tensor) and not written. Empty
    slots hold INT32_MAX.

    The ``radix_partition`` kernel takes a power of two: it runs at ``p2``,
    the next one up, and ``h & (p2 - 1) & (n_parts - 1) == h & (n_parts -
    1)`` turns its ids into the buckets; their histogram sums the kernel's
    over the ids that fold together (no host read)."""
    n = int(keys.shape[0])
    p2 = next_pow2(n_parts)
    pid, hist2 = radix_partition(keys.contiguous(), p2)
    if p2 == n_parts:
        hist = hist2.to(_I64)
    else:
        fold = torch.arange(p2, dtype=_I64, device=keys.device) & (n_parts - 1)
        hist = torch.zeros(n_parts, dtype=_I64, device=keys.device).index_add_(
            0, fold, hist2.to(_I64))
        pid = pid & (n_parts - 1)
    starts = torch.cumsum(hist, 0) - hist
    order = torch.sort(pid, stable=True).indices
    pid_s = pid[order].to(_I64)
    within = torch.arange(n, dtype=_I64, device=keys.device) - starts[pid_s]
    ok = within < cap
    overflow = (~ok).sum()
    # rows that do not fit go to one slot past the buffers, dropped after
    dump = n_parts * cap
    dest = torch.where(ok, pid_s * cap + within, dump)
    c = int(rows.shape[0])
    buf_rows = torch.full((c, dump + 1), SENTINEL, dtype=_I32, device=keys.device)
    buf_rows[:, dest] = rows[:, order]
    buf_keys = torch.full((dump + 1,), SENTINEL, dtype=_I32, device=keys.device)
    buf_keys[dest] = keys[order]
    return (buf_rows[:, :dump].reshape(c, n_parts, cap),
            buf_keys[:dump].reshape(n_parts, cap), overflow)


def _exchange(rows: torch.Tensor, keys: torch.Tensor, n_parts: int, cap: int, group):
    """Route rows to the rank owning hash(key). Returns the received
    ``(C, n_parts * cap)`` rows and ``(n_parts * cap,)`` keys (padded with
    INT32_MAX; block s came from rank s) and this rank's overflow."""
    buf_rows, buf_keys, overflow = _bucket(rows, keys, n_parts, cap)
    c = int(rows.shape[0])
    recv_keys = torch.empty_like(buf_keys)
    dist.all_to_all_single(recv_keys, buf_keys, group=group)
    # all_to_all_single splits dim 0: put the destination first
    send_rows = buf_rows.transpose(0, 1).contiguous()
    recv_rows = torch.empty_like(send_rows)
    dist.all_to_all_single(recv_rows, send_rows, group=group)
    return (recv_rows.transpose(0, 1).reshape(c, n_parts * cap),
            recv_keys.reshape(-1), overflow)


def _local_sorted(keys: torch.Tensor, rows: torch.Tensor):
    order = torch.sort(keys, stable=True).indices  # padding sorts last
    return keys[order], rows[:, order]


def _psum(group, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each 0-d tensor summed over the group, in one all_reduce (int64)."""
    out = torch.stack([v.to(_I64) for v in values])
    dist.all_reduce(out, group=group)
    return tuple(out.unbind())


# ---------------------------------------------------------------------------
# distributed join (count and materialising forms) and grouping
# ---------------------------------------------------------------------------


def _join_count_local(lkeys: torch.Tensor, rkeys: torch.Tensor) -> torch.Tensor:
    """Matches of the sorted local shards (padding excluded), int64."""
    lo, hi = sorted_search_range(rkeys, lkeys)
    return torch.where(lkeys != SENTINEL, hi - lo, 0).sum(dtype=_I64)


def _exchange_both(lrows, rrows, n_parts, cap_factor, group):
    lcap = bucket_cap(int(lrows.shape[1]), cap_factor, n_parts)
    rcap = bucket_cap(int(rrows.shape[1]), cap_factor, n_parts)
    lrows2, lkeys2, lof = _exchange(lrows, lrows[0], n_parts, lcap, group)
    rrows2, rkeys2, rof = _exchange(rrows, rrows[0], n_parts, rcap, group)
    return lrows2, lkeys2, rrows2, rkeys2, lof + rof


def make_join_count(group, cap_factor: float = 2.0) -> Callable:
    """``f(left_rows, right_rows) -> (count, overflow)``, 0-d int64 tensors
    equal on every rank. Each rank passes its (C, n_local) int32 shards."""
    n_parts = dist.get_world_size(group)

    def local(lrows: torch.Tensor, rrows: torch.Tensor):
        _, lkeys, _, rkeys, of = _exchange_both(lrows, rrows, n_parts, cap_factor, group)
        count = _join_count_local(torch.sort(lkeys).values, torch.sort(rkeys).values)
        return _psum(group, count, of)

    return local


def make_join_materialize(group, out_cap_per_device: int, cap_factor: float = 2.0) -> Callable:
    """The materialising join: ``f(left_rows, right_rows) -> (keys, li, ri,
    n, overflow)``. ``keys``, ``li`` and ``ri`` are this rank's
    ``out_cap_per_device`` slots (the joined key and the left / right row in
    the rank's sorted received relations; INT32_MAX and -1 past its
    matches); ``n`` (the matches kept, summed) and ``overflow`` (exchange
    overflow and matches past a rank's slots, summed) are 0-d int64 tensors
    equal on every rank."""
    n_parts = dist.get_world_size(group)
    out_cap = out_cap_per_device

    def local(lrows: torch.Tensor, rrows: torch.Tensor):
        lrows2, lkeys2, rrows2, rkeys2, of = _exchange_both(lrows, rrows, n_parts,
                                                            cap_factor, group)
        lkeys, _ = _local_sorted(lkeys2, lrows2)
        rkeys, _ = _local_sorted(rkeys2, rrows2)
        lo, hi = sorted_search_range(rkeys, lkeys)
        counts = torch.where(lkeys != SENTINEL, hi - lo, 0)
        cum = torch.cat([counts.new_zeros(1, dtype=_I64), torch.cumsum(counts, 0, dtype=_I64)])
        total = cum[-1]
        # slot t of the rank's output: the left row g holding it and
        # ri = lo[g] + (t - cum[g]): join_expand over one-row left groups
        g = int(lkeys.shape[0])
        li, ri = join_expand(torch.arange(g, dtype=_I32, device=lkeys.device),
                             torch.ones(g, dtype=_I32, device=lkeys.device), lo, counts,
                             cum, 0, out_cap)
        out_keys = torch.where(li >= 0, lkeys[li.clamp(min=0)], SENTINEL)
        n, of = _psum(group, torch.clamp(total, max=out_cap),
                      of + torch.clamp(total - out_cap, min=0))
        return out_keys, li, ri, n, of

    return local


def make_group_count(group, cap_factor: float = 2.0,
                     max_groups_per_dev: int = 1 << 16) -> Callable:
    """Distributed GROUP BY key COUNT(*): ``f(rows) -> (keys, counts,
    overflow)``. After the exchange a key's rows are on one rank, so its
    local run is the whole group. ``keys`` (int32, INT32_MAX past the
    rank's groups) and ``counts`` (int64) are the rank's first
    ``max_groups_per_dev`` groups in key order (further groups are dropped,
    as in the reference); ``overflow`` is summed over the group."""
    n_parts = dist.get_world_size(group)
    m = max_groups_per_dev

    def local(rows: torch.Tensor):
        cap = bucket_cap(int(rows.shape[1]), cap_factor, n_parts)
        _, keys2, of = _exchange(rows[:1], rows[0], n_parts, cap, group)
        keys = torch.sort(keys2).values
        valid = keys != SENTINEL
        is_start = valid.clone()
        is_start[1:] &= keys[1:] != keys[:-1]
        gid = torch.cumsum(is_start, 0) - 1
        # group g < m lands in slot g, everything else in slot m (dropped)
        slot = torch.where(valid & (gid < m), gid, m)
        counts = torch.zeros(m + 1, dtype=_I64, device=keys.device)
        counts.scatter_add_(0, slot, valid.to(_I64))
        gkeys = torch.full((m + 1,), SENTINEL, dtype=_I32, device=keys.device)
        gkeys.scatter_(0, torch.where(is_start, slot, m), keys)
        (of,) = _psum(group, of)
        return gkeys[:m], counts[:m], of

    return local


# ---------------------------------------------------------------------------
# host-side convenience for tests and examples
# ---------------------------------------------------------------------------


def shard_relation(rows, group) -> torch.Tensor:
    """This rank's block of a (C, N) relation (a numpy array or a tensor),
    padded with INT32_MAX to a multiple of the group's size, on the rank's
    device: rank r of P holds columns [r * N_pad / P, (r + 1) * N_pad / P)."""
    n_dev, r = dist.get_world_size(group), dist.get_rank(group)
    if not torch.is_tensor(rows):
        rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32))
    c, n = rows.shape
    per = -(-max(n, 1) // n_dev)
    block = rows[:, r * per: min((r + 1) * per, n)]
    out = torch.full((c, per), SENTINEL, dtype=_I32, device=group_device(group))
    out[:, : block.shape[1]] = block
    return out
