"""Columnar solution batches on the device (paper §3.1).

A batch holds one int32 column per query variable (dictionary-encoded RDF
term IDs) plus a bool validity mask, both torch tensors on one device. The
layout, the capacity buckets and the pool protocol follow the reference
package's ``core/batch.py`` exactly: ``(n_vars, capacity)`` int32 columns,
power-of-two capacities between ``MIN_BATCH`` and ``MAX_BATCH``, and a
``BatchPool`` arena keyed by ``(n_vars, capacity)`` whose buffers move
between single owners (release / MOVE through ``with_mask``).

``n_rows`` (the physically filled prefix) is a host integer; ``n_active``
reads the mask and so waits for the device. ``dense`` marks a batch whose
filled prefix is all active, known on the host without reading the mask:
the operator statistics count such a batch's rows as ``n_rows``.

The pool sanitizer (``repro_torch.analysis.sanitize``) hooks in here as in
the reference: ``_SANITIZER`` stays None until a ``SanitizingBatchPool`` is
built, so each hook below is one ``is None`` test when sanitizing is off,
and batches of plain pools stay untracked when it is on. Its state lives on
the host; no hook reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# NULL marker: OPTIONAL can leave variables unbound inside an aligned batch.
# Valid dictionary IDs are >= 0.
NULL_ID = -1

# Pool-sanitizer hook point: None until the first SanitizingBatchPool is
# built (repro_torch.analysis.sanitize installs its tracker here)
_SANITIZER = None

MIN_BATCH = 32
MAX_BATCH = 4096
BATCH_BUCKETS: Tuple[int, ...] = tuple(
    1 << p for p in range(MIN_BATCH.bit_length() - 1, MAX_BATCH.bit_length())
)


def bucket_for(n: int) -> int:
    """Smallest capacity bucket holding ``n`` rows."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return MAX_BATCH


class BatchPool:
    """Arena of recycled device batch buffers, keyed by (n_vars, capacity).

    Counters mirror the reference pool: ``allocations`` count fresh
    buffers, ``reuses`` recycled ones, ``releases`` buffers handed back,
    ``dropped`` buffers retired over a full stack or by ``drain()``, and
    ``bytes_copied`` is credited by the operators for every byte of column
    data they move. ``stats()`` reports them under the reference's keys
    (the per-query attribution); ``counters()`` is the conservation
    snapshot."""

    def __init__(self, device: torch.device, max_per_bucket: int = 32) -> None:
        self.device = torch.device(device)
        self.max_per_bucket = max_per_bucket
        self._free: Dict[Tuple[int, int], List[Tuple[torch.Tensor, torch.Tensor]]] = {}
        self.allocations = 0
        self.reuses = 0
        self.releases = 0
        self.dropped = 0
        self.bytes_allocated = 0
        self.bytes_copied = 0

    def acquire(self, n_vars: int, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A (columns, mask) buffer pair; contents are UNINITIALIZED."""
        stack = self._free.get((n_vars, capacity))
        if stack:
            self.reuses += 1
            return stack.pop()
        self.allocations += 1
        cols = torch.empty((n_vars, capacity), dtype=torch.int32, device=self.device)
        mask = torch.empty(capacity, dtype=torch.bool, device=self.device)
        self.bytes_allocated += cols.numel() * 4 + mask.numel()
        return cols, mask

    def release(self, cols: torch.Tensor, mask: torch.Tensor) -> None:
        self.releases += 1
        key = (int(cols.shape[0]), int(cols.shape[1]))
        stack = self._free.setdefault(key, [])
        if len(stack) < self.max_per_bucket:
            stack.append((cols, mask))
        else:
            self.dropped += 1

    def drain(self) -> None:
        """Drop every recycled buffer (end-of-query teardown)."""
        self.dropped += sum(len(s) for s in self._free.values())
        self._free.clear()

    def stats(self) -> Dict[str, int]:
        return {
            "allocations": self.allocations,
            "reuses": self.reuses,
            "releases": self.releases,
            "bytes_allocated": self.bytes_allocated,
            "bytes_copied": self.bytes_copied,
        }

    def counters(self) -> Dict[str, int]:
        """Buffer conservation snapshot: every fresh buffer is live (owned
        by a batch), pooled (in a free stack) or retired, so after a query
        fully drains its operators ``allocs == releases + pooled`` and
        ``live == 0``."""
        pooled = sum(len(s) for s in self._free.values())
        return {
            "allocs": self.allocations,
            "releases": self.dropped,
            "pooled": pooled,
            "live": self.allocations - self.dropped - pooled,
            "acquires": self.allocations + self.reuses,
            "recycles": self.releases,
        }


@dataclasses.dataclass
class ColumnBatch:
    """A batch of solutions in columnar layout on one device.

    Attributes:
      var_ids:  tuple of variable ids, one per column.
      columns:  int32 tensor (n_vars, capacity).
      mask:     bool tensor (capacity,) — True for active rows.
      n_rows:   number of physically filled rows (<= capacity); rows in
                [n_rows, capacity) are padding and always masked out.
      sorted_by: var id the active rows are non-decreasing in, or None.
      pool:     owning BatchPool, or None for unpooled buffers. Exactly one
                holder owns the buffers; ``with_mask`` MOVEs ownership.
      dense:    True only where every row of [0, n_rows) is known active
                on the host (set by the writer; any narrowing clears it).
    """

    var_ids: Tuple[int, ...]
    columns: torch.Tensor
    mask: torch.Tensor
    n_rows: int
    sorted_by: Optional[int] = None
    pool: Optional[BatchPool] = None
    dense: bool = False

    # -- constructors -----------------------------------------------------

    @staticmethod
    def from_columns(
        var_ids: Sequence[int],
        cols: Sequence[torch.Tensor],
        device: torch.device,
        sorted_by: Optional[int] = None,
        capacity: Optional[int] = None,
        pool: Optional[BatchPool] = None,
    ) -> "ColumnBatch":
        var_ids = tuple(int(v) for v in var_ids)
        n = int(cols[0].shape[0]) if len(cols) else 0
        cap = capacity or bucket_for(max(n, 1))
        if pool is not None:
            data, mask = pool.acquire(len(var_ids), cap)
            mask[:n] = True
            mask[n:] = False
            if n < cap:
                data[:, n:] = NULL_ID
        else:
            data = torch.full((len(var_ids), cap), NULL_ID, dtype=torch.int32, device=device)
            mask = torch.zeros(cap, dtype=torch.bool, device=device)
            mask[:n] = True
        for i, c in enumerate(cols):
            data[i, :n] = c
        b = ColumnBatch(var_ids, data, mask, n, sorted_by, pool, dense=True)
        if pool is not None and _SANITIZER is not None:
            _SANITIZER.on_create(b)
        return b

    @staticmethod
    def alloc(
        var_ids: Sequence[int],
        capacity: int,
        device: torch.device,
        pool: Optional[BatchPool] = None,
        sorted_by: Optional[int] = None,
    ) -> "ColumnBatch":
        """A writable batch for kernel emit paths: columns content is
        undefined, mask is all-False, n_rows is 0. The writer fills
        columns[:, :n], sets mask[:n] and n_rows, and must NULL-fill
        columns[:, n:] when it stops short of capacity."""
        var_ids = tuple(int(v) for v in var_ids)
        if pool is not None:
            data, mask = pool.acquire(len(var_ids), capacity)
            mask.fill_(False)
        else:
            data = torch.full(
                (len(var_ids), capacity), NULL_ID, dtype=torch.int32, device=device
            )
            mask = torch.zeros(capacity, dtype=torch.bool, device=device)
        b = ColumnBatch(var_ids, data, mask, 0, sorted_by, pool)
        if pool is not None and _SANITIZER is not None:
            _SANITIZER.on_create(b)
        return b

    @staticmethod
    def empty(var_ids: Sequence[int], device: torch.device,
              capacity: int = MIN_BATCH) -> "ColumnBatch":
        var_ids = tuple(int(v) for v in var_ids)
        data = torch.full((len(var_ids), capacity), NULL_ID, dtype=torch.int32, device=device)
        return ColumnBatch(
            var_ids, data, torch.zeros(capacity, dtype=torch.bool, device=device), 0
        )

    # -- pooling ----------------------------------------------------------

    def release(self) -> None:
        """Return the buffers to the owning pool. Idempotent; no-op for
        unpooled batches. The caller must not touch columns/mask after."""
        pool, self.pool = self.pool, None
        if pool is not None:
            if _SANITIZER is not None:
                _SANITIZER.on_release(self)
            if getattr(pool, "_sanitized", False):
                # only [:, :n_rows] ever held exposed data: poisoning just
                # that region keeps the release cost proportional to use
                pool.release(self.columns, self.mask, used=self.n_rows)
            else:
                pool.release(self.columns, self.mask)

    def _guard(self) -> None:
        """Use-after-release tripwire: raises SanitizeError when the
        sanitizer is installed and this batch's buffers were released or
        MOVEd. A host-side check: it reads no device memory."""
        if _SANITIZER is not None and self.__dict__.get("_san_state") is not None:
            _SANITIZER.on_access(self)

    # -- accessors ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.columns.device

    @property
    def capacity(self) -> int:
        return int(self.columns.shape[1])

    @property
    def n_active(self) -> int:
        self._guard()
        return int(self.mask[: self.n_rows].sum()) if self.n_rows else 0

    def col_index(self, var: int) -> int:
        return self.var_ids.index(var)

    def column(self, var: int) -> torch.Tensor:
        """Raw (uncompacted) column including inactive rows."""
        self._guard()
        return self.columns[self.col_index(var), : self.n_rows]

    def selection_vector(self) -> torch.Tensor:
        """The paper's SV: sorted dense indices of active rows (int32)."""
        self._guard()
        return torch.nonzero(self.mask[: self.n_rows]).flatten().to(torch.int32)

    # -- transforms ----------------------------------------------------------

    def compact(self) -> "ColumnBatch":
        """Drop inactive rows. Buffer ownership moves to the compacted batch;
        when rows are dropped the source buffers are recycled."""
        self._guard()
        if self.n_active == self.n_rows:
            self.dense = True
            return self
        sel = self.selection_vector().long()
        cols = [self.columns[i, sel] for i in range(len(self.var_ids))]
        out = ColumnBatch.from_columns(
            self.var_ids, cols, self.device, self.sorted_by, pool=self.pool
        )
        self.release()
        return out

    def project(self, keep: Sequence[int]) -> "ColumnBatch":
        keep = tuple(int(v) for v in keep)
        idx = [self.col_index(v) for v in keep]
        sb = self.sorted_by if self.sorted_by in keep else None
        # the row gather copies, so the projected batch is unpooled and this
        # batch keeps ownership of its buffers
        m = self.mask if self.pool is None else self.mask.clone()
        return ColumnBatch(keep, self.columns[idx], m, self.n_rows, sb, dense=self.dense)

    def with_mask(self, mask: torch.Tensor) -> "ColumnBatch":
        self._guard()
        if self.pool is not None:
            # pooled batches are single-owner: narrow the mask in place and
            # MOVE buffer ownership to the derived batch (zero-copy)
            self.mask.logical_and_(mask)
            self.dense = False
            return self._moved()
        return ColumnBatch(
            self.var_ids, self.columns, self.mask & mask, self.n_rows, self.sorted_by
        )

    def with_sip_mask(self, filters, counts=None) -> "ColumnBatch":
        """``with_mask`` of the SIP filters' keep-mask (``(codes, words or
        None, lo, hi)`` each, and ``counts`` their counter pairs; see
        ``kernels.bloom_filter.sip_mask``), with the same ownership rules,
        computed into the mask by one kernel launch: in place for a pooled
        batch, into a fresh mask for an unpooled one."""
        from repro_torch.kernels.bloom_filter import sip_mask

        self._guard()
        if self.pool is not None:
            sip_mask(self.mask, self.n_rows, filters, counts=counts)
            self.dense = False
            return self._moved()
        fresh = sip_mask(self.mask, self.n_rows, filters, out=torch.empty_like(self.mask),
                         counts=counts)
        return ColumnBatch(self.var_ids, self.columns, fresh, self.n_rows, self.sorted_by)

    def _moved(self) -> "ColumnBatch":
        """A batch over this one's buffers that takes over their ownership
        (the MOVE of ``with_mask``)."""
        pool, self.pool = self.pool, None
        out = ColumnBatch(self.var_ids, self.columns, self.mask, self.n_rows, self.sorted_by, pool)
        if _SANITIZER is not None:
            _SANITIZER.on_move(self, out)
        return out


def concat_batches(
    batches: Sequence[ColumnBatch],
    device: torch.device,
    var_ids: Optional[Sequence[int]] = None,
    pool: Optional[BatchPool] = None,
    release_inputs: bool = False,
) -> ColumnBatch:
    """Concatenate batches, aligning schemas and NULL-filling missing vars.

    Each input batch is gathered straight into the output buffer at its
    offset through the gather_emit kernel (one pass per source), with an
    emit plan built on the host for each source schema."""
    from repro_torch.kernels.gather_emit import EmitPlan, gather_emit

    if not batches:
        return ColumnBatch.empty(tuple(var_ids or ()), device)
    if var_ids is None:
        seen: Dict[int, None] = {}
        for b in batches:
            for v in b.var_ids:
                seen.setdefault(v, None)
        var_ids = tuple(seen)
    var_ids = tuple(int(v) for v in var_ids)
    sels = [b.selection_vector() for b in batches]
    total = sum(int(s.shape[0]) for s in sels)
    cap = bucket_for(max(total, 1))
    if total > cap:
        cap = total
    out = ColumnBatch.alloc(var_ids, cap, device, pool)
    plans: Dict[Tuple[int, ...], EmitPlan] = {}
    pos = 0
    for b, sel in zip(batches, sels):
        n = int(sel.shape[0])
        if n:
            plan = plans.get(b.var_ids)
            if plan is None:
                plan = plans[b.var_ids] = EmitPlan(
                    [b.var_ids.index(v) if v in b.var_ids else -1 for v in var_ids])
            gather_emit(b.columns, None, sel, None, plan, out=out.columns, out_offset=pos)
            if pool is not None:  # NULL-filled missing vars aren't copies
                pool.bytes_copied += sum(1 for r in plan.lsel if r >= 0) * n * 4
            pos += n
        if release_inputs:
            b.release()
    if total < cap:
        out.columns[:, total:] = NULL_ID
    out.mask[:total] = True
    out.n_rows = total
    out.dense = True
    return out

