"""Index scan operator: evaluates one triple pattern over a sorted index.

Produces columnar batches on the store's device, sorted by the first free
role of the chosen index order. Supports ``skip()`` on that role (the
storage seek), drives the adaptive batch sizer from the received
next()/skip() pattern (paper §3.4), and applies the sideways-information-
passing prefilters of downstream joins (``core/sip.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.adaptive import AdaptiveBatchSizer
from repro_torch.core.algebra import K, TriplePattern, V
from repro_torch.core.batch import BatchPool, ColumnBatch
from repro_torch.core.operators.base import BatchOperator
from repro_torch.core.sip import SipFilter, apply_sip, sip_seen
from repro_torch.core.storage import INDEX_ORDERS, QuadStore, ScanRange

_INT32_MAX = (1 << 31) - 1


class IndexScan(BatchOperator):
    def __init__(
        self,
        store: QuadStore,
        pattern: TriplePattern,
        want_sorted_var: Optional[int] = None,
        sizer: Optional[AdaptiveBatchSizer] = None,
        pool: Optional[BatchPool] = None,
        sip_filters: Sequence[SipFilter] = (),
    ) -> None:
        self.store = store
        self.pattern = pattern
        self.pool = pool
        # SIP prefilters: summaries of downstream joins' build sides. On the
        # sorted var they narrow the scan by seeking; on other vars they
        # mask batches. Applied at the first read, when the exporting
        # join's build can run.
        self.sip_filters = list(sip_filters)
        self._sip_pending = bool(self.sip_filters)

        # encode constant slots; a constant not present in the dictionary
        # means the pattern matches nothing
        self._dead = False
        bound: List[Optional[int]] = [None, None, None, None]
        slots = (pattern.s, pattern.p, pattern.o, pattern.g)
        for role, sl in enumerate(slots):
            if isinstance(sl, K):
                tid = store.dict.lookup(sl.term)
                if tid is None:
                    self._dead = True
                    tid = -1
                bound[role] = tid
        self.bound = bound

        # free roles and their variables; repeated vars inside one pattern
        # (e.g. ?x :p ?x) add a residual equality mask
        self.role_of_var: Dict[int, int] = {}
        self.residual_pairs: List[Tuple[int, int]] = []  # (role_a, role_b)
        for role, sl in enumerate(slots):
            if isinstance(sl, V):
                if sl.id in self.role_of_var:
                    self.residual_pairs.append((self.role_of_var[sl.id], role))
                else:
                    self.role_of_var[sl.id] = role

        want_role = self.role_of_var.get(want_sorted_var) if want_sorted_var is not None else None
        self.index = store.choose_index(bound, want_role)
        self.perm = INDEX_ORDERS[self.index]

        self._var_ids = tuple(self.role_of_var)
        self.var_col_pos = {
            v: self.perm.index(self.role_of_var[v]) for v in self._var_ids
        }
        # sortedness: the first free position in the index order
        n_bound = 0
        while n_bound < 4 and bound[self.perm[n_bound]] is not None:
            n_bound += 1
        self._sort_col_pos = n_bound if n_bound < 4 else None
        self._sorted_var: Optional[int] = None
        if self._sort_col_pos is not None:
            role = self.perm[self._sort_col_pos]
            for v, r in self.role_of_var.items():
                if r == role:
                    self._sorted_var = v

        self.range: ScanRange = (
            ScanRange(self.index, 0, 0)
            if self._dead
            else store.range_for_pattern(self.index, bound)
        )
        self.offset = 0
        # end offset within the range: the range's length, or where a SIP
        # code range stops the scan
        self._end = len(self.range)
        self.sizer = sizer or AdaptiveBatchSizer()
        super().__init__("Scan", self._describe())

    def _describe(self) -> str:
        parts = []
        slots = (self.pattern.s, self.pattern.p, self.pattern.o)
        for sl in slots:
            parts.append(f"?v{sl.id}" if isinstance(sl, V) else str(sl.term))
        return f"({', '.join(parts)}) [{self.index}]"

    # -- operator API -----------------------------------------------------------

    def var_ids(self) -> Tuple[int, ...]:
        return self._var_ids

    def sorted_by(self) -> Optional[int]:
        return self._sorted_var

    def _next(self) -> Optional[ColumnBatch]:
        if self._sip_pending:
            self._apply_sip_ranges()
        while True:
            if self.offset >= self._end:
                return None
            count = min(self.sizer.on_next(), self._end - self.offset)
            rows = self.store.read(self.range, self.offset, count)
            n = int(rows[0].shape[0])
            self.offset += n
            self.stats.rows_scanned += n
            cols = [rows[self.var_col_pos[v]] for v in self._var_ids]
            b = ColumnBatch.from_columns(
                self._var_ids, cols, self.store.device, self._sorted_var, pool=self.pool
            )
            if not self.residual_pairs and not self.sip_filters:
                return b
            for ra, rb in self.residual_pairs:
                pa, pb = self.perm.index(ra), self.perm.index(rb)
                m = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
                m[:n] = rows[pa] == rows[pb]
                b = b.with_mask(m)
            b = self._apply_sip_masks(b)
            if b.n_active or self.offset >= self._end:
                return b
            # fully masked: read the next chunk instead of bouncing an
            # empty batch up the pipeline
            b.release()

    # -- sideways information passing -------------------------------------------

    def _apply_sip_ranges(self) -> None:
        """Code-range narrowing on the sorted var, once, before the first
        read: seek to the build side's min key, and end the scan at the
        first row past its max (one more seek, instead of testing each
        batch's keys)."""
        self._sip_pending = False
        for f in self.sip_filters:
            if not self.can_skip(f.var):
                continue  # unsorted var: mask mode only
            rng = f.code_range()
            if rng is None:
                continue
            lo, hi = rng
            if hi < lo:  # provably empty build side: nothing can match
                self.offset = self._end
                return
            self.offset = self.store.seek(self.range, self.offset, self._sort_col_pos, lo)
            self.stats.extra["sip_range_seeks"] = self.stats.extra.get("sip_range_seeks", 0) + 1
            if hi < _INT32_MAX:
                end = self.store.seek(self.range, self.offset, self._sort_col_pos, hi + 1)
                self._end = min(self._end, end)

    def _apply_sip_masks(self, b: ColumnBatch) -> ColumnBatch:
        """Every filter's range and bloom test over the batch, one launch;
        the filters' counters as they stand after it."""
        b = apply_sip(b, self.sip_filters)
        if self.sip_filters:
            sip_seen(self.stats, self.sip_filters)
        return b

    def can_skip(self, var: Optional[int]) -> bool:
        return (
            var is not None
            and var == self._sorted_var
            and self._sort_col_pos is not None
        )

    def sip_code_range(self) -> Tuple[int, int]:
        """Inclusive (lo, hi) of the sort column over the whole range, read
        off the sorted index: the range-only SipFilter payload that a
        merely sorted merge-join build side exports. (0, -1) when the scan
        is empty."""
        n = len(self.range)
        if n == 0 or self._sort_col_pos is None:
            return 0, -1
        col = self.store.index_columns(self.range.index)[self._sort_col_pos]
        first, last = col[[self.range.lo, self.range.hi - 1]].tolist()
        return int(first), int(last)

    def _skip(self, var: int, target: int) -> None:
        if not self.can_skip(var):
            raise ValueError("skip on unsorted variable")
        self.sizer.on_skip()
        self.offset = self.store.seek(
            self.range, self.offset, self._sort_col_pos, target
        )

    def _reset(self) -> None:
        self.offset = 0
        self._end = len(self.range)
        self._sip_pending = bool(self.sip_filters)
        self.sizer.on_reset()
