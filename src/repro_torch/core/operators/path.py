"""PathExpand: the batch property-path operator (DESIGN.md §8) on the device.

Evaluates one path pattern through the frontier engine
(``core/paths/engine.py``) and streams the materialized pair relation out
as pooled, subject-sorted column batches — a pipeline breaker like Sort
(the closure must complete before sorted emission).

Seed-side choice, as in the reference: a bound subject seeds forward BFS
from that single node; a bound object seeds BFS over the flipped relation
(bound-object expansion) and swaps the pairs back; with both endpoints
bound the pattern is an existence check (one row or none); ``?x path ?x``
keeps the cyclic pairs only; with both endpoints free the engine
enumerates every source. The frontier counters (rounds, peak frontier,
dedup in/out) land in ``stats.extra`` when the closure is evaluated, under
the reference's names, with the pairs as ``stats.rows_scanned``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.algebra import K, Slot, V
from repro_torch.core.batch import BatchPool, ColumnBatch
from repro_torch.core.operators.base import BatchOperator
from repro_torch.core.paths.engine import PathEngine, PathResult
from repro_torch.core.paths.expr import PathExpr, path_repr
from repro_torch.core.sip import SipFilter, apply_sip, sip_seen
from repro_torch.core.storage import QuadStore


class PathExpand(BatchOperator):
    def __init__(
        self,
        store: QuadStore,
        expr: PathExpr,
        s_slot: Slot,
        o_slot: Slot,
        batch_size: int = 4096,
        pool: Optional[BatchPool] = None,
        sip_filters: Sequence[SipFilter] = (),
    ) -> None:
        self.store = store
        self.device = store.device
        self.expr = expr
        self.s_slot, self.o_slot = s_slot, o_slot
        # SIP prefilters, mask mode only: the closure is materialized
        # wholesale by the frontier engine, so range seeks buy nothing here,
        # but masking emitted pairs still prunes the join's probe stream
        self.sip_filters = list(sip_filters)
        self.batch_size = batch_size
        self.pool = pool
        self.engine = PathEngine(store, pool)
        self._result: Optional[PathResult] = None
        self._offset = 0

        self._var_ids: Tuple[int, ...]
        self._sorted_var: Optional[int]
        self.seed_side = "subject"
        if isinstance(s_slot, V) and isinstance(o_slot, V):
            self._var_ids = (s_slot.id,) if s_slot.id == o_slot.id else (s_slot.id, o_slot.id)
            self._sorted_var = s_slot.id
        elif isinstance(o_slot, V):  # bound subject: forward BFS
            self._var_ids, self._sorted_var = (o_slot.id,), o_slot.id
        elif isinstance(s_slot, V):  # bound object: reverse BFS
            self._var_ids, self._sorted_var = (s_slot.id,), s_slot.id
            self.seed_side = "object"
        else:  # both bound: forward from the subject, an existence check
            self._var_ids, self._sorted_var = (), None
        super().__init__("PathExpand", self._describe())

    def _describe(self) -> str:
        def slot(sl: Slot) -> str:
            return f"?v{sl.id}" if isinstance(sl, V) else str(sl.term)

        return (
            f"({slot(self.s_slot)}, {path_repr(self.expr)}, "
            f"{slot(self.o_slot)}) [seed={self.seed_side}]"
        )

    # -- operator API -------------------------------------------------------

    def var_ids(self) -> Tuple[int, ...]:
        return self._var_ids

    def sorted_by(self) -> Optional[int]:
        return self._sorted_var

    def children(self) -> List[BatchOperator]:
        return []

    # -- evaluation ---------------------------------------------------------

    def _seed(self, sl: Slot) -> Optional[torch.Tensor]:
        tid = self.store.dict.lookup(sl.term)
        if tid is None:
            return None  # unknown constant: empty result
        return torch.tensor([tid], dtype=torch.int32, device=self.device)

    def _evaluate(self) -> PathResult:
        none = torch.zeros(0, dtype=torch.int32, device=self.device)
        empty = PathResult(none, none)
        s_bound = isinstance(self.s_slot, K)
        o_bound = isinstance(self.o_slot, K)
        if s_bound:
            seeds = self._seed(self.s_slot)
            if seeds is None:
                return empty
            res = self.engine.evaluate(self.expr, seeds=seeds)
        elif o_bound:
            seeds = self._seed(self.o_slot)
            if seeds is None:
                return empty
            res = self.engine.evaluate(self.expr, seeds=seeds, reverse=True)
        else:
            res = self.engine.evaluate(self.expr)
        if s_bound and o_bound:  # both bound: existence check
            oid = self.store.dict.lookup(self.o_slot.term)
            if oid is None:
                return empty
            keep = res.dst == int(oid)
            res = PathResult(res.src[keep], res.dst[keep])
        if len(self._var_ids) == 1 and not (s_bound or o_bound):
            # ?x path ?x — keep only cyclic pairs
            keep = res.src == res.dst
            res = PathResult(res.src[keep], res.dst[keep])
        self.stats.rows_scanned += len(res)
        self.stats.extra.update(self.engine.counters.as_dict())
        self.stats.extra["dedup_ratio"] = round(self.engine.counters.dedup_ratio, 3)
        return res

    def _primary(self) -> torch.Tensor:
        """The column the emitted batches are sorted by."""
        assert self._result is not None
        if isinstance(self.s_slot, V):
            return self._result.src
        return self._result.dst

    def _next(self) -> Optional[ColumnBatch]:
        if self._result is None:
            self._result = self._evaluate()
        res = self._result
        if not self._var_ids:  # both endpoints bound: 0/1 row existence
            if self._offset or not len(res):
                return None
            self._offset = 1
            b = ColumnBatch.alloc((), 32, self.device, self.pool)
            b.mask[0] = True
            b.n_rows = 1
            b.dense = True
            return b
        if self._offset >= len(res):
            return None
        n = min(self.batch_size, len(res) - self._offset)
        sl = slice(self._offset, self._offset + n)
        self._offset += n
        if len(self._var_ids) == 2:
            cols = [res.src[sl], res.dst[sl]]
        elif isinstance(self.s_slot, V):
            cols = [res.src[sl]]  # ?x path <o>, or ?x path ?x (src == dst)
        else:
            cols = [res.dst[sl]]
        b = ColumnBatch.from_columns(
            self._var_ids, cols, self.device, self._sorted_var, pool=self.pool
        )
        # every filter's range and bloom test over the batch, one launch
        b = apply_sip(b, [f for f in self.sip_filters if f.var in self._var_ids])
        if self.sip_filters:
            sip_seen(self.stats, self.sip_filters)
        return b

    def can_skip(self, var: Optional[int]) -> bool:
        return var is not None and var == self._sorted_var

    def _skip(self, var: int, target: int) -> None:
        if not self.can_skip(var):
            raise ValueError("skip on unsorted variable")
        if self._result is None:
            self._result = self._evaluate()
        primary = self._primary()
        needle = torch.tensor([target], dtype=primary.dtype, device=self.device)
        pos = int(torch.searchsorted(primary, needle))
        if pos > self._offset:
            self._offset = pos

    def _reset(self) -> None:
        self._offset = 0

    def _close(self) -> None:
        # the pair relation is plain device memory, not pooled: drop it
        self._result = None
