"""Sort (ORDER BY / join-input re-sort) and materialized sources.

Sort is the pipeline breaker: it materializes its whole input on the
device, sorts it columnar, and re-emits batches. Two key orders:

  * code order  — for join inputs (dictionary codes are what merge joins
    compare; paper §2.2.1);
  * value order — for ORDER BY semantics, via the numeric side-array
    (NaN/non-numeric terms order after numerics, by code).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.algebra import SortKey
from repro_torch.core.batch import MAX_BATCH, BatchPool, ColumnBatch
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.exprs.vm import numeric_of
from repro_torch.core.operators.base import BatchOperator
from repro_torch.core.vecops import lexsort


class MaterializedSource(BatchOperator):
    """Emit a fully-materialized (n_vars, n) device column block as
    batches. Supports skip() when sorted, so a sorted block feeds straight
    back into merge joins."""

    def __init__(
        self,
        var_ids: Sequence[int],
        cols: torch.Tensor,
        sorted_var: Optional[int] = None,
        batch_size: int = MAX_BATCH,
        name: str = "Materialized",
        pool: Optional[BatchPool] = None,
    ):
        self._vars = tuple(int(v) for v in var_ids)
        self.cols = cols
        self._sorted_var = sorted_var
        self.batch_size = batch_size
        self.pool = pool
        self.offset = 0
        super().__init__(name, f"{cols.shape[1]} rows")

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def sorted_by(self) -> Optional[int]:
        return self._sorted_var

    def _next(self) -> Optional[ColumnBatch]:
        n = int(self.cols.shape[1])
        if self.offset >= n:
            return None
        hi = min(self.offset + self.batch_size, n)
        block = self.cols[:, self.offset: hi]
        self.offset = hi
        return ColumnBatch.from_columns(
            self._vars,
            [block[i] for i in range(block.shape[0])],
            self.cols.device,
            self._sorted_var,
            pool=self.pool,
        )

    def _skip(self, var: int, target: int) -> None:
        if var != self._sorted_var:
            raise ValueError("skip on unsorted var")
        key_col = self.cols[self._vars.index(var), self.offset:]
        needle = torch.tensor([target], dtype=key_col.dtype, device=key_col.device)
        self.offset += int(torch.searchsorted(key_col.contiguous(), needle))

    def _reset(self) -> None:
        self.offset = 0


def materialize(child: BatchOperator,
                device: torch.device) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """Drain a child into one (n_vars, n) compacted device block,
    recycling the consumed batches (pipeline-breaker boundary)."""
    vars_ = tuple(child.var_ids())
    blocks = []
    while True:
        b = child.next_batch()
        if b is None:
            break
        cb = b.compact()
        if cb.n_rows:
            order = [cb.col_index(v) for v in vars_]
            blocks.append(cb.columns[order, : cb.n_rows])  # row gather copies
        cb.release()
    if blocks:
        return vars_, torch.cat(blocks, dim=1)
    return vars_, torch.zeros((len(vars_), 0), dtype=torch.int32, device=device)


class SortByVarOp(BatchOperator):
    """Re-sort by one variable's *code* so a merge join can consume the
    stream (the Sort(?person2) in the paper's Listing 1)."""

    def __init__(
        self,
        child: BatchOperator,
        var: int,
        device: torch.device,
        batch_size: int = MAX_BATCH,
        pool: Optional[BatchPool] = None,
    ):
        self.child = child
        self.var = var
        self.device = device
        self.batch_size = batch_size
        self.pool = pool
        self._src: Optional[MaterializedSource] = None
        super().__init__("Sort", f"(?v{var})")

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.var

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _ensure(self) -> MaterializedSource:
        if self._src is None:
            vars_, cols = materialize(self.child, self.device)
            key = cols[vars_.index(self.var)]
            order = torch.sort(key, stable=True).indices
            self._src = MaterializedSource(
                vars_, cols[:, order], self.var, self.batch_size,
                name="SortBuffer", pool=self.pool,
            )
        return self._src

    def _next(self) -> Optional[ColumnBatch]:
        return self._ensure().next_batch()

    def sip_keys(self, var: int) -> torch.Tensor:
        """Key column for a SipFilter export: the sort is a pipeline
        breaker anyway, so forcing its materialization from a probe-side
        scan only moves the same work earlier."""
        src = self._ensure()
        return src.cols[src.var_ids().index(var)]

    def _skip(self, var: int, target: int) -> None:
        self._ensure().skip(var, target)

    def _reset(self) -> None:
        self.child.reset()
        self._src = None


class OrderByOp(BatchOperator):
    """ORDER BY over term values (numeric side-array)."""

    def __init__(
        self,
        child: BatchOperator,
        keys: Sequence[SortKey],
        dictionary: Dictionary,
        device: torch.device,
        batch_size: int = MAX_BATCH,
        pool: Optional[BatchPool] = None,
    ):
        self.child = child
        self.keys = list(keys)
        self.dictionary = dictionary
        self.device = device
        self.batch_size = batch_size
        self.pool = pool
        self._src: Optional[MaterializedSource] = None
        super().__init__("OrderBy", ",".join(f"?v{k.var}" for k in keys))

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _ensure(self) -> MaterializedSource:
        if self._src is None:
            vars_, cols = materialize(self.child, self.device)
            # lexsort: last key = primary
            sort_cols = []
            for k in reversed(self.keys):
                codes = cols[vars_.index(k.var)]
                vals = numeric_of(self.dictionary, codes)
                nan = torch.isnan(vals)
                # numeric first (by value), then non-numeric by code
                if k.ascending:
                    primary = torch.where(nan, float("inf"), vals)
                    tiebreak = torch.where(nan, codes.to(torch.int64), 0)
                else:
                    primary = torch.where(nan, float("inf"), -vals)
                    tiebreak = torch.where(nan, -codes.to(torch.int64), 0)
                sort_cols.extend([tiebreak, primary])
            if sort_cols and cols.shape[1]:
                cols = cols[:, lexsort(sort_cols)]
            self._src = MaterializedSource(
                vars_, cols, None, self.batch_size,
                name="OrderBuffer", pool=self.pool,
            )
        return self._src

    def _next(self) -> Optional[ColumnBatch]:
        return self._ensure().next_batch()

    def _reset(self) -> None:
        self.child.reset()
        self._src = None
