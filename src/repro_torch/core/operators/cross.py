"""Cartesian product for disconnected plan fragments (rare; the planner
only emits it when no join variable exists). Reuses the Build-phase
expansion machinery with a single group spanning both sides.

Both sides are materialized on the device, so their row counts ``nl`` and
``nr`` are host ints, and every window of the product is known on the host:
emission (``join_expand`` over the one group, then ``gather_emit``) makes
no host sync per batch. ``cum`` is int64 and the window's base a host int,
so a product beyond 2^31 rows is fine.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, bucket_for
from repro_torch.core.operators.base import BatchOperator
from repro_torch.core.operators.sort import materialize
from repro_torch.kernels.gather_emit import EmitPlan, gather_emit
from repro_torch.kernels.join_expand import join_expand


class CrossJoin(BatchOperator):
    def __init__(
        self,
        left: BatchOperator,
        right: BatchOperator,
        device: torch.device,
        pool: Optional[BatchPool] = None,
    ):
        self.left = left
        self.right = right
        self.device = device
        self.pool = pool
        lv, rv = tuple(left.var_ids()), tuple(right.var_ids())
        self._right_out = tuple(v for v in rv if v not in lv)
        self._vars = lv + self._right_out
        # emit every left row, then the right-only ones
        self._plan = EmitPlan(range(len(lv)), [rv.index(v) for v in self._right_out])
        self._lcols: Optional[torch.Tensor] = None
        self._rcols: Optional[torch.Tensor] = None
        self._emitted = 0
        super().__init__("Cross")

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def children(self) -> List[BatchOperator]:
        return [self.left, self.right]

    def _ensure(self) -> None:
        if self._lcols is None:
            _, self._lcols = materialize(self.left, self.device)
            _, self._rcols = materialize(self.right, self.device)
            nl, nr = int(self._lcols.shape[1]), int(self._rcols.shape[1])
            self._total = nl * nr
            # join_expand's one group: every left row against every right row
            i32 = dict(dtype=torch.int32, device=self.device)
            zero = torch.zeros(1, **i32)
            self._group = (zero, torch.tensor([nl], **i32), zero, torch.tensor([nr], **i32),
                           torch.tensor([0, self._total], dtype=torch.int64, device=self.device))

    def _next(self) -> Optional[ColumnBatch]:
        self._ensure()
        if self._emitted >= self._total:
            return None
        count = min(bucket_for(4096), self._total - self._emitted)
        li, ri = join_expand(*self._group, self._emitted, count)
        self._emitted += count
        b = ColumnBatch.alloc(self._vars, bucket_for(count), self.device, self.pool)
        _, mask = gather_emit(self._lcols, self._rcols, li, ri, self._plan, out=b.columns)
        b.n_rows = count
        if count < b.capacity:
            b.columns[:, count:] = NULL_ID
        b.mask[:count] = mask
        b.dense = not self._plan.pairs  # no pair to test: every row is active
        if self.pool is not None:
            self.pool.bytes_copied += len(self._vars) * count * 4
        return b

    def _reset(self) -> None:
        self.left.reset()
        self.right.reset()
        self._lcols = None
        self._emitted = 0
