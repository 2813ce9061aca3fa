"""Batch↔row adapters (paper §4.2 Interoperability).

BatchToRow lets per-row (legacy) operators consume batch output: each
batch's filled prefix and mask come to the host in one copy
(``host_rows``), its device buffers go straight back to the pool, and the
active rows are handed out one by one. RowToBatch lets batch operators
consume row output, typically at a pipeline-breaking point: it gathers up
to ``batch_size`` rows into a host buffer (pinned when the batch lives on
the card) and uploads it into a pooled batch without waiting for the copy.
Both preserve sort order and forward skip().
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, bucket_for
from repro_torch.core.legacy.operators import Row, RowOperator
from repro_torch.core.operators.base import BatchOperator


def host_rows(b: ColumnBatch) -> np.ndarray:
    """The active rows of ``b`` on the host, as an (n_vars, n_active) int32
    array in row order: the filled prefix and its mask cross in one
    device-to-host copy, and the selection runs on the host."""
    n = b.n_rows
    both = torch.cat([b.columns[:, :n], b.mask[None, :n].to(torch.int32)]).cpu().numpy()
    return both[:-1, both[-1] != 0]


class BatchToRow(RowOperator):
    def __init__(self, child: BatchOperator):
        self.child = child
        self._vars: Tuple[int, ...] = ()
        self._host: Optional[np.ndarray] = None  # the current batch's rows, (n_vars, n)
        self._rows: List[list] = []
        self._i = 0
        super().__init__("BatchToRow")
        self.stats.extra["host_copies"] = 0  # batches copied to the host, one copy each

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.child.sorted_by()

    def children(self):
        return [self.child]

    def _pull(self) -> bool:
        """Copy the child's next batch to the host; False when exhausted."""
        b = self.child.next_batch()
        self._i = 0
        if b is None:
            self._host, self._rows = None, []
            return False
        self._vars = b.var_ids
        self._host = host_rows(b)
        b.release()  # the rows live on the host now
        self._rows = self._host.T.tolist()
        self.stats.extra["host_copies"] += 1
        return True

    def _next(self) -> Optional[Row]:
        while self._i >= len(self._rows):
            if not self._pull():
                return None
        r = self._rows[self._i]
        self._i += 1
        return {v: c for v, c in zip(self._vars, r) if c != NULL_ID}

    def _skip(self, var: int, target: int) -> None:
        # drop buffered rows below target, then skip the child
        if self._i < len(self._rows):
            col = self._host[self._vars.index(var), self._i:]
            self._i += int(np.searchsorted(col, np.int32(target), side="left"))
        self.child.skip(var, target)

    def _reset(self) -> None:
        self.child.reset()
        self._close()

    def _close(self) -> None:
        # no device buffer is held between calls: only the host rows go
        self._host, self._rows, self._i = None, [], 0


class RowToBatch(BatchOperator):
    def __init__(
        self,
        child: RowOperator,
        device: torch.device,
        batch_size: int = 1024,
        pool: Optional[BatchPool] = None,
    ):
        self.child = child
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.pool = pool
        super().__init__("RowToBatch")
        self.stats.extra["uploads"] = 0  # batches uploaded from the host, one copy each

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.child.sorted_by()

    def children(self) -> List[BatchOperator]:
        return [self.child]  # type: ignore[list-item]

    def _next(self) -> Optional[ColumnBatch]:
        vars_ = tuple(self.child.var_ids())
        rows = []
        while len(rows) < self.batch_size:
            r = self.child.next_row()
            if r is None:
                break
            rows.append([r.get(v, NULL_ID) for v in vars_])
        n = len(rows)
        if n == 0:
            return None
        cap = bucket_for(self.batch_size)
        # a pinned staging buffer lets the upload run without a host wait;
        # the host allocator keeps it alive until the copy has run
        host = torch.empty((len(vars_), cap), dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        h = host.numpy()
        h[:, :n] = np.asarray(rows, dtype=np.int32).reshape(n, len(vars_)).T
        h[:, n:] = NULL_ID
        b = ColumnBatch.alloc(vars_, cap, self.device, self.pool, self.child.sorted_by())
        b.columns.copy_(host, non_blocking=True)
        b.mask[:n] = True
        b.n_rows = n
        b.dense = True
        self.stats.extra["uploads"] += 1
        return b

    def _skip(self, var: int, target: int) -> None:
        self.child.skip(var, target)

    def _reset(self) -> None:
        self.child.reset()
