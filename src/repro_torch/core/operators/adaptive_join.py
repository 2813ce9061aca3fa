"""Mid-plan adaptive join re-strategy, as in the reference's
``operators/adaptive_join.py``.

The planner picks merge or hash from estimated cardinalities. When the
estimate of a merge join's build (right, sorted) input is badly low, the
sort that makes the merge possible can cost more than a hash build of the
same rows. ``AdaptiveMergeJoin`` defers the choice to its first
``next_batch()``: the build input is a pipeline breaker either way (it
feeds a Sort in the static plan), so it is materialised on the device
first, its row count held against the planner's estimate, and only then is
the real join made:

  * the estimate held (or a hash build would not be cheaper): a stable
    device sort of the block by the join key, then the planned
    ``MergeJoin``;
  * the build blew past the estimate (q-error >= QERROR_FLAG) and a hash
    build is cheaper than the sort: ``HashJoin`` with the materialised
    block as its build side; the probe (left) stream is consumed as is.

The planner marks a merge join ``adaptive_ok`` only where no ancestor
depends on its output order, so the switch never breaks a streaming
group-by or merge-join parent. The decision is kept in ``stats.extra``
(``adaptive_switches``, ``adaptive_qerror``) and ``stats.detail``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core.batch import BatchPool, ColumnBatch
from repro_torch.core.operators.base import BatchOperator, close_tree
from repro_torch.core.operators.hash_join import HashJoin
from repro_torch.core.operators.merge_join import MergeJoin
from repro_torch.core.operators.sort import MaterializedSource, materialize
from repro_torch.core.profiler import QERROR_FLAG, q_error

# the planner's cost model (planner._HASH_BUILD_FACTOR): hashing a build
# row costs about 4x streaming it, a sort n*log2(n)
_HASH_BUILD_FACTOR = 4.0


class AdaptiveMergeJoin(BatchOperator):
    """Planned merge join that may re-strategise to hash at run time."""

    def __init__(
        self,
        left: BatchOperator,
        right: BatchOperator,  # the UNSORTED build input (the planned Sort's child)
        join_var: int,
        device: torch.device,
        mode: str = "inner",
        post_filter=None,
        dictionary=None,
        post_program=None,
        pool: Optional[BatchPool] = None,
        spill_dir: Optional[str] = None,
        est_build: float = 0.0,  # the planner's est_rows for the right input
        memory_budget: Optional[int] = None,
    ) -> None:
        if mode not in ("inner", "left_outer", "semi", "anti"):
            raise ValueError(f"unknown join mode {mode!r}")
        self.left = left
        self.right = right
        self.v = join_var
        self.device = device
        self.mode = mode
        self.post_filter = post_filter
        self.dictionary = dictionary
        self.post_program = post_program
        self.pool = pool
        self.spill_dir = spill_dir
        self.est_build = float(est_build)
        self.memory_budget = memory_budget
        self._inner: Optional[BatchOperator] = None

        lv, rv = tuple(left.var_ids()), tuple(right.var_ids())
        if join_var not in lv or join_var not in rv:
            raise ValueError("join var missing from an input")
        self._shared = tuple(x for x in lv if x in rv)
        if mode in ("semi", "anti"):
            self._out_vars: Tuple[int, ...] = lv
        else:
            self._out_vars = lv + tuple(x for x in rv if x not in lv)
        super().__init__("AdaptiveJoin", f"(?v{join_var}) mode={mode}")

    def var_ids(self) -> Tuple[int, ...]:
        return self._out_vars

    def sorted_by(self) -> Optional[int]:
        # no order even when the merge branch wins: the planner lowers here
        # only where no ancestor needs one, and a fixed contract keeps
        # parents from depending on the run-time choice
        return None

    def children(self) -> List[BatchOperator]:
        if self._inner is not None:
            return [self._inner]
        return [self.left, self.right]

    def _decide(self) -> BatchOperator:
        rvars, rcols = materialize(self.right, self.device)
        actual = int(rcols.shape[1])
        q = q_error(self.est_build, float(actual))
        self.stats.extra["adaptive_qerror"] = round(q, 2)
        # only an under-estimate makes the planned sort dearer than
        # budgeted; after an over-estimate the merge stays the right call
        sort_cost = actual * max(math.log2(actual), 1.0) if actual else 0.0
        switch = (
            q >= QERROR_FLAG
            and actual > self.est_build
            and _HASH_BUILD_FACTOR * actual < sort_cost
        )
        self.stats.extra["adaptive_switches"] = int(switch)
        self.stats.detail = f"(?v{self.v}) mode={self.mode} -> {'hash' if switch else 'merge'} q={q:.1f}"
        if switch:
            build = MaterializedSource(rvars, rcols, None, name="AdaptiveBuild", pool=self.pool)
            return HashJoin(
                self.left, build, self._shared, self.device, self.mode,
                post_filter=self.post_filter, dictionary=self.dictionary, pool=self.pool,
                post_program=self.post_program, memory_budget=self.memory_budget,
                spill_dir=self.spill_dir,
            )
        order = torch.sort(rcols[rvars.index(self.v)], stable=True).indices
        src = MaterializedSource(rvars, rcols[:, order], self.v, name="SortBuffer", pool=self.pool)
        return MergeJoin(
            self.left, src, self.v, self.device, self.mode,
            post_filter=self.post_filter, dictionary=self.dictionary, pool=self.pool,
            post_program=self.post_program, spill_dir=self.spill_dir,
        )

    def _next(self) -> Optional[ColumnBatch]:
        if self._inner is None:
            self._inner = self._decide()
        return self._inner.next_batch()

    def _reset(self) -> None:
        if self._inner is not None:
            close_tree(self._inner)
            self._inner = None
        self.left.reset()
        self.right.reset()
        self.stats.extra.clear()
        self.stats.detail = f"(?v{self.v}) mode={self.mode}"
