"""Translator + executor: physical plan → operator tree → result.

``Engine(store).execute(sparql)`` parses and plans on the host exactly as
the reference package does, lowers the plan to an operator tree, drains
the root, and copies the projected rows to the host once, at the end of
the query. The translator picks, per operator, the batch implementation
(device data) or the row implementation (host rows), inserting batch↔row
adapters at engine boundaries, as the reference does:

  * engine='barq'   — all-batch tree on the store's device;
  * engine='legacy' — all-row tree over the store's host index arrays
    (the paper's tuple-at-a-time baseline);
  * engine='mixed'  — batch scans, joins and filters, row implementations
    for aggregation, sort and distinct, with adapters in between.

The batch engine covers the reference's default configuration (cost-based
join strategy, cost-gated SIP), the forced ``hash`` / ``merge`` and SIP
``on`` / ``off`` settings, memory budgets with ``spill_dir`` and the
adaptive merge join, and cardinality feedback (``"observe"`` records each
operator's actual rows, ``"apply"`` also plans with them): scans with seek
and SIP prefilters, merge (with a
spilling right window), lookup and radix-partitioned hash joins (inner /
left_outer / semi / anti; grace under a budget), cross products, FILTER
and BIND through the expression VM (the interpreted tree walk where the
VM cannot compile the expression), streaming, sort-based and partitioned
GROUP BY with plain and DISTINCT aggregates, DISTINCT (partitioned under a
budget), ORDER BY, LIMIT/OFFSET, UNION, and property paths through the
vectorized frontier engine (``PathExpand``) or, for the row node
``PPathScan``, the row-based transitive path behind an adapter. A
configuration outside it raises ``NotImplementedError`` naming the part of
the port that will bring it; the engine never evaluates a query some other
way.

Under ``EngineConfig.verify_plans`` every plan goes through the reference's
plan verifier (``repro_torch.analysis.plan_verify``); under ``sanitize`` the
engine's buffer arena is a ``SanitizingBatchPool``
(``repro_torch.analysis.sanitize``). ``sip_backend`` accepts only None: the
package runs one kernel per device.

Every query runs under a ``telemetry.QueryTrace`` (``EngineConfig.
telemetry``, on by default): spans for parse, plan, translate and execute,
the ported kernels' dispatches for this query alone, and the operator tree.
After the drain the operators' row counts, part of which the batches leave
on the device, become host integers in one device-to-host copy, issued
before the copy of the result rows so that it adds no host sync of its own
(``pending_counts``; under a row root, the mixed engine's, it is one sync
of its own); the trace, EXPLAIN ANALYZE and the feedback store read host
integers, and the statistics add no host sync to any batch.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import algebra as A
from repro_torch.core import planner as PL
from repro_torch.core import telemetry
from repro_torch.core.adaptive import AdaptiveBatchSizer
from repro_torch.core.batch import NULL_ID, BatchPool, bucket_for
from repro_torch.core.device import resolve_device
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.expressions import eval_expr_values
from repro_torch.core.legacy import operators as LOP
from repro_torch.core.legacy.property_path import RowPathScan, RowTransitivePath
from repro_torch.core.operators.adapters import BatchToRow, RowToBatch
from repro_torch.core.operators.adaptive_join import AdaptiveMergeJoin
from repro_torch.core.operators.aggregate import (
    PartitionedDistinct,
    PartitionedGroupBy,
    SortDistinct,
    SortGroupBy,
    StreamingDistinct,
    StreamingGroupBy,
)
from repro_torch.core.operators.base import (
    BatchOperator,
    close_tree,
    pending_counts,
    settle_counts,
)
from repro_torch.core.operators.cross import CrossJoin
from repro_torch.core.operators.hash_join import HashJoin
from repro_torch.core.operators.lookup_join import LookupJoin
from repro_torch.core.operators.merge_join import MergeJoin
from repro_torch.core.operators.path import PathExpand
from repro_torch.core.operators.scan import IndexScan
from repro_torch.core.operators.simple import (
    ExtendOp,
    FilterOp,
    ProjectOp,
    SliceOp,
    UnionOp,
)
from repro_torch.core.operators.sort import OrderByOp, SortByVarOp
from repro_torch.core.profiler import _pool_delta, profile_tree
from repro_torch.core.stats import GraphStats
from repro_torch.core.sip import SipFilter
from repro_torch.core.storage import QuadStore

# the only values this package implements, and the part of the port that
# brings each other value (None: the reference has no other value)
_SUPPORTED = {
    "engine": (("barq", "legacy", "mixed"), None),
    "join_strategy": ((None, "hash", "merge"), None),
    "sip": ((None, "on", "off"), None),
    "adaptive_join": ((None, "off", "on"), None),
    "cardinality_feedback": (("off", "observe", "apply"), None),
    # one kernel per device: there is no backend to choose
    "sip_backend": ((None,), None),
}


@dataclasses.dataclass
class EngineConfig:
    """Engine settings, with the reference's field names."""

    engine: str = "barq"  # barq | legacy | mixed
    adaptive_batching: bool = True
    initial_batch: int = 64
    max_batch: int = 4096
    allow_child_skip: bool = True
    spill_dir: Optional[str] = None
    # join emission batch size: None = default (256)
    join_initial_batch: Optional[int] = None
    # binary-join strategy: None = cost-based, "hash" / "merge" force one
    join_strategy: Optional[str] = None
    # sideways information passing: None = cost-gated, "on", "off"
    sip: Optional[str] = None
    # the reference's kernel backend for the bloom summaries; this package
    # runs the CUDA kernel on the card and its plain version on the CPU,
    # so only None is accepted
    sip_backend: Optional[str] = None
    # buffer pooling: recycle batch buffers through an Engine-owned arena
    pool_buffers: bool = True
    pool_max_per_bucket: int = 32
    # query telemetry: record a QueryTrace per execution (spans, the
    # query's kernel ledger, the operator lane) and settle the operators'
    # row counts after the drain; False skips both
    telemetry: bool = True
    # cardinality feedback: "off" = no history, "observe" = record each
    # operator's actual rows into the feedback store without touching
    # plans, "apply" = the planner also overrides its estimates with them
    cardinality_feedback: str = "off"
    memory_budget: Optional[int] = None
    adaptive_join: str = "off"
    # correctness tooling: verify_plans runs the PlanVerifier's structural
    # checks on every planned query; sanitize wraps the buffer arena in
    # shadow ownership tracking (poisoned releases, use-after-release,
    # double-release and leak detection). Both default from the
    # environment, as in the reference.
    verify_plans: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("BARQ_VERIFY_PLANS", "") == "1"
    )
    sanitize: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("BARQ_SANITIZE", "") == "1"
    )

    def check(self) -> None:
        """Raise NotImplementedError for a value this package has not
        ported, ValueError for one the reference does not accept either."""
        mb = self.memory_budget
        if mb is not None and (isinstance(mb, bool) or not isinstance(mb, int) or mb < 0):
            raise ValueError(f"EngineConfig.memory_budget={mb!r}: expected None or bytes >= 0")
        if self.spill_dir is not None and not isinstance(self.spill_dir, (str, os.PathLike)):
            raise ValueError(f"EngineConfig.spill_dir={self.spill_dir!r}: expected None or a path")
        for name, (values, later) in _SUPPORTED.items():
            got = getattr(self, name)
            if got not in values:
                allowed = " or ".join(repr(v) for v in values)
                if later is None:
                    raise ValueError(f"EngineConfig.{name}={got!r}: expected {allowed}")
                raise NotImplementedError(
                    f"EngineConfig.{name}={got!r} is not ported yet: it comes "
                    f"with {later} (this package runs {name}={allowed})"
                )


AnyOp = Union[BatchOperator, LOP.RowOperator]


def _make_pool(cfg: EngineConfig, device: torch.device) -> BatchPool:
    """The engine's buffer arena; under ``cfg.sanitize`` a shadow-tracked
    one that poisons releases and attributes leaks."""
    if cfg.sanitize:
        from repro_torch.analysis.sanitize import SanitizingBatchPool

        return SanitizingBatchPool(device, cfg.pool_max_per_bucket)
    return BatchPool(device, cfg.pool_max_per_bucket)


class Translator:
    def __init__(self, store: QuadStore, cfg: EngineConfig, device: torch.device,
                 pool: Optional[BatchPool] = None):
        self.store = store
        self.cfg = cfg
        self.device = device
        self.pool = pool
        # SIP runtime handles, keyed by annotation sid: consuming scans and
        # exporting joins resolve to the same SipFilter. Fresh for each
        # Translator, so a reused plan never sees stale summaries.
        self._sip_registry: Dict[int, SipFilter] = {}

    def _sip_filter(self, ann: PL.PSipFilter) -> SipFilter:
        sf = self._sip_registry.get(ann.sid)
        if sf is None:
            sf = self._sip_registry[ann.sid] = SipFilter(ann.var)
        return sf

    def translate(self, plan: PL.Phys) -> AnyOp:
        if self.cfg.engine == "legacy":
            return self._row(plan)
        return self._build(plan)

    def _sizer(self, initial: Optional[int] = None) -> AdaptiveBatchSizer:
        # clamp the configured size to the capacity buckets
        return AdaptiveBatchSizer(
            initial=min(
                bucket_for(initial or self.cfg.initial_batch),
                bucket_for(self.cfg.max_batch),
            ),
            max_size=self.cfg.max_batch,
            enabled=self.cfg.adaptive_batching,
        )

    def _join_sizer(self) -> AdaptiveBatchSizer:
        return self._sizer(self.cfg.join_initial_batch or 256)

    # -- engine-aware build (barq / mixed) -------------------------------------

    def _build(self, n: PL.Phys) -> AnyOp:
        """Lower one Phys node, stamping the planner's cardinality estimate
        (and its source) and node fingerprint on the produced operator's
        stats (EXPLAIN ANALYZE and feedback input)."""
        return _stamp(self._build_node(n), n)

    def _build_node(self, n: PL.Phys) -> AnyOp:
        """Lower one Phys node (and its subtree): batch operators, and under
        ``engine="mixed"`` row operators for sort, distinct, grouping and
        ORDER BY (and project, slice and HAVING over a row child)."""
        dev, pool, d = self.device, self.pool, self.store.dict
        mixed = self.cfg.engine == "mixed"
        batch = self._batch_child
        if isinstance(n, PL.PScan):
            return IndexScan(
                self.store, n.pattern, n.sort_var, sizer=self._sizer(), pool=pool,
                sip_filters=[self._sip_filter(a) for a in n.sip],
            )
        if isinstance(n, PL.PSort):
            child = self._build(n.child)
            if mixed:
                # row-based sort consuming batch input: an adapter in
                # between, then back to batches at the pipeline break
                return self._to_batch(LOP.RowSort(self._to_row(child), var=n.var))
            return SortByVarOp(self._to_batch(child), n.var, dev, self.cfg.max_batch, pool=pool)
        if isinstance(n, PL.PMergeJoin):
            if (
                self.cfg.adaptive_join == "on"
                and n.adaptive_ok
                and not n.sip_exports
                and isinstance(n.right, PL.PSort)
                and n.right.var == n.var
            ):
                # defer sort-vs-hash until the build input's true size is
                # known: the planned Sort is a pipeline breaker, no
                # ancestor consumes this join's order (adaptive_ok), and no
                # SIP export hangs off the build window
                return AdaptiveMergeJoin(
                    batch(n.left), batch(n.right.child), n.var, dev,
                    mode=n.mode, post_filter=n.post_filter, dictionary=d,
                    post_program=n.post_program, pool=pool, spill_dir=self.cfg.spill_dir,
                    est_build=getattr(n.right, "est_rows", 0.0) or 0.0,
                    memory_budget=self.cfg.memory_budget,
                )
            left, right = batch(n.left), batch(n.right)
            # SIP export: bloom keys off a Sort's materialization, or a code
            # range off a sorted scan; anything else stays pass-through
            for ann in n.sip_exports:
                sf = self._sip_filter(ann)
                if isinstance(right, SortByVarOp):
                    sf.bind(lambda r=right, v=ann.var: ("keys", r.sip_keys(v)))
                elif isinstance(right, IndexScan) and right.sorted_by() == ann.var:
                    sf.bind(lambda r=right: ("range",) + r.sip_code_range())
            return MergeJoin(
                left, right, n.var, dev,
                mode=n.mode, post_filter=n.post_filter, dictionary=d,
                sizer=self._join_sizer(), allow_child_skip=self.cfg.allow_child_skip,
                pool=pool, post_program=n.post_program, spill_dir=self.cfg.spill_dir,
            )
        if isinstance(n, PL.PLookupJoin):
            return LookupJoin(batch(n.probe), batch(n.build), n.var, dev, n.mode, pool=pool)
        if isinstance(n, PL.PHashJoin):
            op = HashJoin(
                batch(n.probe), batch(n.build), n.keys, dev,
                mode=n.mode, post_filter=n.post_filter, dictionary=d,
                sizer=self._join_sizer(), pool=pool, post_program=n.post_program,
                memory_budget=self.cfg.memory_budget, spill_dir=self.cfg.spill_dir,
                grace=True if n.grace else None, grace_parts=n.grace_parts,
            )
            # SIP export: the materialized build layout gives the bloom keys
            for ann in n.sip_exports:
                self._sip_filter(ann).bind(lambda j=op, v=ann.var: ("keys", j.sip_keys(v)))
            return op
        if isinstance(n, PL.PPathExpand):
            # the vectorized frontier engine: paths run on the batch
            # pipeline like every other leaf
            return PathExpand(
                self.store, n.pattern.expr, n.pattern.s, n.pattern.o,
                batch_size=self.cfg.max_batch, pool=pool,
                sip_filters=[self._sip_filter(a) for a in n.sip],
            )
        if isinstance(n, PL.PPathScan):
            # the row node for `+`, bridged by an adapter
            return self._to_batch(self._path_op(n))
        if isinstance(n, PL.PCross):
            return CrossJoin(batch(n.left), batch(n.right), dev, pool=pool)
        if isinstance(n, PL.PFilter):
            return FilterOp(batch(n.child), n.expr, d, program=n.program)
        if isinstance(n, PL.PExtend):
            return ExtendOp(batch(n.child), n.var, n.expr, d, dev, pool=pool, program=n.program)
        if isinstance(n, PL.PProject):
            child = self._build(n.child)
            if isinstance(child, LOP.RowOperator):
                return LOP.RowProject(child, n.vars)
            return ProjectOp(child, n.vars, dev, pool=pool)
        if isinstance(n, PL.PDistinct):
            child = self._build(n.child)
            if mixed:
                return LOP.RowDistinct(self._to_row(child))
            child = self._to_batch(child)
            if n.streaming_var is not None and child.sorted_by() == n.streaming_var:
                return StreamingDistinct(child, n.streaming_var, dev)
            if n.grace:
                return PartitionedDistinct(
                    child, dev, self.cfg.max_batch, pool=pool,
                    memory_budget=self.cfg.memory_budget, spill_dir=self.cfg.spill_dir,
                    n_parts=n.grace_parts or 16,
                )
            return SortDistinct(child, dev, self.cfg.max_batch)
        if isinstance(n, PL.PGroup):
            child = self._build(n.child)
            if mixed:
                return LOP.RowGroupBy(self._to_row(child), n.group_vars, n.aggs, d)
            child = self._to_batch(child)
            if n.streaming and len(n.group_vars) <= 1:
                gv = n.group_vars[0] if n.group_vars else None
                if gv is None or child.sorted_by() == gv:
                    return StreamingGroupBy(
                        child, gv, n.aggs, d, dev, self.cfg.max_batch, pool=pool
                    )
            if n.grace and n.group_vars:
                return PartitionedGroupBy(
                    child, n.group_vars, n.aggs, d, dev, self.cfg.max_batch, pool=pool,
                    memory_budget=self.cfg.memory_budget, spill_dir=self.cfg.spill_dir,
                    n_parts=n.grace_parts or 16,
                )
            return SortGroupBy(
                child, n.group_vars, n.aggs, d, dev, self.cfg.max_batch, pool=pool
            )
        if isinstance(n, PL.PHaving):
            child = self._build(n.child)
            if isinstance(child, LOP.RowOperator):  # mixed: row grouping
                return LOP.RowFilter(child, n.expr, d)
            return FilterOp(child, n.expr, d, program=n.program, name="Having")
        if isinstance(n, PL.POrderBy):
            child = self._build(n.child)
            if mixed:
                return self._to_batch(LOP.RowSort(self._to_row(child), keys=n.keys, dictionary=d))
            return OrderByOp(self._to_batch(child), n.keys, d, dev, self.cfg.max_batch, pool=pool)
        if isinstance(n, PL.PSlice):
            child = self._build(n.child)
            if isinstance(child, LOP.RowOperator):
                return LOP.RowLimit(child, n.limit, n.offset)
            return SliceOp(child, n.limit, n.offset)
        if isinstance(n, PL.PUnion):
            return UnionOp(batch(n.left), batch(n.right), dev, pool=pool)
        raise TypeError(type(n))

    # -- adapters --------------------------------------------------------------

    def _batch_child(self, n: PL.Phys) -> BatchOperator:
        return self._to_batch(self._build(n))

    def _to_batch(self, op: AnyOp) -> BatchOperator:
        if isinstance(op, BatchOperator):
            return op
        return RowToBatch(op, self.device, self.cfg.max_batch, pool=self.pool)

    def _to_row(self, op: AnyOp) -> LOP.RowOperator:
        if isinstance(op, LOP.RowOperator):
            return op
        return BatchToRow(op)

    def _path_op(self, n: PL.PPathScan) -> LOP.RowOperator:
        pat = n.pattern
        if not isinstance(pat.p, A.K):
            raise ValueError(
                "property paths require a constant predicate, got a "
                "variable in the predicate position"
            )
        assert isinstance(pat.s, A.V) and isinstance(pat.o, A.V), (
            "bound-endpoint paths are planned as filters over the closure"
        )
        return RowTransitivePath(self.store, pat.p.term, pat.s.id, pat.o.id)

    # -- all-row build (legacy engine, the paper's baseline) ----------------------

    def _row(self, n: PL.Phys) -> LOP.RowOperator:
        return _stamp(self._row_node(n), n)

    def _row_node(self, n: PL.Phys) -> LOP.RowOperator:
        d, row = self.store.dict, self._row
        if isinstance(n, PL.PScan):
            return LOP.RowScan(self.store, n.pattern, n.sort_var)
        if isinstance(n, PL.PPathExpand):
            return RowPathScan(self.store, n.pattern.expr, n.pattern.s, n.pattern.o)
        if isinstance(n, PL.PPathScan):
            return self._path_op(n)
        if isinstance(n, PL.PSort):
            return LOP.RowSort(row(n.child), var=n.var)
        if isinstance(n, PL.PMergeJoin):
            return LOP.RowMergeJoin(
                row(n.left), row(n.right), n.var, mode=n.mode,
                post_filter=n.post_filter, dictionary=d,
            )
        if isinstance(n, PL.PLookupJoin):
            # legacy uses sort+merge for the same plan shape
            probe = row(n.probe)
            build = LOP.RowSort(row(n.build), var=n.var)
            if probe.sorted_by() != n.var:
                probe = LOP.RowSort(probe, var=n.var)
            return LOP.RowMergeJoin(probe, build, n.var, mode=n.mode)
        if isinstance(n, PL.PHashJoin):
            return LOP.RowHashJoin(
                row(n.probe), row(n.build), n.keys, mode=n.mode,
                post_filter=n.post_filter, dictionary=d,
            )
        if isinstance(n, PL.PCross):
            # block nested loop: the right subtree is rebuilt for each left row
            return _RowCross(row(n.left), lambda rplan=n.right: row(rplan))
        if isinstance(n, PL.PFilter):
            return LOP.RowFilter(row(n.child), n.expr, d)
        if isinstance(n, PL.PExtend):
            return _RowExtend(row(n.child), n.var, n.expr, d)
        if isinstance(n, PL.PProject):
            return LOP.RowProject(row(n.child), n.vars)
        if isinstance(n, PL.PDistinct):
            return LOP.RowDistinct(row(n.child))
        if isinstance(n, PL.PGroup):
            return LOP.RowGroupBy(row(n.child), n.group_vars, n.aggs, d)
        if isinstance(n, PL.PHaving):
            return LOP.RowFilter(row(n.child), n.expr, d)
        if isinstance(n, PL.POrderBy):
            return LOP.RowSort(row(n.child), keys=n.keys, dictionary=d)
        if isinstance(n, PL.PSlice):
            return LOP.RowLimit(row(n.child), n.limit, n.offset)
        if isinstance(n, PL.PUnion):
            return LOP.RowUnion(row(n.left), row(n.right))
        raise TypeError(type(n))


def _stamp(op: AnyOp, n: PL.Phys) -> AnyOp:
    est = getattr(n, "est_rows", 0.0)
    if est and op.stats.est_rows is None:
        op.stats.est_rows = float(est)
        op.stats.est_source = getattr(n, "est_source", "stats")
    if op.stats.node_fp is None:
        op.stats.node_fp = getattr(n, "fp", "") or None
    return op


class _RowCross(LOP.RowOperator):
    def __init__(self, left: LOP.RowOperator, right_factory):
        self.left = left
        self.right_factory = right_factory
        self._lrow: Optional[dict] = None
        self._right: Optional[LOP.RowOperator] = None
        probe = right_factory()
        lv = tuple(left.var_ids())
        self._vars = lv + tuple(v for v in probe.var_ids() if v not in lv)
        super().__init__("Cross", "(row)")

    def var_ids(self):
        return self._vars

    def children(self):
        return [self.left]

    def _next(self):
        while True:
            if self._lrow is None:
                self._lrow = self.left.next_row()
                if self._lrow is None:
                    return None
                self._right = self.right_factory()
            r = self._right.next_row()
            if r is None:
                self._lrow = None
                continue
            out = dict(self._lrow)
            out.update(r)
            return out

    def _reset(self):
        self.left.reset()
        self._lrow = None


class _RowExtend(LOP.RowOperator):
    def __init__(self, child: LOP.RowOperator, var: int, expr, dictionary: Dictionary):
        self.child, self.var, self.expr, self.dictionary = child, var, expr, dictionary
        super().__init__("Bind", "(row)")

    def var_ids(self):
        return self.child.var_ids() + (self.var,)

    def sorted_by(self):
        return self.child.sorted_by()

    def children(self):
        return [self.child]

    def _next(self):
        r = self.child.next_row()
        if r is None:
            return None
        b = LOP.row_to_batch(r, self.child.var_ids())
        vals, ok = eval_expr_values(self.expr, b, self.dictionary)
        out = dict(r)
        if ok[0]:
            v = float(vals[0])
            out[self.var] = self.dictionary.encode(int(v) if v.is_integer() else v)
        return out

    def _reset(self):
        self.child.reset()


class QueryResult:
    def __init__(self, var_table: A.VarTable, proj: Tuple[int, ...], rows: np.ndarray,
                 root: Optional[AnyOp] = None, pool: Optional[BatchPool] = None,
                 pool_base: Optional[Dict[str, int]] = None,
                 trace: Optional[telemetry.QueryTrace] = None):
        self.var_table = var_table
        self.proj = proj
        self.rows = rows  # (n, n_proj) int32 codes, on the host
        self.root = root  # the closed operator tree (its stats stay readable)
        self.pool = pool  # the buffer arena (Engine-shared and warm)
        # pool counters bracketing this execution: profile() and
        # pool_delta() report this query's share, and the end snapshot is
        # frozen here so later queries on the same arena can't leak in
        self.pool_base = pool_base
        self.pool_final: Optional[Dict[str, int]] = (
            dict(pool.stats()) if pool is not None else None
        )
        self.trace = trace  # QueryTrace, or None with telemetry off

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    def decoded(self, dictionary: Dictionary) -> List[dict]:
        names = [self.var_table.name(v) for v in self.proj]
        return [
            {
                nm: (None if c == NULL_ID else dictionary.decode(int(c)))
                for nm, c in zip(names, row)
            }
            for row in self.rows.tolist()
        ]

    def pool_delta(self) -> Dict[str, int]:
        """This query's pool counters (end-of-execution snapshot minus the
        pre-execution one)."""
        if self.pool_final is None:
            return {}
        return _pool_delta(self.pool_final, self.pool_base)

    def profile(self, analyze: bool = False) -> str:
        settle_counts(self.root)  # counts still on the device: one copy
        return profile_tree(self.root, self.var_table, pool=self.pool_final,
                            pool_base=self.pool_base, analyze=analyze)

    def explain_analyze(self) -> str:
        """EXPLAIN ANALYZE report: per-operator actual vs planner-estimated
        rows with MISEST flags at q-error >= profiler.QERROR_FLAG."""
        return self.profile(analyze=True)


class Engine:
    """Public API: ``Engine(store, cfg, device, feedback, stats).execute(sparql_text
    | plan)``.

    ``device=None`` is the CUDA card; it raises where there is none. Pass
    ``device="cpu"`` to run the kernels' plain PyTorch versions. Under
    ``cardinality_feedback`` "observe" or "apply" the engine records into
    ``feedback`` (a caller-shared ``CardinalityFeedback``) or into one of
    its own. ``stats`` is the planner's ``GraphStats`` over ``store``,
    built here when it is None; engines over one store may share one,
    since building it reads every quad on the host."""

    def __init__(self, store: QuadStore, cfg: Optional[EngineConfig] = None,
                 device=None, feedback: Optional[telemetry.CardinalityFeedback] = None,
                 stats: Optional[GraphStats] = None):
        self.device = resolve_device(device)
        self.cfg = cfg or EngineConfig()
        self.cfg.check()
        if store.device != self.device:
            raise ValueError(
                f"the store lies on {store.device}, the engine on {self.device}"
            )
        self.store = store
        if stats is not None and stats.store is not store:
            raise ValueError("stats were built over another store")
        self.stats = stats if stats is not None else GraphStats(store)
        mode = self.cfg.cardinality_feedback
        self.feedback: Optional[telemetry.CardinalityFeedback] = None
        if mode != "off":
            self.feedback = feedback if feedback is not None else telemetry.CardinalityFeedback()
        self.planner = PL.Planner(
            self.stats,
            barq_enabled=self.cfg.engine != "legacy",
            dictionary=store.dict,
            join_strategy=self.cfg.join_strategy,
            sip=self.cfg.sip,
            feedback=self.feedback if mode == "apply" else None,
            memory_budget=self.cfg.memory_budget,
            adaptive_join=self.cfg.adaptive_join,
        )
        # Engine-owned warm arena shared across this engine's queries (the
        # row engine holds no batches); per-query attribution comes from
        # counter snapshots, not resets
        self.pool: Optional[BatchPool] = (
            _make_pool(self.cfg, self.device)
            if self.cfg.pool_buffers and self.cfg.engine != "legacy" else None
        )

    def plan_fingerprint(self) -> str:
        """Identity of every config knob that changes plan shape. Under
        ``cardinality_feedback="apply"`` the feedback store's version is
        folded in too: new observations must invalidate cached plans."""
        base = (
            f"{self.cfg.engine}|{self.cfg.join_strategy}|{self.cfg.sip}"
            f"|mb{self.cfg.memory_budget}|aj{self.cfg.adaptive_join}"
        )
        if self.cfg.cardinality_feedback == "apply" and self.feedback is not None:
            base += f"|fb{self.feedback.version}"
        return base

    def parse(self, text: str) -> Tuple[A.PlanNode, A.VarTable]:
        from repro_torch.core.parser import parse_query

        return parse_query(text)

    def plan(self, node: A.PlanNode) -> PL.Phys:
        phys = self.planner.plan(node)
        if self.cfg.verify_plans:
            # structural invariant checks: raises PlanInvariantError naming
            # the node on a malformed plan
            from repro_torch.analysis.plan_verify import verify_plan

            verify_plan(phys)
        return phys

    def explain(self, node_or_text: Union[str, A.PlanNode],
                var_table: Optional[A.VarTable] = None) -> str:
        """The chosen physical plan (no execution)."""
        if isinstance(node_or_text, str):
            node_or_text, var_table = self.parse(node_or_text)
        return PL.explain(self.plan(node_or_text), var_table)

    def explain_analyze(self, node_or_text: Union[str, A.PlanNode],
                        var_table: Optional[A.VarTable] = None) -> str:
        """Execute and render per-operator estimated vs actual rows with
        misestimate flags."""
        return self.execute(node_or_text, var_table).explain_analyze()

    def execute(self, node_or_text: Union[str, A.PlanNode],
                var_table: Optional[A.VarTable] = None,
                trace: Optional[telemetry.QueryTrace] = None) -> QueryResult:
        if trace is None and self.cfg.telemetry:
            label = (
                " ".join(node_or_text.split())[:120]
                if isinstance(node_or_text, str) else "query"
            )
            trace = telemetry.QueryTrace(label)
        if trace is None:
            if isinstance(node_or_text, str):
                node, var_table = self.parse(node_or_text)
            else:
                node = node_or_text
            return self._run_plan(self.plan(node), var_table, None)
        with telemetry.trace_query(trace=trace):
            if isinstance(node_or_text, str):
                with trace.span("parse"):
                    node, var_table = self.parse(node_or_text)
            else:
                node = node_or_text
            with trace.span("plan"):
                phys = self.plan(node)
            return self._run_plan(phys, var_table, trace)

    def execute_plan(self, phys: PL.Phys, var_table: Optional[A.VarTable] = None,
                     trace: Optional[telemetry.QueryTrace] = None) -> QueryResult:
        if trace is None and self.cfg.telemetry:
            trace = telemetry.QueryTrace()
        if trace is None:
            return self._run_plan(phys, var_table, None)
        with telemetry.trace_query(trace=trace):
            return self._run_plan(phys, var_table, trace)

    def _run_plan(self, phys: PL.Phys, var_table: Optional[A.VarTable],
                  trace: Optional[telemetry.QueryTrace]) -> QueryResult:
        pool = self.pool
        pool_base = dict(pool.stats()) if pool is not None else None
        t0 = time.perf_counter()
        op = Translator(self.store, self.cfg, self.device, pool=pool).translate(phys)
        if trace is not None:
            trace.add_span("translate", "query", t0, time.perf_counter() - t0)
        proj = tuple(PL.phys_vars(phys))
        settle = trace is not None or self.feedback is not None
        t0 = time.perf_counter()
        try:
            if isinstance(op, LOP.RowOperator):
                rows = self._drain_rows(op, proj)
                if settle:
                    settle_counts(op)  # mixed trees: batch operators under rows
            else:
                rows = self._drain_batches(op, proj, settle)
        finally:
            # operator teardown even when the drain raised; stats survive
            close_tree(op)
        if trace is not None:
            trace.add_span("execute", "query", t0, time.perf_counter() - t0,
                           rows=int(rows.shape[0]))
            trace.add_operator_tree(op)
        if self.feedback is not None:
            self._record_actuals(op)
        return QueryResult(var_table or A.VarTable(), proj, rows, root=op, pool=pool,
                           pool_base=pool_base, trace=trace)

    def _record_actuals(self, root: AnyOp) -> None:
        """Feed the drained tree's actual output rows into the feedback
        store, keyed by node fingerprint. Pass-through chains (Sort over
        Scan, ...) share one fingerprint: record it once, from the topmost
        operator (identical counts by construction)."""
        seen = set()

        def walk(op) -> None:
            fp = op.stats.node_fp
            if fp and fp not in seen:
                seen.add(fp)
                self.feedback.record(fp, op.stats.results)
            for c in op.children():
                walk(c)

        walk(root)

    @staticmethod
    def _drain_rows(op: LOP.RowOperator, proj: Tuple[int, ...]) -> np.ndarray:
        """The row engine's result: every row of the root, NULL_ID where a
        projected variable is unbound."""
        rows = [[r.get(v, NULL_ID) for v in proj] for r in op.drain()]
        return np.asarray(rows, dtype=np.int32).reshape(len(rows), len(proj))

    def _drain_batches(self, op: BatchOperator, proj: Tuple[int, ...],
                       settle: bool) -> np.ndarray:
        """Streaming drain: keep each batch's projection on the device, give
        the buffers straight back to the arena, and copy the rows to the
        host once. With ``settle`` the operators' device row counts come
        to the host in one copy queued ahead of the rows', into pinned
        memory, so the rows' copy is the only wait."""
        blocks = []
        while True:
            b = op.next_batch()
            if b is None:
                break
            if not b.n_active:
                b.release()
                continue
            cb = b.compact()
            order = [cb.col_index(v) for v in proj]
            blocks.append(cb.columns[order, : cb.n_rows].T)  # row gather copies
            cb.release()
        stats, counts = pending_counts(op) if settle else ([], None)
        if counts is not None:
            host_counts = torch.empty(counts.shape, dtype=counts.dtype,
                                      pin_memory=counts.is_cuda)
            host_counts.copy_(counts, non_blocking=True)
        dev_rows = (
            torch.cat(blocks, dim=0) if blocks
            else torch.zeros((0, len(proj)), dtype=torch.int32, device=self.device)
        )
        rows = dev_rows.cpu().numpy()  # waits for the stream, counts' copy included
        if counts is not None:
            for s, v in zip(stats, host_counts.tolist()):
                s.settle(v)
        return rows
