"""Cost-based query planner: logical → physical plans (paper §2.2.2, §4.2).

The planner keeps the paper's architecture: ONE optimizer and cost model for
both executors. Join ordering is greedy smallest-expansion-first over the
System-R containment estimate; physical selection prefers merge joins when
the inputs arrive sorted (sorted indexes make them nearly free, §2.2.1),
a LookupJoin when the build side is small, and otherwise chooses by cost
between Sort pipeline breakers + merge and the radix-partitioned hash
join (DESIGN.md §11) — so unsorted OPTIONAL/MINUS/mid-plan inputs no
longer force two O(n log n) sorts. EngineConfig.join_strategy forces one
path for parity tests and ablations.

The single BARQ-awareness concession the paper describes (§4.2 Component
Isolation) is reproduced: merge joins expected to produce substantially
more results than either input ('amplifying joins') get a lower cost when
BARQ is enabled, because most of their work happens in-memory inside the
join. The flag flips plan choice exactly the way Listing 4 vs Listing 1
differ (bind-join plan for the legacy engine, pure merge-join plan for
BARQ).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple, Union as TUnion

from repro_torch.core import algebra as A
from repro_torch.core import telemetry
from repro_torch.core.stats import GraphStats

# ---------------------------------------------------------------------------
# physical plan nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhysNode:
    est_rows: float = dataclasses.field(default=0.0, init=False)
    # where est_rows came from: "stats" (cost model) or "feedback"
    # (observed-cardinality override, DESIGN.md §14)
    est_source: str = dataclasses.field(default="stats", init=False, repr=False)
    # stable node fingerprint (annotate_fingerprints): the key observed
    # cardinalities are recorded and looked up under. Empty until computed.
    fp: str = dataclasses.field(default="", init=False, repr=False)
    # the set of source fingerprints this node's inner-join tree covers —
    # inner joins hash the *unordered* union, so (A⋈B)⋈C and A⋈(C⋈B) and
    # the hash/merge/lookup variants of the same logical join share one
    # fingerprint (cardinality doesn't depend on order or strategy)
    srcs: FrozenSet[str] = dataclasses.field(
        default_factory=frozenset, init=False, repr=False
    )


@dataclasses.dataclass
class PSipFilter:
    """Sideways-information-passing annotation (DESIGN.md §12): a probe-
    side leaf carrying one of these prefilters its output through a
    bloom/code-range summary of the exporting join's build side. ``sid``
    links the consuming leaf to the exporting join (which lists the same
    annotation in ``sip_exports``) across the translator."""

    var: int
    sid: int
    source: str  # "hash_build" | "merge_build"


@dataclasses.dataclass
class PScan(PhysNode):
    pattern: A.TriplePattern
    sort_var: Optional[int]  # variable the scan should come out sorted by
    sip: Tuple[PSipFilter, ...] = ()


@dataclasses.dataclass
class PPathScan(PhysNode):
    """Transitive property path ?s :p+ ?o — row-based only (paper §4).
    Kept for programmatically built plans; the planner now emits
    PPathExpand for every path (DESIGN.md §8)."""

    pattern: A.TriplePattern  # path == '+', constant predicate


@dataclasses.dataclass
class PPathExpand(PhysNode):
    """Vectorized property path: semi-naive delta-frontier BFS over the
    batch pipeline (DESIGN.md §8). ``seed_side`` records the planner's
    bound-endpoint choice: 'subject' seeds forward BFS (bound or
    enumerated subjects), 'object' seeds reverse BFS over flipped edges."""

    pattern: A.PathPattern
    seed_side: str = "subject"
    sip: Tuple[PSipFilter, ...] = ()


@dataclasses.dataclass
class PSort(PhysNode):
    child: "Phys"
    var: int


@dataclasses.dataclass
class PMergeJoin(PhysNode):
    left: "Phys"
    right: "Phys"
    var: int
    mode: str = "inner"
    post_filter: Optional[A.Expr] = None
    amplifying: bool = False  # output >> inputs: the BARQ sweet spot
    # left-join condition compiled by the expression VM (planner-cached)
    post_program: Optional[object] = None
    sip_exports: Tuple[PSipFilter, ...] = ()
    # mid-plan re-strategy eligibility (DESIGN.md §15): set by the planner
    # only where no ancestor consumes this join's sort order, so the
    # executor may lower an AdaptiveMergeJoin that switches merge->hash
    # when the build-side actual blows the estimate. Fingerprint-neutral.
    adaptive_ok: bool = dataclasses.field(default=False, compare=False)


@dataclasses.dataclass
class PLookupJoin(PhysNode):
    probe: "Phys"
    build: "Phys"
    var: int
    mode: str = "inner"


@dataclasses.dataclass
class PHashJoin(PhysNode):
    """Radix-partitioned hash join (DESIGN.md §11): the build side is
    materialized into a partitioned hash layout, the probe side streams
    through unsorted — chosen by cost when sorting the inputs for a merge
    join would dominate. ``keys`` may be empty: the degenerate
    constant-key join (cross / NULL-extending cross / exists-anything)
    that disjoint OPTIONAL and FILTER NOT EXISTS lower onto."""

    probe: "Phys"
    build: "Phys"
    keys: Tuple[int, ...] = ()
    mode: str = "inner"
    post_filter: Optional[A.Expr] = None
    post_program: Optional[object] = None
    sip_exports: Tuple[PSipFilter, ...] = ()
    # partitioning as a tracked physical property (DESIGN.md §15): grace
    # marks a budget-directed out-of-core build; grace_parts is the chosen
    # top-level fan-out, exp_spill_bytes the costing-time spill expectation
    # rendered by explain(). All fingerprint-neutral — strategy, not shape.
    grace: bool = dataclasses.field(default=False, compare=False)
    grace_parts: int = dataclasses.field(default=0, compare=False)
    exp_spill_bytes: float = dataclasses.field(default=0.0, compare=False)


@dataclasses.dataclass
class PCross(PhysNode):
    left: "Phys"
    right: "Phys"


@dataclasses.dataclass
class PFilter(PhysNode):
    expr: A.Expr
    child: "Phys"
    # ExprProgram compiled at plan time and cached on the node, so a plan
    # reused through the server's plan cache never re-lowers (DESIGN.md §9)
    program: Optional[object] = None


@dataclasses.dataclass
class PExtend(PhysNode):
    var: int
    expr: A.Expr
    child: "Phys"
    program: Optional[object] = None  # value-mode ExprProgram


@dataclasses.dataclass
class PProject(PhysNode):
    vars: Tuple[int, ...]
    child: "Phys"


@dataclasses.dataclass
class PDistinct(PhysNode):
    child: "Phys"
    streaming_var: Optional[int]  # set => DISTINCT-via-skip applies
    # budget-directed partitioned dedup (DESIGN.md §15)
    grace: bool = dataclasses.field(default=False, compare=False)
    grace_parts: int = dataclasses.field(default=0, compare=False)


@dataclasses.dataclass
class PGroup(PhysNode):
    child: "Phys"
    group_vars: Tuple[int, ...]
    aggs: Tuple[A.AggSpec, ...]
    streaming: bool  # single sorted group var
    # budget-directed partitioned grouping (DESIGN.md §15)
    grace: bool = dataclasses.field(default=False, compare=False)
    grace_parts: int = dataclasses.field(default=0, compare=False)


@dataclasses.dataclass
class PHaving(PhysNode):
    """HAVING: a mask-mode expression-VM filter stage over the aggregate
    output (DESIGN.md §10). Kept distinct from PFilter so plans show the
    post-grouping stage and translators can keep row/batch parity."""

    expr: A.Expr
    child: "Phys"
    program: Optional[object] = None  # plan-time compiled ExprProgram


@dataclasses.dataclass
class POrderBy(PhysNode):
    child: "Phys"
    keys: Tuple[A.SortKey, ...]


@dataclasses.dataclass
class PSlice(PhysNode):
    child: "Phys"
    limit: Optional[int]
    offset: int


@dataclasses.dataclass
class PUnion(PhysNode):
    left: "Phys"
    right: "Phys"


Phys = TUnion[
    PScan, PPathScan, PPathExpand, PSort, PMergeJoin, PLookupJoin,
    PHashJoin, PCross, PFilter, PExtend, PProject, PDistinct, PGroup,
    PHaving, POrderBy, PSlice, PUnion,
]


def phys_vars(n: Phys) -> Tuple[int, ...]:
    if isinstance(n, (PScan, PPathScan, PPathExpand)):
        return n.pattern.vars()
    if isinstance(n, (PSort, PFilter, PHaving, PSlice)):
        return phys_vars(n.child)
    if isinstance(n, PDistinct):
        return phys_vars(n.child)
    if isinstance(n, PExtend):
        return tuple(dict.fromkeys(phys_vars(n.child) + (n.var,)))
    if isinstance(n, PProject):
        return n.vars
    if isinstance(n, PMergeJoin):
        lv = phys_vars(n.left)
        if n.mode in ("semi", "anti"):
            return lv
        return tuple(dict.fromkeys(lv + phys_vars(n.right)))
    if isinstance(n, PLookupJoin):
        lv = phys_vars(n.probe)
        if n.mode in ("semi", "anti"):
            return lv
        return tuple(dict.fromkeys(lv + phys_vars(n.build)))
    if isinstance(n, PHashJoin):
        lv = phys_vars(n.probe)
        if n.mode in ("semi", "anti"):
            return lv
        return tuple(dict.fromkeys(lv + phys_vars(n.build)))
    if isinstance(n, (PCross, PUnion)):
        return tuple(dict.fromkeys(phys_vars(n.left) + phys_vars(n.right)))
    if isinstance(n, PGroup):
        return n.group_vars + tuple(a.out for a in n.aggs)
    if isinstance(n, POrderBy):
        return phys_vars(n.child)
    raise TypeError(type(n))


def phys_sorted_by(n: Phys) -> Optional[int]:
    if isinstance(n, PScan):
        return n.sort_var
    if isinstance(n, PPathScan):
        return n.pattern.s.id if isinstance(n.pattern.s, A.V) else None
    if isinstance(n, PPathExpand):
        if isinstance(n.pattern.s, A.V):
            return n.pattern.s.id
        return n.pattern.o.id if isinstance(n.pattern.o, A.V) else None
    if isinstance(n, PSort):
        return n.var
    if isinstance(n, PMergeJoin):
        return None if n.mode == "left_outer" else n.var
    if isinstance(n, PLookupJoin):
        return phys_sorted_by(n.probe)
    if isinstance(n, PHashJoin):
        # probe order survives; tracked left_outer (a join condition, or a
        # multi-key join whose packing may fall back to pair tracking)
        # emits its NULL-extended rows after each batch's expansions,
        # breaking the interleave. A grace build re-orders the probe side
        # by partition, so it preserves nothing (DESIGN.md §15).
        if n.grace:
            return None
        if n.mode == "left_outer" and (
            n.post_filter is not None or len(n.keys) > 1
        ):
            return None
        return phys_sorted_by(n.probe)
    if isinstance(n, (PFilter, PHaving, PSlice)):
        return phys_sorted_by(n.child)
    if isinstance(n, PExtend):
        return phys_sorted_by(n.child)
    if isinstance(n, PProject):
        sb = phys_sorted_by(n.child)
        return sb if sb in n.vars else None
    if isinstance(n, PDistinct):
        if n.grace:
            # partitioned dedup emits partition-major, never sorted —
            # unlike SortDistinct whose np.unique output is ordered
            return None
        return n.streaming_var or (
            phys_vars(n.child)[0] if len(phys_vars(n.child)) == 1 else None
        )
    if isinstance(n, PGroup):
        return n.group_vars[0] if n.streaming and n.group_vars else None
    return None


# ---------------------------------------------------------------------------
# node fingerprints (DESIGN.md §14)
# ---------------------------------------------------------------------------

# Every Phys node gets a stable fingerprint identifying *what it computes*
# (not how): constants stay literal (cardinality depends on them), variables
# canonicalize through the query's first-appearance map, and physical
# details that can't change output cardinality — sort vars, seed sides,
# join strategy, SIP annotations — are excluded. The executor records each
# operator's actual row count under this key; the planner's feedback
# override looks the same key up on the next plan of the same (or any
# same-shaped) query.


def _fp_hash(label: str) -> str:
    return hashlib.sha256(label.encode()).hexdigest()[:16]


def _fp_slot(sl, canon: Dict[int, int]) -> str:
    if isinstance(sl, A.V):
        return f"?{canon.get(sl.id, sl.id)}"
    return f"K:{sl.term}"


def _fp_expr(e, canon: Dict[int, int]) -> str:
    if e is None:
        return ""
    if isinstance(e, A.VarRef):
        return f"?{canon.get(e.var, e.var)}"
    if isinstance(e, A.Lit):
        return f"L:{e.value!r}"
    if isinstance(e, A.Cmp):
        return f"({_fp_expr(e.lhs, canon)}{e.op}{_fp_expr(e.rhs, canon)})"
    if isinstance(e, A.Arith):
        return f"({_fp_expr(e.lhs, canon)}{e.op}{_fp_expr(e.rhs, canon)})"
    if isinstance(e, A.And):
        return "and(" + ",".join(_fp_expr(t, canon) for t in e.terms) + ")"
    if isinstance(e, A.Or):
        return "or(" + ",".join(_fp_expr(t, canon) for t in e.terms) + ")"
    if isinstance(e, A.Not):
        return f"not({_fp_expr(e.term, canon)})"
    if isinstance(e, A.Bound):
        return f"bound(?{canon.get(e.var, e.var)})"
    if isinstance(e, A.Func):
        return f"{e.name}(" + ",".join(_fp_expr(a, canon) for a in e.args) + ")"
    return type(e).__name__


def _leaf_label(p, canon: Dict[int, int]) -> str:
    """Fingerprint label for a BGP leaf (TriplePattern or PathPattern)."""
    if isinstance(p, A.PathPattern):
        from repro_torch.core.paths.expr import path_repr

        return (
            f"path({_fp_slot(p.s, canon)},{path_repr(p.expr)},"
            f"{_fp_slot(p.o, canon)})"
        )
    parts = [_fp_slot(p.s, canon), _fp_slot(p.p, canon), _fp_slot(p.o, canon)]
    if p.g is not None:
        parts.append(_fp_slot(p.g, canon))
    if p.path:
        parts.append(f"+{p.path}")
    return f"scan({','.join(parts)})"


def _srcs_label(srcs: FrozenSet[str]) -> str:
    return ",".join(sorted(srcs))


def _join_fp(
    mode: str, post_filter, left: "Phys", right: "Phys", canon: Dict[int, int]
) -> Tuple[str, FrozenSet[str]]:
    """Fingerprint for a join over two (already-fingerprinted) subplans.
    Plain inner joins hash the unordered union of source sets; everything
    order-sensitive (semi/anti/left_outer, or a join condition) hashes the
    ordered pair of source sets plus the condition."""
    if mode == "inner" and post_filter is None:
        srcs = left.srcs | right.srcs
        return _fp_hash("join{" + _srcs_label(srcs) + "}"), srcs
    label = (
        f"{mode}[{_fp_expr(post_filter, canon)}]"
        f"({_srcs_label(left.srcs)}|{_srcs_label(right.srcs)})"
    )
    fp = _fp_hash(label)
    return fp, frozenset((fp,))


# unary nodes that preserve their child's cardinality 1:1 share the child's
# fingerprint — one observation covers the whole pass-through chain
_PASS_THROUGH = (PSort, PProject, POrderBy, PExtend)


def annotate_fingerprints(n: Phys, canon: Dict[int, int]) -> None:
    """Bottom-up fingerprint computation over a physical plan. Idempotent:
    nodes fingerprinted during planning (feedback consultation) keep their
    values; only unset nodes are computed."""
    if n.fp:
        return
    for fld in ("child", "left", "right", "probe", "build"):
        c = getattr(n, fld, None)
        if isinstance(c, PhysNode):
            annotate_fingerprints(c, canon)
    if isinstance(n, (PScan, PPathExpand, PPathScan)):
        n.fp = _fp_hash(_leaf_label(n.pattern, canon))
        n.srcs = frozenset((n.fp,))
    elif isinstance(n, _PASS_THROUGH):
        n.fp, n.srcs = n.child.fp, n.child.srcs
    elif isinstance(n, PFilter):
        # selections commute with inner joins, so a filter joins the
        # source set as a pseudo-source atom: σ_E(A⋈B⋈C) and σ_E(A⋈B)⋈C
        # fingerprint identically no matter where the planner placed it
        n.srcs = n.child.srcs | frozenset((f"σ[{_fp_expr(n.expr, canon)}]",))
        n.fp = _fp_hash("join{" + _srcs_label(n.srcs) + "}")
    elif isinstance(n, PHaving):
        n.fp = _fp_hash(
            f"having[{_fp_expr(n.expr, canon)}]" + "{"
            + _srcs_label(n.child.srcs) + "}"
        )
        n.srcs = frozenset((n.fp,))
    elif isinstance(n, PDistinct):
        n.fp = _fp_hash("distinct{" + _srcs_label(n.child.srcs) + "}")
        n.srcs = frozenset((n.fp,))
    elif isinstance(n, PGroup):
        gv = ",".join(f"?{canon.get(v, v)}" for v in n.group_vars)
        aggs = ";".join(
            f"{'d' if a.distinct else ''}{a.func}"
            f"({'*' if a.var is None else '?%s' % canon.get(a.var, a.var)})"
            for a in n.aggs
        )
        n.fp = _fp_hash(
            f"group[{gv}|{aggs}]" + "{" + _srcs_label(n.child.srcs) + "}"
        )
        n.srcs = frozenset((n.fp,))
    elif isinstance(n, PSlice):
        n.fp = _fp_hash(
            f"slice[{n.limit}:{n.offset}]" + "{"
            + _srcs_label(n.child.srcs) + "}"
        )
        n.srcs = frozenset((n.fp,))
    elif isinstance(n, PMergeJoin):
        n.fp, n.srcs = _join_fp(n.mode, n.post_filter, n.left, n.right, canon)
    elif isinstance(n, PLookupJoin):
        n.fp, n.srcs = _join_fp(n.mode, None, n.probe, n.build, canon)
    elif isinstance(n, PHashJoin):
        n.fp, n.srcs = _join_fp(n.mode, n.post_filter, n.probe, n.build, canon)
    elif isinstance(n, PCross):
        n.fp, n.srcs = _join_fp("inner", None, n.left, n.right, canon)
    elif isinstance(n, PUnion):
        n.fp = _fp_hash(
            "union("
            + "|".join(
                sorted((_srcs_label(n.left.srcs), _srcs_label(n.right.srcs)))
            )
            + ")"
        )
        n.srcs = frozenset((n.fp,))
    else:
        n.fp = _fp_hash(type(n).__name__)
        n.srcs = frozenset((n.fp,))


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


# hash-join cost constants (DESIGN.md §11 strategy table): building the
# partitioned layout touches every build row a few times (partition, reorder,
# probe bookkeeping), a sort costs ~ n log2 n row moves. The constants only
# need to be right about the crossover, not the absolute times.
_HASH_BUILD_FACTOR = 4.0
# extra per-row cost when an over-budget hash build must run as a grace
# join (partition fan-out + spill I/O on both sides, DESIGN.md §15)
_GRACE_SPILL_FACTOR = 2.0


def _sort_cost(n: float) -> float:
    n = max(n, 2.0)
    return n * math.log2(n)


class Planner:
    def __init__(
        self,
        stats: GraphStats,
        barq_enabled: bool = True,
        dictionary=None,
        join_strategy: Optional[str] = None,
        sip: Optional[str] = None,
        feedback: Optional[telemetry.CardinalityFeedback] = None,
        memory_budget: Optional[int] = None,
        adaptive_join: Optional[str] = None,
    ):
        assert join_strategy in (None, "hash", "merge")
        assert sip in (None, "on", "off")
        assert adaptive_join in (None, "on", "off")
        self.stats = stats
        # partitioned substrate (DESIGN.md §15): bytes of working memory a
        # single build/sort may assume resident. None disables every
        # budget-aware decision — plans are byte-identical to pre-§15.
        self.memory_budget = memory_budget
        # "on" marks order-insensitive merge joins adaptive_ok so the
        # executor can re-strategize merge->hash on observed misestimates
        self.adaptive_join = adaptive_join
        # observed-cardinality feedback store (DESIGN.md §14): when set,
        # estimates at every choke point — leaf cards, join ordering, the
        # generic binary-join estimate — prefer recorded actuals over the
        # cost model, and a final pass stamps est_source="feedback"
        self.feedback = feedback
        # canonical var map of the query being planned (fingerprint input)
        self._canon: Dict[int, int] = {}
        # sideways information passing (DESIGN.md §12): None = cost-gated
        # (push a prefilter when the build side looks selective), "on" =
        # always push where sound, "off" = never annotate
        self.sip = sip
        self._sip_counter = 0
        # §4.2: the one cost-model tweak — amplifying merge joins get cheaper
        # when BARQ executes them
        self.barq_enabled = barq_enabled
        # EngineConfig.join_strategy: None = cost-based choice between the
        # sort+merge and radix-hash paths; "hash"/"merge" force one (tests,
        # ablations)
        self.join_strategy = join_strategy
        # expression VM: FILTER / BIND / left-join conditions compile once
        # at plan time; programs are cached per (expr, mode) across the
        # whole plan (and across plans, for a long-lived planner)
        self.dictionary = dictionary if dictionary is not None else getattr(
            getattr(stats, "store", None), "dict", None
        )
        self._prog_cache: dict = {}

    # -- public -------------------------------------------------------------------

    def plan(self, node: A.PlanNode) -> Phys:
        self._canon = telemetry.canonical_var_map(node)
        phys = self._plan(node)
        if self.sip != "off":
            self._sip_walk(phys)
        annotate_fingerprints(phys, self._canon)
        if self.feedback is not None:
            self._apply_feedback(phys)
        if self.memory_budget is not None:
            # after feedback: budget decisions should see history-corrected
            # cardinalities, not just the cost model's
            self._budget_walk(phys)
        if self.adaptive_join == "on":
            self._mark_adaptive(phys, order_needed=False)
        return phys

    # -- budget-aware physical properties (DESIGN.md §15) -----------------------

    @staticmethod
    def _est_bytes(n: Phys) -> float:
        return max(n.est_rows, 0.0) * max(len(phys_vars(n)), 1) * 4.0

    def _grace_parts_for(self, nbytes: float) -> int:
        # average partition should fit half the budget (probe partitions
        # share the other half); power of two, capped at 256
        half = max(self.memory_budget // 2, 1)
        p = 1
        while p * half < nbytes and p < 256:
            p *= 2
        return max(p, 2)

    def _budget_walk(self, n: Phys) -> None:
        """Post-pass marking partitioning as a physical property: hash
        builds whose estimated bytes exceed the budget become grace builds,
        unsorted GROUP BY/DISTINCT over budget consume the partitioned
        layout instead of the whole-input sort."""
        for fld in ("child", "left", "right", "probe", "build"):
            c = getattr(n, fld, None)
            if isinstance(c, PhysNode):
                self._budget_walk(c)
        if isinstance(n, PHashJoin) and n.keys:
            bb = self._est_bytes(n.build)
            if bb > self.memory_budget:
                n.grace = True
                n.grace_parts = self._grace_parts_for(bb)
                n.exp_spill_bytes = max(
                    bb + self._est_bytes(n.probe) - self.memory_budget, 0.0
                )
        elif isinstance(n, PGroup) and n.group_vars:
            if self._est_bytes(n.child) > self.memory_budget:
                if n.streaming and isinstance(n.child, PSort):
                    # the PSort existed only to force streaming grouping;
                    # the partitioned path groups unsorted input directly
                    n.child = n.child.child
                    n.streaming = False
                if not n.streaming:
                    # naturally sorted streaming input needs no budget: it
                    # reduces run-by-run without materializing
                    n.grace = True
                    n.grace_parts = self._grace_parts_for(
                        self._est_bytes(n.child)
                    )
        elif isinstance(n, PDistinct) and n.streaming_var is None:
            if self._est_bytes(n.child) > self.memory_budget:
                n.grace = True
                n.grace_parts = self._grace_parts_for(self._est_bytes(n.child))

    def _mark_adaptive(self, n: Phys, order_needed: bool) -> None:
        """Top-down order-sensitivity walk: a PMergeJoin is adaptive_ok
        only when NO ancestor consumes its output order — switching
        merge->hash mid-plan re-orders emission, so an order-consuming
        parent (another merge join, a streaming group/distinct, ORDER BY
        assumptions) must pin the strategy."""
        if isinstance(n, PMergeJoin):
            n.adaptive_ok = not order_needed
            # both inputs feed a merge: their order is always consumed
            self._mark_adaptive(n.left, True)
            self._mark_adaptive(n.right, True)
            return
        if isinstance(n, (PSort, POrderBy)):
            # a sort above re-establishes any order: children are free
            self._mark_adaptive(n.child, False)
            return
        if isinstance(n, PGroup):
            self._mark_adaptive(n.child, n.streaming)
            return
        if isinstance(n, PDistinct):
            self._mark_adaptive(n.child, n.streaming_var is not None)
            return
        if isinstance(n, (PFilter, PHaving, PProject, PExtend, PSlice)):
            self._mark_adaptive(n.child, order_needed)
            return
        if isinstance(n, (PHashJoin, PLookupJoin)):
            # the probe side's order flows through; the build side is
            # materialized wholesale, so its order never matters
            self._mark_adaptive(n.probe, order_needed)
            self._mark_adaptive(n.build, False)
            return
        if isinstance(n, (PCross, PUnion)):
            self._mark_adaptive(n.left, False)
            self._mark_adaptive(n.right, False)
            return
        for fld in ("child", "left", "right", "probe", "build"):
            c = getattr(n, fld, None)
            if isinstance(c, PhysNode):
                self._mark_adaptive(c, True)  # unknown parent: be safe

    def _apply_feedback(self, n: Phys) -> None:
        """Final pass: override every node's estimate with its observed
        cardinality where history exists, tagging the source so EXPLAIN
        renders ``est=N(source=feedback)`` and EXPLAIN ANALYZE q-errors
        reflect the history-corrected numbers."""
        for fld in ("child", "left", "right", "probe", "build"):
            c = getattr(n, fld, None)
            if isinstance(c, PhysNode):
                self._apply_feedback(c)
        obs = self.feedback.lookup(n.fp)
        if obs is not None:
            n.est_rows = obs
            n.est_source = "feedback"

    def _feedback_est(self, fp: str, default: float) -> float:
        if self.feedback is None:
            return default
        obs = self.feedback.lookup(fp)
        return default if obs is None else obs

    def compile_expr(self, expr: A.Expr, mode: str):
        """ExprProgram for ``expr``; ``False`` (cached) when the expression
        is outside the VM surface — operators then use the interpreted
        tree walk without re-attempting compilation; None when no
        dictionary is attached."""
        if self.dictionary is None or expr is None:
            return None
        key = (expr, mode)
        if key not in self._prog_cache:
            from repro_torch.core.exprs import ExprCompileError, compile_expr

            try:
                self._prog_cache[key] = compile_expr(expr, self.dictionary, mode)
            except ExprCompileError:
                self._prog_cache[key] = False  # known uncompilable
        return self._prog_cache[key]

    def _pfilter(self, expr: A.Expr, child: Phys, sel: float = 0.5) -> Phys:
        out = PFilter(expr, child, program=self.compile_expr(expr, "mask"))
        out.est_rows = child.est_rows * sel
        return out

    # -- sideways information passing (DESIGN.md §12) ---------------------------

    # auto mode pushes a prefilter only when the build side is estimated
    # to be meaningfully smaller than the probe stream it would prune
    _SIP_GATE = 0.5

    def _sip_wanted(self, build_est: float, probe_est: float) -> bool:
        if self.sip == "on":
            return True
        return build_est < self._SIP_GATE * max(probe_est, 1.0)

    def _sip_walk(self, n: Phys) -> None:
        """Post-pass over the final physical plan: for every inner/semi
        hash or merge join whose build side looks selective, push a
        PSipFilter annotation into the probe-side leaves. Runs bottom-up
        so inner joins' filters land before outer ones'."""
        for fld in ("child", "left", "right", "probe", "build"):
            c = getattr(n, fld, None)
            if isinstance(c, PhysNode):
                self._sip_walk(c)
        if (
            isinstance(n, PHashJoin)
            and n.mode in ("inner", "semi")
            and n.keys
            and self._sip_wanted(n.build.est_rows, n.probe.est_rows)
        ):
            for var in n.keys:
                ann = PSipFilter(var, self._sip_counter, "hash_build")
                if self._push_sip(n.probe, ann):
                    self._sip_counter += 1
                    n.sip_exports = n.sip_exports + (ann,)
        if isinstance(n, PMergeJoin) and n.mode in ("inner", "semi"):
            # the right side must either be a pipeline breaker (PSort —
            # full bloom summary for free) or a sorted leaf (O(1)
            # range-only summary); anything else would force an extra
            # materialization just to summarize it
            exportable = isinstance(n.right, PSort) or (
                isinstance(n.right, PScan) and n.right.sort_var == n.var
            )
            if exportable and self._sip_wanted(n.right.est_rows, n.left.est_rows):
                ann = PSipFilter(n.var, self._sip_counter, "merge_build")
                if self._push_sip(n.left, ann):
                    self._sip_counter += 1
                    n.sip_exports = n.sip_exports + (ann,)

    def _push_sip(self, n: Phys, ann: PSipFilter) -> bool:
        """Descend toward leaves binding ann.var; attach where sound.
        A SIP prefilter may only remove rows whose ann.var value is
        certainly absent from the exporting join's build side, so it can
        cross any operator for which 'prune child rows with var not in S'
        never changes rows the top join would keep: filters, sorts,
        distinct, both union branches, the probe/left side of inner,
        semi, anti and left-outer joins, and grouping keyed on the var.
        It must NOT cross a nullable (optional) side, an anti subtrahend,
        a slice, or an aggregate input whose group keys don't include the
        var."""
        v = ann.var
        if isinstance(n, PScan):
            if v in n.pattern.vars():
                n.sip = n.sip + (ann,)
                return True
            return False
        if isinstance(n, PPathExpand):
            if v in n.pattern.vars():
                n.sip = n.sip + (ann,)
                return True
            return False
        if isinstance(n, (PSort, PFilter, PHaving, PDistinct, POrderBy)):
            return self._push_sip(n.child, ann)
        if isinstance(n, PExtend):
            # BIND introduces n.var fresh — if that's the filtered var it
            # originates here, not in any leaf below
            return False if v == n.var else self._push_sip(n.child, ann)
        if isinstance(n, PProject):
            return v in n.vars and self._push_sip(n.child, ann)
        if isinstance(n, PGroup):
            # sound only on a group key: pruning rows of a v∉S group
            # removes that whole group, which the top join drops anyway
            return v in n.group_vars and self._push_sip(n.child, ann)
        if isinstance(n, (PUnion, PCross)):
            a = self._push_sip(n.left, ann)
            b = self._push_sip(n.right, ann)
            return a or b
        if isinstance(n, PMergeJoin):
            if n.mode == "inner":
                a = self._push_sip(n.left, ann)
                b = self._push_sip(n.right, ann)
                return a or b
            if n.mode in ("semi", "anti", "left_outer"):
                return self._push_sip(n.left, ann)
            return False
        if isinstance(n, (PHashJoin, PLookupJoin)):
            if n.mode == "inner":
                a = self._push_sip(n.probe, ann)
                b = self._push_sip(n.build, ann)
                return a or b
            if n.mode in ("semi", "anti", "left_outer"):
                return self._push_sip(n.probe, ann)
            return False
        return False  # PSlice, PPathScan: stop

    # -- logical dispatch -------------------------------------------------------------

    def _plan(self, node: A.PlanNode) -> Phys:
        if isinstance(node, A.BGP):
            return self._plan_bgp(node.patterns, [])
        if isinstance(node, A.Filter):
            # push filters into BGP join ordering when possible (§2.2.2)
            if isinstance(node.child, A.BGP):
                return self._plan_bgp(node.child.patterns, [node.expr])
            child = self._plan(node.child)
            return self._pfilter(node.expr, child)
        if isinstance(node, A.Join):
            return self._plan_binary_join(node.left, node.right, "inner", None)
        if isinstance(node, A.LeftJoin):
            return self._plan_binary_join(node.left, node.right, "left_outer", node.expr)
        if isinstance(node, A.Minus):
            return self._plan_binary_join(node.left, node.right, "anti", None)
        if isinstance(node, A.NotExists):
            # anti-semi-join like Minus, EXCEPT with disjoint variable sets
            # (see _plan_binary_join): there NOT EXISTS removes every left
            # row as soon as the inner pattern has any solution
            return self._plan_binary_join(
                node.left, node.right, "not_exists", None
            )
        if isinstance(node, A.Union):
            l, r = self._plan(node.left), self._plan(node.right)
            out = PUnion(l, r)
            out.est_rows = l.est_rows + r.est_rows
            return out
        if isinstance(node, A.Extend):
            child = self._plan(node.child)
            out = PExtend(
                node.var, node.expr, child,
                program=self.compile_expr(node.expr, "value"),
            )
            out.est_rows = child.est_rows
            return out
        if isinstance(node, A.Project):
            child = self._plan(node.child)
            out = PProject(tuple(node.vars), child)
            out.est_rows = child.est_rows
            return out
        if isinstance(node, A.Distinct):
            child = self._plan(node.child)
            cvars = phys_vars(child)
            sv = None
            if len(cvars) == 1 and phys_sorted_by(child) == cvars[0]:
                sv = cvars[0]
            out = PDistinct(child, sv)
            out.est_rows = max(child.est_rows * 0.5, 1)
            return out
        if isinstance(node, A.GroupAgg):
            child = self._plan(node.child)
            gv = tuple(node.group_vars)
            streaming = (len(gv) == 1 and phys_sorted_by(child) == gv[0]) or len(gv) == 0
            # resort to enable streaming aggregation when cheap (§3.3)
            if len(gv) == 1 and not streaming:
                child = PSort(child, gv[0])
                child.est_rows = child.child.est_rows
                streaming = True
            out = PGroup(child, gv, tuple(node.aggs), streaming)
            out.est_rows = max(child.est_rows * 0.1, 1)
            if node.having is not None:
                h = PHaving(
                    node.having, out,
                    program=self.compile_expr(node.having, "mask"),
                )
                h.est_rows = max(out.est_rows * 0.5, 1)
                return h
            return out
        if isinstance(node, A.OrderBy):
            child = self._plan(node.child)
            out = POrderBy(child, tuple(node.keys))
            out.est_rows = child.est_rows
            return out
        if isinstance(node, A.Slice):
            child = self._plan(node.child)
            out = PSlice(child, node.limit, node.offset)
            out.est_rows = min(
                child.est_rows, node.limit if node.limit is not None else child.est_rows
            )
            return out
        raise TypeError(f"cannot plan {type(node)}")

    # -- BGP join ordering (greedy System-R style) ---------------------------------------

    @staticmethod
    def _normalize_pattern(p):
        """Fold the legacy TriplePattern path='+' shorthand into a
        PathPattern so one code path prices and plans every path."""
        if isinstance(p, A.TriplePattern) and p.path == "+":
            if not isinstance(p.p, A.K):
                raise ValueError(
                    "property paths require a constant predicate, got "
                    f"variable predicate in {p}"
                )
            from repro_torch.core.paths.expr import PClosure, PLink

            return A.PathPattern(p.s, PClosure(PLink(p.p.term), min_hops=1), p.o)
        return p

    def _pattern_card(self, p) -> float:
        """Cardinality for a BGP leaf: triple patterns from the index
        ranges, paths from the stats-based closure estimate (replacing the
        old hard-coded 3-hop multiplier). With a feedback store attached,
        an observed actual for the same leaf fingerprint wins."""
        if isinstance(p, A.PathPattern):
            est = max(self.stats.path_cardinality(p), 0)
        else:
            est = max(self.stats.pattern_cardinality(p), 0)
        if self.feedback is None:
            return est
        return self._feedback_est(
            _fp_hash(_leaf_label(self._normalize_pattern(p), self._canon)), est
        )

    def _pattern_distinct(self, p, var: int) -> int:
        if isinstance(p, A.PathPattern):
            return self.stats.path_distinct_values(p, var)
        return self.stats.distinct_values(p, var)

    # beyond this many patterns the exact DP's subset enumeration (3^n)
    # would dominate planning time; fall back to the greedy loop
    _BUSHY_MAX = 8

    def _plan_bgp(self, patterns: Sequence[A.TriplePattern], filters: List[A.Expr]) -> Phys:
        assert patterns
        remaining = [self._normalize_pattern(p) for p in patterns]
        if 3 <= len(remaining) <= self._BUSHY_MAX:
            plan = self._plan_bgp_bushy(remaining, list(filters))
            if plan is not None:
                return plan
        return self._plan_bgp_greedy(remaining, filters)

    def _plan_bgp_bushy(self, pats: List, filters: List[A.Expr]) -> Optional[Phys]:
        """Bounded exact join ordering: bitmask DP over connected pattern
        subsets (System-R generalized to bushy trees). Each DP state keeps
        the cheapest plan for one subset under the §11 cost model with
        SIP-aware probe discounts, so shapes like (A⋈B)⋈(C⋈D) — which the
        greedy linear loop can never emit — win when two small
        intermediate results exist. Returns None for disconnected BGPs
        (the greedy loop's cartesian handling covers those)."""
        n = len(pats)
        leaves: List[Phys] = []
        for p in pats:
            leaf = self._leaf(p)
            leaf.est_rows = self._pattern_card(p)
            leaves.append(leaf)
        vsets = [frozenset(p.vars()) for p in pats]
        # variable set per subset mask
        vmask = {0: frozenset()}
        for m in range(1, 1 << n):
            low = m & -m
            vmask[m] = vmask[m ^ low] | vsets[low.bit_length() - 1]
        # best[mask] = (cost, plan)
        best: dict = {1 << i: (leaves[i].est_rows, leaves[i]) for i in range(n)}
        for m in sorted(range(1, 1 << n), key=lambda x: bin(x).count("1")):
            if bin(m).count("1") < 2:
                continue
            sub = (m - 1) & m
            while sub:
                oth = m ^ sub
                if sub < oth and sub in best and oth in best and (
                    vmask[sub] & vmask[oth]
                ):
                    ca, pa = best[sub]
                    cb, pb = best[oth]
                    join, jc = self._join_subplans(pa, pb)
                    tot = ca + cb + jc
                    if m not in best or tot < best[m][0]:
                        best[m] = (tot, join)
                sub = (sub - 1) & m
        full = (1 << n) - 1
        if full not in best:
            return None
        plan = best[full][1]
        return self._attach_filters(plan, filters)

    def _join_subplans(self, left: Phys, right: Phys) -> Tuple[Phys, float]:
        """Join two DP subplans: pick the join var (preferring an already
        sorted side), estimate output, and choose merge vs hash by the
        §11 cost model. The hash probe pass is discounted by the SIP
        survival fraction min(d_probe, d_build)/d_probe — the same
        containment assumption stats.semi_join_cardinality uses — since
        an annotated probe leaf never streams rows the build side can't
        match. Never mutates its inputs (losing DP candidates share
        subtrees with winners)."""
        lv, rv = phys_vars(left), phys_vars(right)
        shared = [v for v in lv if v in rv]
        jv = shared[0]
        for v in shared:
            if phys_sorted_by(left) == v or phys_sorted_by(right) == v:
                jv = v
                break
        d_l = self._distinct_estimate(left, jv)
        d_r = self._distinct_estimate(right, jv)
        est = self.stats.join_cardinality(
            max(int(left.est_rows), 1), max(int(right.est_rows), 1), d_l, d_r
        )
        amplifying = est > 4 * max(left.est_rows, right.est_rows)
        if self.barq_enabled and amplifying:
            est *= 0.5  # §4.2: amplifying merge joins are cheap under BARQ
        if self.feedback is not None:
            # observed cardinality for this join's source set (order- and
            # strategy-insensitive) beats the containment estimate — and
            # flows into the DP cost, so ordering re-plans under history
            annotate_fingerprints(left, self._canon)
            annotate_fingerprints(right, self._canon)
            est = self._feedback_est(
                _join_fp("inner", None, left, right, self._canon)[0], est
            )
        ln = max(left.est_rows, 1.0)
        rn = max(right.est_rows, 1.0)
        l_sorted = phys_sorted_by(left) == jv
        r_sorted = phys_sorted_by(right) == jv
        merge_cost = est + ln + rn
        if not l_sorted:
            merge_cost += _sort_cost(ln)
        if not r_sorted:
            merge_cost += _sort_cost(rn)
        # hash: build the smaller side, stream the bigger one
        if ln >= rn:
            probe, build, pn, bn, d_p, d_b = left, right, ln, rn, d_l, d_r
        else:
            probe, build, pn, bn, d_p, d_b = right, left, rn, ln, d_r, d_l
        sip_f = 1.0
        if self.sip != "off" and self._sip_wanted(bn, pn):
            sip_f = max(min(d_p, d_b) / max(d_p, 1), 0.05)
        hash_cost = _HASH_BUILD_FACTOR * bn + pn * sip_f + est
        if (
            self.memory_budget is not None
            and bn * max(len(phys_vars(build)), 1) * 4.0 > self.memory_budget
        ):
            # over-budget build goes grace: both sides pay a partition
            # pass plus spill I/O (DESIGN.md §15 budget costing)
            hash_cost += _GRACE_SPILL_FACTOR * (bn + pn)
        if self.join_strategy == "merge" or (
            self.join_strategy != "hash"
            and (l_sorted and r_sorted or merge_cost <= hash_cost)
        ):
            if not l_sorted:
                s = PSort(left, jv)
                s.est_rows = left.est_rows
                left = s
            if not r_sorted:
                s = PSort(right, jv)
                s.est_rows = right.est_rows
                right = s
            out: Phys = PMergeJoin(left, right, jv)
            out.amplifying = amplifying
            out.est_rows = est
            return out, merge_cost
        keys = tuple(v for v in phys_vars(probe) if v in phys_vars(build))
        if isinstance(probe, PScan) and probe.sort_var is None:
            # a hash probe doesn't need sorted input, but asking the scan
            # to come out sorted by the join var is free (index choice)
            # and lets a pushed SIP filter narrow it by code range via
            # seek instead of just masking (copy: DP leaves are shared
            # across candidate plans)
            p2 = PScan(probe.pattern, jv, sip=probe.sip)
            p2.est_rows = probe.est_rows
            probe = p2
        out = PHashJoin(probe=probe, build=build, keys=keys)
        out.est_rows = est
        return out, hash_cost

    def _attach_filters(self, plan: Phys, filters: List[A.Expr]) -> Phys:
        """Place each pushed-down filter at the lowest node that covers
        its variables (post-pass over the DP-chosen shape — the greedy
        loop instead interleaves placement with ordering)."""
        if not filters:
            return plan

        def place(node: Phys) -> Phys:
            for fld in ("child", "left", "right", "probe", "build"):
                c = getattr(node, fld, None)
                if isinstance(c, PhysNode):
                    setattr(node, fld, place(c))
            for f in list(filters):
                if set(A.expr_vars(f)) <= set(phys_vars(node)):
                    filters.remove(f)
                    node = self._pfilter(f, node)
            return node

        plan = place(plan)
        for f in filters:  # vars never all bound: evaluate at the top
            plan = self._pfilter(f, plan)
        return plan

    def _plan_bgp_greedy(self, remaining: List, filters: List[A.Expr]) -> Phys:
        cards = {id(p): self._pattern_card(p) for p in remaining}
        # start from the most selective pattern
        first = min(remaining, key=lambda p: cards[id(p)])
        remaining.remove(first)
        current: Phys = self._leaf(first)
        current.est_rows = cards[id(first)]
        current_vars = set(first.vars())
        pending_filters = list(filters)

        while remaining:
            # pick the joinable pattern with the smallest estimated output
            best, best_est, best_var = None, None, None
            for p in remaining:
                shared = [v for v in p.vars() if v in current_vars]
                if not shared:
                    continue
                jv = self._choose_join_var(current, p, shared)
                d_a = self._distinct_estimate(current, jv)
                d_b = self._pattern_distinct(p, jv)
                est = self.stats.join_cardinality(
                    max(int(current.est_rows), 1), cards[id(p)], d_a, d_b
                )
                if self.barq_enabled and est > 4 * max(current.est_rows, cards[id(p)]):
                    # §4.2: amplifying merge joins are cheaper under BARQ
                    est *= 0.5
                if self.feedback is not None:
                    # history for (current ⋈ p)'s source set steers the
                    # greedy pick just like it steers the DP
                    annotate_fingerprints(current, self._canon)
                    leaf_fp = _fp_hash(_leaf_label(p, self._canon))
                    srcs = current.srcs | frozenset((leaf_fp,))
                    est = self._feedback_est(
                        _fp_hash("join{" + ",".join(sorted(srcs)) + "}"), est
                    )
                if best_est is None or est < best_est:
                    best, best_est, best_var = p, est, jv
            if best is None:
                # disconnected: cartesian with the smallest remaining pattern
                best = min(remaining, key=lambda p: cards[id(p)])
                remaining.remove(best)
                rhs: Phys = self._leaf(best)
                rhs.est_rows = cards[id(best)]
                current = PCross(current, rhs)
                current.est_rows = current.left.est_rows * rhs.est_rows
                current_vars |= set(best.vars())
            else:
                remaining.remove(best)
                current = self._make_join(current, best, best_var, best_est)
                current_vars |= set(best.vars())
            current, pending_filters = self._apply_ready_filters(
                current, current_vars, pending_filters
            )

        for f in pending_filters:
            current = self._pfilter(f, current)
        return current

    def _apply_ready_filters(self, current: Phys, cvars: set, filters: List[A.Expr]):
        ready = [f for f in filters if set(A.expr_vars(f)) <= cvars]
        rest = [f for f in filters if f not in ready]
        for f in ready:
            current = self._pfilter(f, current)
        return current, rest

    def _choose_join_var(self, current: Phys, p: A.TriplePattern, shared: List[int]) -> int:
        # prefer the current plan's existing sort var to avoid a re-sort
        sb = phys_sorted_by(current)
        if sb in shared:
            return sb
        return shared[0]

    def _distinct_estimate(self, n: Phys, var: int) -> int:
        if isinstance(n, PScan):
            return self.stats.distinct_values(n.pattern, var)
        return max(int(n.est_rows ** 0.5), 1)

    def _leaf(self, p, sort_var: Optional[int] = None) -> Phys:
        p = self._normalize_pattern(p)
        if isinstance(p, A.PathPattern):
            # seed-side choice: a bound object flips the edges and runs
            # BFS backwards from it; otherwise seed forward from the
            # (bound or enumerated) subjects
            seed = (
                "object"
                if isinstance(p.o, A.K) and isinstance(p.s, A.V)
                else "subject"
            )
            return PPathExpand(p, seed_side=seed)
        return PScan(p, sort_var)

    def _make_join(self, left: Phys, p: A.TriplePattern, jv: int, est: float) -> Phys:
        right: Phys = self._leaf(p, jv)
        right.est_rows = self._pattern_card(p)
        left_sorted = phys_sorted_by(left) == jv
        if not left_sorted:
            if (
                self.join_strategy != "hash"
                and left.est_rows <= 4096
                and isinstance(left, (PScan, PFilter))
            ):
                # small unsorted left: lookup-join into the scan instead
                if phys_sorted_by(right) != jv:
                    s = PSort(right, jv)
                    s.est_rows = right.est_rows
                    right = s
                out = PLookupJoin(probe=right, build=left, var=jv)
                out.est_rows = est
                return out
            # unsorted mid-plan input: hash-join it against the pattern
            # when that beats re-sorting it (DESIGN.md §11) — the probe
            # side streams unsorted, only the pattern is materialized
            if self._choose_join_strategy(left, right, jv, est) == "hash":
                shared = tuple(
                    v for v in phys_vars(left) if v in phys_vars(right)
                )
                out = PHashJoin(probe=left, build=right, keys=shared)
                out.est_rows = est
                return out
            left = PSort(left, jv)
            left.est_rows = left.child.est_rows
        if phys_sorted_by(right) != jv:
            s = PSort(right, jv)
            s.est_rows = right.est_rows
            right = s
        join = PMergeJoin(left, right, jv)
        join.est_rows = est
        join.amplifying = est > 4 * max(left.est_rows, right.est_rows)
        return join

    # -- generic binary joins (OPTIONAL / MINUS / subplans) -------------------------------

    def _binary_join_estimate(
        self, left: Phys, right: Phys, jv: int, mode: str
    ) -> float:
        """Output estimate for a generic binary join, flowing through the
        stats object so the hash-vs-merge choice below prices output cost
        from the same number the plan reports. semi/anti estimates use the
        containment-based semi-join selectivity (NOT the old flat
        left * 0.5, which ignored the right side entirely)."""
        d_l = self._distinct_estimate(left, jv)
        d_r = self._distinct_estimate(right, jv)
        card_l = max(int(left.est_rows), 1)
        card_r = max(int(right.est_rows), 1)
        if mode in ("semi", "anti", "not_exists"):
            return self.stats.semi_join_cardinality(
                card_l, d_l, d_r, anti=mode != "semi"
            )
        est = self.stats.join_cardinality(card_l, card_r, d_l, d_r)
        if mode == "left_outer":
            # a left join emits at least one row per left row
            est = max(est, left.est_rows)
        return est

    def _choose_join_strategy(
        self, left: Phys, right: Phys, jv: int, est: float
    ) -> str:
        """Sort+merge vs radix-hash (DESIGN.md §11 strategy table). Merge
        pays one PSort per unsorted input plus a linear pass; hash pays a
        constant-factor build over the right side and streams the probe
        side unsorted. With both inputs already sorted the merge join is
        nearly free and always wins."""
        if self.join_strategy in ("hash", "merge"):
            return self.join_strategy
        l_sorted = phys_sorted_by(left) == jv
        r_sorted = phys_sorted_by(right) == jv
        if l_sorted and r_sorted:
            return "merge"
        ln = max(left.est_rows, 1.0)
        rn = max(right.est_rows, 1.0)
        merge_cost = ln + rn + est
        if not l_sorted:
            merge_cost += _sort_cost(ln)
        if not r_sorted:
            merge_cost += _sort_cost(rn)
        hash_cost = _HASH_BUILD_FACTOR * rn + ln + est
        if (
            self.memory_budget is not None
            and rn * max(len(phys_vars(right)), 1) * 4.0 > self.memory_budget
        ):
            hash_cost += _GRACE_SPILL_FACTOR * (rn + ln)
        return "hash" if hash_cost < merge_cost else "merge"

    def _plan_binary_join(
        self,
        lnode: A.PlanNode,
        rnode: A.PlanNode,
        mode: str,
        expr: Optional[A.Expr],
    ) -> Phys:
        left = self._plan(lnode)
        right = self._plan(rnode)
        lv, rv = phys_vars(left), phys_vars(right)
        shared = [v for v in lv if v in rv]
        if not shared:
            if mode == "inner":
                out = PCross(left, right)
                out.est_rows = left.est_rows * right.est_rows
                return out
            if mode == "anti":
                # MINUS with disjoint domains keeps everything (§8.3.3:
                # no shared variable -> every pair is incompatible)
                return left
            if mode == "not_exists":
                # NOT EXISTS diverges from MINUS here: any inner solution
                # removes ALL left rows. The degenerate constant-key anti
                # hash join is exactly that shape.
                out = PHashJoin(left, right, (), mode="anti")
                out.est_rows = left.est_rows * 0.5
                return out
            # left_outer without shared vars: SPARQL left join must keep
            # every left row even when the optional side is empty — the
            # NULL-extending constant-key hash join, not a plain PCross
            # (which returns zero rows on an empty right side)
            out = PHashJoin(
                left, right, (), mode="left_outer", post_filter=expr,
                post_program=self.compile_expr(expr, "mask"),
            )
            out.est_rows = max(left.est_rows, left.est_rows * right.est_rows)
            return out
        jv = shared[0]
        # prefer a shared var an input is already sorted by
        for v in shared:
            if phys_sorted_by(left) == v or phys_sorted_by(right) == v:
                jv = v
                break
        est = self._binary_join_estimate(left, right, jv, mode)
        join_mode = "anti" if mode == "not_exists" else mode
        if self.feedback is not None:
            annotate_fingerprints(left, self._canon)
            annotate_fingerprints(right, self._canon)
            est = self._feedback_est(
                _join_fp(join_mode, expr, left, right, self._canon)[0], est
            )
        if self._choose_join_strategy(left, right, jv, est) == "hash":
            out = PHashJoin(
                left, right, tuple(shared), mode=join_mode, post_filter=expr,
                post_program=self.compile_expr(expr, "mask"),
            )
            out.est_rows = est
            return out
        if phys_sorted_by(left) != jv:
            s = PSort(left, jv)
            s.est_rows = left.est_rows
            left = s
        if phys_sorted_by(right) != jv:
            s = PSort(right, jv)
            s.est_rows = right.est_rows
            right = s
        out = PMergeJoin(
            left, right, jv, mode=join_mode, post_filter=expr,
            post_program=self.compile_expr(expr, "mask"),
        )
        out.est_rows = est
        return out


def explain(n: Phys, var_table: Optional[A.VarTable] = None, indent: int = 0) -> str:
    pad = "  " * indent

    def estf(node) -> str:
        # ``(source=feedback)`` marks history-overridden estimates; plans
        # built without a feedback store render byte-identically to pre-§14
        src = (
            "(source=feedback)"
            if getattr(node, "est_source", "stats") == "feedback"
            else ""
        )
        return f"est={node.est_rows:.0f}{src}"

    def vname(v):
        return f"?{var_table.name(v)}" if var_table else f"?v{v}"

    def sip_in(node) -> str:
        if not getattr(node, "sip", ()):
            return ""
        anns = ", ".join(
            f"SipFilter({vname(f.var)}#{f.sid})" for f in node.sip
        )
        return f" sip=[{anns}]"

    def sip_out(node) -> str:
        if not getattr(node, "sip_exports", ()):
            return ""
        anns = ", ".join(f"{vname(f.var)}#{f.sid}" for f in node.sip_exports)
        return f" sip-export=[{anns}]"

    if isinstance(n, PScan):
        t = []
        for sl in (n.pattern.s, n.pattern.p, n.pattern.o):
            t.append(vname(sl.id) if isinstance(sl, A.V) else str(sl.term))
        return f"{pad}Scan({', '.join(t)}) {estf(n)}{sip_in(n)}"
    if isinstance(n, PPathExpand):
        from repro_torch.core.paths.expr import path_repr

        s = vname(n.pattern.s.id) if isinstance(n.pattern.s, A.V) else str(n.pattern.s.term)
        o = vname(n.pattern.o.id) if isinstance(n.pattern.o, A.V) else str(n.pattern.o.term)
        return (
            f"{pad}PathExpand({s}, {path_repr(n.pattern.expr)}, {o}) "
            f"[seed={n.seed_side}] {estf(n)}{sip_in(n)}"
        )
    if isinstance(n, PSort):
        return f"{pad}Sort({vname(n.var)})\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PMergeJoin):
        amp = " AMPLIFYING" if n.amplifying else ""
        if n.adaptive_ok:
            amp += " adaptive"
        return (
            f"{pad}MergeJoin({vname(n.var)}, {n.mode}){amp} "
            f"{estf(n)}{sip_out(n)}\n"
            + explain(n.left, var_table, indent + 1)
            + "\n"
            + explain(n.right, var_table, indent + 1)
        )
    if isinstance(n, PLookupJoin):
        return (
            f"{pad}LookupJoin({vname(n.var)}, {n.mode}) {estf(n)}\n"
            + explain(n.probe, var_table, indent + 1)
            + "\n"
            + explain(n.build, var_table, indent + 1)
        )
    if isinstance(n, PHashJoin):
        keys = ", ".join(vname(k) for k in n.keys) if n.keys else "<const>"
        grace = (
            f" grace parts={n.grace_parts}"
            f" spill≈{n.exp_spill_bytes / 1e6:.1f}MB"
            if n.grace
            else ""
        )
        return (
            f"{pad}HashJoin({keys}, {n.mode}){grace} {estf(n)}{sip_out(n)}\n"
            + explain(n.probe, var_table, indent + 1)
            + "\n"
            + explain(n.build, var_table, indent + 1)
        )
    if isinstance(n, PCross):
        return (
            f"{pad}Cross {estf(n)}\n"
            + explain(n.left, var_table, indent + 1)
            + "\n"
            + explain(n.right, var_table, indent + 1)
        )
    if isinstance(n, PFilter):
        return f"{pad}Filter {estf(n)}\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PHaving):
        return f"{pad}Having {estf(n)}\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PExtend):
        return f"{pad}Bind({vname(n.var)})\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PProject):
        return f"{pad}Project\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PDistinct):
        if n.grace:
            kind = f"partitioned parts={n.grace_parts}"
        else:
            kind = "streaming" if n.streaming_var is not None else "sort"
        return f"{pad}Distinct[{kind}]\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PGroup):
        if n.grace:
            kind = f"partitioned parts={n.grace_parts}"
        else:
            kind = "streaming" if n.streaming else "sort"
        return f"{pad}Group[{kind}]\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, POrderBy):
        return f"{pad}OrderBy\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PSlice):
        return f"{pad}Slice\n" + explain(n.child, var_table, indent + 1)
    if isinstance(n, PUnion):
        return (
            f"{pad}Union\n"
            + explain(n.left, var_table, indent + 1)
            + "\n"
            + explain(n.right, var_table, indent + 1)
        )
    return f"{pad}{type(n).__name__}"
