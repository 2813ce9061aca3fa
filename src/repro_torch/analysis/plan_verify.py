"""PlanVerifier — post-planning structural invariant checks (DESIGN.md §16).

The planner maintains several invariants by construction: merge joins only
over inputs sorted by the join variable, SIP annotations only on sides
where pruning is sound (`Planner._push_sip`), grace/adaptive marks only
where the budget and order-safety walks permit, and a fingerprint +
cardinality estimate on every node. A planner regression that breaks one
of these doesn't fail at plan time — it surfaces as silently wrong results
(an unsorted merge join) or a latent crash three operators downstream.

``verify_plan`` re-derives each invariant from the plan alone and raises
``PlanInvariantError`` naming the offending node. The Engine runs it under
``EngineConfig.verify_plans`` (env ``BARQ_VERIFY_PLANS=1``) right after
planning, so CI can execute the whole suite with verification on.

The checks deliberately mirror — but do not call — the planner's own
walks: an independent re-derivation is what makes this a verifier rather
than a tautology.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Set, Tuple

from repro_torch.core import planner as PL


class PlanInvariantError(RuntimeError):
    """A physical plan violates a structural invariant; the message names
    the offending node and the check that failed."""


@dataclasses.dataclass(frozen=True)
class PlanDiagnostic:
    check: str  # V-FP | V-SCHEMA | V-SORT | V-SIP | V-GRACE | V-ADAPTIVE
    node: str  # rendered node name, e.g. "PMergeJoin(?3)"
    message: str

    def render(self) -> str:
        return f"[{self.check}] {self.node}: {self.message}"


_CHILD_FIELDS = ("child", "left", "right", "probe", "build")


def _children(n: PL.Phys):
    for fld in _CHILD_FIELDS:
        c = getattr(n, fld, None)
        if isinstance(c, PL.PhysNode):
            yield c


def _node_name(n: PL.Phys) -> str:
    var = getattr(n, "var", None)
    if var is not None:
        return f"{type(n).__name__}(?{var})"
    keys = getattr(n, "keys", None)
    if keys:
        return f"{type(n).__name__}({','.join('?%d' % k for k in keys)})"
    return type(n).__name__


class PlanVerifier:
    def __init__(self, plan: PL.Phys):
        self.plan = plan
        self.diags: List[PlanDiagnostic] = []
        # sid -> (exporting join, list of leaves carrying the annotation)
        self._exports: Dict[int, PL.Phys] = {}
        self._consumers: Dict[int, List[PL.Phys]] = {}

    def verify(self) -> List[PlanDiagnostic]:
        self._walk(self.plan)
        self._check_adaptive(self.plan, order_needed=False)
        self._check_sip()
        return self.diags

    def _flag(self, check: str, node: PL.Phys, message: str) -> None:
        self.diags.append(PlanDiagnostic(check, _node_name(node), message))

    # -- per-node structural checks -----------------------------------------

    def _walk(self, n: PL.Phys) -> None:
        for c in _children(n):
            self._walk(c)
        self._check_identity(n)
        self._check_schema(n)
        self._check_sorted(n)
        self._check_grace(n)
        self._collect_sip(n)

    def _check_identity(self, n: PL.Phys) -> None:
        """Every node carries a fingerprint (feedback key) and a finite,
        non-negative cardinality estimate (costing/EXPLAIN input)."""
        if not n.fp:
            self._flag("V-FP", n, "node has no fingerprint; "
                       "annotate_fingerprints never ran over this plan")
        est = n.est_rows
        if not isinstance(est, (int, float)) or not math.isfinite(est) or est < 0:
            self._flag("V-FP", n, f"est_rows={est!r} is not a finite "
                       "non-negative number")

    def _check_schema(self, n: PL.Phys) -> None:
        """Variable coverage: every variable an operator consumes must be
        produced by its input — the translator would otherwise fail (or
        worse, index the wrong column) at runtime."""
        if isinstance(n, PL.PSort):
            if n.var not in PL.phys_vars(n.child):
                self._flag("V-SCHEMA", n,
                           f"sort var ?{n.var} not produced by its input")
        elif isinstance(n, PL.PMergeJoin):
            for side, sub in (("left", n.left), ("right", n.right)):
                if n.var not in PL.phys_vars(sub):
                    self._flag("V-SCHEMA", n,
                               f"join var ?{n.var} missing from the {side} input")
        elif isinstance(n, (PL.PLookupJoin,)):
            for side, sub in (("probe", n.probe), ("build", n.build)):
                if n.var not in PL.phys_vars(sub):
                    self._flag("V-SCHEMA", n,
                               f"join var ?{n.var} missing from the {side} input")
        elif isinstance(n, PL.PHashJoin):
            for k in n.keys:
                for side, sub in (("probe", n.probe), ("build", n.build)):
                    if k not in PL.phys_vars(sub):
                        self._flag("V-SCHEMA", n,
                                   f"join key ?{k} missing from the {side} input")
        elif isinstance(n, PL.PExtend):
            if n.var in PL.phys_vars(n.child):
                self._flag("V-SCHEMA", n,
                           f"BIND target ?{n.var} is already bound below")
        elif isinstance(n, PL.PProject):
            cv = set(PL.phys_vars(n.child))
            for v in n.vars:
                if v not in cv:
                    self._flag("V-SCHEMA", n,
                               f"projected var ?{v} not produced by its input")
        elif isinstance(n, PL.PGroup):
            cv = set(PL.phys_vars(n.child))
            for v in n.group_vars:
                if v not in cv:
                    self._flag("V-SCHEMA", n,
                               f"group var ?{v} not produced by its input")
            for a in n.aggs:
                if a.var is not None and a.var not in cv:
                    self._flag("V-SCHEMA", n,
                               f"aggregate input ?{a.var} not produced by its input")
        elif isinstance(n, PL.PDistinct):
            if (n.streaming_var is not None
                    and n.streaming_var not in PL.phys_vars(n.child)):
                self._flag("V-SCHEMA", n,
                           f"streaming var ?{n.streaming_var} not produced "
                           "by its input")
        elif isinstance(n, PL.PSlice):
            if n.offset < 0 or (n.limit is not None and n.limit < 0):
                self._flag("V-SCHEMA", n,
                           f"negative slice bounds limit={n.limit} "
                           f"offset={n.offset}")

    def _check_sorted(self, n: PL.Phys) -> None:
        """Sortedness claims vs consumer requirements: a merge join or
        streaming group/distinct over an input that is *not* actually
        sorted by the claimed variable produces silently wrong results."""
        if isinstance(n, PL.PMergeJoin):
            for side, sub in (("left", n.left), ("right", n.right)):
                sb = PL.phys_sorted_by(sub)
                if sb != n.var:
                    self._flag("V-SORT", n,
                               f"{side} input is sorted by "
                               f"{'nothing' if sb is None else '?%d' % sb}, "
                               f"but the merge join needs ?{n.var}")
        elif isinstance(n, PL.PGroup) and n.streaming and n.group_vars:
            if len(n.group_vars) != 1:
                self._flag("V-SORT", n,
                           "streaming grouping claims "
                           f"{len(n.group_vars)} group vars; only a single "
                           "sorted var can stream")
            elif PL.phys_sorted_by(n.child) != n.group_vars[0]:
                self._flag("V-SORT", n,
                           f"streaming grouping on ?{n.group_vars[0]} over an "
                           "input not sorted by it")
        elif isinstance(n, PL.PDistinct) and n.streaming_var is not None:
            if PL.phys_sorted_by(n.child) != n.streaming_var:
                self._flag("V-SORT", n,
                           f"streaming distinct on ?{n.streaming_var} over an "
                           "input not sorted by it")

    def _check_grace(self, n: PL.Phys) -> None:
        """Grace (partitioned / out-of-core) marks only where the budget
        walk's gating permits: a grace mark on an ineligible shape lowers
        to an operator that can't honor it (DESIGN.md §15)."""
        if isinstance(n, PL.PHashJoin) and n.grace:
            if not n.keys:
                self._flag("V-GRACE", n,
                           "grace build on a key-less (degenerate) hash join")
            if n.grace_parts < 2:
                self._flag("V-GRACE", n,
                           f"grace build with grace_parts={n.grace_parts} (< 2)")
        elif isinstance(n, PL.PGroup) and n.grace:
            if not n.group_vars:
                self._flag("V-GRACE", n, "partitioned grouping without group vars")
            if n.streaming:
                self._flag("V-GRACE", n,
                           "grace and streaming are mutually exclusive: "
                           "sorted runs reduce in-place without a budget")
            if n.grace_parts < 2:
                self._flag("V-GRACE", n,
                           f"partitioned grouping with grace_parts={n.grace_parts}")
        elif isinstance(n, PL.PDistinct) and n.grace:
            if n.streaming_var is not None:
                self._flag("V-GRACE", n,
                           "grace and streaming distinct are mutually exclusive")
            if n.grace_parts < 2:
                self._flag("V-GRACE", n,
                           f"partitioned distinct with grace_parts={n.grace_parts}")

    # -- adaptive-join gating (mirror of Planner._mark_adaptive) -------------

    def _check_adaptive(self, n: PL.Phys, order_needed: bool) -> None:
        """adaptive_ok only where NO ancestor consumes the join's output
        order — re-derived top-down, independently of the planner's walk."""
        if isinstance(n, PL.PMergeJoin):
            if n.adaptive_ok and order_needed:
                self._flag("V-ADAPTIVE", n,
                           "adaptive_ok on a merge join whose output order an "
                           "ancestor consumes; a mid-plan merge->hash switch "
                           "would break that consumer")
            self._check_adaptive(n.left, True)
            self._check_adaptive(n.right, True)
            return
        if isinstance(n, (PL.PSort, PL.POrderBy)):
            self._check_adaptive(n.child, False)
            return
        if isinstance(n, PL.PGroup):
            self._check_adaptive(n.child, n.streaming)
            return
        if isinstance(n, PL.PDistinct):
            self._check_adaptive(n.child, n.streaming_var is not None)
            return
        if isinstance(n, (PL.PFilter, PL.PHaving, PL.PProject, PL.PExtend,
                          PL.PSlice)):
            self._check_adaptive(n.child, order_needed)
            return
        if isinstance(n, (PL.PHashJoin, PL.PLookupJoin)):
            self._check_adaptive(n.probe, order_needed)
            self._check_adaptive(n.build, False)
            return
        if isinstance(n, (PL.PCross, PL.PUnion)):
            self._check_adaptive(n.left, False)
            self._check_adaptive(n.right, False)
            return
        for c in _children(n):
            self._check_adaptive(c, True)

    # -- SIP soundness (mirror of Planner._push_sip) -------------------------

    def _collect_sip(self, n: PL.Phys) -> None:
        if isinstance(n, (PL.PScan, PL.PPathExpand)):
            for ann in n.sip:
                self._consumers.setdefault(ann.sid, []).append(n)
        for ann in getattr(n, "sip_exports", ()):
            if ann.sid in self._exports:
                self._flag("V-SIP", n,
                           f"sip #{ann.sid} exported twice")
            self._exports[ann.sid] = n

    def _sound_leaves(self, n: PL.Phys, var: int, acc: Set[int]) -> None:
        """ids of leaves a prefilter on ``var`` may soundly reach from
        ``n`` — the read-only mirror of the planner's _push_sip descent."""
        if isinstance(n, (PL.PScan, PL.PPathExpand)):
            if var in n.pattern.vars():
                acc.add(id(n))
            return
        if isinstance(n, (PL.PSort, PL.PFilter, PL.PHaving, PL.PDistinct,
                          PL.POrderBy)):
            self._sound_leaves(n.child, var, acc)
            return
        if isinstance(n, PL.PExtend):
            if var != n.var:
                self._sound_leaves(n.child, var, acc)
            return
        if isinstance(n, PL.PProject):
            if var in n.vars:
                self._sound_leaves(n.child, var, acc)
            return
        if isinstance(n, PL.PGroup):
            if var in n.group_vars:
                self._sound_leaves(n.child, var, acc)
            return
        if isinstance(n, (PL.PUnion, PL.PCross)):
            self._sound_leaves(n.left, var, acc)
            self._sound_leaves(n.right, var, acc)
            return
        if isinstance(n, PL.PMergeJoin):
            if n.mode == "inner":
                self._sound_leaves(n.left, var, acc)
                self._sound_leaves(n.right, var, acc)
            elif n.mode in ("semi", "anti", "left_outer"):
                self._sound_leaves(n.left, var, acc)
            return
        if isinstance(n, (PL.PHashJoin, PL.PLookupJoin)):
            if n.mode == "inner":
                self._sound_leaves(n.probe, var, acc)
                self._sound_leaves(n.build, var, acc)
            elif n.mode in ("semi", "anti", "left_outer"):
                self._sound_leaves(n.probe, var, acc)
            return
        # PSlice / PPathScan: a prefilter must never cross (pruning below a
        # LIMIT changes which rows survive it)

    def _check_sip(self) -> None:
        for sid, leaves in self._consumers.items():
            join = self._exports.get(sid)
            if join is None:
                for leaf in leaves:
                    self._flag("V-SIP", leaf,
                               f"consumes sip #{sid} that no join exports; "
                               "the prefilter would wait forever")
                continue
            ann = next(a for a in join.sip_exports if a.sid == sid)
            if join.mode not in ("inner", "semi"):
                self._flag("V-SIP", join,
                           f"sip #{sid} exported from a {join.mode} join; "
                           "only inner/semi build sides are summarizable")
            if isinstance(join, PL.PHashJoin):
                if ann.var not in join.keys:
                    self._flag("V-SIP", join,
                               f"sip #{sid} on ?{ann.var}, which is not a "
                               "join key")
                probe_side = join.probe
            else:  # PMergeJoin
                if ann.var != join.var:
                    self._flag("V-SIP", join,
                               f"sip #{sid} on ?{ann.var}, but the merge "
                               f"join key is ?{join.var}")
                exportable = isinstance(join.right, PL.PSort) or (
                    isinstance(join.right, PL.PScan)
                    and join.right.sort_var == join.var
                )
                if not exportable:
                    self._flag("V-SIP", join,
                               f"sip #{sid} summarizes a build side that is "
                               "neither a Sort nor a sorted scan — nothing "
                               "materializes the summary")
                probe_side = join.left
            sound: Set[int] = set()
            self._sound_leaves(probe_side, ann.var, sound)
            for leaf in leaves:
                if id(leaf) not in sound:
                    self._flag("V-SIP", leaf,
                               f"carries sip #{sid} outside the exporting "
                               "join's sound (probe/left) region — pruning "
                               "here can drop surviving rows")
        for sid, join in self._exports.items():
            if sid not in self._consumers:
                self._flag("V-SIP", join,
                           f"exports sip #{sid} that no leaf consumes")


def verify_plan(plan: PL.Phys, collect: bool = False) -> List[PlanDiagnostic]:
    """Verify a physical plan. Returns the diagnostics list; unless
    ``collect`` is set, any finding raises ``PlanInvariantError`` naming
    the first offending node."""
    diags = PlanVerifier(plan).verify()
    if diags and not collect:
        head = diags[0]
        more = f" (+{len(diags) - 1} more)" if len(diags) > 1 else ""
        raise PlanInvariantError(head.render() + more)
    return diags
