"""SPARQL algebra: logical plan nodes + expression AST (paper §2.1).

The optimizer rewrites and orders these nodes; the translator
(`core/executor.py`) turns them into BARQ or legacy operator trees. The
node set covers the subset scoped in DESIGN.md §7 — BGPs, FILTER, OPTIONAL,
UNION, MINUS, DISTINCT, GROUP BY/aggregates, ORDER BY, LIMIT/OFFSET,
projection and BIND.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.dictionary import Term

# ---------------------------------------------------------------------------
# variables
# ---------------------------------------------------------------------------


class VarTable:
    """Query-scoped variable name <-> dense id interning (paper Fig. 3:
    'variables are also represented by IDs during execution')."""

    def __init__(self) -> None:
        self.name_to_id: Dict[str, int] = {}
        self.id_to_name: List[str] = []

    def var(self, name: str) -> int:
        name = name.lstrip("?")
        vid = self.name_to_id.get(name)
        if vid is None:
            vid = len(self.id_to_name)
            self.name_to_id[name] = vid
            self.id_to_name.append(name)
        return vid

    def name(self, vid: int) -> str:
        return self.id_to_name[vid]

    def fresh(self, hint: str = "_v") -> int:
        i = 0
        while f"{hint}{i}" in self.name_to_id:
            i += 1
        return self.var(f"{hint}{i}")


# ---------------------------------------------------------------------------
# expressions (FILTER / BIND / HAVING)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VarRef:
    var: int


@dataclasses.dataclass(frozen=True)
class Lit:
    value: Term


@dataclasses.dataclass(frozen=True)
class Cmp:
    op: str  # '=', '!=', '<', '<=', '>', '>='
    lhs: "Expr"
    rhs: "Expr"


@dataclasses.dataclass(frozen=True)
class Arith:
    op: str  # '+', '-', '*', '/'
    lhs: "Expr"
    rhs: "Expr"


@dataclasses.dataclass(frozen=True)
class And:
    terms: Tuple["Expr", ...]


@dataclasses.dataclass(frozen=True)
class Or:
    terms: Tuple["Expr", ...]


@dataclasses.dataclass(frozen=True)
class Not:
    term: "Expr"


@dataclasses.dataclass(frozen=True)
class Bound:
    var: int


# SPARQL 1.1 builtin calls (FILTER/BIND function grammar). ``name`` is the
# lower-cased function name; the supported surface is FUNC_ARITIES below.
# String/term-classification predicates are evaluated in the *dictionary
# domain* by the expression VM (once per distinct term, broadcast per row;
# DESIGN.md §9) — Func keeps them first-class in the algebra so the planner
# can compile them like any other expression node.
@dataclasses.dataclass(frozen=True)
class Func:
    name: str  # 'if', 'coalesce', 'in', 'sameterm', 'isnumeric', ...
    args: Tuple["Expr", ...]


# name -> (min_args, max_args or None for variadic)
FUNC_ARITIES = {
    "if": (3, 3),
    "coalesce": (1, None),
    "in": (2, None),  # args[0] IN args[1:]
    "sameterm": (2, 2),
    "isnumeric": (1, 1),
    "isiri": (1, 1),
    "isliteral": (1, 1),
    "strstarts": (2, 2),
    "strends": (2, 2),
    "contains": (2, 2),
    "regex": (2, 3),
}


Expr = Union[VarRef, Lit, Cmp, Arith, And, Or, Not, Bound, Func]


def expr_vars(e: Expr) -> Tuple[int, ...]:
    if isinstance(e, VarRef):
        return (e.var,)
    if isinstance(e, Bound):
        return (e.var,)
    if isinstance(e, (Cmp, Arith)):
        return tuple(dict.fromkeys(expr_vars(e.lhs) + expr_vars(e.rhs)))
    if isinstance(e, (And, Or)):
        out: Tuple[int, ...] = ()
        for t in e.terms:
            out = out + expr_vars(t)
        return tuple(dict.fromkeys(out))
    if isinstance(e, Not):
        return expr_vars(e.term)
    if isinstance(e, Func):
        out = ()
        for a in e.args:
            out = out + expr_vars(a)
        return tuple(dict.fromkeys(out))
    return ()


# Func names whose evaluation never leaves the dictionary-code domain:
# term tests run over the per-term table, IN/sameTerm compare codes.
_CODE_FUNCS = frozenset(
    ("in", "sameterm", "isnumeric", "isiri", "isliteral",
     "strstarts", "strends", "contains", "regex")
)


def is_code_only(e: Expr) -> bool:
    """True if the expression can be evaluated purely over dictionary codes
    (equality/inequality between vars or var-vs-constant, term tests and
    dictionary-domain string predicates) — the fast path the paper
    highlights (§2.2.1: joins/hashing/sorting run over numbers)."""
    if isinstance(e, Cmp) and e.op in ("=", "!="):
        ok_l = isinstance(e.lhs, (VarRef, Lit))
        ok_r = isinstance(e.rhs, (VarRef, Lit))
        return ok_l and ok_r
    if isinstance(e, (And, Or)):
        return all(is_code_only(t) for t in e.terms)
    if isinstance(e, Not):
        return is_code_only(e.term)
    if isinstance(e, Bound):
        return True
    if isinstance(e, Func) and e.name in _CODE_FUNCS:
        return all(isinstance(a, (VarRef, Lit)) for a in e.args)
    return False


# ---------------------------------------------------------------------------
# triple patterns & plan nodes
# ---------------------------------------------------------------------------

# a slot is either a Var id wrapped or a constant term
@dataclasses.dataclass(frozen=True)
class V:  # variable slot
    id: int


@dataclasses.dataclass(frozen=True)
class K:  # constant slot
    term: Term


Slot = Union[V, K]


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    s: Slot
    p: Slot
    o: Slot
    g: Optional[Slot] = None
    # legacy property-path modifier: "" (plain) or "+". Kept for
    # compatibility with older plans; the parser now emits PathPattern
    # nodes for every non-trivial path (DESIGN.md §8).
    path: str = ""


    def slots(self) -> Tuple[Slot, ...]:
        return (self.s, self.p, self.o) + ((self.g,) if self.g else ())

    def vars(self) -> Tuple[int, ...]:
        return tuple(
            dict.fromkeys(sl.id for sl in self.slots() if isinstance(sl, V))
        )


@dataclasses.dataclass(frozen=True)
class PathPattern:
    """A property-path pattern ``s path o`` (SPARQL 1.1 §9): endpoints are
    slots, the predicate position holds a compiled path expression
    (repro_torch.core.paths.expr). Lives alongside TriplePattern inside BGPs so
    the planner's join ordering sees paths as ordinary joinable leaves."""

    s: Slot
    expr: object  # paths.expr.PathExpr (kept loose to avoid an import cycle)
    o: Slot

    def slots(self) -> Tuple[Slot, ...]:
        return (self.s, self.o)

    def vars(self) -> Tuple[int, ...]:
        return tuple(
            dict.fromkeys(sl.id for sl in self.slots() if isinstance(sl, V))
        )


@dataclasses.dataclass
class PlanNode:
    pass


@dataclasses.dataclass
class BGP(PlanNode):
    patterns: List[TriplePattern]


@dataclasses.dataclass
class Join(PlanNode):
    left: PlanNode
    right: PlanNode


@dataclasses.dataclass
class LeftJoin(PlanNode):  # OPTIONAL
    left: PlanNode
    right: PlanNode
    expr: Optional[Expr] = None


@dataclasses.dataclass
class Minus(PlanNode):
    left: PlanNode
    right: PlanNode


@dataclasses.dataclass
class NotExists(PlanNode):
    """FILTER NOT EXISTS { ... } — an anti-semi-join, kept distinct from
    Minus because the two diverge when ``right`` shares no variables with
    ``left`` (SPARQL §8.3.3): MINUS keeps every left row (nothing is
    compatible), NOT EXISTS removes *all* left rows as soon as the inner
    pattern has any solution. The planner lowers the disjoint case onto
    the degenerate constant-key anti hash join."""

    left: PlanNode
    right: PlanNode


@dataclasses.dataclass
class Union(PlanNode):
    left: PlanNode
    right: PlanNode


@dataclasses.dataclass
class Filter(PlanNode):
    expr: Expr
    child: PlanNode


@dataclasses.dataclass
class Extend(PlanNode):  # BIND (expr AS ?v)
    var: int
    expr: Expr
    child: PlanNode


@dataclasses.dataclass
class Project(PlanNode):
    vars: List[int]
    child: PlanNode


@dataclasses.dataclass
class Distinct(PlanNode):
    child: PlanNode


@dataclasses.dataclass(frozen=True)
class AggSpec:
    func: str  # 'count', 'sum', 'min', 'max', 'avg'
    var: Optional[int]  # None => COUNT(*)
    distinct: bool
    out: int  # output var id


@dataclasses.dataclass
class GroupAgg(PlanNode):
    """GROUP BY + aggregates. ``having`` is the (optional) HAVING
    constraint, evaluated over the aggregate output; aggregate calls inside
    it are desugared by the parser to hidden AggSpecs in ``aggs`` whose out
    vars the condition references (DESIGN.md §10)."""

    group_vars: List[int]
    aggs: List[AggSpec]
    child: PlanNode
    having: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class SortKey:
    var: int
    ascending: bool = True


@dataclasses.dataclass
class OrderBy(PlanNode):
    keys: List[SortKey]
    child: PlanNode


@dataclasses.dataclass
class Slice(PlanNode):
    child: PlanNode
    limit: Optional[int] = None
    offset: int = 0


def plan_vars(node: PlanNode) -> Tuple[int, ...]:
    """Visible variables produced by a plan node."""
    if isinstance(node, BGP):
        out: Tuple[int, ...] = ()
        for p in node.patterns:
            out += p.vars()
        return tuple(dict.fromkeys(out))
    if isinstance(node, (Join, Union)):
        return tuple(dict.fromkeys(plan_vars(node.left) + plan_vars(node.right)))
    if isinstance(node, LeftJoin):
        return tuple(dict.fromkeys(plan_vars(node.left) + plan_vars(node.right)))
    if isinstance(node, (Minus, NotExists)):
        return plan_vars(node.left)
    if isinstance(node, (Filter, Distinct)):
        return plan_vars(node.child)
    if isinstance(node, Extend):
        return tuple(dict.fromkeys(plan_vars(node.child) + (node.var,)))
    if isinstance(node, Project):
        return tuple(node.vars)
    if isinstance(node, GroupAgg):
        return tuple(node.group_vars) + tuple(a.out for a in node.aggs)
    if isinstance(node, (OrderBy, Slice)):
        return plan_vars(node.child)
    raise TypeError(f"unknown plan node {type(node)}")
