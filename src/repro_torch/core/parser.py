"""Recursive-descent parser for the SPARQL subset scoped in DESIGN.md §7.

Supports: SELECT (DISTINCT) with projection / aggregates / expressions-as,
WHERE groups with triple patterns (',' ';' '.' shorthand), property paths
(`+` `*` `?` `^` `/` `|` with parentheses, SPARQL 1.1 §9), FILTER,
OPTIONAL, MINUS, UNION, BIND, GROUP BY, ORDER BY (ASC/DESC), LIMIT/OFFSET,
and the 'a' keyword for rdf:type. Terms: prefixed names (:p, rdf:type),
<iri>, numeric literals, "string" literals. Produces the algebra of
repro_torch.core.algebra; non-trivial paths become A.PathPattern nodes carrying
a repro_torch.core.paths.expr AST.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple, Union

from repro_torch.core import algebra as A
from repro_torch.core.paths.expr import PAlt, PathExpr, PClosure, PInv, PLink, PSeq

_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+|\#[^\n]*)
  | (?P<IRI><[^>]*>)
  | (?P<STRING>"(?:[^"\\]|\\.)*")
  | (?P<NUM>[+-]?\d+\.\d*(?:[eE][+-]?\d+)?|[+-]?\.?\d+(?:[eE][+-]?\d+)?)
  | (?P<VAR>[?$][A-Za-z_][A-Za-z0-9_]*)
  | (?P<PNAME>[A-Za-z_][A-Za-z0-9_\-]*)?:(?:[A-Za-z0-9_\-.]*[A-Za-z0-9_\-])?
  | (?P<KW>[A-Za-z][A-Za-z0-9_]*)
  | (?P<OP>\|\||&&|!=|<=|>=|[{}().,;*/+\-=<>!^?|])
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "distinct", "where", "filter", "optional", "minus", "union",
    "bind", "as", "group", "by", "order", "asc", "desc", "limit", "offset",
    "count", "sum", "min", "max", "avg", "a", "bound", "having", "not", "exists",
    # builtin calls (algebra.Func; evaluated by the expression VM, §9)
    "if", "coalesce", "in", "sameterm", "isnumeric", "isiri", "isliteral",
    "strstarts", "strends", "contains", "regex",
}


class Token:
    def __init__(self, kind: str, value: str, pos: int):
        self.kind = kind
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(text: str) -> List[Token]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize at {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "WS":
            continue
        val = m.group()
        if kind == "KW" and val.lower() not in _KEYWORDS:
            # bare word in term position — treat as prefixed name w/o colon
            kind = "PNAME"
        out.append(Token(kind or "PNAME", val, m.start()))
    out.append(Token("EOF", "", len(text)))
    return out


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0
        self.vt = A.VarTable()
        # inside a HAVING constraint, aggregate calls are legal expression
        # primaries; they desugar to (possibly hidden) AggSpecs collected
        # here and referenced by their out var (DESIGN.md §10)
        self._agg_specs: Optional[List[A.AggSpec]] = None
        self._hidden_aggs: List[A.AggSpec] = []

    # -- token helpers ------------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, word: str) -> bool:
        t = self.peek()
        if t.kind == "KW" and t.value.lower() == word:
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            raise SyntaxError(f"expected {word.upper()} at {self.peek().value!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "OP" and t.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SyntaxError(f"expected {op!r} at {self.peek().value!r}")

    # -- entry --------------------------------------------------------------------

    def parse(self) -> Tuple[A.PlanNode, A.VarTable]:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        proj_vars: List[int] = []
        aggs: List[A.AggSpec] = []
        binds: List[Tuple[int, A.Expr]] = []
        select_all = False
        while True:
            t = self.peek()
            if t.kind == "VAR":
                proj_vars.append(self.vt.var(self.next().value))
            elif t.kind == "OP" and t.value == "*":
                self.next()
                select_all = True
            elif t.kind == "OP" and t.value == "(":
                self.next()
                agg = self._try_aggregate()
                if agg is not None:
                    func, var, dist = agg
                    self.expect_kw("as")
                    out = self.vt.var(self.next().value)
                    aggs.append(A.AggSpec(func, var, dist, out))
                    proj_vars.append(out)
                else:
                    e = self._expr()
                    self.expect_kw("as")
                    out = self.vt.var(self.next().value)
                    binds.append((out, e))
                    proj_vars.append(out)
                self.expect_op(")")
            else:
                break
        self.accept_kw("where")
        body = self._group_graph_pattern()

        group_vars: List[int] = []
        group_binds: List[Tuple[int, A.Expr]] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            while True:
                if self.peek().kind == "VAR":
                    group_vars.append(self.vt.var(self.next().value))
                elif self.peek().kind == "OP" and self.peek().value == "(":
                    # GROUP BY (expr AS ?v): desugars to BIND + var key, so
                    # the grouping key runs through the expression VM
                    self.next()
                    e = self._expr()
                    self.expect_kw("as")
                    v = self.vt.var(self.next().value)
                    self.expect_op(")")
                    group_binds.append((v, e))
                    group_vars.append(v)
                else:
                    break

        # HAVING (SPARQL 1.1 §11): one or more parenthesized constraints
        # over the aggregate output, implicitly AND-ed. Aggregate calls in
        # the constraints desugar to hidden AggSpecs (see _primary).
        having: Optional[A.Expr] = None
        if self.accept_kw("having"):
            self._agg_specs = aggs
            constraints: List[A.Expr] = []
            while self.peek().kind == "OP" and self.peek().value == "(":
                self.expect_op("(")
                constraints.append(self._expr())
                self.expect_op(")")
            self._agg_specs = None
            if not constraints:
                raise SyntaxError(
                    f"HAVING requires a parenthesized constraint at "
                    f"{self.peek().value!r}"
                )
            having = (
                constraints[0] if len(constraints) == 1
                else A.And(tuple(constraints))
            )

        # ORDER BY keys are full expressions (ASC/DESC(expr) or a bare
        # var); expression keys desugar to a BIND below
        order_specs: List[Tuple[A.Expr, bool]] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                if self.accept_kw("asc") or self.accept_kw("desc"):
                    asc = self.toks[self.i - 1].value.lower() == "asc"
                    self.expect_op("(")
                    order_specs.append((self._expr(), asc))
                    self.expect_op(")")
                elif self.peek().kind == "VAR":
                    order_specs.append(
                        (A.VarRef(self.vt.var(self.next().value)), True)
                    )
                else:
                    break

        limit = offset = None
        # LIMIT/OFFSET in any order
        for _ in range(2):
            if self.accept_kw("limit"):
                limit = int(self.next().value)
            elif self.accept_kw("offset"):
                offset = int(self.next().value)

        node: A.PlanNode = body
        for out, e in binds:
            node = A.Extend(out, e, node)
        for v, e in group_binds:
            node = A.Extend(v, e, node)
        if having is not None:
            # SPARQL §18.2.4.4: HAVING sees only the group keys and
            # aggregate results — anything else must fail at parse time,
            # not as an internal error downstream
            allowed = (
                set(group_vars)
                | {a.out for a in aggs}
                | {a.out for a in self._hidden_aggs}
            )
            for v in A.expr_vars(having):
                if v not in allowed:
                    raise SyntaxError(
                        "HAVING may only reference group variables or "
                        f"aggregates; ?{self.vt.name(v)} is neither"
                    )
        if aggs or group_vars or having is not None:
            # grouping projects only its keys and aggregate results —
            # anything else fails here, not as an internal error downstream
            visible = set(group_vars) | {a.out for a in aggs}
            for v in proj_vars:
                if v not in visible:
                    raise SyntaxError(
                        f"SELECT variable ?{self.vt.name(v)} must be a "
                        "GROUP BY key or an aggregate result when "
                        "grouping is used"
                    )
            # hidden HAVING aggregates ride along in the spec list; the
            # final projection below strips their out columns
            node = A.GroupAgg(group_vars, aggs + self._hidden_aggs, node, having)
            if not proj_vars:
                proj_vars = group_vars + [a.out for a in aggs]
        if select_all or not proj_vars:
            hidden = {a.out for a in self._hidden_aggs}
            proj_vars = [v for v in A.plan_vars(node) if v not in hidden]
        order_keys: List[A.SortKey] = []
        order_binds: List[Tuple[int, A.Expr]] = []
        for e, asc in order_specs:
            if isinstance(e, A.VarRef):
                order_keys.append(A.SortKey(e.var, asc))
            else:
                v = self.vt.fresh("_ord")
                order_binds.append((v, e))
                order_keys.append(A.SortKey(v, asc))
        if order_binds and not distinct:
            # expression keys may reference non-projected vars: BIND the
            # key below the projection, carry it (and any non-projected
            # bare key vars) through, strip with a final re-projection
            for v, e in order_binds:
                node = A.Extend(v, e, node)
            carry = list(proj_vars)
            for k in order_keys:
                if k.var not in carry:
                    carry.append(k.var)
            node = A.Project(carry, node)
            node = A.OrderBy(order_keys, node)
            node = A.Project(proj_vars, node)
        else:
            if order_binds:
                # SPARQL: with DISTINCT, ORDER BY may only use projected
                # expressions — the keys are computed after dedup
                avail = set(proj_vars)
                for _, e in order_binds:
                    missing = [x for x in A.expr_vars(e) if x not in avail]
                    if missing:
                        raise SyntaxError(
                            "ORDER BY expressions under DISTINCT may only "
                            "use projected variables; "
                            f"?{self.vt.name(missing[0])} is not projected"
                        )
            node = A.Project(proj_vars, node)
            if distinct:
                node = A.Distinct(node)
            if order_binds:
                for v, e in order_binds:
                    node = A.Extend(v, e, node)
                node = A.OrderBy(order_keys, node)
                node = A.Project(proj_vars, node)
            elif order_keys:
                node = A.OrderBy(order_keys, node)
        if limit is not None or offset is not None:
            node = A.Slice(node, limit, offset or 0)
        if self.peek().kind != "EOF":
            raise SyntaxError(f"trailing input at {self.peek().value!r}")
        return node, self.vt

    def _try_aggregate(self) -> Optional[Tuple[str, Optional[int], bool]]:
        t = self.peek()
        if t.kind == "KW" and t.value.lower() in ("count", "sum", "min", "max", "avg"):
            func = self.next().value.lower()
            self.expect_op("(")
            dist = self.accept_kw("distinct")
            if self.accept_op("*"):
                if dist:
                    # would require whole-solution dedup, which no engine
                    # implements — reject instead of silently answering
                    # with the plain row count
                    raise SyntaxError(
                        "COUNT(DISTINCT *) is not supported; count a "
                        "specific variable instead"
                    )
                var = None
            else:
                var = self.vt.var(self.next().value)
            self.expect_op(")")
            return func, var, dist
        return None

    # -- graph patterns ----------------------------------------------------------------

    def _group_graph_pattern(self) -> A.PlanNode:
        self.expect_op("{")
        node: Optional[A.PlanNode] = None
        triples: List[A.TriplePattern] = []
        filters: List[A.Expr] = []

        def flush() -> None:
            nonlocal node, triples
            if triples:
                bgp = A.BGP(triples)
                node = bgp if node is None else A.Join(node, bgp)
                triples = []

        while not self.accept_op("}"):
            t = self.peek()
            if t.kind == "KW" and t.value.lower() == "filter":
                self.next()
                if self.accept_kw("not"):
                    self.expect_kw("exists")
                    flush()
                    sub = self._group_graph_pattern()
                    # NOT EXISTS is an anti-semi-join, NOT a MINUS: the two
                    # diverge when the inner pattern shares no variables
                    # with the outer group (SPARQL §8.3.3)
                    node = A.NotExists(node, sub) if node is not None else sub
                else:
                    self.expect_op("(")
                    filters.append(self._expr())
                    self.expect_op(")")
            elif t.kind == "KW" and t.value.lower() == "optional":
                self.next()
                flush()
                sub = self._group_graph_pattern()
                # SPARQL: a FILTER inside OPTIONAL is the left-join
                # *condition* (it may reference left-side vars), not a
                # filter on the optional pattern alone
                expr = None
                if isinstance(sub, A.Filter):
                    expr, sub = sub.expr, sub.child
                node = (
                    A.LeftJoin(node, sub, expr) if node is not None else sub
                )
            elif t.kind == "KW" and t.value.lower() == "minus":
                self.next()
                flush()
                sub = self._group_graph_pattern()
                node = A.Minus(node, sub) if node is not None else sub
            elif t.kind == "KW" and t.value.lower() == "bind":
                self.next()
                self.expect_op("(")
                e = self._expr()
                self.expect_kw("as")
                v = self.vt.var(self.next().value)
                self.expect_op(")")
                flush()
                base = node if node is not None else A.BGP([])
                node = A.Extend(v, e, base)
            elif t.kind == "OP" and t.value == "{":
                flush()
                sub = self._group_graph_pattern()
                while self.accept_kw("union"):
                    sub2 = self._group_graph_pattern()
                    sub = A.Union(sub, sub2)
                node = sub if node is None else A.Join(node, sub)
            else:
                triples.extend(self._triples_same_subject())
                self.accept_op(".")
        flush()
        if node is None:
            node = A.BGP([])
        for f in filters:
            node = A.Filter(f, node)
        return node

    def _triples_same_subject(self) -> List[Union[A.TriplePattern, A.PathPattern]]:
        s = self._slot()
        out: List[Union[A.TriplePattern, A.PathPattern]] = []
        while True:
            p_slot, p_expr = self._predicate()
            while True:
                o = self._slot()
                if p_expr is not None:
                    out.append(A.PathPattern(s, p_expr, o))
                else:
                    out.append(A.TriplePattern(s, p_slot, o))
                if not self.accept_op(","):
                    break
            if not self.accept_op(";"):
                break
            if self.peek().kind == "OP" and self.peek().value in (".", "}"):
                break
        return out

    # -- property paths (SPARQL 1.1 §9) ------------------------------------------

    _PATH_OPS = ("+", "*", "?", "/", "|", "^")

    def _predicate(self) -> Tuple[Optional[A.Slot], Optional[PathExpr]]:
        """Parse the predicate position: (slot, None) for a plain predicate
        or variable, (None, expr) for a non-trivial property path."""
        t = self.peek()
        if t.kind == "VAR":
            self.next()
            nxt = self.peek()
            if nxt.kind == "OP" and nxt.value in self._PATH_OPS:
                raise SyntaxError(
                    "property paths require a constant predicate; found "
                    f"path operator {nxt.value!r} after variable {t.value!r}"
                )
            return A.V(self.vt.var(t.value)), None
        if t.kind in ("NUM", "STRING"):  # odd but previously accepted
            return self._slot(predicate=True), None
        expr = self._path_alt()
        if isinstance(expr, PLink):
            return A.K(expr.pred), None
        return None, expr

    def _path_alt(self) -> PathExpr:
        parts = [self._path_seq()]
        while self.accept_op("|"):
            parts.append(self._path_seq())
        return parts[0] if len(parts) == 1 else PAlt(tuple(parts))

    def _path_seq(self) -> PathExpr:
        parts = [self._path_step()]
        while self.accept_op("/"):
            parts.append(self._path_step())
        return parts[0] if len(parts) == 1 else PSeq(tuple(parts))

    def _path_step(self) -> PathExpr:
        if self.accept_op("^"):
            return PInv(self._path_elt())
        return self._path_elt()

    def _path_elt(self) -> PathExpr:
        prim = self._path_primary()
        if self.accept_op("+"):
            return PClosure(prim, min_hops=1)
        if self.accept_op("*"):
            return PClosure(prim, min_hops=0)
        if self.accept_op("?"):
            return PClosure(prim, min_hops=0, max_hops=1)
        return prim

    def _path_primary(self) -> PathExpr:
        t = self.peek()
        if t.kind == "OP" and t.value == "(":
            self.next()
            e = self._path_alt()
            self.expect_op(")")
            return e
        if t.kind == "KW" and t.value == "a":
            self.next()
            return PLink("rdf:type")
        if t.kind in ("PNAME", "IRI"):
            return PLink(self.next().value)
        if t.kind == "VAR":
            raise SyntaxError(
                "property paths require a constant predicate; found "
                f"variable {t.value!r} inside a path"
            )
        raise SyntaxError(f"expected a predicate or path at {t.value!r}")

    def _slot(self, predicate: bool = False) -> A.Slot:
        t = self.next()
        if t.kind == "VAR":
            return A.V(self.vt.var(t.value))
        if t.kind == "KW" and t.value == "a" and predicate:
            return A.K("rdf:type")
        if t.kind in ("PNAME", "IRI"):
            return A.K(t.value)
        if t.kind == "NUM":
            v = float(t.value)
            return A.K(int(v) if v.is_integer() else v)
        if t.kind == "STRING":
            return A.K(t.value)
        raise SyntaxError(f"unexpected term {t.value!r}")

    # -- expressions ----------------------------------------------------------------

    def _expr(self) -> A.Expr:
        return self._or()

    def _or(self) -> A.Expr:
        terms = [self._and()]
        while self.accept_op("||"):
            terms.append(self._and())
        return terms[0] if len(terms) == 1 else A.Or(tuple(terms))

    def _and(self) -> A.Expr:
        terms = [self._cmp()]
        while self.accept_op("&&"):
            terms.append(self._cmp())
        return terms[0] if len(terms) == 1 else A.And(tuple(terms))

    def _cmp(self) -> A.Expr:
        lhs = self._add()
        t = self.peek()
        if t.kind == "OP" and t.value in ("=", "!=", "<", "<=", ">", ">="):
            op = self.next().value
            rhs = self._add()
            return A.Cmp(op, lhs, rhs)
        if self.accept_kw("in"):
            return A.Func("in", (lhs,) + self._in_list())
        if (
            t.kind == "KW" and t.value.lower() == "not"
            and self.peek(1).kind == "KW" and self.peek(1).value.lower() == "in"
        ):
            self.next()
            self.next()
            return A.Not(A.Func("in", (lhs,) + self._in_list()))
        return lhs

    def _in_list(self) -> Tuple[A.Expr, ...]:
        self.expect_op("(")
        args = [self._expr()]
        while self.accept_op(","):
            args.append(self._expr())
        self.expect_op(")")
        return tuple(args)

    def _add(self) -> A.Expr:
        lhs = self._mul()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("+", "-"):
                op = self.next().value
                lhs = A.Arith(op, lhs, self._mul())
            else:
                return lhs

    def _mul(self) -> A.Expr:
        lhs = self._unary()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("*", "/"):
                op = self.next().value
                lhs = A.Arith(op, lhs, self._unary())
            else:
                return lhs

    def _unary(self) -> A.Expr:
        if self.accept_op("!"):
            return A.Not(self._unary())
        return self._primary()

    def _primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "OP" and t.value == "(":
            self.next()
            e = self._expr()
            self.expect_op(")")
            return e
        if self._agg_specs is not None and t.kind == "KW" and t.value.lower() in (
            "count", "sum", "min", "max", "avg"
        ):
            # aggregate call inside HAVING: reuse a matching SELECT-clause
            # spec (so `HAVING (SUM(?v) > k)` and `(SUM(?v) AS ?s)` share
            # one accumulator) or add a hidden spec with a fresh out var
            func, var, dist = self._try_aggregate()
            for a in self._agg_specs + self._hidden_aggs:
                if (a.func, a.var, a.distinct) == (func, var, dist):
                    return A.VarRef(a.out)
            out = self.vt.fresh("_agg")
            self._hidden_aggs.append(A.AggSpec(func, var, dist, out))
            return A.VarRef(out)
        if t.kind == "KW" and t.value.lower() == "bound":
            self.next()
            self.expect_op("(")
            v = self.vt.var(self.next().value)
            self.expect_op(")")
            return A.Bound(v)
        if t.kind == "KW" and t.value.lower() in A.FUNC_ARITIES and t.value.lower() != "in":
            name = self.next().value.lower()
            self.expect_op("(")
            args = [self._expr()]
            while self.accept_op(","):
                args.append(self._expr())
            self.expect_op(")")
            lo, hi = A.FUNC_ARITIES[name]
            if len(args) < lo or (hi is not None and len(args) > hi):
                raise SyntaxError(
                    f"{name.upper()} expects {lo}"
                    + ("" if hi == lo else f"..{hi or 'n'}")
                    + f" arguments, got {len(args)}"
                )
            return A.Func(name, tuple(args))
        if t.kind == "VAR":
            return A.VarRef(self.vt.var(self.next().value))
        if t.kind == "NUM":
            v = float(self.next().value)
            return A.Lit(int(v) if v.is_integer() else v)
        if t.kind in ("PNAME", "IRI", "STRING"):
            return A.Lit(self.next().value)
        raise SyntaxError(f"unexpected expression token {t.value!r}")


def parse_query(text: str) -> Tuple[A.PlanNode, A.VarTable]:
    return Parser(text).parse()
