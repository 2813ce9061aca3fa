"""Interpreted per-node expression evaluation over columnar batches.

This is the legacy tree walk: each algebra node evaluates recursively with
tensor operations on the batch's own device — the baseline the vectorized
expression VM (``core/exprs/``) is measured against, the expression engine
of the row executor, and what FILTER / BIND run where the planner marks an
expression outside the VM's surface. Two evaluation regimes: code-only
expressions (equality / inequality between variables or against constants)
run directly on the int32 dictionary codes; value expressions (<, <=,
arithmetic) decode operands through the dictionary's float64 numeric
side-array with one gather (``exprs.vm.numeric_of``).

Three-valued SPARQL semantics are exact and match the VM bit for bit:
every boolean node evaluates to (value, error) pairs; ``NOT(error)`` stays
error and ``true || error`` is true. Builtin calls (algebra.Func) share
their per-term semantics with the VM through ``core/exprs/terms``; a term
test decodes on the host, once per distinct code of the batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.algebra import (
    And, Arith, Bound, Cmp, Expr, Func, Lit, Not, Or, VarRef,
)
from repro_torch.core.batch import NULL_ID, ColumnBatch
from repro_torch.core.dictionary import Dictionary, _numeric_value
from repro_torch.core.exprs import terms as T
from repro_torch.core.exprs.vm import numeric_of

_CMP = {
    "=": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}
_ARITH = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}

BoolErr = Tuple[torch.Tensor, torch.Tensor]  # (value bool, error bool) per row


def _full(batch: ColumnBatch, value, dtype) -> torch.Tensor:
    return torch.full((batch.n_rows,), value, dtype=dtype, device=batch.device)


def _false(batch: ColumnBatch) -> torch.Tensor:
    return torch.zeros(batch.n_rows, dtype=torch.bool, device=batch.device)


def _codes(e: Expr, batch: ColumnBatch, d: Optional[Dictionary]) -> Optional[torch.Tensor]:
    """int32 codes for a leaf, or None if not a code-addressable leaf."""
    if isinstance(e, VarRef):
        return batch.column(e.var)
    if isinstance(e, Lit):
        if d is None:
            raise ValueError("dictionary required for constant in expression")
        tid = d.lookup(e.value)
        # a term absent from the dictionary is a real term that matches no
        # row: use a fresh sentinel code (== len(d)), NOT the NULL id —
        # 'bound but unequal' is false, never an error
        return _full(batch, len(d) if tid is None else tid, torch.int32)
    return None


def _numeric(e: Expr, batch: ColumnBatch, d: Optional[Dictionary]) -> BoolErr:
    """(values float64, valid bool) for a value-context expression."""
    if isinstance(e, VarRef):
        if d is None:
            raise ValueError("dictionary required for value comparisons")
        vals = numeric_of(d, batch.column(e.var))
        return vals, ~torch.isnan(vals)
    if isinstance(e, Lit):
        v = _numeric_value(e.value)
        finite = v == v and v not in (float("inf"), float("-inf"))
        return _full(batch, v, torch.float64), _full(batch, finite, torch.bool)
    if isinstance(e, Arith):
        lv, lok = _numeric(e.lhs, batch, d)
        rv, rok = _numeric(e.rhs, batch, d)
        out = _ARITH[e.op](lv, rv)  # IEEE: x/0 is inf or nan, as numpy's
        return out, lok & rok & torch.isfinite(out)
    if isinstance(e, Func) and e.name == "if":
        cv, cerr = _eval(e.args[0], batch, d)
        tv, tok = _numeric(e.args[1], batch, d)
        fv, fok = _numeric(e.args[2], batch, d)
        return torch.where(cv, tv, fv), ~cerr & torch.where(cv, tok, fok)
    if isinstance(e, Func) and e.name == "coalesce":
        vals, ok = _numeric(e.args[0], batch, d)
        for arg in e.args[1:]:
            av, aok = _numeric(arg, batch, d)
            vals = torch.where(ok, vals, av)
            ok = ok | aok
        return vals, ok
    # boolean-shaped node in value context (BIND(?a > ?b AS ?x)): 0/1
    v, err = _eval(e, batch, d)
    return v.to(torch.float64), ~err


def eval_expr_mask(
    e: Expr, batch: ColumnBatch, d: Optional[Dictionary] = None
) -> torch.Tensor:
    """Boolean mask over the batch capacity: True where the expression is
    (three-valued) true — 'error' rows are excluded. ANDed with the batch
    mask by the caller (selection-vector update)."""
    v, err = _eval(e, batch, d)
    keep = v & ~err
    if batch.n_rows == batch.capacity:  # a full batch, e.g. the row engine's one row
        return keep
    m = torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
    m[: batch.n_rows] = keep
    return m


def _tri_rows(
    name: str, args: Tuple, e: Expr, batch: ColumnBatch, d: Optional[Dictionary]
) -> BoolErr:
    """Per-row trinary term test — the interpreted counterpart of the VM's
    dictionary-domain tables: the batch's distinct codes go to the host in
    one copy, each decodes once, and the results come back in one upload."""
    if d is None:
        raise ValueError("dictionary required for term predicates")
    fn = T.term_predicate(name, args)
    if isinstance(e, Lit):  # constant subject: one term, not a column
        tri = fn(e.value)
        return _full(batch, tri == T.TRUE, torch.bool), _full(batch, tri == T.ERROR, torch.bool)
    codes = _codes(e, batch, d)
    if codes is None:
        raise TypeError(f"{name} subject must be a term (variable/constant)")
    n_terms = len(d)
    uniq, inv = torch.unique(codes, return_inverse=True)
    per_code = [
        T.ERROR if c < 0 else (T.FALSE if c >= n_terms else fn(d.decode(c)))
        for c in uniq.tolist()
    ]
    tri = torch.tensor(per_code, dtype=torch.int32, device=codes.device)[inv]
    return tri == T.TRUE, tri == T.ERROR


def _eval(e: Expr, batch: ColumnBatch, d: Optional[Dictionary]) -> BoolErr:
    """Boolean-context evaluation: (value, error) row pairs."""
    if isinstance(e, And):
        # Kleene: a row errs iff some term errs and no term is definitely
        # false (false && error == false)
        v = ~_false(batch)
        any_err = _false(batch)
        any_false = _false(batch)
        for t in e.terms:
            tv, terr = _eval(t, batch, d)
            any_err |= terr
            any_false |= ~tv & ~terr
            v &= tv & ~terr
        return v, any_err & ~any_false
    if isinstance(e, Or):
        any_true = _false(batch)
        any_err = _false(batch)
        for t in e.terms:
            tv, terr = _eval(t, batch, d)
            any_true |= tv & ~terr
            any_err |= terr
        # a definite true dominates error (true || error == true)
        return any_true, any_err & ~any_true
    if isinstance(e, Not):
        v, err = _eval(e.term, batch, d)
        # NOT(error) stays error
        return ~v & ~err, err
    if isinstance(e, Bound):
        return batch.column(e.var) != NULL_ID, _false(batch)
    if isinstance(e, Cmp):
        if e.op in ("=", "!="):
            if isinstance(e.lhs, Lit) and isinstance(e.rhs, Lit):
                # term identity folds directly — dictionary-absent terms
                # must not collide through the shared sentinel code
                v = (e.lhs.value == e.rhs.value) == (e.op == "=")
                return _full(batch, v, torch.bool), _false(batch)
            lc = _codes(e.lhs, batch, d)
            rc = _codes(e.rhs, batch, d)
            if lc is not None and rc is not None:
                err = (lc == NULL_ID) | (rc == NULL_ID)
                return _CMP[e.op](lc, rc) & ~err, err
        lv, lok = _numeric(e.lhs, batch, d)
        rv, rok = _numeric(e.rhs, batch, d)
        ok = lok & rok
        return _CMP[e.op](lv, rv) & ok, ~ok
    if isinstance(e, Func):
        return _eval_func(e, batch, d)
    if isinstance(e, (VarRef, Lit)):
        # effective boolean value of a term (SPARQL 17.2.2): numbers by
        # value, strings by emptiness, IRIs / unbound are type errors
        return _tri_rows("ebv", (), e, batch, d)
    if isinstance(e, Arith):
        v, ok = _numeric(e, batch, d)
        return (v != 0) & ok, ~ok
    raise TypeError(f"unsupported expression node {type(e)}")


def _eval_func(e: Func, batch: ColumnBatch, d: Optional[Dictionary]) -> BoolErr:
    name = e.name
    if name == "if":
        cv, cerr = _eval(e.args[0], batch, d)
        tv, terr = _eval(e.args[1], batch, d)
        fv, ferr = _eval(e.args[2], batch, d)
        v = torch.where(cv, tv, fv)
        err = cerr | torch.where(cv, terr, ferr)
        return v & ~err, err
    if name == "coalesce":
        v, err = _eval(e.args[0], batch, d)
        for arg in e.args[1:]:
            av, aerr = _eval(arg, batch, d)
            v = torch.where(err, av, v)
            err = err & aerr
        return v & ~err, err
    if name == "in":
        # expr IN (list) == chained || of equalities (Kleene error rules)
        any_true = _false(batch)
        any_err = _false(batch)
        for item in e.args[1:]:
            iv, ierr = _eval(Cmp("=", e.args[0], item), batch, d)
            any_true |= iv & ~ierr
            any_err |= ierr
        return any_true, any_err & ~any_true
    if name == "sameterm":
        if isinstance(e.args[0], Lit) and isinstance(e.args[1], Lit):
            v = e.args[0].value == e.args[1].value
            return _full(batch, v, torch.bool), _false(batch)
        lc = _codes(e.args[0], batch, d)
        rc = _codes(e.args[1], batch, d)
        if lc is None or rc is None:
            raise TypeError("sameTerm arguments must be terms")
        err = (lc == NULL_ID) | (rc == NULL_ID)
        return (lc == rc) & ~err, err
    for a in e.args[1:]:
        if not isinstance(a, Lit):
            raise TypeError(f"{name} pattern arguments must be constants")
    return _tri_rows(name, tuple(a.value for a in e.args[1:]), e.args[0], batch, d)


def eval_expr_values(
    e: Expr, batch: ColumnBatch, d: Dictionary
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Numeric values for BIND (Extend): returns (float64 values, valid)."""
    return _numeric(e, batch, d)
