"""algebra.Expr -> ExprProgram lowering (DESIGN.md §9.2).

One pass builds SSA straight-line code with three online optimizations:

  * operand classification — every instruction is pinned to the code
    domain (int32 dictionary codes: equality, BOUND, term tests,
    dictionary-domain string predicates) or the value domain (float
    numeric side-array decodes: arithmetic, ordered comparisons), the
    paper's §2.2.1 split, so the executor never decodes a column that is
    only ever compared by identity;
  * constant folding — a peephole over the emitted stream: arithmetic /
    comparisons whose operands are both constants collapse to LOAD_CONST
    (non-finite results keep SPARQL error semantics: LOAD_CONST errs on
    non-finite values, so folded 1/0 still evaluates to 'error');
  * common-subexpression elimination — emission is hash-consed on the
    full instruction, so syntactically repeated subtrees (the FILTER-dense
    SP²Bench shape) evaluate once per batch.

A final linear-scan pass renames SSA registers onto a minimal register
pool (operands are read before the destination is written, so a register
freed by its last use can be the destination of the same instruction).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core import algebra as A
from repro_torch.core.dictionary import Dictionary, _numeric_value
from repro_torch.core.exprs import bytecode as B
from repro_torch.core.exprs import terms as T

# ops eligible for the constant-folding peephole
_FOLD = {
    B.ADD: lambda a, b: a + b,
    B.SUB: lambda a, b: a - b,
    B.MUL: lambda a, b: a * b,
    B.DIV: lambda a, b: a / b if b != 0 else math.inf if a > 0 else -math.inf if a < 0 else math.nan,
    B.LT: lambda a, b: float(a < b),
    B.LE: lambda a, b: float(a <= b),
    B.GT: lambda a, b: float(a > b),
    B.GE: lambda a, b: float(a >= b),
    B.EQ_NUM: lambda a, b: float(a == b),
    B.NE_NUM: lambda a, b: float(a != b),
}

_CMP_TO_OP = {"<": B.LT, "<=": B.LE, ">": B.GT, ">=": B.GE,
              "=": B.EQ_NUM, "!=": B.NE_NUM}
_ARITH_TO_OP = {"+": B.ADD, "-": B.SUB, "*": B.MUL, "/": B.DIV}

# boolean-shaped algebra nodes: their register already holds 0/1
_BOOL_NODES = (A.Cmp, A.And, A.Or, A.Not, A.Bound)
_TEST_FUNCS = frozenset(
    ("isnumeric", "isiri", "isliteral", "strstarts", "strends",
     "contains", "regex")
)


class ExprCompileError(ValueError):
    pass


class _Builder:
    def __init__(self, dictionary: Optional[Dictionary]):
        self.d = dictionary
        self.instrs: List[B.Instr] = []
        self.memo: Dict[B.Instr, int] = {}
        self.const_of: Dict[int, float] = {}  # SSA reg -> known const value
        self.consts: List[float] = []
        self.const_idx: Dict[float, int] = {}
        self.code_vars: List[int] = []
        self.code_idx: Dict[int, int] = {}
        self.num_vars: List[int] = []
        self.num_idx: Dict[int, int] = {}
        self.tables: List[B.TableSpec] = []
        self.table_idx: Dict[B.TableSpec, int] = {}

    # -- input slots -------------------------------------------------------

    def _code_col(self, var: int) -> int:
        if var not in self.code_idx:
            self.code_idx[var] = len(self.code_vars)
            self.code_vars.append(var)
        return self.code_idx[var]

    def _num_col(self, var: int) -> int:
        if var not in self.num_idx:
            self.num_idx[var] = len(self.num_vars)
            self.num_vars.append(var)
        return self.num_idx[var]

    def _table_col(self, spec: B.TableSpec) -> int:
        """Absolute icols index of a predicate table column (tables sit
        after the code columns; resolved after build in _finish)."""
        if spec not in self.table_idx:
            self.table_idx[spec] = len(self.tables)
            self.tables.append(spec)
        return self.table_idx[spec]

    def _need_dict(self) -> Dictionary:
        if self.d is None:
            raise ExprCompileError(
                "dictionary required to compile constants / term predicates"
            )
        return self.d

    def _encode(self, term) -> int:
        # encode (not lookup): a term absent from the data gets a fresh
        # code that matches no row — 'bound but unequal' is false, not the
        # NULL sentinel (which would wrongly make the comparison an error)
        return self._need_dict().encode(term)

    # -- emission (CSE + constant folding) ---------------------------------

    def emit(self, op: int, a: int = 0, b: int = 0, c: int = 0) -> int:
        key = (op, a, b, c)
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        if op in _FOLD and a in self.const_of and b in self.const_of:
            va, vb = self.const_of[a], self.const_of[b]
            if math.isfinite(va) and math.isfinite(vb):
                return self.const(_FOLD[op](va, vb))
        dst = len(self.instrs)  # SSA: one fresh register per instruction
        self.instrs.append((op, dst, a, b, c))
        self.memo[key] = dst
        if op == B.LOAD_CONST:
            self.const_of[dst] = self.consts[a]
        return dst

    def const(self, v: float) -> int:
        v = float(v)
        if v not in self.const_idx:
            self.const_idx[v] = len(self.consts)
            self.consts.append(v)
        return self.emit(B.LOAD_CONST, self.const_idx[v])

    # -- lowering ----------------------------------------------------------

    def value(self, e: A.Expr) -> int:
        """Lower in value context: the result register holds a float
        (booleans as 0/1, errors in the error plane)."""
        if isinstance(e, A.VarRef):
            return self.emit(B.LOAD_NUM, self._num_col(e.var))
        if isinstance(e, A.Lit):
            return self.const(_numeric_value(e.value))
        if isinstance(e, A.Arith):
            return self.emit(
                _ARITH_TO_OP[e.op], self.value(e.lhs), self.value(e.rhs)
            )
        if isinstance(e, A.Func) and e.name in ("if", "coalesce"):
            return self._func(e, "value")
        if isinstance(e, _BOOL_NODES) or isinstance(e, A.Func):
            return self.boolean(e)  # 0/1 float is a fine value
        raise ExprCompileError(f"cannot lower {type(e).__name__} as a value")

    def boolean(self, e: A.Expr) -> int:
        """Lower in boolean context (EBV applied where SPARQL requires)."""
        if isinstance(e, A.And):
            reg = self.boolean(e.terms[0])
            for t in e.terms[1:]:
                reg = self.emit(B.AND, reg, self.boolean(t))
            return reg
        if isinstance(e, A.Or):
            reg = self.boolean(e.terms[0])
            for t in e.terms[1:]:
                reg = self.emit(B.OR, reg, self.boolean(t))
            return reg
        if isinstance(e, A.Not):
            return self.emit(B.NOT, self.boolean(e.term))
        if isinstance(e, A.Bound):
            return self.emit(B.BOUND, self._code_col(e.var))
        if isinstance(e, A.Cmp):
            return self._cmp(e)
        if isinstance(e, A.Func):
            return self._func(e)
        if isinstance(e, A.VarRef):
            # EBV of a term variable: dictionary-domain table (numbers by
            # value, strings by emptiness, IRIs -> error)
            return self._test("ebv", (), e.var)
        if isinstance(e, A.Lit):
            tri = T.ebv(e.value)
            return self.const(math.nan if tri == T.ERROR else float(tri))
        if isinstance(e, A.Arith):
            return self.value(e)  # numeric EBV: != 0 at the use site
        raise ExprCompileError(f"cannot lower {type(e).__name__} as a boolean")

    # -- comparison classification (the §2.2.1 code/value split) -----------

    def _cmp(self, e: A.Cmp) -> int:
        leaves = isinstance(e.lhs, (A.VarRef, A.Lit)) and isinstance(
            e.rhs, (A.VarRef, A.Lit)
        )
        if e.op in ("=", "!=") and leaves:
            return self._code_eq(e.lhs, e.rhs, negate=e.op == "!=")
        return self.emit(_CMP_TO_OP[e.op], self.value(e.lhs), self.value(e.rhs))

    def _code_eq(self, lhs: A.Expr, rhs: A.Expr, negate: bool) -> int:
        if isinstance(lhs, A.Lit) and isinstance(rhs, A.VarRef):
            lhs, rhs = rhs, lhs
        if isinstance(lhs, A.VarRef) and isinstance(rhs, A.VarRef):
            op = B.NE_CODE if negate else B.EQ_CODE
            a, b = self._code_col(lhs.var), self._code_col(rhs.var)
            if a > b:  # canonical operand order widens CSE hits
                a, b = b, a
            return self.emit(op, a, b)
        if isinstance(lhs, A.VarRef):  # var vs constant term
            op = B.NE_CONST if negate else B.EQ_CONST
            return self.emit(op, self._code_col(lhs.var), self._encode(rhs.value))
        # constant vs constant: term identity folds
        eq = lhs.value == rhs.value
        return self.const(float(eq != negate))

    # -- builtin calls -----------------------------------------------------

    def _test(self, func: str, args: Tuple, var: int) -> int:
        spec = B.TableSpec(func, tuple(args), var)
        self._need_dict()  # tables are built against the dictionary
        tcol = self._table_col(spec)
        return self.emit(B.TEST, tcol, self._code_col(var), 0)

    def _branch(self, e: A.Expr, mode: str) -> int:
        """IF/COALESCE operands follow the *enclosing* context: boolean in
        a FILTER (so a term variable gets its EBV, matching the tree
        walk), value in a BIND."""
        return self.boolean(e) if mode == "mask" else self.value(e)

    def _func(self, e: A.Func, mode: str = "mask") -> int:
        name = e.name
        if name == "if":
            c, t, f = e.args
            return self.emit(
                B.IF, self.boolean(c), self._branch(t, mode), self._branch(f, mode)
            )
        if name == "coalesce":
            reg = self._branch(e.args[0], mode)
            for arg in e.args[1:]:
                reg = self.emit(B.COALESCE, reg, self._branch(arg, mode))
            return reg
        if name == "in":
            # per-item classification, mirroring Cmp('='): a leaf item
            # against a leaf lhs compares by term identity (code domain);
            # only computed items drop to value-domain equality
            lhs, items = e.args[0], e.args[1:]
            lhs_leaf = isinstance(lhs, (A.VarRef, A.Lit))
            regs = []
            lhs_val = None
            for item in items:
                if lhs_leaf and isinstance(item, (A.VarRef, A.Lit)):
                    regs.append(self._code_eq(lhs, item, negate=False))
                else:
                    if lhs_val is None:
                        lhs_val = self.value(lhs)
                    regs.append(
                        self.emit(B.EQ_NUM, lhs_val, self.value(item))
                    )
            reg = regs[0]
            for r in regs[1:]:
                reg = self.emit(B.OR, reg, r)
            return reg
        if name == "sameterm":
            a, b = e.args
            if not (isinstance(a, (A.VarRef, A.Lit)) and isinstance(b, (A.VarRef, A.Lit))):
                raise ExprCompileError("sameTerm arguments must be terms")
            return self._code_eq(a, b, negate=False)
        if name in _TEST_FUNCS:
            subject, rest = e.args[0], e.args[1:]
            for a in rest:
                if not isinstance(a, A.Lit):
                    raise ExprCompileError(
                        f"{name} pattern arguments must be constants"
                    )
            args = tuple(a.value for a in rest)
            if isinstance(subject, A.Lit):  # constant subject: fold
                tri = T.term_predicate(name, args)(subject.value)
                return self.const(math.nan if tri == T.ERROR else float(tri))
            if not isinstance(subject, A.VarRef):
                raise ExprCompileError(
                    f"{name} subject must be a variable or constant"
                )
            return self._test(name, args, subject.var)
        raise ExprCompileError(f"unknown function {name!r}")

    # -- finalize ----------------------------------------------------------

    def _finish(self, out_reg: int, source_ops: int) -> B.ExprProgram:
        # TEST's table operand was a table ordinal; rebase onto the icols
        # block (tables follow the code columns)
        base = len(self.code_vars)
        instrs = [
            (op, dst, a + base, b, c) if op == B.TEST else (op, dst, a, b, c)
            for (op, dst, a, b, c) in _dce(self.instrs, out_reg)
        ]
        instrs, n_regs, out_reg = _allocate(instrs, out_reg)
        return B.ExprProgram(
            instrs=tuple(instrs),
            n_regs=n_regs,
            out_reg=out_reg,
            consts=tuple(self.consts),
            code_vars=tuple(self.code_vars),
            num_vars=tuple(self.num_vars),
            tables=tuple(self.tables),
            source_ops=source_ops,
        )


def _reg_operands(instr: B.Instr) -> Tuple[int, ...]:
    op, _, a, b, c = instr
    if op in B.CODE_OPS or op in (B.LOAD_NUM, B.LOAD_CONST):
        return ()
    if op == B.NOT:
        return (a,)
    if op == B.IF:
        return (a, b, c)
    return (a, b)


def _dce(instrs: List[B.Instr], out_reg: int) -> List[B.Instr]:
    """Drop instructions whose result is never read (all ops are pure;
    constant folding leaves its operand LOAD_CONSTs behind). SSA names are
    unique, so one backward liveness sweep suffices."""
    live = {out_reg}
    keep: List[B.Instr] = []
    for ins in reversed(instrs):
        if ins[1] in live:
            live.update(_reg_operands(ins))
            keep.append(ins)
    keep.reverse()
    return keep


def _allocate(
    instrs: List[B.Instr], out_reg: int
) -> Tuple[List[B.Instr], int, int]:
    """Linear-scan rename: SSA names -> minimal register pool."""
    last_use = {out_reg: len(instrs)}
    for i, ins in enumerate(instrs):
        for r in _reg_operands(ins):
            last_use[r] = max(last_use.get(r, -1), i)
    mapping: Dict[int, int] = {}
    free: List[int] = []
    n_regs = 0
    out: List[B.Instr] = []
    for i, ins in enumerate(instrs):
        op, dst, a, b, c = ins
        regs = _reg_operands(ins)  # SSA operand names
        if op == B.NOT:
            a = mapping[a]
        elif op == B.IF:
            a, b, c = mapping[a], mapping[b], mapping[c]
        elif regs:
            a, b = mapping[a], mapping[b]
        for r in set(regs):  # free operands dying here (reads precede write)
            if last_use.get(r) == i:
                free.append(mapping[r])
        rd = free.pop() if free else n_regs
        n_regs = max(n_regs, rd + 1)
        mapping[dst] = rd
        out.append((op, rd, a, b, c))
    return out, max(n_regs, 1), mapping.get(out_reg, out_reg)


def _count_nodes(e: A.Expr) -> int:
    if isinstance(e, (A.VarRef, A.Lit, A.Bound)):
        return 1
    if isinstance(e, (A.Cmp, A.Arith)):
        return 1 + _count_nodes(e.lhs) + _count_nodes(e.rhs)
    if isinstance(e, (A.And, A.Or)):
        return 1 + sum(_count_nodes(t) for t in e.terms)
    if isinstance(e, A.Not):
        return 1 + _count_nodes(e.term)
    if isinstance(e, A.Func):
        return 1 + sum(_count_nodes(a) for a in e.args)
    return 1


def compile_expr(
    expr: A.Expr,
    dictionary: Optional[Dictionary],
    mode: str = "mask",
) -> B.ExprProgram:
    """Compile an expression tree. ``mode='mask'`` lowers in boolean
    context (FILTER / left-join condition), ``mode='value'`` in value
    context (BIND / ORDER BY / GROUP BY keys)."""
    bld = _Builder(dictionary)
    out = bld.boolean(expr) if mode == "mask" else bld.value(expr)
    return bld._finish(out, _count_nodes(expr))
