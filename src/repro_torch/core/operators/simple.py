"""Filter, Project, Extend (BIND), Slice, Union — vectorized unary/binary ops.

FILTER and BIND run their compiled expression program through the
``expr_eval`` kernel, one launch per batch; FILTER narrows the batch mask
in place (no copy). An expression outside the compiler's surface (the
planner marks it ``program=False``, or a compile of a hand-built tree
fails) evaluates through the interpreted tree walk
(``core/expressions.py``) on the batch's device, exactly where the
reference does; nothing switches to the walk because a kernel failed.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.algebra import Expr
from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, concat_batches
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.expressions import eval_expr_mask, eval_expr_values
from repro_torch.core.exprs import ExprCompileError, compile_expr
from repro_torch.core.exprs.vm import eval_program_mask, eval_program_values
from repro_torch.core.operators.base import BatchOperator, HostTimer


def resolve_program(expr: Expr, dictionary: Optional[Dictionary], program,
                    mode: str):
    """The planner's compiled program, or a compile for hand-built trees;
    None where the tree walk evaluates the expression: ``program is
    False`` (the planner's mark for an uncompilable expression), a failed
    compile, or no dictionary to compile against."""
    if program is False:
        return None
    if program is not None or dictionary is None:
        return program
    try:
        return compile_expr(expr, dictionary, mode)
    except ExprCompileError:
        return None


def expr_mask(expr: Expr, program, batch: ColumnBatch,
              dictionary: Optional[Dictionary]) -> torch.Tensor:
    """FILTER semantics over ``batch``: the program's mask through the VM,
    or the tree walk's where there is no program."""
    if program is None:
        return eval_expr_mask(expr, batch, dictionary)
    return eval_program_mask(program, batch, dictionary)


def _report_program(op) -> None:
    """The program's evaluations and their host time in ``op.stats``."""
    ex = op.stats.extra
    ex["expr_dispatches"] = op._timer.calls
    ex["expr_eval_ms"] = op._timer.ms


class FilterOp(BatchOperator):
    """FILTER through the expression VM (one kernel launch per batch) or
    the tree walk, narrowing the mask in place. A program's instruction
    count, evaluations and their host time are ``stats.extra``'s
    ``expr_ops``, ``expr_dispatches`` and ``expr_eval_ms``."""

    def __init__(
        self,
        child: BatchOperator,
        expr: Expr,
        dictionary: Optional[Dictionary],
        program=None,
        name: str = "Filter",  # "Having" for the post-grouping stage
    ):
        self.child = child
        self.expr = expr
        self.dictionary = dictionary
        self.program = resolve_program(expr, dictionary, program, "mask")
        self._timer = HostTimer()
        super().__init__(name, "" if self.program is None else "[vm]")
        if self.program is not None:
            self.stats.extra["expr_ops"] = len(self.program.instrs)

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.child.sorted_by()  # filtering preserves order

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _next(self) -> Optional[ColumnBatch]:
        while True:
            b = self.child.next_batch()
            if b is None:
                return None
            if self.program is None:
                m = eval_expr_mask(self.expr, b, self.dictionary)
            else:
                with self._timer:
                    m = eval_program_mask(self.program, b, self.dictionary)
                _report_program(self)
            b = b.with_mask(m)
            if b.n_active:
                return b
            b.release()  # all rows inactive: recycle batch, keep pulling

    def _skip(self, var: int, target: int) -> None:
        self.child.skip(var, target)

    def _reset(self) -> None:
        self.child.reset()


class ProjectOp(BatchOperator):
    def __init__(
        self,
        child: BatchOperator,
        keep: Tuple[int, ...],
        device: torch.device,
        pool: Optional[BatchPool] = None,
    ):
        self.child = child
        self.keep = tuple(keep)
        self.device = device
        self.pool = pool
        super().__init__("Project", f"{len(keep)} vars")

    def var_ids(self) -> Tuple[int, ...]:
        return self.keep

    def sorted_by(self) -> Optional[int]:
        sb = self.child.sorted_by()
        return sb if sb in self.keep else None

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _next(self) -> Optional[ColumnBatch]:
        b = self.child.next_batch()
        if b is None:
            return None
        if self.pool is None:
            return b.project(self.keep)
        # pooled path: copy the kept columns into a recycled buffer and
        # give the source buffers back
        idx = [b.col_index(v) for v in self.keep]
        sb = b.sorted_by if b.sorted_by in self.keep else None
        out = ColumnBatch.alloc(self.keep, b.capacity, self.device, self.pool, sb)
        out.columns.copy_(b.columns[idx])
        out.mask.copy_(b.mask)
        out.n_rows = b.n_rows
        out.dense = b.dense
        self.pool.bytes_copied += out.columns.numel() * 4
        b.release()
        return out

    def _skip(self, var: int, target: int) -> None:
        self.child.skip(var, target)

    def _reset(self) -> None:
        self.child.reset()


class ExtendOp(BatchOperator):
    """BIND (expr AS ?v): computes the value expression over the batch,
    dictionary-encodes the distinct results, appends a column."""

    def __init__(
        self,
        child: BatchOperator,
        var: int,
        expr: Expr,
        dictionary: Dictionary,
        device: torch.device,
        pool: Optional[BatchPool] = None,
        program=None,
    ):
        self.child = child
        self.var = var
        self.expr = expr
        self.dictionary = dictionary
        self.device = device
        self.pool = pool
        self.program = resolve_program(expr, dictionary, program, "value")
        self._timer = HostTimer()
        super().__init__("Bind", f"?v{var}" + ("" if self.program is None else " [vm]"))
        if self.program is not None:
            self.stats.extra["expr_ops"] = len(self.program.instrs)

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids() + (self.var,)

    def sorted_by(self) -> Optional[int]:
        return self.child.sorted_by()

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _next(self) -> Optional[ColumnBatch]:
        b = self.child.next_batch()
        if b is None:
            return None
        if self.program is None:
            vals, ok = eval_expr_values(self.expr, b, self.dictionary)
        else:
            with self._timer:
                vals, ok = eval_program_values(self.program, b, self.dictionary)
            _report_program(self)
        n = b.n_rows
        codes = torch.full((b.capacity,), NULL_ID, dtype=torch.int32, device=self.device)
        okn = ok[:n]
        # encode the few distinct computed values, map back vectorized
        uniq, inv = torch.unique(vals[:n][okn], return_inverse=True)
        if uniq.shape[0]:
            ids = torch.tensor(
                [self.dictionary.encode(float(u)) for u in uniq.tolist()],
                dtype=torch.int32, device=self.device,
            )
            tmp = torch.full((n,), NULL_ID, dtype=torch.int32, device=self.device)
            tmp[okn] = ids[inv]
            codes[:n] = tmp
        out = ColumnBatch.alloc(self.var_ids(), b.capacity, self.device, self.pool, b.sorted_by)
        out.columns[:-1] = b.columns
        out.columns[-1] = codes
        out.mask.copy_(b.mask)
        out.n_rows = b.n_rows
        out.dense = b.dense
        if self.pool is not None:
            self.pool.bytes_copied += out.columns.numel() * 4
        b.release()
        return out

    def _reset(self) -> None:
        self.child.reset()


class SliceOp(BatchOperator):
    """LIMIT/OFFSET over active rows."""

    def __init__(self, child: BatchOperator, limit: Optional[int], offset: int = 0):
        self.child = child
        self.limit = limit
        self.offset = offset
        self._seen = 0
        self._emitted = 0
        super().__init__("Slice", f"limit={limit} offset={offset}")

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.child.sorted_by()

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _next(self) -> Optional[ColumnBatch]:
        while True:
            if self.limit is not None and self._emitted >= self.limit:
                return None
            b = self.child.next_batch()
            if b is None:
                return None
            sel = b.selection_vector()
            n = int(sel.shape[0])
            lo = max(0, self.offset - self._seen)
            self._seen += n
            keep = sel[lo:]
            if self.limit is not None:
                keep = keep[: self.limit - self._emitted]
            if keep.shape[0] == 0:
                b.release()
                continue
            m = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
            m[keep.long()] = True
            self._emitted += int(keep.shape[0])
            # keep ⊆ active rows, so narrowing the mask is equivalent to
            # replacing it (and moves pooled-buffer ownership along)
            return b.with_mask(m)

    def _reset(self) -> None:
        self.child.reset()
        self._seen = 0
        self._emitted = 0


class UnionOp(BatchOperator):
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
        lv = tuple(left.var_ids())
        self._vars = lv + tuple(v for v in right.var_ids() if v not in lv)
        self._on_right = False
        super().__init__("Union")

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def children(self) -> List[BatchOperator]:
        return [self.left, self.right]

    def _next(self) -> Optional[ColumnBatch]:
        while True:
            src = self.right if self._on_right else self.left
            b = src.next_batch()
            if b is None:
                if self._on_right:
                    return None
                self._on_right = True
                continue
            if set(b.var_ids) == set(self._vars):
                # cheap path: same schema, reorder columns only
                order = [b.col_index(v) for v in self._vars]
                m = b.mask if b.pool is None else b.mask.clone()
                out = ColumnBatch(self._vars, b.columns[order], m, b.n_rows, None,
                                  dense=b.dense)
                b.release()  # the row gather copied the columns
                return out
            return concat_batches(
                [b], self.device, self._vars, pool=self.pool, release_inputs=True
            )

    def _reset(self) -> None:
        self.left.reset()
        self.right.reset()
        self._on_right = False
