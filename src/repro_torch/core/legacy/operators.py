"""The legacy tuple-at-a-time Volcano engine — the paper's baseline.

Each operator returns a single solution per ``next_row()`` call; sorted
operators additionally support ``skip(target)`` repositioning. Rows are
dicts {var_id: code} on the host. The per-tuple virtual-call overhead the
paper measures against is, here, per-tuple Python dispatch.

The row engine is host Python by nature: scans read the store's host index
arrays (``QuadStore.index_array``) and search them with numpy, never the
device columns, and an expression over a row evaluates through the
interpreted tree walk on a one-row CPU batch. Each operator keeps the
batch operators' ``OpStats`` (``stats.results`` counts rows on the host,
``stats.rows_scanned`` the index rows a scan read).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.algebra import AggSpec, Expr, K, SortKey, TriplePattern, V
from repro_torch.core.batch import NULL_ID, ColumnBatch
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.expressions import eval_expr_mask, eval_expr_values
from repro_torch.core.operators.base import OpStats
from repro_torch.core.storage import INDEX_ORDERS, QuadStore, ScanRange

Row = Dict[int, int]

_ONE_ROW = torch.ones(1, dtype=torch.bool)  # the mask of every one-row batch


def row_to_batch(row: Row, vars_: Sequence[int]) -> ColumnBatch:
    """A one-row CPU batch of ``row`` over ``vars_`` (NULL where unbound):
    the row engine's rows are host rows, so their expressions never touch
    the card."""
    cols = (torch.tensor([[row.get(v, NULL_ID)] for v in vars_], dtype=torch.int32)
            if vars_ else torch.empty((0, 1), dtype=torch.int32))
    return ColumnBatch(tuple(vars_), cols, _ONE_ROW, 1)


def row_holds(expr: Expr, row: Row, vars_: Sequence[int], d: Optional[Dictionary]) -> bool:
    """Whether ``expr`` is (three-valued) true on one row."""
    return bool(eval_expr_mask(expr, row_to_batch(row, vars_), d)[0])


class RowOperator:
    def __init__(self, name: str, detail: str = "") -> None:
        self.stats = OpStats(name, detail)

    # -- public API (wrapped for stats; rows are host rows, so every count
    # is a host int) ------------------------------------------------------------

    def next_row(self) -> Optional[Row]:
        """The next solution, or None when exhausted."""
        st = self.stats
        st.next_calls += 1
        t0 = time.perf_counter()
        try:
            r = self._next()
        finally:
            st.wall_time += time.perf_counter() - t0
        if r is not None:
            st._results += 1
        return r

    def skip(self, var: int, target: int) -> None:
        """Reposition so later rows have ``var`` >= ``target``. Only valid
        if ``sorted_by() == var``."""
        self.stats.skip_calls += 1
        self._skip(var, target)

    def reset(self) -> None:
        """Restart iteration from the beginning."""
        self.stats.reset_calls += 1
        self._reset()

    def var_ids(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def sorted_by(self) -> Optional[int]:
        return None

    def supports_skip(self) -> bool:
        return self.sorted_by() is not None

    def children(self) -> List["RowOperator"]:
        return []

    # -- implementation hooks ---------------------------------------------------

    def _next(self) -> Optional[Row]:
        raise NotImplementedError

    def _skip(self, var: int, target: int) -> None:
        raise NotImplementedError(f"{self.stats.name} does not support skip()")

    def _reset(self) -> None:
        raise NotImplementedError

    def drain(self) -> List[Row]:
        out = []
        while True:
            r = self.next_row()
            if r is None:
                return out
            out.append(r)


class RowScan(RowOperator):
    """Tuple-at-a-time index scan over the host index array, with a numpy
    seek on skip()."""

    def __init__(self, store: QuadStore, pattern: TriplePattern,
                 want_sorted_var: Optional[int] = None):
        self.store = store
        self.pattern = pattern
        self._dead = False
        bound: List[Optional[int]] = [None, None, None, None]
        for role, sl in enumerate((pattern.s, pattern.p, pattern.o, pattern.g)):
            if isinstance(sl, K):
                tid = store.dict.lookup(sl.term)
                if tid is None:
                    self._dead = True
                    tid = -1
                bound[role] = tid
        self.bound = bound
        self.role_of_var: Dict[int, int] = {}
        self.residual_pairs: List[Tuple[int, int]] = []
        for role, sl in enumerate((pattern.s, pattern.p, pattern.o, pattern.g)):
            if isinstance(sl, V):
                if sl.id in self.role_of_var:
                    self.residual_pairs.append((self.role_of_var[sl.id], role))
                else:
                    self.role_of_var[sl.id] = role
        want_role = self.role_of_var.get(want_sorted_var) if want_sorted_var is not None else None
        self.index = store.choose_index(bound, want_role)
        self.perm = INDEX_ORDERS[self.index]
        self._vars = tuple(self.role_of_var)
        self.var_col_pos = {v: self.perm.index(r) for v, r in self.role_of_var.items()}
        n_bound = 0
        while n_bound < 4 and bound[self.perm[n_bound]] is not None:
            n_bound += 1
        self._sort_col_pos = n_bound if n_bound < 4 else None
        self._sorted_var = None
        if self._sort_col_pos is not None:
            role = self.perm[self._sort_col_pos]
            for v, r in self.role_of_var.items():
                if r == role:
                    self._sorted_var = v
        self.range: ScanRange = (
            ScanRange(self.index, 0, 0) if self._dead
            else store.host_range_for_pattern(self.index, bound)
        )
        self._take = tuple(self.var_col_pos.items())
        self._residual = tuple((self.perm.index(a), self.perm.index(b))
                               for a, b in self.residual_pairs)
        self.offset = 0
        super().__init__("Scan", "(row)")

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def sorted_by(self) -> Optional[int]:
        return self._sorted_var

    def _next(self) -> Optional[Row]:
        n = len(self.range)
        if self.offset >= n:
            return None
        rows = self.store.index_array(self.index)
        while self.offset < n:
            row = rows[self.range.lo + self.offset].tolist()
            self.offset += 1
            self.stats.rows_scanned += 1
            if all(row[a] == row[b] for a, b in self._residual):
                return {v: row[p] for v, p in self._take}
        return None

    def _skip(self, var: int, target: int) -> None:
        assert var == self._sorted_var
        self.offset = self.store.host_seek(self.range, self.offset, self._sort_col_pos, target)

    def _reset(self) -> None:
        self.offset = 0

    def estimated_rows(self) -> int:
        return len(self.range)


class RowMergeJoin(RowOperator):
    """Classic one-tuple-at-a-time merge join with skip(). ``post_filter``
    implements the SPARQL LeftJoin condition: a row pair only counts as a
    match if the expression holds on the joined row (so a fully-filtered
    group still yields the NULL-extended left row)."""

    def __init__(self, left: RowOperator, right: RowOperator, join_var: int,
                 mode: str = "inner", post_filter=None, dictionary=None):
        assert left.sorted_by() == join_var and right.sorted_by() == join_var
        assert mode in ("inner", "left_outer", "semi", "anti")
        self.left, self.right, self.v, self.mode = left, right, join_var, mode
        self.post_filter = post_filter
        self.dictionary = dictionary
        lv, rv = tuple(left.var_ids()), tuple(right.var_ids())
        self.shared = tuple(x for x in lv if x in rv)
        self._vars = lv if mode in ("semi", "anti") else lv + tuple(
            x for x in rv if x not in lv
        )
        self._lrow: Optional[Row] = None
        self._rgroup: List[Row] = []
        self._rgroup_key: Optional[int] = None
        self._rnext: Optional[Row] = None
        self._gi = 0  # cursor within right group
        self._right_done = False
        self._lrow_matched = False
        super().__init__("MergeJoin", f"(?v{join_var}) row mode={mode}")

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def sorted_by(self) -> Optional[int]:
        return None if self.mode == "left_outer" else self.v

    def children(self) -> List[RowOperator]:
        return [self.left, self.right]

    def _advance_left(self) -> None:
        self._lrow = self.left.next_row()
        self._gi = 0
        self._lrow_matched = False

    def _load_right_group(self, key: int) -> None:
        """Position the right group buffer at the first key >= key."""
        if self._rgroup_key is not None and self._rgroup_key >= key:
            return
        # gallop via skip
        if self._rnext is None and not self._right_done:
            if self.right.supports_skip():
                self.right.skip(self.v, key)
            self._rnext = self.right.next_row()
            if self._rnext is None:
                self._right_done = True
        while self._rnext is not None and self._rnext[self.v] < key:
            if self.right.supports_skip():
                self.right.skip(self.v, key)
            self._rnext = self.right.next_row()
            if self._rnext is None:
                self._right_done = True
        self._rgroup = []
        self._rgroup_key = None
        if self._rnext is None:
            return
        gkey = self._rnext[self.v]
        self._rgroup_key = gkey
        while self._rnext is not None and self._rnext[self.v] == gkey:
            self._rgroup.append(self._rnext)
            self._rnext = self.right.next_row()
            if self._rnext is None:
                self._right_done = True

    def _next(self) -> Optional[Row]:
        while True:
            if self._lrow is None:
                self._advance_left()
                if self._lrow is None:
                    return None
            k = self._lrow[self.v]
            self._load_right_group(k)
            if self._rgroup_key != k:
                # no match for this left row
                lr = self._lrow
                self._advance_left()
                if self.mode in ("left_outer", "anti"):
                    return dict(lr)
                continue
            # matched group
            if self.mode == "anti":
                # check secondary keys
                if self._anti_semi_match(self._lrow):
                    self._advance_left()
                    continue
                lr = self._lrow
                self._advance_left()
                return dict(lr)
            if self.mode == "semi":
                lr = self._lrow
                matched = self._anti_semi_match(lr)
                self._advance_left()
                if matched:
                    return dict(lr)
                continue
            # inner / left_outer: iterate group
            while self._gi < len(self._rgroup):
                rrow = self._rgroup[self._gi]
                self._gi += 1
                if all(self._lrow.get(s) == rrow.get(s) for s in self.shared):
                    out = dict(self._lrow)
                    for kk, vv in rrow.items():
                        out.setdefault(kk, vv)
                    if self.post_filter is not None and not row_holds(
                            self.post_filter, out, self._vars, self.dictionary):
                        continue  # not a match under the join condition
                    self._lrow_matched = True
                    return out
            lr, was_matched = self._lrow, self._lrow_matched
            self._advance_left()
            if self.mode == "left_outer" and not was_matched:
                return dict(lr)

    def _anti_semi_match(self, lrow: Row) -> bool:
        return any(
            all(lrow.get(s) == r.get(s) for s in self.shared) for r in self._rgroup
        )

    def _skip(self, var: int, target: int) -> None:
        assert var == self.v
        if self.left.supports_skip():
            self.left.skip(var, target)
        self._lrow = None
        self._gi = 0

    def _reset(self) -> None:
        self.left.reset()
        self.right.reset()
        self._lrow = None
        self._rgroup, self._rgroup_key, self._rnext = [], None, None
        self._right_done = False
        self._gi = 0


class RowHashJoin(RowOperator):
    """Classic hash join — the row engine's general join for unsorted
    inputs (the legacy translation of PHashJoin). The build side loads
    into a key-tuple → rows dict; probe rows stream through. Unbound key
    slots hash as None and match each other, mirroring the batch engine's
    NULL_ID-equals-itself semantics. An empty key tuple is the degenerate
    constant-key join (cross / NULL-extending cross / exists-anything).
    ``post_filter`` is the SPARQL LeftJoin condition: a probe row whose
    matches all fail it still emits, NULL-extended."""

    def __init__(self, probe: RowOperator, build: RowOperator,
                 keys: Sequence[int], mode: str = "inner",
                 post_filter=None, dictionary=None):
        assert mode in ("inner", "left_outer", "semi", "anti")
        self.probe, self.build = probe, build
        self.keys = tuple(keys)
        self.mode = mode
        self.post_filter = post_filter
        self.dictionary = dictionary
        pv, bv = tuple(probe.var_ids()), tuple(build.var_ids())
        self.shared = tuple(x for x in pv if x in bv)
        self._vars = pv if mode in ("semi", "anti") else pv + tuple(
            x for x in bv if x not in pv
        )
        self._table: Optional[Dict[Tuple, List[Row]]] = None
        self._emit: List[Row] = []
        self._ei = 0  # cursor into _emit (front-pops would be O(n) each)
        super().__init__(
            "HashJoin", f"({','.join(f'?v{k}' for k in self.keys)}) row mode={mode}"
        )

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def sorted_by(self) -> Optional[int]:
        if self.mode == "left_outer" and self.post_filter is not None:
            return None
        return self.probe.sorted_by()

    def children(self) -> List[RowOperator]:
        return [self.probe, self.build]

    def _ensure_table(self) -> None:
        if self._table is not None:
            return
        self._table = {}
        while True:
            r = self.build.next_row()
            if r is None:
                break
            key = tuple(r.get(k) for k in self.keys)
            self._table.setdefault(key, []).append(r)

    def _next(self) -> Optional[Row]:
        self._ensure_table()
        while True:
            if self._ei < len(self._emit):
                r = self._emit[self._ei]
                self._ei += 1
                return r
            lrow = self.probe.next_row()
            if lrow is None:
                return None
            group = self._table.get(tuple(lrow.get(k) for k in self.keys), [])
            matches = [
                r for r in group
                if all(lrow.get(s) == r.get(s) for s in self.shared)
            ]
            if self.mode == "semi":
                if matches:
                    return dict(lrow)
                continue
            if self.mode == "anti":
                if not matches:
                    return dict(lrow)
                continue
            out_rows = []
            for r in matches:
                out = dict(lrow)
                for k, v in r.items():
                    out.setdefault(k, v)
                if self.post_filter is not None and not row_holds(
                        self.post_filter, out, self._vars, self.dictionary):
                    continue
                out_rows.append(out)
            if self.mode == "left_outer" and not out_rows:
                out_rows.append(dict(lrow))
            if self.mode == "inner" and not out_rows:
                continue
            self._emit = out_rows
            self._ei = 0

    def _skip(self, var: int, target: int) -> None:
        # buffered rows at or above the target must survive the gallop
        self._emit = [
            r for r in self._emit[self._ei:] if r.get(var, -1) >= target
        ]
        self._ei = 0
        self.probe.skip(var, target)

    def _reset(self) -> None:
        self.probe.reset()
        self.build.reset()
        self._table = None
        self._emit = []
        self._ei = 0


class RowFilter(RowOperator):
    def __init__(self, child: RowOperator, expr: Expr, dictionary: Dictionary):
        self.child, self.expr, self.dictionary = child, expr, dictionary
        super().__init__("Filter", "(row)")
        self.stats.extra["rows_tested"] = 0

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.child.sorted_by()

    def children(self) -> List[RowOperator]:
        return [self.child]

    def _next(self) -> Optional[Row]:
        vars_ = self.child.var_ids()
        while True:
            r = self.child.next_row()
            if r is None:
                return None
            self.stats.extra["rows_tested"] += 1
            if row_holds(self.expr, r, vars_, self.dictionary):
                return r

    def _skip(self, var: int, target: int) -> None:
        self.child.skip(var, target)

    def _reset(self) -> None:
        self.child.reset()


class RowProject(RowOperator):
    def __init__(self, child: RowOperator, keep: Sequence[int]):
        self.child, self.keep = child, tuple(keep)
        super().__init__("Project", "(row)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.keep

    def sorted_by(self) -> Optional[int]:
        sb = self.child.sorted_by()
        return sb if sb in self.keep else None

    def children(self) -> List[RowOperator]:
        return [self.child]

    def _next(self) -> Optional[Row]:
        r = self.child.next_row()
        if r is None:
            return None
        return {v: r[v] for v in self.keep if v in r}

    def _skip(self, var: int, target: int) -> None:
        self.child.skip(var, target)

    def _reset(self) -> None:
        self.child.reset()


class RowDistinct(RowOperator):
    def __init__(self, child: RowOperator):
        self.child = child
        self._seen: set = set()
        super().__init__("Distinct", "(row hash)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def children(self) -> List[RowOperator]:
        return [self.child]

    def _next(self) -> Optional[Row]:
        while True:
            r = self.child.next_row()
            if r is None:
                return None
            key = tuple(sorted(r.items()))
            if key not in self._seen:
                self._seen.add(key)
                return r

    def _reset(self) -> None:
        self.child.reset()
        self._seen.clear()


class RowGroupBy(RowOperator):
    """Hash-based GROUP BY (the legacy engine's general algorithm)."""

    def __init__(self, child: RowOperator, group_vars: Sequence[int],
                 aggs: Sequence[AggSpec], dictionary: Dictionary):
        self.child = child
        self.group_vars = tuple(group_vars)
        self.aggs = list(aggs)
        self.dictionary = dictionary
        self._out: Optional[Iterator] = None
        super().__init__("Group", "(row hash)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.group_vars + tuple(a.out for a in self.aggs)

    def children(self) -> List[RowOperator]:
        return [self.child]

    def _fresh_state(self) -> List[dict]:
        return [dict(count=0.0, bound=0.0, sum=0.0, min=np.inf, max=-np.inf,
                     nn=0.0, distinct=set()) for _ in self.aggs]

    def _build(self) -> Iterator[Row]:
        d = self.dictionary
        groups: Dict[Tuple, List] = {}
        while True:
            r = self.child.next_row()
            if r is None:
                break
            key = tuple(r.get(v, NULL_ID) for v in self.group_vars)
            st = groups.get(key)
            if st is None:
                st = self._fresh_state()
                groups[key] = st
            for ai, a in enumerate(self.aggs):
                s = st[ai]
                s["count"] += 1
                if a.var is None:
                    continue
                code = r.get(a.var)
                if code is None:
                    continue  # unbound rows never feed an aggregate
                s["bound"] += 1
                if a.distinct:
                    # dedup by bound code; the aggregate function applies
                    # over the distinct set at finalization
                    s["distinct"].add(code)
                    continue
                v = d.numeric_value(code)
                if v == v:  # not NaN
                    s["nn"] += 1
                    s["sum"] += v
                    s["min"] = min(s["min"], v)
                    s["max"] = max(s["max"], v)
        if not groups and not self.group_vars:
            groups[()] = self._fresh_state()
        for key, st in groups.items():
            row = {v: key[i] for i, v in enumerate(self.group_vars)}
            for ai, a in enumerate(self.aggs):
                s = st[ai]
                if a.distinct and a.var is not None:
                    codes = np.asarray(sorted(s["distinct"]), dtype=np.int64)
                    vals = d.numeric_of(codes)
                    nums = vals[~np.isnan(vals)]
                    if a.func == "count":
                        val = float(len(codes))  # distinct bound terms
                    elif a.func == "sum":
                        val = float(nums.sum()) if len(nums) else 0.0
                    elif a.func == "min":
                        val = float(nums.min()) if len(nums) else None
                    elif a.func == "max":
                        val = float(nums.max()) if len(nums) else None
                    elif a.func == "avg":
                        val = float(nums.mean()) if len(nums) else None
                    else:
                        raise ValueError(a.func)
                elif a.func == "count" and a.var is None:
                    val = s["count"]
                elif a.func == "count":
                    val = s["bound"]  # SPARQL: COUNT counts bound terms
                elif a.func == "sum":
                    val = s["sum"]
                elif a.func == "min":
                    val = s["min"] if s["nn"] else None
                elif a.func == "max":
                    val = s["max"] if s["nn"] else None
                elif a.func == "avg":
                    val = s["sum"] / s["nn"] if s["nn"] else None
                else:
                    raise ValueError(a.func)
                if val is None:
                    continue  # empty / non-numeric group: leave unbound
                enc = int(val) if float(val).is_integer() else float(val)
                row[a.out] = d.encode(enc)
            yield row

    def _next(self) -> Optional[Row]:
        if self._out is None:
            self._out = self._build()
        return next(self._out, None)

    def _reset(self) -> None:
        self.child.reset()
        self._out = None


class RowSort(RowOperator):
    def __init__(self, child: RowOperator, var: Optional[int] = None,
                 keys: Optional[Sequence[SortKey]] = None,
                 dictionary: Optional[Dictionary] = None):
        self.child = child
        self.var = var
        self.keys = keys
        self.dictionary = dictionary
        self._rows: Optional[List[Row]] = None
        self._i = 0
        super().__init__("Sort", f"(?v{var})" if var is not None else "(order by)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.var

    def children(self) -> List[RowOperator]:
        return [self.child]

    def _ensure(self) -> None:
        if self._rows is not None:
            return
        rows = self.child.drain()
        if self.var is not None:
            rows.sort(key=lambda r: r.get(self.var, NULL_ID))
        else:
            d = self.dictionary

            def key(r):
                ks = []
                for k in self.keys:
                    code = r.get(k.var, NULL_ID)
                    v = d.numeric_value(code)
                    nan = v != v
                    prim = np.inf if nan else (v if k.ascending else -v)
                    tie = (code if k.ascending else -code) if nan else 0
                    ks.extend([prim, tie])
                return tuple(ks)
            rows.sort(key=key)
        self._rows = rows

    def _next(self) -> Optional[Row]:
        self._ensure()
        if self._i >= len(self._rows):
            return None
        r = self._rows[self._i]
        self._i += 1
        return r

    def _skip(self, var: int, target: int) -> None:
        assert var == self.var
        self._ensure()
        while self._i < len(self._rows) and self._rows[self._i].get(var, -1) < target:
            self._i += 1

    def _reset(self) -> None:
        self.child.reset()
        self._rows = None
        self._i = 0


class RowLimit(RowOperator):
    def __init__(self, child: RowOperator, limit: Optional[int], offset: int = 0):
        self.child = child
        self.limit, self.offset = limit, offset
        self._seen = 0
        self._emitted = 0
        super().__init__("Slice", "(row)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def sorted_by(self) -> Optional[int]:
        return self.child.sorted_by()

    def children(self) -> List[RowOperator]:
        return [self.child]

    def _next(self) -> Optional[Row]:
        while True:
            if self.limit is not None and self._emitted >= self.limit:
                return None
            r = self.child.next_row()
            if r is None:
                return None
            self._seen += 1
            if self._seen <= self.offset:
                continue
            self._emitted += 1
            return r

    def _reset(self) -> None:
        self.child.reset()
        self._seen = self._emitted = 0


class RowUnion(RowOperator):
    def __init__(self, left: RowOperator, right: RowOperator):
        self.left, self.right = left, right
        lv = tuple(left.var_ids())
        self._vars = lv + tuple(v for v in right.var_ids() if v not in lv)
        self._on_right = False
        super().__init__("Union", "(row)")

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def children(self) -> List[RowOperator]:
        return [self.left, self.right]

    def _next(self) -> Optional[Row]:
        if not self._on_right:
            r = self.left.next_row()
            if r is not None:
                return r
            self._on_right = True
        return self.right.next_row()

    def _reset(self) -> None:
        self.left.reset()
        self.right.reset()
        self._on_right = False


class RowBindJoin(RowOperator):
    """Block-based bind join: pull a block of ~1K left tuples, push their
    join-key bindings into the right side (re-scoped via skip), evaluate,
    repeat. The legacy optimizer prefers this plan shape for amplifying
    joins."""

    def __init__(self, left: RowOperator, right_factory, join_var: int,
                 block_size: int = 1024):
        self.left = left
        self.right_factory = right_factory  # (code,) -> RowOperator for bound key
        self.v = join_var
        self.block_size = block_size
        self._block: List[Row] = []
        self._bi = 0
        self._right: Optional[RowOperator] = None
        self._left_done = False
        lv = tuple(left.var_ids())
        probe = right_factory(0)
        self._vars = lv + tuple(x for x in probe.var_ids() if x not in lv)
        super().__init__("BindJoin", f"(?v{join_var}) block={block_size}")

    def var_ids(self) -> Tuple[int, ...]:
        return self._vars

    def children(self) -> List[RowOperator]:
        return [self.left]

    def _next(self) -> Optional[Row]:
        while True:
            if self._right is not None:
                r = self._right.next_row()
                while r is not None:
                    lrow = self._block[self._bi]
                    if all(lrow.get(k) == r.get(k) for k in r if k in lrow):
                        out = dict(lrow)
                        out.update(r)
                        return out
                    r = self._right.next_row()
                self._right = None
                self._bi += 1
            if self._bi < len(self._block):
                lrow = self._block[self._bi]
                self._right = self.right_factory(lrow[self.v])
                continue
            if self._left_done:
                return None
            self._block = []
            self._bi = 0
            while len(self._block) < self.block_size:
                lr = self.left.next_row()
                if lr is None:
                    self._left_done = True
                    break
                self._block.append(lr)
            if not self._block and self._left_done:
                return None

    def _reset(self) -> None:
        self.left.reset()
        self._block, self._bi, self._right = [], 0, None
        self._left_done = False
