"""Row-based property-path operators over the store's host index arrays.

The vectorized subsystem (``core/paths``, ``operators/path.py``) runs
paths on the batch pipeline; these row/set implementations are (a) the
legacy engine's path evaluator and (b) an independent oracle:
``eval_path_pairs`` evaluates any path expression with pure Python sets —
deliberately no shared code with the kernel path.

RowTransitivePath keeps the per-source scalar BFS for `+` (the row node
``PPathScan``). Everything here reads ``QuadStore.index_array`` on the
host, never the device columns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.algebra import K, Slot, V
from repro_torch.core.legacy.operators import Row, RowOperator
from repro_torch.core.paths.expr import (
    PAlt,
    PathExpr,
    PClosure,
    PInv,
    PLink,
    PSeq,
    matches_zero_length,
    path_repr,
)
from repro_torch.core.storage import QuadStore


class RowTransitivePath(RowOperator):
    def __init__(self, store: QuadStore, pred, var_s: int, var_o: int):
        self.store = store
        self.var_s, self.var_o = var_s, var_o
        pid = store.dict.lookup(pred)
        arr = store.index_array("psoc")  # (p, s, o, c)
        if pid is None:
            self.edges = np.zeros((0, 2), dtype=np.int32)
        else:
            lo = int(np.searchsorted(arr[:, 0], pid, side="left"))
            hi = int(np.searchsorted(arr[:, 0], pid, side="right"))
            self.edges = arr[lo:hi, 1:3]  # (s, o), subject-sorted
        self.subjects = np.unique(self.edges[:, 0]) if len(self.edges) else np.zeros(0, np.int32)
        self._src_idx = 0
        self._targets: List[int] = []
        self._t_idx = 0
        super().__init__("PathScan", f"(?v{var_s}, +, ?v{var_o}) row-based")

    def var_ids(self) -> Tuple[int, ...]:
        return (self.var_s, self.var_o)

    def sorted_by(self) -> Optional[int]:
        return self.var_s

    def _successors(self, node: int) -> np.ndarray:
        lo = int(np.searchsorted(self.edges[:, 0], node, side="left"))
        hi = int(np.searchsorted(self.edges[:, 0], node, side="right"))
        return self.edges[lo:hi, 1]

    def _bfs(self, src: int) -> List[int]:
        seen: Set[int] = set()
        frontier = [src]
        order: List[int] = []
        while frontier:
            nxt: List[int] = []
            for u in frontier:
                for v in self._successors(u).tolist():
                    if v not in seen:
                        seen.add(v)
                        order.append(v)
                        nxt.append(v)
            frontier = nxt
        return sorted(order)  # deterministic object order within a subject

    def _next(self) -> Optional[Row]:
        while True:
            if self._t_idx < len(self._targets):
                src = int(self.subjects[self._src_idx - 1])
                tgt = self._targets[self._t_idx]
                self._t_idx += 1
                return {self.var_s: src, self.var_o: tgt}
            if self._src_idx >= len(self.subjects):
                return None
            src = int(self.subjects[self._src_idx])
            self._src_idx += 1
            self._targets = self._bfs(src)
            self._t_idx = 0
            self.stats.rows_scanned += len(self._targets)

    def _skip(self, var: int, target: int) -> None:
        assert var == self.var_s
        # gallop the source cursor; discard the in-flight target list if the
        # current source falls below the target
        pos = int(np.searchsorted(self.subjects, target, side="left"))
        if pos > self._src_idx - 1:
            self._src_idx = pos
            self._targets, self._t_idx = [], 0
        elif self._src_idx >= 1 and int(self.subjects[self._src_idx - 1]) < target:
            self._targets, self._t_idx = [], 0

    def _reset(self) -> None:
        self._src_idx = 0
        self._targets, self._t_idx = [], 0


# ---------------------------------------------------------------------------
# set-based oracle for arbitrary path expressions
# ---------------------------------------------------------------------------


def _graph_domain(store: QuadStore) -> Set[int]:
    """Zero-length path domain: every term used as subject or object."""
    spoc = store.index_array("spoc")
    return set(spoc[:, 0].tolist()) | set(spoc[:, 2].tolist())


def eval_path_pairs(store: QuadStore, expr: PathExpr) -> Set[Tuple[int, int]]:
    """All (subject, object) code pairs of a path expression, computed
    with Python sets (deliberately kernel-free: the parity oracle)."""
    if isinstance(expr, PLink):
        pid = store.dict.lookup(expr.pred)
        if pid is None:
            return set()
        arr = store.index_array("psoc")
        lo = int(np.searchsorted(arr[:, 0], pid, side="left"))
        hi = int(np.searchsorted(arr[:, 0], pid, side="right"))
        return {(int(s), int(o)) for s, o in arr[lo:hi, 1:3]}
    if isinstance(expr, PInv):
        return {(o, s) for s, o in eval_path_pairs(store, expr.sub)}
    if isinstance(expr, PSeq):
        pairs = eval_path_pairs(store, expr.parts[0])
        for part in expr.parts[1:]:
            nxt: Dict[int, Set[int]] = {}
            for s, o in eval_path_pairs(store, part):
                nxt.setdefault(s, set()).add(o)
            pairs = {(s, z) for s, o in pairs for z in nxt.get(o, ())}
        return pairs
    if isinstance(expr, PAlt):
        out: Set[Tuple[int, int]] = set()
        for part in expr.parts:
            out |= eval_path_pairs(store, part)
        return out
    if isinstance(expr, PClosure):
        base = eval_path_pairs(store, expr.sub)
        if expr.max_hops == 1:
            pairs = set(base)
        else:
            adj: Dict[int, Set[int]] = {}
            for s, o in base:
                adj.setdefault(s, set()).add(o)
            pairs = set()
            for src in adj:
                seen: Set[int] = set()
                frontier = [src]
                while frontier:
                    nxt_frontier: List[int] = []
                    for u in frontier:
                        for v in adj.get(u, ()):
                            if v not in seen:
                                seen.add(v)
                                nxt_frontier.append(v)
                    frontier = nxt_frontier
                pairs |= {(src, t) for t in seen}
        if expr.min_hops == 0:
            pairs |= {(d, d) for d in _graph_domain(store)}
        return pairs
    raise TypeError(type(expr))


class RowPathScan(RowOperator):
    """Legacy-engine evaluator for arbitrary path patterns: materializes
    ``eval_path_pairs`` filtered by bound endpoints, emits rows sorted by
    the subject (then object) variable."""

    def __init__(self, store: QuadStore, expr: PathExpr, s_slot: Slot, o_slot: Slot):
        self.store = store
        self.expr = expr
        self.s_slot, self.o_slot = s_slot, o_slot
        pairs = eval_path_pairs(store, expr)
        if matches_zero_length(expr):
            # a bound endpoint matches itself via the empty walk even when
            # the term never appears in the graph
            for sl in (s_slot, o_slot):
                if isinstance(sl, K):
                    tid = store.dict.lookup(sl.term)
                    if tid is not None:
                        pairs.add((tid, tid))
        if isinstance(s_slot, K):
            sid = store.dict.lookup(s_slot.term)
            pairs = {p for p in pairs if p[0] == sid}
        if isinstance(o_slot, K):
            oid = store.dict.lookup(o_slot.term)
            pairs = {p for p in pairs if p[1] == oid}
        if (
            isinstance(s_slot, V)
            and isinstance(o_slot, V)
            and s_slot.id == o_slot.id
        ):
            pairs = {p for p in pairs if p[0] == p[1]}
        self.pairs = sorted(pairs)
        self._i = 0
        super().__init__("PathScan", f"({path_repr(expr)}) row-based")

    def var_ids(self) -> Tuple[int, ...]:
        out = []
        for sl in (self.s_slot, self.o_slot):
            if isinstance(sl, V) and sl.id not in out:
                out.append(sl.id)
        return tuple(out)

    def sorted_by(self) -> Optional[int]:
        if isinstance(self.s_slot, V):
            return self.s_slot.id
        return self.o_slot.id if isinstance(self.o_slot, V) else None

    def _next(self) -> Optional[Row]:
        if self._i >= len(self.pairs):
            return None
        s, o = self.pairs[self._i]
        self._i += 1
        row: Row = {}
        if isinstance(self.s_slot, V):
            row[self.s_slot.id] = s
        if isinstance(self.o_slot, V):
            row[self.o_slot.id] = o
        return row

    def _skip(self, var: int, target: int) -> None:
        if var != self.sorted_by():
            return
        col = 0 if isinstance(self.s_slot, V) else 1
        while self._i < len(self.pairs) and self.pairs[self._i][col] < target:
            self._i += 1

    def _reset(self) -> None:
        self._i = 0
