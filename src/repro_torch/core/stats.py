"""Cardinality estimation for the cost-based optimizer (paper §2.2.2).

Stardog's estimation stack: precomputed graph statistics (predicate
cardinality, distinct subjects/objects per predicate), characteristic sets
enhanced with count-min sketches, and independence heuristics. We implement
the same shape at laptop scale:

  * exact pattern ranges (the sorted indexes give them in O(log n));
  * per-predicate distinct-subject/object counts;
  * characteristic sets (the set of predicates each subject has) for
    star-join estimation [Neumann & Moerkotte, ICDE'11];
  * a count-min sketch over subject frequencies for bound-term estimates
    on skewed graphs [Cormode & Muthukrishnan '05].

Join estimates use the System-R containment rule
|A ⋈_v B| ≈ |A|·|B| / max(d_A(v), d_B(v)).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.algebra import K, PathPattern, TriplePattern, V
from repro_torch.core.paths.expr import PAlt, PClosure, PInv, PLink, PSeq
from repro_torch.core.storage import INDEX_ORDERS, QuadStore

# depth cap for closure estimation: BFS deeper than this contributes little
# to the *estimate* (real evaluation is exact; this only prices plans)
CLOSURE_DEPTH_CAP = 16


class CountMinSketch:
    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 7):
        rng = np.random.RandomState(seed)
        self.width = width
        self.depth = depth
        self.salts = rng.randint(1, 2**31 - 1, size=depth).astype(np.uint32)
        self.table = np.zeros((depth, width), dtype=np.int64)

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        keys = keys.astype(np.uint32)
        return np.stack(
            [((keys * s) >> np.uint32(16)) % self.width for s in self.salts]
        )

    def add_many(self, keys: np.ndarray) -> None:
        rows = self._rows(keys)
        for d in range(self.depth):
            np.add.at(self.table[d], rows[d], 1)

    def estimate(self, key: int) -> int:
        rows = self._rows(np.asarray([key]))
        return int(min(self.table[d, rows[d, 0]] for d in range(self.depth)))


class GraphStats:
    def __init__(self, store: QuadStore):
        self.store = store
        spoc = store.index_array("spoc")
        self.n_quads = len(spoc)
        preds = spoc[:, 1]
        self.pred_count: Dict[int, int] = dict(
            zip(*[a.tolist() for a in np.unique(preds, return_counts=True)])
        )
        # distinct subjects/objects per predicate (posc is sorted by p,o,s)
        self.distinct_subj: Dict[int, int] = {}
        self.distinct_obj: Dict[int, int] = {}
        for p in self.pred_count:
            m = preds == p
            self.distinct_subj[p] = int(len(np.unique(spoc[m, 0])))
            self.distinct_obj[p] = int(len(np.unique(spoc[m, 2])))
        self.total_distinct_subj = int(len(np.unique(spoc[:, 0]))) or 1
        self.total_distinct_obj = int(len(np.unique(spoc[:, 2]))) or 1
        # characteristic sets: predicate-set signature -> #subjects
        self.char_sets: Counter = Counter()
        if self.n_quads:
            order = np.lexsort((preds, spoc[:, 0]))
            ss, pp = spoc[order, 0], preds[order]
            boundaries = np.nonzero(np.diff(ss))[0] + 1
            start = 0
            for end in list(boundaries) + [len(ss)]:
                sig = frozenset(np.unique(pp[start:end]).tolist())
                self.char_sets[sig] += 1
                start = end
        # count-min sketch over subject occurrence frequencies
        self.subj_sketch = CountMinSketch()
        if self.n_quads:
            self.subj_sketch.add_many(spoc[:, 0])

    # -- estimates ----------------------------------------------------------------

    def pattern_cardinality(self, pattern: TriplePattern) -> int:
        bound = self._bound(pattern)
        return self.store.pattern_cardinality(bound)

    def distinct_values(self, pattern: TriplePattern, var: int) -> int:
        """Estimated distinct bindings for ``var`` in the pattern's result."""
        card = max(self.pattern_cardinality(pattern), 1)
        p_id = (
            self.store.dict.lookup(pattern.p.term)
            if isinstance(pattern.p, K)
            else None
        )
        role = None
        for r, sl in enumerate((pattern.s, pattern.p, pattern.o)):
            if isinstance(sl, V) and sl.id == var:
                role = r
                break
        if role == 0:  # subject
            d = self.distinct_subj.get(p_id, self.total_distinct_subj)
        elif role == 2:  # object
            d = self.distinct_obj.get(p_id, self.total_distinct_obj)
        else:  # predicate or graph var
            d = max(len(self.pred_count), 1)
        return max(1, min(d, card))

    # -- property-path estimates (DESIGN.md §8) ------------------------------------

    @staticmethod
    def closure_multiplier(card: int, d_subj: int, d_obj: int) -> float:
        """Estimated |transitive closure| / |edge relation|.

        Replaces the old hard-coded 3-hop multiplier: with average
        out-degree k = card / d_subj, the per-source reachable set is the
        geometric series sum_{d=1..D} k^d capped at d_obj (every reachable
        node is some edge's object), with D = log_k(d_obj) capped at
        CLOSURE_DEPTH_CAP. For thin graphs (k <= 1, chains/trees) the
        series degenerates and the estimate is the capped average depth.
        """
        if card <= 0:
            return 1.0
        d_subj = max(d_subj, 1)
        d_obj = max(d_obj, 1)
        k = card / d_subj
        if k <= 1.0:
            reach = float(min(d_obj, CLOSURE_DEPTH_CAP))
        else:
            depth = min(math.log(d_obj, k), float(CLOSURE_DEPTH_CAP))
            reach = min(float(d_obj), k * (k ** depth - 1.0) / (k - 1.0))
        return max(reach / k, 1.0)

    def _path_expr_stats(self, expr) -> Tuple[float, int, int]:
        """(cardinality, distinct subjects, distinct objects) of a path
        expression's pair relation."""
        if isinstance(expr, PLink):
            pid = self.store.dict.lookup(expr.pred)
            if pid is None or pid not in self.pred_count:
                return 0.0, 1, 1
            return (
                float(self.pred_count[pid]),
                self.distinct_subj.get(pid, 1),
                self.distinct_obj.get(pid, 1),
            )
        if isinstance(expr, PInv):
            c, ds, do = self._path_expr_stats(expr.sub)
            return c, do, ds
        if isinstance(expr, PSeq):
            c, ds, do = self._path_expr_stats(expr.parts[0])
            for part in expr.parts[1:]:
                c2, ds2, do2 = self._path_expr_stats(part)
                c = self.join_cardinality(max(int(c), 1), max(int(c2), 1), do, ds2)
                do = do2
            return c, min(ds, int(max(c, 1))), min(do, int(max(c, 1)))
        if isinstance(expr, PAlt):
            c = ds = do = 0
            for part in expr.parts:
                c2, ds2, do2 = self._path_expr_stats(part)
                c, ds, do = c + c2, ds + ds2, do + do2
            return c, max(ds, 1), max(do, 1)
        if isinstance(expr, PClosure):
            c, ds, do = self._path_expr_stats(expr.sub)
            n_nodes = max(self.total_distinct_subj, self.total_distinct_obj)
            if expr.max_hops == 1:  # 'p?': sub ∪ identity
                return c + n_nodes, ds, do
            c = c * self.closure_multiplier(int(c), ds, do)
            if expr.min_hops == 0:  # 'p*': closure ∪ identity
                c += n_nodes
            return c, ds, do
        raise TypeError(type(expr))

    def path_cardinality(self, pattern: PathPattern) -> int:
        """Result-size estimate for a PathPattern, bound endpoints applied
        with the same containment logic as triple patterns."""
        card, ds, do = self._path_expr_stats(pattern.expr)
        if isinstance(pattern.s, K):
            card /= max(ds, 1)
        if isinstance(pattern.o, K):
            card /= max(do, 1)
        return max(int(card), 0)

    def path_distinct_values(self, pattern: PathPattern, var: int) -> int:
        card, ds, do = self._path_expr_stats(pattern.expr)
        d = 1
        if isinstance(pattern.s, V) and pattern.s.id == var:
            d = ds
        if isinstance(pattern.o, V) and pattern.o.id == var:
            d = max(d, do)
        return max(1, min(d, int(max(card, 1))))

    def star_cardinality(self, pred_ids: frozenset) -> int:
        """Characteristic-set estimate: subjects having all given predicates."""
        return sum(c for sig, c in self.char_sets.items() if pred_ids <= sig)

    def join_cardinality(
        self,
        card_a: int,
        card_b: int,
        d_a: int,
        d_b: int,
    ) -> float:
        return card_a * card_b / max(d_a, d_b, 1)

    def semi_join_cardinality(
        self,
        card_a: int,
        d_a: int,
        d_b: int,
        anti: bool = False,
    ) -> float:
        """Semi-join estimate under the same containment assumption as
        join_cardinality: the smaller key domain is contained in the
        larger, so a left row finds a match with probability
        min(d_a, d_b) / d_a. ``anti`` returns the complement. This is what
        semi/anti selectivity flows through (replacing the old flat
        left * 0.5, which ignored the right side entirely and skewed the
        hash-vs-merge strategy choice)."""
        match_frac = min(d_a, d_b) / max(d_a, 1)
        frac = (1.0 - match_frac) if anti else match_frac
        return card_a * min(max(frac, 0.0), 1.0)

    def _bound(self, pattern: TriplePattern):
        bound = [None, None, None, None]
        for role, sl in enumerate(
            (pattern.s, pattern.p, pattern.o, pattern.g or None)
        ):
            if isinstance(sl, K):
                tid = self.store.dict.lookup(sl.term)
                bound[role] = -1 if tid is None else tid
        return bound
