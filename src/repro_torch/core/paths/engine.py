"""Batched property-path evaluation on the device: semi-naive delta-frontier
BFS, as in the reference's ``core/paths/engine.py``.

A path expression compiles to an *edge relation* — two int32 device
tensors (src, dst), lexicographically sorted and deduplicated:

  * PLink  — a psoc index slice (already (s, o)-sorted per predicate);
  * PInv   — the sub-relation with columns swapped and re-sorted;
  * PSeq   — relational composition (successor ranges through the
             ``sorted_search`` kernel, then ``join_expand`` and
             ``gather_emit`` windows);
  * PAlt   — union + relation dedup (the ``frontier_dedup`` kernel with an
             empty visited set);
  * PClosure — the frontier engine below (``+``/``*``), or a single
             union with the identity relation (``?``).

Closure runs as multi-source BFS where one *round* expands the whole
frontier as one batch: successor ranges via one ``sorted_search_range``
launch (both sides of the ``sorted_search`` kernel), candidate
(source, node) pairs via ``join_expand`` + ``gather_emit`` windows written
straight into pooled buffers, one sort of the int64 pair key, then one
``frontier_dedup`` launch (adjacent-unique + visited-set mask over the
sorted candidates) yields the delta frontier; only last round's
discoveries are ever expanded. The visited set doubles as the result: it
is exactly the closure pairs, kept sorted by (source, node) throughout.

Host reads per round: the round's candidate total, the delta frontier's
size, and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.core.batch import BatchPool
from repro_torch.core.paths.expr import (
    PAlt,
    PathExpr,
    PClosure,
    PInv,
    PLink,
    PSeq,
    matches_zero_length,
)
from repro_torch.core.storage import QuadStore
from repro_torch.kernels.frontier_dedup import frontier_dedup
from repro_torch.kernels.gather_emit import EmitPlan, gather_emit
from repro_torch.kernels.join_expand import join_expand
from repro_torch.kernels.sorted_search import sorted_search_range

# expansion window: candidates are materialized into the round buffer in
# chunks of this many output slots (bounds the join_expand working set)
EXPAND_WINDOW = 4096
_I32 = torch.int32


def _pow2_cap(n: int) -> int:
    """Power-of-two buffer capacity >= max(n, 32) — pow2 capacities make
    pooled buffers reusable across rounds with different frontier sizes."""
    return 1 << max(int(n) - 1, 31).bit_length()


@dataclasses.dataclass
class PathCounters:
    """Per-engine frontier metrics, plain ints updated from values the
    engine already reads on the host."""

    rounds: int = 0
    frontier_total: int = 0  # sum of frontier sizes over rounds
    frontier_peak: int = 0
    candidates: int = 0  # expansion outputs before dedup
    discovered: int = 0  # delta-frontier pairs after dedup

    @property
    def dedup_ratio(self) -> float:
        """discovered / candidates — 1.0 means no wasted expansion."""
        return self.discovered / self.candidates if self.candidates else 1.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "frontier_rounds": self.rounds,
            "frontier_peak": self.frontier_peak,
            "dedup_in": self.candidates,
            "dedup_out": self.discovered,
        }


@dataclasses.dataclass
class PathResult:
    """Sorted, deduplicated (src, dst) pair relation on the device."""

    src: torch.Tensor
    dst: torch.Tensor

    def __len__(self) -> int:
        return int(self.src.shape[0])

    def swapped(self) -> "PathResult":
        order = torch.sort(vecops._pair_comp(self.dst, self.src)).indices
        return PathResult(self.dst[order], self.src[order])


def _empty(device: torch.device) -> PathResult:
    e = torch.zeros(0, dtype=_I32, device=device)
    return PathResult(e, e)


class _Arena:
    """(2, cap) int32 buffers from the engine's BatchPool: the frontier
    engine's working sets ride the same arena as the operators' batches,
    so its alloc/reuse traffic shows in the pool counters."""

    def __init__(self, pool: Optional[BatchPool], device: torch.device):
        self.pool = pool
        self.device = device
        self._masks: Dict[int, torch.Tensor] = {}

    def acquire(self, n: int) -> torch.Tensor:
        cap = _pow2_cap(n)
        if self.pool is None:
            return torch.empty((2, cap), dtype=_I32, device=self.device)
        cols, mask = self.pool.acquire(2, cap)
        self._masks[id(cols)] = mask
        return cols

    def release(self, cols: Optional[torch.Tensor]) -> None:
        if cols is None or self.pool is None:
            return
        mask = self._masks.pop(id(cols), None)
        if mask is None:
            mask = torch.empty(cols.shape[1], dtype=torch.bool, device=self.device)
        self.pool.release(cols, mask)


class PathEngine:
    """Compiles path expressions against one store and runs closures on
    the store's device."""

    def __init__(self, store: QuadStore, pool: Optional[BatchPool] = None):
        self.store = store
        self.device = store.device
        self.arena = _Arena(pool, self.device)
        self.counters = PathCounters()
        self._domain: Optional[torch.Tensor] = None
        self._no_pairs = torch.zeros(0, dtype=_I32, device=self.device)
        self._emit_plan = EmitPlan((0,), (0,))  # row 0 of each side

    # -- public -------------------------------------------------------------

    def evaluate(self, expr: PathExpr, seeds: Optional[torch.Tensor] = None,
                 reverse: bool = False) -> PathResult:
        """Pairs of ``expr``. With ``seeds`` (sorted unique int32 codes) the
        result is restricted to pairs whose subject (or object, when
        ``reverse`` — bound-object expansion over flipped edges) is a seed;
        a top-level unbounded closure then runs BFS from the seeds only
        instead of materializing the whole closure."""
        if seeds is not None and isinstance(expr, PClosure) and expr.max_hops == -1:
            base = self.relation(expr.sub)
            if reverse:
                base = base.swapped()
            res = self._closure(base, seeds)
            if expr.min_hops == 0:
                res = _union(res, PathResult(seeds, seeds))
            return res.swapped() if reverse else res
        rel = self.relation(expr)
        if seeds is None:
            return rel
        if reverse:
            rel = rel.swapped()
        keep = torch.isin(rel.src, seeds)
        res = PathResult(rel.src[keep], rel.dst[keep])
        if matches_zero_length(expr):
            # bound endpoints reach themselves via the empty walk even when
            # off-graph (the relation's identity only spans graph nodes)
            res = _union(res, PathResult(seeds, seeds))
        return res.swapped() if reverse else res

    # -- relation compilation ----------------------------------------------

    def relation(self, expr: PathExpr) -> PathResult:
        if isinstance(expr, PLink):
            return self._link(expr.pred)
        if isinstance(expr, PInv):
            return self.relation(expr.sub).swapped()
        if isinstance(expr, PSeq):
            rel = self.relation(expr.parts[0])
            for part in expr.parts[1:]:
                rel = self._compose(rel, self.relation(part))
            return rel
        if isinstance(expr, PAlt):
            parts = [self.relation(p) for p in expr.parts]
            return _dedup_rel(
                torch.cat([p.src for p in parts]), torch.cat([p.dst for p in parts])
            )
        if isinstance(expr, PClosure):
            sub = self.relation(expr.sub)
            if expr.max_hops == 1:  # 'p?': one hop or zero
                res = sub
            else:
                res = self._closure(sub, torch.unique(sub.src).to(_I32))
            if expr.min_hops == 0:
                dom = self._graph_domain()
                res = _union(res, PathResult(dom, dom))
            return res
        raise TypeError(type(expr))

    def _link(self, pred) -> PathResult:
        pid = self.store.dict.lookup(pred)
        if pid is None:
            return _empty(self.device)
        rng = self.store.range_for_pattern("psoc", (None, pid, None, None))
        cols = self.store.index_columns("psoc")  # (p, s, o, c) lex-sorted
        src, dst = cols[1][rng.lo: rng.hi], cols[2][rng.lo: rng.hi]
        # the slice is (s, o)-sorted; the same triple in several named
        # graphs duplicates pairs, so run the adjacent-unique mask
        mask = frontier_dedup(src, dst, self._no_pairs, self._no_pairs)
        if not bool(mask.all()):
            src, dst = src[mask], dst[mask]
        return PathResult(src, dst)

    def _graph_domain(self) -> torch.Tensor:
        """All terms used as subject or object (the zero-length path
        domain; DESIGN.md §8)."""
        if self._domain is None:
            cols = self.store.index_columns("spoc")
            self._domain = torch.unique(torch.cat([cols[0], cols[2]])).to(_I32)
        return self._domain

    # -- composition ---------------------------------------------------------

    def _compose(self, a: PathResult, b: PathResult) -> PathResult:
        """a ∘ b: pairs (x, z) with (x, y) ∈ a, (y, z) ∈ b."""
        if not len(a) or not len(b):
            return _empty(self.device)
        out, total = self._expand(a.dst, a.src, b)
        src, dst = out[0, :total].clone(), out[1, :total].clone()
        self.arena.release(out)
        return _dedup_rel(src, dst)

    def _expand(self, nodes: torch.Tensor, carry: torch.Tensor,
                rel: PathResult) -> Tuple[torch.Tensor, int]:
        """One batched successor expansion: for row i, every ``rel`` edge
        whose src equals ``nodes[i]`` emits (carry[i], rel.dst[edge]) into
        rows 0 and 1 of a pooled buffer. Returns (buffer, total); the caller
        releases the buffer."""
        lo, hi = sorted_search_range(rel.src, nodes)
        lens = hi - lo
        n = int(nodes.shape[0])
        ones = torch.ones(n, dtype=_I32, device=self.device)
        idx = torch.arange(n, dtype=_I32, device=self.device)
        cum = vecops.group_output_offsets(ones, lens)
        total = int(cum[-1])
        out = self.arena.acquire(total)
        lcols, rcols = carry[None, :], rel.dst[None, :]
        for base in range(0, total, EXPAND_WINDOW):
            count = min(EXPAND_WINDOW, total - base)
            li, ri = join_expand(idx, ones, lo, lens, cum, base, count)
            gather_emit(lcols, rcols, li, ri, self._emit_plan, out=out, out_offset=base)
        return out, total

    # -- the frontier engine -------------------------------------------------

    def _closure(self, rel: PathResult, seeds: torch.Tensor) -> PathResult:
        """Transitive closure restricted to ``seeds`` (sorted unique), via
        semi-naive delta-frontier iteration. Result pairs are (seed, node),
        node reached in >= 1 hops, sorted by (seed, node)."""
        c = self.counters
        n_seed = int(seeds.shape[0])
        vis_hi = vis_lo = self._no_pairs  # (seed index, node), lex-sorted
        if n_seed == 0 or not len(rel):
            return _empty(self.device)
        # round-0 frontier: the seeds themselves (not part of the result —
        # min_hops >= 1; a cycle back to the seed re-discovers it normally)
        f_buf = self.arena.acquire(n_seed)
        f_buf[0, :n_seed] = torch.arange(n_seed, dtype=_I32, device=self.device)
        f_buf[1, :n_seed] = seeds
        n_f = n_seed
        while n_f:
            c.rounds += 1
            c.frontier_total += n_f
            c.frontier_peak = max(c.frontier_peak, n_f)
            cand_buf, total = self._expand(f_buf[1, :n_f], f_buf[0, :n_f], rel)
            self.arena.release(f_buf)
            f_buf = None
            if total == 0:
                self.arena.release(cand_buf)
                break
            c.candidates += total
            # one sort of the pair key, then one dedup launch
            order = torch.sort(
                vecops._pair_comp(cand_buf[0, :total], cand_buf[1, :total])
            ).indices
            sort_buf = self.arena.acquire(total)
            s_hi, s_lo = sort_buf[0, :total], sort_buf[1, :total]
            torch.index_select(cand_buf[0, :total], 0, order, out=s_hi)
            torch.index_select(cand_buf[1, :total], 0, order, out=s_lo)
            self.arena.release(cand_buf)
            new_idx = torch.nonzero(frontier_dedup(s_hi, s_lo, vis_hi, vis_lo)).flatten()
            n_f = int(new_idx.shape[0])
            c.discovered += n_f
            if n_f:
                f_buf = self.arena.acquire(n_f)
                torch.index_select(s_hi, 0, new_idx, out=f_buf[0, :n_f])
                torch.index_select(s_lo, 0, new_idx, out=f_buf[1, :n_f])
                vis_hi, vis_lo = vecops.merge_sorted_pairs(
                    vis_hi, vis_lo, f_buf[0, :n_f], f_buf[1, :n_f]
                )
            self.arena.release(sort_buf)
        self.arena.release(f_buf)
        # visited == closure pairs; map seed indices back to codes (sorted
        # seeds keep the (src, dst) order lexicographic)
        return PathResult(seeds[vis_hi.long()], vis_lo)


# -- relation helpers ---------------------------------------------------------


def _dedup_rel(src: torch.Tensor, dst: torch.Tensor) -> PathResult:
    if not int(src.shape[0]):
        return _empty(src.device)
    order = torch.sort(vecops._pair_comp(src, dst)).indices
    src, dst = src[order], dst[order]
    none = src.new_zeros(0)
    mask = frontier_dedup(src, dst, none, none)
    if not bool(mask.all()):
        src, dst = src[mask], dst[mask]
    return PathResult(src, dst)


def _union(a: PathResult, b: PathResult) -> PathResult:
    return _dedup_rel(torch.cat([a.src, b.src]), torch.cat([a.dst, b.dst]))
