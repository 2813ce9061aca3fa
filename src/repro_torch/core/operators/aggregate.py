"""Vectorized grouping (paper §3.3) on the device.

StreamingGroupBy handles a single group variable with input sorted by it
(or a global aggregate): every batch reduces to per-run partials with one
``segment_scan`` kernel launch per required statistic, plus a scalar carry
for the run spanning the batch boundary. SortGroupBy groups multi-variable
or unsorted input by sorting once on a packed int64 composite key and
streaming the sorted runs through StreamingGroupBy. StreamingDistinct
scrolls past duplicates with skip(); SortDistinct sorts and dedups.

Semantics follow the reference: COUNT counts bound terms, SUM/MIN/MAX/AVG
restrict to numeric terms, DISTINCT dedups bound codes before the function
applies, and MIN/MAX/AVG over an empty group stay unbound. The partials
come from the float64 scan, as the reference's default numpy backend
computes them: MIN, MAX and COUNT equal it exactly, and a SUM of values
that are not exactly summable differs from its sequential sum only in the
order of the additions.

DISTINCT aggregates (DESIGN.md §10.2) sort each batch once by (group,
code) and take the first occurrence of each pair with the
``frontier_dedup`` kernel (empty visited set); the per-run distinct stats
then reduce through ``segment_scan`` like the others. The run spanning a
batch boundary collects each batch's unique bound codes as device chunks
and dedups them once, with ``torch.unique``, when the run closes; a global
group spans every batch of its input that way.

Under a memory budget the planner marks GROUP BY and DISTINCT inputs over
it partitioned: PartitionedGroupBy and PartitionedDistinct fan the input
out by the group key (every visible column, for DISTINCT) into a
``PartitionedRelation`` that spills to ``spill_dir``, then aggregate or
dedup one partition at a time. Equal keys share a partition, so the
per-partition outputs concatenate into the answer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.core.algebra import AggSpec
from repro_torch.core.batch import MAX_BATCH, NULL_ID, BatchPool, ColumnBatch
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.exprs.vm import numeric_of
from repro_torch.core.operators.base import BatchOperator, HostTimer
from repro_torch.core.operators.sort import MaterializedSource, materialize
from repro_torch.core.partition import PartitionedRelation, fan_in
from repro_torch.kernels.frontier_dedup import frontier_dedup

_F64 = torch.float64

# per-run statistics each (func, distinct) aggregate consumes: 'cnt' is the
# run length, 'bnd'/'nn' count bound / numeric rows, 'sum'/'min'/'max' fold
# numeric values, and the d-prefixed stats fold over the run's distinct
# bound codes
_NEEDS: Dict[Tuple[str, bool], Tuple[str, ...]] = {
    ("count*", False): ("cnt",),
    ("count*", True): ("cnt",),  # hand-built plans only: the parser rejects it
    ("count", False): ("bnd",),
    ("count", True): ("dbnd",),
    ("sum", False): ("sum",),
    ("sum", True): ("dsum",),
    ("min", False): ("min", "nn"),
    ("min", True): ("min", "nn"),  # distinct never changes an extremum
    ("max", False): ("max", "nn"),
    ("max", True): ("max", "nn"),
    ("avg", False): ("sum", "nn"),
    ("avg", True): ("dsum", "dnn"),
}
_DISTINCT_STATS = ("dbnd", "dnn", "dsum")
_SCALAR_INIT = {
    "cnt": 0.0, "bnd": 0.0, "nn": 0.0, "sum": 0.0,
    "min": float("inf"), "max": float("-inf"),
}


def _agg_needs(a: AggSpec) -> Tuple[str, ...]:
    return _NEEDS[("count*" if a.var is None else a.func, a.distinct)]


@dataclasses.dataclass
class _Carry:
    """Partials for the group run spanning the batch boundary: scalars for
    the associative stats, and for DISTINCT count/sum/avg each batch's
    unique bound codes of the run as device chunks, deduped once when the
    run closes."""

    key: Optional[int] = None
    stats: Optional[List[Dict[str, float]]] = None  # per-agg scalar partials
    dcodes: Optional[Dict[int, List[torch.Tensor]]] = None  # per-agg code chunks


class StreamingGroupBy(BatchOperator):
    """GROUP BY <one var> with aggregates over input sorted by that var.
    group_var None => global aggregation (single group)."""

    def __init__(
        self,
        child: BatchOperator,
        group_var: Optional[int],
        aggs: Sequence[AggSpec],
        dictionary: Dictionary,
        device: torch.device,
        batch_size: int = MAX_BATCH,
        pool: Optional[BatchPool] = None,
    ):
        if group_var is not None and child.sorted_by() != group_var:
            raise ValueError("input must be sorted by the group var")
        self.child = child
        self.g = group_var
        self.aggs = list(aggs)
        self.dictionary = dictionary
        self.device = device
        self.batch_size = batch_size
        self.pool = pool
        self._needs = [_agg_needs(a) for a in self.aggs]
        self._dset_aggs = tuple(
            ai for ai, need in enumerate(self._needs)
            if any(s in _DISTINCT_STATS for s in need)
        )
        self._out_keys: List[torch.Tensor] = []
        self._out_vals: List[List[torch.Tensor]] = [[] for _ in self.aggs]
        self._carry = _Carry()
        self._enc_keys: Optional[torch.Tensor] = None
        self._enc_cols: List[torch.Tensor] = []
        self._emitted = 0
        self._drained = False
        self._zero_counters()
        super().__init__(
            "Group",
            f"by=?v{group_var} " + ",".join(f"{a.func}->?v{a.out}" for a in aggs),
        )

    def var_ids(self) -> Tuple[int, ...]:
        base = (self.g,) if self.g is not None else ()
        return base + tuple(a.out for a in self.aggs)

    def sorted_by(self) -> Optional[int]:
        return self.g

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _zero_counters(self) -> None:
        # segment_scan and frontier_dedup dispatches with their host time
        # (on the card the time to enqueue them), and the runs consumed
        self._sr = HostTimer()
        self._dd = HostTimer()
        self._runs = 0

    def _reduce(self, keys: torch.Tensor, values: Optional[torch.Tensor],
                func: str) -> torch.Tensor:
        with self._sr:
            return vecops.segment_reduce(keys, values, func)[1]

    # -- aggregation -------------------------------------------------------------

    def _consume_all(self) -> None:
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            cb = b.compact()
            if cb.n_rows == 0:
                cb.release()
                continue
            keys = (
                cb.column(self.g)
                if self.g is not None
                else torch.zeros(cb.n_rows, dtype=torch.int32, device=self.device)
            )
            self._consume_batch(keys, cb)
            cb.release()  # per-run partials copied into outputs / carry
        self._close_carry()
        if self.g is None and not self._out_keys:
            # global aggregate over empty input still yields one row
            # (COUNT = 0, SUM = 0; MIN/MAX/AVG stay unbound)
            self._carry = self._open_carry(0)
            self._close_carry()
        ex = self.stats.extra
        ex["group_runs"] = self._runs
        ex["segment_reduce"] = self._sr.calls
        ex["segment_reduce_ms"] = self._sr.ms
        if self._dd.calls:
            ex["distinct_dedup"] = self._dd.calls
            ex["distinct_dedup_ms"] = self._dd.ms
        self._drained = True

    def _batch_stats(self, keys: torch.Tensor, cb: ColumnBatch):
        """(stats, dinfo): stats[ai][stat] is a (n_runs,) float64 tensor of
        per-run partials, one segment_scan launch per distinct (var, stat)
        pair; dinfo[ai], for each DISTINCT count/sum/avg, is the (group,
        code)-sorted batch's (keys, codes, first-bound-occurrence mask),
        from which a boundary run's unique bound codes are sliced."""
        col_cache: Dict[int, Dict[str, torch.Tensor]] = {}
        dsort_cache: Dict[int, Tuple[torch.Tensor, ...]] = {}
        job_cache: Dict[Tuple[int, str], torch.Tensor] = {}

        def cols_of(var: int) -> Dict[str, torch.Tensor]:
            c = col_cache.get(var)
            if c is None:
                codes = cb.column(var)
                vals = numeric_of(self.dictionary, codes)
                c = {"codes": codes, "vals": vals, "valid": ~torch.isnan(vals)}
                col_cache[var] = c
            return c

        def dsort_of(var: int) -> Tuple[torch.Tensor, ...]:
            d = dsort_cache.get(var)
            if d is None:
                c = cols_of(var)
                # sorting by (group, code) permutes rows only inside runs
                order = torch.sort(vecops._pair_comp(keys, c["codes"])).indices
                skeys, scodes = keys[order], c["codes"][order]
                # first occurrence of each (group, code) pair: the
                # frontier_dedup kernel with an empty visited set, over
                # codes + 1 so that NULL (-1) stays non-negative
                none = skeys.new_zeros(0)
                with self._dd:
                    first = frontier_dedup(skeys, scodes + 1, none, none)
                d = (skeys, scodes, c["vals"][order], first & (scodes >= 0))
                dsort_cache[var] = d
            return d

        def job(var: Optional[int], stat: str) -> torch.Tensor:
            key = (-1 if var is None else var, stat)
            out = job_cache.get(key)
            if out is not None:
                return out
            if stat == "cnt":
                out = self._reduce(keys, None, "count")
            elif stat in _DISTINCT_STATS:
                skeys, _, svals, keep = dsort_of(var)
                if stat == "dbnd":
                    out = self._reduce(skeys, keep.to(_F64), "sum")
                else:
                    dv = keep & ~torch.isnan(svals)
                    out = self._reduce(
                        skeys, dv.to(_F64) if stat == "dnn" else torch.where(dv, svals, 0.0),
                        "sum")
            else:
                c = cols_of(var)
                if stat == "bnd":
                    out = self._reduce(keys, (c["codes"] >= 0).to(_F64), "sum")
                elif stat == "nn":
                    out = self._reduce(keys, c["valid"].to(_F64), "sum")
                elif stat == "sum":
                    out = self._reduce(keys, torch.where(c["valid"], c["vals"], 0.0), "sum")
                elif stat == "min":
                    out = self._reduce(
                        keys, torch.where(c["valid"], c["vals"], float("inf")), "min")
                else:
                    out = self._reduce(
                        keys, torch.where(c["valid"], c["vals"], float("-inf")), "max")
            job_cache[key] = out
            return out

        stats = [
            {stat: job(a.var, stat) for stat in need}
            for a, need in zip(self.aggs, self._needs)
        ]
        dinfo = {ai: dsort_of(self.aggs[ai].var) for ai in self._dset_aggs}
        return stats, dinfo

    def _consume_batch(self, keys: torch.Tensor, cb: ColumnBatch) -> None:
        run_keys, _, _ = vecops.run_boundaries(keys)
        n_runs = int(run_keys.shape[0])
        if n_runs == 0:
            return
        self._runs += n_runs
        stats, dinfo = self._batch_stats(keys, cb)
        i0 = 0
        if self._carry.key is not None:
            if int(run_keys[0]) == self._carry.key:
                # first run continues the open group: fold its partials in
                self._merge_run(stats, dinfo, 0)
                i0 = 1
                if n_runs > 1:
                    self._close_carry()
            else:
                self._close_carry()
        last = n_runs - 1
        if last > i0:
            # every interior run is provably complete: finalize vectorized
            self._out_keys.append(run_keys[i0:last])
            for ai, a in enumerate(self.aggs):
                part = {k: v[i0:last] for k, v in stats[ai].items()}
                self._out_vals[ai].append(self._final(a, part))
        if last >= i0:
            # the last run may span the batch boundary: it becomes the carry
            self._carry = self._open_carry(int(run_keys[last]))
            self._merge_run(stats, dinfo, last)

    def _open_carry(self, key: int) -> _Carry:
        return _Carry(
            key=key,
            stats=[{s: _SCALAR_INIT[s] for s in need if s not in _DISTINCT_STATS}
                   for need in self._needs],
            dcodes={},
        )

    def _merge_run(self, stats, dinfo, r: int) -> None:
        c = self._carry
        names = [(ai, k) for ai in range(len(self.aggs)) for k in stats[ai]
                 if k not in _DISTINCT_STATS]
        if names:
            # one device read for every scalar partial of run r
            vals = torch.stack([stats[ai][k][r] for ai, k in names]).tolist()
            for (ai, k), x in zip(names, vals):
                st = c.stats[ai]
                if k == "min":
                    st["min"] = min(st["min"], x)
                elif k == "max":
                    st["max"] = max(st["max"], x)
                else:
                    st[k] += x
        for ai, (skeys, scodes, _, keep) in dinfo.items():
            # run r's unique bound codes (sorted by construction)
            c.dcodes.setdefault(ai, []).append(scodes[keep & (skeys == c.key)])

    def _close_carry(self) -> None:
        c = self._carry
        if c.key is None:
            return
        self._out_keys.append(
            torch.tensor([c.key], dtype=torch.int32, device=self.device)
        )
        for ai, a in enumerate(self.aggs):
            part = {
                k: torch.tensor([v], dtype=_F64, device=self.device)
                for k, v in c.stats[ai].items()
            }
            if ai in self._dset_aggs:
                chunks = c.dcodes.get(ai)
                codes = (torch.unique(torch.cat(chunks)) if chunks
                         else torch.zeros(0, dtype=torch.int32, device=self.device))
                vals = numeric_of(self.dictionary, codes)
                ok = ~torch.isnan(vals)
                part["dbnd"] = torch.tensor(
                    [float(codes.shape[0])], dtype=_F64, device=self.device)
                part["dnn"] = ok.sum().to(_F64).reshape(1)
                part["dsum"] = torch.where(ok, vals, 0.0).sum().reshape(1)
            self._out_vals[ai].append(self._final(a, part))
        self._carry = _Carry()

    @staticmethod
    def _final(a: AggSpec, st: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-run float64 results; NaN marks an UNBOUND output."""
        nan = float("nan")
        if a.var is None:
            return st["cnt"]
        if a.func == "count":
            return st["dbnd"] if a.distinct else st["bnd"]
        if a.func == "sum":
            return st["dsum"] if a.distinct else st["sum"]
        if a.func == "min":
            return torch.where(st["nn"] > 0, st["min"], nan)
        if a.func == "max":
            return torch.where(st["nn"] > 0, st["max"], nan)
        if a.func == "avg":
            num = st["dsum"] if a.distinct else st["sum"]
            den = st["dnn"] if a.distinct else st["nn"]
            return torch.where(den > 0, num / den.clamp(min=1.0), nan)
        raise ValueError(a.func)

    # -- emission ----------------------------------------------------------------

    def _encode(self, vals: torch.Tensor) -> torch.Tensor:
        """One dictionary.encode per *distinct* value (host), mapped back
        with one gather; NaN rows (unbound aggregates) become NULL_ID."""
        codes = torch.full((vals.shape[0],), NULL_ID, dtype=torch.int32, device=self.device)
        ok = ~torch.isnan(vals)
        uniq, inv = torch.unique(vals[ok], return_inverse=True)
        if uniq.shape[0]:
            ids = torch.tensor(
                [
                    self.dictionary.encode(int(u) if float(u).is_integer() else float(u))
                    for u in uniq.tolist()
                ],
                dtype=torch.int32, device=self.device,
            )
            codes[ok] = ids[inv]
        return codes

    def _next(self) -> Optional[ColumnBatch]:
        if not self._drained:
            self._consume_all()
        if self._enc_keys is None:
            self._enc_keys = (
                torch.cat(self._out_keys) if self._out_keys
                else torch.zeros(0, dtype=torch.int32, device=self.device)
            )
            self._enc_cols = [
                self._encode(
                    torch.cat(v) if v else torch.zeros(0, dtype=_F64, device=self.device)
                )
                for v in self._out_vals
            ]
        n = int(self._enc_keys.shape[0])
        if self._emitted >= n:
            return None
        hi = min(self._emitted + self.batch_size, n)
        sl = slice(self._emitted, hi)
        cols = [self._enc_keys[sl]] if self.g is not None else []
        cols.extend(c[sl] for c in self._enc_cols)
        self._emitted = hi
        return ColumnBatch.from_columns(
            self.var_ids(), cols, self.device, self.g, pool=self.pool
        )

    def _reset(self) -> None:
        self.child.reset()
        self._out_keys = []
        self._out_vals = [[] for _ in self.aggs]
        self._carry = _Carry()
        self._enc_keys = None
        self._enc_cols = []
        self._emitted = 0
        self._drained = False
        self._zero_counters()


# synthetic variable id for the dense group id column (never collides with
# parser-assigned ids, which are non-negative)
_GID = -1


class SortGroupBy(BatchOperator):
    """General GROUP BY (multi-var or unsorted input): drain the needed
    columns, sort ONCE by a packed int64 composite key, assign dense group
    ids, and stream the sorted runs through StreamingGroupBy."""

    def __init__(
        self,
        child: BatchOperator,
        group_vars: Sequence[int],
        aggs: Sequence[AggSpec],
        dictionary: Dictionary,
        device: torch.device,
        batch_size: int = MAX_BATCH,
        pool: Optional[BatchPool] = None,
    ):
        self.child = child
        self.group_vars = tuple(group_vars)
        self.aggs = list(aggs)
        self.dictionary = dictionary
        self.device = device
        self.batch_size = batch_size
        self.pool = pool
        self._src: Optional[BatchOperator] = None
        self._stream: Optional[StreamingGroupBy] = None
        super().__init__("Group", f"by={self.group_vars} (sort-based)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.group_vars + tuple(a.out for a in self.aggs)

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _drain_needed(self, need: Tuple[int, ...]) -> torch.Tensor:
        blocks = []
        while True:
            b = self.child.next_batch()
            if b is None:
                break
            cb = b.compact()
            if cb.n_rows:
                idx = [cb.col_index(v) for v in need]
                blocks.append(cb.columns[idx, : cb.n_rows])  # row gather copies
            cb.release()
        if blocks:
            return torch.cat(blocks, dim=1)
        return torch.zeros((len(need), 0), dtype=torch.int32, device=self.device)

    def _need_vars(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        avars = tuple(dict.fromkeys(a.var for a in self.aggs if a.var is not None))
        return tuple(dict.fromkeys(self.group_vars + avars)), avars

    def _aggregate_block(self, cols: torch.Tensor, need: Tuple[int, ...],
                         avars: Tuple[int, ...]) -> torch.Tensor:
        n = int(cols.shape[1])
        gidx = [need.index(v) for v in self.group_vars]
        key_rows = cols[gidx] if self.group_vars else cols[:0]
        if self.group_vars and n:
            packed = vecops.pack_group_keys(key_rows)
            order = torch.sort(packed, stable=True).indices
            cols = cols[:, order]
            key_rows = cols[gidx]
            _, starts, lengths = vecops.run_boundaries(packed[order])
            gid = torch.repeat_interleave(
                torch.arange(starts.shape[0], dtype=torch.int32, device=self.device),
                lengths.long(),
            )
        else:
            gid = torch.zeros(n, dtype=torch.int32, device=self.device)
            starts = torch.zeros(1 if n else 0, dtype=torch.int32, device=self.device)

        inner = (
            torch.cat([gid[None, :], cols[[need.index(v) for v in avars]]], dim=0)
            if avars else gid[None, :]
        )
        inner_src = MaterializedSource(
            (_GID,) + avars, inner, _GID, self.batch_size,
            name="GroupSortBuffer", pool=self.pool,
        )
        self._stream = StreamingGroupBy(
            inner_src, _GID, self.aggs, self.dictionary, self.device, self.batch_size,
        )
        # drain the stream (one row per group), then translate the dense gid
        # back to the group-key values via each group's first sorted row
        _, scols = materialize(self._stream, self.device)
        first_row = starts[scols[0].long()].long()
        out_cols = [kr[first_row] for kr in key_rows]
        out_cols.extend(scols[1 + ai] for ai in range(len(self.aggs)))
        if out_cols:
            return torch.stack(out_cols, dim=0).to(torch.int32)
        return torch.zeros((0, 0), dtype=torch.int32, device=self.device)

    def _ensure(self) -> BatchOperator:
        if self._src is not None:
            return self._src
        need, avars = self._need_vars()
        cols = self._drain_needed(need)
        block = self._aggregate_block(cols, need, avars)
        self._src = MaterializedSource(
            self.var_ids(), block, None, self.batch_size, name="GroupOut",
            pool=self.pool,
        )
        return self._src

    def _next(self) -> Optional[ColumnBatch]:
        return self._ensure().next_batch()

    def _reset(self) -> None:
        self.child.reset()
        self._src = None
        self._stream = None


class StreamingDistinct(BatchOperator):
    """DISTINCT over input sorted by its (single) visible variable, using
    skip() to scroll past duplicates in storage (paper §3.3)."""

    def __init__(self, child: BatchOperator, var: int, device: torch.device,
                 use_skip: bool = True):
        if child.sorted_by() != var:
            raise ValueError("input must be sorted by the distinct var")
        self.child = child
        self.var = var
        self.device = device
        self.use_skip = use_skip and child.supports_skip()
        self._last: Optional[int] = None
        super().__init__("Distinct", f"(?v{var}) streaming")

    def var_ids(self) -> Tuple[int, ...]:
        return (self.var,)

    def sorted_by(self) -> Optional[int]:
        return self.var

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _next(self) -> Optional[ColumnBatch]:
        while True:
            b = self.child.next_batch()
            if b is None:
                return None
            fb = b.compact()
            cb = fb.project((self.var,))
            fb.release()  # project copied the kept column
            if cb.n_rows == 0:
                continue
            run_keys, _, _ = vecops.run_boundaries(cb.column(self.var))
            if self._last is not None:
                run_keys = run_keys[run_keys != self._last]
            if run_keys.shape[0] == 0:
                continue
            self._last = int(run_keys[-1])
            if self.use_skip:
                # scroll the child past the last seen value
                self.child.skip(self.var, self._last + 1)
            return ColumnBatch.from_columns((self.var,), [run_keys], self.device, self.var)

    def _skip(self, var: int, target: int) -> None:
        self.child.skip(var, target)

    def _reset(self) -> None:
        self.child.reset()
        self._last = None


class SortDistinct(BatchOperator):
    """General DISTINCT: materialize + unique rows (sort-based)."""

    def __init__(self, child: BatchOperator, device: torch.device,
                 batch_size: int = MAX_BATCH):
        self.child = child
        self.device = device
        self.batch_size = batch_size
        self._src: Optional[MaterializedSource] = None
        super().__init__("Distinct", "(sort-based)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _ensure(self) -> MaterializedSource:
        if self._src is None:
            vars_, cols = materialize(self.child, self.device)
            uniq = torch.unique(cols, dim=1) if cols.shape[1] else cols
            sb = vars_[0] if len(vars_) == 1 and uniq.shape[1] else None
            self._src = MaterializedSource(
                vars_, uniq.to(torch.int32), sb, self.batch_size, name="DistinctBuffer"
            )
        return self._src

    def _next(self) -> Optional[ColumnBatch]:
        return self._ensure().next_batch()

    def _reset(self) -> None:
        self.child.reset()
        self._src = None


class PartitionedGroupBy(SortGroupBy):
    """GROUP BY over a partitioned input: the needed columns fan out by
    group key into a budget / spill-aware PartitionedRelation, then the
    sort-based block aggregation runs one partition at a time, so the
    whole input is never sorted or resident at once."""

    def __init__(
        self,
        child: BatchOperator,
        group_vars: Sequence[int],
        aggs: Sequence[AggSpec],
        dictionary: Dictionary,
        device: torch.device,
        batch_size: int = MAX_BATCH,
        pool: Optional[BatchPool] = None,
        memory_budget: Optional[int] = None,
        spill_dir: Optional[str] = None,
        n_parts: int = 16,
    ):
        if not group_vars:
            raise ValueError("partitioned grouping needs group keys")
        super().__init__(child, group_vars, aggs, dictionary, device, batch_size, pool)
        self.memory_budget = memory_budget
        self.spill_dir = spill_dir
        self.n_parts = max(2, n_parts)
        self._rel: Optional[PartitionedRelation] = None
        self.stats.detail = f"by={self.group_vars} (partitioned)"

    def _ensure(self) -> BatchOperator:
        if self._src is not None:
            return self._src
        need, avars = self._need_vars()
        rel = self._rel = PartitionedRelation(
            len(need), self.n_parts, self.device, self.spill_dir, self.memory_budget, self.pool)
        fan_in(self.child, rel, need, self.group_vars)
        blocks = []
        for p in range(self.n_parts):
            part = rel.take(p)
            if part.shape[1]:
                blocks.append(self._aggregate_block(part, need, avars))
        block = (torch.cat(blocks, dim=1) if blocks else
                 torch.zeros((len(self.var_ids()), 0), dtype=torch.int32, device=self.device))
        self.stats.extra["grace_partitions"] = self.n_parts
        self.stats.extra["spill_bytes"] = rel.spill_bytes
        self.stats.extra["spill_files"] = rel.spill_files
        self._src = MaterializedSource(
            self.var_ids(), block, None, self.batch_size, name="GroupOut", pool=self.pool,
        )
        return self._src

    def _close(self) -> None:
        if self._rel is not None:
            self._rel.close()

    def _reset(self) -> None:
        self._close()
        self._rel = None
        super()._reset()


class PartitionedDistinct(BatchOperator):
    """General DISTINCT over a partitioned input: rows fan out by all
    their columns (equal rows share a partition), each partition dedups on
    its own with ``torch.unique``, and the results concatenate. The output
    is partition-major, so it claims no order."""

    def __init__(
        self,
        child: BatchOperator,
        device: torch.device,
        batch_size: int = MAX_BATCH,
        pool: Optional[BatchPool] = None,
        memory_budget: Optional[int] = None,
        spill_dir: Optional[str] = None,
        n_parts: int = 16,
    ):
        self.child = child
        self.device = device
        self.batch_size = batch_size
        self.pool = pool
        self.memory_budget = memory_budget
        self.spill_dir = spill_dir
        self.n_parts = max(2, n_parts)
        self._rel: Optional[PartitionedRelation] = None
        self._src: Optional[MaterializedSource] = None
        super().__init__("Distinct", "(partitioned)")

    def var_ids(self) -> Tuple[int, ...]:
        return self.child.var_ids()

    def children(self) -> List[BatchOperator]:
        return [self.child]

    def _ensure(self) -> MaterializedSource:
        if self._src is not None:
            return self._src
        vs = self.var_ids()
        rel = self._rel = PartitionedRelation(
            len(vs), self.n_parts, self.device, self.spill_dir, self.memory_budget, self.pool)
        fan_in(self.child, rel, vs, vs)
        blocks = []
        for p in range(self.n_parts):
            part = rel.take(p)
            if part.shape[1]:
                blocks.append(torch.unique(part, dim=1))
        uniq = (torch.cat(blocks, dim=1).to(torch.int32) if blocks else
                torch.zeros((len(vs), 0), dtype=torch.int32, device=self.device))
        self.stats.extra["grace_partitions"] = self.n_parts
        self.stats.extra["spill_bytes"] = rel.spill_bytes
        self.stats.extra["spill_files"] = rel.spill_files
        self._src = MaterializedSource(
            vs, uniq, None, self.batch_size, name="DistinctBuffer", pool=self.pool,
        )
        return self._src

    def _next(self) -> Optional[ColumnBatch]:
        return self._ensure().next_batch()

    def _close(self) -> None:
        if self._rel is not None:
            self._rel.close()

    def _reset(self) -> None:
        self._close()
        self._rel = None
        self.child.reset()
        self._src = None
