"""Query profiler — Listing 1/3/5-style operator-tree reports, as in the
reference package's ``core/profiler.py``.

One reason the paper picked vectorization over code generation is that the
operator tree stays observable (§3.1). Both engines' operators carry
``OpStats``; this walker prints results, batches, next/skip call counts,
rows scanned from storage (the overfetch metric of §3.4), the operators'
``extra`` counters and host wall-time shares.

With ``analyze=True`` the report becomes EXPLAIN ANALYZE: each operator
additionally prints the planner's cardinality estimate next to the actual
row count, and flags misestimates whose q-error ``max(est/actual,
actual/est)`` reaches ``QERROR_FLAG`` — the signal the adaptive join and
cardinality feedback consume.

The ``pool:`` line reads ``BatchPool.stats()``, as the reference's does:
``alloc`` are fresh device buffers, ``reuse`` recycled ones, ``release``
buffers handed back, ``allocated`` the bytes of the fresh buffers and
``copied`` the bytes the operators moved.
"""

from __future__ import annotations

from typing import List, Optional

# q-error at or above this flags an estimate as wrong (the conventional
# "order of magnitude within 4x" threshold from the cardinality-estimation
# literature)
QERROR_FLAG = 4.0


def _fmt_count(n: float) -> str:
    if n >= 1e9:
        return f"{n / 1e9:.1f}B"
    if n >= 1e6:
        return f"{n / 1e6:.1f}M"
    if n >= 1e3:
        return f"{n / 1e3:.1f}K"
    return str(int(n))


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB"):
        if abs(n) < 1024:
            return f"{n:.0f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GB"


def _fmt_extra(v) -> str:
    """Extra-counter values: large float counts go through the K/M/B
    formatter like ints; small floats (ratios, milliseconds) print at 2
    decimals instead of full repr precision."""
    if isinstance(v, float):
        return _fmt_count(v) if abs(v) >= 1e3 else f"{v:.2f}"
    return _fmt_count(v)


def q_error(est: float, actual: float) -> float:
    """Cardinality q-error: max(est/actual, actual/est), both clamped to
    >= 1 so zero-row operators don't divide by zero (q=1 is a perfect
    estimate)."""
    e = max(float(est), 1.0)
    a = max(float(actual), 1.0)
    return max(e / a, a / e)


def _pool_delta(pool, pool_base: Optional[dict]) -> dict:
    """Pool counters attributable to this query: current counters minus
    the pre-execution snapshot (a shared Engine's pool accumulates across
    queries). ``pool`` may be a live BatchPool or an already-frozen
    stats dict (QueryResult snapshots at the end of the query so later
    queries on the same arena can't leak into the report)."""
    s = pool.stats() if hasattr(pool, "stats") else dict(pool)
    if not pool_base:
        return s
    return {k: v - pool_base.get(k, 0) for k, v in s.items()}


def profile_tree(root, var_table=None, pool=None,
                 pool_base: Optional[dict] = None, analyze: bool = False) -> str:
    total = max(root.stats.wall_time, 1e-12)
    lines: List[str] = []
    if pool is not None:
        # arena report: steady-state allocations should be O(plan depth)
        s = _pool_delta(pool, pool_base)
        lines.append(
            "pool: alloc: {alloc}, reuse: {reuse}, release: {release}, "
            "allocated: {ab}, copied: {cb}".format(
                alloc=_fmt_count(s["allocations"]),
                reuse=_fmt_count(s["reuses"]),
                release=_fmt_count(s["releases"]),
                ab=_fmt_bytes(s["bytes_allocated"]),
                cb=_fmt_bytes(s["bytes_copied"]),
            )
        )

    def walk(op, prefix: str, is_last: bool, is_root: bool) -> None:
        s = op.stats
        head = "" if is_root else ("'- " if is_last else "+- ")
        detail = s.detail
        if var_table is not None:
            for vid, name in enumerate(var_table.id_to_name):
                detail = detail.replace(f"?v{vid}", f"?{name}")
        parts = [f"{s.name}{detail}", f"results: {_fmt_count(s.results)}"]
        est = s.est_rows
        if analyze and est is not None:
            q = q_error(est, s.results)
            flag = f" MISEST(q={q:.1f})" if q >= QERROR_FLAG else ""
            src = "(source=feedback)" if s.est_source == "feedback" else ""
            parts.append(f"est: {_fmt_count(est)}{src}{flag}")
        if s.batches:
            parts.append(f"batches: {_fmt_count(s.batches)}")
        parts.append(f"next: {_fmt_count(s.next_calls)}")
        if s.skip_calls:
            parts.append(f"skip: {_fmt_count(s.skip_calls)}")
        if s.rows_scanned:
            parts.append(f"scanned: {_fmt_count(s.rows_scanned)}")
        for k, v in s.extra.items():
            parts.append(f"{k}: {_fmt_extra(v)}")
        parts.append(f"host wall: {100.0 * s.wall_time / total:.1f}%")
        lines.append(prefix + head + ", ".join(parts))
        kids = op.children()
        child_prefix = prefix if is_root else prefix + ("   " if is_last else "|  ")
        for i, c in enumerate(kids):
            walk(c, child_prefix, i == len(kids) - 1, False)

    walk(root, "", True, True)
    return "\n".join(lines)


def collect_stats(root, pool=None, pool_base: Optional[dict] = None) -> dict:
    """Aggregate tree stats for reporting.

    Aggregation rules for per-operator ``extra`` counters: ``*_peak`` keys
    take the max across operators, ``*_ratio`` keys are recomputed from
    their aggregated numerator/denominator (never summed), everything else
    is an additive count. ``pool_base`` subtracts a pre-execution
    snapshot so shared-pool counters report this query's delta.
    """
    agg = {
        "total_results": root.stats.results,
        "rows_scanned": 0,
        "next_calls": 0,
        "skip_calls": 0,
        "operators": 0,
    }
    if pool is not None:
        for k, v in _pool_delta(pool, pool_base).items():
            agg[f"pool_{k}"] = v
    qmax = 0.0

    def walk(op):
        nonlocal qmax
        agg["operators"] += 1
        agg["rows_scanned"] += op.stats.rows_scanned
        agg["next_calls"] += op.stats.next_calls
        agg["skip_calls"] += op.stats.skip_calls
        est = op.stats.est_rows
        if est is not None:
            qmax = max(qmax, q_error(est, op.stats.results))
        for k, v in op.stats.extra.items():
            # per-operator counters: peaks aggregate by max, ratios are
            # recomputed below, the rest are additive counts
            if k.endswith("_peak"):
                agg[k] = max(agg.get(k, 0), v)
            elif not k.endswith("_ratio"):
                agg[k] = agg.get(k, 0) + v
        for c in op.children():
            walk(c)

    walk(root)
    if agg.get("dedup_in"):
        agg["dedup_ratio"] = round(agg["dedup_out"] / agg["dedup_in"], 3)
    if qmax:
        agg["max_q_error"] = round(qmax, 2)
    return agg
