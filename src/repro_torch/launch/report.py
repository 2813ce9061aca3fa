"""Report generators over the serving layer's records, as in the reference
package's ``launch/report.py`` (its serving and telemetry tables only):
``kernel_table`` and ``span_table`` render a QueryTrace's kernel ledger and
spans; ``metrics_report`` pretty-prints a saved MetricsRegistry snapshot
(``registry.save()`` or a server's ``metrics_snapshot()`` JSON) and
``workload_report`` a saved WorkloadRepository. The kernel times are host
milliseconds inside the kernel wrappers (on the card, the time to enqueue
the launches). Both reports read files only; no store is built and no
engine runs.
"""

from __future__ import annotations

import json
from typing import List


def kernel_table(ledger) -> str:
    """Fixed-width per-kernel attribution table from a KernelLedger
    (dispatch counts and host ms inside the wrappers, by kernel and
    backend)."""
    rows = []
    for (name, backend), count in sorted(ledger.backend_counts.items()):
        wall_ms = ledger.backend_wall_s.get((name, backend), 0.0) * 1e3
        rows.append((name, backend, count, wall_ms))
    if not rows:
        return "  (no kernel dispatches recorded)"
    total_ms = sum(r[3] for r in rows) or 1e-9
    lines = [f"  {'kernel':<18} {'backend':<8} {'calls':>7} "
             f"{'host_ms':>9} {'share':>6}"]
    for name, backend, count, wall_ms in rows:
        lines.append(f"  {name:<18} {backend:<8} {count:>7} "
                     f"{wall_ms:>9.3f} {wall_ms / total_ms:>5.1%}")
    lines.append(f"  {'total':<18} {'':<8} {sum(r[2] for r in rows):>7} "
                 f"{total_ms:>9.3f}")
    return "\n".join(lines)


def span_table(trace) -> str:
    lines = []
    for name, _cat, _t0, dur, args in trace.spans:
        extra = f"  {args}" if args else ""
        lines.append(f"  {name:<12} {dur * 1e3:>9.3f} ms{extra}")
    return "\n".join(lines) if lines else "  (no spans)"


def metrics_report(path: str) -> str:
    """Pretty-print a saved MetricsRegistry snapshot (``registry.save()``
    output or a server's ``metrics_snapshot()`` JSON) as fixed-width
    tables. File-only: no engine, no store."""
    with open(path) as f:
        snap = json.load(f)
    lines: List[str] = []
    req = snap.get("requests", {})
    lines.append(f"uptime: {snap.get('uptime_s', 0):.1f}s   "
                 f"requests: {req.get('count', 0)}   "
                 f"rows: {req.get('rows', 0)}   "
                 f"errors: {req.get('errors', 0)}   "
                 f"qps: {req.get('qps', 0)}")
    lines.append(f"latency: mean {req.get('mean_ms', 0):.3f} ms   "
                 f"p50 {req.get('p50_ms', 0):.3f} ms   "
                 f"p99 {req.get('p99_ms', 0):.3f} ms")
    pc = snap.get("plan_cache", {})
    lines.append(f"plan cache: {pc.get('hits', 0)} hits / "
                 f"{pc.get('misses', 0)} misses "
                 f"(hit rate {pc.get('hit_rate', 0.0):.1%})")
    hist = snap.get("latency_hist", {})
    if hist.get("count"):
        lines.append("\nlatency histogram (cumulative):")
        for le, c in hist.get("buckets", {}).items():
            if c:
                lines.append(f"  le {le:>8}s {c:>8}")
    by_backend = snap.get("kernels", {}).get("by_backend", {})
    if by_backend:
        wall = snap.get("kernels", {}).get("by_backend_host_ms", {})
        lines.append("\nkernel attribution:")
        lines.append(f"  {'kernel/backend':<28} {'calls':>8} {'host_ms':>10}")
        for k, c in sorted(by_backend.items()):
            lines.append(f"  {k:<28} {c:>8} {wall.get(k, 0.0):>10.3f}")
    pool = snap.get("pool", {})
    if pool:
        lines.append("\npool events: " + ", ".join(
            f"{k}={v}" for k, v in sorted(pool.items())))
    return "\n".join(lines)


def workload_report(path: str, top_n: int = 15) -> str:
    """Render a saved WorkloadRepository JSONL: top fingerprints by wall
    time, the q-error leaderboard, and recent latency regressions. Loads
    into a fresh repository (exercising the same merge path a restarted
    server uses) — no engine runs."""
    from repro_torch.serve.workload_repo import WorkloadRepository

    repo = WorkloadRepository()
    n = repo.load(path)
    lines: List[str] = [
        f"workload repository: {n} fingerprints, "
        f"{len(repo.feedback.snapshot())} feedback entries",
    ]

    def _ex(rec: dict) -> str:
        ex = " ".join(str(rec.get("example", "")).split())
        return ex[:46] + "…" if len(ex) > 47 else ex

    lines.append("\ntop fingerprints by total wall time:")
    lines.append(f"  {'fingerprint':<18} {'n':>6} {'wall_s':>9} "
                 f"{'mean_ms':>9} {'p99_ms':>9} {'max_q':>7}  example")
    for rec in repo.top_by_wall(top_n):
        lines.append(
            f"  {rec['fingerprint'][:16]:<18} {rec['n']:>6} "
            f"{rec['wall_s']:>9.3f} {rec['mean_s'] * 1e3:>9.3f} "
            f"{rec['p99_s'] * 1e3:>9.3f} {rec['max_q_error']:>7.2f}  "
            f"{_ex(rec)}"
        )
    leaderboard = repo.qerror_leaderboard(top_n)
    if leaderboard:
        lines.append("\nq-error leaderboard (worst plan-node misestimate):")
        lines.append(f"  {'fingerprint':<18} {'max_q':>8} {'n':>6}  example")
        for rec in leaderboard:
            lines.append(f"  {rec['fingerprint'][:16]:<18} "
                         f"{rec['max_q_error']:>8.2f} {rec['n']:>6}  {_ex(rec)}")
    if repo.regressions:
        lines.append("\nlatency regressions (latest first):")
        lines.append(f"  {'fingerprint':<18} {'latency_ms':>11} "
                     f"{'baseline_p99_ms':>16} {'factor':>7}")
        for rec in list(repo.regressions)[::-1]:
            lines.append(
                f"  {str(rec.get('fingerprint', ''))[:16]:<18} "
                f"{rec.get('latency_s', 0.0) * 1e3:>11.3f} "
                f"{rec.get('baseline_p99_s', 0.0) * 1e3:>16.3f} "
                f"{rec.get('factor', 0.0):>7.2f}"
            )
    else:
        lines.append("\nno latency regressions recorded")
    return "\n".join(lines)
