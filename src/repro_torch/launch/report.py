"""Report generators, as in the reference package's ``launch/report.py``:

- dry-run records (``launch/dryrun.py``'s and ``launch/engine_dryrun.py``'s
  JSON files under ``--out``) -> the roofline table and its summary;
- ``--bench BENCH_PR*.json`` -> the property-path metrics table (frontier
  rounds, dedup ratio, pool traffic);
- ``--query q6`` / ``--sparql '...'`` runs one query on a generated LSQB
  store on the device (the CUDA card unless ``--device cpu``) and prints
  the whole observability surface: EXPLAIN, EXPLAIN ANALYZE (actual
  against estimated rows, MISEST at q-error >= 4), the lifecycle spans, the
  query's kernel attribution table and, with ``--trace``, the Chrome-trace
  JSON; ``--json`` prints the trace summary instead;
- ``--metrics`` pretty-prints a saved MetricsRegistry snapshot
  (``registry.save()`` or a server's ``metrics_snapshot()`` JSON) and
  ``--workload-report`` a saved WorkloadRepository; both read files only.

The kernel times are host milliseconds inside the kernel wrappers (on the
card, the time to enqueue the launches).

    python -m repro_torch.launch.report --query q6 [--device cpu] [--trace q6.json]
    python -m repro_torch.launch.report --sparql 'SELECT ?a { ... }'
    python -m repro_torch.launch.report --out experiments/dryrun --mesh single
    python -m repro_torch.launch.report --bench BENCH_PR2.json
    python -m repro_torch.launch.report --metrics metrics.json
    python -m repro_torch.launch.report --workload-report wl.jsonl
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List


def load(out_dir: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _f(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}µs"
    if x < 1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.2f}s"


def _gb(x: float) -> str:
    return f"{x / 1e9:.2f}"


def roofline_table(recs: List[Dict], mesh: str, tag_filter: str = "") -> str:
    """Markdown roofline table of the ``ok`` records on ``mesh`` (a null
    ``compile_s``, as the port's dry run writes, shows as —)."""
    rows = [
        "| arch | shape | compute | memory | collective | dominant | "
        "step LB | useful/HLO | temp GB/dev | compile s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        rt = r["roofline"]
        ratio = r.get("useful_flops_ratio")
        cs = r.get("compile_s")
        rows.append(
            "| {arch} | {shape} | {c} | {m} | {k} | **{dom}** | {lb} | {ur} | {tmp} | {cs} |".format(
                arch=r["arch"],
                shape=r["shape"],
                c=_f(rt["compute_s"]),
                m=_f(rt["memory_s"]),
                k=_f(rt["collective_s"]),
                dom=rt["dominant"],
                lb=_f(rt["step_time_lower_bound_s"]),
                ur=f"{ratio:.2f}" if ratio else "—",
                tmp=_gb(r["memory"]["temp_bytes"]),
                cs="—" if cs is None else cs,
            )
        )
    return "\n".join(rows)


def summary(recs: List[Dict]) -> str:
    ok = [r for r in recs if r.get("status") == "ok"]
    fail = [r for r in recs if r.get("status") != "ok"]
    doms = {}
    for r in ok:
        doms[r["roofline"]["dominant"]] = doms.get(r["roofline"]["dominant"], 0) + 1
    lines = [
        f"cells ok: {len(ok)}, failed: {len(fail)}",
        f"dominant-term distribution: {doms}",
    ]
    for r in fail:
        lines.append(f"FAILED {r['arch']} x {r['shape']} x {r['mesh']}: {r.get('error')}")
    return "\n".join(lines)


def _derived_dict(derived: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in derived.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def path_metrics_table(bench_json: str) -> str:
    """Markdown table of the property-path rows in a BENCH_PR*.json:
    per-operator frontier rounds, dedup ratio and pool alloc/reuse traffic
    next to the row-baseline speedup."""
    with open(bench_json) as f:
        report = json.load(f)
    rows = [
        "| bench | ms/call | pairs | rounds | dedup ratio | pool alloc/reuse | speedup |",
        "|---|---|---|---|---|---|---|",
    ]
    for suite in report.values():
        for rec in suite:
            if not str(rec.get("name", "")).startswith("path_"):
                continue
            d = _derived_dict(str(rec.get("derived", "")))
            rows.append(
                "| {name} | {ms:.1f} | {pairs} | {rounds} | {dedup} | {pool} | {sp} |".format(
                    name=rec["name"],
                    ms=float(rec["us_per_call"]) / 1e3,
                    pairs=d.get("pairs", "—"),
                    rounds=d.get("rounds", "—"),
                    dedup=d.get("dedup_ratio", "—"),
                    pool=(
                        f"{d['pool_alloc']}/{d['pool_reuse']}"
                        if "pool_alloc" in d
                        else "—"
                    ),
                    sp=d.get("speedup_vs_row", "—"),
                )
            )
    return "\n".join(rows)


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


def query_report(args, parser) -> int:
    """The --query/--sparql mode: one query, the full telemetry surface."""
    from repro_torch.core.executor import Engine, EngineConfig
    from repro_torch.data.lsqb import LSQB_QUERIES, generate_social_graph

    if args.sparql:
        query, label = args.sparql, "adhoc"
    else:
        if args.query not in LSQB_QUERIES:
            parser.error(f"unknown LSQB query {args.query!r} "
                         f"(have: {', '.join(sorted(LSQB_QUERIES))})")
        query, label = LSQB_QUERIES[args.query], args.query

    store, meta = generate_social_graph(scale=args.scale, device=args.device)
    engine = Engine(store, EngineConfig(engine=args.engine), device=args.device)
    res = engine.execute(query)
    trace = res.trace

    if args.json:
        doc = trace.summary()
        doc["pool"] = res.pool_delta()
        doc["rows"] = res.n_rows
        print(json.dumps(doc, indent=2))
    else:
        print(f"query {label} on {meta['n_triples']} triples "
              f"({args.engine} engine, {engine.device}): {res.n_rows} rows\n")
        print("plan (EXPLAIN):")
        print(engine.explain(query))
        print("\noperators (EXPLAIN ANALYZE):")
        print(res.explain_analyze())
        print("\nlifecycle spans:")
        print(span_table(trace))
        print("\nkernel attribution:")
        print(kernel_table(trace.ledger))
        if res.pool_delta():
            print("\npool delta:", res.pool_delta())

    if args.trace:
        trace.save_chrome_trace(args.trace)
        print(f"\nwrote {args.trace} — open in ui.perfetto.dev", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry-run, bench, query and serving reports")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--bench", default=None, metavar="BENCH_JSON",
                    help="print the property-path metrics table instead")
    ap.add_argument("--query", default=None,
                    help="telemetry report for an LSQB query (q1..q9)")
    ap.add_argument("--sparql", default=None,
                    help="telemetry report for raw SPARQL text")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="social-graph scale factor for --query/--sparql")
    ap.add_argument("--engine", default="barq",
                    choices=("barq", "mixed", "legacy"))
    ap.add_argument("--device", default=None,
                    help="torch device for --query/--sparql (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the query's Chrome-trace JSON here")
    ap.add_argument("--json", action="store_true",
                    help="emit the query trace summary as JSON")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="pretty-print a saved MetricsRegistry JSON")
    ap.add_argument("--workload-report", default=None, metavar="PATH",
                    help="render a saved WorkloadRepository JSONL")
    args = ap.parse_args(argv)
    if args.metrics:
        print(metrics_report(args.metrics))
        return 0
    if args.workload_report:
        print(workload_report(args.workload_report))
        return 0
    if args.query or args.sparql:
        return query_report(args, ap)
    if args.bench:
        print(path_metrics_table(args.bench))
        return 0
    recs = [r for r in load(args.out) if "__" not in (r.get("tag") or "")]
    print(summary(recs))
    print()
    print(roofline_table(recs, args.mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
