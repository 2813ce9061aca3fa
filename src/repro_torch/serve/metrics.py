"""Serving metrics registry, as in the reference package's
``serve/metrics.py``.

Production serving needs aggregate observability on top of per-query
traces: latency percentiles over a sliding window, throughput, plan-cache
effectiveness, and where kernel time went across the whole request mix.
``MetricsRegistry`` is that aggregation point — ``QueryServer`` feeds it
one observation per request (latency, rows, the request's scoped
``KernelLedger``, and its pool-counter delta) and exports the whole thing
as JSON for dashboards / the benchmark reports.

The exporter surface (DESIGN.md §14): a fixed-bucket latency
histogram on the registry, an OpenMetrics/Prometheus text exposition
(``to_openmetrics``) covering the registry plus an optional
WorkloadRepository's per-fingerprint gauges, and ``validate_openmetrics``
— a strict format checker the benchmark smoke runs over every emitted
exposition (TYPE-before-samples, suffix rules per metric type, cumulative
histogram buckets with +Inf, terminating ``# EOF``).

Kernel series carry this package's backends: ``cuda`` for a launch on the
card, ``plain`` for a call of a kernel's plain version on the CPU. Their
seconds are the host time inside the kernel wrappers (on the card, the
time to enqueue the launches), not device time.

Only stdlib is imported (collections, json, re, time) plus the telemetry
module — percentiles are computed by interpolation over a sorted copy of
the window, so this stays importable anywhere.
"""

from __future__ import annotations

import collections
import json
import re
import time
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.telemetry import KernelLedger


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Linear-interpolated percentile of an already-sorted list (matches
    numpy.percentile's default method; no numpy dependency here). Empty
    input returns 0.0; ``p`` is clamped into [0, 100] so a caller typo
    can never index out of range."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    p = min(max(p, 0.0), 100.0)
    rank = (p / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class SlidingWindow:
    """Bounded window of (timestamp, value) observations.

    Percentiles are over the last ``maxlen`` observations; rates (QPS) are
    over the observations that fall inside the trailing ``window_s``
    seconds, so an idle server's QPS decays to zero instead of reporting
    its lifetime average."""

    def __init__(self, maxlen: int = 1024) -> None:
        self._obs: Deque[Tuple[float, float]] = collections.deque(maxlen=maxlen)

    def add(self, value: float, ts: Optional[float] = None) -> None:
        self._obs.append((time.monotonic() if ts is None else ts, value))

    def __len__(self) -> int:
        return len(self._obs)

    def values(self) -> List[float]:
        return [v for _t, v in self._obs]

    def percentile(self, p: float) -> float:
        return _percentile(sorted(self.values()), p)

    def mean(self) -> float:
        vals = self.values()
        return sum(vals) / len(vals) if vals else 0.0

    def rate(self, window_s: float = 60.0, now: Optional[float] = None) -> float:
        """Observations per second over the trailing ``window_s``. A window
        holding zero or one observation reports 0.0 — a single sample
        spans no time, and dividing by its epsilon-age would report an
        absurd ~1e9/s rate on the first request."""
        if len(self._obs) < 2:
            return 0.0
        now = time.monotonic() if now is None else now
        cutoff = now - window_s
        n = sum(1 for t, _v in self._obs if t >= cutoff)
        if n < 2:
            return 0.0
        span = max(now - max(self._obs[0][0], cutoff), 1e-9)
        return n / span


class LatencyHistogram:
    """Fixed-bound cumulative histogram (Prometheus ``le`` semantics).

    The sliding window above answers "p99 right now"; this answers "the
    lifetime latency distribution" in a form scrape-based systems can
    aggregate across servers. Bounds are log-spaced seconds chosen for
    sub-millisecond-to-multi-second query engines."""

    DEFAULT_BOUNDS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.bounds: Tuple[float, ...] = tuple(bounds or self.DEFAULT_BOUNDS)
        # per-bucket (non-cumulative) counts; +Inf bucket is the last slot
        self._counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += float(value)
        self.count += 1
        for i, b in enumerate(self.bounds):
            if value <= b:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """[(le_label, cumulative_count), ...] ending with ("+Inf", count)."""
        out: List[Tuple[str, int]] = []
        acc = 0
        for b, c in zip(self.bounds, self._counts):
            acc += c
            out.append((format(b, "g"), acc))
        out.append(("+Inf", self.count))
        return out

    def snapshot(self) -> dict:
        return {
            "buckets": {le: c for le, c in self.cumulative()},
            "sum": round(self.sum, 6),
            "count": self.count,
        }

    def merge_snapshot(self, snap: dict) -> None:
        """Accumulate a persisted snapshot with identical bounds (report
        tooling merges saved registries; cumulative counts de-cumulate
        first)."""
        prev = 0
        buckets = snap.get("buckets", {})
        for i, b in enumerate(self.bounds):
            cum = int(buckets.get(format(b, "g"), prev))
            self._counts[i] += cum - prev
            prev = cum
        self._counts[-1] += int(buckets.get("+Inf", prev)) - prev
        self.sum += float(snap.get("sum", 0.0))
        self.count += int(snap.get("count", 0))


class MetricsRegistry:
    """Server-lifetime aggregation of per-request telemetry."""

    def __init__(self, window: int = 1024) -> None:
        self.latencies = SlidingWindow(window)
        self.latency_hist = LatencyHistogram()
        self.n_requests = 0
        self.n_rows = 0
        self.n_errors = 0
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        # cumulative kernel attribution across all observed requests
        self.kernels = KernelLedger()
        # summed per-request pool deltas (allocations, reuses, ...)
        self.pool: collections.Counter = collections.Counter()
        # out-of-core / adaptive execution counters (DESIGN.md §15):
        # grace-join + partitioned-aggregate spill volume and mid-plan
        # strategy switches, summed across requests
        self.spill_bytes = 0
        self.spill_files = 0
        self.adaptive_switches = 0
        self.started = time.monotonic()

    # -- feeding ------------------------------------------------------------

    def observe_plan_cache(self, hit: bool) -> None:
        if hit:
            self.plan_cache_hits += 1
        else:
            self.plan_cache_misses += 1

    def observe_request(
        self,
        latency_s: float,
        n_rows: int = 0,
        ledger: Optional[KernelLedger] = None,
        pool_delta: Optional[Dict[str, int]] = None,
        error: bool = False,
        ts: Optional[float] = None,
        spill_bytes: int = 0,
        spill_files: int = 0,
        adaptive_switches: int = 0,
    ) -> None:
        self.n_requests += 1
        self.n_rows += int(n_rows)
        if error:
            self.n_errors += 1
        self.latencies.add(float(latency_s), ts=ts)
        self.latency_hist.observe(float(latency_s))
        if ledger is not None:
            self.kernels.merge(ledger)
        if pool_delta:
            self.pool.update(pool_delta)
        self.spill_bytes += int(spill_bytes)
        self.spill_files += int(spill_files)
        self.adaptive_switches += int(adaptive_switches)

    # -- reading ------------------------------------------------------------

    def qps(self, window_s: float = 60.0) -> float:
        return self.latencies.rate(window_s)

    def plan_cache_hit_rate(self) -> float:
        n = self.plan_cache_hits + self.plan_cache_misses
        return self.plan_cache_hits / n if n else 0.0

    def snapshot(self, window_s: float = 60.0) -> dict:
        """JSON-able registry state: request/latency stats over the sliding
        window, plan-cache effectiveness, kernel and pool attribution."""
        return {
            "uptime_s": round(time.monotonic() - self.started, 3),
            "requests": {
                "count": self.n_requests,
                "rows": self.n_rows,
                "errors": self.n_errors,
                "qps": round(self.qps(window_s), 3),
                "mean_ms": round(self.latencies.mean() * 1e3, 4),
                "p50_ms": round(self.latencies.percentile(50) * 1e3, 4),
                "p99_ms": round(self.latencies.percentile(99) * 1e3, 4),
            },
            "plan_cache": {
                "hits": self.plan_cache_hits,
                "misses": self.plan_cache_misses,
                "hit_rate": round(self.plan_cache_hit_rate(), 4),
            },
            "kernels": self.kernels.snapshot(),
            "pool": dict(self.pool),
            "execution": {
                "spill_bytes": self.spill_bytes,
                "spill_files": self.spill_files,
                "adaptive_switches": self.adaptive_switches,
            },
            "latency_hist": self.latency_hist.snapshot(),
        }

    def to_json(self, indent: Optional[int] = None, window_s: float = 60.0) -> str:
        return json.dumps(self.snapshot(window_s), indent=indent)

    def save(self, path: str, window_s: float = 60.0) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2, window_s=window_s))

    # -- OpenMetrics exposition (DESIGN.md §14) -----------------------------

    def to_openmetrics(
        self,
        workload=None,
        window_s: float = 60.0,
        top_n: int = 20,
    ) -> str:
        """Render the registry (and optionally a WorkloadRepository) in
        OpenMetrics text format for scrape-based monitoring.

        Conventions followed (and enforced by :func:`validate_openmetrics`):
        counter families are declared without the ``_total`` suffix but
        every counter sample carries it; histograms expose cumulative
        ``_bucket{le=...}`` series ending at ``+Inf`` plus ``_sum`` and
        ``_count``; the exposition terminates with ``# EOF``. Per-fingerprint
        workload series are capped at ``top_n`` fingerprints by total wall
        time so label cardinality stays bounded no matter how diverse the
        workload is."""
        w = _OMWriter()
        w.gauge("barq_uptime_seconds", "Seconds since the metrics registry was created",
                [(None, time.monotonic() - self.started)])
        w.counter("barq_requests", "Requests observed",
                  [(None, self.n_requests)])
        w.counter("barq_request_errors", "Requests that raised",
                  [(None, self.n_errors)])
        w.counter("barq_result_rows", "Result rows returned across all requests",
                  [(None, self.n_rows)])
        w.gauge("barq_qps", "Requests per second over the trailing window",
                [(None, self.qps(window_s))])
        w.gauge(
            "barq_request_latency_quantile_seconds",
            "Sliding-window latency quantiles",
            [({"quantile": q}, self.latencies.percentile(float(q)) )
             for q in ("50", "90", "99")],
        )
        w.histogram(
            "barq_request_latency_seconds",
            "Request latency distribution (lifetime)",
            self.latency_hist,
        )
        w.counter(
            "barq_plan_cache_requests",
            "Plan-cache lookups by outcome",
            [({"result": "hit"}, self.plan_cache_hits),
             ({"result": "miss"}, self.plan_cache_misses)],
        )
        w.gauge("barq_plan_cache_hit_ratio", "Plan-cache hit rate",
                [(None, self.plan_cache_hit_rate())])
        kernel_counts = sorted(self.kernels.backend_counts.items())
        w.counter(
            "barq_kernel_dispatches",
            "Kernel dispatches by kernel and backend",
            [({"kernel": n, "backend": b}, c) for (n, b), c in kernel_counts],
        )
        w.counter(
            "barq_kernel_wall_seconds",
            "Host seconds inside the kernel wrappers by kernel and backend "
            "(launch enqueue time on the card)",
            [({"kernel": n, "backend": b}, v)
             for (n, b), v in sorted(self.kernels.backend_wall_s.items())],
        )
        w.counter(
            "barq_pool_events",
            "Batch-pool events (allocations, reuses, releases, bytes)",
            [({"event": k}, v) for k, v in sorted(self.pool.items())],
        )
        w.counter("barq_spill_bytes",
                  "Bytes spilled by grace joins and partitioned aggregates",
                  [(None, self.spill_bytes)])
        w.counter("barq_spill_files",
                  "Spill files written by out-of-core operators",
                  [(None, self.spill_files)])
        w.counter("barq_adaptive_switches",
                  "Mid-plan operator strategy switches (merge->hash, "
                  "resident->grace)",
                  [(None, self.adaptive_switches)])
        if workload is not None:
            top = workload.top_by_wall(top_n)
            w.counter(
                "barq_fingerprint_requests",
                "Requests per query fingerprint (top fingerprints by wall time)",
                [({"fingerprint": r["fingerprint"]}, r["n"]) for r in top],
            )
            w.counter(
                "barq_fingerprint_wall_seconds",
                "Total wall time per query fingerprint",
                [({"fingerprint": r["fingerprint"]}, r["wall_s"]) for r in top],
            )
            w.gauge(
                "barq_fingerprint_p99_seconds",
                "Recent p99 latency per query fingerprint",
                [({"fingerprint": r["fingerprint"]}, r["p99_s"]) for r in top],
            )
            w.gauge(
                "barq_fingerprint_max_q_error",
                "Worst plan-node cardinality q-error seen per fingerprint",
                [({"fingerprint": r["fingerprint"]}, r["max_q_error"]) for r in top],
            )
            w.gauge(
                "barq_latency_regressions",
                "Fingerprints currently flagged as latency regressions",
                [(None, len(workload.regressions))],
            )
            if workload.feedback is not None:
                w.gauge(
                    "barq_feedback_entries",
                    "Plan-node fingerprints with observed cardinalities",
                    [(None, len(workload.feedback.snapshot()))],
                )
        return w.render()


class _OMWriter:
    """Tiny OpenMetrics text-format serializer.

    One ``family(...)`` call per metric family keeps the TYPE/HELP header
    adjacent to its samples, which is exactly the ordering the format
    requires."""

    def __init__(self) -> None:
        self._lines: List[str] = []

    @staticmethod
    def _fmt_value(v) -> str:
        f = float(v)
        if f == int(f) and abs(f) < 1e15:
            return str(int(f))
        return repr(f)

    @staticmethod
    def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
        if not labels:
            return ""
        inner = ",".join(
            '{}="{}"'.format(
                k,
                str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n"),
            )
            for k, v in labels.items()
        )
        return "{" + inner + "}"

    def _family(self, name: str, mtype: str, help_text: str) -> None:
        self._lines.append(f"# TYPE {name} {mtype}")
        self._lines.append(f"# HELP {name} {help_text}")

    def gauge(self, name, help_text, samples) -> None:
        self._family(name, "gauge", help_text)
        for labels, v in samples:
            self._lines.append(f"{name}{self._fmt_labels(labels)} {self._fmt_value(v)}")

    def counter(self, name, help_text, samples) -> None:
        self._family(name, "counter", help_text)
        for labels, v in samples:
            self._lines.append(
                f"{name}_total{self._fmt_labels(labels)} {self._fmt_value(v)}"
            )

    def histogram(self, name, help_text, hist: LatencyHistogram) -> None:
        self._family(name, "histogram", help_text)
        for le, c in hist.cumulative():
            self._lines.append(
                f'{name}_bucket{{le="{le}"}} {c}'
            )
        self._lines.append(f"{name}_sum {self._fmt_value(hist.sum)}")
        self._lines.append(f"{name}_count {hist.count}")

    def render(self) -> str:
        return "\n".join(self._lines + ["# EOF"]) + "\n"


_OM_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_OM_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>[0-9.eE+-]+))?$"
)
_OM_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def validate_openmetrics(text: str) -> List[str]:
    """Strict structural check of an OpenMetrics exposition; raises
    ``ValueError`` on the first violation and returns the list of family
    names on success.

    Checks: every sample's family is declared by a preceding ``# TYPE``
    line; counter samples use the ``_total`` suffix; histogram samples use
    only ``_bucket``/``_sum``/``_count`` with cumulative non-decreasing
    ``le`` buckets ending at ``+Inf`` whose final count equals ``_count``;
    sample values parse as floats; the exposition ends with exactly one
    ``# EOF`` line. The benchmark smoke runs this over every exposition the
    server emits so a format drift fails CI rather than a scrape."""
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines = lines[:-1]
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition must terminate with '# EOF'")
    if "# EOF" in lines[:-1]:
        raise ValueError("'# EOF' must appear exactly once, at the end")
    types: Dict[str, str] = {}
    families: List[str] = []
    # per-histogram bucket state for cumulativity checks
    hist_buckets: Dict[str, List[Tuple[float, float]]] = {}
    hist_counts: Dict[str, float] = {}
    for lineno, line in enumerate(lines[:-1], 1):
        if not line:
            raise ValueError(f"line {lineno}: blank lines are not allowed")
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE line")
            _, _, name, mtype = parts
            if not _OM_NAME_RE.match(name):
                raise ValueError(f"line {lineno}: invalid metric name {name!r}")
            if mtype not in ("counter", "gauge", "histogram", "summary",
                            "info", "stateset", "unknown"):
                raise ValueError(f"line {lineno}: unknown metric type {mtype!r}")
            if name in types:
                raise ValueError(f"line {lineno}: duplicate TYPE for {name!r}")
            types[name] = mtype
            families.append(name)
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("#"):
            raise ValueError(f"line {lineno}: unknown comment directive")
        m = _OM_SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample line {line!r}")
        sample = m.group("name")
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(f"line {lineno}: non-numeric value {m.group('value')!r}")
        if m.group("labels"):
            body = m.group("labels")[1:-1]
            if body and _OM_LABEL_RE.sub("", body).strip(", ") != "":
                raise ValueError(f"line {lineno}: malformed labels {body!r}")
        # map the sample back to its family, honoring typed suffixes
        family = None
        for suffix in ("_total", "_bucket", "_sum", "_count", ""):
            base = sample[: len(sample) - len(suffix)] if suffix else sample
            if sample.endswith(suffix) and base in types:
                family = base
                break
        if family is None:
            raise ValueError(
                f"line {lineno}: sample {sample!r} has no preceding TYPE declaration"
            )
        mtype = types[family]
        suffix = sample[len(family):]
        if mtype == "counter":
            if suffix != "_total":
                raise ValueError(
                    f"line {lineno}: counter sample must use '_total' suffix"
                )
            if value < 0:
                raise ValueError(f"line {lineno}: counter value must be >= 0")
        elif mtype == "gauge":
            if suffix != "":
                raise ValueError(f"line {lineno}: gauge sample must not be suffixed")
        elif mtype == "histogram":
            if suffix == "_bucket":
                labels = dict(_OM_LABEL_RE.findall(m.group("labels") or ""))
                if "le" not in labels:
                    raise ValueError(
                        f"line {lineno}: histogram bucket missing 'le' label"
                    )
                le = float("inf") if labels["le"] == "+Inf" else float(labels["le"])
                buckets = hist_buckets.setdefault(family, [])
                if buckets and (le <= buckets[-1][0] or value < buckets[-1][1]):
                    raise ValueError(
                        f"line {lineno}: histogram buckets must be cumulative "
                        f"with increasing 'le'"
                    )
                buckets.append((le, value))
            elif suffix == "_count":
                hist_counts[family] = value
            elif suffix != "_sum":
                raise ValueError(
                    f"line {lineno}: histogram sample must be _bucket/_sum/_count"
                )
    for family, buckets in hist_buckets.items():
        if not buckets or buckets[-1][0] != float("inf"):
            raise ValueError(f"histogram {family!r} missing '+Inf' bucket")
        if family in hist_counts and buckets[-1][1] != hist_counts[family]:
            raise ValueError(
                f"histogram {family!r}: '+Inf' bucket != _count sample"
            )
    return families
