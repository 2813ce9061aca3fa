"""Batched SPARQL query serving — the end-to-end entry point for the
paper's kind of system, as in the reference package's
``serve/query_server.py``.

Requests are (query_text, arrival_time); the server executes them through
a shared Engine with per-request latency accounting and a reusable plan
cache keyed by the query template. The adaptive batch sizer inside the
engine is the paper's §3.4 mechanism; this layer adds the serving loop,
workload mix, and percentile reporting the evaluation section uses.

Every request runs inside its own QueryTrace, so kernel dispatches and
pool counters are attributed to exactly one request even though all
requests share one Engine (and its warm buffer arena). The per-request
ledgers and pool deltas aggregate into ``self.metrics`` — a
``MetricsRegistry`` with sliding-window percentiles, QPS, plan-cache
hit/miss, and JSON/OpenMetrics export.

Each request is attributed to its canonical template fingerprint and
recorded in a ``WorkloadRepository`` (latency/row histograms, kernel
rollups, per-plan-node observed cardinalities, regression detection),
and an optional ``FlightRecorder`` captures trace + EXPLAIN ANALYZE
bundles for outlier requests. The engine shares the repository's
``CardinalityFeedback`` store, so under
``EngineConfig.cardinality_feedback="apply"`` a repeated query re-plans
with the cardinalities its previous runs actually observed.

The engine runs on ``device`` (None = the CUDA card; it raises where there
is none). A request's latency is host time around planning and execution:
on the card it covers the device's work, because the engine's last copy of
the result rows to the host waits for the stream. ``kernel_wall_s`` is the
host time inside the kernel wrappers, on the card the time to enqueue the
launches, not device time. ``stats`` (the planner's ``GraphStats`` over the
store) goes to the engine, which builds its own when it is None.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import algebra as A
from repro_torch.core import planner as PL
from repro_torch.core import profiler
from repro_torch.core import telemetry
from repro_torch.core.executor import Engine, EngineConfig
from repro_torch.core.stats import GraphStats
from repro_torch.core.storage import QuadStore
from repro_torch.serve.flight_recorder import FlightRecorder
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.workload_repo import WorkloadRepository


@dataclasses.dataclass
class RequestResult:
    query_id: str
    n_rows: int
    latency_s: float
    # per-request attribution (None/empty when engine telemetry is off)
    trace: Optional[telemetry.QueryTrace] = None
    kernel_dispatches: int = 0
    # host seconds inside the kernel wrappers (enqueue time on the card)
    kernel_wall_s: float = 0.0
    pool_delta: Dict[str, int] = dataclasses.field(default_factory=dict)
    plan_cache_hit: bool = False
    # workload-history attribution
    fingerprint: str = ""
    max_q_error: float = 0.0
    regression: Optional[dict] = None
    flight_bundle: Optional[str] = None
    # the result rows (n_rows, n_projected) int32 codes, on the host
    rows: Optional[np.ndarray] = None


class QueryServer:
    def __init__(
        self,
        store: QuadStore,
        cfg: Optional[EngineConfig] = None,
        workload: Optional[WorkloadRepository] = None,
        flight: Optional[FlightRecorder] = None,
        device=None,
        stats: Optional[GraphStats] = None,
    ):
        self.store = store
        self.workload = workload if workload is not None else WorkloadRepository()
        # the engine records per-plan-node actual cardinalities into the
        # repository's feedback store; whether the planner *reads* them
        # back is the engine's cardinality_feedback knob
        self.engine = Engine(store, cfg or EngineConfig(), device,
                             feedback=self.workload.feedback, stats=stats)
        self.flight = flight
        self._plan_cache: Dict[str, Tuple[PL.Phys, A.VarTable, str]] = {}
        self.metrics = MetricsRegistry()

    def _plan_for(self, text: str) -> Tuple[PL.Phys, A.VarTable, str]:
        # cache key is a hash of the query text itself — the caller's
        # query_id is a reporting label only, so two different queries
        # sharing an id can never silently reuse the wrong cached plan.
        # The engine's plan fingerprint (join strategy, SIP mode, …) is
        # folded in too: swapping the engine config must not serve a plan
        # shaped under the old knobs, and under feedback=apply it advances
        # with the feedback store's version so new observations re-plan.
        key = hashlib.sha256(
            f"{self.engine.plan_fingerprint()}\n{text}".encode()
        ).hexdigest()
        hit = self._plan_cache.get(key)
        self.metrics.observe_plan_cache(hit is not None)
        if hit is None:
            node, vt = self.engine.parse(text)
            hit = (self.engine.plan(node), vt, telemetry.query_fingerprint(node))
            self._plan_cache[key] = hit
        return hit

    def execute(self, key: str, text: str) -> RequestResult:
        t0 = time.perf_counter()
        misses_before = self.metrics.plan_cache_misses
        phys, vt, qfp = self._plan_for(text)
        res = self.engine.execute_plan(phys, vt)
        latency = time.perf_counter() - t0
        tr = res.trace
        pool_delta = res.pool_delta()
        stats = profiler.collect_stats(res.root)
        self.metrics.observe_request(
            latency,
            n_rows=res.n_rows,
            ledger=tr.ledger if tr is not None else None,
            pool_delta=pool_delta,
            spill_bytes=int(stats.get("spill_bytes", 0)),
            spill_files=int(stats.get("spill_files", 0)),
            adaptive_switches=int(stats.get("adaptive_switches", 0)),
        )
        max_q = float(stats.get("max_q_error", 0.0))
        obs = self.workload.observe(
            qfp,
            latency,
            rows=res.n_rows,
            ledger=tr.ledger if tr is not None else None,
            max_q_error=max_q,
            query_text=text,
        )
        bundle = None
        if self.flight is not None:
            bundle = self.flight.observe(
                qfp,
                latency,
                baseline_p99_s=obs["baseline_p99_s"],
                max_q_error=max_q,
                trace=tr,
                # rendered only if a trigger fires — EXPLAIN ANALYZE over
                # the already-executed tree costs a walk, not a re-run
                explain_fn=res.explain_analyze,
                query_text=text,
            )
        return RequestResult(
            key,
            res.n_rows,
            latency,
            trace=tr,
            kernel_dispatches=tr.ledger.total() if tr is not None else 0,
            kernel_wall_s=tr.ledger.total_wall_s() if tr is not None else 0.0,
            pool_delta=pool_delta,
            plan_cache_hit=self.metrics.plan_cache_misses == misses_before,
            fingerprint=qfp,
            max_q_error=max_q,
            regression=obs["regression"],
            flight_bundle=bundle,
            rows=res.rows,
        )

    def explain_analyze(self, text: str) -> str:
        """EXPLAIN ANALYZE through the server's plan cache (counts as a
        cache touch but not as a served request in the latency window)."""
        phys, vt, _qfp = self._plan_for(text)
        return self.engine.execute_plan(phys, vt).explain_analyze()

    def metrics_snapshot(self, window_s: float = 60.0) -> dict:
        snap = self.metrics.snapshot(window_s)
        snap["workload"] = self.workload.snapshot()
        # regressions at top level too: dashboards alert on this key
        snap["regressions"] = list(self.workload.regressions)
        if self.flight is not None:
            snap["flight"] = self.flight.snapshot()
        return snap

    def metrics_json(self, indent: Optional[int] = 2,
                     window_s: float = 60.0) -> str:
        import json

        return json.dumps(self.metrics_snapshot(window_s), indent=indent)

    def openmetrics(self, window_s: float = 60.0, top_n: int = 20) -> str:
        """OpenMetrics text exposition of the registry plus per-fingerprint
        workload series (scrape endpoint body)."""
        return self.metrics.to_openmetrics(
            workload=self.workload, window_s=window_s, top_n=top_n
        )

    def run_workload(
        self, requests: List[Tuple[str, str]], warmup: int = 0
    ) -> Dict[str, float]:
        for key, text in requests[:warmup]:
            self.execute(key, text)
        return workload_stats([self.execute(k, t) for k, t in requests[warmup:]])


def workload_stats(results: List[RequestResult]) -> Dict[str, float]:
    """The reference's ``run_workload`` summary over served requests:
    count, rows, qps, mean / p50 / p99 latency, kernel dispatches and
    host ms inside the kernel wrappers, and the plan-cache hit rate."""
    lats = np.asarray([r.latency_s for r in results])
    return {
        "n_requests": len(results),
        "total_rows": int(sum(r.n_rows for r in results)),
        "qps": len(results) / max(lats.sum(), 1e-9),
        "mean_ms": float(lats.mean() * 1e3),
        "p50_ms": float(np.percentile(lats, 50) * 1e3),
        "p99_ms": float(np.percentile(lats, 99) * 1e3),
        "kernel_dispatches": int(sum(r.kernel_dispatches for r in results)),
        "kernel_wall_ms": float(
            sum(r.kernel_wall_s for r in results) * 1e3
        ),
        "plan_cache_hit_rate": float(
            sum(r.plan_cache_hit for r in results) / max(len(results), 1)
        ),
    }
