"""Flight recorder: always-on trace ring + trigger-on-outlier capture
(DESIGN.md §14).

Tracing every query is cheap enough to leave on (the scoped
``QueryTrace`` already rides along with each served request), but
*keeping* every trace is not. The flight recorder holds the last
``ring_size`` traces in memory and writes a full diagnostic bundle to
disk only when a request looks anomalous:

* **latency trigger** — the request took more than ``latency_factor`` ×
  the p99 the WorkloadRepository has established for this fingerprint
  (no baseline yet → no latency trigger; a cold template's first slow
  run is not an outlier, it's the baseline forming);
* **q-error trigger** — EXPLAIN ANALYZE's worst plan-node q-error is at
  or above ``q_error_threshold``, i.e. the planner was catastrophically
  wrong about cardinalities regardless of how fast the query happened
  to run.

A capture bundle is a directory under ``out_dir`` holding the Chrome
trace (``trace.json``, open in Perfetto), the EXPLAIN ANALYZE report
(``explain.txt``, rendered lazily — the callable only runs when a
trigger actually fires), and ``meta.json`` with the trigger reason and
the numbers behind it. Disk usage is bounded by ``max_captures``; after
that the recorder keeps ringing in memory but stops writing.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Deque, Optional

from repro_torch.core.telemetry import QueryTrace


class FlightRecorder:
    def __init__(
        self,
        out_dir: str = "artifacts/flight",
        ring_size: int = 32,
        latency_factor: float = 3.0,
        q_error_threshold: float = 16.0,
        max_captures: int = 16,
    ) -> None:
        assert latency_factor > 1.0 and q_error_threshold > 1.0
        self.out_dir = out_dir
        self.latency_factor = latency_factor
        self.q_error_threshold = q_error_threshold
        self.max_captures = max_captures
        self.ring: Deque[dict] = collections.deque(maxlen=ring_size)
        self.n_captures = 0
        self.n_observed = 0
        self._seq = 0

    def observe(
        self,
        fingerprint: str,
        latency_s: float,
        baseline_p99_s: float = 0.0,
        max_q_error: Optional[float] = None,
        trace: Optional[QueryTrace] = None,
        explain_fn: Optional[Callable[[], str]] = None,
        query_text: str = "",
        ts: Optional[float] = None,
    ) -> Optional[str]:
        """Ring the request; capture a bundle if a trigger fires. Returns
        the bundle directory path when a capture was written, else None."""
        ts = time.time() if ts is None else ts
        self.n_observed += 1
        reasons = []
        if baseline_p99_s > 0.0 and latency_s > self.latency_factor * baseline_p99_s:
            reasons.append("latency")
        if max_q_error is not None and max_q_error >= self.q_error_threshold:
            reasons.append("q_error")
        entry = {
            "fingerprint": fingerprint,
            "latency_s": round(float(latency_s), 6),
            "baseline_p99_s": round(float(baseline_p99_s), 6),
            "max_q_error": None if max_q_error is None else round(max_q_error, 2),
            "reasons": reasons,
            "ts": ts,
            "trace": trace,
        }
        self.ring.append(entry)
        if not reasons or self.n_captures >= self.max_captures:
            return None
        return self._capture(entry, explain_fn, query_text)

    def _capture(
        self,
        entry: dict,
        explain_fn: Optional[Callable[[], str]],
        query_text: str,
    ) -> str:
        self._seq += 1
        name = "{:.0f}_{}_{}_{:03d}".format(
            entry["ts"],
            entry["fingerprint"][:8] or "anon",
            "-".join(entry["reasons"]),
            self._seq,
        )
        bundle = os.path.join(self.out_dir, name)
        os.makedirs(bundle, exist_ok=True)
        trace = entry["trace"]
        if trace is not None:
            trace.save_chrome_trace(os.path.join(bundle, "trace.json"))
        if explain_fn is not None:
            try:
                explain = explain_fn()
            except Exception as e:  # a broken explain must not kill the request
                explain = f"<explain failed: {e}>"
            with open(os.path.join(bundle, "explain.txt"), "w") as f:
                f.write(explain if explain.endswith("\n") else explain + "\n")
        meta = {k: v for k, v in entry.items() if k != "trace"}
        meta["query"] = query_text[:2000]
        meta["thresholds"] = {
            "latency_factor": self.latency_factor,
            "q_error_threshold": self.q_error_threshold,
        }
        with open(os.path.join(bundle, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        self.n_captures += 1
        return bundle

    def snapshot(self) -> dict:
        return {
            "observed": self.n_observed,
            "captures": self.n_captures,
            "ring": [
                {k: v for k, v in e.items() if k != "trace"} for e in self.ring
            ],
        }
