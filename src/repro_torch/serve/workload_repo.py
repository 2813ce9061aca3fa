"""Workload-history repository (DESIGN.md §14).

The serving metrics registry answers "how is the server doing"; this
module answers "how is each *query shape* doing". Requests are grouped by
their canonical template fingerprint (``core.telemetry.query_fingerprint``
— literals, whitespace, and variable names normalized away), and per
fingerprint the repository accumulates latency/row histograms, kernel
rollups, worst-seen cardinality q-error, and a recent-latency window for
p99 baselines. Two consumers hang off that history:

* **Cardinality feedback** — the repository owns (or is handed) a
  ``CardinalityFeedback`` store; the engine records per-plan-node observed
  cardinalities into it and the planner reads them back under
  ``EngineConfig.cardinality_feedback="apply"``. Persisting the repository
  persists the feedback store too, so a restarted server re-plans with
  yesterday's observed cardinalities immediately.
* **Regression detection** — each observation is compared against the
  fingerprint's established p99; a latency excursion past
  ``regression_factor`` × baseline (with enough history to make the
  baseline meaningful) is recorded on ``repository.regressions`` and
  surfaced through ``QueryServer.metrics_snapshot()``.

Persistence is line-oriented JSON (one fingerprint per line plus a meta
header and a feedback-state line), so saves stream, loads merge, and a
truncated file loses only its tail. Everything here is stdlib-only.
"""

from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Deque, Dict, List, Optional

from repro_torch.core.telemetry import CardinalityFeedback, KernelLedger
from repro_torch.serve.metrics import _percentile

# recent-latency window per fingerprint: big enough for a stable p99,
# small enough that thousands of fingerprints stay cheap
_RECENT_WINDOW = 128
# a regression verdict needs at least this many prior samples — a p99 over
# three observations is noise, not a baseline
_MIN_BASELINE_SAMPLES = 16


def _log2_bucket(value: float, unit: float) -> int:
    """Sparse histogram bucket: floor(log2(value/unit)), clamped at 0.
    With unit=1e-6 a 370 µs latency lands in bucket 8 (256–512 µs)."""
    v = value / unit
    if v < 1.0:
        return 0
    return int(math.log2(v)) + 1


class FingerprintStats:
    """Accumulated history for one query template."""

    __slots__ = (
        "fingerprint", "n", "n_errors", "wall_s", "rows", "max_q_error",
        "latency_hist", "rows_hist", "kernel_counts", "kernel_wall_s",
        "recent", "first_seen", "last_seen", "example",
    )

    def __init__(self, fingerprint: str) -> None:
        self.fingerprint = fingerprint
        self.n = 0
        self.n_errors = 0
        self.wall_s = 0.0
        self.rows = 0
        self.max_q_error = 0.0
        # sparse log2 histograms: latency in µs, result rows in rows
        self.latency_hist: collections.Counter = collections.Counter()
        self.rows_hist: collections.Counter = collections.Counter()
        self.kernel_counts: collections.Counter = collections.Counter()
        self.kernel_wall_s: Dict[str, float] = collections.defaultdict(float)
        self.recent: Deque[float] = collections.deque(maxlen=_RECENT_WINDOW)
        self.first_seen = 0.0
        self.last_seen = 0.0
        self.example = ""

    def p99_s(self) -> float:
        return _percentile(sorted(self.recent), 99.0)

    def mean_s(self) -> float:
        return self.wall_s / self.n if self.n else 0.0

    def observe(
        self,
        latency_s: float,
        rows: int,
        ledger: Optional[KernelLedger] = None,
        max_q_error: Optional[float] = None,
        error: bool = False,
        ts: Optional[float] = None,
    ) -> None:
        ts = time.time() if ts is None else ts
        if not self.n:
            self.first_seen = ts
        self.last_seen = max(self.last_seen, ts)
        self.n += 1
        if error:
            self.n_errors += 1
        self.wall_s += float(latency_s)
        self.rows += int(rows)
        self.latency_hist[_log2_bucket(latency_s, 1e-6)] += 1
        self.rows_hist[_log2_bucket(float(max(rows, 0)), 1.0)] += 1
        if max_q_error is not None:
            self.max_q_error = max(self.max_q_error, float(max_q_error))
        if ledger is not None:
            self.kernel_counts.update(ledger.counts)
            for k, v in ledger.wall_s.items():
                self.kernel_wall_s[k] += v
        self.recent.append(float(latency_s))

    # -- persistence --------------------------------------------------------

    def to_record(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "n": self.n,
            "n_errors": self.n_errors,
            "wall_s": round(self.wall_s, 6),
            "rows": self.rows,
            "max_q_error": round(self.max_q_error, 3),
            "latency_hist": {str(k): v for k, v in sorted(self.latency_hist.items())},
            "rows_hist": {str(k): v for k, v in sorted(self.rows_hist.items())},
            "kernel_counts": dict(self.kernel_counts),
            "kernel_wall_s": {k: round(v, 6) for k, v in self.kernel_wall_s.items()},
            "recent": [round(v, 6) for v in self.recent],
            "first_seen": self.first_seen,
            "last_seen": self.last_seen,
            "example": self.example,
        }

    def merge_record(self, rec: dict) -> None:
        """Fold a persisted record into this stats object (load-time merge:
        a live repository loading yesterday's file keeps today's counts)."""
        self.n += int(rec.get("n", 0))
        self.n_errors += int(rec.get("n_errors", 0))
        self.wall_s += float(rec.get("wall_s", 0.0))
        self.rows += int(rec.get("rows", 0))
        self.max_q_error = max(self.max_q_error, float(rec.get("max_q_error", 0.0)))
        for k, v in rec.get("latency_hist", {}).items():
            self.latency_hist[int(k)] += int(v)
        for k, v in rec.get("rows_hist", {}).items():
            self.rows_hist[int(k)] += int(v)
        self.kernel_counts.update(rec.get("kernel_counts", {}))
        for k, v in rec.get("kernel_wall_s", {}).items():
            self.kernel_wall_s[k] += float(v)
        # persisted recent samples are older than anything live: prepend
        loaded = [float(v) for v in rec.get("recent", [])]
        live = list(self.recent)
        self.recent.clear()
        self.recent.extend((loaded + live)[-_RECENT_WINDOW:])
        fs = float(rec.get("first_seen", 0.0))
        if fs and (not self.first_seen or fs < self.first_seen):
            self.first_seen = fs
        self.last_seen = max(self.last_seen, float(rec.get("last_seen", 0.0)))
        if not self.example:
            self.example = rec.get("example", "")


class WorkloadRepository:
    """Per-fingerprint workload history with bounded memory and JSONL
    persistence."""

    def __init__(
        self,
        max_fingerprints: int = 512,
        feedback: Optional[CardinalityFeedback] = None,
        regression_factor: float = 2.0,
        max_regressions: int = 64,
    ) -> None:
        assert regression_factor > 1.0
        self.max_fingerprints = max_fingerprints
        self.regression_factor = regression_factor
        self.feedback = feedback if feedback is not None else CardinalityFeedback()
        self._stats: Dict[str, FingerprintStats] = {}
        self.regressions: Deque[dict] = collections.deque(maxlen=max_regressions)
        self.n_evicted = 0

    def __len__(self) -> int:
        return len(self._stats)

    def get(self, fingerprint: str) -> Optional[FingerprintStats]:
        return self._stats.get(fingerprint)

    def _stats_for(self, fingerprint: str) -> FingerprintStats:
        st = self._stats.get(fingerprint)
        if st is None:
            if len(self._stats) >= self.max_fingerprints:
                # evict the least-recently-seen template; its history is the
                # least likely to be consulted again
                victim = min(self._stats.values(), key=lambda s: s.last_seen)
                del self._stats[victim.fingerprint]
                self.n_evicted += 1
            st = self._stats[fingerprint] = FingerprintStats(fingerprint)
        return st

    def observe(
        self,
        fingerprint: str,
        latency_s: float,
        rows: int = 0,
        ledger: Optional[KernelLedger] = None,
        max_q_error: Optional[float] = None,
        error: bool = False,
        query_text: str = "",
        ts: Optional[float] = None,
    ) -> dict:
        """Record one request; returns ``{"baseline_p99_s": ..,
        "regression": rec-or-None}`` so callers (flight recorder, server)
        can react without a second lookup. The baseline p99 is computed
        *before* this observation enters the window — an outlier must not
        raise the bar it is judged against."""
        st = self._stats_for(fingerprint)
        baseline_p99 = st.p99_s()
        established = st.n >= _MIN_BASELINE_SAMPLES and baseline_p99 > 0.0
        regression = None
        if established and latency_s > self.regression_factor * baseline_p99:
            regression = {
                "fingerprint": fingerprint,
                "latency_s": round(float(latency_s), 6),
                "baseline_p99_s": round(baseline_p99, 6),
                "factor": round(latency_s / baseline_p99, 2),
                "ts": time.time() if ts is None else ts,
            }
            self.regressions.append(regression)
        st.observe(latency_s, rows, ledger=ledger, max_q_error=max_q_error,
                   error=error, ts=ts)
        if query_text and not st.example:
            st.example = query_text[:500]
        return {"baseline_p99_s": baseline_p99, "regression": regression}

    # -- reading ------------------------------------------------------------

    def top_by_wall(self, n: int = 20) -> List[dict]:
        """Top fingerprints by total wall time — the exporter's and the
        report's shared ranking."""
        ranked = sorted(self._stats.values(), key=lambda s: -s.wall_s)[:n]
        return [
            {
                "fingerprint": s.fingerprint,
                "n": s.n,
                "wall_s": round(s.wall_s, 6),
                "rows": s.rows,
                "mean_s": round(s.mean_s(), 6),
                "p99_s": round(s.p99_s(), 6),
                "max_q_error": round(s.max_q_error, 2),
                "example": s.example,
            }
            for s in ranked
        ]

    def qerror_leaderboard(self, n: int = 20) -> List[dict]:
        ranked = sorted(
            (s for s in self._stats.values() if s.max_q_error > 0),
            key=lambda s: -s.max_q_error,
        )[:n]
        return [
            {
                "fingerprint": s.fingerprint,
                "max_q_error": round(s.max_q_error, 2),
                "n": s.n,
                "wall_s": round(s.wall_s, 6),
                "example": s.example,
            }
            for s in ranked
        ]

    def snapshot(self, top_n: int = 20) -> dict:
        return {
            "fingerprints": len(self._stats),
            "evicted": self.n_evicted,
            "feedback_entries": len(self.feedback.snapshot()),
            "top_by_wall": self.top_by_wall(top_n),
            "qerror_leaderboard": self.qerror_leaderboard(top_n),
            "regressions": list(self.regressions),
        }

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> int:
        """Write the repository as JSONL: a meta header, one line per
        fingerprint, one feedback-state line, recent regressions. Returns
        the number of fingerprint lines written."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        n = 0
        with open(path, "w") as f:
            f.write(json.dumps({
                "kind": "meta", "format": "barq-workload-v1",
                "saved_at": time.time(),
                "fingerprints": len(self._stats),
                "evicted": self.n_evicted,
            }) + "\n")
            for st in sorted(self._stats.values(), key=lambda s: -s.wall_s):
                f.write(json.dumps({"kind": "fingerprint", **st.to_record()}) + "\n")
                n += 1
            f.write(json.dumps({
                "kind": "feedback", "state": self.feedback.snapshot(),
            }) + "\n")
            for rec in self.regressions:
                f.write(json.dumps({"kind": "regression", **rec}) + "\n")
        return n

    def load(self, path: str) -> int:
        """Merge a saved repository into this one (count-weighted for the
        feedback store, additive for histograms/counters). Unknown line
        kinds are skipped so the format can grow. Returns the number of
        fingerprint records merged."""
        n = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.get("kind")
                if kind == "fingerprint":
                    self._stats_for(rec["fingerprint"]).merge_record(rec)
                    n += 1
                elif kind == "feedback":
                    self.feedback.merge(rec.get("state", {}))
                elif kind == "regression":
                    self.regressions.append(
                        {k: v for k, v in rec.items() if k != "kind"}
                    )
        return n
