"""Cardinality q-error, the misestimate signal the adaptive join reads.

Only the two names ``operators/adaptive_join.py`` needs are here so far:
the operator-tree report and EXPLAIN ANALYZE come with the telemetry
slice of the port.
"""

from __future__ import annotations

# q-error at or above this flags an estimate as wrong (the conventional
# "order of magnitude within 4x" threshold from the cardinality-estimation
# literature)
QERROR_FLAG = 4.0


def q_error(est: float, actual: float) -> float:
    """Cardinality q-error: max(est/actual, actual/est), both clamped to
    >= 1 so zero-row operators don't divide by zero (q=1 is a perfect
    estimate)."""
    e = max(float(est), 1.0)
    a = max(float(actual), 1.0)
    return max(e / a, a / e)
