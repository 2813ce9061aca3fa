"""The measured window's arithmetic: the closing rule, the rate and the tail.

The window opens when the first round after warm-up starts and closes at
the end of the first round that ends at or after ``seconds``, so it holds
whole rounds only and every query of the mix has the same share of it.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, List, Tuple

import numpy as np


def drive(serve_round: Callable[[list], list], rounds: Iterator[list], seconds: float,
          clock: Callable[[], float] = time.perf_counter) -> Tuple[list, float, int]:
    """Serve whole rounds until one ends at or after ``seconds``; returns the
    records, the window's wall seconds and the number of rounds."""
    records: List = []
    start = clock()
    n = 0
    while True:
        records.extend(serve_round(next(rounds)))
        n += 1
        if clock() - start >= seconds:
            return records, clock() - start, n


def qps(n_queries: int, window_s: float) -> float:
    """Queries completed over the window's wall time (not over summed
    latencies)."""
    return n_queries / window_s


def p95_ms(latencies_s) -> float:
    """The 95th percentile of every request's latency, in ms (linear
    interpolation between the two nearest ranks)."""
    return float(np.percentile(np.asarray(latencies_s, dtype=np.float64), 95)) * 1e3
