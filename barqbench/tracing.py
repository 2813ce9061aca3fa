"""What the traced run reads: the device's timeline from ``torch.profiler``
and the host syncs from PyTorch's CUDA sync-debug mode.

The profiler records CUDA activity only (kernels, copies, fills and the
runtime calls that launched them), not the host's operators, so a round of
hundreds of thousands of launches stays small enough to read in seconds.
Device and host timestamps share the profiler's clock, which is the wall
clock (``time.time_ns``). The device's idle time between two operations is
summed by where it fell: the request and the operations on either side of
it, which say what the host was steering at the time.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

# the ten ported kernels, by the names of their __global__ functions
PORTED_KERNELS = (
    "join_expand_kernel", "gather_emit_kernel", "expr_eval_kernel", "segment_scan_kernel",
    "sorted_search_kernel", "sorted_search_sample_kernel", "radix_partition_kernel",
    "hash_probe_kernel", "bloom_build_kernel", "bloom_probe_kernel", "frontier_dedup_kernel",
)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
# PyTorch's one-time notice when the sync debug mode first warns: not a sync
SYNC_MODE_NOTICE = "Synchronization debug mode is a prototype feature"
TOP = 10


@dataclasses.dataclass
class Timeline:
    queries: int
    window_s: float  # host seconds from the first request's start to the last one's end
    busy_s: float  # union of the device's intervals
    launches: int
    op_s: Dict[str, float]  # device seconds by operation name (``short``)
    ported_s: float  # device seconds in the ported kernels
    ported_n: Dict[str, int]  # launches of each ported kernel seen on the device
    gaps: List[Tuple[str, float]]  # idle seconds by where they fell, the largest first
    attributed: float  # share of device operations that fell inside a request


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


def short(name: str) -> str:
    """An operation's name without its return type, template and argument
    lists (a mangled C++ name gives its identifier)."""
    if name.startswith("_Z"):
        digits = re.match(r"_ZN?(\d+)", name)
        if digits:
            start = digits.end()
            return name[start: start + int(digits.group(1))]
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return re.split(r"[<(]", name, 1)[0].strip()[:120] or name[:120]


def read_timeline(events, spans: Sequence[Tuple[str, int, int]], window_s: float) -> Timeline:
    """Reduce the profiler's events over the requests in ``spans`` (name,
    start and end in wall-clock ns)."""
    dev: List[Tuple[int, int, str]] = []
    launches = 0
    for ev in events:
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            start = _ns(ev, "start")
            dur = _ns(ev, "duration")
            dev.append((start, start + dur, name))
        elif name in LAUNCH_CALLS:
            launches += 1
    dev.sort()
    op_s: Dict[str, float] = {}
    ported = 0
    ported_n: Dict[str, int] = {}
    busy = 0
    cur_lo = cur_hi = None
    for lo, hi, name in dev:
        key = short(name)
        op_s[key] = op_s.get(key, 0.0) + (hi - lo) / 1e9
        if any(k in name for k in PORTED_KERNELS):
            ported += hi - lo
            ported_n[key] = ported_n.get(key, 0) + 1
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    starts = [s for _n, s, _e in spans]
    inside = 0
    gaps: Dict[str, float] = {}
    prev_hi, prev_name = None, None
    for lo, hi, name in dev:
        i = bisect.bisect_right(starts, lo) - 1
        owner = spans[i][0] if i >= 0 and lo <= spans[i][2] else None
        inside += owner is not None
        if prev_hi is not None and lo > prev_hi:
            label = f"{owner or 'between requests'}: {short(prev_name)} -> {short(name)}"
            gaps[label] = gaps.get(label, 0.0) + (lo - prev_hi) / 1e9
        if prev_hi is None or hi > prev_hi:
            prev_hi, prev_name = hi, name
    return Timeline(
        queries=len(spans), window_s=window_s, busy_s=busy / 1e9, launches=launches,
        op_s=op_s, ported_s=ported / 1e9, ported_n=ported_n,
        gaps=sorted(gaps.items(), key=lambda g: -g[1])[:TOP],
        attributed=inside / len(dev) if dev else 0.0)


def profiled(serve_round, requests: list) -> Tuple[list, Optional[Timeline]]:
    """Serve ``requests`` under the profiler; (records, timeline)."""
    from torch.profiler import ProfilerActivity, profile

    spans: List[Tuple[str, int, int]] = []

    def one(req):
        t0 = time.time_ns()
        (rec,) = serve_round([req])
        spans.append((req.name, t0, time.time_ns()))
        return rec

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        records = [one(r) for r in requests]
        window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    return records, read_timeline(events, spans, window_s)


def count_syncs(fn) -> Tuple[object, int]:
    """Run ``fn`` with PyTorch's CUDA sync debugging on; (its result, the
    number of synchronising operations it reported)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synced = [w for w in caught if "synchroniz" in str(w.message)
              and not str(w.message).startswith(SYNC_MODE_NOTICE)]
    return out, len(synced)
