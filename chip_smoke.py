#!/usr/bin/env python3
"""Drive the PyTorch / CUDA engine (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json REPORT]

Every run goes through all the phases, in order; any failure raises and the
script exits non-zero:

  build     compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a;
  kernels   each CUDA kernel against its plain PyTorch version on the card,
            at the engine's shapes; the kernel's own device time per launch
            and the plain version's (and, where one PyTorch call computes
            the same function, that call's) device time per call from
            torch.profiler, and each one's time per call with CUDA events;
            radix_partition also at its edges (key views at every 4-byte
            phase, 0 to 2^24 keys, 1 to 8,192 partitions, skewed keys), and
            bloom_probe also as the fused SIP mask of a scan batch (one to
            six filters, range-only and empty ranges, short batches, masks
            partly False, codes at every phase) beside the unfused step;
            bloom_build also on keys in the hash join's order, all equal,
            half NULL, at phases 1 and 3, 4,096 to 2^24 keys and W from 1
            to 2^20 words, one launch and one copy a build, timed in random
            and grouped order;
  full      the LSQB social graph at the paper's SF 0.3 size (scale 160,
            about 7.3M triples) on the card, through ``Engine.execute``,
            each count held against a closed form computed with numpy from
            the generated quads. Two paths, each with the launch counters
            set to 0 just before it and read just after: the merge path
            (``join_strategy="merge"``, ``sip="off"``; q1, q2, q7),
            which must launch the four merge-path kernels, and the
            reference's default configuration (cost-based joins, cost-gated
            SIP; q1, q2, q4, q5, q6, q7), which must launch the hash join's
            kernels on every query and the bloom filter's on q4, q5 and q6
            (the bloom_probe launches that carried no filter words are
            counted apart). Telemetry is on (the default): each query's
            QueryTrace must count, kernel by kernel, exactly the launches
            the counters saw over it, and the launches the operators' row
            counting made are reported;
  paths     property paths p1-p5 on the same store under the default
            configuration (counters set to 0 before, read after), each
            count against a numpy closed form; frontier_dedup must launch
            in every query and sorted_search in p1-p4; the frontier
            counters and the peak device memory are reported;
  distinct  COUNT(DISTINCT) d1 and d2 on the same store, then the BSBM BI
            mix at scale 36 (7.2M triples; all but b6, whose 233M-row
            self-join runs in breadth only), d1, d2, b4 and b8 against
            closed forms; frontier_dedup must launch in d1, d2, b4 and b8;
  explore   the BSBM explore mix e1-e5 (EXPLORE_INSTANCES instantiations
            of each from the seed) on the same scale-36 store, e3 (a cross
            product) against its closed form; then cross products of
            1,000 x 1,000 and 1,000 x 2,000 rows drained from CrossJoin,
            each against nl x nr, their host syncs equal (after one
            uncounted drain of each);
  serve     (SERVE_BUDGET_S, 60 s, reported against the phase's time) a
            stream of 100 requests from
            ``repro_torch.launch.serve.build_requests`` (seeded): 80 BSBM
            explore instances on the scale-36 store and 20 counts on the
            full-size LSQB store cycling p1, q4 and p3 (SERVE_LSQB: q4 and
            two path counts with closed forms, in place of q1 and q5, which
            take over 2 s each), through two QueryServers under
            EngineConfig(), 5 of them warm-up; the launch counters set to 0
            before the stream and read after it. Every count against its
            closed form, every explore result against a bare Engine's
            rows, plan-cache hits against the requests less the distinct
            texts, the registries' kernel dispatches against the requests'
            ledgers and the launch counts kernel by kernel, both OpenMetrics
            expositions validated (kernel series all ``/cuda``), and a
            served q4's host syncs against the same plan's through
            ``Engine.execute_plan``; qps, mean, p50 and p99 latency, the hit
            rate and the dispatches per kernel are printed. Then q4 twice
            through a QueryServer under ``cardinality_feedback="apply"``
            with a FlightRecorder (q-error threshold 4): both counts the
            closed form, the second plan marked ``(source=feedback)``, the
            first run's bundle parsed back when its q-error fires. Then
            every query the script runs (LSQB q1-q9, p1-p5, d1, d2; BSBM
            b1-b8 and the explore instances) planned under
            ``verify_plans=True`` in the default, ``("merge", "off")`` and
            8 MiB-budget configurations: each plan verifies clean, or the
            verifier flags a plan the translator refuses today too. Then q4
            under ``sanitize=True`` against its closed form with no leak
            and conserved counters, its wall beside an unsanitized run's,
            and a released card batch read back as POISON and refused with
            the allocating operator's name;
  legacy    the row engine (``engine="legacy"``: host rows over the store's
            host index arrays) and the mixed engine (batch scans and joins
            on the card, row grouping, sort and distinct on the host): the
            mixed engine's q4 and q5 and the row engine's q4 on the
            full-size store against their closed forms, with the batches
            that cross to the host, the query's host syncs (a second run)
            and those inside BatchToRow's copies (a third run, at most one
            a copy); RowToBatch's uploads of the :knows rows against the
            host index, with no host sync; the LSQB, path, distinct, BSBM
            BI, explore and fault-probe queries at breadth scale (q8 and
            b6 on smaller stores) under both engines, row-equal to the
            batch engine on the card (numbers within 1e-12: a SUM adds in
            another order); the paper's Fig. 6a (LSQB, batch engine on the
            card against row engine on the host) beside the card's name and
            power limit; q2's FILTER cost a row on the host; a hand-built
            PPathScan against PathExpand; an unknown function refused alike
            by the three engines, and a FILTER marked uncompilable through
            the tree walk on the card against the VM's and the row
            engine's rows. Its launch counts are those of the mixed runs;
  follow-ups  a second run of each default-path query but q6, of the
            merge path's q1 and of p1-p5 counts its host syncs, and a third of q4
            (PROFILED_QUERY) under torch.profiler gives the device's busy
            time, the top device and host ops and the cudaLaunchKernel and
            cudaMemsetAsync calls;
  telemetry q4 on the default engine with telemetry off beside the full
            phase's run with it on: host syncs (sync-counted runs after the
            first), the row counting's launches and walls, cudaLaunchKernel
            calls under torch.profiler; telemetry may add at most 2 syncs.
            q6's EXPLAIN ANALYZE from the full phase's run (the rows into
            its COUNT(*) equal to the closed form), its Chrome trace
            written and parsed back, and q4 under
            ``cardinality_feedback="apply"`` after the full phase's run's
            actuals (an empty history plans it as the default engine
            does), its plan marked ``(source=feedback)`` and its count the
            closed form;
  outofcore out-of-core and adaptive execution (its launch counts are
            those of the budgeted, spilling and adaptive runs alone):
            benchmarks/spill_stress.py's scenarios on the card (a 200,000 x
            200,000 grace join under a tenth of the build's bytes in four
            modes, an 80%-skewed build that must re-partition, the run-time
            switch of a build the plan sized as resident), each against the
            unconstrained HashJoin's rows; q4-q6 on the full-size store
            under ``EngineConfig(memory_budget=OOC_BUDGET, spill_dir=...)``
            against their closed forms (q6 planned grace with 4+ parts,
            spilling, and launching the hash path's four kernels); d2 and
            the BSBM BI queries under the same budget against their closed
            forms or the unconstrained rows, one at least partitioned with
            segment_scan; each with its wall time, spill bytes and files,
            peak device memory and host syncs (a second run; not for q6,
            whose second run is cut) beside the
            unconstrained run's; a MergeJoin whose right window of one key
            of 2^20 + 4,096 rows spills; q4 under the adaptive merge join,
            as planned and with its build estimate forced to 10 rows. The
            spill directory must be empty after every run;
  breadth   the nine LSQB queries, p1-p5, d1 and d2 at LSQB scale 1,
            the eight BSBM BI queries and the explore mix at BSBM scale 1
            and the fault probes
            (plans wider than one gather_emit launch, values float32 cannot
            hold, a 210-instruction BIND) on a small store, on the card and on
            the CPU (the kernels' plain versions) under the default
            configuration, ``("hash", "off")``, ``("merge", "on")``,
            ``("merge", "off")`` and the default under a 64 KiB budget with
            a spill directory (q8 under all but ``("merge", "on")``), with
            equal rows required (a plan the
            budget makes unrunnable must be refused alike). The CPU side
            runs in a child process (``--cpu-breadth``), started after the
            timed runs and joined at the end.

Each phase header carries the seconds since the start. The line before
the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32 rate
# outside the tensor cores, used for every elementwise or integer operation,
# and the float64 rate outside the tensor cores, for expr_eval's float64
# value plane
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_FP64_OPS_PER_S = 34e12
# values float32 cannot hold (0.1, 1/3, 2^24 + 1, 2^24 + 0.4), beside exact
# ones: the float64 value plane's inputs in the kernel checks
NOT_F32 = (0.1, 1 / 3, 16777217.0, 16777216.4, 123456789.123, 0.7, 7.0, -2.5, 0.0)

# kernel -> (CUDA source, the TPU kernel it replaces, the path whose run
# counts its launches)
KERNEL_INFO = {
    "join_expand": ("src/repro_torch/csrc/join_expand.cu",
                    "src/repro/kernels/join_expand.py:64", "merge"),
    "gather_emit": ("src/repro_torch/csrc/gather_emit.cu",
                    "src/repro/kernels/gather_emit.py:88", "merge"),
    "expr_eval": ("src/repro_torch/csrc/expr_eval.cu",
                  "src/repro/kernels/expr_eval.py:43", "merge"),
    "segment_scan": ("src/repro_torch/csrc/segment_scan.cu",
                     "src/repro/kernels/segment_reduce.py:63", "merge"),
    "radix_partition": ("src/repro_torch/csrc/radix_partition.cu",
                        "src/repro/kernels/radix_partition.py:46", "default"),
    "hash_probe": ("src/repro_torch/csrc/hash_probe.cu",
                   "src/repro/kernels/hash_join.py:70", "default"),
    "bloom_build": ("src/repro_torch/csrc/bloom_filter.cu",
                    "src/repro/kernels/bloom_filter.py:83", "default"),
    "bloom_probe": ("src/repro_torch/csrc/bloom_filter.cu",
                    "src/repro/kernels/bloom_filter.py:131", "default"),
    "sorted_search": ("src/repro_torch/csrc/sorted_search.cu",
                      "src/repro/kernels/sorted_search.py:41", "paths"),
    "frontier_dedup": ("src/repro_torch/csrc/frontier_dedup.cu",
                       "src/repro/kernels/frontier_dedup.py:52", "paths"),
}
SEED = 42
FULL_SCALE = 160.0  # the LSQB generator's size of the paper's SF 0.3: ~7.3M triples
BREADTH_SCALE = 1.0
BSBM_BREADTH_SCALE = 1.0  # ~200K triples
# full-size paths: (join_strategy, sip) and their queries
PATHS = {
    # q6 (37 s) is cut from the merge path to keep the script in its time
    # limit with the outofcore phase; q2 still runs a FILTER (expr_eval)
    "merge": (("merge", "off"), ("q1", "q2", "q7")),
    "default": ((None, None), ("q1", "q2", "q4", "q5", "q6", "q7")),
}
MERGE_SYNC_QUERIES = ("q1",)  # the merge path's sync-counting reruns
# the default path's sync-counting reruns: q6's (203,992 syncs in every run
# so far, about 50 s in sync debug mode on an H100 host) is cut to keep the
# script in its time limit with the serve phase
DEFAULT_SYNC_QUERIES = ("q1", "q2", "q4", "q5", "q7")
SIP_QUERIES = ("q4", "q5", "q6")  # default-path queries that must run SIP
# the profiled run of the default path: q2 (q6's profiled run and its event
# analysis took 169 s of the script's time limit)
# the default-path query run under torch.profiler: q4 from PR 23 (q2's
# profiled run and its event analysis took 65 s, PR 23 call 1)
PROFILED_QUERY = "q4"
BREADTH_CONFIGS = {
    "default": (None, None), "hash-off": ("hash", "off"),
    "merge-on": ("merge", "on"), "merge-off": ("merge", "off"),
    # the default configuration under a budget, spilling to a directory of
    # its own in each process
    "budget-64k": {"memory_budget": 64 << 10},
}
# property paths, run on the full-size LSQB store under EngineConfig()
P1_TARGET, P2_SOURCE = ":person0", ":person12345"
PATH_QUERIES = {
    "p1": f"SELECT (COUNT(*) AS ?n) {{ ?x :knows+ {P1_TARGET} }}",
    "p2": f"SELECT (COUNT(*) AS ?n) {{ {P2_SOURCE} :knows+ ?x . ?x :hasInterest ?t }}",
    "p3": "SELECT (COUNT(*) AS ?n) { ?m :replyOf+ ?r }",
    "p4": "SELECT (COUNT(*) AS ?n) { ?x :knows/:knows ?y }",
    "p5": "SELECT (COUNT(*) AS ?n) { ?x (:knows|^:knows) ?y }",
}
SEARCH_QUERIES = ("p1", "p2", "p3", "p4")  # p5 (a link and its inverse) needs no search
# DISTINCT aggregates on the same store
DISTINCT_QUERIES = {
    "d1": "SELECT (COUNT(DISTINCT ?p2) AS ?n) { ?p1 :knows ?p2 }",
    "d2": "SELECT ?city (COUNT(DISTINCT ?tag) AS ?n) "
          "{ ?p :isLocatedIn ?city . ?p :hasInterest ?tag } GROUP BY ?city",
}
# the BSBM BI mix: scale 36 is 7,199,185 triples, the LSQB store's size;
# b6 (the feature self-join) emits 233M rows there and runs in breadth only
BSBM_SCALE = 36.0
BSBM_SEED = 7  # the generator's default
BSBM_FULL_QUERIES = ("b1", "b2", "b3", "b4", "b5", "b7", "b8")
EXPLORE_INSTANCES = 3  # instantiations of each BSBM explore template (e1-e5)
DEDUP_QUERIES = ("d1", "d2", "b4", "b8")  # distinct-phase queries that must run frontier_dedup
# the outofcore phase: its budget (device bytes a blocking operator may
# hold before it goes grace / partitioned and spills), the full-size LSQB
# queries run under it (q6's hash joins must go grace), the BSBM BI queries
# with GROUP BY (and b8) run under it, the query of the adaptive join's
# two branches, and the breadth phase's budget
OOC_BUDGET = 8 << 20
OOC_QUERIES = ("q4", "q5", "q6")
OOC_GRACE_QUERY = "q6"
OOC_BSBM_QUERIES = ("b1", "b2", "b3", "b4", "b5", "b7", "b8")
ADAPTIVE_QUERY = "q4"
# the telemetry phase: queries run with telemetry off beside the full
# phase's runs (on); the profiled one's cudaLaunchKernel calls are compared
# too (on: the follow-ups' profiled run)
# (q6's off run and its "apply" run, about 100 s together, are cut to keep
# the script in its time limit with the serve phase: the apply run is q4's,
# and q6's EXPLAIN ANALYZE and Chrome trace still come from the full phase)
TELEMETRY_QUERIES = ("q4",)
SMALL_TELEMETRY_QUERY = PROFILED_QUERY
APPLY_QUERY = "q4"
# the full phase's default-path results the telemetry phase reads
KEPT_QUERIES = ("q4", "q6")
BREADTH_BUDGET = 64 << 10
# LSQB q8 (9.4M rows at breadth scale) runs in these breadth configurations
# only: under ("merge", "on") it took 11.5 s on an H100 and 42.9 s in the
# CPU child, cut to keep the script in its time limit with the serve phase
# (("merge", "off") runs the same merge joins)
Q8_BREADTH_CONFIGS = ("default", "hash-off", "merge-off", "budget-64k")
# the fault probes, on probe_store in the breadth phase: plans past one
# gather_emit launch (19 and 20 emitted rows, one key and five pairs) and
# the float64 value plane (2^24 + 1, 0.1 * 3, 210 instructions, sums)
_STAR = " ".join(f"?s :p{k} ?o{k} ." for k in range(18))
_SIX = (" ".join(f"?s :p{k} ?{v} ." for k, v in enumerate("abcdef")),
        " ".join(f"?t :q{k} ?{v} ." for k, v in enumerate("abcdef")))
_AGGS = "(SUM({d}?x) AS ?sum) (AVG({d}?x) AS ?avg) (MIN({d}?x) AS ?lo) (MAX({d}?x) AS ?hi) " \
        "(COUNT({d}?x) AS ?n)"
PROBE_QUERIES = {
    "f1 star of 18": f"SELECT * {{ {_STAR} }}",
    "f1 join on six": f"SELECT * {{ {{ {_SIX[0]} }} {{ {_SIX[1]} }} }}",
    "f1 optional on six": f"SELECT * {{ {_SIX[0]} OPTIONAL {{ {_SIX[1]} }} }}",
    "f1 union of 20 columns": f"SELECT * {{ {{ {_STAR} }} UNION {{ ?s :q0 ?x }} }}",
    "f3 filter above 2^24": "SELECT ?i ?x { ?i :x ?x . FILTER(?x > 16777216) }",
    "f3 bind x * 3": "SELECT ?i ?x ?y { ?i :x ?x . BIND(?x * 3 AS ?y) }",
    "f2 bind of 70 terms": "SELECT ?i ?y { ?i :x ?x . BIND("
                           + " + ".join(f"?x * {k + 0.5}" for k in range(1, 71)) + " AS ?y) }",
    "f3 aggregates": "SELECT ?g " + _AGGS.format(d="") + " { ?i :g ?g . ?i :x ?x } GROUP BY ?g",
    "f3 distinct aggregates": "SELECT ?g " + _AGGS.format(d="DISTINCT ")
                              + " { ?i :g ?g . ?i :x ?x } GROUP BY ?g",
}

# the serve phase: a stream of SERVE_REQUESTS requests from
# repro_torch.launch.serve.build_requests (SERVE_LSQB_SHARE of them LSQB
# counts on the full-size store cycling SERVE_LSQB, the rest BSBM explore
# instances on the scale-36 store) through two QueryServers under
# EngineConfig(), the first SERVE_WARMUP left out of the latencies. Then
# q4's feedback loop through a flight recorder, the plan verifier over
# every query the script runs, and q4 sanitized; the phase reports its time
# against SERVE_BUDGET_S.
SERVE_REQUESTS = 100
SERVE_LSQB_SHARE = 0.2
# the LSQB cycle is fixed, so every run serves the same stream: q1, q4 and
# q5 with q1 and q5 replaced by the path counts p1 and p3 (closed forms),
# because their full-size runs took over 2 s on an H100 (q1 3.1-5.0 s, q5
# 1.6-2.7 s), which a 60 s phase cannot hold 13 times
SERVE_LSQB = ("p1", "q4", "p3")
SERVE_WARMUP = 5
SERVE_BUDGET_S = 60.0
SERVE_FEEDBACK_QUERY = "q4"
SERVE_QERROR = 4.0
SANITIZE_QUERY = "q4"
VERIFY_CONFIGS = {"default": (None, None), "merge-off": ("merge", "off"),
                  "budget-8m": {"memory_budget": OOC_BUDGET}}

# the legacy phase: the row engine (host rows over the store's host index
# arrays) and the mixed engine (batch scans and joins on the card, row
# grouping, sort and distinct on the host, adapters in between)
LEGACY_FULL_MIXED = ("q4", "q5")  # full size, against their closed forms
LEGACY_FULL_ROW = ("q4",)  # the row engine at full size
# breadth queries the row engine and the mixed engine run on small stores
# instead (their row runs take minutes at breadth scale): q8's pairs of
# people sharing a tag, b6's pairs of products sharing a feature
LEGACY_SMALL_LSQB_SCALE = 0.1
LEGACY_SMALL_LSQB = ("q8",)
LEGACY_SMALL_BSBM_SCALE = 0.02
LEGACY_SMALL_BSBM = ("b6",)
LEGACY_UPLOAD_BATCHES = 200  # RowToBatch batches drained for the upload check
LEGACY_FILTER_ROWS = 20_000  # one-row FILTER evaluations timed for the per-row cost
# a FILTER over :knows for the tree walk on the card: a term test, a code
# comparison and a value comparison
WALK_FILTER = "FILTER(?a != ?b && (isIRI(?b) || ?a < ?b))"

T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def elapsed() -> str:
    return f"(t={time.perf_counter() - T_START:.1f} s)"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def call_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events: at the engine's sizes this is the host's per-call work
    (Python, ctypes, allocation), not the device's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def event_ms(prepare, fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` alone, each of ``iters`` calls after a
    ``prepare()`` that is not timed, between two CUDA events recorded
    around the call: the device time of its launches and the gaps between
    them."""
    prepare()
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _kernel_event(name: str, key: str, main_only: bool = False) -> bool:
    """Whether a profiler event is one of kernel ``name``'s CUDA kernels:
    ``{name}_kernel``, or with ``main_only`` false also a helper kernel of
    the same launch (``{name}_<part>_kernel``, e.g. sorted_search's
    sampling pre-pass)."""
    part = "" if main_only else r"(_[a-z]+)?"
    return re.search(rf"\b{name}{part}_kernel\b", key) is not None


def device_ms(fn, iters: int, kernel=None, windows: int = 5):
    """Device milliseconds from torch.profiler over ``iters`` calls: per
    call, the self device time of ``kernel``'s CUDA kernels (one wrapper
    call is one counted launch) when it is named, else summed over every
    device op. The profiler can come back from a window with no device
    event at all, so a window that recorded none is profiled again, up to
    ``windows`` times; None when none of them recorded such device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type != cpu and e.self_device_time_total > 0]
        if kernel is not None:
            evs = [e for e in evs if _kernel_event(kernel, e.key)]
        if evs:
            return sum(e.self_device_time_total for e in evs) / iters / 1e3
    return None


def timings(name, kernel_fn, plain_fn, plain_iters: int, library_fn=None) -> dict:
    """The kernel's, its plain version's and (where there is one) the
    library call's device and per-call times. Where the profiler records no
    device time, the per-call time stands in, and ``{key}_source`` and the
    log say so (``"profiler"`` otherwise)."""
    t = {"call_ms": call_ms(kernel_fn, 200), "plain_call_ms": call_ms(plain_fn, plain_iters)}
    t["ms"] = device_ms(kernel_fn, 200, kernel=name)
    t["plain_ms"] = device_ms(plain_fn, plain_iters)
    keys = [("ms", "call_ms"), ("plain_ms", "plain_call_ms")]
    t["library_ms"] = t["library_call_ms"] = None
    if library_fn is not None:
        t["library_call_ms"] = call_ms(library_fn, 200)
        t["library_ms"] = device_ms(library_fn, 200)
        keys.append(("library_ms", "library_call_ms"))
    for key, fallback in keys:
        t[f"{key}_source"] = "profiler"
        if t[key] is None:
            log(f"  {name}: the profiler recorded no device time; {key} is {fallback}")
            t[key], t[f"{key}_source"] = t[fallback], fallback
    return t


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_diff(got, want) -> float:
    """max |got - want| over the elements where both are finite (0.0 where
    none is); the checks compare every element's bits as well."""
    both = torch.isfinite(got) & torch.isfinite(want)
    return float((got[both] - want[both]).abs().max()) if bool(both.any()) else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _groups(rng, g, lmax, rmax, dev, unit_left=False):
    llens = np.ones(g, np.int32) if unit_left else rng.randint(1, lmax + 1, g).astype(np.int32)
    rlens = rng.randint(1, rmax + 1, g).astype(np.int32)
    return _group_tensors(llens, rlens, dev)


def _group_tensors(llens, rlens, dev):
    from repro_torch.core.vecops import group_output_offsets

    lstarts = np.concatenate([[0], np.cumsum(llens)[:-1]]).astype(np.int32)
    rstarts = np.concatenate([[0], np.cumsum(rlens)[:-1]]).astype(np.int32)
    ts = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
          for x in (lstarts, llens, rstarts, rlens)]
    return (*ts, group_output_offsets(ts[1], ts[3]))


def _empty_runs_at_tiles(rng, tile, n_tiles, dev):
    """Groups whose every tile of ``tile`` slots opens on a run of 1-40
    empty groups (left or right run empty), then random groups of up to 24
    slots that fill the tile."""
    ll, rl = [], []
    for _ in range(n_tiles):
        for _ in range(rng.randint(1, 41)):
            empty_left = rng.rand() < 0.5
            ll.append(0 if empty_left else rng.randint(1, 4))
            rl.append(rng.randint(1, 4) if empty_left else 0)
        left = tile
        while left > 0:
            a, b = rng.randint(1, 5), rng.randint(1, 7)
            if a * b > left:
                a, b = 1, left
            ll.append(a)
            rl.append(b)
            left -= a * b
    return _group_tensors(np.asarray(ll), np.asarray(rl), dev)


def _sectors(idx, itemsize):
    """32-byte sectors that reads of the elements ``idx`` of an array with
    ``itemsize``-byte elements touch."""
    return len(np.unique(np.asarray(idx, np.int64) * itemsize // 32))


def _expand_bound(args, base, count):
    """join_expand's bound: li and ri written (8 bytes a slot), and each
    32-byte sector read once of the cum entries and the three group
    parameters the kernel reads (lstarts, rstarts, rlens) of the groups
    this window spans (cum[G] included); ~8 operations a slot."""
    cum = args[4].cpu().numpy()
    total = int(cum[-1])
    lo, hi = max(base, 0), min(base + count, total)
    if lo >= hi:
        return bound(8 * count, 8 * count)
    g0 = int(np.searchsorted(cum, lo, side="right")) - 1
    g1 = int(np.searchsorted(cum, hi, side="left"))
    groups = np.arange(g0, g1)
    read = 32 * (_sectors(np.append(np.arange(g0, g1 + 1), len(cum) - 1), 8)
                 + 3 * _sectors(groups, 4))
    return bound(read + 8 * count, 8 * count)


def check_join_expand(rng, dev):
    from repro_torch.kernels import join_expand as JE

    err = 0
    small, large = JE.TILE_SMALL, JE.TILE_LARGE
    q6 = _groups(rng, 40000, 4, 8, dev)
    wide = _groups(rng, 400_000, 4, 8, dev)  # about 4.5M slots
    cases = [
        ("groups=40000", q6, None, 4096),
        ("unit-left runs", _groups(rng, 4096, 1, 64, dev, unit_left=True), 0, 4096),
        ("unit-right runs", _groups(rng, 4096, 64, 1, dev), 0, 4096),
        ("count=2^20", _groups(rng, 40000, 4, 8, dev), 0, 1 << 20),
        ("cum > 2^31", _groups(rng, 20000, 1000, 1000, dev), None, 4096),
        ("empty runs at small tile starts", _empty_runs_at_tiles(rng, small, 64, dev), 0,
         64 * small),
        ("empty runs at large tile starts",
         _empty_runs_at_tiles(rng, large, JE.LARGE_FROM // large, dev), 0, JE.LARGE_FROM),
        ("one group, count=2^20", _group_tensors(np.asarray([8]), np.asarray([1 << 17]), dev),
         0, 1 << 20),
        ("G=1", _group_tensors(np.asarray([3]), np.asarray([5]), dev), 0, 4096),
        ("G=300000", _groups(rng, 300_000, 4, 8, dev), None, 4096),
        ("base, count not multiples of the small tile", _groups(rng, 40000, 4, 8, dev),
         12_345, 3 * small + 77),
        ("base, count not multiples of the large tile", wide, 12_345, JE.LARGE_FROM + 77),
        ("count just below the large tile", wide, 0, JE.LARGE_FROM - 1),
        ("count=65536", wide, 0, 65536),
    ]
    for label, args, base, count in cases:
        total = int(args[4][-1])
        if base is None:
            base = total - 2048 if "2^31" in label else total // 2
        if "2^31" in label:
            require(total > 2 ** 31, "join_expand: the wide case must pass 2^31 slots")
        if label.startswith("empty runs"):
            tile = JE.tile_for(count)
            require(tile == (small if "small" in label else large),
                    f"join_expand: the case '{label}' must run at its tile")
            ll, rl, cum = (x.cpu().numpy() for x in (args[1], args[3], args[4]))
            starts = set(cum[:-1][(ll.astype(np.int64) * rl) == 0].tolist())
            require(set(range(0, count, tile)) <= starts,
                    "join_expand: every tile of the empty-run case must open on empty groups")
        li, ri = JE.join_expand(*args, base, count)
        pli, pri = JE.join_expand_plain(*args, base, count)
        require(torch.equal(li, pli) and torch.equal(ri, pri),
                f"join_expand disagrees with its plain version ({label})")
        err = max(err, int((li - pli).abs().max()), int((ri - pri).abs().max()))
        log(f"  join_expand {label}: total={total} base={base} count={count} "
            f"tile={JE.tile_for(count)} ok")
    base = int(q6[4][-1]) // 2
    t = timings("join_expand", lambda: JE.join_expand(*q6, base, 4096),
                lambda: JE.join_expand_plain(*q6, base, 4096), 20)
    # further shapes, on both sides of the tile choice: up to 65,536 slots
    # the small tile, from 262,144 the large one
    for key, args, b, count in (("G=300000", cases[9][1], None, 4096),
                                ("count=65536", wide, 0, 65536),
                                ("count=262144", wide, 0, 262144),
                                ("count=2^20", cases[3][1], 0, 1 << 20),
                                ("one group, count=2^20", cases[7][1], 0, 1 << 20)):
        b = int(args[4][-1]) // 2 if b is None else b
        te = timings("join_expand", lambda: JE.join_expand(*args, b, count),
                     lambda: JE.join_expand_plain(*args, b, count), 5)
        b_ms, b_by = _expand_bound(args, b, count)
        t[key] = {**{f: te[f] for f in ("ms", "call_ms", "plain_ms")},
                  "bound_ms": b_ms, "bound_by": b_by, "tile": JE.tile_for(count)}
        log(f"  join_expand {key}: kernel {te['ms']:.6f} ms on the device "
            f"({te['call_ms']:.5f} ms per call), tile {JE.tile_for(count)}, "
            f"bound {b_ms:.6f} ms ({b_by})")
    return err, t, _expand_bound(q6, base, 4096)


def _emit_bound(plan, li, ri, c):
    """gather_emit's bound: li (and ri) read, the block and the mask
    written, and each 32-byte sector read once of every left row emitted
    or compared at the slots' li, and of every such right row at the slots
    whose ri is valid; ~8 operations a slot."""
    li_np = li.cpu().numpy()
    left_rows = {r for r in plan.lsel if r >= 0} | {a for a, _ in plan.pairs}
    right_rows = {r for r in plan.rsel if r >= 0} | {b for _, b in plan.pairs}
    rsec = 0
    if ri is not None:
        ri_np = ri.cpu().numpy()
        rsec = _sectors(ri_np[ri_np >= 0], 4)
    cells = 32 * (len(left_rows) * _sectors(li_np, 4) + len(right_rows) * rsec)
    nbytes = (4 if ri is None else 8) * c + cells + 4 * plan.n_rows * c + c
    return bound(nbytes, 8 * c)


def check_gather_emit(rng, dev):
    from repro_torch.kernels import gather_emit as GE
    from repro_torch.kernels import join_expand as JE

    nsrc, c = 1_000_000, 4096
    lcols = torch.from_numpy(rng.randint(0, 4, (3, nsrc)).astype(np.int32)).to(dev)
    rcols = torch.from_numpy(rng.randint(0, 4, (3, nsrc)).astype(np.int32)).to(dev)
    li = torch.from_numpy(rng.randint(0, nsrc, c).astype(np.int32)).to(dev)
    ri_np = rng.randint(0, nsrc, c).astype(np.int32)
    ri_np[rng.rand(c) < 0.1] = -1  # virtual NULL rows (left_outer padding)
    ri = torch.from_numpy(ri_np).to(dev)
    empty_r = torch.zeros((3, 0), dtype=torch.int32, device=dev)
    # join-shaped indices: join_expand over the 40,000-group case, so li
    # never decreases and ri comes in runs, as on the main path
    groups = _groups(rng, 40000, 4, 8, dev)
    jli, jri = JE.join_expand(*groups, int(groups[4][-1]) // 2, c)
    require(bool((jli[1:] >= jli[:-1]).all()), "gather_emit: join-shaped li must not decrease")
    # plans at and past the caps over 18- and 6-row sources
    wide_l = torch.from_numpy(rng.randint(0, 4, (18, 100_000)).astype(np.int32)).to(dev)
    wide_r = torch.from_numpy(rng.randint(0, 4, (6, 100_000)).astype(np.int32)).to(dev)
    wli = torch.from_numpy(rng.randint(0, 100_000, c).astype(np.int32)).to(dev)
    wri = torch.from_numpy(np.where(rng.rand(c) < 0.1, -1, rng.randint(0, 100_000, c))
                           .astype(np.int32)).to(dev)
    at_caps = GE.EmitPlan(tuple(range(11)) + (-1,), (5, -1, 0, 3),
                          ((0, 0), (11, 1), (3, 3), (7, 5)))
    require(at_caps.n_rows == GE.MAX_ROWS and len(at_caps.pairs) == GE.MAX_PAIRS
            and len(at_caps.chunks) == 1, "gather_emit: the caps case must sit at the caps")
    # past the caps: launches of chunks within them over the same li / ri
    wide = GE.EmitPlan(tuple(range(15)) + (-1,), (5, -1, 0, 3),
                       ((0, 0), (11, 1), (3, 3), (7, 5), (17, 2), (16, 4)))
    pairs_only = GE.EmitPlan(pairs=((0, 0), (11, 1), (3, 3), (7, 5), (17, 2), (16, 4)))
    require(wide.n_rows == 20 and len(wide.chunks) == 2 and len(pairs_only.chunks) == 2,
            "gather_emit: the wide cases must pass the caps")
    join = GE.EmitPlan((0, 1, 2), (1, 2), ((0, 0),))
    concat = GE.EmitPlan((0, 1, 2))
    cases = [
        ("join emit", (lcols, rcols, li, ri, join), None),
        ("-1 rows, 2 pairs", (lcols, rcols, li, ri,
                              GE.EmitPlan((0, -1, 2), (-1, 1), ((0, 0), (1, 1)))), None),
        ("mask only", (lcols, rcols, li, ri, GE.EmitPlan(pairs=((0, 0),))), None),
        ("empty right", (lcols, empty_r, li, ri, GE.EmitPlan((0, 1), (0, 2), ((0, 0),))), None),
        ("concat (no ri)", (lcols, None, li, None, GE.EmitPlan((2, -1, 0))), None),
        ("concat, all rows", (lcols, None, li, None, concat), None),
        ("out offset", (lcols, rcols, li, ri, join), 4096),
        ("unaligned out offset", (lcols, rcols, li, ri, join), 4099),
        ("join-shaped", (lcols, rcols, jli, jri, join), None),
        ("plan at the caps", (wide_l, wide_r, wli, wri, at_caps), None),
        ("20 rows, 6 pairs", (wide_l, wide_r, wli, wri, wide), None),
        ("pairs only, 6 pairs", (wide_l, wide_r, wli, wri, pairs_only), None),
        ("20 rows, 6 pairs, out offset", (wide_l, wide_r, wli, wri, wide), 4099),
    ]
    err = 0
    for label, args, off in cases:
        if off is None:
            blk, m = GE.gather_emit(*args)
            pblk, pm = GE.gather_emit_plain(*args)
        else:
            out = torch.full((24, 3 * c), 7, dtype=torch.int32, device=dev)
            pout = out.clone()
            blk, m = GE.gather_emit(*args, out=out, out_offset=off)
            pblk, pm = GE.gather_emit_plain(*args, out=pout, out_offset=off)
            require(torch.equal(out, pout), f"gather_emit: out= buffers differ ({label})")
        require(torch.equal(blk, pblk) and torch.equal(m, pm),
                f"gather_emit disagrees with its plain version ({label})")
        if blk.numel():
            err = max(err, int((blk - pblk).abs().max()))
        log(f"  gather_emit {label}: C={c} ok")
    # C = 2^20 random slots
    bli = torch.from_numpy(rng.randint(0, nsrc, 1 << 20).astype(np.int32)).to(dev)
    bri = torch.from_numpy(rng.randint(-1, nsrc, 1 << 20).astype(np.int32)).to(dev)
    big = (lcols, rcols, bli, bri, join)
    blk, m = GE.gather_emit(*big)
    pblk, pm = GE.gather_emit_plain(*big)
    require(torch.equal(blk, pblk) and torch.equal(m, pm),
            "gather_emit disagrees with its plain version (C=2^20)")
    log("  gather_emit C=2^20: ok")
    args = cases[0][1]
    out = torch.empty((5, c), dtype=torch.int32, device=dev)
    t = timings("gather_emit", lambda: GE.gather_emit(*args, out=out),
                lambda: GE.gather_emit_plain(*args, out=out), 20)
    jargs = cases[8][1]
    extra = {
        "join-shaped": (jargs, out, None, 20),
        "concat, all rows": (cases[5][1], None,
                             lambda: torch.index_select(lcols, 1, li), 20),
        "plan at the caps": (cases[9][1], None, None, 20),
        "20 rows, 6 pairs (2 launches)": (cases[10][1], None, None, 20),
        "C=2^20": (big, None, None, 3),
    }
    for key, (a, o, lib_fn, iters) in extra.items():
        kw = {} if o is None else {"out": o}
        te = timings("gather_emit", lambda: GE.gather_emit(*a, **kw),
                     lambda: GE.gather_emit_plain(*a, **kw), iters, library_fn=lib_fn)
        b_ms, b_by = _emit_bound(a[4], a[2], a[3], int(a[2].shape[0]))
        t[key] = {**{f: te[f] for f in ("ms", "call_ms", "plain_ms", "library_ms")},
                  "bound_ms": b_ms, "bound_by": b_by}
        log(f"  gather_emit {key}: kernel {te['ms']:.6f} ms on the device "
            f"({te['call_ms']:.5f} ms per call), library {te['library_ms']}, "
            f"bound {b_ms:.6f} ms ({b_by})")
    return err, t, _emit_bound(args[4], args[2], args[3], c)


def all_opcode_program():
    """A FILTER program that uses each of the 23 opcodes, over code
    columns ?v0 ?v1 ?v3 and numeric columns ?v0 ?v1 ?v2."""
    from repro_torch.core import algebra as A
    from repro_torch.core.dictionary import Dictionary
    from repro_torch.core.exprs import compile_expr

    d = Dictionary()
    for v in range(21):
        d.encode(int(v))
    for t in ['"apple"', '"applesauce"', '"banana"', '""', ":iri1", ":iri2", 2.5]:
        d.encode(t)
    V, L = A.VarRef, A.Lit
    e = A.And((
        A.Or((A.Cmp("=", V(0), V(1)), A.Cmp("!=", V(0), V(3)))),
        A.Or((A.Cmp("=", V(0), L(3)), A.Not(A.Cmp("!=", V(1), L(5))))),
        A.Or((A.Bound(1), A.Func("strstarts", (V(3), L('"app"'))))),
        A.Func("if", (A.Cmp("<", V(0), L(10)),
                      A.Cmp("<=", A.Arith("+", V(0), V(1)), L(30)),
                      A.Cmp(">", A.Arith("-", V(0), V(1)), L(-2)))),
        A.Func("coalesce", (A.Cmp(">=", A.Arith("/", V(0), V(2)), L(1)),
                            A.Cmp("=", A.Arith("*", V(0), V(1)), L(12)))),
        A.Cmp("!=", A.Arith("*", V(1), V(2)), L(4)),
    ))
    prog = compile_expr(e, d, "mask")
    require({i[0] for i in prog.instrs} == set(range(23)),
            "the expr_eval check program must use all 23 opcodes")
    return prog, d


def q6_filter_program(dictionary):
    """q6's FILTER, compiled from the query text as the planner compiles it."""
    from repro_torch.core import algebra as A
    from repro_torch.core.exprs import compile_expr
    from repro_torch.core.parser import parse_query
    from repro_torch.data.lsqb import LSQB_QUERIES

    node = parse_query(LSQB_QUERIES["q6"])[0]
    while not isinstance(node, A.Filter):
        node = node.child
    return compile_expr(node.expr, dictionary, "mask")


def bind70_program(dictionary):
    """``BIND(?x * 1.5 + ?x * 2.5 + ... + ?x * 70.5 AS ?y)``: 210
    instructions, 70 constants, 3 registers."""
    from repro_torch.core import algebra as A
    from repro_torch.core.exprs import compile_expr

    x = A.VarRef(0)
    e = A.Arith("*", x, A.Lit(1.5))
    for k in range(2, 71):
        e = A.Arith("+", e, A.Arith("*", x, A.Lit(k + 0.5)))
    prog = compile_expr(e, dictionary, "value")
    require((len(prog.instrs), len(prog.consts), prog.n_regs) == (210, 70, 3),
            "the 70-term BIND must compile to 210 instructions, 70 constants, 3 registers")
    return prog


def times3_program(dictionary):
    """``BIND(?x * 3 AS ?y)``: 3 instructions, 2 registers."""
    from repro_torch.core import algebra as A
    from repro_torch.core.exprs import compile_expr

    return compile_expr(A.Arith("*", A.VarRef(0), A.Lit(3)), dictionary, "value")


def many_register_program(n_regs):
    """A hand-built value program over one numeric column that holds
    ``n_regs`` registers live: r_k = x / c_k for every k, then their sum."""
    from repro_torch.core.exprs import bytecode as B

    last = n_regs - 1
    instrs = [(B.LOAD_NUM, last, 0, 0, 0)]
    for r in range(last):
        instrs += [(B.LOAD_CONST, r, r, 0, 0), (B.DIV, r, last, r, 0)]
    instrs += [(B.ADD, 0, 0, r, 0) for r in range(1, last)]
    return B.ExprProgram(instrs=tuple(instrs), n_regs=n_regs, out_reg=0,
                         consts=tuple(float(k % 13) - 3.5 for k in range(last)),
                         code_vars=(), num_vars=(0,), tables=(), source_ops=len(instrs))


def check_expr_eval(rng, dev):
    from repro_torch.core.batch import ColumnBatch
    from repro_torch.core.exprs.vm import prepare_inputs
    from repro_torch.kernels import expr_eval as EE

    prog, d = all_opcode_program()
    n = 4096
    cols = [rng.randint(-1, 21, n), rng.randint(-1, 21, n),
            rng.choice([0, 1, 2, 4], n), rng.randint(-1, len(d), n)]
    batch = ColumnBatch.from_columns(
        (0, 1, 2, 3), [torch.from_numpy(c.astype(np.int32)).to(dev) for c in cols], dev)
    icols, fcols = prepare_inputs(prog, batch, d)
    require(fcols.dtype == torch.float64, "expr_eval: the value plane must be float64")
    # float64 values float32 cannot hold, and non-numeric rows
    fcols = torch.from_numpy(rng.choice(NOT_F32, tuple(fcols.shape))).to(dev)
    fcols[:, ::97] = float("nan")

    def numeric(m):
        f = torch.from_numpy(rng.choice(NOT_F32, (1, m))).to(dev)
        f[:, ::89] = float("nan")
        return f

    q6 = q6_filter_program(d)
    q6_icols = torch.from_numpy(rng.randint(-1, 3000, (q6.n_icols, n)).astype(np.int32)).to(dev)
    q6_icols[1, ::5] = q6_icols[0, ::5]
    none = torch.zeros((1, n), dtype=torch.int32, device=dev)
    shared_big = many_register_program(100)  # 124,416 bytes of shared memory at 128 threads
    global_big = many_register_program(1000)  # past a block's shared memory at 32 threads
    # the 23 opcodes on global planes: the same program with 1,000 registers,
    # 993 of them unused
    global_23 = dataclasses.replace(prog, n_regs=1000)
    times3 = times3_program(d)
    require(EE.launch_shape(prog) == (EE.THREADS, "shared")
            and EE.launch_shape(q6)[1] == EE.launch_shape(times3)[1] == "registers"
            and EE.launch_shape(shared_big) == (EE.THREADS, "shared")
            and EE.launch_shape(global_big)[1] == EE.launch_shape(global_23)[1] == "global",
            "expr_eval: the instances are not as planned")
    no_num = torch.full((1, n), float("nan"), dtype=torch.float64, device=dev)
    # label: (program, icols, fcols)
    progs = {
        "23-opcode program": (prog, icols, fcols),
        "23-opcode program, global planes": (global_23, icols, fcols),
        "q6 FILTER": (q6, q6_icols, no_num),
        "BIND(?x * 3)": (times3, none, numeric(n)),
        "70-term BIND": (bind70_program(d), none, numeric(n)),
        "100 registers, shared planes above 48 KB": (shared_big, none, numeric(n)),
        "300 registers, 64 threads": (many_register_program(300), none, numeric(n)),
        "1,000 registers, global planes": (global_big, none, numeric(n)),
    }
    max_err, t = 0.0, None
    for label, (p, ic, fc) in progs.items():
        val, err_ = EE.expr_eval(p, ic, fc)
        pval, perr = EE.expr_eval_plain(p, ic, fc)
        require(val.dtype == torch.float64 and torch.equal(err_, perr),
                f"expr_eval: error planes differ ({label})")
        require(torch.equal(val.view(torch.int64), pval.view(torch.int64)),
                f"expr_eval: values differ from the plain version's bits ({label})")
        max_err = max(max_err, max_abs_diff(val, pval))
        shape = EE.launch_shape(p)
        log(f"  expr_eval {label} ({len(p.instrs)} instrs, {len(p.consts)} consts, "
            f"{p.n_regs} regs; {shape[0]} threads, the {shape[1]} instance): n={n} "
            f"true={int(((val != 0) & ~err_).sum())} bit for bit")
        te = timings("expr_eval", lambda: EE.expr_eval(p, ic, fc),
                     lambda: EE.expr_eval_plain(p, ic, fc), 3 if p.n_regs > 50 else 10)
        nbytes = p.n_icols * 4 * n + p.n_fcols * 8 * n + n * 9
        b_ms, b_by = bound(nbytes, n * len(p.instrs), PEAK_FP64_OPS_PER_S)
        if t is None:
            t, main_bound = te, (b_ms, b_by)
        else:
            t[label] = {**{f: te[f] for f in ("ms", "call_ms", "plain_ms")},
                        "bound_ms": b_ms, "bound_by": b_by}
        log(f"  expr_eval {label}: kernel {te['ms']:.6f} ms on the device "
            f"({te['call_ms']:.5f} ms per call), bound {b_ms:.6f} ms ({b_by})")
    return max_err, t, main_bound


def _sorted_keys(rng, n, max_run, n_runs=None):
    """``n`` sorted keys in runs of 1 to ``max_run``; ``n_runs`` run lengths
    are drawn (``n`` when not given), enough when they sum past ``n``."""
    lens = rng.randint(1, max_run + 1, n if n_runs is None else n_runs)
    lens[-1] += max(0, n - int(lens.sum()))
    keys = np.repeat(np.arange(len(lens)), lens)[:n]
    return keys.astype(np.int32)


def check_segment_scan(rng, dev):
    from repro_torch.kernels import segment_scan as SS

    n, big = 4096, 1 << 20
    key_sets = {
        "runs<=64": _sorted_keys(rng, n, 64),
        "runs across 1024": _sorted_keys(rng, n, 3000),
        "one run": np.zeros(n, np.int32),
        "all distinct": np.arange(n, dtype=np.int32),
        "n=100000": _sorted_keys(rng, 100_000, 500),
        # above one tile (4096): many blocks joined by the look-back
        "n=1048576 runs<=500": _sorted_keys(rng, big, 500),
        "n=1048576 runs across tiles": _sorted_keys(rng, big, 20_000, n_runs=200),
        "n=1048576 one run": np.full(big, 7, np.int32),
    }
    err = 0.0
    for label, keys_np in key_sets.items():
        keys = torch.from_numpy(keys_np).to(dev)
        m = len(keys_np)
        # float64 values float32 cannot hold, and standard normals: the
        # plain version keeps the kernel's summation order, so every sum
        # equals it bit for bit
        vals = torch.from_numpy(rng.choice(NOT_F32, m) * rng.standard_normal(m)).to(dev)
        for op in ("sum", "count", "min", "max"):
            v = torch.ones_like(vals) if op == "count" else vals
            got = SS.segment_scan(keys, v, op)
            want = SS.segment_scan_plain(keys, v, op)
            require(got.dtype == torch.float64, "segment_scan: the value plane must be float64")
            require(torch.equal(got.view(torch.int64), want.view(torch.int64)),
                    f"segment_scan {op} differs from the tile model's bits ({label})")
            err = max(err, max_abs_diff(got, want))
        got = SS.segment_scan(keys, None, "count")
        want = SS.segment_scan_plain(keys, None, "count")
        require(torch.equal(got, want), f"segment_scan count without values differs ({label})")
        err = max(err, max_abs_diff(got, want))
        log(f"  segment_scan {label}: n={m} sum/count/min/max and count without values ok")

    def timed(label, values, op, plain_iters=5):
        keys = torch.from_numpy(key_sets[label]).to(dev)
        m = keys.shape[0]
        vals = (None if values is None else
                torch.from_numpy(rng.choice(NOT_F32, m)).to(dev))
        fn = lambda: SS.segment_scan(keys, vals, op)  # noqa: E731
        t = timings("segment_scan", fn, lambda: SS.segment_scan_plain(keys, vals, op), plain_iters)
        # every device op of one call, the look-back's zeroed scratch included
        t["call_device_ms"] = device_ms(fn, 200)
        return t, bound((12 if values is None else 20) * m, 2 * m, PEAK_FP64_OPS_PER_S)

    t, main_bound = timed("runs<=64", "values", "sum", plain_iters=10)
    for key, label, values, op in (("count_without_values", "runs<=64", None, "count"),
                                   ("n=100000", "n=100000", "values", "sum"),
                                   ("n=1048576", "n=1048576 runs<=500", "values", "sum"),
                                   ("n=1048576 one run", "n=1048576 one run", "values", "sum")):
        te, (b_ms, b_by) = timed(label, values, op)
        t[key] = {**{f: te[f] for f in ("ms", "call_ms", "plain_ms", "call_device_ms")},
                  "bound_ms": b_ms, "bound_by": b_by}
        log(f"  segment_scan {key}: kernel {te['ms']:.6f} ms on the device "
            f"({te['call_ms']:.5f} ms per call, {te['call_device_ms']} ms of device ops per "
            f"call), bound {b_ms:.6f} ms ({b_by})")
    return err, t, main_bound


# radix_partition's edges: key counts and partition counts, each pair at
# one of the four 4-byte phases, so that every instance runs (batch to
# 4,096 keys, small to 2^18 and with few partitions to 2^20, large beyond)
RADIX_NS = (0, 1, 4095, 65_536, 262_143, 3_891_273, 1 << 24)
RADIX_PARTS = (1, 2, 16, 1024, 8192)


def check_radix_partition(rng, dev):
    from repro_torch.kernels import radix_partition as RP

    n = 3_891_273  # the full-size q1 build: the :knows scan's subject column
    keys = torch.from_numpy(rng.randint(0, 2_000_000, n).astype(np.int32)).to(dev)
    # the edges draw from their own generator, so that the later checks'
    # inputs stay those of earlier runs
    erng = np.random.RandomState(SEED + 1)
    big = torch.from_numpy(erng.randint(-(2 ** 31), 2 ** 31 - 1, 1 << 24,
                                        dtype=np.int64).astype(np.int32)).to(dev)
    cases = [(f"n={m:,} P={p} at phase {(i + j) % 4}", _at_offset(big[:m], (i + j) % 4), p)
             for i, m in enumerate(RADIX_NS) for j, p in enumerate(RADIX_PARTS)]
    cases.append(("n=1,000,000 P=16 at phase 1", _at_offset(big[:1_000_000], 1), 16))
    cases += [(f"n=3,891,273 P=1024 at phase {ph}", _at_offset(keys, ph), 1024)
              for ph in (1, 2, 3)]
    for p in (1, 1024, 8192):
        for label, v in (("all -1", -1), ("all equal", 77)):
            cases.append((f"{label} keys, n=3,891,273 P={p}",
                          torch.full((n,), v, dtype=torch.int32, device=dev), p))
    cases.append(("sorted runs (a build's subject column), P=1024",
                  torch.from_numpy(_sorted_keys(erng, n, 40)).to(dev), 1024))
    for label, k, p in cases:
        pid, hist = RP.radix_partition(k, p)
        ppid, phist = RP.radix_partition_plain(k, p)
        require(torch.equal(pid, ppid) and torch.equal(hist, phist),
                f"radix_partition disagrees with its plain version ({label})")
        require(int(hist.sum()) == k.shape[0], f"radix_partition: histogram total ({label})")
        log(f"  radix_partition {label}: ok")
    ran = {RP.launch_shape(int(k.shape[0]), p)[0] for _, k, p in cases}
    require(ran == {RP.SMALL, RP.BATCH, RP.LARGE},
            f"radix_partition: the edges ran instances {sorted(ran)}, not all three")
    t = timings("radix_partition", lambda: RP.radix_partition(keys, 1024),
                lambda: RP.radix_partition_plain(keys, 1024), 10)
    # back-to-back launches find the 31 MB of keys and pids in the 50 MB L2,
    # where the DRAM bound does not hold: ms is taken with a 64 MB write
    # between launches (not counted), the warm time beside it
    flush = torch.empty(1 << 24, dtype=torch.int32, device=dev)
    t["keys in L2"] = {"ms": t["ms"], "ms_source": t["ms_source"]}
    t["ms"] = device_ms(lambda: (flush.zero_(), RP.radix_partition(keys, 1024)), 200,
                        kernel="radix_partition")
    t["ms_source"] = "profiler"
    if t["ms"] is None:
        # the same quantity from CUDA events around each launch alone
        t["ms"] = event_ms(flush.zero_, lambda: RP.radix_partition(keys, 1024), 200)
        t["ms_source"] = "cuda_events"
        log("  radix_partition keys out of L2: the profiler recorded no device time; ms is "
            "from CUDA events around each launch")
    log(f"  radix_partition keys out of L2: {t['ms']:.6f} ms ({t['ms_source']}), in L2 "
        f"{t['keys in L2']['ms']:.6f} ({t['keys in L2']['ms_source']})")
    # the launch-bound size: 4,096 keys, one call's device time and its
    # time per call (the wrapper no longer zero-fills the histogram)
    small = keys[:4096].clone()
    t["n=4096"] = {"ms": device_ms(lambda: RP.radix_partition(small, 1024), 200,
                                   kernel="radix_partition"),
                   "call_ms": call_ms(lambda: RP.radix_partition(small, 1024), 200),
                   "call_device_ms": device_ms(lambda: RP.radix_partition(small, 1024), 200),
                   "bound_ms": bound(8 * 4096 + 4 * 1024, 6 * 4096)[0]}
    log(f"  radix_partition n=4096: {json.dumps(t['n=4096'])}")
    # keys read, pids written, the histogram written; ~6 integer ops a key
    return 0, t, bound(8 * n + 4 * 1024, 6 * n)


def _layout(hi, lo, n_parts):
    from repro_torch.kernels import hash_join as HJ

    order, starts = HJ.hash_build(hi, lo, n_parts)
    idx = order.long()
    return starts, (None if hi is None else hi[idx].contiguous()), lo[idx].contiguous()


def _probe_bytes(starts_np, qpid, lo_np, c, key_bytes):
    """Bytes a probe of ``c`` keys needs: its keys read and (lo, hi) written,
    one 32-byte sector for its two part_starts entries, and one sector per
    binary-search step, counted from this data's partition slices."""
    seg_lo, seg_hi = starts_np[qpid], starts_np[qpid + 1]
    # a binary search over m rows takes at most bit_length(m) steps
    steps = np.ceil(np.log2(seg_hi - seg_lo + 1.0)) + np.ceil(np.log2(seg_hi - lo_np + 1.0))
    return c * (key_bytes + 8 + 32) + 32 * int(steps.sum())


def run_keys(rng, n, max_run, n_parts, dev):
    """A build of ``n`` single keys in runs of 1 to ``max_run`` rows, laid
    out in ``n_parts`` partitions, and probes of every key, of each
    partition's last row, of absent keys and of INT32_MIN."""
    keys = _sorted_keys(rng, n, max_run, n_runs=n // max(1, max_run // 2) + 1) * 7 + 3
    starts, _, skl = _layout(None, torch.from_numpy(keys).to(dev), n_parts)
    last = skl[(starts[1:] - 1).clamp(min=0).long()][starts[1:] > starts[:-1]]
    q = torch.cat([torch.from_numpy(np.unique(keys)).to(dev), last,
                   torch.from_numpy(np.unique(keys)[:500] + 1).to(dev),
                   torch.tensor([-(2 ** 31), -1], dtype=torch.int32, device=dev)])
    return starts, None, skl, None, q


def probe_edge_cases(rng, dev, keys_np, q):
    """hash_probe's edges: one partition over the 3.9M-row build, runs up
    to 5,000 rows (many ending at their partition's last row), and probe
    batches that leave the last group of lanes partly past the end."""
    keys = torch.from_numpy(keys_np).to(dev)
    one = _layout(None, keys, 1)
    big = _layout(None, keys, 1024)
    q4097 = torch.cat([q, q[:1]])
    return [
        ("single keys, 3,891,273 rows, P=1", (*one, None, q)),
        ("runs of up to 5,000 rows, P=1024", run_keys(rng, 3_891_273, 5000, 1024, dev)),
        ("runs of up to 5,000 rows, P=1", run_keys(rng, 1_000_000, 5000, 1, dev)),
        ("runs of up to 40 rows, P=64", run_keys(rng, 200_000, 40, 64, dev)),
        ("a probe of 1 key", (*big, None, q[:1].clone())),
        ("a probe of 33 keys", (*big, None, q[:33].clone())),
        ("a probe of 4,097 keys", (*big, None, q4097)),
    ]


def check_hash_probe(rng, dev):
    from repro_torch.core import vecops as TV
    from repro_torch.kernels import hash_join as HJ

    n, c, p = 3_891_273, 4096, 1024
    dom = 500_000
    # leave partitions 0-7 empty, so some probes find no slice at all
    cand = rng.randint(0, dom, 2 * n).astype(np.int32)
    cand_pid = TV.hash_partition(torch.from_numpy(cand), p).numpy()
    keys_np = cand[cand_pid >= 8][:n]
    starts, _, skl = _layout(None, torch.from_numpy(keys_np).to(dev), p)
    in_empty = cand[cand_pid < 8][:64]
    q_np = np.concatenate([
        keys_np[rng.randint(0, n, c // 2)],  # present
        rng.randint(dom, 2 * dom, c // 2 - 128).astype(np.int32),  # absent
        np.full(64, -1, np.int32), in_empty,  # NULL keys, empty partitions
    ]).astype(np.int32)
    q = torch.from_numpy(q_np).to(dev)

    # pair keys: two columns packed with fixed spans; oversized: hi past 2^21
    def pair_case(m, lo_dom, hi_dom):
        cols = torch.from_numpy(np.stack([rng.randint(0, hi_dom, m), rng.randint(0, lo_dom, m)])
                                .astype(np.int32)).to(dev)
        spans = [int(x) + 3 for x in cols.amax(dim=1).tolist()]
        packed = TV.pack_group_keys(cols, spans=spans)
        qcols = torch.cat([cols[:, torch.randint(0, m, (c // 2,), device=dev)],
                           cols[:, :c // 2] + 1], dim=1)
        qpacked = TV.pack_group_keys(qcols, spans=spans)
        split = lambda x: ((x >> 31).to(torch.int32), (x & 0x7FFFFFFF).to(torch.int32))  # noqa: E731
        return split(packed), split(qpacked)

    (bh, bl), (qh, ql) = pair_case(1_000_000, 3000, 3_000_000)
    ohi = torch.from_numpy(rng.randint(1 << 21, 1 << 22, 200_000).astype(np.int32)).to(dev)
    olo = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, 200_000).astype(np.int32)).to(dev)
    opick = torch.randint(0, 200_000, (c,), device=dev)
    cases = [
        ("single keys, 3,891,273 rows, P=1024", (starts, None, skl, None, q)),
        ("pair keys, 1,000,000 rows", (*_layout(bh, bl, 256), qh, ql)),
        ("oversized pair keys", (*_layout(ohi, olo, 1024), ohi[opick],
                                 olo[opick] ^ (opick % 2).to(torch.int32))),
        ("empty build", (torch.zeros(p + 1, dtype=torch.int32, device=dev), None,
                         skl[:0], None, q)),
    ]
    cases += probe_edge_cases(rng, dev, keys_np, q)
    for label, args in cases:
        lo, hi = HJ.hash_probe(*args)
        plo, phi = HJ.hash_probe_plain(*args)
        require(torch.equal(lo, plo) and torch.equal(hi, phi),
                f"hash_probe disagrees with its plain version ({label})")
        log(f"  hash_probe {label}: {int((hi > lo).sum())} of {args[-1].shape[0]} matched, ok")
    lo, hi = HJ.hash_probe(starts, None, skl, None, q)
    matched = (hi > lo).cpu().numpy()
    require(matched[: c // 2].all() and not matched[c // 2:].any(),
            "hash_probe: present keys must match and absent ones must not")
    # the library yardstick: two searchsorted calls on the (pid, key) composite
    shift = TV._pid_shift(p)
    spid = torch.repeat_interleave(torch.arange(p, device=dev), (starts[1:] - starts[:-1]).long(),
                                   output_size=n)
    comp_b = (spid << shift) | TV._pair_comp(None, skl)
    qpid = TV.hash_partition(q, p)
    comp_q = (qpid.long() << shift) | TV._pair_comp(None, q)
    lib = (torch.searchsorted(comp_b, comp_q).to(torch.int32),
           torch.searchsorted(comp_b, comp_q, right=True).to(torch.int32))
    require(torch.equal(lib[0], lo) and torch.equal(lib[1], hi),
            "hash_probe: the library searchsorted yardstick disagrees")
    t = timings("hash_probe", lambda: HJ.hash_probe(starts, None, skl, None, q),
                lambda: HJ.hash_probe_plain(starts, None, skl, None, q), 5,
                library_fn=lambda: (torch.searchsorted(comp_b, comp_q),
                                    torch.searchsorted(comp_b, comp_q, right=True)))
    nbytes = _probe_bytes(starts.cpu().numpy().astype(np.int64), qpid.cpu().numpy().astype(np.int64),
                          lo.cpu().numpy().astype(np.int64), c, 4)
    return 0, t, bound(nbytes, 60 * c)


def _engine_order(keys, n_parts):
    """``keys`` as the hash join lays its build out (``HashJoin.sip_keys``):
    sorted by radix partition, then by key, so equal keys sit together."""
    from repro_torch.kernels import radix_partition as RP

    pid, _ = RP.radix_partition_plain(keys, n_parts)
    return keys[torch.argsort((pid.to(torch.int64) << 32) | keys.to(torch.int64))].contiguous()


def _device_ops(fn, iters: int = 20, windows: int = 5) -> dict:
    """{name: count} of the device kernels and copies that ``iters`` calls
    of ``fn`` ran, from torch.profiler. The profiler may drop an event now
    and then, so a count may fall short, and a whole window may come back
    with no device event at all: such a window is profiled again, up to
    ``windows`` of them, and {} means that none recorded any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cpu:
                ops[e.name()] = ops.get(e.name(), 0) + 1
        if ops:
            return ops
    return {}


def _torch_ops(fn, iters: int = 20) -> dict:
    """{op: count} of the PyTorch operators that ``iters`` calls of ``fn``
    dispatched on CUDA tensors, each with the device of its first output
    ("aten._to_copy.default -> cpu" is a copy to the host). Unlike the
    profiler, the dispatcher drops nothing; it does not see a kernel
    launched through the C interface, which its wrapper's count shows."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def on_card(x):
        return isinstance(x, torch.Tensor) and x.device.type == "cuda"

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            flat = [out] if isinstance(out, torch.Tensor) else list(out) \
                if isinstance(out, (tuple, list)) else []
            if any(on_card(a) for a in (*args, *kwargs.values(), *flat)):
                first = next((t for t in flat if isinstance(t, torch.Tensor)), None)
                key = f"{func} -> {first.device.type if first is not None else 'none'}"
                self.ops[key] = self.ops.get(key, 0) + 1
            return out

    fn()
    torch.cuda.synchronize()
    with Record() as rec:
        for _ in range(iters):
            fn()
    torch.cuda.synchronize()
    return rec.ops


# what one bloom_build call may dispatch besides its kernel: the words'
# allocation, views of the slab and of the range words, and the range's
# one copy to the host
BLOOM_BUILD_TORCH_OPS = {"aten.empty.memory_format -> cuda", "aten.slice.Tensor -> cuda",
                         "aten._to_copy.default -> cpu", "aten.copy_.default -> cpu"}


# bloom_build's shapes timed beside the full-size q6 build's random order
BLOOM_TIMED = ("n=1,369,041 in the engine's order", "n=1,369,041 all equal",
               "n=1,369,041 half NULL", "n=4,096", "n=2^24")


# bloom_build's shapes beyond the full-size q6 build (keys in [0, 300,000)
# unless named): (label, keys, n_words or None)
def _bloom_shapes(rng, dev, keys):
    n = int(keys.shape[0])
    u = lambda m, hi=300_000: torch.from_numpy(  # noqa: E731
        rng.randint(0, hi, m).astype(np.int32)).to(dev)
    half = keys.clone()
    half[torch.from_numpy(rng.permutation(n)[: n // 2]).to(dev)] = -1
    return [("n=1,369,041", keys, None),
            ("n=1,369,041 in the engine's order", _engine_order(keys, 1024), None),
            ("n=1,369,041 all equal", torch.full((n,), 12345, dtype=torch.int32, device=dev), None),
            ("n=1,369,041 half NULL", half, None),
            ("n=1,369,040 at phase 1", _at_offset(keys[1:], 1), None),
            ("n=4,096", u(4096), None),
            ("n=4,093 at phase 3", _at_offset(u(4093), 3), None),
            ("n=40,000 (W = 2^15)", u(40_000), None),
            ("n=100,000 (W = 2^16)", u(100_000, 1 << 30), None),
            ("n=300,000 into 2^18 words", u(300_000), 1 << 18),
            ("n=2^24", u(1 << 24, 1 << 24), None),
            ("1,000 NULL keys", torch.full((1000,), -1, dtype=torch.int32, device=dev), None),
            ("one key", u(1), None),
            ("empty", keys[:0].clone(), None)]


def check_bloom(rng, dev):
    """bloom_build and bloom_probe: their checks and timings."""
    from repro_torch.core import vecops as TV
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import bloom_filter as BF

    n, c = 1_369_041, 4096  # the full-size q6 SIP build: the :hasInterest scan
    keys = torch.from_numpy(rng.randint(0, 300_000, n).astype(np.int32)).to(dev)
    n_words = TV.bloom_n_words(n)
    require(n_words == 1 << 20, "bloom: the full-size build should fill 2^20 words")
    rows = {}
    shapes = _bloom_shapes(rng, dev, keys)
    for label, k, w in shapes:
        before = BF.build_launches
        words, lo, hi = BF.bloom_build(k, w)
        require(BF.build_launches - before == 1, f"bloom_build: not one launch ({label})")
        w = TV.bloom_n_words(k.shape[0]) if w is None else w
        pwords, plo, phi = BF.bloom_build(k.cpu(), w)
        require(torch.equal(words.cpu(), pwords) and (lo, hi) == (plo, phi),
                f"bloom_build disagrees with its plain version on the CPU ({label})")
        require(torch.equal(words, BF.bloom_build_plain(k, w)),
                f"bloom_build disagrees with its plain version on the card ({label})")
        log(f"  bloom_build {label}: {w} words, range ({lo}, {hi}) ok")
    before, slab = BF.build_launches, dict(KB._slabs)
    ops = _torch_ops(lambda: BF.bloom_build(keys))
    # a slab used up mid-run is replaced by one fill (build.zeroed)
    refilled = (any(KB._slabs.get(k) is not v for k, v in slab.items())
                or KB._slabs.keys() - slab.keys())
    extra = (set(ops) - BLOOM_BUILD_TORCH_OPS
             - ({"aten.zeros.default -> cuda"} if refilled else set()))
    require(BF.build_launches - before == 21 and not extra,
            f"bloom_build: 21 calls made {BF.build_launches - before} launches and dispatched "
            f"{ops}, not the kernel with an allocation, views and a copy to the host alone")
    log(f"  bloom_build, 20 calls' PyTorch ops on the card: {ops}")
    ran = _device_ops(lambda: BF.bloom_build(keys))
    if ran:
        require(all("bloom_build_kernel" in x or "DtoH" in x for x in ran)
                and any("bloom_build_kernel" in x for x in ran),
                f"bloom_build: 20 calls ran {ran}, not the kernel and a copy alone")
        log(f"  bloom_build, 20 calls on the device: {ran}")
    else:
        log("  bloom_build, 20 calls on the device: the profiler recorded no device event in "
            "5 windows (not measured); the dispatched ops and the launch count above stand")
    t = timings("bloom_build", lambda: BF.bloom_build(keys),
                lambda: BF.bloom_build_plain(keys, n_words), 5)
    # keys read once, words written once; ~12 integer ops a key
    b = bound(4 * n + 4 * n_words, 12 * n)
    rows["bloom_build"] = (0, t, b)
    for label, k, _ in shapes:
        if label not in BLOOM_TIMED:
            continue
        kn = int(k.shape[0])
        t[f"bloom_build {label}"] = {
            "ms": device_ms(lambda: BF.bloom_build(k), 200, kernel="bloom_build"),
            "call_ms": call_ms(lambda: BF.bloom_build(k), 200),
            "bound_ms": bound(4 * kn + 4 * TV.bloom_n_words(kn), 12 * kn)[0]}
        log(f"  bloom_build {label}: {json.dumps(t[f'bloom_build {label}'])}")
    words, _, _ = BF.bloom_build(keys)

    q = torch.cat([keys[torch.randint(0, n, (c // 2,), device=dev)],
                   torch.randint(300_000, 600_000, (c // 2 - 32,), device=dev, dtype=torch.int32),
                   torch.full((32,), -1, dtype=torch.int32, device=dev)])
    for label, qq in (("4,096 queries", q), ("4,095 queries at phase 1", _at_offset(q[1:], 1))):
        got = BF.bloom_probe(words, qq)
        require(torch.equal(got, BF.bloom_probe_plain(words, qq)),
                f"bloom_probe disagrees with its plain version ({label})")
    got = BF.bloom_probe(words, q)
    require(bool(got[: c // 2].all()), "bloom_probe: a false negative")
    log(f"  bloom_probe {c} queries: {int(got[c // 2:].sum())} false positives of "
        f"{c - c // 2} non-members, ok")
    t = timings("bloom_probe", lambda: BF.bloom_probe(words, q),
                lambda: BF.bloom_probe_plain(words, q), 20)
    t.update(check_sip_mask(dev, words))
    # a query read, a bool written, each 32-byte sector of words that these
    # queries touch read once
    rows["bloom_probe"] = (0, t, bound(c * (4 + 1) + 32 * _word_sectors(words, q), 12 * c))
    return rows


def _word_sectors(words, codes):
    """32-byte sectors of ``words`` that probes of ``codes`` touch."""
    from repro_torch.core import vecops as TV

    word, _ = TV.bloom_hash(codes, int(words.shape[0]))
    return int(torch.unique(word // 8).shape[0])


# the fused SIP mask's cases: (filter kinds, capacity, n_rows, mask partly
# False, the codes' 4-byte phase); kinds "bloom" (the full-size q6 build's
# filter first, then smaller builds), "range", "empty"
SIP_CASES = {
    "one filter": (("bloom",), 4096, 4096, False, 0),
    "two filters (q5's shape)": (("bloom", "bloom"), 4096, 4096, False, 0),
    "six filters: two launches": (("bloom",) * 3 + ("range", "bloom", "bloom"),
                                  4096, 4096, False, 0),
    "range only": (("range",), 4096, 4096, False, 0),
    "range beside a bloom filter": (("range", "bloom"), 1024, 1000, False, 0),
    "empty range": (("empty", "bloom"), 4096, 4096, False, 0),
    "n_rows below capacity": (("bloom",), 4096, 2049, False, 0),
    "mask partly False, capacity 4,097": (("bloom", "bloom"), 4097, 3999, True, 0),
    "codes at phase 1, capacity 4,097": (("bloom", "bloom"), 4097, 4095, True, 1),
    "codes at phase 2, capacity 4,098": (("bloom",), 4098, 4098, False, 2),
    "codes at phase 3, capacity 4,099": (("bloom", "range"), 4099, 4001, True, 3),
    "one row": (("bloom",), 32, 1, False, 0),
    "no rows": (("bloom",), 32, 0, True, 0),
}


def _sip_inputs(rng, dev, words, case):
    """A case's (mask, n_rows, filters): codes in [-1, 300,000) (NULLs,
    members, non-members) as row views of one flat buffer at the case's
    phase, the rows past n_rows NULL."""
    from repro_torch.kernels import bloom_filter as BF

    kinds, cap, n, partly, phase = SIP_CASES[case]
    flat = torch.full((len(kinds) * (cap + 8) + 8,), -1, dtype=torch.int32, device=dev)
    filters = []
    for k, kind in enumerate(kinds):
        start = 4 * (k * (cap // 4 + 2)) + phase
        flat[start: start + n] = torch.from_numpy(
            rng.randint(-1, 300_000, n).astype(np.int32)).to(dev)
        codes = flat[start: start + n]
        if kind == "bloom":
            if k == 0:
                w, lo, hi = words, 0, 299_999
            else:
                w, lo, hi = BF.bloom_build(torch.from_numpy(
                    rng.randint(-1, 300_000, 50_000).astype(np.int32)).to(dev))
            filters.append((codes, w, lo, hi))
        elif kind == "range":
            lo = int(rng.randint(-1, 150_000))
            filters.append((codes, None, lo, lo + 100_000))
        else:
            filters.append((codes, None, 10, 9))
    mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    mask[:n] = (torch.from_numpy(rng.rand(n) < 0.7).to(dev) if partly else True)
    return mask, n, filters


def _unfused_sip_step(mask, n, filters):
    """The scan's SIP step before the fused kernel, with this tree's ops:
    per filter the range test, the probe, the AND, a zeroed
    full-capacity mask, its slice copy and with_mask's in-place AND."""
    from repro_torch.kernels import bloom_filter as BF

    for codes, words, lo, hi in filters:
        m = (codes >= lo) & (codes <= hi)
        if words is not None:
            m &= BF.bloom_probe(words, codes)
        full = torch.zeros(mask.shape[0], dtype=torch.bool, device=mask.device)
        full[:n] = m
        mask.logical_and_(full)
    return mask


def host_calls(fn, iters: int = 20) -> dict:
    """cudaLaunchKernel and cudaMemsetAsync calls per call of ``fn``
    (torch.profiler's host events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return {k: names.count(k) / iters for k in ("cudaLaunchKernel", "cudaMemsetAsync")}


def check_sip_mask(dev, words):
    """The fused SIP mask (bloom_probe's second entry point) against
    sip_mask_plain on the card, bit for bit, in place, into a fresh mask and
    with no mask; then the device time of its launch and its time per call
    beside the unfused step, at 4,096 rows with one and two filters."""
    from repro_torch.kernels import bloom_filter as BF

    rng = np.random.RandomState(SEED + 2)
    out = {}
    for case in SIP_CASES:
        mask, n, filters = _sip_inputs(rng, dev, words, case)
        want = BF.sip_mask_plain(mask.clone(), n, filters)
        before = BF.probe_launches
        got = BF.sip_mask(mask.clone(), n, filters)
        launched = BF.probe_launches - before
        fresh = BF.sip_mask(mask, n, filters, out=torch.empty_like(mask))
        require(torch.equal(got, want) and torch.equal(fresh, want),
                f"sip_mask disagrees with its plain version ({case})")
        require(torch.equal(BF.sip_mask(None, n, filters),
                            BF.sip_mask_plain(None, n, filters)),
                f"sip_mask with no mask disagrees with its plain version ({case})")
        require(torch.equal(_unfused_sip_step(mask.clone(), n, filters), want),
                f"sip_mask differs from the unfused step ({case})")
        require(launched == -(-len(filters) // BF.SIP_TERMS),
                f"sip_mask: {launched} launches for {len(filters)} filters ({case})")
        log(f"  sip_mask {case}: {int(got.sum())} of {n} rows kept, {launched} launch(es), ok")
    for case, key in (("one filter", "sip_mask 1 filter"),
                      ("two filters (q5's shape)", "sip_mask 2 filters")):
        mask, n, filters = _sip_inputs(rng, dev, words, case)
        fused = lambda: BF.sip_mask(mask, n, filters)  # noqa: E731
        unfused = lambda: _unfused_sip_step(mask, n, filters)  # noqa: E731
        sectors = sum(_word_sectors(f[1], f[0]) for f in filters if f[1] is not None)
        b_ms, b_by = bound(4 * n * len(filters) + 2 * mask.shape[0] + 32 * sectors,
                           12 * n * len(filters))
        out[key] = {"ms": device_ms(fused, 200, kernel="bloom_probe"),
                    "call_ms": call_ms(fused, 200),
                    "unfused_call_ms": call_ms(unfused, 200),
                    "unfused_device_ms": device_ms(unfused, 200),
                    "host_calls": host_calls(fused), "unfused_host_calls": host_calls(unfused),
                    "plain_ms": device_ms(lambda: BF.sip_mask_plain(mask, n, filters), 20),
                    "bound_ms": b_ms, "bound_by": b_by}
        log(f"  {key}, {n} rows: {json.dumps(out[key])}")
    return out


def _search_bound(keys_np, q_np, sides):
    """Each query read and its positions written once, and each 32-byte
    sector of keys that this run's searches (of ``sides``) touch read once,
    found by replaying a branchless search; ~4 operations a search step."""
    n, m = len(keys_np), len(q_np)
    below = {"left": lambda i: keys_np[i] < q_np, "right": lambda i: keys_np[i] <= q_np}
    sectors = np.unique(np.concatenate(
        [probes // 8 for side in sides for probes in _search_probes(below[side], n, m)]))
    steps = int(np.ceil(np.log2(n))) + 1
    return bound(4 * m * (1 + len(sides)) + 32 * len(sectors), 4 * m * steps * len(sides))


def _small_search_keys(rng, keys, n):
    """The first ``n`` of ``keys`` and queries on, beside, between and
    beyond them, INT32_MIN and INT32_MAX included."""
    k = keys[:n].contiguous()
    kn = k.cpu().numpy().astype(np.int64)
    lo, hi = (int(kn[0]), int(kn[-1])) if n else (0, 100)
    q = np.concatenate([kn, kn - 1, kn + 1, rng.randint(lo - 5, hi + 6, 4096),
                        [-(2 ** 31), 2 ** 31 - 1]])
    return k, torch.from_numpy(np.clip(q, -(2 ** 31), 2 ** 31 - 1).astype(np.int32)).to(k.device)


def check_sorted_search(rng, dev, keys):
    """``keys``: the full-size store's :knows subject column (sorted)."""
    from repro_torch.kernels import sorted_search as SR

    n = int(keys.shape[0])
    lo_k, hi_k = int(keys[0]), int(keys[-1])
    cases = {}
    for m in (4096, 1 << 20):
        q = np.concatenate([
            keys[torch.randint(0, n, (m // 2,), device=dev)].cpu().numpy(),  # on keys
            rng.randint(lo_k, hi_k + 1, m // 2 - 4),  # between keys
            [lo_k - 1, lo_k - 1000, hi_k + 1, hi_k + 1000],  # below and above
        ]).astype(np.int32)
        cases[f"n={n} m={m}"] = (keys, torch.from_numpy(q).to(dev))
    q = cases[f"n={n} m={1 << 20}"][1]
    q_sorted = torch.sort(q).values
    cases[f"n={n} m={1 << 20} sorted queries"] = (keys, q_sorted)
    for small in (0, 1, 4095, SR.SAMPLES - 1, SR.SAMPLES + 1):
        cases[f"n={small}"] = _small_search_keys(rng, keys, small)
    for label, (k, qs) in cases.items():
        lib = [torch.searchsorted(k, qs, right=r, out_int32=True) for r in (False, True)]
        for side, want in zip(("left", "right"), lib):
            got = SR.sorted_search(k, qs, side)
            require(torch.equal(got, SR.sorted_search_plain(k, qs, side)),
                    f"sorted_search disagrees with its plain version ({label}, {side})")
            require(torch.equal(got, want),
                    f"sorted_search disagrees with torch.searchsorted ({label}, {side})")
        lo, hi = SR.sorted_search_range(k, qs)
        plo, phi = SR.sorted_search_range_plain(k, qs)
        require(torch.equal(lo, plo) and torch.equal(hi, phi),
                f"sorted_search_range disagrees with its plain version ({label})")
        require(torch.equal(lo, lib[0]) and torch.equal(hi, lib[1]),
                f"sorted_search_range disagrees with torch.searchsorted ({label})")
        log(f"  sorted_search {label} ({qs.shape[0]} queries): left, right and both: ok")
    m = int(q.shape[0])
    keys_np = keys.cpu().numpy()
    t = timings("sorted_search", lambda: SR.sorted_search(keys, q, "left"),
                lambda: SR.sorted_search_plain(keys, q, "left"), 20,
                library_fn=lambda: torch.searchsorted(keys, q, out_int32=True))
    # the same searches with the queries sorted, and both sides in one
    # launch against two library calls
    extra = {
        "sorted_queries": (timings("sorted_search", lambda: SR.sorted_search(keys, q_sorted, "left"),
                                   lambda: SR.sorted_search_plain(keys, q_sorted, "left"), 20,
                                   library_fn=lambda: torch.searchsorted(keys, q_sorted,
                                                                         out_int32=True)),
                           _search_bound(keys_np, q_sorted.cpu().numpy(), ("left",))),
        "both_sides": (timings("sorted_search", lambda: SR.sorted_search_range(keys, q),
                               lambda: SR.sorted_search_range_plain(keys, q), 20,
                               library_fn=lambda: SR.sorted_search_range_plain(keys, q)),
                       _search_bound(keys_np, q.cpu().numpy(), ("left", "right"))),
    }
    for key, (te, (b_ms, b_by)) in extra.items():
        t[key] = {**{f: te[f] for f in ("ms", "call_ms", "plain_ms", "library_ms")},
                  "bound_ms": b_ms, "bound_by": b_by}
        log(f"  sorted_search {key} (m={m}): kernel {te['ms']:.6f} ms on the device, library "
            f"{te['library_ms']:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
    return 0, t, _search_bound(keys_np, q.cpu().numpy(), ("left",))


def _search_probes(below, n, m):
    """The key indices that the kernels' branchless lower bound reads, step
    by step, for ``m`` searches over ``n`` sorted entries; ``below(i)`` says
    for each search whether entry ``i[j]`` orders below search j's target."""
    base = np.zeros(m, np.int64)
    length = n
    while length > 1:
        half = length >> 1
        idx = base + half
        yield idx
        base = np.where(below(idx), idx, base)
        length -= half
    yield base


def _sorted_pairs(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order].astype(np.int32), lo[order].astype(np.int32)


def dense_visited(dev, hi_span, lo_span):
    """Every pair of [0, hi_span) x [0, lo_span), sorted: a visited set
    dense in the candidates' range, so a tile's window passes CHUNK."""
    vh = torch.arange(hi_span, dtype=torch.int32, device=dev).repeat_interleave(lo_span)
    vl = torch.arange(lo_span, dtype=torch.int32, device=dev).repeat(hi_span)
    return vh, vl


def _at_offset(x, off):
    """``x`` copied into a larger tensor at element offset ``off`` (a slice
    with another 16-byte alignment phase)."""
    big = torch.zeros(x.shape[0] + 8, dtype=x.dtype, device=x.device)
    big[off: off + x.shape[0]] = x
    return big[off: off + x.shape[0]]


def dedup_edge_cases(rng, dev, cand, visited):
    """frontier_dedup's edges: columns at offsets 1 and 3 of larger tensors
    (the same phase and different ones), short candidate lists, a visited
    window longer than CHUNK, windows searched rather than staged, all
    candidates equal, a first candidate of (INT32_MIN, INT32_MIN)."""
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    h, l = cand
    out = []
    for oh, ol in ((1, 1), (3, 3), (1, 3), (0, 3)):
        sl = (_at_offset(h, oh), _at_offset(l, ol))
        out += [(f"columns at offsets {oh} and {ol}, visited 480,000", sl, visited),
                (f"columns at offsets {oh} and {ol}, empty visited", sl, (none, none))]
    for n in (1, 7, 2049):
        sl = (h[:n].clone(), l[:n].clone())
        out += [(f"c={n}, visited 480,000", sl, visited),
                (f"c={n}, empty visited", sl, (none, none))]
    dh, dl = _sorted_pairs(rng.randint(0, 64, 1 << 20), rng.randint(0, 70_000, 1 << 20))
    dc = (torch.from_numpy(dh).to(dev), torch.from_numpy(dl).to(dev))
    out.append(("visited 4,000,000 dense in the candidates' range (searched)", dc,
                dense_visited(dev, 64, 62_500)))
    # tiles past the visited set's last pair have an empty window at its
    # end: the visited columns are views of longer tensors whose next word
    # is the last candidate, so a read past the set drops it
    sh, sl = _sorted_pairs(rng.randint(0, 64, 4096), rng.randint(0, 70_000, 4096))
    for label, (ch, cl), hi_span in (("2^20 candidates (searched)", (dh, dl), 64),
                                     ("2^20 candidates (staged)", (dh, dl), 32),
                                     ("4,096 candidates (searched)", (sh, sl), 64)):
        vh, vl = dense_visited(dev, hi_span, 62_500)
        require((int(ch[-1]), int(cl[-1])) > (int(vh[-1]), int(vl[-1])),
                "the last candidate lies past the visited set")
        full_h = torch.cat([vh, torch.tensor([ch[-1]], dtype=torch.int32, device=dev)])
        full_l = torch.cat([vl, torch.tensor([cl[-1]], dtype=torch.int32, device=dev)])
        v = int(vh.shape[0])
        out.append((f"{label}, tiles past the end of {v} visited, the next word a candidate",
                    (torch.from_numpy(ch).to(dev), torch.from_numpy(cl).to(dev)),
                    (full_h[:v], full_l[:v])))
    # 2,000,000 visited pairs dense in the lower half of the candidates'
    # range: staged, and its tiles' windows pass CHUNK (two chunks each)
    out.append(("visited 2,000,000 dense in half the candidates' range (staged)", dc,
                dense_visited(dev, 32, 62_500)))
    # few candidates against a dense visited set (no chunk: every window
    # searched), and candidates mostly in one corner, so that the tiles of
    # the spread-out rest have windows of many tiles (searched in-kernel)
    out.append(("4,096 candidates, visited 4,000,000 dense", (torch.from_numpy(sh).to(dev),
                torch.from_numpy(sl).to(dev)), dense_visited(dev, 64, 62_500)))
    kh = np.concatenate([np.zeros(1_000_000, np.int64), rng.randint(1, 64, 48_576)])
    kl = np.concatenate([rng.randint(0, 14_000, 1_000_000), rng.randint(0, 16_000, 48_576)])
    kh, kl = _sorted_pairs(kh, kl)
    out.append(("2^20 candidates, a corner dense, the rest spread (staged and searched)", (
        torch.from_numpy(kh).to(dev), torch.from_numpy(kl).to(dev)),
        dense_visited(dev, 64, 14_000)))
    same = torch.full((5000,), 12, dtype=torch.int32, device=dev)
    out += [("all candidates equal, visited", (same, same + 1), visited),
            ("all candidates equal, empty visited", (same, same + 1), (none, none))]
    m = torch.tensor([-(2 ** 31)] * 3 + [0, 5], dtype=torch.int32, device=dev)
    out += [("first candidate (INT32_MIN, INT32_MIN)", (m, m.clone()), (none, none)),
            ("first candidate (INT32_MIN, INT32_MIN), visited", (m, m.clone()), (m[3:], m[3:]))]
    return out


def check_frontier_dedup(rng, dev):
    from repro_torch.kernels import frontier_dedup as FD

    c, v = 1 << 20, 480_000
    # candidates with duplicates: (seed index, node) pairs from a domain
    # a little larger than the candidate count
    ch, cl = _sorted_pairs(rng.randint(0, 4096, c), rng.randint(0, 300, c))
    uniq = np.unique(ch.astype(np.int64) << 32 | cl.astype(np.int64))
    others = np.unique(rng.randint(4096, 8192, 2 * v).astype(np.int64) << 32
                       | rng.randint(0, 300, 2 * v).astype(np.int64))
    vis = np.sort(np.concatenate([rng.choice(uniq, v // 2, replace=False),
                                  rng.choice(others, v - v // 2, replace=False)]))
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x).astype(np.int32)).to(dev)  # noqa: E731
    cand = (T(ch), T(cl))
    visited = (T(vis >> 32), T(vis & 0xFFFFFFFF))
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    cases = [("visited 480,000", cand, visited), ("empty visited", cand, (none, none))]
    cases += dedup_edge_cases(rng, dev, cand, visited)
    for label, cset, vset in cases:
        got = FD.frontier_dedup(*cset, *vset)
        want = FD.frontier_dedup_plain(*cset, *vset)
        require(torch.equal(got, want), f"frontier_dedup disagrees with its plain version ({label})")
        log(f"  frontier_dedup C={cset[0].shape[0]} ({label}): {int(got.sum())} kept, ok")
    t = timings("frontier_dedup", lambda: FD.frontier_dedup(*cand, *visited),
                lambda: FD.frontier_dedup_plain(*cand, *visited), 10)
    t_empty = timings("frontier_dedup", lambda: FD.frontier_dedup(*cand, none, none),
                      lambda: FD.frontier_dedup_plain(*cand, none, none), 10)
    t["empty_visited"] = {k: t_empty[k] for k in ("ms", "call_ms", "plain_ms")}
    # the distinct phase's launches: at most 4,096 candidates, no visited set
    small = (cand[0][:4096].clone(), cand[1][:4096].clone())
    t_small = timings("frontier_dedup", lambda: FD.frontier_dedup(*small, none, none),
                      lambda: FD.frontier_dedup_plain(*small, none, none), 20)
    b_ms, b_by = bound(9 * 4096, 4 * 4096)
    t["distinct_shape"] = {**{k: t_small[k] for k in ("ms", "call_ms", "plain_ms")},
                           "bound_ms": b_ms, "bound_by": b_by}
    log(f"  frontier_dedup 4,096 candidates, empty visited: kernel {t_small['ms']:.6f} ms on "
        f"the device ({t_small['call_ms']:.5f} ms per call), bound {b_ms:.6f} ms ({b_by})")
    # each candidate's pair read and its mask byte written once, and each
    # 32-byte sector of the two visited columns that this run's searches
    # (one per first occurrence) touch read once; ~6 operations a step
    ckey = ch.astype(np.int64) << 32 | cl
    firsts = ckey[np.diff(ckey, prepend=-1) != 0]
    sectors = np.unique(np.concatenate(
        [probes // 8 for probes in _search_probes(lambda i: vis[i] < firsts, v, len(firsts))]))
    steps = int(np.ceil(np.log2(v))) + 1
    return 0, t, bound(9 * c + 2 * 32 * len(sectors), 6 * len(firsts) * steps)


def kernel_phase(dev, seed, knows_src):
    rng = np.random.RandomState(seed)
    results = {}
    for name, fn in (("join_expand", check_join_expand), ("gather_emit", check_gather_emit),
                     ("expr_eval", check_expr_eval), ("segment_scan", check_segment_scan),
                     ("radix_partition", check_radix_partition),
                     ("hash_probe", check_hash_probe)):
        results[name] = fn(rng, dev)
    results.update(check_bloom(rng, dev))
    results["sorted_search"] = check_sorted_search(rng, dev, knows_src)
    results["frontier_dedup"] = check_frontier_dedup(rng, dev)
    rows = {}
    for name, (err, t, (bound_ms, bound_by)) in results.items():
        src, repl, _ = KERNEL_INFO[name]
        # launches: set from the full phase's run of the kernel's path
        rows[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": None, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library_ms"],
            # where each time comes from: "profiler" (device time), else the
            # stand-in the log names
            **{f"{k}_source": t[f"{k}_source"] for k in ("ms", "plain_ms", "library_ms")
               if f"{k}_source" in t},
            "call_ms": t["call_ms"], "plain_call_ms": t["plain_call_ms"],
            "library_call_ms": t["library_call_ms"],
        }
        # further shapes timed beside the main one (frontier_dedup's empty
        # visited set and the distinct phase's shape, sorted_search's sorted
        # queries and both sides, segment_scan's larger inputs)
        rows[name].update({k: v for k, v in t.items() if isinstance(v, dict)})
        lib = ("" if t["library_ms"] is None else
               f", library {t['library_ms']:.6f} ms on the device "
               f"({t['library_call_ms']:.5f} ms per call)")
        log(f"  {name}: kernel {t['ms']:.6f} ms on the device ({t['call_ms']:.5f} ms per "
            f"call), plain {t['plain_ms']:.5f} ms on the device ({t['plain_call_ms']:.5f} ms "
            f"per call){lib}, bound {bound_ms:.6f} ms ({bound_by}), max |err| {err}")
    return rows


# ---------------------------------------------------------------------------
# full-size and breadth phases
# ---------------------------------------------------------------------------


def _member(sorted_keys, keys):
    """Which of ``keys`` occur in the sorted int64 array ``sorted_keys``."""
    if len(sorted_keys) == 0:
        return np.zeros(len(keys), dtype=bool)
    pos = np.minimum(np.searchsorted(sorted_keys, keys), len(sorted_keys) - 1)
    return sorted_keys[pos] == keys


def closed_form_counts(store):
    """LSQB counts straight from the generated quads (numpy only)."""
    q = store.index_array("spoc").astype(np.int64)
    d = store.dict
    n_terms = len(d)

    def edges(pred):
        e = q[q[:, 1] == d.lookup(pred)]
        return e[:, 0], e[:, 2]

    ks, ko = edges(":knows")
    interests = np.bincount(edges(":hasInterest")[0], minlength=n_terms)
    located = q[q[:, 1] == d.lookup(":isLocatedIn")]
    per_city = np.bincount(located[:, 2], minlength=n_terms).astype(np.int64)
    # q4: sum over replyOf edges (m1, m2) of the interests of m2's creators
    cs, co = edges(":hasCreator")
    creator_int = np.bincount(cs, weights=interests[co], minlength=n_terms)
    # q5: knows edges (p1, p2) and universities u of p1 where p2 studies at u
    ss, so = edges(":studyAt")  # sorted by subject (SPOC order)
    first = np.searchsorted(ss, ks)
    runs = np.searchsorted(ss, ks, side="right") - first
    edge = np.repeat(np.arange(len(ks)), runs)
    offset = np.arange(len(edge)) - np.repeat(np.cumsum(runs) - runs, runs)
    u = so[first[edge] + offset]
    q5 = int(_member(np.sort(ss * n_terms + so), ko[edge] * n_terms + u).sum())
    # q6: sum over 2-hop paths p1->p2->p3 of interests(p3), minus p1 == p3
    out_interest = np.bincount(ks, weights=interests[ko], minlength=n_terms)
    two_hop = int(round(float(out_interest[ko].sum())))
    mutual = _member(np.sort(ko * n_terms + ks), ks * n_terms + ko)
    return {
        "q1": int(interests[ko].sum()),
        "q2": int((per_city ** 2).sum() - len(located)),
        "q4": int(round(float(creator_int[edges(":replyOf")[1]].sum()))),
        "q5": q5,
        "q6": two_hop - int(interests[ks[mutual]].sum()),
        "q7": int(np.maximum(interests[ko], 1).sum()),
    }


def run_count(engine, text):
    t0 = time.perf_counter()
    res = engine.execute(text)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (row,) = res.decoded(engine.store.dict)
    (count,) = row.values()
    return int(count), wall


def run_traced(engine, text):
    """(count, wall seconds, result) of a one-count query, ending in a
    device sync."""
    res, wall = run_query(engine, text)
    (row,) = res.decoded(engine.store.dict)
    (count,) = row.values()
    return int(count), wall, res


def check_trace_ledger(label, res, delta):
    """The query's QueryTrace: its ``"cuda"`` dispatches, kernel by kernel,
    must equal the launch counters' deltas over the query, and it must
    hold no other backend. Returns the length of its kernel event log."""
    tr = res.trace
    require(tr is not None, f"{label}: no QueryTrace with telemetry on")
    led = tr.ledger.backend_counts
    got = {k: c for (k, b), c in led.items() if b == "cuda"}
    want = {k: v for k, v in delta.items() if v}
    require(got == want, f"{label}: the trace's cuda dispatches {got} != the launch "
                         f"counters' deltas {want}")
    require(sum(led.values()) == sum(got.values()),
            f"{label}: the trace holds other backends: {dict(led)}")
    return len(tr._kernels)


# the planner's statistics over each full-size store, built once and shared
# by every engine over it (building them reads every quad on the host); per
# store: the build's seconds and the engines that took them
_GRAPH_STATS: dict = {}
GRAPH_STATS_REPORT: dict = {}


def stats_for(store):
    """The planner's GraphStats over ``store``, built on first use (its
    seconds logged: the host time each later engine over the store saves)
    and shared after."""
    from repro_torch.core.stats import GraphStats

    key = id(store)
    if key not in _GRAPH_STATS:
        t0 = time.perf_counter()
        _GRAPH_STATS[key] = GraphStats(store)
        build_s = time.perf_counter() - t0
        GRAPH_STATS_REPORT[f"{store.n_quads} triples"] = {"build_s": build_s, "engines": 0}
        log(f"  the planner's statistics over {store.n_quads} triples built in {build_s:.3f} s "
            f"on the host; every engine over the store shares them")
    GRAPH_STATS_REPORT[f"{store.n_quads} triples"]["engines"] += 1
    return _GRAPH_STATS[key]


def run_query(engine, text):
    """(result, wall seconds) of one query, ending in a device sync."""
    t0 = time.perf_counter()
    res = engine.execute(text)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


# PyTorch's one-time notice when the sync debug mode first warns: not a sync
SYNC_MODE_NOTICE = "Synchronization debug mode is a prototype feature"


def count_syncs(fn, sources=None):
    """Run ``fn`` with PyTorch's CUDA sync debugging on; returns the number
    of synchronising operations it reported (their messages' first lines
    appended to ``sources`` when it is a list)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synced = [str(w.message) for w in caught if "synchroniz" in str(w.message)
              and not str(w.message).startswith(SYNC_MODE_NOTICE)]
    if sources is not None:
        sources.extend(m.splitlines()[0][:160] for m in synced)
    return len(synced)


@contextlib.contextmanager
def sip_tally():
    """Counts the scans' sip_mask calls by their number of filters (one
    call masks one batch) while the block runs: {filters: calls}."""
    from repro_torch.kernels import bloom_filter as BF

    tally, real = {}, BF.sip_mask

    def counting(mask, n_rows, filters, out=None):
        tally[len(filters)] = tally.get(len(filters), 0) + 1
        return real(mask, n_rows, filters, out)

    BF.sip_mask = counting
    try:
        yield tally
    finally:
        BF.sip_mask = real


def _config(path_cfg, spill_dir=None):
    """An EngineConfig from a (join_strategy, sip) pair, or from a dict of
    fields spilling to ``spill_dir``."""
    import repro_torch

    if isinstance(path_cfg, dict):
        return repro_torch.EngineConfig(**path_cfg, spill_dir=spill_dir)
    join_strategy, sip = path_cfg
    return repro_torch.EngineConfig(join_strategy=join_strategy, sip=sip)


# the reference planner's fault that the port's copy keeps: under a budget
# it can plan a merge join over a grace hash join, whose output has no
# order, and the merge join refuses it before anything runs
REFUSED_UNORDERED = "sorted by the join var"


def load_full_store(dev, scale, seed, report):
    """The full-size LSQB store on the card."""
    import repro_torch

    t0 = time.perf_counter()
    store, _ = repro_torch.generate_social_graph(scale=scale, seed=seed, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"  scale={scale}: {store.n_quads} triples, {store.device_bytes()} device bytes "
        f"(four index orders), generated and loaded in {load_s:.1f} s")
    report["full"] = {"scale": scale, "triples": store.n_quads,
                      "device_bytes": store.device_bytes(), "load_s": load_s, "paths": {}}
    return store


def knows_subjects(store):
    """The :knows scan's subject column, sorted (the psoc index slice)."""
    rng = store.range_for_pattern("psoc", (None, store.dict.lookup(":knows"), None, None))
    return store.index_columns("psoc")[1][rng.lo: rng.hi].contiguous()


def full_phase(dev, store, report):
    """The timed runs of both full-size paths, each query's trace ledger
    held against its launch deltas; returns the engines, each path's launch
    counts and the default path's results of KEPT_QUERIES."""
    import repro_torch
    from repro_torch import kernels as K
    from repro_torch.core.operators import base as OB
    from repro_torch.kernels import bloom_filter as BF

    t0 = time.perf_counter()
    want = report["full"]["closed_forms"] = closed_form_counts(store)
    log(f"  closed forms from the quads in {time.perf_counter() - t0:.1f} s: {want}")
    engines, path_launches, kept = {}, {}, {}
    for path, (cfg, queries) in PATHS.items():
        engine = engines[path] = repro_torch.Engine(store, _config(cfg), device=dev,
                                                    stats=stats_for(store))
        log(f"  path {path}: join_strategy={cfg[0]!r} sip={cfg[1]!r} {elapsed()}")
        rep = report["full"]["paths"][path] = {"config": list(cfg), "queries": {}}
        K.reset_launch_counts()
        for name in queries:
            before = K.launch_counts()
            wordless = BF.wordless_launches
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            counting = OB.count_launches
            with sip_tally() as masked:
                got, wall, res = run_traced(engine, repro_torch.LSQB_QUERIES[name])
            peak = torch.cuda.max_memory_allocated() - base
            after = K.launch_counts()
            counting = OB.count_launches - counting
            delta = {k: after[k] - before[k] for k in after}
            wordless = BF.wordless_launches - wordless
            events = check_trace_ledger(f"{path} {name}", res, delta)
            batches = _tree_batches(res.root)
            log(f"  {name}: count={got} closed form={want[name]} wall={wall:.3f} s "
                f"launches={delta}, bloom_probe launches with no words={wordless}, "
                f"masked batches by filter count={masked}; the trace's ledger equals the "
                f"launch deltas, {events} kernel events; the row counting made "
                f"{counting} launches over {batches} operator batches")
            if path == "default" and name in SIP_QUERIES:
                log(f"  {name}: build_launches={delta['bloom_build']}")
            require(got == want[name], f"{path} {name}: engine count {got} != closed form "
                                       f"{want[name]}")
            rep["queries"][name] = {"count": got, "wall_s": wall, "launches": delta,
                                    "peak_bytes": peak,
                                    "bloom_probe_wordless": wordless,
                                    "sip_batches_by_filters": masked,
                                    "trace_kernel_events": events,
                                    "count_launches": counting, "operator_batches": batches}
            if path == "default" and name in KEPT_QUERIES:
                kept[name] = res
            del res
            if path == "default":
                for k in ("radix_partition", "hash_probe") + (
                        ("bloom_build", "bloom_probe") if name in SIP_QUERIES else ()):
                    require(delta[k] > 0, f"default {name}: {k} was never launched")
        path_launches[path] = rep["launches"] = K.launch_counts()
        for name, (_, _, kpath) in KERNEL_INFO.items():
            if kpath == path:
                require(path_launches[path][name] > 0,
                        f"kernel {name} was never launched on the {path} path")
    return engines, path_launches, kept


def _tree_batches(root):
    """The batches every operator of a tree emitted (the row counting's
    denominator: it counts each of them, on the host or on the device)."""
    total, stack = 0, [root]
    while stack:
        op = stack.pop()
        total += op.stats.batches
        stack.extend(op.children())
    return total


def _edges(q, d, pred):
    e = q[q[:, 1] == d.lookup(pred)]
    return e[:, 0], e[:, 2]


def _csr(src, dst, n):
    """Out-neighbour lists of ``n`` nodes: (indptr, neighbours)."""
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, dst[np.argsort(src, kind="stable")]


def _neighbours(indptr, nbrs, nodes):
    """The concatenated out-neighbours of ``nodes``, and for each the
    index of its node in ``nodes``."""
    starts, lens = indptr[nodes], indptr[nodes + 1] - indptr[nodes]
    owner = np.repeat(np.arange(len(nodes)), lens)
    offs = np.arange(len(owner)) - np.repeat(np.cumsum(lens) - lens, lens)
    return nbrs[np.repeat(starts, lens) + offs], owner


def _reach(indptr, nbrs, seed, n):
    """Bool mask of the nodes reached from ``seed`` in one or more hops."""
    seen = np.zeros(n, dtype=bool)
    frontier = np.asarray([seed], dtype=np.int64)
    while len(frontier):
        nxt, _ = _neighbours(indptr, nbrs, frontier)
        nxt = np.unique(nxt[~seen[nxt]])
        seen[nxt] = True
        frontier = nxt
    return seen


def path_closed_forms(store):
    """p1-p5 straight from the generated quads (numpy only)."""
    q = store.index_array("spoc").astype(np.int64)
    d = store.dict
    n = len(d)
    ks, ko = _edges(q, d, ":knows")
    interests = np.bincount(_edges(q, d, ":hasInterest")[0], minlength=n)
    fwd, rev = _csr(ks, ko, n), _csr(ko, ks, n)
    # p3: semi-naive closure of the reply graph over int64 pair keys
    rs, ro = _edges(q, d, ":replyOf")
    reply = _csr(rs, ro, n)
    pairs = delta = np.unique(rs * n + ro)
    while len(delta):
        z, owner = _neighbours(*reply, delta % n)
        delta = np.setdiff1d(np.unique((delta // n)[owner] * n + z), pairs, assume_unique=True)
        pairs = np.union1d(pairs, delta)
    z, owner = _neighbours(*fwd, ko)
    return {
        "p1": int(_reach(*rev, d.lookup(P1_TARGET), n).sum()),
        "p2": int(interests[_reach(*fwd, d.lookup(P2_SOURCE), n)].sum()),
        "p3": len(pairs),
        "p4": len(np.unique(ks[owner] * n + z)),
        "p5": len(np.unique(np.concatenate([ks * n + ko, ko * n + ks]))),
    }


def distinct_closed_forms(store):
    """d1 (a count) and d2 ({city: distinct tags}) from the quads."""
    q = store.index_array("spoc").astype(np.int64)
    d = store.dict
    n = len(d)
    ls, lc = _edges(q, d, ":isLocatedIn")
    tags, owner = _neighbours(*_csr(*_edges(q, d, ":hasInterest"), n), ls)
    cities, counts = np.unique(np.unique(lc[owner] * n + tags) // n, return_counts=True)
    return {"d1": len(np.unique(_edges(q, d, ":knows")[1])),
            "d2": {d.decode(int(c)): int(k) for c, k in zip(cities, counts)}}


def bsbm_closed_forms(store):
    """b4 ({vendor: distinct reviewers of its offered products}) and b8
    (products with a producer and no review) from the quads."""
    q = store.index_array("spoc").astype(np.int64)
    d = store.dict
    n = len(d)
    vendor_of = np.full(n, -1, np.int64)  # one vendor per offer
    offers, vendors = _edges(q, d, ":vendor")
    vendor_of[offers] = vendors
    reviewer_of = np.full(n, -1, np.int64)  # one reviewer per review
    reviews, reviewers = _edges(q, d, ":reviewer")
    reviewer_of[reviews] = reviewers
    offer, product = _edges(q, d, ":product")
    review, reviewed = _edges(q, d, ":reviewFor")
    revs, owner = _neighbours(*_csr(reviewed, reviewer_of[review], n), product)
    vendors, counts = np.unique(np.unique(vendor_of[offer][owner] * n + revs) // n,
                                return_counts=True)
    with_producer = np.unique(_edges(q, d, ":producer")[0])
    # b6's self-join rows: ordered pairs of distinct products per feature
    per_feature = np.bincount(_edges(q, d, ":productFeature")[1], minlength=n)
    return {"b4": {d.decode(int(v)): int(k) for v, k in zip(vendors, counts)},
            "b8": len(np.setdiff1d(with_producer, reviewed)),
            "b6_rows": int((per_feature * (per_feature - 1)).sum())}


def path_counters(res):
    """The frontier counters of every PathExpand in a query's operator
    tree: rounds and dedup in/out summed, the peak frontier the largest."""
    from repro_torch.core.operators.path import PathExpand

    out = {"frontier_rounds": 0, "frontier_peak": 0, "dedup_in": 0, "dedup_out": 0}
    stack = [res.root]
    while stack:
        op = stack.pop()
        if isinstance(op, PathExpand):
            for k, v in op.engine.counters.as_dict().items():
                out[k] = max(out[k], v) if k == "frontier_peak" else out[k] + v
        stack.extend(op.children())
    return out


def _require_launches(launches, kpath):
    for name, (_, _, p) in KERNEL_INFO.items():
        if p == kpath:
            require(launches[name] > 0, f"kernel {name} was never launched on the {kpath} path")


def paths_phase(engine, store, report):
    """p1-p5 on the full-size store under ``engine`` (EngineConfig()), each
    count held against its closed form; returns the phase's launch counts.
    Each query's report keeps frontier_dedup's sizes as _distinct_run's
    do."""
    from repro_torch import kernels as K
    from repro_torch.kernels import frontier_dedup as FD

    t0 = time.perf_counter()
    want = path_closed_forms(store)
    log(f"  closed forms from the quads in {time.perf_counter() - t0:.1f} s: {want}")
    rep = report["paths"] = {"queries": {}, "closed_forms": want}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for name, text in PATH_QUERIES.items():
        before = K.launch_counts()
        FD.reset_sizes()
        res, wall = run_query(engine, text)
        after = K.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        sizes = FD.sizes()
        (row,) = res.decoded(engine.store.dict)
        got, ctr = int(row["n"]), path_counters(res)
        del res
        log(f"  {name}: count={got} closed form={want[name]} wall={wall:.3f} s {ctr} "
            f"launches={delta} frontier_dedup sizes={sizes}")
        require(got == want[name], f"paths {name}: engine count {got} != closed form {want[name]}")
        require(delta.get("frontier_dedup", 0) > 0, f"paths {name}: frontier_dedup never launched")
        if name in SEARCH_QUERIES:
            require(delta.get("sorted_search", 0) > 0, f"paths {name}: sorted_search never launched")
        rep["queries"][name] = {"count": got, "wall_s": wall, "launches": delta,
                                "frontier_dedup_sizes": sizes, **ctr}
    launches = rep["launches"] = K.launch_counts()
    _require_launches(launches, "paths")
    rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"  peak device memory over the phase: {rep['max_memory_allocated']} bytes "
        f"(torch.cuda.max_memory_allocated)")
    return launches


def _distinct_run(engine, name, text, rep):
    """Run one query of the distinct phase; returns its decoded rows. The
    report keeps its launch counts and frontier_dedup's sizes: candidates
    summed over its launches, the most in one launch, the largest visited
    set."""
    from repro_torch import kernels as K
    from repro_torch.kernels import frontier_dedup as FD

    before = K.launch_counts()
    FD.reset_sizes()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, wall = run_query(engine, text)
    peak = torch.cuda.max_memory_allocated() - base
    after = K.launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    sizes = FD.sizes()
    rows = res.decoded(engine.store.dict)
    rep["queries"][name] = {"rows": len(rows), "wall_s": wall, "launches": delta,
                            "peak_bytes": peak, "frontier_dedup_sizes": sizes}
    log(f"  {name}: {len(rows)} rows wall={wall:.3f} s launches={delta} "
        f"frontier_dedup sizes={sizes}")
    if name in DEDUP_QUERIES:
        require(delta.get("frontier_dedup", 0) > 0, f"distinct {name}: frontier_dedup never launched")
    return rows


def distinct_phase(engine, store, dev, report, forms):
    """d1 and d2 on the full-size LSQB store, then the BSBM BI mix (all but
    b6) at scale 36; d1, d2, b4 and b8 against closed forms, which go into
    ``forms`` with each BSBM query's rows (``canonical``) for the outofcore
    phase. Returns the phase's launch counts, the BSBM store and its
    metadata."""
    import repro_torch
    from repro_torch import kernels as K
    from repro_torch.data import BSBM_BI_QUERIES, generate_ecommerce_graph

    want = distinct_closed_forms(store)
    rep = report["distinct"] = {"queries": {}}
    K.reset_launch_counts()
    (row,) = _distinct_run(engine, "d1", DISTINCT_QUERIES["d1"], rep)
    require(int(row["n"]) == want["d1"], f"distinct d1: {row['n']} != closed form {want['d1']}")
    got = {r["city"]: int(r["n"]) for r in _distinct_run(engine, "d2", DISTINCT_QUERIES["d2"], rep)}
    require(got == want["d2"], "distinct d2: the per-city distinct tag counts differ from the "
                               "closed form")
    log(f"  d1 = {want['d1']}; d2: {len(got)} groups summing to {sum(got.values())}, "
        f"equal to the closed forms")
    t0 = time.perf_counter()
    bstore, meta = generate_ecommerce_graph(scale=BSBM_SCALE, seed=BSBM_SEED, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rep["bsbm"] = {"scale": BSBM_SCALE, "triples": bstore.n_quads, "products": meta["n_product"],
                   "load_s": load_s}
    log(f"  BSBM scale={BSBM_SCALE}: {bstore.n_quads} triples, {meta['n_product']} products, "
        f"generated and loaded in {load_s:.1f} s {elapsed()}")
    bwant = bsbm_closed_forms(bstore)
    rep["bsbm"]["b6_rows"] = bwant["b6_rows"]
    log(f"  b6 (breadth only) would emit {bwant['b6_rows']} self-join rows at this scale")
    forms.update(d2=want["d2"], b4=bwant["b4"], b8=bwant["b8"], bsbm_rows={})
    bengine = repro_torch.Engine(bstore, repro_torch.EngineConfig(), device=dev,
                                 stats=stats_for(bstore))
    for name in BSBM_FULL_QUERIES:
        rows = _distinct_run(bengine, name, BSBM_BI_QUERIES[name], rep)
        forms["bsbm_rows"][name] = canonical(rows)
        if name == "b4":
            got = {r["vendor"]: int(r["reviewers"]) for r in rows}
            require(got == bwant["b4"], "bsbm b4: the per-vendor reviewer counts differ from "
                                        "the closed form")
            log(f"  b4: {len(got)} vendors, equal to the closed form")
        elif name == "b8":
            require(int(rows[0]["n"]) == bwant["b8"],
                    f"bsbm b8: {rows[0]['n']} != closed form {bwant['b8']}")
            log(f"  b8: {bwant['b8']} unreviewed products, equal to the closed form")
    return K.launch_counts(), bstore, meta


def explore_queries(meta, seed):
    """EXPLORE_INSTANCES instantiations of each BSBM explore template (e1-e5)
    from ``seed``: {name: text}."""
    from repro_torch.data import BSBM_EXPLORE_TEMPLATES, instantiate_explore

    rng = np.random.RandomState(seed)
    return {f"{name}.{k}": instantiate_explore(tpl, meta, rng)
            for name, tpl in sorted(BSBM_EXPLORE_TEMPLATES.items())
            for k in range(EXPLORE_INSTANCES)}


def e3_closed_form(store, text):
    """e3's rows from the quads: the product's features times its
    producers."""
    q = store.index_array("spoc")
    d = store.dict
    mine = q[q[:, 0] == d.lookup(re.search(r":product\d+", text).group(0))]
    return int((mine[:, 1] == d.lookup(":productFeature")).sum()) * \
        int((mine[:, 1] == d.lookup(":producer")).sum())


def _pred_subjects(store, pred, k):
    """The first ``k`` subjects of ``pred``'s scan (a psoc slice) as a
    (1, k) device block."""
    rng = store.range_for_pattern("psoc", (None, store.dict.lookup(pred), None, None))
    require(rng.hi - rng.lo >= k, f"fewer than {k} {pred} triples")
    return store.index_columns("psoc")[1][rng.lo: rng.lo + k][None, :].contiguous()


def drain_cross(left, right, dev):
    """A CrossJoin over two materialized blocks, drained: (rows, batches),
    the rows summed on the device and read once at the end."""
    from repro_torch.core.operators.cross import CrossJoin
    from repro_torch.core.operators.sort import MaterializedSource

    op = CrossJoin(MaterializedSource((1,), left), MaterializedSource((2,), right), dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    batches = 0
    while (b := op.next_batch()) is not None:
        total += b.mask[: b.n_rows].sum()
        batches += 1
    return int(total), batches


def explore_phase(dev, bstore, meta, report):
    """The BSBM explore mix on the scale-36 store: e1-e5, EXPLORE_INSTANCES
    of each, e3 against its closed form; then a cross product of at least
    10^6 rows and one of twice as many, each against nl x nr, with their
    host syncs and what made them (each drained once before, uncounted),
    which must be equal. Returns the phase's launch counts."""
    import repro_torch
    from repro_torch import kernels as K

    rep = report["explore"] = {"scale": BSBM_SCALE, "queries": {}}
    engine = repro_torch.Engine(bstore, repro_torch.EngineConfig(), device=dev,
                                stats=stats_for(bstore))
    K.reset_launch_counts()
    for name, text in explore_queries(meta, SEED).items():
        before = K.launch_counts()
        res, wall = run_query(engine, text)
        n = len(res.decoded(bstore.dict))
        delta = {k: v - before[k] for k, v in K.launch_counts().items() if v - before[k]}
        rep["queries"][name] = {"rows": n, "wall_s": wall, "launches": delta}
        log(f"  {name}: {n} rows, wall={wall:.3f} s, launches={delta}")
        if name.startswith("e3"):
            want = e3_closed_form(bstore, text)
            require(n == want, f"explore {name}: {n} rows != closed form {want}")
            require(delta.get("join_expand", 0) > 0 and delta.get("gather_emit", 0) > 0,
                    f"explore {name}: the cross join launched no join_expand / gather_emit")
    left = _pred_subjects(bstore, ":producer", 1000)
    rights = {k: _pred_subjects(bstore, ":vendor", k) for k in (1000, 2000)}
    for right in rights.values():  # first-use work (allocations) left out of the counts
        drain_cross(left, right, dev)
    for k, right in rights.items():
        out, sources = {}, []
        t0 = time.perf_counter()
        syncs = count_syncs(lambda: out.update(zip(("rows", "batches"),
                                                    drain_cross(left, right, dev))), sources)
        wall = time.perf_counter() - t0
        require(out["rows"] == 1000 * k, f"cross product: {out['rows']} rows != {1000 * k}")
        rep[f"cross 1000 x {k}"] = {**out, "syncs": syncs, "wall_s": wall, "sources": sources}
        log(f"  cross product 1,000 x {k:,}: {out['rows']} rows in {out['batches']} batches, "
            f"{syncs} host syncs, {wall:.3f} s (sync debug mode on): {sources}")
    a, b = rep["cross 1000 x 1000"], rep["cross 1000 x 2000"]
    require(a["syncs"] == b["syncs"] and a["batches"] < b["batches"],
            f"cross product: host syncs depend on the batches ({a['syncs']} for "
            f"{a['batches']}, {b['syncs']} for {b['batches']})")
    return K.launch_counts()


# ---------------------------------------------------------------------------
# the serve phase: a request stream through the QueryServer
# ---------------------------------------------------------------------------


def _rows_key(rows):
    return sorted(map(tuple, rows.tolist()))


def _om_labels(text, label):
    return {m.group(1) for m in re.finditer(label + r'="([^"]*)"', text)}


def serve_stream_part(dev, store, bstore, bmeta, report, closed):
    """The request stream through two QueryServers under EngineConfig() and
    its checks: the LSQB counts against their closed forms, the explore
    rows against a bare Engine's, the plan-cache hits, the dispatches
    against the launch counts, the OpenMetrics expositions, and a served
    request's host syncs against execute_plan's. Returns the stream's
    launch counts and its requests."""
    import repro_torch
    from repro_torch import kernels as K
    from repro_torch.launch.serve import build_requests, serve_stream
    from repro_torch.serve.metrics import validate_openmetrics
    from repro_torch.serve.query_server import QueryServer

    rep = report["serve"]
    texts = {**repro_torch.LSQB_QUERIES, **PATH_QUERIES, **DISTINCT_QUERIES}
    stream = build_requests(bmeta, SERVE_REQUESTS, SEED, SERVE_LSQB_SHARE, SERVE_LSQB,
                            texts)
    n_lsqb = sum(s == "lsqb" for _, _, s in stream)
    rep.update(cycle=list(SERVE_LSQB), requests=len(stream), lsqb_requests=n_lsqb,
               warmup=SERVE_WARMUP)
    log(f"  stream: {len(stream)} requests, {n_lsqb} on the LSQB store cycling {SERVE_LSQB}, "
        f"{len(stream) - n_lsqb} BSBM explore instances, {SERVE_WARMUP} warm-up")
    servers = {"bsbm": QueryServer(bstore, repro_torch.EngineConfig(), device=dev,
                                   stats=stats_for(bstore)),
               "lsqb": QueryServer(store, repro_torch.EngineConfig(), device=dev,
                                   stats=stats_for(store))}
    K.reset_launch_counts()
    t0 = time.perf_counter()
    stats, results = serve_stream(servers, stream, warmup=SERVE_WARMUP)
    rep["stream_s"] = time.perf_counter() - t0
    launches = K.launch_counts()
    rep["stats"] = stats
    # where a request's time goes, by template (after the warm-up): the
    # trace's execute span (the drain, its last copy waiting for the card)
    # and the rest (plan-cache lookup, parse and plan on a miss, translate,
    # the server's bookkeeping)
    by_key = {}
    for (key, _, _), r in zip(stream[SERVE_WARMUP:], results[SERVE_WARMUP:]):
        _, execute = r.trace.span_bounds("execute")
        acc = by_key.setdefault(key, [0, 0.0, 0.0, 0])
        acc[0] += 1
        acc[1] += r.latency_s
        acc[2] += execute
        acc[3] += 0 if r.plan_cache_hit else 1
    rep["by_template"] = {k: {"requests": n, "mean_ms": lat / n * 1e3,
                              "execute_ms": ex / n * 1e3, "misses": m}
                          for k, (n, lat, ex, m) in sorted(by_key.items())}
    log(f"  served in {rep['stream_s']:.3f} s ({card_line()}): qps={stats['qps']:.3f} "
        f"mean={stats['mean_ms']:.3f} ms p50={stats['p50_ms']:.3f} ms "
        f"p99={stats['p99_ms']:.3f} ms plan-cache hit rate={stats['plan_cache_hit_rate']:.4f} "
        f"(after {SERVE_WARMUP} warm-up requests)")
    for k, v in rep["by_template"].items():
        log(f"    {k}: {v['requests']} requests ({v['misses']} plan-cache misses), mean "
            f"{v['mean_ms']:.3f} ms, of it the execute span {v['execute_ms']:.3f} ms")
    # every LSQB count against its closed form
    bad = []
    for (key, _, s), r in zip(stream, results):
        if s == "lsqb":
            name = key.split("_", 1)[1]
            got = int(store.dict.decode(int(r.rows[0, 0])))
            if r.n_rows != 1 or got != closed[name]:
                bad.append((key, r.n_rows, got, closed[name]))
    require(not bad, f"serve: LSQB counts differ from their closed forms "
                     f"(key, rows, count, closed form): {bad}")
    # every explore request's rows against a bare Engine's
    t0 = time.perf_counter()
    bare = repro_torch.Engine(bstore, repro_torch.EngineConfig(), device=dev,
                              stats=stats_for(bstore))
    want, bad = {}, []
    for (key, text, s), r in zip(stream, results):
        if s == "bsbm":
            if text not in want:
                want[text] = _rows_key(bare.execute(text).rows)
            if _rows_key(r.rows) != want[text]:
                bad.append((key, r.n_rows, len(want[text])))
    require(not bad, f"serve: explore rows differ from a bare Engine's (key, served rows, "
                     f"bare rows): {bad}")
    rep["bare_reruns_s"] = time.perf_counter() - t0
    log(f"  {n_lsqb} LSQB counts equal their closed forms; "
        f"{len(stream) - n_lsqb} explore results ({len(want)} distinct texts) equal a bare "
        f"Engine's rows {elapsed()}")
    # plan-cache hits = requests - distinct texts
    hits = sum(srv.metrics.plan_cache_hits for srv in servers.values())
    distinct = len({text for _, text, _ in stream})
    require(hits == len(stream) - distinct,
            f"serve: {hits} plan-cache hits != {len(stream)} requests - {distinct} "
            f"distinct texts")
    # the registries' dispatches = the requests' = the launch counts
    reg, per_req = {}, {}
    for srv in servers.values():
        for k, v in srv.metrics.kernels.counts.items():
            reg[k] = reg.get(k, 0) + v
    for r in results:
        for k, v in r.trace.ledger.counts.items():
            per_req[k] = per_req.get(k, 0) + v
    nonzero = {k: v for k, v in launches.items() if v}
    backends = {b for srv in servers.values() for _, b in srv.metrics.kernels.backend_counts}
    require(reg == per_req == nonzero and backends <= {"cuda"},
            f"serve: the registries' dispatches {reg}, the requests' {per_req} and the "
            f"launch counts {nonzero} differ, or a backend other than cuda ({backends})")
    require(sum(reg.values()) == sum(r.kernel_dispatches for r in results),
            "serve: the requests' kernel_dispatches do not sum to the registries'")
    rep["dispatches"] = reg
    log(f"  {hits} plan-cache hits = {len(stream)} - {distinct} distinct texts; "
        f"dispatches per kernel = launch counts = the requests' ledgers: {reg}")
    # the OpenMetrics expositions
    for name, srv in servers.items():
        om = srv.openmetrics()
        fams = validate_openmetrics(om)
        kernels = srv.metrics_snapshot()["kernels"]["by_backend"]
        require("barq_fingerprint_requests" in fams,
                f"serve: {name}'s exposition has no barq_fingerprint_requests: {fams}")
        require(_om_labels(om, "backend") == {"cuda"}
                and all(k.endswith("/cuda") for k in kernels),
                f"serve: {name}'s kernel series are not all /cuda: "
                f"{_om_labels(om, 'backend')}, {sorted(kernels)}")
        rep[f"openmetrics_{name}"] = {"families": len(fams), "bytes": len(om),
                                      "kernel_series": sorted(kernels)}
    log(f"  both expositions validate, with barq_fingerprint_requests and kernel series "
        f"{sorted(set(rep['openmetrics_lsqb']['kernel_series']) | set(rep['openmetrics_bsbm']['kernel_series']))}")
    # a served LSQB request makes the host syncs of the same plan
    # through Engine.execute_plan (both warm: the plan is cached)
    srv = servers["lsqb"]
    text = texts[SERVE_FEEDBACK_QUERY]
    phys, vt, _ = srv._plan_for(text)
    served = count_syncs(lambda: srv.execute("sync", text))
    plain = count_syncs(lambda: srv.engine.execute_plan(phys, vt))
    require(served == plain, f"serve: a served {SERVE_FEEDBACK_QUERY} made {served} host "
                             f"syncs, the same plan through execute_plan {plain}")
    rep["syncs"] = {"served": served, "execute_plan": plain}
    log(f"  {SERVE_FEEDBACK_QUERY} served {served} host syncs, through "
        f"Engine.execute_plan {plain}")
    return launches, stream


def serve_feedback_part(dev, store, report, closed):
    """q4 twice through a QueryServer under cardinality_feedback="apply"
    with a flight recorder: both counts the closed form, the second plan
    from feedback, the first run's bundle when its q-error fires."""
    import repro_torch
    from repro_torch.core import planner as PL
    from repro_torch.serve.flight_recorder import FlightRecorder
    from repro_torch.serve.query_server import QueryServer

    name = SERVE_FEEDBACK_QUERY
    text = repro_torch.LSQB_QUERIES[name]
    rep = report["serve"]["feedback"] = {"query": name}
    with tempfile.TemporaryDirectory() as tmp:
        fr = FlightRecorder(out_dir=tmp, q_error_threshold=SERVE_QERROR)
        srv = QueryServer(store, repro_torch.EngineConfig(cardinality_feedback="apply"),
                          flight=fr, device=dev, stats=stats_for(store))
        r1 = srv.execute(name, text)
        r2 = srv.execute(name, text)
        counts = [int(store.dict.decode(int(r.rows[0, 0]))) for r in (r1, r2)]
        require(counts == [closed[name]] * 2,
                f"serve feedback: {name} counted {counts}, closed form {closed[name]}")
        require(len(srv._plan_cache) == 2, "serve feedback: the second run was not re-planned")
        phys2, vt2, _ = list(srv._plan_cache.values())[-1]
        plan2 = PL.explain(phys2, vt2)
        require("(source=feedback)" in plan2,
                f"serve feedback: the second plan shows no (source=feedback):\n{plan2}")
        rep.update(counts=counts, max_q_error=[r1.max_q_error, r2.max_q_error],
                   latency_s=[r1.latency_s, r2.latency_s], bundle=r1.flight_bundle is not None)
        if r1.max_q_error >= SERVE_QERROR:
            b = r1.flight_bundle
            require(b is not None, f"serve feedback: q-error {r1.max_q_error} captured no bundle")
            trace = json.loads(Path(b, "trace.json").read_text())
            meta = json.loads(Path(b, "meta.json").read_text())
            explain = Path(b, "explain.txt").read_text()
            require("est:" in explain and meta["reasons"] and trace.get("traceEvents"),
                    f"serve feedback: the bundle is incomplete: "
                    f"{sorted(p.name for p in Path(b).iterdir())}")
            rep["bundle_trace_bytes"] = Path(b, "trace.json").stat().st_size
    log(f"  feedback: {name} counted {counts} (closed form {closed[name]}), max q-error "
        f"{r1.max_q_error} then {r2.max_q_error}, walls {r1.latency_s:.3f} / "
        f"{r2.latency_s:.3f} s; the second plan shows (source=feedback); first run's bundle: "
        f"{rep.get('bundle_trace_bytes', 'none (q-error under the threshold)')} trace bytes")


def verify_part(dev, store, bstore, texts, report):
    """Every query the script runs planned (not executed) under
    verify_plans=True in three configurations: each plan verifies clean,
    or the verifier flags one the engine refuses today too."""
    import repro_torch
    from repro_torch.analysis.plan_verify import PlanInvariantError
    from repro_torch.core.executor import Translator

    rep = report["serve"]["verify"] = {}
    for cname, cfg in VERIFY_CONFIGS.items():
        with tempfile.TemporaryDirectory() as tmp:
            c = _config(cfg, spill_dir=tmp if isinstance(cfg, dict) else None)
            c.verify_plans = True
            clean, refused = 0, {}
            t0 = time.perf_counter()
            for sname, st, queries in (("lsqb", store, texts["lsqb"]),
                                       ("bsbm", bstore, texts["bsbm"])):
                eng = repro_torch.Engine(st, c, device=dev, stats=stats_for(st))
                for qname, text in queries.items():
                    node, _ = eng.parse(text)
                    try:
                        eng.plan(node)
                        clean += 1
                    except PlanInvariantError as e:
                        phys = eng.planner.plan(node)
                        try:
                            Translator(st, eng.cfg, dev).translate(phys)
                            taken = None
                        except ValueError as t:
                            taken = str(t)
                        require(taken is not None and REFUSED_UNORDERED in taken,
                                f"verify {cname} {qname}: the verifier flags a plan the engine "
                                f"runs: {e}")
                        refused[qname] = str(e).splitlines()[0][:160]
            rep[cname] = {"clean": clean, "refused": refused,
                          "seconds": time.perf_counter() - t0}
        log(f"  verify_plans {cname}: {clean} plans verify clean, refused alike by the "
            f"verifier and the translator: {refused or 'none'} "
            f"({rep[cname]['seconds']:.2f} s)")


def sanitize_part(dev, store, lsqb_engine, report, closed):
    """q4 on a sanitizing engine against its closed form, no leak and
    conserved counters, its wall beside an unsanitized run; then a small
    card batch poisoned at release and refused after it."""
    import repro_torch
    from repro_torch.analysis.sanitize import POISON, PoolSanitizer, SanitizeError, SanitizingBatchPool
    from repro_torch.core import batch as PB
    from repro_torch.core.batch import ColumnBatch

    name = SANITIZE_QUERY
    text = repro_torch.LSQB_QUERIES[name]
    rep = report["serve"]["sanitize"] = {"query": name}
    eng = repro_torch.Engine(store, repro_torch.EngineConfig(sanitize=True), device=dev,
                             stats=stats_for(store))
    try:
        res, wall = run_query(eng, text)
        got = int(store.dict.decode(int(res.rows[0, 0])))
        require(got == closed[name], f"sanitize {name}: {got} != closed form {closed[name]}")
        del res
        leaks, c = eng.pool.leaks(), eng.pool.counters()
        require(not leaks and c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"],
                f"sanitize {name}: leaks {eng.pool.sanitizer.leak_report(eng.pool)[:5]}, "
                f"counters {c}")
        _, plain_wall = run_query(lsqb_engine, text)
        rep.update(count=got, wall_s=wall, unsanitized_wall_s=plain_wall, counters=c,
                   pool=eng.pool.stats())
        log(f"  sanitize: {name} counted {got} (closed form), no leak, counters {c}; wall "
            f"{wall:.3f} s sanitized, {plain_wall:.3f} s not")
        pool = SanitizingBatchPool(dev, sanitizer=PoolSanitizer())
        pool.sanitizer.push_op("ServeSmokeBatch")
        b = ColumnBatch.from_columns((0, 1), [torch.arange(1000, dtype=torch.int32, device=dev)] * 2,
                                     dev, pool=pool)
        pool.sanitizer.pop_op()
        cols, mask = b.columns, b.mask
        syncs = count_syncs(b.release)
        poisoned = bool((cols[:, :1000] == int(POISON)).all()) and bool(mask[:1000].all())
        require(poisoned and syncs == 0,
                f"sanitize: the released batch is not POISON throughout ({poisoned}) or its "
                f"release made {syncs} host syncs")
        try:
            b.column(0)
            msg = None
        except SanitizeError as e:
            msg = str(e)
        require(msg is not None and "ServeSmokeBatch" in msg,
                f"sanitize: touching a released batch raised {msg!r}")
        rep["released_batch"] = {"poisoned": poisoned, "release_syncs": syncs, "error": msg}
        log(f"  sanitize: a released card batch of 1,000 rows reads POISON throughout ({syncs} "
            f"host syncs in its release); touching it raises: {msg}")
    finally:
        # the later phases run plain pools: take the hook out again
        PB._SANITIZER = None


def serve_phase(dev, store, bstore, bmeta, report):
    """The serve phase (SERVE_BUDGET_S): the request stream, the feedback
    loop, verify_plans and sanitize; returns the stream's launch counts."""
    import repro_torch
    from repro_torch.data import BSBM_BI_QUERIES

    t0 = time.perf_counter()
    report["serve"] = {"budget_s": SERVE_BUDGET_S}
    closed = {**report["full"]["closed_forms"], **report["paths"]["closed_forms"]}
    log(f"  the request stream: {elapsed()}")
    launches, stream = serve_stream_part(dev, store, bstore, bmeta, report, closed)
    log(f"  the feedback loop: {elapsed()}")
    serve_feedback_part(dev, store, report, closed)
    log(f"  verify_plans: {elapsed()}")
    stream_texts = {f"stream {i}": t for i, t in enumerate(
        dict.fromkeys(t for _, t, s in stream if s == "bsbm"))}
    texts = {"lsqb": {**repro_torch.LSQB_QUERIES, **PATH_QUERIES, **DISTINCT_QUERIES},
             "bsbm": {**BSBM_BI_QUERIES, **explore_queries(bmeta, SEED), **stream_texts}}
    verify_part(dev, store, bstore, texts, report)
    log(f"  sanitize: {elapsed()}")
    lsqb_engine = repro_torch.Engine(store, repro_torch.EngineConfig(), device=dev,
                                     stats=stats_for(store))
    sanitize_part(dev, store, lsqb_engine, report, closed)
    phase_s = report["serve"]["phase_s"] = time.perf_counter() - t0
    log(f"  serve phase: {phase_s:.2f} s of its {SERVE_BUDGET_S:.0f} s budget "
        f"({'met' if phase_s <= SERVE_BUDGET_S else 'NOT met'}) {elapsed()}")
    return launches


# ---------------------------------------------------------------------------
# the legacy phase: the row engine and the mixed engine
# ---------------------------------------------------------------------------


def _count(res, store):
    (row,) = res.decoded(store.dict)
    (count,) = row.values()
    return int(count)


class _KernelDelta:
    """Kernel launches summed over the runs made through ``run``."""

    def __init__(self):
        self.launches = {name: 0 for name in KERNEL_INFO}

    def run(self, engine, text):
        from repro_torch import kernels as K

        before = K.launch_counts()
        res, wall = run_query(engine, text)
        for k, v in K.launch_counts().items():
            self.launches[k] += v - before[k]
        return res, wall


def _copy_syncs(fn):
    """Host syncs made inside BatchToRow's copies while ``fn`` runs: one
    count a copy."""
    from repro_torch.core.operators import adapters

    real, counts = adapters.host_rows, []

    def counted(b):
        out = {}
        counts.append(count_syncs(lambda: out.setdefault("rows", real(b))))
        return out["rows"]

    adapters.host_rows = counted
    try:
        fn()
    finally:
        adapters.host_rows = real
    return counts


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def rows_close(got, want, rel=1e-12):
    """Two answers (``canonical`` rows) equal, but for numbers within
    ``rel`` of each other: the batch engine's segment_scan adds a group's
    values in its fixed tree order, the row engine in row order, so a SUM
    or AVG over values float32 cannot hold may differ in its last bits.
    Returns (equal, the largest relative difference of two numbers)."""
    def key(r):
        return repr([f"{float(v):.9g}" if _number(v) else v for v in r])

    if len(got) != len(want):
        return False, None
    worst = 0.0
    for a, b in zip(sorted(got, key=key), sorted(want, key=key)):
        if len(a) != len(b):
            return False, None
        for x, y in zip(a, b):
            if _number(x) and _number(y):
                diff = abs(x - y) / max(abs(x), abs(y), 1e-300) if x != y else 0.0
                worst = max(worst, diff)
                if diff > rel:
                    return False, diff
            elif x != y:
                return False, None
    return True, worst


def legacy_full(dev, store, report, mixed_runs):
    """Full size: the mixed engine's q4 and q5 and the row engine's q4
    against their closed forms, BatchToRow's crossings and host syncs, and
    RowToBatch's upload (no host sync) checked against the host index."""
    import repro_torch
    from repro_torch.core.algebra import K as Kst
    from repro_torch.core.algebra import TriplePattern, V
    from repro_torch.core.legacy.operators import RowScan
    from repro_torch.core.operators.adapters import RowToBatch

    forms = report["full"]["closed_forms"]
    rep = report["legacy"]["full"] = {}
    mixed = repro_torch.Engine(store, repro_torch.EngineConfig(engine="mixed"), device=dev,
                               stats=stats_for(store))
    for name in LEGACY_FULL_MIXED:
        text = repro_torch.LSQB_QUERIES[name]
        res, wall = mixed_runs.run(mixed, text)
        got, crossed = _count(res, store), tree_extra(res.root)["host_copies"]
        require(got == forms[name], f"legacy: mixed {name} count {got} != closed form "
                                    f"{forms[name]}")
        syncs = count_syncs(lambda: run_query(mixed, text))
        copies = _copy_syncs(lambda: run_query(mixed, text))
        require(len(copies) == crossed and crossed > 0,
                f"legacy: mixed {name} made {len(copies)} copies for {crossed} crossings")
        require(max(copies) <= 1, f"legacy: a BatchToRow copy made {max(copies)} host syncs")
        rep[f"mixed {name}"] = {"count": got, "wall_s": wall, "crossed_batches": crossed,
                                "syncs": syncs, "copy_syncs": sum(copies)}
        log(f"  mixed {name}: count={got} (closed form) wall={wall:.3f} s, {crossed} batches "
            f"crossed to the host, {syncs} host syncs (a second run), {sum(copies)} of them "
            f"in the {len(copies)} BatchToRow copies (a third run)")
    legacy = repro_torch.Engine(store, repro_torch.EngineConfig(engine="legacy"), device=dev,
                                stats=stats_for(store))
    for name in LEGACY_FULL_ROW:
        res, wall = run_query(legacy, repro_torch.LSQB_QUERIES[name])
        got = _count(res, store)
        require(got == forms[name], f"legacy: legacy {name} count {got} != closed form "
                                    f"{forms[name]}")
        scanned = tree_extra(res.root)["rows_scanned"]
        rep[f"legacy {name}"] = {"count": got, "wall_s": wall, "rows_scanned": scanned}
        log(f"  legacy {name}: count={got} (closed form) wall={wall:.3f} s (host index "
            f"arrays built on first use included), {scanned} rows scanned")
    # RowToBatch: the :knows rows uploaded from pinned buffers, no host wait
    pat = TriplePattern(V(0), Kst(":knows"), V(1))
    up = RowToBatch(RowScan(store, pat, 0), dev, 4096, pool=mixed.pool)
    up.next_batch().release()  # first use (the pinned allocator) left out
    got = []

    def drain():
        for _ in range(LEGACY_UPLOAD_BATCHES):
            b = up.next_batch()
            got.append(b.columns[:, : b.n_rows].clone())
            b.release()

    t0 = time.perf_counter()
    syncs = count_syncs(drain)
    wall = time.perf_counter() - t0
    rows = torch.cat(got, dim=1).cpu().numpy()
    scan = RowScan(store, pat, 0)
    host = store.index_array(scan.index)[scan.range.lo:][4096: 4096 + rows.shape[1]]
    want = host[:, [scan.var_col_pos[0], scan.var_col_pos[1]]].T
    require(np.array_equal(rows, want), "legacy: RowToBatch's uploads differ from the index")
    require(syncs == 0, f"legacy: RowToBatch's uploads made {syncs} host syncs")
    rep["row_to_batch"] = {"batches": LEGACY_UPLOAD_BATCHES, "rows": rows.shape[1],
                           "syncs": syncs, "wall_s": wall}
    log(f"  RowToBatch: {LEGACY_UPLOAD_BATCHES} batches ({rows.shape[1]} :knows rows) "
        f"uploaded in {wall:.3f} s with {syncs} host syncs, rows equal to the index")


def _timed_filter_rows(store):
    """Microseconds a row of LSQB q2's FILTER (``?p1 != ?p2``) through the
    tree walk on a one-row CPU batch, the row engine's way."""
    from repro_torch.core import algebra as A
    from repro_torch.core.legacy.operators import row_holds

    expr = A.Cmp("!=", A.VarRef(0), A.VarRef(1))
    rng = np.random.RandomState(SEED)
    rows = [{0: int(a), 1: int(b)} for a, b in rng.randint(0, len(store.dict), (512, 2))]
    t0 = time.perf_counter()
    for i in range(LEGACY_FILTER_ROWS):
        row_holds(expr, rows[i % 512], (0, 1), store.dict)
    return (time.perf_counter() - t0) / LEGACY_FILTER_ROWS * 1e6


def legacy_breadth(dev, report, mixed_runs):
    """Breadth: the LSQB, path, distinct, BSBM BI, explore and fault-probe
    queries under the row engine and the mixed engine, each row-equal to
    the batch engine's on the card; the paper's Fig. 6a (LSQB, batch engine
    on the card against the row engine on the host)."""
    import repro_torch
    from repro_torch.data import BSBM_BI_QUERIES, generate_ecommerce_graph

    lsqb, _ = repro_torch.generate_social_graph(scale=BREADTH_SCALE, seed=SEED, device=dev)
    small, _ = repro_torch.generate_social_graph(scale=LEGACY_SMALL_LSQB_SCALE, seed=SEED,
                                                 device=dev)
    bsbm, bmeta = generate_ecommerce_graph(scale=BSBM_BREADTH_SCALE, seed=BSBM_SEED, device=dev)
    bsmall, _ = generate_ecommerce_graph(scale=LEGACY_SMALL_BSBM_SCALE, seed=BSBM_SEED,
                                         device=dev)
    pstore = probe_store(dev, SEED)
    small_names = set(LEGACY_SMALL_LSQB + LEGACY_SMALL_BSBM)
    everything = {**repro_torch.LSQB_QUERIES, **PATH_QUERIES, **DISTINCT_QUERIES,
                  **BSBM_BI_QUERIES, **explore_queries(bmeta, SEED)}
    lsqb_q = {**repro_torch.LSQB_QUERIES, **PATH_QUERIES, **DISTINCT_QUERIES}
    bsbm_q = {**BSBM_BI_QUERIES, **explore_queries(bmeta, SEED)}
    work = [("lsqb", lsqb, {k: v for k, v in lsqb_q.items() if k not in small_names}),
            ("lsqb-small", small, {k: everything[k] for k in LEGACY_SMALL_LSQB}),
            ("bsbm", bsbm, {k: v for k, v in bsbm_q.items() if k not in small_names}),
            ("bsbm-small", bsmall, {k: everything[k] for k in LEGACY_SMALL_BSBM}),
            ("probes", pstore, PROBE_QUERIES)]
    log(f"  LSQB scale {BREADTH_SCALE}: {lsqb.n_quads} triples, {LEGACY_SMALL_LSQB_SCALE}: "
        f"{small.n_quads}; BSBM scale {BSBM_BREADTH_SCALE}: {bsbm.n_quads}, "
        f"{LEGACY_SMALL_BSBM_SCALE}: {bsmall.n_quads}; fault probes: {pstore.n_quads}")
    rep = report["legacy"]["breadth"] = {}
    for label, st, queries in work:
        engines = {eng: repro_torch.Engine(st, repro_torch.EngineConfig(engine=eng), device=dev)
                   for eng in ("barq", "legacy", "mixed")}
        for name, text in queries.items():
            res, bwall = run_query(engines["barq"], text)
            want = canonical(res.decoded(st.dict))
            walls, worst = {"barq": bwall}, 0.0
            for eng in ("legacy", "mixed"):
                res, walls[eng] = (mixed_runs.run if eng == "mixed" else run_query)(
                    engines[eng], text)
                same, diff = rows_close(canonical(res.decoded(st.dict)), want)
                require(same, f"legacy: {eng} {name} ({label}) rows differ from barq's on the "
                              f"card (largest relative difference {diff})")
                worst = max(worst, diff)
                if eng == "legacy" and (label, name) == ("lsqb", "q2"):
                    q2_tested = tree_extra(res.root)["rows_tested"]
            rep[name] = {"store": label, "result": _short(want), "max_rel_diff": worst,
                         **{f"{k}_s": v for k, v in walls.items()}}
            log(f"  {label} {name}: {_short(want)}; barq {walls['barq']:.3f} s (card), legacy "
                f"{walls['legacy']:.3f} s, mixed {walls['mixed']:.3f} s, rows equal"
                + (f" (numbers within {worst:.1e})" if worst else ""))
    # the paper's Fig. 6a on this card: LSQB, barq (card) against legacy (host rows)
    card = card_line()
    names = sorted(repro_torch.LSQB_QUERIES)
    fig = {n: (rep[n]["barq_s"], rep[n]["legacy_s"]) for n in names}
    ratio = sum(v[1] for v in fig.values()) / sum(v[0] for v in fig.values())
    report["legacy"]["fig6a"] = {"card": card, "queries": fig, "ratio_of_sums": ratio}
    log(f"  Fig. 6a (LSQB scale {BREADTH_SCALE}, {', '.join(LEGACY_SMALL_LSQB)} at "
        f"{LEGACY_SMALL_LSQB_SCALE}) on {card}:")
    for n, (b, l) in fig.items():
        log(f"    {n}: barq {b:.4f} s (card), legacy {l:.4f} s (host rows), {l / b:.1f}x")
    log(f"    legacy / barq, ratio of the sums: {ratio:.2f}")
    wall, tested = rep["q2"]["legacy_s"], q2_tested
    per_row = _timed_filter_rows(lsqb)
    report["legacy"]["q2_rows"] = {"wall_s": wall, "filter_rows": tested,
                                   "us_per_filtered_row": wall / tested * 1e6,
                                   "filter_us_per_row": per_row}
    log(f"  legacy q2 (CPU: the card's host): {wall:.3f} s for {tested} rows into its FILTER, "
        f"{wall / tested * 1e6:.2f} us a row in all; the FILTER alone (tree walk on a one-row "
        f"CPU batch) {per_row:.2f} us a row over {LEGACY_FILTER_ROWS} rows")
    return small


def legacy_nodes(dev, small, report):
    """The two formerly raising nodes on the card: a hand-built PPathScan
    (the row `+` behind RowToBatch) row-equal to PathExpand's, and FILTERs
    through the tree walk: an unknown function refused alike by every
    engine, and a FILTER marked uncompilable (``program=False``) through the
    batch FilterOp, row-equal to the VM's and to the row engine's."""
    import repro_torch
    from repro_torch.core import algebra as A
    from repro_torch.core import planner as PL

    engines = {eng: repro_torch.Engine(small, repro_torch.EngineConfig(engine=eng), device=dev)
               for eng in ("barq", "legacy", "mixed")}
    pat = A.TriplePattern(A.V(0), A.K(":knows"), A.V(1), A.K(":default"))
    res = engines["barq"].execute_plan(PL.PPathScan(pat))
    got = sorted(map(tuple, res.rows.tolist()))
    want = sorted(map(tuple, engines["barq"].execute("SELECT ?x ?y { ?x :knows+ ?y }")
                      .rows.tolist()))
    require(got == want and len(got) > 0, "legacy: PPathScan's rows differ from PathExpand's")
    rep = report["legacy"]["nodes"] = {"ppathscan_rows": len(got)}
    log(f"  PPathScan (RowTransitivePath behind RowToBatch, card): {len(got)} rows, equal to "
        f"PathExpand's")
    scan = PL.PScan(pat, None)
    refused = set()
    for eng, engine in engines.items():
        try:
            engine.execute_plan(PL.PFilter(A.Func("strlen", (A.VarRef(1),)), scan))
            refused.add("ran")
        except ValueError as e:
            refused.add(str(e))
    require(refused == {"unknown term predicate 'strlen'"},
            f"legacy: strlen was not refused alike: {refused}")
    text = f"SELECT ?a ?b {{ ?a :knows ?b . {WALK_FILTER} }}"
    plan = engines["barq"].plan(engines["barq"].parse(text)[0])
    stack, marked = [plan], 0
    while stack:
        n = stack.pop()
        if isinstance(n, PL.PFilter):
            n.program, marked = False, marked + 1
        stack.extend(getattr(n, f) for f in ("child", "left", "right", "probe", "build")
                     if isinstance(getattr(n, f, None), PL.PhysNode))
    require(marked > 0, "legacy: the walk plan has no FILTER")
    walk = sorted(map(tuple, engines["barq"].execute_plan(plan).rows.tolist()))
    for eng in ("barq", "legacy"):
        rows = sorted(map(tuple, engines[eng].execute(text).rows.tolist()))
        require(rows == walk and len(walk) > 0,
                f"legacy: the tree walk's FILTER rows differ from {eng}'s")
    rep["walk_filter_rows"] = len(walk)
    log(f"  strlen refused alike by barq, legacy and mixed on the card; the tree walk's "
        f"FILTER on the card ({WALK_FILTER}): {len(walk)} rows, equal to the VM's and the row "
        f"engine's")


def legacy_phase(dev, store, report):
    """The row engine and the mixed engine at full size and at breadth
    scale; returns the mixed runs' kernel launches."""
    t0 = time.perf_counter()
    report["legacy"] = {"small_lsqb": list(LEGACY_SMALL_LSQB),
                        "small_bsbm": list(LEGACY_SMALL_BSBM)}
    mixed_runs = _KernelDelta()
    legacy_full(dev, store, report, mixed_runs)
    log(f"  breadth {elapsed()}")
    small = legacy_breadth(dev, report, mixed_runs)
    legacy_nodes(dev, small, report)
    report["legacy"]["phase_s"] = time.perf_counter() - t0
    report["legacy"]["launches"] = mixed_runs.launches
    log(f"  legacy phase: {report['legacy']['phase_s']:.1f} s; the mixed runs' launches: "
        f"{ {k: v for k, v in mixed_runs.launches.items() if v} }")
    return mixed_runs.launches


# ---------------------------------------------------------------------------
# the outofcore phase: budgets, spills, grace joins, partitioned grouping,
# the merge join's spilling window and the adaptive merge join
# ---------------------------------------------------------------------------


def tree_extra(root):
    """The operators' ``stats.extra`` counters of a tree and their
    ``stats.rows_scanned``: spill bytes and files, re-partitions, switches,
    host copies, rows scanned summed, the widest fan-out kept."""
    out, stack = {}, [root]
    while stack:
        op = stack.pop()
        items = dict(op.stats.extra)
        if op.stats.rows_scanned:
            items["rows_scanned"] = op.stats.rows_scanned
        for k, v in items.items():
            out[k] = max(out.get(k, 0), v) if k == "grace_partitions" else out.get(k, 0) + v
        stack.extend(op.children())
    return out


def _find_op(root, cls):
    stack = [root]
    while stack:
        op = stack.pop()
        if isinstance(op, cls):
            return op
        stack.extend(op.children())
    return None


def _source(cols, vars_, dev, sorted_var=None, pool=None):
    from repro_torch.core.operators.sort import MaterializedSource

    t = torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(dev)
    return MaterializedSource(vars_, t, sorted_var, 4096, pool=pool)


def drain_rows(op):
    """An operator's rows, drained on the device and read once, in
    lexicographic order: an (n_vars, n) host array."""
    blocks = []
    while (b := op.next_batch()) is not None:
        c = b.compact()
        blocks.append(c.columns[:, : c.n_rows].clone())
        c.release()
    if not blocks:
        return np.zeros((len(op.var_ids()), 0), np.int32)
    rows = torch.cat(blocks, dim=1).cpu().numpy()
    return rows[:, np.lexsort(rows[::-1])]


def _spill_files(d):
    return sorted(Path(d).rglob("*.npy"))


class LaunchTally:
    """Sums the kernels' launches over the blocks it counts (the runs of
    the out-of-core path), and not over the unconstrained runs beside
    them."""

    def __init__(self):
        self.counts = {k: 0 for k in KERNEL_INFO}

    @contextlib.contextmanager
    def count(self):
        from repro_torch import kernels as K

        before = K.launch_counts()
        delta = {}
        try:
            yield delta
        finally:
            after = K.launch_counts()
            delta.update({k: after[k] - before[k] for k in after if after[k] != before[k]})
            for k, v in delta.items():
                self.counts[k] += v


def spill_stress(dev, tmp, rep, tally):
    """benchmarks/spill_stress.py's scenarios on the card, at its sizes: a
    200,000 x 200,000 unsorted grace join under a tenth of the build's
    bytes in four modes, the 80%-skewed semi join that must re-partition,
    and the run-time switch of a build the plan sized as resident."""
    from repro_torch.core.batch import BatchPool
    from repro_torch.core.operators.base import close_tree
    from repro_torch.core.operators.hash_join import HashJoin

    def join(l, r, mode, budget=None, grace=None):
        pool = BatchPool(dev)
        return HashJoin(_source(l, (0, 1), dev, pool=pool), _source(r, (0, 2), dev, pool=pool),
                        (0,), dev, mode, pool=pool, memory_budget=budget,
                        spill_dir=tmp if budget else None, grace=grace)

    def scenario(label, l, r, mode, budget, grace):
        want = drain_rows(join(l, r, mode))
        j = join(l, r, mode, budget, grace)
        t0 = time.perf_counter()
        with tally.count() as launches:
            got = drain_rows(j)
        wall = time.perf_counter() - t0
        extra = dict(j.stats.extra)
        close_tree(j)
        left = _spill_files(tmp)
        log(f"  {label}: {got.shape[1]} rows in {wall:.3f} s, {extra}, launches={launches}")
        require(np.array_equal(got, want), f"outofcore {label}: rows differ from the "
                                           "unconstrained HashJoin's")
        require(not left, f"outofcore {label}: spill files left after close: {left}")
        rep[label] = {"rows": int(got.shape[1]), "wall_s": wall, "extra": extra,
                      "launches": launches, "budget": budget}
        return extra

    rng = np.random.RandomState(0)
    n = 200_000
    l = np.stack([rng.permutation(n) % (n // 2), rng.randint(0, 1000, n)]).astype(np.int32)
    r = np.stack([rng.permutation(n) % (n // 2), rng.randint(0, 1000, n)]).astype(np.int32)
    for mode in ("inner", "left_outer", "semi", "anti"):
        extra = scenario(f"grace join {mode}", l, r, mode, r.nbytes // 10, True)
        require(extra.get("spill_files", 0) > 0 and extra.get("spill_bytes", 0) > 0,
                f"outofcore grace join {mode}: nothing spilled ({extra})")
    extra = scenario("runtime switch", l, r, "inner", r.nbytes // 4, None)
    require(extra.get("adaptive_switches") == 1, f"outofcore runtime switch: {extra}")
    rng = np.random.RandomState(8)
    n = 120_000
    lk = np.where(rng.rand(n) < 0.8, 7, rng.randint(0, 2000, n))
    rk = np.where(rng.rand(n) < 0.8, 7, rng.randint(0, 2000, n))
    l = np.stack([lk, rng.randint(0, 10, n)]).astype(np.int32)
    r = np.stack([rk, rng.randint(0, 10, n)]).astype(np.int32)
    extra = scenario("skew recursion", l, r, "semi", r.nbytes // 10, True)
    require(extra.get("repartitions", 0) > 0, f"outofcore skew: never re-partitioned ({extra})")


def fanout_cost(dev, rep):
    """What one PartitionedRelation.append costs on the card: a 4,096-row,
    2-column block into 32 partitions (a grace join's probe batch), its
    partition ids apart; host syncs, cudaLaunchKernel calls and ms a call
    (CUDA events over 50 calls after a warm-up)."""
    from repro_torch.core.partition import PartitionedRelation, partition_ids_multi

    rng = np.random.RandomState(SEED)
    cols = torch.from_numpy(rng.randint(0, 1 << 20, (2, 4096)).astype(np.int32)).to(dev)
    rel = PartitionedRelation(2, 32, dev)
    pids = partition_ids_multi([cols[0]], 32)
    out = {}
    for label, fn in (("partition_ids_multi", lambda: partition_ids_multi([cols[0]], 32)),
                      ("append", lambda: rel.append(cols, pids))):
        fn()
        syncs = count_syncs(fn)
        launches = device_profile(fn)["cuda_launch_kernel"]
        out[label] = {"syncs": syncs, "cuda_launch_kernel": launches, "ms": call_ms(fn, 50)}
    rel.close()
    rep["fanout"] = out
    log(f"  fan-out of a 4,096-row block into 32 partitions: {out}")


def _budget_query(engine, name, text, tmp, tally, rep, plain):
    """One query under the budget: its rows, wall, counters, peak device
    memory (torch.cuda.max_memory_allocated less what was allocated before
    the query: the stores stay out) and launches; a second run counts its
    host syncs (but for OOC_GRACE_QUERY's). ``plain`` is the unconstrained
    run's report entry
    (wall_s, peak_bytes, syncs where the follow-ups counted them)."""
    explain = engine.explain(text)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tally.count() as launches:
        res, wall = run_query(engine, text)
    peak = torch.cuda.max_memory_allocated() - base
    extra = tree_extra(res.root)
    rows = res.decoded(engine.store.dict)
    del res
    require(not _spill_files(tmp), f"outofcore {name}: spill files left after the query")
    syncs = None  # not measured: q6's second run (about 40 s) is cut from PR 23
    if name != OOC_GRACE_QUERY:
        syncs = count_syncs(lambda: run_query(engine, text))
        require(not _spill_files(tmp), f"outofcore {name}: spill files left after the "
                                       "second run")
    rep[name] = {"wall_s": wall, "plain_wall_s": plain.get("wall_s"), "extra": extra,
                 "peak_bytes": peak, "plain_peak_bytes": plain.get("peak_bytes"),
                 "syncs": syncs, "plain_syncs": plain.get("syncs"), "launches": launches,
                 "grace_parts": [int(x) for x in re.findall(r"grace parts=(\d+)", explain)],
                 "partitioned_parts": [int(x) for x in
                                       re.findall(r"partitioned parts=(\d+)", explain)]}
    log(f"  {name}: wall {wall:.3f} s (unconstrained {plain.get('wall_s')}), {extra}, "
        f"peak {peak} bytes (unconstrained {plain.get('peak_bytes')}), {syncs} host "
        f"syncs (unconstrained {plain.get('syncs')}), grace parts "
        f"{rep[name]['grace_parts']}, partitioned parts {rep[name]['partitioned_parts']}, "
        f"launches={launches}")
    return rows, rep[name]


def merge_window_spill(dev, tmp, rep, tally):
    """A MergeJoin whose right window holds one key of 2^20 + 4,096 rows
    among background keys, against 3 left rows of that key: with
    spill_dir set the window spills while draining, and the rows equal
    the same join's without it."""
    from repro_torch.core.operators import merge_join as MJ
    from repro_torch.core.operators.base import close_tree

    rng = np.random.RandomState(SEED)
    hot, key = (1 << 20) + 4096, 500_000
    rk = np.sort(np.concatenate([rng.randint(0, 1_000_000, 200_000), np.full(hot, key)]))
    lk = np.sort(np.concatenate([rng.randint(0, 1_000_000, 20_000), np.full(3, key)]))
    r = np.stack([rk, rng.randint(0, 1000, rk.shape[0])]).astype(np.int32)
    l = np.stack([lk, rng.randint(0, 1000, lk.shape[0])]).astype(np.int32)

    def join(spill_dir):
        return MJ.MergeJoin(_source(l, (0, 1), dev, 0), _source(r, (0, 2), dev, 0), 0, dev,
                            spill_dir=spill_dir)

    want = drain_rows(join(None))
    j = join(tmp)
    t0 = time.perf_counter()
    with tally.count() as launches:
        got = drain_rows(j)
    wall = time.perf_counter() - t0
    spills = j._rwin.spills
    close_tree(j)
    left = _spill_files(tmp)
    log(f"  merge window: {got.shape[1]} rows in {wall:.3f} s, the right window spilled "
        f"{spills} times, launches={launches}")
    require(spills > 0, "outofcore merge window: the right window never spilled")
    require(np.array_equal(got, want), "outofcore merge window: rows differ from the join "
                                       "without spill_dir")
    require(not left, f"outofcore merge window: spill files left: {left}")

    def drain_syncs(spill_dir):  # a further drain of a fresh join, syncs counted
        j = join(spill_dir)
        n = count_syncs(lambda: drain_rows(j))
        close_tree(j)
        return n

    syncs = {"spilled": drain_syncs(tmp), "resident": drain_syncs(None)}
    require(not _spill_files(tmp), "outofcore merge window: spill files left after a rerun")
    log(f"  merge window host syncs: {syncs}")
    rep["merge window"] = {"rows": int(got.shape[1]), "wall_s": wall, "spills": spills,
                           "launches": launches, "syncs": syncs}


def force_misestimate(phys, est=10.0):
    """Shrink the planner's build-side estimates of merge joins in place."""
    from repro_torch.core import planner as PL

    if isinstance(phys, PL.PMergeJoin) and isinstance(phys.right, PL.PSort):
        phys.right.est_rows = est
    for f in dataclasses.fields(phys):
        v = getattr(phys, f.name)
        if isinstance(v, PL.Phys):
            force_misestimate(v, est)


def adaptive_check(dev, store, want, rep, tally):
    """ADAPTIVE_QUERY on the full-size store under the merge path with the
    adaptive join on: once as planned (it stays merge), once with the
    build's estimate forced to 10 rows (it switches to hash); both counts
    equal the closed form, which the merge path's count equals."""
    import repro_torch
    from repro_torch.core.operators.adaptive_join import AdaptiveMergeJoin

    engine = repro_torch.Engine(store, repro_torch.EngineConfig(
        join_strategy="merge", adaptive_join="on"), device=dev, stats=stats_for(store))
    text = repro_torch.LSQB_QUERIES[ADAPTIVE_QUERY]
    require(" adaptive" in engine.explain(text),
            f"outofcore adaptive: {ADAPTIVE_QUERY} has no adaptive merge join")
    node, vt = engine.parse(text)
    for label, forced in (("as planned", False), ("forced misestimate", True)):
        phys = engine.plan(node)
        if forced:
            force_misestimate(phys)
        t0 = time.perf_counter()
        with tally.count() as launches:
            res = engine.execute_plan(phys, vt)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (row,) = res.decoded(store.dict)
        got = int(next(iter(row.values())))
        aj = _find_op(res.root, AdaptiveMergeJoin)
        log(f"  adaptive {ADAPTIVE_QUERY} {label}: count={got} closed form={want} "
            f"wall={wall:.3f} s {aj.stats.extra} {aj.stats.detail!r} launches={launches}")
        require(got == want, f"outofcore adaptive {label}: {got} != {want}")
        require(aj.stats.extra.get("adaptive_switches") == int(forced) and
                ("-> hash" in aj.stats.detail) == forced,
                f"outofcore adaptive {label}: {aj.stats.extra}")
        rep[f"adaptive {label}"] = {"count": got, "wall_s": wall,
                                    "extra": dict(aj.stats.extra),
                                    "detail": aj.stats.detail, "launches": launches}


def outofcore_phase(dev, store, bstore, forms, report):
    """The out-of-core path on the card; returns its launch counts (the
    budgeted, spilling and adaptive runs only)."""
    import repro_torch
    from repro_torch.data import BSBM_BI_QUERIES

    rep = report["outofcore"] = {"budget": OOC_BUDGET}
    tally = LaunchTally()
    default = report["full"]["paths"]["default"]["queries"]
    fanout_cost(dev, rep)
    with tempfile.TemporaryDirectory(prefix="barq-spill-") as tmp:
        spill_stress(dev, tmp, rep, tally)
        engine = repro_torch.Engine(store, repro_torch.EngineConfig(
            memory_budget=OOC_BUDGET, spill_dir=tmp), device=dev, stats=stats_for(store))
        for name in OOC_QUERIES:
            rows, q = _budget_query(engine, name, repro_torch.LSQB_QUERIES[name], tmp, tally,
                                    rep, default[name])
            got = int(next(iter(rows[0].values())))
            require(got == forms["lsqb"][name], f"outofcore {name}: {got} != closed form "
                                                f"{forms['lsqb'][name]}")
        q6 = rep[OOC_GRACE_QUERY]
        require(q6["grace_parts"] and max(q6["grace_parts"]) >= 4,
                f"outofcore {OOC_GRACE_QUERY}: no hash join planned grace with 4+ parts")
        require(q6["extra"].get("spill_files", 0) > 0, f"outofcore {OOC_GRACE_QUERY}: no spill")
        for k in ("radix_partition", "hash_probe", "join_expand", "gather_emit"):
            require(q6["launches"].get(k, 0) > 0, f"outofcore {OOC_GRACE_QUERY}: {k} never "
                                                  "launched")
        rows, _ = _budget_query(engine, "d2", DISTINCT_QUERIES["d2"], tmp, tally, rep,
                                report["distinct"]["queries"]["d2"])
        require({r["city"]: int(r["n"]) for r in rows} == forms["d2"],
                "outofcore d2: per-city counts differ from the closed form")
        bengine = repro_torch.Engine(bstore, repro_torch.EngineConfig(
            memory_budget=OOC_BUDGET, spill_dir=tmp), device=dev, stats=stats_for(bstore))
        partitioned = []
        for name in OOC_BSBM_QUERIES:
            rows, q = _budget_query(bengine, name, BSBM_BI_QUERIES[name], tmp, tally, rep,
                                    report["distinct"]["queries"][name])
            if name == "b4":
                ok = {r["vendor"]: int(r["reviewers"]) for r in rows} == forms["b4"]
            elif name == "b8":
                ok = int(rows[0]["n"]) == forms["b8"]
            else:
                ok = canonical(rows) == forms["bsbm_rows"][name]
            require(ok, f"outofcore {name}: rows differ from the unconstrained run's "
                        "(or the closed form)")
            if q["partitioned_parts"] and q["launches"].get("segment_scan", 0) > 0:
                partitioned.append(name)
        require(partitioned, "outofcore: no BSBM GROUP BY ran partitioned with segment_scan")
        log(f"  partitioned GROUP BY with segment_scan: {partitioned}")
        merge_window_spill(dev, tmp, rep, tally)
        adaptive_check(dev, store, forms["lsqb"][ADAPTIVE_QUERY], rep, tally)
    rep["launches"] = tally.counts
    for k in ("radix_partition", "hash_probe", "join_expand", "gather_emit", "segment_scan"):
        require(tally.counts[k] > 0, f"outofcore: {k} was never launched")
    return tally.counts


def full_followups(engines, report):
    """The sync-counting reruns (of the full phase's queries and of the
    property paths) and the profiled run of the full phase."""
    import repro_torch

    reruns = [(path, name, repro_torch.LSQB_QUERIES[name], report["full"]["paths"][path])
              for path, queries in (("merge", MERGE_SYNC_QUERIES),
                                    ("default", DEFAULT_SYNC_QUERIES))
              for name in queries]
    reruns += [("default", name, text, report["paths"]) for name, text in PATH_QUERIES.items()]
    for path, name, text, rep in reruns:
        engine = engines[path]
        t0 = time.perf_counter()
        syncs = count_syncs(lambda: run_count(engine, text))
        wall = time.perf_counter() - t0
        rep["queries"][name].update(syncs=syncs, syncs_wall_s=wall)
        log(f"  {path} {name}: {syncs} host syncs (a second run, torch sync debug mode, "
            f"{wall:.1f} s)")
    name = PROFILED_QUERY
    rep = report["full"]["paths"]["default"]["queries"][name]
    prof = device_profile(lambda: run_count(engines["default"], repro_torch.LSQB_QUERIES[name]))
    rep["profile"] = prof
    if prof["device_busy_s"] is None:
        log(f"  default {name} profile: the profiler recorded no device time (not measured)")
        return
    prof["idle_share"] = 1.0 - prof["device_busy_s"] / rep["wall_s"]
    log(f"  default {name} profile (a third run): device busy {prof['device_busy_s']:.3f} s "
        f"of {rep['wall_s']:.3f} s unprofiled wall, idle share {prof['idle_share']:.4f}, "
        f"profiled run {prof['profiled_wall_s']:.1f} s, its events summed in "
        f"{prof['analysis_s']:.1f} s, {prof['cuda_launch_kernel']} cudaLaunchKernel and "
        f"{prof['cuda_memset']} cudaMemsetAsync calls")
    for key, count, us in prof["device_ops"]:
        log(f"    device {us / 1e3:10.1f} ms {count:8d}x {key[:90]}")
    for kname, (count, us) in prof["kernels"].items():
        log(f"    kernel {kname}: {count} launches, {us / max(count, 1):.2f} us each on the device")
    for key, count, us in prof["host_ops"]:
        log(f"    host   {us / 1e3:10.1f} ms {count:8d}x {key[:90]}")


# ---------------------------------------------------------------------------
# the telemetry phase: the per-query trace, EXPLAIN ANALYZE and cardinality
# feedback on the full-size store
# ---------------------------------------------------------------------------


def launch_calls(fn):
    """(cudaLaunchKernel calls, wall seconds) of one run of ``fn`` under
    torch.profiler (host events), after one unprofiled run whose wall it
    returns."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return names.count("cudaLaunchKernel"), wall


def telemetry_phase(dev, engines, store, kept, report):
    """Telemetry off against on for TELEMETRY_QUERIES on the default
    engine (host syncs of a sync-counted run after the first, the row
    counting's launches, walls; for the small query also cudaLaunchKernel
    under the profiler), whose sync difference must be the same for every
    query; q6's EXPLAIN ANALYZE from the full phase's run, the rows into
    its COUNT(*) equal to the closed form; APPLY_QUERY under
    ``cardinality_feedback="apply"`` after the full phase's run's actuals,
    its plan marked ``(source=feedback)`` and its count the closed form;
    q6's Chrome trace written and parsed back. The checks are counts and
    equalities."""
    import repro_torch
    from repro_torch.core.operators import base as OB
    from repro_torch.core.operators.aggregate import StreamingGroupBy

    t_phase = time.perf_counter()
    engine = engines["default"]
    forms = report["full"]["closed_forms"]
    full = report["full"]["paths"]["default"]["queries"]
    rep = report["telemetry"] = {"queries": {}}
    diffs = {}
    for name in TELEMETRY_QUERIES:
        text = repro_torch.LSQB_QUERIES[name]
        on = full[name]
        q = rep["queries"][name] = {"on": {
            "wall_s": on["wall_s"], "syncs": on["syncs"], "syncs_wall_s": on["syncs_wall_s"],
            "count_launches": on["count_launches"], "operator_batches": on["operator_batches"],
            "trace_kernel_events": on["trace_kernel_events"]}}
        engine.cfg.telemetry = False
        try:
            out = {}
            counting = OB.count_launches
            t0 = time.perf_counter()
            syncs = count_syncs(lambda: out.update(zip(("count", "wall", "res"),
                                                       run_traced(engine, text))))
            q["off"] = {"syncs": syncs, "syncs_wall_s": time.perf_counter() - t0,
                        "count_launches": OB.count_launches - counting}
            require(out["count"] == forms[name] and out["res"].trace is None,
                    f"telemetry off {name}: count {out['count']} (closed form "
                    f"{forms[name]}), trace {out['res'].trace}")
            del out
            if name == SMALL_TELEMETRY_QUERY:
                q["off"]["cuda_launch_kernel"], q["off"]["wall_s"] = launch_calls(
                    lambda: run_count(engine, text))
        finally:
            engine.cfg.telemetry = True
        if name == SMALL_TELEMETRY_QUERY:
            q["on"]["cuda_launch_kernel"] = on["profile"]["cuda_launch_kernel"]
        diffs[name] = q["on"]["syncs"] - q["off"]["syncs"]
        log(f"  {name}: host syncs on {q['on']['syncs']} / off {q['off']['syncs']} "
            f"(sync-counted runs {q['on']['syncs_wall_s']:.1f} s / "
            f"{q['off']['syncs_wall_s']:.1f} s); the row counting's launches on "
            f"{q['on']['count_launches']} (first run) / off {q['off']['count_launches']} "
            f"over {q['on']['operator_batches']} operator batches; "
            f"{q['on']['trace_kernel_events']} kernel events in the trace; "
            + f"first-run wall on {q['on']['wall_s']:.3f} s"
            + (f"; cudaLaunchKernel on {q['on']['cuda_launch_kernel']} (the follow-ups' "
               f"profiled run) / off {q['off']['cuda_launch_kernel']}, an unprofiled rerun "
               f"off {q['off']['wall_s']:.3f} s" if name == SMALL_TELEMETRY_QUERY else ""))
    require(len(set(diffs.values())) == 1 and 0 <= min(diffs.values()) <= 2,
            f"telemetry: the host syncs it adds differ by query or exceed 2: {diffs}")
    rep["sync_difference"] = diffs

    res = kept["q6"]
    analyze = res.explain_analyze()
    log("  q6 EXPLAIN ANALYZE (the full phase's run):\n" + analyze)
    group = _find_op(res.root, StreamingGroupBy)
    into = group.children()[0].stats.results
    require(into == forms["q6"] and res.root.stats.results == 1,
            f"telemetry: q6's COUNT(*) took {into} rows, closed form {forms['q6']}")
    require("est:" in analyze and analyze.count("\n") >= 5,
            "telemetry: q6's EXPLAIN ANALYZE lacks estimates or operators")
    rep["q6_explain_analyze"] = analyze

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "q6_trace.json"
        res.trace.save_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        rep["q6_chrome_trace_bytes"] = path.stat().st_size
    evs = doc["traceEvents"]
    kernel_evs = sum(1 for e in evs if e.get("cat") == "kernel")
    spans = [e["name"] for e in evs if e.get("cat") == "query"]
    require(kernel_evs == len(res.trace._kernels) and kernel_evs > 0
            and spans == ["parse", "plan", "translate", "execute"]
            and any(e.get("cat") == "operator" for e in evs),
            f"telemetry: q6's Chrome trace came back with {kernel_evs} kernel events, "
            f"spans {spans}")
    log(f"  q6 Chrome trace: {rep['q6_chrome_trace_bytes']} bytes, {len(evs)} events "
        f"({kernel_evs} kernel), parsed back")

    fb = repro_torch.CardinalityFeedback()
    ap = repro_torch.Engine(store, repro_torch.EngineConfig(cardinality_feedback="apply"),
                            device=dev, stats=stats_for(store), feedback=fb)
    name = APPLY_QUERY
    text = repro_torch.LSQB_QUERIES[name]
    plan1 = ap.explain(text)
    fresh = repro_torch.Engine(store, repro_torch.EngineConfig(), device=dev,
                               stats=stats_for(store))
    require(plan1 == fresh.explain(text), "telemetry: an apply plan with no history "
                                          "differs from a fresh default engine's")
    del fresh
    # an empty history plans the query as the default engine does, so the
    # full phase's run is the first apply run: record its actuals as the
    # engine does after a drain
    ap._record_actuals(kept[name].root)
    plan2 = ap.explain(text)
    require("(source=feedback)" in plan2, f"telemetry: {name}'s second plan shows no feedback")
    got, wall, res2 = run_traced(ap, text)
    analyze2 = res2.explain_analyze()
    require(got == forms[name] and "(source=feedback)" in analyze2,
            f"telemetry: {name} under apply counted {got} (closed form {forms[name]})")
    rep["apply"] = {"query": name, "feedback_entries": len(fb), "version": fb.version,
                    "plan_shape_changed": _plan_shape(plan2) != _plan_shape(plan1),
                    "count": got, "wall_s": wall, "plan": plan2,
                    "explain_analyze": analyze2}
    log(f"  {name} under cardinality_feedback=\"apply\": count={got} (closed form), "
        f"wall={wall:.3f} s, {len(fb)} feedback entries; the second plan:\n{plan2}")
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"  telemetry phase: {rep['phase_s']:.1f} s")


def _plan_shape(explain):
    """An EXPLAIN text without its estimates, sources and SIP filter ids."""
    return re.sub(r"est=\S+|\(source=feedback\)|#\d+", "", explain)


def device_profile(fn, top: int = 8):
    """One run under torch.profiler: device busy seconds (the sum of every
    device op's time; None when the profiler saw no device), the top device
    ops and host ops by self time (microseconds), and each port kernel's
    launches and device microseconds.

    It reads the profiler's raw events and sums them itself: building
    ``key_averages()`` costs about 0.1 ms per event, and a full-size query
    records millions of events."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    profiled_wall = time.perf_counter() - t0
    cpu = torch.autograd.DeviceType.CPU
    dev_t = defaultdict(lambda: [0, 0.0])  # name -> [count, us]
    host_t = defaultdict(lambda: [0, 0.0])
    threads = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            threads[e.start_thread_id()].append((e.start_ns(), e.duration_ns(), e.name()))
        else:
            d = dev_t[e.name()]
            d[0] += 1
            d[1] += e.duration_ns() / 1e3
    # host self time: an op's duration less that of the ops nested in it
    for evs in threads.values():
        evs.sort(key=lambda r: (r[0], -r[1]))
        stack = []
        for start, dur, name in evs:
            while stack and stack[-1][1] <= start:
                stack.pop()
            if stack:
                host_t[stack[-1][0]][1] -= dur / 1e3
            h = host_t[name]
            h[0] += 1
            h[1] += dur / 1e3
            stack.append((name, start + dur))
    del prof, threads
    dev = sorted(((k, c, us) for k, (c, us) in dev_t.items() if us > 0), key=lambda r: -r[2])
    host = sorted(((k, c, us) for k, (c, us) in host_t.items()), key=lambda r: -r[2])
    busy = sum(r[2] for r in dev) / 1e6 if dev else None
    kernels = {name: [sum(r[1] for r in dev if _kernel_event(name, r[0], main_only=True)),
                      sum(r[2] for r in dev if _kernel_event(name, r[0]))]
               for name in KERNEL_INFO}
    return {"device_busy_s": busy, "profiled_wall_s": profiled_wall,
            "analysis_s": time.perf_counter() - t0 - profiled_wall,
            "device_ops": dev[:top], "host_ops": host[:top], "kernels": kernels,
            "cuda_launch_kernel": host_t["cudaLaunchKernel"][0],
            "cuda_memset": host_t["cudaMemsetAsync"][0]}


def canonical(decoded):
    """Decoded rows as sorted lists of values (JSON-safe), so that two
    answers compare whole."""
    return sorted(([r[k] for k in sorted(r)] for r in decoded), key=repr)


def probe_store(device, seed):
    """The fault probes' store: 20 subjects with 18 properties over three
    values, 20 others with six properties (the first ten copying a
    subject's first six values, every fourth changing its sixth), and 60
    items in four groups with numeric values float32 cannot hold."""
    import repro_torch

    rng = np.random.RandomState(seed)
    store = repro_torch.QuadStore(device=device)
    vals = rng.randint(0, 3, (20, 18))
    for i in range(20):
        for k in range(18):
            store.add(f":s{i}", f":p{k}", f":v{vals[i, k]}")
    for j in range(20):
        for k in range(6):
            v = int(vals[j, k]) if j < 10 else int(rng.randint(0, 3))
            store.add(f":t{j}", f":q{k}", f":v{(v + 1) % 3 if j % 4 == 3 and k == 5 else v}")
    for i in range(60):
        x = NOT_F32[i % len(NOT_F32)] if i < 30 else float(rng.choice(NOT_F32[:4]))
        store.add(f":i{i}", ":x", int(x) if x == 16777217.0 else x)
        store.add(f":i{i}", ":g", f":g{i % 4}")
    return store.build()


def breadth_results(device, scale, seed):
    """{config: {query: (rows, wall seconds)}} for the nine LSQB queries,
    p1-p5, d1 and d2 at LSQB ``scale``, the eight BSBM BI queries and the
    explore mix (``explore_queries``) at BSBM_BREADTH_SCALE and the fault
    probes on ``probe_store``, under every
    breadth configuration, on ``device``."""
    import repro_torch
    from repro_torch.data import BSBM_BI_QUERIES, generate_ecommerce_graph

    store, _ = repro_torch.generate_social_graph(scale=scale, seed=seed, device=device)
    bstore, bmeta = generate_ecommerce_graph(scale=BSBM_BREADTH_SCALE, seed=BSBM_SEED,
                                             device=device)
    pstore = probe_store(device, seed)
    if device.type == "cuda":
        log(f"  LSQB scale {scale}: {store.n_quads} triples; BSBM scale {BSBM_BREADTH_SCALE}: "
            f"{bstore.n_quads} triples; fault probes: {pstore.n_quads} triples")
    work = [(store, {**repro_torch.LSQB_QUERIES, **PATH_QUERIES, **DISTINCT_QUERIES}),
            (bstore, {**BSBM_BI_QUERIES, **explore_queries(bmeta, seed)}),
            (pstore, PROBE_QUERIES)]
    out = {}
    for cfg_name, cfg in BREADTH_CONFIGS.items():
        out[cfg_name] = {}
        with tempfile.TemporaryDirectory(prefix="barq-breadth-") as spill:
            for st, queries in work:
                engine = repro_torch.Engine(st, _config(cfg, spill), device=device)
                for name, text in queries.items():
                    if name == "q8" and cfg_name not in Q8_BREADTH_CONFIGS:
                        continue
                    try:
                        res, wall = run_query(engine, text)
                    except ValueError as e:
                        if REFUSED_UNORDERED not in str(e):
                            raise
                        out[cfg_name][name] = ([[f"refused: {e}"]], 0.0)
                        continue
                    require(not _spill_files(spill), f"breadth {cfg_name} {name}: spill files "
                                                     "left after the query")
                    out[cfg_name][name] = (canonical(res.decoded(st.dict)), wall)
    return out


def start_cpu_breadth(out_path: Path) -> subprocess.Popen:
    """The breadth phase's CPU side, in a child process of this script."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--cpu-breadth", str(out_path)])


def _short(rows):
    return f"{rows[0][0]}" if len(rows) == 1 and len(rows[0]) == 1 else f"{len(rows)} rows"


def breadth_phase(dev, scale, seed, report, child, child_out: Path):
    cuda = json.loads(json.dumps(breadth_results(dev, scale, seed)))  # the CPU side's types
    log(f"  cuda side done {elapsed()}; waiting for the CPU side")
    rc = child.wait(timeout=900)
    require(rc == 0, f"the CPU breadth process failed with exit code {rc}")
    cpu = json.loads(child_out.read_text())
    report["breadth"] = {"scale": scale, "bsbm_scale": BSBM_BREADTH_SCALE, "configs": {}}
    for cfg_name in BREADTH_CONFIGS:
        rep = report["breadth"]["configs"][cfg_name] = {}
        for name, (grows, wc) in cuda[cfg_name].items():
            crows, wcpu = cpu[cfg_name][name]
            log(f"  {cfg_name} {name}: cuda {_short(grows)} ({wc:.3f} s)  cpu {_short(crows)} "
                f"({wcpu:.3f} s)")
            require(grows == crows, f"{cfg_name} {name}: the card's rows differ from the CPU's")
            rep[name] = {"result": _short(grows), "cuda_s": wc, "cpu_s": wcpu}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the full report to this file")
    ap.add_argument("--cpu-breadth", metavar="OUT",
                    help="(the breadth phase's child) write the CPU counts to OUT and exit")
    args = ap.parse_args()

    if args.cpu_breadth:
        torch.set_num_threads(4)
        results = breadth_results(torch.device("cpu"), BREADTH_SCALE, SEED)
        Path(args.cpu_breadth).write_text(json.dumps(results))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as KB

    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    KB.build()
    KB.library()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {report['build_s']:.1f} s ({len(KB.sources())} sources, sm_90a)")

    log(f"full-size store: {elapsed()}")
    store = load_full_store(dev, FULL_SCALE, SEED, report)
    log(f"kernels: {elapsed()}")
    rows = kernel_phase(dev, SEED, knows_subjects(store))
    log(f"full-size: {elapsed()}")
    engines, path_launches, kept = full_phase(dev, store, report)
    log(f"paths: {elapsed()}")
    path_launches["paths"] = paths_phase(engines["default"], store, report)
    log(f"distinct: {elapsed()}")
    forms = {"lsqb": report["full"]["closed_forms"]}
    path_launches["distinct"], bstore, bmeta = distinct_phase(engines["default"], store, dev,
                                                             report, forms)
    log(f"explore: {elapsed()}")
    path_launches["explore"] = explore_phase(dev, bstore, bmeta, report)
    log(f"serve: {elapsed()}")
    path_launches["serve"] = serve_phase(dev, store, bstore, bmeta, report)
    log(f"legacy: {elapsed()}")
    path_launches["legacy"] = legacy_phase(dev, store, report)
    with tempfile.TemporaryDirectory() as tmp:
        child_out = Path(tmp) / "cpu_breadth.json"
        child = start_cpu_breadth(child_out)
        try:
            log(f"full-size follow-ups (the CPU breadth runs beside them): {elapsed()}")
            full_followups(engines, report)
            log(f"telemetry: {elapsed()}")
            telemetry_phase(dev, engines, store, kept, report)
            del engines, kept
            log(f"outofcore: {elapsed()}")
            path_launches["outofcore"] = outofcore_phase(dev, store, bstore, forms, report)
            del store, bstore
            _GRAPH_STATS.clear()
            for name, (_, _, path) in KERNEL_INFO.items():
                rows[name]["launches"] = path_launches[path][name]
                rows[name]["launches_by_path"] = {p: n[name] for p, n in path_launches.items()}
            log(f"breadth: {elapsed()}")
            breadth_phase(dev, BREADTH_SCALE, SEED, report, child, child_out)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    log(f"done: {elapsed()}")

    report["graph_stats"] = GRAPH_STATS_REPORT
    for label, g in GRAPH_STATS_REPORT.items():
        log(f"  planner statistics over {label}: one build of {g['build_s']:.3f} s shared by "
            f"{g['engines']} engines")
    report["kernels"] = list(rows.values())
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": report["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
