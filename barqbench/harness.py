"""One run of one cell: resolve the cell, build the store, warm up, drive the
window, check the answers, print the result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name in
``BENCHMARK.json``: ``configs/<config>.json``, ``mixes/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(facts)`` that returns a number, or None
where it finds nothing to read). A later cell adds files and entries and
edits none.

The system under test is ``repro_torch`` (from ``src/``); the data, the
traffic, the reduction of traces to metrics and the reference that decides
``correct`` live here, and nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from barqbench import judge as J
from barqbench import reference, traffic, tracing, window
from barqbench.reference import data as refdata

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    pass


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    per_layer: List[dict]
    end_to_end: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, root: Path, workload: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    w = cells[workload]
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(workload, int(w["chips"]), config, mix,
                [m for m in bench["per_layer"] if _applies(m, workload)],
                [m for m in bench["end_to_end"] if _applies(m, workload)])


def reader(name: str):
    """The metric's reader, ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"barqbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Record:
    name: str
    consts: Dict[str, str]
    text: str
    latency_s: float
    execute_s: Optional[float]
    rows: Optional[np.ndarray]  # int32 codes, None where the request raised
    plan: Optional[tuple] = None  # (physical plan, variable table) that ran
    error: Optional[str] = None


def _execute_span(res) -> Optional[float]:
    tr = res.trace
    if tr is None:
        return None
    for name, _cat, _t0, dur, _args in tr.spans:
        if name == "execute":
            return dur
    return None


def serve_round(server, requests) -> List[Record]:
    out = []
    for req in requests:
        t0 = time.perf_counter()
        try:
            res = server.execute(req.name, req.text)
        except Exception as exc:  # a failed request is judged, not fatal
            out.append(Record(req.name, req.consts, req.text, time.perf_counter() - t0, None,
                              None, error=f"{type(exc).__name__}: {exc}"))
            continue
        latency = time.perf_counter() - t0
        # the plan that ran, from the server's plan cache: its columns label the rows
        out.append(Record(req.name, req.consts, req.text, latency, _execute_span(res), res.rows,
                          server._plan_for(req.text)[:2]))
    return out


def build_store(graph, device):
    """The graph as a ``QuadStore`` on ``device`` and the planner's
    statistics over it; (store, stats, seconds in build and statistics)."""
    import torch

    from repro_torch.core.stats import GraphStats
    from repro_torch.core.storage import QuadStore

    store = QuadStore(device=device)
    codes = store.dict.encode_many(graph.terms)
    store.add_encoded(codes[graph.quads])
    t0 = time.perf_counter()
    store.build()
    stats = GraphStats(store)
    if store.device.type == "cuda":
        torch.cuda.synchronize()
    return store, stats, time.perf_counter() - t0


def decoded(records: List[Record], server, mix: dict) -> List[tuple]:
    """(query, rows as terms in the spec's column order, or None)."""
    from repro_torch.core import planner as PL

    d = server.store.dict
    out = []
    for r in records:
        if r.rows is None:
            out.append((r.name, None))
            continue
        phys, vt = r.plan
        names = [vt.name(v) for v in PL.phys_vars(phys)]
        want = mix["queries"][r.name]["columns"]
        cols = [names.index(c) for c in want] if sorted(names) == sorted(want) else None
        if cols is None or r.rows.shape[1] != len(cols):
            out.append((r.name, None))  # not the query's columns: judged wrong
            continue
        try:
            out.append((r.name, [tuple(d.decode(int(row[c])) if row[c] >= 0 else None
                                       for c in cols) for row in r.rows]))
        except IndexError:  # a code the dictionary never gave out
            out.append((r.name, None))
    return out


def run_cell(bench: dict, root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             products: Optional[int] = None, log=None) -> dict:
    """One run; returns the result line's object. ``device="cpu"`` and a
    small number of ``products`` rehearse it on the CPU (its device numbers are then
    the CPU's and nothing is profiled)."""
    import torch

    from repro_torch.core.executor import EngineConfig
    from repro_torch.serve.query_server import QueryServer

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = resolve(bench, root, workload)
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{workload} needs {cell.chips} CUDA card(s); "
                         f"torch.cuda.is_available()={torch.cuda.is_available()}")
        from repro_torch.kernels import build as KB

        KB.library()  # the first run in a checkout builds the kernels here
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(torch.device("cuda", 0))
    data_seed, mix_seed = traffic.seeds(seed, 2)
    conf = cell.config
    graph = refdata.graph_for(conf, data_seed, products)
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    store, stats, store_build_s = build_store(graph, dev)
    server = QueryServer(store, EngineConfig(**conf.get("engine", {})), device=dev, stats=stats)
    mix = cell.mix
    stream = traffic.rounds(mix, graph.meta, mix_seed)
    for _ in range(mix["warmup_rounds"]):
        warm = serve_round(server, next(stream))
        bad = [r.error for r in warm if r.error]
        if bad:
            log(f"warm-up request failed: {bad[0]}")
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"{workload}: {len(graph.quads)} triples, set-up {setup_s:.3f} s "
        f"(store build and statistics {store_build_s:.3f} s)")

    records, window_s, n_rounds = window.drive(lambda rs: serve_round(server, rs), stream, seconds)
    log(f"window: {len(records)} requests in {n_rounds} rounds, {window_s:.3f} s, p95 "
        f"{window.p95_ms([r.latency_s for r in records]):.3f} ms; mean ms "
        + " ".join(f"{q} {1e3 * np.mean([r.latency_s for r in records if r.name == q]):.1f}"
                   for q in sorted({r.name for r in records})))
    # the probe: the profiled rounds, then in a traced run the sync-counted
    # ones, drawn with constants of their own, so every run probes the same
    # requests whatever the number of rounds the window held
    probe = traffic.rounds(mix, graph.meta, mix_seed, mix["probe_constants_seed"])
    timeline = syncs = None
    reqs = [r for _ in range(mix["profile_rounds"]) for r in next(probe)]
    if on_card:
        extra, timeline = tracing.profiled(lambda rs: serve_round(server, rs), reqs)
        log(f"profiled {len(extra)} requests: busy {timeline.busy_s:.6f} s of "
            f"{timeline.window_s:.6f} s, {timeline.launches} launches, "
            f"{timeline.attributed:.4f} of device ops inside a request; ported kernels "
            f"{timeline.ported_s:.6f} s, launches {timeline.ported_n}")
    else:
        extra = serve_round(server, reqs)
    if trace:
        reqs = [r for _ in range(mix["sync_rounds"]) for r in next(probe)]
        if on_card:
            recs, n_syncs = tracing.count_syncs(lambda: serve_round(server, reqs))
            syncs = {"count": n_syncs, "queries": len(recs)}
        else:
            recs = serve_round(server, reqs)
        extra += recs
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    device_block = {"platform": "gpu" if on_card else "cpu",
                    "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                    "count": cell.chips if on_card else 0,
                    "memory_peak_bytes": peak}
    judged = records + extra
    answers = decoded(judged, server, mix)
    del server, store, stats
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref_s: Dict[str, float] = {}
    checks = J.judge(answers, reference.answers(graph, judged, mix, seconds=ref_s),
                     mix["queries"], J.ranker(graph))
    log(f"reference: {time.perf_counter() - t0:.3f} s over {len(judged)} requests; by query "
        + " ".join(f"{k} {v:.3f}" for k, v in sorted(ref_s.items())))
    limits = mix["limits"]
    failed = sum(r.error is not None for r in judged)
    for r in judged:
        if r.error:
            log(f"failed {r.name} {r.consts}: {r.error}")
            break
    correct = J.verdict(checks, limits) and len(judged) > 0
    facts = {"requests": [{"name": r.name, "latency_s": r.latency_s, "execute_s": r.execute_s}
                          for r in records],
             "window_s": window_s, "setup_s": setup_s, "store_build_s": store_build_s,
             "timeline": timeline, "syncs": syncs}
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = reader(m["name"])(facts)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(judged), "failed": failed,
           "metrics": metrics, "device": device_block}
    if trace and timeline is not None:
        out["device"]["busy_s"] = timeline.busy_s
        out["device"]["window_s"] = timeline.window_s
        ops = sorted(timeline.op_s.items(), key=lambda kv: -kv[1])[:tracing.TOP]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                            "idle_gaps": [[k, v] for k, v in timeline.gaps]}
    out["checks"] = {k: {"value": checks[k], "limit": v} for k, v in limits.items()}
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    try:
        out = run_cell(bench, root, args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start)
    except NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
