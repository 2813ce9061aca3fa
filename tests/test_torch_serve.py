"""The port's serving layer (``repro_torch.serve``, ``repro_torch.launch``)
against the JAX package's, on the CPU.

The reference's serving cases (the workload repository, the flight
recorder, the metrics registry and its OpenMetrics exposition, the
QueryServer's per-request attribution, plan cache and feedback loop, the
report tables, trace isolation across threads) run against the port, each
beside the reference on the same inputs where both compute something. A
request stream built by ``repro_torch.launch.serve.build_requests`` goes
through both packages' servers over stores generated from the same seed,
and rows, fingerprints, plan-cache hits, pool deltas, the workload
snapshot, the metrics snapshot's keys and the OpenMetrics families must
match exactly. The entry point runs as a module on the CPU.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import planner as RPL  # noqa: E402
from repro.core import telemetry as RTel  # noqa: E402
from repro.data import generate_ecommerce_graph as ref_ecommerce  # noqa: E402
from repro.data import generate_social_graph as ref_social  # noqa: E402
from repro.launch import report as RReport  # noqa: E402
from repro.serve import flight_recorder as RFlight  # noqa: E402
from repro.serve import metrics as RMetrics  # noqa: E402
from repro.serve import query_server as RServer  # noqa: E402
from repro.serve import workload_repo as RRepo  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import planner as PL  # noqa: E402
from repro_torch.core.stats import GraphStats  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.launch import report as PReport  # noqa: E402
from repro_torch.launch.serve import build_requests, serve_stream  # noqa: E402
from repro_torch.serve import flight_recorder as PFlight  # noqa: E402
from repro_torch.serve import metrics as PMetrics  # noqa: E402
from repro_torch.serve import query_server as PServer  # noqa: E402
from repro_torch.serve import workload_repo as PRepo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = {
    "ref": dict(metrics=RMetrics, repo=RRepo, flight=RFlight, tel=RTel, report=RReport,
                server=RServer, config=RConfig, backend="numpy"),
    "port": dict(metrics=PMetrics, repo=PRepo, flight=PFlight, tel=telemetry, report=PReport,
                 server=PServer, config=repro_torch.EngineConfig, backend="plain"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the stores are small, and the test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


def _chain_store(n=120):
    store = RStore()
    for i in range(n):
        store.add(f":p{i}", ":knows", f":p{(i * 7 + 1) % n}")
        store.add(f":p{i}", ":age", 20 + i % 30)
        store.add(f":p{i}", ":interest", f":tag{i % 5}")
    return store.build()


def _tiny_store():
    store = RStore()
    rng = np.random.RandomState(0)
    people = [f":p{i}" for i in range(10)]
    for i in range(10):
        for j in rng.choice(10, size=3, replace=False):
            if i != int(j):
                store.add(people[i], ":knows", people[int(j)])
        store.add(people[i], ":age", int(rng.randint(20, 60)))
        for t in rng.choice(4, size=2, replace=False):
            store.add(people[i], ":interest", f":tag{int(t)}")
    return store.build()


def _join_store(n=4000, seed=13):
    rng = np.random.RandomState(seed)
    store = RStore()
    for i in range(n):
        store.add(f":s{i:05d}", ":knows", f":o{rng.randint(0, 50):05d}")
        store.add(f":s{i:05d}", ":name", f":n{rng.randint(0, 30):05d}")
        store.add(f":t{i:05d}", ":likes", f":o{rng.randint(0, 50):05d}")
        store.add(f":t{i:05d}", ":age", int(rng.randint(0, 90)))
    return store.build()


def _stores(ref_store):
    return {"ref": ref_store, "port": _port_store(ref_store)}


def _server(pkg, store, cfg=None, **kw):
    """A QueryServer of ``pkg`` (the port's on the CPU)."""
    P = PKGS[pkg]
    if pkg == "port":
        kw["device"] = "cpu"
    return P["server"].QueryServer(store, cfg, **kw)


def _misest_query():
    return ("SELECT ?a ?c { ?a :knows ?b . ?b :knows ?c . ?c :age ?x . "
            "FILTER(?x > 25) }")


@pytest.fixture(scope="module")
def chain():
    return _stores(_chain_store())


# ---------------------------------------------------------------------------
# workload repository
# ---------------------------------------------------------------------------


def _repo_scenario(pkg, tmp_path):
    P = PKGS[pkg]
    repo = P["repo"].WorkloadRepository()
    led = P["tel"].KernelLedger()
    led.record("join_expand", P["backend"], 0.002)
    for i in range(5):
        repo.observe("fp1", 0.010 + i * 1e-4, rows=100, ledger=led,
                     max_q_error=3.0, query_text="SELECT ...", ts=100.0 + i)
    repo.observe("fp2", 0.5, rows=1, max_q_error=40.0, ts=200.0)
    st = repo.get("fp1")
    assert st.n == 5 and st.rows == 500
    assert st.kernel_counts["join_expand"] == 5
    assert st.max_q_error == 3.0
    assert repo.qerror_leaderboard(5)[0]["fingerprint"] == "fp2"
    assert repo.top_by_wall(1)[0]["fingerprint"] == "fp2"

    path = str(tmp_path / f"{pkg}.jsonl")
    repo.feedback.record("node-a", 123.0)
    assert repo.save(path) == 2
    fresh = P["repo"].WorkloadRepository()
    assert fresh.load(path) == 2
    assert fresh.get("fp1").n == 5
    assert fresh.get("fp1").latency_hist == repo.get("fp1").latency_hist
    assert fresh.feedback.lookup("node-a") == 123.0
    fresh.load(path)
    assert fresh.get("fp1").n == 10
    lines = [json.loads(x) for x in Path(path).read_text().splitlines()]
    return [{k: v for k, v in x.items() if k != "saved_at"} for x in lines], fresh.snapshot()


def test_repository_accumulates_and_persists(tmp_path):
    assert _repo_scenario("port", tmp_path) == _repo_scenario("ref", tmp_path)


def test_repository_eviction_and_bound():
    out = {}
    for pkg in PKGS:
        repo = PKGS[pkg]["repo"].WorkloadRepository(max_fingerprints=4)
        for i in range(10):
            repo.observe(f"fp{i}", 0.001, ts=float(i))
        assert len(repo) == 4
        assert repo.n_evicted == 6
        assert repo.get("fp9") is not None
        assert repo.get("fp0") is None
        out[pkg] = sorted(s["fingerprint"] for s in repo.top_by_wall(10))
    assert out["port"] == out["ref"]


def test_repository_regression_detection():
    out = {}
    for pkg in PKGS:
        repo = PKGS[pkg]["repo"].WorkloadRepository(regression_factor=2.0)
        for i in range(20):
            assert repo.observe("fp", 0.010, ts=float(i))["regression"] is None
        reg = repo.observe("fp", 0.100, ts=30.0)["regression"]
        assert reg is not None and reg["factor"] >= 2.0
        assert repo.regressions[-1]["fingerprint"] == "fp"
        assert repo.observe("cold-fp", 9.9, ts=31.0)["regression"] is None
        out[pkg] = list(repo.regressions)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_recorder_q_error_trigger(tmp_path):
    metas = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        fr = P["flight"].FlightRecorder(out_dir=str(tmp_path / pkg), q_error_threshold=16.0)
        tr = P["tel"].QueryTrace("t")
        bundle = fr.observe("fp", 0.01, max_q_error=100.0, trace=tr,
                            explain_fn=lambda: "EXPLAIN TEXT", query_text="SELECT ...",
                            ts=1000.0)
        assert bundle is not None
        assert sorted(os.listdir(bundle)) == ["explain.txt", "meta.json", "trace.json"]
        metas[pkg] = json.loads(Path(bundle, "meta.json").read_text())
        assert metas[pkg]["reasons"] == ["q_error"]
        assert metas[pkg]["query"] == "SELECT ..."
        assert "EXPLAIN TEXT" in Path(bundle, "explain.txt").read_text()
        json.loads(Path(bundle, "trace.json").read_text())
        assert fr.observe("fp", 0.01, max_q_error=2.0) is None
        assert fr.n_captures == 1
    assert metas["port"] == metas["ref"]


def test_flight_recorder_latency_trigger_and_bounds(tmp_path):
    for pkg in PKGS:
        fr = PKGS[pkg]["flight"].FlightRecorder(out_dir=str(tmp_path / pkg),
                                                latency_factor=3.0, ring_size=4,
                                                max_captures=2)
        assert fr.observe("fp", 10.0, baseline_p99_s=0.0) is None
        assert fr.observe("fp", 0.5, baseline_p99_s=0.01) is not None
        assert fr.observe("fp", 0.5, baseline_p99_s=0.01) is not None
        assert fr.observe("fp", 0.5, baseline_p99_s=0.01) is None
        assert fr.n_captures == 2
        for _ in range(10):
            fr.observe("fp", 0.001)
        assert len(fr.ring) == 4
        assert fr.snapshot()["observed"] == 14
        assert all("trace" not in e for e in fr.snapshot()["ring"])


# ---------------------------------------------------------------------------
# the server end to end
# ---------------------------------------------------------------------------


def test_server_feedback_loop_and_workload_surface(tmp_path, chain):
    out = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        fr = P["flight"].FlightRecorder(out_dir=str(tmp_path / pkg), q_error_threshold=4.0)
        srv = _server(pkg, chain[pkg],
                      P["config"](engine="barq", cardinality_feedback="apply"), flight=fr)
        q = _misest_query()
        r1 = srv.execute("q", q)
        r2 = srv.execute("q", q)
        assert r1.fingerprint == r2.fingerprint != ""
        assert r2.n_rows == r1.n_rows
        assert r2.max_q_error <= 2.0
        if r1.max_q_error >= 4.0:
            assert r1.flight_bundle is not None
            assert "est:" in Path(r1.flight_bundle, "explain.txt").read_text()
        snap = srv.metrics_snapshot()
        assert snap["workload"]["fingerprints"] == 1
        assert snap["workload"]["top_by_wall"][0]["n"] == 2
        assert snap["workload"]["feedback_entries"] > 0
        assert "regressions" in snap
        assert snap["flight"]["observed"] == 2
        exposition = srv.openmetrics()
        fams = P["metrics"].validate_openmetrics(exposition)
        assert "barq_fingerprint_requests" in fams
        assert f'fingerprint="{r1.fingerprint}"' in exposition
        out[pkg] = (r1.fingerprint, r1.n_rows, r1.max_q_error, r2.max_q_error,
                    r1.flight_bundle is not None, snap["workload"]["feedback_entries"], fams)
    assert out["port"] == out["ref"]


def test_server_observe_mode_keeps_plan_cache_hot(chain):
    for pkg in PKGS:
        srv = _server(pkg, chain[pkg],
                      PKGS[pkg]["config"](engine="barq", cardinality_feedback="observe"))
        srv.execute("q", _misest_query())
        assert srv.execute("q", _misest_query()).plan_cache_hit


def test_query_server_per_request_attribution(chain):
    """Each request's RequestResult carries its own kernel/pool deltas; the
    registry aggregates them exactly; the pool deltas equal the
    reference's."""
    q1 = "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x . FILTER(?x > 25) }"
    q2 = "SELECT ?a { ?a :age ?x }"
    out = {}
    for pkg in PKGS:
        srv = _server(pkg, chain[pkg], PKGS[pkg]["config"](engine="barq"))
        r1, r2, r3 = srv.execute("q1", q1), srv.execute("q2", q2), srv.execute("q1", q1)
        assert not r1.plan_cache_hit and not r2.plan_cache_hit
        assert r3.plan_cache_hit
        assert r1.kernel_dispatches > 0
        assert r2.kernel_dispatches == 0  # a single scan launches no kernel
        assert dict(r3.trace.ledger.counts) == dict(r1.trace.ledger.counts)
        assert r3.pool_delta["allocations"] == 0  # warm arena on the repeat
        snap = srv.metrics_snapshot()
        assert snap["requests"]["count"] == 3
        assert snap["plan_cache"]["hits"] == 1 and snap["plan_cache"]["misses"] == 2
        total = r1.kernel_dispatches + r2.kernel_dispatches + r3.kernel_dispatches
        assert sum(snap["kernels"]["dispatches"].values()) == total
        json.loads(srv.metrics_json())
        misses = srv.metrics.plan_cache_misses
        assert "est:" in srv.explain_analyze(q1)
        assert srv.metrics.plan_cache_misses == misses
        out[pkg] = ([r.n_rows for r in (r1, r2, r3)], [r.pool_delta for r in (r1, r2, r3)],
                    snap["pool"])
    assert out["port"] == out["ref"]
    port_srv = _server("port", chain["port"])
    r = port_srv.execute("q1", q1)
    assert set(b for _, b in r.trace.ledger.backend_counts) == {"plain"}


def test_run_workload_keeps_pinned_keys_and_adds_attribution():
    stores = _stores(_tiny_store())
    reqs = [("a", "SELECT ?a ?b { ?a :knows ?b }"),
            ("b", "SELECT ?p { ?p :interest :tag0 }")] * 3
    out = {}
    for pkg in PKGS:
        srv = _server(pkg, stores[pkg], PKGS[pkg]["config"](engine="barq"))
        stats = srv.run_workload(reqs, warmup=2)
        for key in ("n_requests", "total_rows", "qps", "mean_ms", "p50_ms", "p99_ms"):
            assert key in stats
        assert stats["n_requests"] == 4
        assert stats["plan_cache_hit_rate"] == 1.0
        assert stats["kernel_dispatches"] >= 0
        out[pkg] = (sorted(stats), stats["n_requests"], stats["total_rows"],
                    stats["plan_cache_hit_rate"])
    assert out["port"] == out["ref"]


def test_query_server_plan_cache_no_collision_across_budget(tmp_path):
    """Same query text, different memory budget: different cache entries,
    different plans, and the port's plans are the reference's."""
    stores = _stores(_join_store())
    q = "SELECT ?s ?o ?n { ?s :knows ?o . ?s :name ?n }"
    explains = {}
    for pkg, pl in (("ref", RPL), ("port", PL)):
        C = PKGS[pkg]["config"]
        srv1 = _server(pkg, stores[pkg], C())
        srv1.execute("q", q)
        spill = tmp_path / pkg
        spill.mkdir()
        srv2 = _server(pkg, stores[pkg], C(spill_dir=str(spill), memory_budget=20_000,
                                           join_strategy="hash"))
        srv2.execute("q", q)
        (p1, _, _), = srv1._plan_cache.values()
        (p2, _, _), = srv2._plan_cache.values()
        assert set(srv1._plan_cache) != set(srv2._plan_cache)
        assert pl.explain(p1) != pl.explain(p2)
        explains[pkg] = (pl.explain(p1), pl.explain(p2), set(srv1._plan_cache),
                         set(srv2._plan_cache))
    assert explains["port"] == explains["ref"]


def test_serve_metrics_capture_spill_counters(tmp_path):
    stores = _stores(_join_store())
    q = "SELECT ?s ?o ?n { ?s :knows ?o . ?s :name ?n }"
    out = {}
    for pkg in PKGS:
        spill = tmp_path / pkg
        spill.mkdir()
        srv = _server(pkg, stores[pkg], PKGS[pkg]["config"](
            spill_dir=str(spill), memory_budget=20_000, join_strategy="hash"))
        srv.execute("q", q)
        snap = srv.metrics.snapshot()
        assert snap["execution"]["spill_files"] > 0
        assert snap["execution"]["spill_bytes"] > 0
        om = srv.metrics.to_openmetrics()
        PKGS[pkg]["metrics"].validate_openmetrics(om)
        assert "barq_spill_bytes_total" in om
        assert "barq_adaptive_switches_total" in om
        assert not list(spill.glob("*.npy"))
        out[pkg] = snap["execution"]["spill_files"]
    assert out["port"] == out["ref"]


def test_query_server_needs_a_card_unless_asked_for_the_cpu(chain):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PServer.QueryServer(chain["port"])


# ---------------------------------------------------------------------------
# metrics: edge cases, aggregation, exposition
# ---------------------------------------------------------------------------


def test_sliding_window_empty_and_single_sample():
    for pkg in PKGS:
        w = PKGS[pkg]["metrics"].SlidingWindow()
        assert w.percentile(50) == 0.0 and w.mean() == 0.0 and w.rate() == 0.0
        w.add(0.01, ts=100.0)
        assert w.percentile(99) == 0.01
        assert w.rate(window_s=60, now=100.0) == 0.0
        assert w.percentile(-5) == w.percentile(200) == 0.01


def test_sliding_window_percentiles_match_numpy():
    rng = np.random.RandomState(7)
    vals = rng.exponential(10.0, 200)
    for pkg in PKGS:
        w = PKGS[pkg]["metrics"].SlidingWindow(maxlen=1024)
        for v in vals:
            w.add(float(v), ts=0.0)
        for p in (0, 25, 50, 90, 99, 100):
            assert w.percentile(p) == pytest.approx(np.percentile(vals, p))
        assert w.mean() == pytest.approx(vals.mean())
        w2 = PKGS[pkg]["metrics"].SlidingWindow(maxlen=10)
        for i in range(100):
            w2.add(float(i), ts=float(i))
        assert len(w2) == 10 and min(w2.values()) == 90.0


def test_sliding_window_rate_decays():
    for pkg in PKGS:
        w = PKGS[pkg]["metrics"].SlidingWindow()
        for i in range(10):
            w.add(1.0, ts=100.0 + i)
        assert w.rate(window_s=60, now=110.0) == pytest.approx(1.0, rel=0.3)
        assert w.rate(window_s=60, now=1000.0) == 0.0


def test_metrics_registry_empty_snapshot_schema():
    snap = PMetrics.MetricsRegistry().snapshot()
    ref = RMetrics.MetricsRegistry().snapshot()
    assert set(snap) == set(ref) == {"uptime_s", "requests", "plan_cache", "kernels",
                                     "pool", "latency_hist", "execution"}
    for k in ("requests", "plan_cache", "latency_hist", "execution"):
        assert set(snap[k]) == set(ref[k]), k
    assert snap["requests"]["qps"] == 0.0 and snap["requests"]["p99_ms"] == 0.0
    assert snap["plan_cache"]["hit_rate"] == 0.0
    assert snap["execution"]["spill_bytes"] == 0
    json.dumps(snap)


def test_metrics_registry_aggregation():
    out = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        reg = P["metrics"].MetricsRegistry()
        led = P["tel"].KernelLedger()
        led.record("join_expand", P["backend"], 0.002)
        led.record("gather_emit", "cuda" if pkg == "port" else "pallas", 0.001)
        reg.observe_request(0.010, n_rows=5, ledger=led, pool_delta={"allocations": 3}, ts=0.0)
        reg.observe_request(0.020, n_rows=2, ledger=led, pool_delta={"allocations": 1}, ts=0.0)
        reg.observe_plan_cache(False)
        reg.observe_plan_cache(True)
        reg.observe_plan_cache(True)
        snap = reg.snapshot()
        assert snap["requests"]["count"] == 2 and snap["requests"]["rows"] == 7
        assert snap["requests"]["p99_ms"] >= snap["requests"]["p50_ms"] > 0
        assert snap["plan_cache"] == {"hits": 2, "misses": 1, "hit_rate": 0.6667}
        assert snap["kernels"]["dispatches"] == {"join_expand": 2, "gather_emit": 2}
        assert snap["pool"]["allocations"] == 4
        json.loads(reg.to_json())
        out[pkg] = {k: v for k, v in snap.items() if k not in ("uptime_s", "kernels")}
    assert out["port"] == out["ref"]
    assert PMetrics.MetricsRegistry().snapshot()["kernels"].keys() == {
        "dispatches", "host_ms", "by_backend", "by_backend_host_ms"}


def test_latency_histogram_buckets_and_merge():
    for pkg in PKGS:
        h = PKGS[pkg]["metrics"].LatencyHistogram()
        for v in (0.0004, 0.003, 99.0):
            h.observe(v)
        cum = dict(h.cumulative())
        assert cum["0.0005"] == 1 and cum["0.005"] == 2 and cum["+Inf"] == 3
        other = PKGS[pkg]["metrics"].LatencyHistogram()
        other.merge_snapshot(h.snapshot())
        other.merge_snapshot(h.snapshot())
        assert other.count == 6 and dict(other.cumulative())["+Inf"] == 6
        assert other.sum == pytest.approx(2 * h.sum)


def test_validate_openmetrics_catches_tampering():
    texts = {}
    for pkg in PKGS:
        M = PKGS[pkg]["metrics"]
        reg = M.MetricsRegistry()
        reg.observe_request(0.01, n_rows=3)
        text = reg.to_openmetrics()
        assert "barq_requests" in M.validate_openmetrics(text)
        for tamper, msg in [
            (text.replace("# EOF\n", ""), "EOF"),
            (text.replace("barq_requests_total", "barq_requests"), "_total"),
            ("barq_orphan 1\n# EOF\n", "TYPE"),
            (text + "# EOF\n", "exactly once"),
            (text.replace("\nbarq_qps ", "\nbarq_qps_total "), "suffixed"),
        ]:
            with pytest.raises(ValueError, match=msg):
                M.validate_openmetrics(tamper)
        with pytest.raises(ValueError):
            M.validate_openmetrics(text.replace('le="+Inf"} ', 'le="+Inf"} -'))
        texts[pkg] = M.validate_openmetrics(text)
    assert texts["port"] == texts["ref"]


# ---------------------------------------------------------------------------
# threaded trace isolation
# ---------------------------------------------------------------------------


def test_trace_query_threads_do_not_leak_dispatches():
    """Two threads tracing concurrently each see only their own kernel
    dispatches, through the port's kernel wrappers as well."""
    from repro_torch.kernels import radix_partition as KRP

    results = {}
    barrier = threading.Barrier(2)
    keys = torch.arange(64, dtype=torch.int32)

    def worker(name, n):
        tr = telemetry.QueryTrace(name)
        barrier.wait()
        with telemetry.trace_query(trace=tr):
            for _ in range(n):
                telemetry.record_dispatch(f"k_{name}", "plain", time.perf_counter(), 1e-6)
                if name == "beta":
                    KRP.radix_partition(keys, 4)
                time.sleep(0.001)
        results[name] = tr.ledger

    t1 = threading.Thread(target=worker, args=("alpha", 7))
    t2 = threading.Thread(target=worker, args=("beta", 11))
    t1.start(); t2.start(); t1.join(); t2.join()  # noqa: E702
    assert dict(results["alpha"].counts) == {"k_alpha": 7}
    assert dict(results["beta"].counts) == {"k_beta": 11, "radix_partition": 11}


# ---------------------------------------------------------------------------
# report tooling
# ---------------------------------------------------------------------------


def test_report_metrics_and_workload_tables(tmp_path):
    outs = {}
    for pkg in PKGS:
        P = PKGS[pkg]
        reg = P["metrics"].MetricsRegistry()
        led = P["tel"].KernelLedger()
        led.record("gather_emit", P["backend"], 0.001)
        reg.observe_request(0.01, n_rows=5, ledger=led, pool_delta={"allocations": 2})
        reg.observe_plan_cache(True)
        mpath = str(tmp_path / f"{pkg}_metrics.json")
        reg.save(mpath)
        out = P["report"].metrics_report(mpath)
        assert "requests: 1" in out and f"gather_emit/{P['backend']}" in out
        assert "1.000" in out  # the kernel's milliseconds reach the table

        repo = P["repo"].WorkloadRepository()
        for i in range(20):
            repo.observe("fp-slow", 0.02, rows=10, max_q_error=8.0,
                         query_text="SELECT ?a { ?a :p ?b }", ts=float(i))
        repo.observe("fp-slow", 0.2, ts=30.0)
        wpath = str(tmp_path / f"{pkg}_wl.jsonl")
        repo.save(wpath)
        out = P["report"].workload_report(wpath)
        assert "fp-slow" in out and "q-error leaderboard" in out
        assert "latency regressions" in out
        outs[pkg] = out
    assert outs["port"] == outs["ref"]
    tr = telemetry.QueryTrace("t")
    tr.ledger.record("hash_probe", "cuda", 0.002)
    assert "hash_probe" in PReport.kernel_table(tr.ledger)
    assert PReport.span_table(tr) == "  (no spans)"


# ---------------------------------------------------------------------------
# a served stream against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_stores():
    bref, meta = ref_ecommerce(scale=0.05, seed=7)
    lref, _ = ref_social(scale=0.05, seed=42)
    return {"bsbm": _stores(bref), "lsqb": _stores(lref)}, meta


def _om_labels(text, label):
    import re

    return {m.group(1) for m in re.finditer(label + r'="([^"]*)"', text)}


def _keyset(d, path=""):
    """The snapshot's nested key paths (per-fingerprint, per-kernel and
    per-event dicts stop at their parent: their keys are data)."""
    out = set()
    for k, v in d.items():
        p = f"{path}/{k}"
        out.add(p)
        if isinstance(v, dict) and k not in ("kernels", "pool", "buckets"):
            out |= _keyset(v, p)
    return out


@pytest.mark.parametrize("cfg", [{}, {"join_strategy": "merge", "sip": "off"},
                                 {"cardinality_feedback": "apply"}],
                         ids=["default", "merge-off", "feedback-apply"])
def test_served_stream_matches_reference(stream_stores, cfg):
    stores, meta = stream_stores
    stream = build_requests(meta, 30, seed=3, lsqb_share=0.2)
    assert sum(s == "lsqb" for _, _, s in stream) == 6
    res, servers = {}, {}
    for pkg in PKGS:
        C = PKGS[pkg]["config"]
        servers[pkg] = {name: _server(pkg, stores[name][pkg], C(**cfg)) for name in stores}
        if pkg == "port":
            stats, res[pkg] = serve_stream(servers[pkg], stream, warmup=3)
            assert stats["n_requests"] == 27
        else:
            res[pkg] = [servers[pkg][s].execute(k, t) for k, t, s in stream]
    port, ref = res["port"], res["ref"]
    assert [r.n_rows for r in port] == [r.n_rows for r in ref]
    assert [r.fingerprint for r in port] == [r.fingerprint for r in ref]
    assert [r.plan_cache_hit for r in port] == [r.plan_cache_hit for r in ref]
    assert [r.pool_delta for r in port] == [r.pool_delta for r in ref]
    assert [r.max_q_error for r in port] == [r.max_q_error for r in ref]
    assert sum(r.n_rows for r in port) > 0
    for name in stores:
        p, r = servers["port"][name], servers["ref"][name]
        pw, rw = p.workload.snapshot(), r.workload.snapshot()
        for k in ("fingerprints", "evicted", "feedback_entries"):
            assert pw[k] == rw[k], (name, k)

        def counts(w):
            return {s["fingerprint"]: (s["n"], s["rows"]) for s in w["top_by_wall"]}

        assert counts(pw) == counts(rw)
        ps, rs = p.metrics_snapshot(), r.metrics_snapshot()
        assert _keyset(ps) == _keyset(rs)
        assert ps["plan_cache"] == rs["plan_cache"] and ps["pool"] == rs["pool"]
        assert ps["requests"]["rows"] == rs["requests"]["rows"]
        # the port names its kernel times host_ms: they are host time
        assert {k.replace("host_ms", "wall_ms") for k in ps["kernels"]} == set(rs["kernels"])
        pom, rom = p.openmetrics(), r.openmetrics()
        assert PMetrics.validate_openmetrics(pom) == RMetrics.validate_openmetrics(rom)
        ref_backends = {"plain" if b == "numpy" else b for b in _om_labels(rom, "backend")}
        assert _om_labels(pom, "backend") == ref_backends <= {"plain"}
        assert _om_labels(pom, "fingerprint") == _om_labels(rom, "fingerprint")
        assert _om_labels(pom, "event") == _om_labels(rom, "event")
    # the registries hold every dispatch of the requests, kernel by kernel
    for pkg in ("port",):
        total = {}
        for r in res[pkg]:
            for k, v in r.trace.ledger.counts.items():
                total[k] = total.get(k, 0) + v
        reg = {}
        for srv in servers[pkg].values():
            for k, v in srv.metrics.kernels.counts.items():
                reg[k] = reg.get(k, 0) + v
        assert reg == total and sum(reg.values()) == sum(r.kernel_dispatches for r in res[pkg])


def test_served_rows_equal_a_bare_engine(stream_stores):
    stores, meta = stream_stores
    stream = build_requests(meta, 12, seed=5)
    srv = {name: _server("port", stores[name]["port"]) for name in stores}
    bare = {name: repro_torch.Engine(stores[name]["port"], device="cpu") for name in stores}
    for (key, text, store), r in zip(stream, serve_stream(srv, stream)[1]):
        want = bare[store].execute(text).rows
        assert sorted(map(tuple, r.rows.tolist())) == sorted(map(tuple, want.tolist())), key


def test_engines_share_a_stores_planner_statistics(stream_stores):
    stores, _ = stream_stores
    lsqb, bsbm = stores["lsqb"]["port"], stores["bsbm"]["port"]
    shared = GraphStats(lsqb)
    own = repro_torch.Engine(lsqb, device="cpu")
    srv = PServer.QueryServer(lsqb, device="cpu", stats=shared)
    assert srv.engine.stats is shared and own.stats is not shared
    for name in ("q1", "q4", "q5"):
        text = repro_torch.LSQB_QUERIES[name]
        assert srv.engine.explain(text) == own.explain(text), name
        got = srv.execute(name, text).rows
        assert got.tolist() == own.execute(text).rows.tolist(), name
    with pytest.raises(ValueError, match="another store"):
        repro_torch.Engine(bsbm, device="cpu", stats=shared)


# ---------------------------------------------------------------------------
# build_requests and the entry point
# ---------------------------------------------------------------------------


def test_build_requests_mix_is_seeded():
    _, meta = ref_ecommerce(scale=0.05, seed=7)
    a = build_requests(meta, 100, seed=42)
    assert a == build_requests(meta, 100, seed=42) != build_requests(meta, 100, seed=43)
    kinds = [s for _, _, s in a]
    assert kinds.count("lsqb") == 20 and kinds.count("bsbm") == 80
    lsqb = [k for k, _, s in a if s == "lsqb"]
    assert lsqb[:6] == ["lsqb_q1", "lsqb_q4", "lsqb_q5"] * 2
    assert {k.split("_")[1] for k, _, s in a if s == "bsbm"} <= {"e1", "e2", "e3", "e4", "e5"}
    assert all("%" not in t for _, t, _ in a)


def test_serve_entry_point_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "20",
         "--scale", "0.05", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    line = next(x for x in out.stdout.splitlines() if x.startswith("query serving:"))
    for key in ("n_requests", "total_rows", "qps", "mean_ms", "p50_ms", "p99_ms",
                "kernel_dispatches", "kernel_wall_ms", "plan_cache_hit_rate"):
        assert f"'{key}'" in line, key
    assert "'n_requests': 18" in line
    assert "device: cpu" in out.stdout
