"""The port's query telemetry (``repro_torch.core.telemetry``), per-operator
statistics and EXPLAIN ANALYZE against the JAX package's, on the CPU.

The same stores and queries go through both packages: the scoped kernel
ledger (global and per-query, nested dispatches, interleaved queries, no
leak out of the context), q-error, EXPLAIN ANALYZE's estimates against the
actual rows under the three engines, ``collect_stats``' aggregation rules
and pool deltas, the trace's spans and Chrome export, telemetry off, and
the adaptive join's decision in the report. On LSQB scale 1 every operator
of q1-q9 must carry the reference's name, estimate, node fingerprint and
actual rows. Two guards hold the port's own design: no operator overrides
the wrapped public methods, and telemetry adds no host read per batch.
"""

import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import profiler as RProf  # noqa: E402
from repro.core import telemetry as RTel  # noqa: E402
from repro.core.executor import Translator as RTranslator  # noqa: E402
from repro.core.operators.base import BatchOperator as RBatchOp  # noqa: E402
from repro.data.lsqb import LSQB_QUERIES  # noqa: E402
from repro.data.lsqb import generate_social_graph as ref_social_graph  # noqa: E402
from repro.kernels import ops as KOPS  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import profiler as PProf  # noqa: E402
from repro_torch.core.batch import BatchPool, ColumnBatch  # noqa: E402
from repro_torch.core.executor import Translator  # noqa: E402
from repro_torch.core.legacy.operators import RowOperator  # noqa: E402
from repro_torch.core.operators.base import BatchOperator  # noqa: E402
from repro_torch.kernels import hash_join as KHJ  # noqa: E402
from repro_torch.kernels import sorted_search as KSS  # noqa: E402

CPU = torch.device("cpu")


def _chain_store(n=60):
    store = RStore()
    for i in range(n):
        store.add(f":p{i}", ":knows", f":p{(i * 7 + 1) % n}")
        store.add(f":p{i}", ":age", 20 + i % 30)
    return store.build()


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


@pytest.fixture(scope="module")
def chain():
    ref = _chain_store()
    return ref, _port_store(ref)


def _engines(chain, **cfg):
    ref_store, port_store = chain
    return (REngine(ref_store, RConfig(**cfg)),
            repro_torch.Engine(port_store, repro_torch.EngineConfig(**cfg), device="cpu"))


def _walk(op):
    yield op
    for c in op.children():
        yield from _walk(c)


# ---------------------------------------------------------------------------
# the scoped kernel ledger
# ---------------------------------------------------------------------------


def test_global_ledger_semantics():
    """The process-global ledger counts every dispatch, traced or not, by
    kernel and by backend, with host seconds, and clears; the kernels'
    launch counters count CUDA launches only, so a plain call leaves them."""
    keys = np.arange(100, dtype=np.int64)
    q = np.array([5, 50], dtype=np.int64)
    rled, led = RTel.global_ledger(), telemetry.global_ledger()
    KOPS.reset_dispatch_counts()
    led.clear()
    before = KSS.launches
    KOPS.sorted_search(keys, q)
    KSS.sorted_search(torch.from_numpy(keys.astype(np.int32)),
                      torch.from_numpy(q.astype(np.int32)))
    assert KSS.launches == before
    assert rled.counts["sorted_search"] == led.counts["sorted_search"] == 1
    assert led.backend_counts[("sorted_search", "plain")] == 1
    assert led.wall_s["sorted_search"] > 0 and led.total() == 1
    assert set(led.snapshot()) == {"dispatches", "host_ms", "by_backend", "by_backend_host_ms"}
    led.clear()
    KOPS.reset_dispatch_counts()
    assert led.total() == rled.total() == 0 and not led.wall_s


def test_nested_dispatches_tick_both():
    """hash_build dispatches radix_partition inside it: the partition lands
    in the trace's ledger and in the global one, in both packages."""
    KOPS.reset_dispatch_counts()
    telemetry.global_ledger().clear()
    hi = np.zeros(64, dtype=np.uint64)
    lo = np.arange(64, dtype=np.uint64)
    with RTel.trace_query("nested") as rtr:
        KOPS.hash_build(hi, lo, 4)
    with telemetry.trace_query("nested") as tr:
        KHJ.hash_build(None, torch.arange(64, dtype=torch.int32), 4)
    for led in (rtr.ledger, RTel.global_ledger(), tr.ledger, telemetry.global_ledger()):
        assert led.counts["radix_partition"] == 1
    assert tr.ledger.backend_counts == {("radix_partition", "plain"): 1}
    assert [e[:2] for e in tr._kernels] == [("radix_partition", "plain")]


@pytest.mark.parametrize("package", ["reference", "port"])
def test_interleaved_queries_attribute_exactly(chain, package):
    """Two queries interleaved batch by batch through one process attribute
    every dispatch to their own trace, and the global ledger sees the sum."""
    q = "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x . FILTER(?x > 25) }"
    kw = dict(initial_batch=32, max_batch=32, adaptive_batching=False, telemetry=False)
    ref_eng, port_eng = _engines(chain, **kw)
    if package == "reference":
        tel, eng, led = RTel, ref_eng, RTel.global_ledger()
        KOPS.reset_dispatch_counts()

        def build():
            return RTranslator(eng.store, eng.cfg).translate(eng.plan(eng.parse(q)[0]))
    else:
        tel, eng, led = telemetry, port_eng, telemetry.global_ledger()
        led.clear()

        def build():
            return Translator(eng.store, eng.cfg, CPU).translate(eng.plan(eng.parse(q)[0]))

    solo = build()
    with tel.trace_query("solo") as tr_solo:
        while solo.next_batch() is not None:
            pass
    expected = dict(tr_solo.ledger.counts)
    assert expected, "the query dispatched no kernel"
    led.clear()
    op_a, op_b = build(), build()
    tr_a, tr_b = tel.QueryTrace("qa"), tel.QueryTrace("qb")
    done_a = done_b = False
    while not (done_a and done_b):
        if not done_a:
            with tel.trace_query(trace=tr_a):
                done_a = op_a.next_batch() is None
        if not done_b:
            with tel.trace_query(trace=tr_b):
                done_b = op_b.next_batch() is None
    assert dict(tr_a.ledger.counts) == dict(tr_b.ledger.counts) == expected
    assert dict(led.counts) == {k: 2 * v for k, v in expected.items()}
    assert tr_a.ledger.total_wall_s() > 0 and tr_b.ledger.total_wall_s() > 0


def test_trace_context_does_not_leak():
    telemetry.global_ledger().clear()
    with telemetry.trace_query("scoped") as tr:
        assert telemetry.current_trace() is tr
    assert telemetry.current_trace() is None
    KSS.sorted_search(torch.arange(8, dtype=torch.int32), torch.tensor([3], dtype=torch.int32))
    assert tr.ledger.counts["sorted_search"] == 0
    assert telemetry.global_ledger().counts["sorted_search"] == 1


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE, collect_stats, the pool line
# ---------------------------------------------------------------------------


def test_q_error_and_formatting_match_reference():
    for est, act in ((10, 10), (100, 10), (10, 100), (0, 0), (0, 8), (5.5, 1e6)):
        assert PProf.q_error(est, act) == RProf.q_error(est, act)
    for v in (3.141592653589793, 0.5, 123456.0, 42, 2_000_000, 0, 1e10):
        assert PProf._fmt_extra(v) == RProf._fmt_extra(v)
        assert PProf._fmt_count(v) == RProf._fmt_count(v)
        assert PProf._fmt_bytes(v) == RProf._fmt_bytes(v)
    assert PProf.QERROR_FLAG == RProf.QERROR_FLAG


@pytest.mark.parametrize("engine", ["barq", "mixed", "legacy"])
def test_explain_analyze_est_vs_actual(chain, engine):
    """The estimates travel planner -> plan -> OpStats -> report in every
    engine as in the reference; the COUNT(*)'s estimate against its one
    row is flagged."""
    ref, port = _engines(chain, engine=engine)
    q = "SELECT (COUNT(*) AS ?c) { ?a :knows ?b }"
    rres, res = ref.execute(q), port.execute(q)
    assert res.n_rows == rres.n_rows == 1
    got = [(o.stats.name, o.stats.est_rows, o.stats.results) for o in _walk(res.root)]
    want = [(o.stats.name, o.stats.est_rows, o.stats.results) for o in _walk(rres.root)]
    assert got == want and any(e is not None for _, e, _ in got)
    report = res.explain_analyze()
    assert "est:" in report and "MISEST" in report
    assert "MISEST" not in res.profile()
    assert "est:" in port.explain_analyze("SELECT ?a { ?a :age ?x }")


class _Stub(BatchOperator):
    def __init__(self, name, children=(), **extra):
        super().__init__(name)
        self._kids = list(children)
        self.stats.extra.update(extra)

    def children(self):
        return self._kids


class _RStub(RBatchOp):
    def __init__(self, name, children=(), **extra):
        super().__init__(name)
        self._kids = list(children)
        self.stats.extra.update(extra)

    def children(self):
        return self._kids


def _stub_tree(cls):
    leaf1 = cls("L1", frontier_peak=10, dedup_in=100, dedup_out=50, dedup_ratio=0.5,
                rounds=3, seg_ms=3.141592653589793)
    leaf2 = cls("L2", frontier_peak=40, dedup_in=100, dedup_out=25, dedup_ratio=0.25,
                rounds=2, big_float=123456.0)
    root = cls("R", children=[leaf1, leaf2])
    root.stats.results = 7
    root.stats.est_rows = 70.0  # q = 10
    return root


def test_collect_stats_rules_and_report_match_reference():
    """*_peak keys take the max, *_ratio keys are recomputed, the rest add
    up; max_q_error summarizes; the report prints floats at 2 decimals."""
    agg, ragg = PProf.collect_stats(_stub_tree(_Stub)), RProf.collect_stats(_stub_tree(_RStub))
    assert agg == ragg
    assert agg["frontier_peak"] == 40 and agg["rounds"] == 5
    assert agg["dedup_ratio"] == 0.375 and agg["max_q_error"] == 10.0
    assert agg["operators"] == 3
    out = PProf.profile_tree(_stub_tree(_Stub), analyze=True)
    assert "seg_ms: 3.14" in out and "big_float: 123.5K" in out
    assert "3.141592653589793" not in out and "MISEST(q=10.0)" in out


def test_collect_stats_pool_base_delta():
    pool = BatchPool(CPU)
    pool.acquire(2, 32)
    base = dict(pool.stats())
    pool.acquire(2, 64)
    agg = PProf.collect_stats(_Stub("Leaf"), pool=pool, pool_base=base)
    assert agg["pool_allocations"] == 1 and agg["pool_bytes_allocated"] == 2 * 64 * 4 + 64
    assert set(k for k in agg if k.startswith("pool_")) == {
        "pool_allocations", "pool_reuses", "pool_releases", "pool_bytes_allocated",
        "pool_bytes_copied"}


def test_shared_engine_pool_delta_per_query(chain):
    """The second query's report holds its own pool traffic only: the warm
    arena allocates nothing on the repeat, as in the reference."""
    ref, port = _engines(chain)
    q = "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x . FILTER(?x > 25) }"
    r1, r2 = port.execute(q), port.execute(q)
    rr1, rr2 = ref.execute(q), ref.execute(q)
    assert r1.pool is r2.pool
    d1, d2 = r1.pool_delta(), r2.pool_delta()
    assert d1["allocations"] > 0 and d2["allocations"] == 0 and d2["reuses"] > 0
    assert rr1.pool_delta()["allocations"] > 0 and rr2.pool_delta()["allocations"] == 0
    assert d1["releases"] == d2["releases"]
    cum = r2.pool.stats()
    for k in ("allocations", "reuses", "releases", "bytes_allocated", "bytes_copied"):
        assert d1[k] + d2[k] == cum[k], k
    line1, line2 = r1.profile().splitlines()[0], r2.profile().splitlines()[0]
    assert line1.startswith("pool:") and line2.startswith("pool:")
    assert "alloc: 0" in line2 and "alloc: 0" not in line1


def test_fresh_engine_first_query_delta_is_absolute(chain):
    _, port = _engines(chain)
    r = port.execute("SELECT ?a { ?a :age ?x }")
    assert r.pool_delta() == r.pool.stats()


POOL_QUERIES = (
    "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x . FILTER(?x > 25) }",
    "SELECT ?a { ?a :age ?x }",
    "SELECT ?a (COUNT(?b) AS ?n) { ?a :knows ?b } GROUP BY ?a",
    "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x . FILTER(?x > 25) }",
)


def test_pool_delta_equals_reference_key_for_key(chain):
    """The same queries on one shared engine in each package: each query's
    pool_delta() dict, the profile's pool: line and collect_stats' pool_*
    entries equal the reference's, key for key and value for value."""
    ref, port = _engines(chain)
    for q in POOL_QUERIES:
        res, rres = port.execute(q), ref.execute(q)
        assert res.pool_delta() == rres.pool_delta(), q
        assert res.profile().splitlines()[0] == rres.profile().splitlines()[0], q
        agg = PProf.collect_stats(res.root, pool=res.pool_final, pool_base=res.pool_base)
        ragg = RProf.collect_stats(rres.root, pool=rres.pool_final, pool_base=rres.pool_base)
        assert ({k: v for k, v in agg.items() if k.startswith("pool_")}
                == {k: v for k, v in ragg.items() if k.startswith("pool_")}), q


# ---------------------------------------------------------------------------
# the trace's spans and Chrome export, telemetry off
# ---------------------------------------------------------------------------


def test_query_trace_spans_and_chrome_export(chain, tmp_path):
    ref, port = _engines(chain)
    q = "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x }"
    res, rres = port.execute(q), ref.execute(q)
    tr = res.trace
    assert [s[0] for s in tr.spans] == [s[0] for s in rres.trace.spans] == [
        "parse", "plan", "translate", "execute"]
    assert all(s[3] >= 0 for s in tr.spans)
    assert tr.ledger.total() > 0 and len(tr._kernels) == tr.ledger.total()
    path = tmp_path / "trace.json"
    tr.save_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    rdoc = rres.trace.to_chrome_trace()
    assert set(doc) == set(rdoc)
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {m["args"]["name"] for m in metas} == {"query", "kernels", "operators"}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert xs and all({"name", "ts", "dur", "pid", "tid"} <= set(e) for e in xs)
    assert all(e["dur"] >= 0 for e in xs)
    assert {"query", "kernel", "operator"} <= {e.get("cat") for e in xs}
    ops = [e["name"] for e in xs if e["cat"] == "operator"]
    rops = [e["name"] for e in rdoc["traceEvents"] if e.get("cat") == "operator"]
    assert [n.split("(")[0] for n in ops] == [n.split("(")[0] for n in rops]
    exec_span = next(e for e in xs if e["name"] == "execute")
    root_ev = max((e for e in xs if e["cat"] == "operator"), key=lambda e: e["dur"])
    assert root_ev["dur"] <= exec_span["dur"] * 1.5 + 1e3
    summ = tr.summary()
    assert summ["spans_ms"]["execute"] > 0 and summ["kernels"]["dispatches"]


def test_telemetry_off_skips_tracing(chain):
    _, port = _engines(chain, telemetry=False)
    res = port.execute("SELECT ?a ?b { ?a :knows ?b . ?b :age ?x . FILTER(?x > 25) }")
    assert res.trace is None and res.pool_delta()
    # the statistics stay exact: counts left on the device settle on read
    rres = REngine(_chain_store(), RConfig(telemetry=False)).execute(
        "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x . FILTER(?x > 25) }")
    assert [o.stats.results for o in _walk(res.root)] == [
        o.stats.results for o in _walk(rres.root)]


# ---------------------------------------------------------------------------
# the adaptive join's decision in the report
# ---------------------------------------------------------------------------


def _adaptive_store(n=3000, seed=7):
    rng = np.random.RandomState(seed)
    store = RStore()
    for i in range(n):
        store.add(f":s{i:05d}", ":knows", f":o{rng.randint(0, 400):05d}")
    for i in range(n * 2 // 3):
        store.add(f":t{i:05d}", ":likes", f":o{rng.randint(0, 400):05d}")
        store.add(f":t{i:05d}", ":age", int(rng.randint(0, 100)))
    return store.build()


def _force_misestimate(phys, est=10.0):
    import dataclasses

    for f in dataclasses.fields(phys):
        v = getattr(phys, f.name)
        if hasattr(v, "est_rows") and dataclasses.is_dataclass(v):
            _force_misestimate(v, est)
    if type(phys).__name__ == "PMergeJoin" and type(phys.right).__name__ == "PSort":
        phys.right.est_rows = est


def test_adaptive_join_switch_visible_in_profile_tree():
    """An AdaptiveMergeJoin whose build was estimated at 5 rows switches to
    hash; the report shows the decision and the chosen inner operator, in
    the same words as the reference's."""
    from repro.core.operators.adaptive_join import AdaptiveMergeJoin as RAdaptive
    from repro.core.operators.sort import MaterializedSource as RSource

    from repro_torch.core.operators.adaptive_join import AdaptiveMergeJoin
    from repro_torch.core.operators.sort import MaterializedSource

    rng = np.random.RandomState(2)
    n = 8000
    l = np.stack([np.sort(rng.randint(0, 2000, n)), rng.randint(0, 100, n)]).astype(np.int32)
    r = np.stack([rng.randint(0, 2000, n // 2), rng.randint(0, 100, n // 2)]).astype(np.int32)
    ref = RAdaptive(RSource((0, 1), l, 0), RSource((0, 2), r), 0, est_build=5.0)
    port = AdaptiveMergeJoin(MaterializedSource((0, 1), torch.from_numpy(l), 0),
                             MaterializedSource((0, 2), torch.from_numpy(r)), 0, CPU,
                             est_build=5.0)
    ref.drain()
    while port.next_batch() is not None:
        pass
    rep, rrep = PProf.profile_tree(port), RProf.profile_tree(ref)
    for text in (rep, rrep):
        assert "adaptive_switch" in text and "-> hash" in text and "HashJoin" in text
    assert [line.split(",")[0] for line in rep.splitlines()] == [
        line.split(",")[0] for line in rrep.splitlines()]
    assert port.stats.results == ref.stats.results


@pytest.mark.parametrize("forced", [False, True], ids=["as planned", "forced misestimate"])
def test_adaptive_join_decision_in_explain_analyze(forced):
    ref_store = _adaptive_store()
    cfg = dict(join_strategy="merge", adaptive_join="on")
    ref = REngine(ref_store, RConfig(**cfg))
    port = repro_torch.Engine(_port_store(ref_store), repro_torch.EngineConfig(**cfg),
                              device="cpu")
    q = "SELECT ?a ?x ?g { ?a :knows ?x . ?b :likes ?x . ?b :age ?g }"
    out = {}
    for name, eng in (("ref", ref), ("port", port)):
        node, vt = eng.parse(q)
        phys = eng.plan(node)
        if forced:
            _force_misestimate(phys)
        out[name] = eng.execute_plan(phys, vt)
    assert Counter(map(tuple, out["port"].rows.tolist())) == Counter(
        map(tuple, out["ref"].rows.tolist()))
    analyze = out["port"].explain_analyze()
    assert "adaptive_switches" in analyze
    assert ("-> hash" in analyze) == forced == ("-> hash" in out["ref"].explain_analyze())
    if forced:
        assert "HashJoin" in analyze  # the chosen inner operator is in the tree


# ---------------------------------------------------------------------------
# LSQB scale 1: every operator against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lsqb1():
    ref_store, _ = ref_social_graph(scale=1.0, seed=42)
    return ref_store, _port_store(ref_store)


def _op_rows(root):
    return [(o.stats.name, o.stats.est_rows, o.stats.est_source, o.stats.node_fp,
             o.stats.results) for o in _walk(root)]


@pytest.mark.parametrize("name", sorted(LSQB_QUERIES))
def test_lsqb_operator_stats_match_reference(lsqb1, name):
    """Under the default configuration each operator, in pre-order, carries
    the reference's name, estimate (and its source), node fingerprint and
    actual output rows. Rows are counted as active rows, which batch
    boundaries do not change, so every count is compared whole."""
    ref_store, port_store = lsqb1
    text = LSQB_QUERIES[name]
    ref = REngine(ref_store, RConfig()).execute(text)
    port = repro_torch.Engine(port_store, device="cpu").execute(text)
    assert _op_rows(port.root) == _op_rows(ref.root)
    node = repro_torch.Engine(port_store, device="cpu").parse(text)[0]
    rnode = REngine(ref_store).parse(text)[0]
    assert telemetry.query_fingerprint(node) == RTel.query_fingerprint(rnode)


# ---------------------------------------------------------------------------
# the port's own guards: the hooks and the sync rule
# ---------------------------------------------------------------------------


def _subclasses(cls):
    for sub in cls.__subclasses__():
        yield sub
        yield from _subclasses(sub)


def test_no_operator_overrides_the_wrapped_methods():
    """Every operator class of the port implements the hooks, never the
    public methods the statistics wrap: an override would run without
    counting next/skip calls, wall time or rows."""
    import importlib
    import pkgutil

    import repro_torch.core as core

    for mod in pkgutil.walk_packages(core.__path__, "repro_torch.core."):
        importlib.import_module(mod.name)
    checked = 0
    for base, wrapped in ((BatchOperator, ("next_batch", "skip", "reset")),
                          (RowOperator, ("next_row", "skip", "reset"))):
        for cls in _subclasses(base):
            if not cls.__module__.startswith("repro_torch."):
                continue
            checked += 1
            for meth in wrapped:
                assert getattr(cls, meth) is getattr(base, meth), (
                    f"{cls.__module__}.{cls.__name__} overrides {meth}")
    assert checked >= 30


class _HostReads(torch.overrides.TorchFunctionMode):
    """Counts reads of device values on the host: Tensor.item / tolist and
    the conversions to Python numbers and truth values."""

    READS = {"item", "tolist", "__int__", "__bool__", "__float__", "__index__"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.READS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def sync_stores():
    out = {}
    for scale in (0.1, 0.2):
        ref, _ = ref_social_graph(scale=scale, seed=42)
        out[scale] = _port_store(ref)
    return out


def _bare_next(op):
    return op._next()


@pytest.mark.parametrize("name", ["q1", "q2", "q4", "q6"])
def test_telemetry_adds_no_host_read_per_batch(sync_stores, name, monkeypatch):
    """The query drained three ways, counting the host reads of device
    values (n_active, item, tolist, int, bool, float, index): with the
    operators' statistics wrapper bypassed (the baseline), with telemetry
    off and with it on. On two store sizes, whatever their batches, the
    statistics add no read and telemetry adds the same small number."""
    real = ColumnBatch.n_active
    wrapped = BatchOperator.next_batch
    seen = {"n_active": 0}

    def counted(b):
        seen["n_active"] += 1
        return real.fget(b)

    monkeypatch.setattr(ColumnBatch, "n_active", property(counted))
    added, batches = {}, {}
    for scale, store in sync_stores.items():
        reads = {}
        for mode in ("baseline", "off", "on"):
            monkeypatch.setattr(BatchOperator, "next_batch",
                                _bare_next if mode == "baseline" else wrapped)
            eng = repro_torch.Engine(store, repro_torch.EngineConfig(
                telemetry=mode == "on", initial_batch=32, max_batch=256), device="cpu")
            eng.execute(LSQB_QUERIES[name])  # the arena's first use left out
            seen["n_active"] = 0
            with _HostReads() as host:
                res = eng.execute(LSQB_QUERIES[name])
            reads[mode] = host.n + seen["n_active"]
            if mode == "on":
                batches[scale] = sum(o.stats.batches for o in _walk(res.root))
        added[scale] = (reads["off"] - reads["baseline"], reads["on"] - reads["baseline"])
    assert batches[0.2] > batches[0.1]
    assert added[0.1] == added[0.2], (added, batches)
    off, on = added[0.1]
    assert off == 0 and 0 <= on <= 2, (added, batches)


def test_stats_count_rows_without_reading_the_device():
    """An operator's rows: a dense batch adds its host count, a masked one
    one device reduction; nothing is read until the count is settled."""
    from repro_torch.core.operators import base as OB

    st = OB.OpStats("x")
    dense = ColumnBatch.from_columns((0,), [torch.arange(5, dtype=torch.int32)], CPU)
    masked = ColumnBatch.from_columns((0,), [torch.arange(40, dtype=torch.int32)], CPU)
    masked = masked.with_mask(torch.arange(masked.capacity) % 3 == 0)
    assert dense.dense and not masked.dense
    with _HostReads() as mode:
        for _ in range(OB._SLOTS + 3):  # past one fold of the slots
            st.count(dense)
            st.count(masked)
        stats, dev = OB.pending_counts(_Stub("root"))
    assert mode.n == 0 and dev is None and st._results == 5 * (OB._SLOTS + 3)
    assert st.results == (5 + 14) * (OB._SLOTS + 3)

