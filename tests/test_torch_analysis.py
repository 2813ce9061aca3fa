"""The port's correctness tooling (``repro_torch.analysis``) and the config
fields that drive it, against the JAX package's, on the CPU.

The plan verifier is a verbatim copy over the port's verbatim planner: each
corrupted plan of the reference's cases is built the same way in both
packages, and both must report the same diagnostics, raise the same error
class and name the same node. The pool sanitizer poisons device buffers
(here CPU tensors) and tracks ownership on the host: the reference's cases
run against the port, and hardened execution gives the reference's rows
with nothing leaked. ``EngineConfig`` has every field of the reference's;
``sip_backend`` accepts only None (one kernel per device), and
``verify_plans`` / ``sanitize`` default from the environment.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.analysis import plan_verify as RPV  # noqa: E402
from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import planner as RPL  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.analysis import plan_verify as PPV  # noqa: E402
from repro_torch.analysis.sanitize import (  # noqa: E402
    POISON,
    PoolSanitizer,
    SanitizeError,
    SanitizingBatchPool,
)
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import batch as PB  # noqa: E402
from repro_torch.core import planner as PL  # noqa: E402
from repro_torch.core.batch import BatchPool, ColumnBatch  # noqa: E402

CPU = torch.device("cpu")
PKGS = {
    "ref": (REngine, RConfig, RPL, RPV),
    "port": (lambda s, c: repro_torch.Engine(s, c, device="cpu"), repro_torch.EngineConfig,
             PL, PPV),
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


def _tiny_ref_store():
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


@pytest.fixture(scope="module")
def tiny():
    ref = _tiny_ref_store()
    return {"ref": ref, "port": _port_store(ref)}


# ---------------------------------------------------------------------------
# the plan verifier
# ---------------------------------------------------------------------------


VERIFY_QUERIES = (
    "SELECT ?a ?b ?c { ?a :knows ?b . ?b :knows ?c . FILTER(?a != ?c) }",
    "SELECT ?a ?b ?t { ?a :knows ?b . OPTIONAL { ?b :interest ?t } }",
    "SELECT ?a (COUNT(?b) AS ?n) { ?a :knows ?b } GROUP BY ?a",
    "SELECT DISTINCT ?x { { ?x :knows ?y } UNION { ?x :interest ?t } }",
    "SELECT ?a ?b { ?a :knows ?b } ORDER BY ?b LIMIT 5",
)
MERGE_CHAIN = "SELECT ?a ?d { ?a :knows ?b . ?b :knows ?c . ?c :knows ?d }"


def _plan(tiny, pkg, query, **cfg):
    make, config, _, _ = PKGS[pkg]
    e = make(tiny[pkg], config(engine="barq", **cfg))
    node, _ = e.parse(query)
    return e.planner.plan(node)


def _find(pl, plan, cls):
    out = []

    def walk(n):
        if isinstance(n, cls):
            out.append(n)
        for fld in ("child", "left", "right", "probe", "build"):
            c = getattr(n, fld, None)
            if isinstance(c, pl.PhysNode):
                walk(c)

    walk(plan)
    return out


def _outcome(pv, plan):
    """The diagnostics the verifier collects, and the class and message of
    what it raises."""
    diags = [(d.check, d.node, d.message) for d in pv.verify_plan(plan, collect=True)]
    try:
        pv.verify_plan(plan)
        raised = None
    except Exception as e:
        raised = (type(e).__name__, str(e))
    return diags, raised


def _both(tiny, corrupt):
    """``corrupt(tiny, pkg, pl)`` builds a corrupted plan in each package;
    returns the port's outcome after holding it equal to the reference's."""
    out = {}
    for pkg, (_, _, pl, pv) in PKGS.items():
        out[pkg] = _outcome(pv, corrupt(tiny, pkg, pl))
    assert out["port"] == out["ref"]
    return out["port"]


@pytest.mark.parametrize("strategy", [None, "hash", "merge"])
def test_planner_output_verifies_clean(tiny, strategy):
    for q in VERIFY_QUERIES:
        for pkg, (_, _, _, pv) in PKGS.items():
            assert pv.verify_plan(_plan(tiny, pkg, q, join_strategy=strategy),
                                  collect=True) == [], (pkg, q)
        assert (PL.explain(_plan(tiny, "port", q, join_strategy=strategy))
                == RPL.explain(_plan(tiny, "ref", q, join_strategy=strategy)))


def _missing_fp(tiny, pkg, pl):
    plan = _plan(tiny, pkg, "SELECT ?a ?b { ?a :knows ?b }")
    plan.fp = ""
    return plan


def _bad_estimate(tiny, pkg, pl):
    plan = _plan(tiny, pkg, "SELECT ?a ?b { ?a :knows ?b }")
    plan.est_rows = -5.0
    return plan


def _merge_plan(tiny, pkg, pl):
    plan = _plan(tiny, pkg, MERGE_CHAIN, join_strategy="merge")
    joins = _find(pl, plan, pl.PMergeJoin)
    assert joins, "planner no longer picks merge joins for the chain query"
    return plan, joins


def _unbound_join_var(tiny, pkg, pl):
    plan, joins = _merge_plan(tiny, pkg, pl)
    joins[0].var = 9999
    return plan


def _unsorted_merge_input(tiny, pkg, pl):
    plan, joins = _merge_plan(tiny, pkg, pl)
    mj = joins[0]
    for side in ("left", "right"):
        sub = getattr(mj, side)
        if isinstance(sub, pl.PSort):
            setattr(mj, side, sub.child)
        elif isinstance(sub, pl.PScan):
            sub.sort_var = None
    return plan


def _bogus_grace_mark(tiny, pkg, pl):
    plan = _plan(tiny, pkg, "SELECT ?a ?c { ?a :knows ?b . ?b :knows ?c }",
                 join_strategy="hash")
    (hj,) = _find(pl, plan, pl.PHashJoin)[:1]
    hj.grace = True
    hj.grace_parts = 1
    return plan


def _streaming_distinct_over_unsorted(tiny, pkg, pl):
    plan = _plan(tiny, pkg, "SELECT DISTINCT ?a { ?a :knows ?b }")
    (d0,) = _find(pl, plan, pl.PDistinct)[:1]
    child_vars = pl.phys_vars(d0.child)
    d0.streaming_var = child_vars[-1]
    if pl.phys_sorted_by(d0.child) == d0.streaming_var:
        d0.child = pl.PSort(child=d0.child, var=child_vars[0])
        d0.child.fp, d0.child.est_rows = "synthetic", 1.0
        d0.streaming_var = (child_vars[-1] if child_vars[-1] != child_vars[0]
                            else child_vars[0] + 10**6)
    return plan


def _adaptive_under_order_consumer(tiny, pkg, pl):
    plan, joins = _merge_plan(tiny, pkg, pl)
    inner = [j for j in joins if j is not joins[0]]
    assert inner, "planner did not nest merge joins for this shape"
    outer = joins[0]
    for side in ("left", "right"):
        sub = getattr(outer, side)
        if isinstance(sub, pl.PSort) and sub.child is inner[0]:
            setattr(outer, side, inner[0])
    inner[0].adaptive_ok = True
    return plan


def _orphan_sip_consumer(tiny, pkg, pl):
    plan = _plan(tiny, pkg, "SELECT ?a ?b { ?a :knows ?b }")
    scans = _find(pl, plan, pl.PScan)
    scans[0].sip = (pl.PSipFilter(var=scans[0].pattern.vars()[0], sid=999,
                                  source="hash_build"),)
    return plan


@pytest.mark.parametrize("corrupt,check,raises", [
    (_missing_fp, "V-FP", True),
    (_bad_estimate, "V-FP", False),
    (_unbound_join_var, "V-SCHEMA", False),
    (_unsorted_merge_input, "V-SORT", False),
    (_bogus_grace_mark, "V-GRACE", False),
    (_streaming_distinct_over_unsorted, ("V-SORT", "V-SCHEMA"), False),
    (_adaptive_under_order_consumer, "V-ADAPTIVE", False),
    (_orphan_sip_consumer, "V-SIP", True),
], ids=["missing_fingerprint", "bad_estimate", "unbound_join_var", "unsorted_merge_input",
        "bogus_grace_mark", "streaming_distinct_over_unsorted",
        "adaptive_under_order_consumer", "orphan_sip_consumer"])
def test_verify_flags(tiny, corrupt, check, raises):
    """The reference's test_verify_flags_* cases, each corrupted plan built
    alike in both packages: the same diagnostics, error class and node."""
    diags, raised = _both(tiny, corrupt)
    checks = check if isinstance(check, tuple) else (check,)
    assert any(d[0] in checks for d in diags), diags
    if corrupt is _bad_estimate:
        assert any("est_rows" in d[2] for d in diags)
    assert raised is not None and raised[0] == "PlanInvariantError"
    if raises:
        assert checks[0] in raised[1]


def test_verify_error_names_offending_node(tiny):
    _, raised = _both(tiny, _missing_fp)
    assert type(_missing_fp(tiny, "port", PL)).__name__ in raised[1]


def test_engine_runs_verifier_when_configured(tiny):
    """verify_plans runs the verifier in Engine.plan: clean plans execute
    with the reference's rows, a corrupted planner output raises."""
    e = repro_torch.Engine(tiny["port"], repro_torch.EngineConfig(verify_plans=True),
                           device="cpu")
    r = REngine(tiny["ref"], RConfig(verify_plans=True))
    for q in VERIFY_QUERIES:
        got, want = e.execute(q).rows, r.execute(q).rows
        assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, want.tolist())), q
    real = e.planner.plan

    def corrupted(node):
        p = real(node)
        p.fp = ""
        return p

    e.planner.plan = corrupted
    with pytest.raises(PPV.PlanInvariantError, match="V-FP"):
        e.execute("SELECT ?a ?b { ?a :knows ?b }")
    off = repro_torch.Engine(tiny["port"], repro_torch.EngineConfig(verify_plans=False),
                             device="cpu")
    off.planner.plan = corrupted
    assert off.execute("SELECT ?a ?b { ?a :knows ?b }").n_rows > 0


@pytest.mark.parametrize("field,env", [("verify_plans", "BARQ_VERIFY_PLANS"),
                                       ("sanitize", "BARQ_SANITIZE")])
def test_env_var_enables_tooling(monkeypatch, field, env):
    for value, want in (("1", True), ("", False), ("0", False)):
        monkeypatch.setenv(env, value)
        assert getattr(repro_torch.EngineConfig(), field) is want
        assert getattr(RConfig(), field) is want
    monkeypatch.delenv(env)
    assert getattr(repro_torch.EngineConfig(), field) is False


def test_engine_config_has_every_reference_field():
    port = {f.name for f in dataclasses.fields(repro_torch.EngineConfig)}
    ref = {f.name for f in dataclasses.fields(RConfig)}
    assert port == ref
    port_defaults = dataclasses.asdict(repro_torch.EngineConfig())
    assert port_defaults == dataclasses.asdict(RConfig())


@pytest.mark.parametrize("field,value", [
    ("sip_backend", None), ("verify_plans", True), ("sanitize", True),
    ("engine", "legacy"), ("engine", "mixed"), ("join_strategy", "hash"),
    ("join_strategy", "merge"), ("sip", "on"), ("sip", "off"),
    ("adaptive_join", "on"), ("cardinality_feedback", "observe"),
    ("cardinality_feedback", "apply"), ("memory_budget", 1 << 20),
    ("pool_buffers", False), ("telemetry", False),
])
def test_no_reference_value_raises_not_implemented(tiny, field, value):
    q = "SELECT ?a (COUNT(?b) AS ?n) { ?a :knows ?b } GROUP BY ?a"
    got = repro_torch.Engine(tiny["port"], repro_torch.EngineConfig(**{field: value}),
                             device="cpu").execute(q).rows
    want = REngine(tiny["ref"], RConfig(**{field: value})).execute(q).rows
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple, want.tolist()))


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas", "cuda"])
def test_sip_backend_accepts_only_none(tiny, backend):
    with pytest.raises(ValueError, match="sip_backend"):
        repro_torch.Engine(tiny["port"], repro_torch.EngineConfig(sip_backend=backend),
                           device="cpu")


# ---------------------------------------------------------------------------
# the pool sanitizer
# ---------------------------------------------------------------------------


def _san_pool():
    # a private tracker per test: installation is global, so fresh state
    # here keeps tests order-independent
    return SanitizingBatchPool(CPU, sanitizer=PoolSanitizer())


def _col(n):
    return torch.arange(n, dtype=torch.int32)


def test_sanitizer_poisons_released_region():
    pool = _san_pool()
    b = ColumnBatch.from_columns((0,), [_col(8)], CPU, pool=pool)
    cols, mask = b.columns, b.mask
    assert b.capacity == 32
    b.release()
    assert bool((cols[0, :8] == int(POISON)).all()) and bool(mask[:8].all())
    # past n_rows the buffer keeps its NULL fill: only the used region
    assert bool((cols[0, 8:] == -1).all()) and not bool(mask[8:].any())


def test_sanitizer_poisons_only_the_released_view():
    """A buffer that is a view into a larger tensor: the fill writes the
    released region of the view and nothing around it."""
    pool = _san_pool()
    base = torch.full((3, 64), 7, dtype=torch.int32)
    mbase = torch.zeros(64, dtype=torch.bool)
    cols, mask = base[1:2, 16:48], mbase[16:48]
    pool.release(cols, mask, used=5)
    assert bool((base[1, 16:21] == int(POISON)).all()) and bool(mbase[16:21].all())
    base[1, 16:21] = 7
    mbase[16:21] = False
    assert bool((base == 7).all()) and not bool(mbase.any())


def test_sanitizer_use_after_release_names_operator_and_site():
    pool = _san_pool()
    pool.sanitizer.push_op("HashJoinBuild")
    b = ColumnBatch.from_columns((0, 1), [_col(4)] * 2, CPU, pool=pool)
    pool.sanitizer.pop_op()
    b.release()
    with pytest.raises(SanitizeError) as ei:
        b.column(0)
    msg = str(ei.value)
    assert "use-after-released" in msg and "HashJoinBuild" in msg
    assert "test_torch_analysis.py:" in msg  # the creation site
    assert pool.sanitizer.use_after_release_errors == 1


def test_sanitizer_use_after_move():
    pool = _san_pool()
    b = ColumnBatch.from_columns((0,), [_col(6)], CPU, pool=pool)
    m = torch.zeros(b.capacity, dtype=torch.bool)
    m[:3] = True
    b2 = b.with_mask(m)
    with pytest.raises(SanitizeError, match="use-after-moved"):
        b.n_active
    assert b2.n_active == 3
    b2.release()


def test_sanitizer_use_after_sip_move():
    """with_sip_mask MOVEs ownership too."""
    pool = _san_pool()
    b = ColumnBatch.from_columns((0,), [_col(6)], CPU, pool=pool)
    b2 = b.with_sip_mask([(b.columns[0, :6], None, 0, 2)])
    with pytest.raises(SanitizeError, match="use-after-moved"):
        b.selection_vector()
    assert b2.n_active == 3
    b2.release()
    assert pool.leaks() == []


def test_sanitizer_double_release_at_pool_level():
    pool = _san_pool()
    cols, mask = pool.acquire(2, 32)
    pool.release(cols, mask)
    with pytest.raises(SanitizeError, match="double-release"):
        pool.release(cols, mask)
    assert pool.sanitizer.double_release_errors == 1


def test_batch_release_stays_idempotent_under_sanitizer():
    pool = _san_pool()
    b = ColumnBatch.from_columns((0,), [_col(4)], CPU, pool=pool)
    b.release()
    b.release()


def test_sanitizer_reports_leak_at_drain():
    pool = _san_pool()
    b = ColumnBatch.alloc((0,), 32, CPU, pool)
    with pytest.raises(SanitizeError, match="leaked"):
        pool.drain()
    assert len(pool.leaks()) == 1
    b.release()
    assert pool.leaks() == []
    pool.drain()


def test_sanitizer_ignores_plain_pool_batches():
    _san_pool()  # installs the global hook
    assert PB._SANITIZER is not None
    plain = BatchPool(CPU)
    b = ColumnBatch.from_columns((0,), [_col(4)], CPU, pool=plain)
    b.release()
    b.column(0)  # released, but untracked: plain pools keep their semantics


def test_counters_conservation_law():
    pool = BatchPool(CPU, max_per_bucket=1)
    batches = [ColumnBatch.alloc((0,), 32, CPU, pool) for _ in range(3)]
    c = pool.counters()
    assert c["live"] == 3 and c["allocs"] == 3
    for b in batches:
        b.release()
    c = pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"]
    pool.drain()
    c = pool.counters()
    assert c["pooled"] == 0 and c["allocs"] == c["releases"]
    assert set(c) == {"allocs", "releases", "pooled", "live", "acquires", "recycles"}
    assert set(pool.stats()) == {"allocations", "reuses", "releases", "bytes_allocated",
                                 "bytes_copied"}


# ---------------------------------------------------------------------------
# hardened execution
# ---------------------------------------------------------------------------


def _rows(store, query, **cfg):
    e = repro_torch.Engine(store, repro_torch.EngineConfig(**cfg), device="cpu")
    return e, sorted(map(tuple, e.execute(query).rows.tolist()))


def test_sanitize_off_matches_seed_semantics(tiny):
    """sanitize=False runs the plain BatchPool; hardened execution gives the
    same rows, and both the reference's."""
    for q in VERIFY_QUERIES:
        e_plain, plain = _rows(tiny["port"], q, sanitize=False)
        e_hard, hard = _rows(tiny["port"], q, sanitize=True, verify_plans=True)
        assert type(e_plain.pool) is BatchPool
        assert type(e_hard.pool) is SanitizingBatchPool
        want = REngine(tiny["ref"], RConfig(sanitize=True, verify_plans=True)).execute(q).rows
        assert plain == hard == sorted(map(tuple, want.tolist())), q


def test_hardened_execution_leaves_no_leaks(tiny):
    e = repro_torch.Engine(tiny["port"], repro_torch.EngineConfig(
        sanitize=True, verify_plans=True), device="cpu")
    for q in VERIFY_QUERIES:
        e.execute(q)
    assert e.pool.leaks() == []
    c = e.pool.counters()
    assert c["live"] == 0, c
    assert c["allocs"] == c["releases"] + c["pooled"], c


@pytest.mark.parametrize("cfg", [{"join_strategy": "hash", "sip": "on"},
                                 {"join_strategy": "merge", "sip": "on"},
                                 {"memory_budget": 0}],
                         ids=["hash-sip", "merge-sip", "budget-0"])
def test_hardened_lsqb_matches_reference(tmp_path, cfg):
    """LSQB q1-q9 on a small generated store, sanitized: the reference's
    rows, nothing leaked, the pool's counters conserved."""
    from repro.data.lsqb import LSQB_QUERIES
    from repro.data.lsqb import generate_social_graph as ref_social

    ref, _ = ref_social(scale=0.04, seed=3)
    store = _port_store(ref)
    if "memory_budget" in cfg:
        cfg = dict(cfg, spill_dir=str(tmp_path))
    e = repro_torch.Engine(store, repro_torch.EngineConfig(sanitize=True, **cfg),
                           device="cpu")
    r = REngine(ref, RConfig(**cfg))
    for name, q in sorted(LSQB_QUERIES.items()):
        try:
            want = sorted(map(tuple, r.execute(q).rows.tolist()))
        except AssertionError:  # the reference's planner fault under a budget
            with pytest.raises(ValueError, match="sorted by the join var"):
                e.execute(q)
            continue
        assert sorted(map(tuple, e.execute(q).rows.tolist())) == want, name
    assert e.pool.leaks() == []
    c = e.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c


_graphs = st.builds(
    lambda e1, e2, ages: (
        sorted(set(e1)), sorted(set(e2)), {i: a for i, a in enumerate(ages)}
    ),
    st.lists(st.tuples(st.integers(0, 7), st.integers(0, 7)), max_size=60),
    st.lists(st.tuples(st.integers(0, 7), st.integers(0, 3)), max_size=25),
    st.lists(st.integers(10, 70), min_size=8, max_size=8),
)


def _property_store(g):
    knows, interests, ages = g
    store = RStore()
    for s, o in knows:
        store.add(f":p{s}", ":knows", f":p{o}")
    for s, t in interests:
        store.add(f":p{s}", ":interest", f":tag{t}")
    for s, a in ages.items():
        store.add(f":p{s}", ":age", int(a))
    return store.build()


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(_graphs)
def test_pool_balance_property(g):
    """Buffer conservation over random graphs: after any query finishes,
    every fresh allocation is pooled or retired — nothing live, nothing
    leaked — for every engine, sanitized or not, with the reference's
    rows."""
    ref = _property_store(g)
    store = _port_store(ref)
    for engine in ("barq", "legacy", "mixed"):
        want = {q: sorted(map(tuple, REngine(ref, RConfig(engine=engine)).execute(q)
                              .rows.tolist())) for q in VERIFY_QUERIES}
        for sanitize in (False, True):
            e = repro_torch.Engine(store, repro_torch.EngineConfig(
                engine=engine, initial_batch=32, max_batch=64, sanitize=sanitize),
                device="cpu")
            for q in VERIFY_QUERIES:
                assert sorted(map(tuple, e.execute(q).rows.tolist())) == want[q], q
            if e.pool is None:
                assert engine == "legacy"
                continue
            c = e.pool.counters()
            assert c["live"] == 0, (engine, sanitize, c)
            assert c["allocs"] == c["releases"] + c["pooled"], (engine, sanitize, c)
            if sanitize:
                assert e.pool.leaks() == [], (engine, sanitize)
