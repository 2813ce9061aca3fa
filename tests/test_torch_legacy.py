"""The PyTorch port's row engine and mixed engine against the JAX
package's, on the CPU.

``repro_torch.Engine(..., EngineConfig(engine="legacy" | "mixed"))`` must
return the same row multiset as ``repro.core.Engine`` under the same
engine, and as the brute-force oracles of the reference's own
equivalence tests; the row engine must plan as the reference's does
(``barq_enabled=False``). The row operators are held against brute force
(merge-join modes, skip), the adapters against round trips, and the row
hash join against the port's grace hash join at 200,000 x 200,000 rows.
"""

import collections
from collections import Counter

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.data.bsbm import BSBM_BI_QUERIES  # noqa: E402
from repro.data.bsbm import generate_ecommerce_graph as ref_bsbm  # noqa: E402
from repro.data.lsqb import LSQB_QUERIES  # noqa: E402
from repro.data.lsqb import generate_social_graph as ref_social  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core.algebra import K, TriplePattern, V  # noqa: E402
from repro_torch.core.legacy import operators as LOP  # noqa: E402
from repro_torch.core.legacy.property_path import RowPathScan  # noqa: E402
from repro_torch.core.operators.adapters import BatchToRow, RowToBatch  # noqa: E402
from repro_torch.core.operators.base import close_tree  # noqa: E402
from repro_torch.core.operators.hash_join import HashJoin  # noqa: E402
from repro_torch.core.operators.scan import IndexScan  # noqa: E402
from repro_torch.core.operators.sort import MaterializedSource  # noqa: E402

CPU = torch.device("cpu")
ENGINES = ("barq", "legacy", "mixed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the row engine's one-row batches are tiny, and
    the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


def _decoded(res, store):
    return Counter(tuple(sorted(r.items())) for r in res.decoded(store.dict))


def _assert_pool_balanced(engine):
    if engine.pool is None:  # the row engine holds no batches
        return
    c = engine.pool.counters()
    assert c["allocs"] == c["releases"] + c["pooled"], c
    assert c["live"] == 0, c


# ---------------------------------------------------------------------------
# the reference's equivalence properties, through the port
# ---------------------------------------------------------------------------


def _build_stores(knows, interests, ages):
    """The same graph in both packages, added in the same order (so the
    dictionaries give equal codes)."""
    ref, port = RStore(), repro_torch.QuadStore(device="cpu")
    for store in (ref, port):
        for s, o in knows:
            store.add(f":p{s}", ":knows", f":p{o}")
        for s, t in interests:
            store.add(f":p{s}", ":interest", f":tag{t}")
        for s, a in ages.items():
            store.add(f":p{s}", ":age", int(a))
    return ref.build(), port.build()


def _run(store, query, engine, port, batch=64):
    if port:
        e = repro_torch.Engine(store, repro_torch.EngineConfig(
            engine=engine, initial_batch=32, max_batch=batch), device="cpu")
    else:
        e = REngine(store, RConfig(engine=engine, initial_batch=32, max_batch=batch))
    r = e.execute(query)
    if port:
        _assert_pool_balanced(e)
    rows = [tuple(None if c == -1 else store.dict.decode(int(c)) for c in row)
            for row in r.rows]
    return sorted(rows, key=str)


def _check(stores, query, oracle=None):
    """Every engine of the port equals the reference's same engine (and
    the oracle, where one is given)."""
    ref, port = stores
    for eng in ENGINES:
        got = _run(port, query, eng, True)
        assert got == _run(ref, query, eng, False), eng
        if oracle is not None:
            assert got == oracle, eng


graphs = st.builds(
    lambda e1, e2, ages: (
        sorted(set(e1)), sorted(set(e2)), {i: a for i, a in enumerate(ages)}
    ),
    st.lists(st.tuples(st.integers(0, 7), st.integers(0, 7)), max_size=60),
    st.lists(st.tuples(st.integers(0, 7), st.integers(0, 3)), max_size=25),
    st.lists(st.integers(10, 70), min_size=8, max_size=8),
)
PROPERTY = settings(max_examples=8, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


@PROPERTY
@given(graphs)
def test_two_hop_filter(g):
    knows, interests, ages = g
    ks = set(knows)
    oracle = sorted(((f":p{a}", f":p{b}", f":p{c}") for a, b in ks for b2, c in ks
                     if b2 == b and a != c), key=str)
    _check(_build_stores(*g), "SELECT ?a ?b ?c { ?a :knows ?b . ?b :knows ?c . FILTER(?a != ?c) }",
           oracle)


@PROPERTY
@given(graphs)
def test_optional_and_minus(g):
    knows, interests, ages = g
    stores = _build_stores(*g)
    it = collections.defaultdict(list)
    for s, t in interests:
        it[s].append(t)
    oracle = []
    for a, b in set(knows):
        if it[b]:
            oracle.extend((f":p{a}", f":p{b}", f":tag{t}") for t in it[b])
        else:
            oracle.append((f":p{a}", f":p{b}", None))
    _check(stores, "SELECT ?a ?b ?t { ?a :knows ?b . OPTIONAL { ?b :interest ?t } }",
           sorted(oracle, key=str))
    ks = set(knows)
    _check(stores, "SELECT ?a ?b { ?a :knows ?b . MINUS { ?b :knows ?a } }",
           sorted(((f":p{a}", f":p{b}") for a, b in ks if (b, a) not in ks), key=str))


@PROPERTY
@given(graphs, st.integers(20, 60))
def test_optional_with_join_condition(g, cutoff):
    """SPARQL LeftJoin: a FILTER inside OPTIONAL over left-side vars is the
    join condition; a left row whose matches all fail it still appears."""
    knows, interests, ages = g
    ks = set(knows)
    oracle = []
    for s, a in ages.items():
        matches = [b for s2, b in ks if s2 == s and a >= cutoff]
        if matches:
            oracle.extend((f":p{s}", a, f":p{b}") for b in matches)
        else:
            oracle.append((f":p{s}", a, None))
    _check(_build_stores(*g), f"SELECT ?p ?a ?b {{ ?p :age ?a . "
                              f"OPTIONAL {{ ?p :knows ?b . FILTER(?a >= {cutoff}) }} }}",
           sorted(oracle, key=str))


@PROPERTY
@given(graphs, st.integers(20, 60))
def test_group_aggregates_filter_and_bind(g, cutoff):
    knows, interests, ages = g
    stores = _build_stores(*g)
    grp = collections.defaultdict(set)
    for a, b in set(knows):
        grp[a].add(b)
    _check(stores, "SELECT ?a (COUNT(DISTINCT ?b) AS ?n) { ?a :knows ?b } GROUP BY ?a",
           sorted(((f":p{a}", len(v)) for a, v in grp.items()), key=str))
    _check(stores, f"SELECT ?p ?a {{ ?p :age ?a . FILTER(?a >= {cutoff}) }}",
           sorted(((f":p{s}", a) for s, a in ages.items() if a >= cutoff), key=str))
    _check(stores, "SELECT ?p ?b { ?p :age ?a . BIND((?a * 2) AS ?b) }",
           sorted(((f":p{s}", a * 2) for s, a in ages.items()), key=str))
    _check(stores, "SELECT ?p (AVG(?a) AS ?m) (MAX(?a) AS ?hi) { ?p :knows ?q . ?q :age ?a } "
                   "GROUP BY ?p HAVING (COUNT(?q) > 1) ORDER BY DESC(?m) LIMIT 3")


@PROPERTY
@given(graphs)
def test_union_distinct(g):
    knows, interests, ages = g
    oracle = sorted({(f":p{a}",) for a, _ in set(knows)}
                    | {(f":p{s}",) for s, _ in set(interests)}, key=str)
    _check(_build_stores(*g), "SELECT DISTINCT ?x { { ?x :knows ?y } UNION { ?x :interest ?t } }",
           oracle)


def _tiny_stores():
    """The reference's ``tiny_store`` fixture, built in both packages."""
    rng = np.random.RandomState(0)
    ref, port = RStore(), repro_torch.QuadStore(device="cpu")
    adds = []
    for i in range(10):
        for j in rng.choice(10, size=3, replace=False):
            if i != int(j):
                adds.append((f":p{i}", ":knows", f":p{int(j)}"))
        adds.append((f":p{i}", ":age", int(rng.randint(20, 60))))
        for t in rng.choice(4, size=2, replace=False):
            adds.append((f":p{i}", ":interest", f":tag{int(t)}"))
    for store in (ref, port):
        for quad in adds:
            store.add(*quad)
    return ref.build(), port.build()


@pytest.mark.parametrize("max_batch", [32, 4096])
def test_triangle_and_batch_size_invariance(max_batch):
    ref, port = _tiny_stores()
    q = "SELECT ?a ?b ?c { ?a :knows ?b . ?b :knows ?c . ?c :knows ?a }"
    base = _run(ref, q, "barq", False)
    for eng in ENGINES:
        assert _run(port, q, eng, True, batch=max_batch) == base, eng


# ---------------------------------------------------------------------------
# the benchmark stores: LSQB q1-q9 and the BSBM BI mix
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lsqb_stores():
    ref, _ = ref_social(scale=0.1, seed=3)
    return ref, _port_store(ref)


@pytest.fixture(scope="module")
def bsbm_stores():
    ref, _ = ref_bsbm(scale=0.02, seed=7)
    return ref, _port_store(ref)


@pytest.mark.parametrize("engine", ["legacy", "mixed"])
@pytest.mark.parametrize("name", sorted(LSQB_QUERIES))
def test_lsqb_query_matches_reference(lsqb_stores, engine, name):
    ref, port = lsqb_stores
    want = REngine(ref, RConfig(engine=engine)).execute(LSQB_QUERIES[name])
    e = repro_torch.Engine(port, repro_torch.EngineConfig(engine=engine), device="cpu")
    got = e.execute(LSQB_QUERIES[name])
    assert _decoded(got, port) == _decoded(want, ref)
    _assert_pool_balanced(e)


@pytest.mark.parametrize("engine", ["legacy", "mixed"])
@pytest.mark.parametrize("name", sorted(BSBM_BI_QUERIES))
def test_bsbm_query_matches_reference(bsbm_stores, engine, name):
    ref, port = bsbm_stores
    want = REngine(ref, RConfig(engine=engine)).execute(BSBM_BI_QUERIES[name])
    e = repro_torch.Engine(port, repro_torch.EngineConfig(engine=engine), device="cpu")
    got = e.execute(BSBM_BI_QUERIES[name])
    assert _decoded(got, port) == _decoded(want, ref)
    _assert_pool_balanced(e)


def test_legacy_plans_match_reference(lsqb_stores, bsbm_stores):
    """The row engine plans without BARQ's amplifying reorder, as the
    reference's does, and differently from the batch engine somewhere."""
    differ = 0
    for (ref, port), queries in ((lsqb_stores, LSQB_QUERIES), (bsbm_stores, BSBM_BI_QUERIES)):
        r = REngine(ref, RConfig(engine="legacy"))
        p = repro_torch.Engine(port, repro_torch.EngineConfig(engine="legacy"), device="cpu")
        pb = repro_torch.Engine(port, device="cpu")
        assert not p.planner.barq_enabled and pb.planner.barq_enabled
        for text in queries.values():
            plan = p.explain(text)
            assert plan == r.explain(text)
            differ += plan != pb.explain(text)
    assert differ > 0


def test_translators_pick_row_and_batch_operators(lsqb_stores):
    """Legacy trees are all rows and hold no pool; mixed trees group on
    rows over batch joins behind a BatchToRow."""
    _, port = lsqb_stores
    q = LSQB_QUERIES["q4"]
    legacy = repro_torch.Engine(port, repro_torch.EngineConfig(engine="legacy"), device="cpu")
    assert legacy.pool is None
    root = legacy.execute(q).root
    assert isinstance(root, LOP.RowOperator)
    stack = [root]
    while stack:
        op = stack.pop()
        assert isinstance(op, LOP.RowOperator), op
        stack.extend(op.children())
    mixed = repro_torch.Engine(port, repro_torch.EngineConfig(engine="mixed"), device="cpu")
    root = mixed.execute(q).root
    while not isinstance(root, LOP.RowGroupBy):
        root = root.children()[0]
    assert isinstance(root.child, BatchToRow) and root.child.stats.extra["host_copies"] > 0


# ---------------------------------------------------------------------------
# row operators: merge-join modes, skip, adapters
# ---------------------------------------------------------------------------


def _row_source(var_ids, cols, sorted_var, batch=8):
    """Rows of a column block, through a batch source and BatchToRow."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(cols, np.int32)))
    return BatchToRow(MaterializedSource(var_ids, t, sorted_var, batch_size=batch))


def _brute_join(left, right, lv, rv, mode):
    shared = [v for v in lv if v in rv]
    out = []
    for lrow in zip(*left):
        matches = [rrow for rrow in zip(*right)
                   if all(lrow[lv.index(s)] == rrow[rv.index(s)] for s in shared)]
        extra = [v for v in rv if v not in lv]
        if mode in ("inner", "left_outer"):
            for rrow in matches:
                out.append(tuple(lrow) + tuple(rrow[rv.index(v)] for v in extra))
            if mode == "left_outer" and not matches:
                out.append(tuple(lrow) + tuple(-1 for _ in extra))
        elif (mode == "semi") == bool(matches):
            out.append(tuple(lrow))
    return sorted(out)


def _rows_of(op, vars_):
    return sorted(tuple(r.get(v, -1) for v in vars_) for r in op.drain())


@pytest.mark.parametrize("mode", ["inner", "left_outer", "semi", "anti"])
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("batch", [4, 64])
def test_row_merge_join_modes_vs_bruteforce(mode, seed, batch):
    rng = np.random.RandomState(seed)
    nl, nr = rng.randint(0, 40), rng.randint(0, 40)
    left = [np.sort(rng.randint(0, 12, nl)), rng.randint(0, 5, nl)]  # vars (0, 1)
    right = [np.sort(rng.randint(0, 12, nr)), rng.randint(0, 5, nr)]  # vars (0, 2)
    join = LOP.RowMergeJoin(_row_source((0, 1), left, 0, batch),
                            _row_source((0, 2), right, 0, batch), 0, mode=mode)
    assert _rows_of(join, join.var_ids()) == _brute_join(left, right, (0, 1), (0, 2), mode)


@pytest.mark.parametrize("mode", ["inner", "semi", "anti"])
@pytest.mark.parametrize("seed", range(4))
def test_row_joins_multikey(mode, seed):
    """Two shared vars: the merge join checks the second on each group row;
    the hash join keys on the first alone and checks the second too."""
    rng = np.random.RandomState(seed + 100)
    nl, nr = rng.randint(1, 30), rng.randint(1, 30)
    left = [np.sort(rng.randint(0, 6, nl)), rng.randint(0, 3, nl)]  # vars (0, 1)
    right = [np.sort(rng.randint(0, 6, nr)), rng.randint(0, 3, nr),
             rng.randint(10, 13, nr)]  # vars (0, 1, 2)
    want = _brute_join(left, right, (0, 1), (0, 1, 2), mode)
    merge = LOP.RowMergeJoin(_row_source((0, 1), left, 0), _row_source((0, 1, 2), right, 0), 0,
                             mode=mode)
    assert _rows_of(merge, merge.var_ids()) == want
    hashed = LOP.RowHashJoin(_row_source((0, 1), left, None), _row_source((0, 1, 2), right, None),
                             (0,), mode=mode)
    assert _rows_of(hashed, hashed.var_ids()) == want


def test_row_merge_join_skip_reduces_rows_scanned(lsqb_stores):
    """A selective merge join seeks its right scan forward (numpy over the
    host index array) instead of reading every row of its range."""
    _, store = lsqb_stores
    studies = LOP.RowScan(store, TriplePattern(V(0), K(":studyAt"), K(":univ0")), 0)
    interests = LOP.RowScan(store, TriplePattern(V(0), K(":hasInterest"), V(1)), 0)
    join = LOP.RowMergeJoin(studies, interests, 0)
    got = _rows_of(join, (0, 1))
    people = {r[0] for r in _rows_of(LOP.RowScan(store, TriplePattern(
        V(0), K(":studyAt"), K(":univ0")), 0), (0,))}
    brute = sorted(r for r in _rows_of(LOP.RowScan(store, TriplePattern(
        V(0), K(":hasInterest"), V(1)), 0), (0, 1)) if r[0] in people)
    assert got == brute and len(got) > 0
    assert interests.stats.rows_scanned < interests.estimated_rows() / 2


def test_adapters_roundtrip(lsqb_stores):
    _, store = lsqb_stores
    pat = TriplePattern(V(0), K(":knows"), V(1))
    rows = BatchToRow(IndexScan(store, pat, 0)).drain()
    batches = []
    r2b = RowToBatch(BatchToRow(IndexScan(store, pat, 0)), CPU, batch_size=16)
    while (b := r2b.next_batch()) is not None:
        batches.append(b)
    assert sum(b.n_active for b in batches) == len(rows) > 0
    assert r2b.sorted_by() == 0
    flat = torch.cat([b.columns[:, : b.n_rows] for b in batches], dim=1)
    assert flat.T.tolist() == [[r[0], r[1]] for r in rows]


# ---------------------------------------------------------------------------
# the grace hash join against the row hash join, and paths
# ---------------------------------------------------------------------------


def test_grace_join_200k_parity_vs_row_hash_join(tmp_path):
    """200k x 200k unsorted join under a fifth of the build side's bytes:
    the port's grace HashJoin spills and equals the port's RowHashJoin
    over BatchToRow."""
    rng = np.random.RandomState(7)
    n = 200_000
    left = np.stack([rng.randint(0, n, n), rng.randint(0, 1000, n)]).astype(np.int32)
    right = np.stack([rng.randint(0, n, n), rng.randint(0, 1000, n)]).astype(np.int32)

    def src(vars_, cols):
        return MaterializedSource(vars_, torch.from_numpy(cols), None, batch_size=4096)

    grace = HashJoin(src((0, 1), left), src((0, 2), right), (0,), CPU, "inner",
                     memory_budget=right.nbytes // 5, spill_dir=str(tmp_path), grace=True)
    got = []
    while (b := grace.next_batch()) is not None:
        got.extend(map(tuple, b.columns[:, b.mask[: b.capacity]].T.tolist()))
    assert grace.stats.extra["spill_files"] > 0 and grace.stats.extra["spill_bytes"] > 0
    close_tree(grace)
    assert not list(tmp_path.glob("*.npy"))
    rows = LOP.RowHashJoin(BatchToRow(src((0, 1), left)), BatchToRow(src((0, 2), right)),
                           (0,)).drain()
    assert sorted(got) == sorted((r[0], r[1], r[2]) for r in rows) and len(rows) > 100_000


def _chain_stores():
    ref, port = RStore(), repro_torch.QuadStore(device="cpu")
    for store in (ref, port):
        # a -> b -> c -> d, plus e -> c, and a disjoint cycle f <-> g
        for x, y in [("a", "b"), ("b", "c"), ("c", "d"), ("e", "c"), ("f", "g"), ("g", "f")]:
            store.add(f":{x}", ":next", f":{y}")
        for x in "abcdefg":
            store.add(f":{x}", "rdf:type", ":Node")
    return ref.build(), port.build()


def _closure_oracle(edges):
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    out = set()
    for src in adj:
        seen, stack = set(), [src]
        while stack:
            for v in adj.get(stack.pop(), ()):
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        out |= {(src, t) for t in seen}
    return out


EDGES = [("a", "b"), ("b", "c"), ("c", "d"), ("e", "c"), ("f", "g"), ("g", "f")]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("query", [
    "SELECT ?x ?y { ?x :next+ ?y }",
    "SELECT ?x ?y { ?x :next+ ?y . ?x rdf:type :Node }",
], ids=["closure", "joined"])
def test_property_paths(engine, query):
    ref, port = _chain_stores()
    e = repro_torch.Engine(port, repro_torch.EngineConfig(engine=engine), device="cpu")
    res = e.execute(query)
    got = {(port.dict.decode(int(a))[1:], port.dict.decode(int(b))[1:])
           for a, b in res.rows.tolist()}
    assert got == _closure_oracle(EDGES)
    assert _run(port, query, engine, True) == _run(ref, query, engine, False)
    if engine == "legacy":
        stack = [res.root]
        while not isinstance(stack[-1], RowPathScan):
            stack.extend(stack.pop().children())


@pytest.mark.parametrize("engine", ENGINES)
def test_path_forms_match_reference(engine):
    """Inverse, sequence, alternative, `*` and `?` with bound endpoints."""
    ref, port = _chain_stores()
    for q in ("SELECT ?x { :a :next* ?x }", "SELECT ?x ?y { ?x ^:next/:next ?y }",
              "SELECT ?x { ?x (:next|^:next)? :c }", "SELECT ?x { ?x :next+ ?x }"):
        assert _run(port, q, engine, True) == _run(ref, q, engine, False), q
