"""The PyTorch port's engine (``repro_torch.Engine``) against the JAX
package's batch engine, on the CPU (the kernels' plain versions).

Both engines run over identical dictionary codes: the port's store is
carried across from the reference store with ``store_from_arrays``. Each
query must return the same multiset of decoded rows as the reference's
``repro.core.Engine`` under the same ``join_strategy`` and ``sip`` (the
same ordered rows where ORDER BY fixes the order), and the port's buffer
pool must balance after every query. The merge path with SIP off runs in
the tests without a config in their name; the reference's default
configuration (cost-based joins, cost-gated SIP), hash joins without SIP
and merge joins with SIP run in the ``*_under_config`` tests.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.data.lsqb import LSQB_QUERIES  # noqa: E402
from repro.data.lsqb import generate_social_graph as ref_social_graph  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


# (join_strategy, sip) configurations beside merge/off
CONFIGS = {"default": (None, None), "hash-off": ("hash", "off"), "merge-on": ("merge", "on")}


def _engines(ref_store, join_strategy="merge", sip="off", port_store=None):
    ref = REngine(ref_store, RConfig(join_strategy=join_strategy, sip=sip))
    port = repro_torch.Engine(
        port_store or _port_store(ref_store),
        repro_torch.EngineConfig(join_strategy=join_strategy, sip=sip), device="cpu",
    )
    return ref, port


def _config_engines(cache, cfg):
    """The (reference, port) engine pair under ``CONFIGS[cfg]``, sharing
    the stores of ``cache["merge-off"]``."""
    if cfg not in cache:
        ref, port = cache["merge-off"]
        cache[cfg] = _engines(ref.store, *CONFIGS[cfg], port_store=port.store)
    return cache[cfg]


def _rows(res, store, ordered=False):
    rows = [tuple(sorted(r.items())) for r in res.decoded(store.dict)]
    return rows if ordered else Counter(rows)


def _assert_pool_balanced(engine):
    c = engine.pool.counters()
    assert c["allocs"] == c["releases"] + c["pooled"], c
    assert c["live"] == 0, c


@pytest.fixture(scope="module")
def lsqb_engines(social_store):
    return _engines(social_store[0])


@pytest.fixture(scope="module")
def lsqb_cache(lsqb_engines):
    return {"merge-off": lsqb_engines}


@pytest.mark.parametrize("name", sorted(LSQB_QUERIES))
def test_lsqb_query_matches_reference(lsqb_engines, name):
    ref, port = lsqb_engines
    want = ref.execute(LSQB_QUERIES[name])
    got = port.execute(LSQB_QUERIES[name])
    assert _rows(got, port.store) == _rows(want, ref.store)
    _assert_pool_balanced(port)


@pytest.mark.parametrize("name", sorted(LSQB_QUERIES))
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_lsqb_query_matches_reference_under_config(lsqb_cache, cfg, name):
    ref, port = _config_engines(lsqb_cache, cfg)
    want = ref.execute(LSQB_QUERIES[name])
    got = port.execute(LSQB_QUERIES[name])
    assert _rows(got, port.store) == _rows(want, ref.store)
    _assert_pool_balanced(port)


def test_port_generator_gives_the_reference_quads():
    ref_store, ref_meta = ref_social_graph(scale=0.04, seed=3)
    store, meta = repro_torch.generate_social_graph(scale=0.04, seed=3, device="cpu")
    assert meta == ref_meta
    np.testing.assert_array_equal(store.index_array("spoc"), ref_store.index_array("spoc"))
    assert [store.dict.decode(i) for i in range(len(store.dict))] == [
        ref_store.dict.decode(i) for i in range(len(ref_store.dict))]


def test_store_indexes_match_reference(social_store):
    ref_store = social_store[0]
    store = _port_store(ref_store)
    for name in ("spoc", "posc", "ospc", "psoc"):
        np.testing.assert_array_equal(store.index_array(name), ref_store.index_array(name))
    knows = ref_store.dict.lookup(":knows")
    for bound in ((None, knows, None, None), (None, None, None, None)):
        idx = ref_store.choose_index(bound, None)
        want, got = ref_store.range_for_pattern(idx, bound), store.range_for_pattern(idx, bound)
        assert (got.lo, got.hi) == (want.lo, want.hi)
        assert store.seek(got, 3, 1, want.lo) == ref_store.seek(want, 3, 1, want.lo)


# ---------------------------------------------------------------------------
# a small store with numeric literals
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def numeric_engines():
    store = RStore()
    rng = np.random.RandomState(11)
    people = [f":p{i}" for i in range(30)]
    for i, p in enumerate(people):
        store.add(p, ":age", int(rng.randint(18, 70)))
        store.add(p, ":score", float(rng.randint(0, 40)) / 4)  # exact in float32
        store.add(p, ":city", f":c{i % 6}")
        for j in rng.choice(len(people), 3, replace=False):
            if int(j) != i:
                store.add(p, ":knows", people[int(j)])
        if i % 3:
            store.add(p, ":nick", f'"n{i}"')
    return _engines(store.build())


@pytest.fixture(scope="module")
def numeric_cache(numeric_engines):
    return {"merge-off": numeric_engines}


NUMERIC_QUERIES = {
    "numeric filter": "SELECT ?p ?a { ?p :age ?a . FILTER(?a > 30 && ?a <= 60) }",
    "bind": "SELECT ?p ?x { ?p :age ?a . BIND(?a * 2 + 1 AS ?x) }",
    "bind over floats": "SELECT ?p ?y { ?p :score ?s . BIND(?s / 2 - 1 AS ?y) }",
    "group by": (
        "SELECT ?c (COUNT(*) AS ?n) (SUM(?a) AS ?s) (MIN(?a) AS ?lo) (MAX(?a) AS ?hi) "
        "(AVG(?a) AS ?m) { ?p :city ?c . ?p :age ?a } GROUP BY ?c"),
    "group by two vars": (
        "SELECT ?c ?s (COUNT(?p) AS ?n) { ?p :city ?c . ?p :score ?s } GROUP BY ?c ?s"),
    "having": (
        "SELECT ?c (SUM(?s) AS ?t) { ?p :city ?c . ?p :score ?s } "
        "GROUP BY ?c HAVING (SUM(?s) > 20)"),
    "global aggregate": "SELECT (SUM(?s) AS ?t) (COUNT(?n) AS ?k) { ?p :score ?s . OPTIONAL { ?p :nick ?n } }",
    "optional with filter": (
        "SELECT ?p ?q ?b { ?p :age ?a . OPTIONAL { ?p :knows ?q . ?q :age ?b . "
        "FILTER(?b > ?a) } }"),
    "union": "SELECT ?p ?v { { ?p :age ?v } UNION { ?p :score ?v } }",
    "union of other schemas": "SELECT ?p ?a ?n { { ?p :age ?a } UNION { ?p :nick ?n } }",
    "distinct one var": "SELECT DISTINCT ?c { ?p :city ?c }",
    "distinct two vars": "SELECT DISTINCT ?c ?q { ?p :city ?c . ?p :knows ?q }",
    "join with filter": (
        "SELECT ?p ?q { ?p :knows ?q . ?p :age ?a . ?q :age ?b . FILTER(?a < ?b) }"),
    "not exists, secondary key": (
        "SELECT ?p ?a { ?p :age ?a . "
        "FILTER NOT EXISTS { ?p :knows ?q . ?q :city ?c . ?p :city ?c } }"),
    "minus, secondary key": "SELECT ?p ?q { ?p :knows ?q . MINUS { ?q :knows ?p } }",
    "optional, secondary key": (
        "SELECT ?p ?q ?c { ?p :knows ?q . ?p :city ?c . OPTIONAL { ?q :city ?c } }"),
    "group over optional": (
        "SELECT ?c (COUNT(?n) AS ?k) { ?p :city ?c . OPTIONAL { ?p :nick ?n } } GROUP BY ?c"),
}

ORDERED_QUERIES = {
    "order by, limit, offset": "SELECT ?p ?a { ?p :age ?a } ORDER BY DESC(?a) ?p LIMIT 7 OFFSET 3",
    "order by expression": "SELECT ?p ?s { ?p :score ?s } ORDER BY DESC(?s * 2 + 1) ?p LIMIT 10",
}


@pytest.mark.parametrize("name", sorted(NUMERIC_QUERIES))
def test_numeric_query_matches_reference(numeric_engines, name):
    ref, port = numeric_engines
    want = ref.execute(NUMERIC_QUERIES[name])
    got = port.execute(NUMERIC_QUERIES[name])
    assert got.n_rows == want.rows.shape[0]
    assert _rows(got, port.store) == _rows(want, ref.store)
    _assert_pool_balanced(port)


@pytest.mark.parametrize("name", sorted(ORDERED_QUERIES))
def test_ordered_query_matches_reference(numeric_engines, name):
    ref, port = numeric_engines
    want = ref.execute(ORDERED_QUERIES[name])
    got = port.execute(ORDERED_QUERIES[name])
    assert _rows(got, port.store, ordered=True) == _rows(want, ref.store, ordered=True)
    _assert_pool_balanced(port)


@pytest.mark.parametrize("name", sorted(NUMERIC_QUERIES))
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_numeric_query_matches_reference_under_config(numeric_cache, cfg, name):
    ref, port = _config_engines(numeric_cache, cfg)
    want = ref.execute(NUMERIC_QUERIES[name])
    got = port.execute(NUMERIC_QUERIES[name])
    assert got.n_rows == want.rows.shape[0]
    assert _rows(got, port.store) == _rows(want, ref.store)
    _assert_pool_balanced(port)


@pytest.mark.parametrize("name", sorted(ORDERED_QUERIES))
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_ordered_query_matches_reference_under_config(numeric_cache, cfg, name):
    ref, port = _config_engines(numeric_cache, cfg)
    want = ref.execute(ORDERED_QUERIES[name])
    got = port.execute(ORDERED_QUERIES[name])
    assert _rows(got, port.store, ordered=True) == _rows(want, ref.store, ordered=True)
    _assert_pool_balanced(port)


def test_plans_match_reference(numeric_engines, lsqb_engines):
    """The host front end is a copy: the same text plans the same way."""
    for (ref, port), queries in ((numeric_engines, NUMERIC_QUERIES),
                                 (lsqb_engines, LSQB_QUERIES)):
        for text in queries.values():
            assert port.explain(text) == ref.explain(text)


# out-of-core and adaptive configurations: their plans (grace, partitioned
# and adaptive marks) are compared here, their rows in
# test_torch_partition.py and test_torch_adaptive_join.py
PLAN_CONFIGS = {
    "budget-0": dict(memory_budget=0),
    "budget-64k": dict(memory_budget=64 << 10),
    "merge-adaptive": dict(join_strategy="merge", adaptive_join="on"),
}


@pytest.mark.parametrize("cfg", sorted(CONFIGS) + sorted(PLAN_CONFIGS))
def test_plans_match_reference_under_config(numeric_cache, lsqb_cache, cfg):
    for cache, queries in ((numeric_cache, NUMERIC_QUERIES), (lsqb_cache, LSQB_QUERIES)):
        if cfg in PLAN_CONFIGS:
            ref_store, port_store = cache["merge-off"][0].store, cache["merge-off"][1].store
            ref = REngine(ref_store, RConfig(**PLAN_CONFIGS[cfg]))
            port = repro_torch.Engine(port_store, repro_torch.EngineConfig(**PLAN_CONFIGS[cfg]),
                                      device="cpu")
        else:
            ref, port = _config_engines(cache, cfg)
        for text in queries.values():
            assert port.explain(text) == ref.explain(text)


def test_default_config_is_the_references():
    port, ref = repro_torch.EngineConfig(), RConfig()
    assert (port.join_strategy, port.sip) == (ref.join_strategy, ref.sip) == (None, None)


def test_lsqb_launch_counts_on_the_cpu(lsqb_cache):
    """The plain versions run on CPU tensors: no kernel launch is counted,
    for any of the ten kernels, under the default configuration (hash
    joins and SIP) and on the merge path, for a join query, a property
    path and a DISTINCT aggregate."""
    from repro_torch import kernels as K

    K.reset_launch_counts()
    for cfg in ("default", "merge-off"):
        port = _config_engines(lsqb_cache, cfg)[1]
        port.execute(LSQB_QUERIES["q6"])
        port.execute("SELECT (COUNT(*) AS ?n) { ?x :knows+ ?y }")
        port.execute("SELECT (COUNT(DISTINCT ?t) AS ?n) { ?p :hasInterest ?t }")
    counts = K.launch_counts()
    assert set(counts) == {"join_expand", "gather_emit", "expr_eval", "segment_scan",
                           "radix_partition", "hash_probe", "bloom_build", "bloom_probe",
                           "sorted_search", "frontier_dedup"}
    assert set(counts.values()) == {0}


# ---------------------------------------------------------------------------
# chip_smoke.py's closed forms, held against both engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def closed_forms(social_store):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.closed_form_counts(social_store[0])


def _count(engine, text):
    res = engine.execute(text)
    return int(engine.store.dict.decode(int(res.rows[0, 0])))


@pytest.mark.parametrize("name", ["q1", "q2", "q4", "q5", "q6", "q7"])
def test_closed_form_counts_match_the_engines(closed_forms, lsqb_cache, name):
    ref, port = _config_engines(lsqb_cache, "default")
    want = closed_forms[name]
    assert _count(ref, LSQB_QUERIES[name]) == want
    assert _count(port, LSQB_QUERIES[name]) == want
