"""DISTINCT aggregates and the BSBM BI mix on the PyTorch port, against the
JAX package's batch engine, on the CPU.

``COUNT/SUM/AVG/MIN/MAX(DISTINCT …)`` run through streaming, sort-based and
global groups, with unbound values through OPTIONAL and non-numeric terms
beside numbers, at the default batch size and at ``max_batch=64`` so that
groups span batches (the carry's code chunks). The port's rows must equal
``repro.core.Engine(engine="barq")``'s, decoded, under the same
``(join_strategy, sip)``, and its pool must balance after every query. The
values are small integers, so the port's float32 partial sums are exact and
the results equal the reference's float64 ones.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.data.bsbm import BSBM_BI_QUERIES as REF_BI  # noqa: E402
from repro.data.bsbm import generate_ecommerce_graph as ref_bsbm  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.data import BSBM_BI_QUERIES, generate_ecommerce_graph  # noqa: E402

CONFIGS = {"merge-off": ("merge", "off"), "default": (None, None),
           "hash-off": ("hash", "off"), "merge-on": ("merge", "on")}


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


def _rows(res, store):
    return Counter(tuple(sorted(r.items())) for r in res.decoded(store.dict))


def _check(ref_store, port_store, cfg, text, max_batch=4096):
    js, sip = CONFIGS[cfg]
    ref = REngine(ref_store, RConfig(join_strategy=js, sip=sip, max_batch=max_batch))
    port = repro_torch.Engine(
        port_store, repro_torch.EngineConfig(join_strategy=js, sip=sip, max_batch=max_batch),
        device="cpu")
    want, got = ref.execute(text), port.execute(text)
    assert _rows(got, port_store) == _rows(want, ref_store)
    c = port.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
    return got


@pytest.fixture(scope="module")
def people():
    """300 people in 7 cities; ages from 20 small values (many repeats),
    about a fifth without one; scores that are numbers or IRIs; tags."""
    rng = np.random.RandomState(4)
    s = RStore()
    for i in range(300):
        p = f":p{i}"
        s.add(p, ":city", f":c{rng.randint(7)}")
        if rng.rand() < 0.8:
            s.add(p, ":age", int(rng.randint(20, 40)))
        for _ in range(rng.randint(0, 4)):
            s.add(p, ":score", int(rng.randint(0, 6)) if rng.rand() < 0.7
                  else f":grade{rng.randint(3)}")
        for t in rng.choice(12, size=rng.randint(1, 5), replace=False):
            s.add(p, ":tag", f":t{int(t)}")
    ref = s.build()
    return ref, _port_store(ref)


ALL_FUNCS = ("(COUNT(DISTINCT {v}) AS ?cd) (SUM(DISTINCT {v}) AS ?sd) (AVG(DISTINCT {v}) AS ?ad) "
             "(MIN(DISTINCT {v}) AS ?lo) (MAX(DISTINCT {v}) AS ?hi)")

DISTINCT_QUERIES = {
    # one group var: StreamingGroupBy (over a sort where the input is not
    # sorted by it)
    "streaming by person": "SELECT ?p " + ALL_FUNCS.format(v="?s")
                           + " { ?p :score ?s } GROUP BY ?p",
    "sorted by city": "SELECT ?c " + ALL_FUNCS.format(v="?a")
                      + " { ?p :city ?c . ?p :age ?a } GROUP BY ?c",
    # two group vars: SortGroupBy, then the streaming engine on dense gids
    "two group vars": "SELECT ?c ?t (COUNT(DISTINCT ?a) AS ?n) (SUM(DISTINCT ?a) AS ?s) "
                      "{ ?p :city ?c . ?p :tag ?t . ?p :age ?a } GROUP BY ?c ?t",
    # one group over every batch
    "global": "SELECT " + ALL_FUNCS.format(v="?a") + " { ?p :age ?a }",
    "global over a join": "SELECT (COUNT(DISTINCT ?t) AS ?n) (COUNT(?t) AS ?all) "
                          "{ ?p :city ?c . ?p :tag ?t }",
    "global, non-numeric and numbers": "SELECT " + ALL_FUNCS.format(v="?s")
                                       + " { ?p :score ?s }",
    # OPTIONAL leaves ?a unbound for some people
    "unbound through OPTIONAL": "SELECT ?c " + ALL_FUNCS.format(v="?a")
                                + " { ?p :city ?c OPTIONAL { ?p :age ?a } } GROUP BY ?c",
    "unbound, global": "SELECT (COUNT(DISTINCT ?a) AS ?n) (AVG(DISTINCT ?a) AS ?m) "
                       "{ ?p :city ?c OPTIONAL { ?p :age ?a } }",
    "beside plain aggregates": "SELECT ?c (COUNT(?a) AS ?n) (COUNT(DISTINCT ?a) AS ?nd) "
                               "(SUM(?a) AS ?s) (SUM(DISTINCT ?a) AS ?sd) (COUNT(*) AS ?rows) "
                               "{ ?p :city ?c . ?p :age ?a } GROUP BY ?c",
    "empty input": "SELECT (COUNT(DISTINCT ?a) AS ?n) (SUM(DISTINCT ?a) AS ?s) "
                   "(AVG(DISTINCT ?a) AS ?m) { ?p :nothing ?a }",
}


@pytest.mark.parametrize("max_batch", [4096, 64])
@pytest.mark.parametrize("name", sorted(DISTINCT_QUERIES))
def test_distinct_aggregate_matches_reference(people, name, max_batch):
    _check(*people, "merge-off", DISTINCT_QUERIES[name], max_batch)


@pytest.mark.parametrize("cfg", ["default", "hash-off", "merge-on"])
@pytest.mark.parametrize("name", ["sorted by city", "global over a join",
                                  "unbound through OPTIONAL", "two group vars"])
def test_distinct_aggregate_matches_reference_under_config(people, cfg, name):
    _check(*people, cfg, DISTINCT_QUERIES[name], 64)


def test_global_distinct_spans_every_batch(people):
    """At 64-row batches the global group's codes arrive in many chunks;
    the count is the number of distinct tags, not per-batch counts."""
    got = _check(*people, "merge-off", DISTINCT_QUERIES["global over a join"], 64)
    (row,) = got.decoded(people[1].dict)
    assert row["n"] == 12 and row["all"] > 64


# ---------------------------------------------------------------------------
# BSBM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bsbm_pair():
    ref, _ = ref_bsbm(scale=0.1, seed=7)
    return ref, _port_store(ref)


def test_port_bsbm_generator_gives_the_reference_quads():
    ref_store, ref_meta = ref_bsbm(scale=0.1, seed=11)
    store, meta = generate_ecommerce_graph(scale=0.1, seed=11, device="cpu")
    assert meta == ref_meta
    np.testing.assert_array_equal(store.index_array("spoc"), ref_store.index_array("spoc"))
    assert [store.dict.decode(i) for i in range(len(store.dict))] == [
        ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    assert BSBM_BI_QUERIES == REF_BI


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(BSBM_BI_QUERIES))
def test_bsbm_bi_query_matches_reference(bsbm_pair, cfg, name):
    got = _check(*bsbm_pair, cfg, BSBM_BI_QUERIES[name])
    assert got.n_rows > 0


# ---------------------------------------------------------------------------
# chip_smoke.py's closed forms for d1, d2, b4, b6 and b8, held against both engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_distinct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decoded(engine, store, text):
    return engine.execute(text).decoded(store.dict)


def test_distinct_closed_forms_match_the_engines(chip_smoke, social_store):
    ref_store = social_store[0]
    port_store = _port_store(ref_store)
    want = chip_smoke.distinct_closed_forms(ref_store)
    for engine, store in ((REngine(ref_store), ref_store),
                          (repro_torch.Engine(port_store, device="cpu"), port_store)):
        (row,) = _decoded(engine, store, chip_smoke.DISTINCT_QUERIES["d1"])
        assert row["n"] == want["d1"]
        rows = _decoded(engine, store, chip_smoke.DISTINCT_QUERIES["d2"])
        assert {r["city"]: r["n"] for r in rows} == want["d2"]


def test_bsbm_closed_forms_match_the_engines(chip_smoke, bsbm_pair):
    ref_store, port_store = bsbm_pair
    want = chip_smoke.bsbm_closed_forms(ref_store)
    for engine, store in ((REngine(ref_store), ref_store),
                          (repro_torch.Engine(port_store, device="cpu"), port_store)):
        rows = _decoded(engine, store, BSBM_BI_QUERIES["b4"])
        assert {r["vendor"]: r["reviewers"] for r in rows} == want["b4"]
        (row,) = _decoded(engine, store, BSBM_BI_QUERIES["b8"])
        assert row["n"] == want["b8"] > 0
        (row,) = _decoded(engine, store, BSBM_BI_QUERIES["b6"])
        assert row["n"] == want["b6_rows"] > 0
