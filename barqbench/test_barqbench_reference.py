"""The generator against BSBM's rules, the reference against the program on
the CPU, the judge, and the control against the reference, at sizes a test
run holds."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from barqbench import harness as H
from barqbench import judge as J
from barqbench import reference, traffic
from barqbench.reference import bsbm, control, data

BENCH = Path(__file__).resolve().parent
MIX = json.loads((BENCH / "mixes" / "explore.json").read_text())
PRODUCTS = 600


def test_sizes_follow_the_specifications_table():
    """The 1M-triple row of the dataset table, and the 100M row's types and
    features."""
    n = data.sizes(2785)
    assert 1 + sum(np.cumprod(n["branching"])) == 151
    assert (n["features"], n["producers"], n["vendors"], n["reviewers"]) == (4744, 60, 34, 1432)
    assert (n["offers"], n["reviews"]) == (55700, 27850)
    n = data.sizes(284826)
    assert 1 + sum(np.cumprod(n["branching"])) == 2011
    assert abs(n["features"] - 47884) <= 0.01 * 47884


@pytest.fixture(scope="module")
def graph():
    return data.bsbm_graph(PRODUCTS, 42)


def _per_subject(g, pred):
    q = g.quads
    return Counter(q[q[:, 1] == g.lookup(pred), 0].tolist())


def test_graph_has_bsbms_shape(graph):
    g = graph
    q = g.quads
    assert len(np.unique(q[:, :3].astype(np.int64) @ np.array([1 << 42, 1 << 21, 1]))) == len(q)
    n = data.sizes(PRODUCTS)
    products = g.subjects("rdf:type", g.lookup("bsbm:Product"))
    assert len(products) == PRODUCTS
    offers_of = Counter(q[q[:, 1] == g.lookup("bsbm:product"), 2].tolist())
    reviews_of = Counter(q[q[:, 1] == g.lookup("bsbm:reviewFor"), 2].tolist())
    assert set(offers_of.values()) == {20} and set(reviews_of.values()) == {10}
    # a type for every level of the tree, the root's excepted, besides bsbm:Product
    assert set(_per_subject(g, "rdf:type")[int(p)] for p in products) == {1 + n["depth"]}
    feats = _per_subject(g, "bsbm:productFeature")
    assert min(feats[int(p)] for p in products) >= 9
    assert max(feats[int(p)] for p in products) <= 21
    # every feature a product carries belongs to one of its types
    for p in products[:50]:
        types = [g.terms[t] for t in g.objects(p, "rdf:type") if g.terms[t] != "bsbm:Product"]
        pools = set().union(*(g.meta["type_features"][t] for t in types))
        assert {g.terms[f] for f in g.objects(p, "bsbm:productFeature")} <= pools
    assert set(g.meta["product_types"]) == set(g.meta["type_features"])
    assert len(g.meta["product_types"]) <= sum(np.cumprod(n["branching"]))


def test_relabel_keeps_every_answer_and_moves_every_id(graph):
    r = data.relabel(graph, 9)
    assert sorted(map(str, r.terms)) == sorted(map(str, graph.terms)) and r.terms != graph.terms
    reqs = [x for _ in range(2) for x in next(traffic.rounds(MIX, graph.meta, 3))]
    # the same rows, in another order where the order follows the ids
    assert ([Counter(a) for a in reference.answers(r, reqs, MIX)]
            == [Counter(a) for a in reference.answers(graph, reqs, MIX)])
    cfg = {"products": PRODUCTS, "graph_seed": 42}
    assert data.graph_for(cfg, 9).terms == r.terms


def test_traffic_draws_features_of_the_types_products(graph):
    stream = traffic.rounds(MIX, graph.meta, 11)
    n = Counter()
    for _ in range(20):
        for r in next(stream):
            n[r.name] += 1
            if "FEATURE2" in r.consts:
                pool = graph.meta["type_features"][r.consts["TYPE"]]
                feats = [r.consts[k] for k in ("FEATURE1", "FEATURE2", "FEATURE3")
                         if k in r.consts]
                assert set(feats) <= set(pool) and len(set(feats)) == len(feats)
    assert n == Counter({k: 20 * v.get("count", 1) for k, v in MIX["queries"].items()})
    again = traffic.rounds(MIX, graph.meta, 11)
    assert [r.text for r in next(again)] == [r.text for r in next(traffic.rounds(
        MIX, graph.meta, 11))]
    # another seed: the same requests in each round, in another order
    a, b = traffic.rounds(MIX, graph.meta, 11), traffic.rounds(MIX, graph.meta, 12)
    for _ in range(3):
        ra, rb = [r.text for r in next(a)], [r.text for r in next(b)]
        assert sorted(ra) == sorted(rb) and ra != rb and len(set(ra)) == len(ra)


@pytest.fixture(scope="module")
def server(graph):
    from repro_torch.serve.query_server import QueryServer

    store, stats, _ = H.build_store(graph, torch.device("cpu"))
    return QueryServer(store, device="cpu", stats=stats)


@pytest.mark.parametrize("query", sorted(MIX["queries"]))
def test_reference_equals_program(graph, server, query):
    """Three instances of each query: the program's rows, decoded, against
    the reference's, as the harness judges them."""
    stream = traffic.rounds(MIX, graph.meta, 17)
    reqs = [r for _ in range(3) for r in next(stream) if r.name == query][:3]
    records = H.serve_round(server, reqs)
    answers = H.decoded(records, server, MIX)
    want = reference.answers(graph, reqs, MIX)
    assert all(rows is not None for _q, rows in answers)
    assert J.judge(answers, want, MIX["queries"], J.ranker(graph))["wrong_answers"] == 0


def test_control_is_not_correct(graph):
    for seed in (1, 2, 3):
        checks = control.readings(graph, MIX, seed, 2)
        assert not J.verdict(checks, MIX["limits"]), (seed, checks)


def _limited(rows, spec, rank):
    """The rows an ORDER BY, OFFSET and LIMIT keep."""
    if "order" in spec:
        col = spec["columns"].index(spec["order"]["by"])
        rows = sorted(rows, key=lambda r: rank(r[col]), reverse=spec["order"].get("desc", False))
    off = spec.get("offset", 0)
    return rows[off: off + spec["limit"]] if "limit" in spec else rows[off:]


def test_reference_judges_itself_correct(graph):
    reqs = [r for rnd in [next(traffic.rounds(MIX, graph.meta, 4))] * 2 for r in rnd]
    want = reference.answers(graph, reqs, MIX)
    rank = J.ranker(graph)
    got = [_limited(rows, MIX["queries"][r.name], rank) for r, rows in zip(reqs, want)]
    checks = J.judge(list(zip([r.name for r in reqs], got)), want, MIX["queries"], rank)
    assert J.verdict(checks, MIX["limits"]) and checks["wrong_answers"] == 0


def test_judge_order_offset_and_limit():
    terms = [":a", ":b", ":c", ":d"]
    rank = J.ranker(data.Graph(terms, np.zeros((0, 4), np.int32), {}))
    spec = {"columns": ["x", "n"], "limit": 2, "order": {"by": "n", "desc": True}}
    want = [(":a", 5), (":b", 3), (":c", 3), (":d", 1)]
    assert J.compare([(":a", 5), (":c", 3)], want, spec, rank)
    assert J.compare([(":a", 5), (":b", 3)], want, spec, rank)
    assert not J.compare([(":b", 3), (":a", 5)], want, spec, rank)  # not descending
    assert not J.compare([(":a", 5), (":d", 1)], want, spec, rank)  # not the top two
    assert not J.compare([(":a", 5)], want, spec, rank)  # too few
    spec = {"columns": ["x"], "order": {"by": "x"}, "offset": 1, "limit": 2}
    want = [(":d",), (":b",), (":a",), (":c",)]
    assert J.compare([(":b",), (":c",)], want, spec, rank)  # by load order
    assert not J.compare([(":a",), (":b",)], want, spec, rank)  # the offset skipped
    assert not J.compare([(":c",), (":b",)], want, spec, rank)
    assert J.compare([(":v", 1)], [(":v", 1.0)], {"columns": ["v", "n"]}, rank)
    assert not J.compare([(":v", None)], [(":v", 1.0)], {"columns": ["v", "n"]}, rank)


def test_q7_pads_a_product_without_current_german_offers(graph):
    """OPTIONAL keeps the product's reviews with the offer's columns unbound."""
    for i in range(PRODUCTS):
        rows = bsbm.q7(graph, {"PRODUCT": f"inst:Product{i}", "DATE": "3000"})
        if rows[0][1] is None:
            break
    else:
        pytest.fail("every product has a current German offer")
    assert len(rows) == 10 and all(r[1:5] == (None,) * 4 and r[5] is not None for r in rows)
