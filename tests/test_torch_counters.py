"""The port's per-operator counters in ``stats.extra`` against the
reference's: the SIP filters' pruned rows and bloom probes on scans and
path leaves, the hash join's partitions, probe rows, exports and times,
the grouping's runs and kernel dispatches, and the expression programs'
instruction counts and dispatches.

The same stores (carried across with ``store_from_arrays``) and queries
run through both engines under several configurations; the two operator
trees are walked side by side and every counter that counts is equal,
while the ``_ms`` counters (host time) are present on the same operators.
Then the reference's own assertions on these counters, run on the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.data.lsqb import LSQB_QUERIES as RQ  # noqa: E402
from repro.data.lsqb import generate_social_graph as ref_social_graph  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core.algebra import AggSpec  # noqa: E402
from repro_torch.core.dictionary import Dictionary  # noqa: E402
from repro_torch.core.operators.aggregate import StreamingGroupBy  # noqa: E402
from repro_torch.core.operators.base import pending_counts  # noqa: E402
from repro_torch.core.operators.sort import MaterializedSource  # noqa: E402

CPU = torch.device("cpu")

# the counters, by how they compare: counts equal, times present
COUNTS = ("sip_pruned_rows", "sip_probe_dispatches", "hash_partitions", "hash_probe_rows",
          "sip_exports", "group_runs", "segment_reduce", "distinct_dedup", "expr_ops",
          "expr_dispatches")
TIMES = ("hash_build_ms", "hash_probe_ms", "segment_reduce_ms", "distinct_dedup_ms",
         "expr_eval_ms")


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


def _chain_store():
    """The reference SIP test's chain (tests/test_sip.py)."""
    store = RStore()
    for i in range(12):
        store.add(f":a{i}", ":r1", f":b{i}")
    for i in range(3000):
        store.add(f":b{i % 400}", ":r2", f":c{i % 350}")
        store.add(f":c{i % 350}", ":r3", f":d{i % 400}")
    for i in range(12):
        store.add(f":d{i}", ":r4", f":e{i}")
        store.add(f":e{i}", ":r5", f":f{i}")
    return store.build()


def _people_store():
    """The reference expression test's people (tests/test_exprs.py)."""
    store = RStore()
    names = ["alice", "albert", "bob", "carol", "dave", "eve", "mallory"]
    for i, nm in enumerate(names):
        store.add(f":p{i}", ":name", f'"{nm}"')
        store.add(f":p{i}", ":age", 20 + 5 * i)
        store.add(f":p{i}", ":knows", f":p{(i + 1) % len(names)}")
        if i % 2 == 0:
            store.add(f":p{i}", ":city", ":springfield")
    return store.build()


CHAIN_Q = ("SELECT ?a ?f { ?a :r1 ?b . ?b :r2 ?c . ?c :r3 ?d . "
           "?d :r4 ?e . ?e :r5 ?f }")
UNION_Q = ("SELECT ?a ?d { ?a :r1 ?b . ?b :r2 ?c . { ?c :r3 ?d } UNION { ?c :r3 ?d . "
           "?d :r4 ?e } }")
EXPR_Q = """
    SELECT ?p ?cat {
      ?p :name ?n . ?p :age ?a .
      FILTER(REGEX(?n, "^a") || CONTAINS(?n, "or"))
      BIND(IF(?a >= 30, 1, 0) AS ?cat)
    }
"""

CONFIGS = {
    "default": {},
    "sip-on": {"sip": "on"},
    "hash-on": {"join_strategy": "hash", "sip": "on"},
    "merge-on": {"join_strategy": "merge", "sip": "on"},
    "small-batches": {"sip": "on", "max_batch": 7},
}


def _walk(root):
    out = []
    stack = [root]
    while stack:
        op = stack.pop()
        out.append(op)
        stack.extend(reversed(op.children()))
    return out


def _counters(root):
    """(name, counted counters, time counters present) of every operator,
    in tree order."""
    return [(op.stats.name,
             {k: v for k, v in op.stats.extra.items() if k in COUNTS},
             sorted(k for k in op.stats.extra if k in TIMES))
            for op in _walk(root)]


def _both(ref_store, text, cfg):
    want = REngine(ref_store, RConfig(**cfg)).execute(text)
    got = repro_torch.Engine(_port_store(ref_store), repro_torch.EngineConfig(**cfg),
                             device="cpu").execute(text)
    assert sorted(map(tuple, got.rows.tolist())) == sorted(map(tuple, want.rows.tolist()))
    return got, want


_STORES = {}


def _store(name):
    if name not in _STORES:
        if name == "chain":
            _STORES[name] = _chain_store()
        elif name == "people":
            _STORES[name] = _people_store()
        else:
            _STORES[name] = ref_social_graph(scale=0.05, seed=3)[0]
    return _STORES[name]


CASES = [("chain", CHAIN_Q), ("chain", UNION_Q), ("people", EXPR_Q)] + [
    ("lsqb", RQ[q]) for q in ("q2", "q4", "q5", "q6")] + [
    ("lsqb", "SELECT ?p (COUNT(DISTINCT ?t) AS ?n) (SUM(?t) AS ?s) "
             "{ ?p :hasInterest ?t } GROUP BY ?p"),
]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["chain", "union", "expr", "q2", "q4", "q5", "q6", "distinct"])
def test_counters_match_the_reference(case, config):
    store_name, text = CASES[case]
    got, want = _both(_store(store_name), text, CONFIGS[config])
    g, w = _counters(got.root), _counters(want.root)
    assert [x[0] for x in g] == [x[0] for x in w]
    assert g == w


def test_sip_counters_on_the_chain_store():
    """The reference's assertion (tests/test_sip.py): SIP prunes probe rows
    or seeks past storage reads, and the operators account for it."""
    store = _store("chain")

    def totals(cfg):
        res, _ = _both(store, CHAIN_Q, cfg)
        agg = {"pruned": 0, "seeks": 0, "probes": 0}
        for op in _walk(res.root):
            agg["pruned"] += op.stats.extra.get("sip_pruned_rows", 0)
            agg["seeks"] += op.stats.extra.get("sip_range_seeks", 0)
            agg["probes"] += op.stats.extra.get("sip_probe_dispatches", 0)
        return agg

    on, off = totals({"sip": "on"}), totals({"sip": "off"})
    assert on["pruned"] + on["seeks"] > 0 and on["probes"] > 0
    assert off == {"pruned": 0, "seeks": 0, "probes": 0}


def test_grouped_query_accounts_for_segment_reduce():
    """The reference's assertion (tests/test_aggregate.py): a grouped query
    reports its segment_scan dispatches, their time and its runs, and the
    profile shows them."""
    store = RStore()
    for i, v in enumerate([1, 2, 2, 5, 7]):
        store.add(f":p{i % 2}", ":val", v)
    store.build()
    got, _ = _both(store, "SELECT ?p (SUM(?v) AS ?s) (COUNT(DISTINCT ?v) AS ?n) "
                          "{ ?p :val ?v } GROUP BY ?p", {})
    assert got.n_rows == 2
    found = {}
    for op in _walk(got.root):
        found.update({k: v for k, v in op.stats.extra.items()
                      if k.startswith(("group", "segment"))})
    assert found.get("segment_reduce", 0) > 0
    assert found.get("group_runs", 0) >= 2
    assert "segment_reduce_ms" in found
    assert "segment_reduce" in got.profile()


def test_distinct_dedup_timed_separately_from_segment_reduce():
    """The reference's assertion (tests/test_aggregate.py), on an operator
    drained by hand."""
    d = Dictionary()
    for i in range(8):
        d.encode(i)
    keys = np.sort(np.arange(64, dtype=np.int32) % 8)
    vals = (np.arange(64) % 5).astype(np.int32)
    src = MaterializedSource((0, 1), torch.from_numpy(np.stack([keys, vals])), 0, 32)
    op = StreamingGroupBy(src, 0, [AggSpec("sum", 1, True, 5), AggSpec("sum", 1, False, 6)],
                          d, CPU, batch_size=32)
    while op.next_batch() is not None:
        pass
    ex = op.stats.extra
    assert ex["segment_reduce"] > 0 and ex["distinct_dedup"] > 0
    assert "distinct_dedup_ms" in ex and "segment_reduce_ms" in ex


def test_expression_counters_in_the_profile():
    """The reference's assertion (tests/test_exprs.py)."""
    got, _ = _both(_store("people"), EXPR_Q, {})
    assert got.n_rows == 3
    prof = got.profile()
    assert "expr_ops" in prof and "expr_dispatches" in prof


def test_sip_counters_settle_with_the_row_counts():
    """The SIP counters stay on the device until the query's one settling
    copy, and reading ``extra`` before that reads nothing back: they are
    not there yet. The profile settles them."""
    store = _port_store(_store("chain"))
    eng = repro_torch.Engine(store, repro_torch.EngineConfig(sip="on", telemetry=False),
                             device="cpu")
    res = eng.execute(CHAIN_Q)
    pending = [op for op in _walk(res.root) if op.stats.sip is not None]
    assert pending, "telemetry off: nothing settles the SIP counters"
    assert not any("sip_pruned_rows" in op.stats.extra for op in pending)
    stats, dev = pending_counts(res.root)
    assert dev is not None and len(stats) == dev.shape[0]
    for s, v in zip(stats, dev.tolist()):
        s.settle(v)
    assert not any(op.stats.sip is not None for op in _walk(res.root))
    on = repro_torch.Engine(store, repro_torch.EngineConfig(sip="on"), device="cpu")
    assert _counters(on.execute(CHAIN_Q).root) == _counters(res.root)
    again = eng.execute(CHAIN_Q)
    assert "sip_pruned_rows" in again.profile()
    assert _counters(again.root) == _counters(res.root)
