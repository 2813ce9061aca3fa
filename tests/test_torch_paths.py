"""The PyTorch port's property paths against the JAX package, on the CPU.

Kernels: ``sorted_search`` and ``frontier_dedup`` (their plain versions,
which the wrappers take for CPU tensors) against the reference's numpy
oracle, its jnp mirror (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same seeded numpy inputs, with exact equality. At
the edges where Pallas pads (a query of INT32_MAX, a first candidate of
(INT32_MIN, INT32_MIN)) the port follows numpy.

Engine: the port's ``PathEngine(device="cpu")`` against the reference's,
pair for pair, and ``repro_torch.Engine.execute`` against
``repro.core.Engine(engine="barq")`` row for row on path queries under the
four (join_strategy, sip) configurations; the port's pool must balance
after every query.
"""

import dataclasses
import zlib
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import vecops as RV  # noqa: E402
from repro.core.batch import BatchPool as RPool  # noqa: E402
from repro.core.paths import PathEngine as RPathEngine  # noqa: E402
from repro.core.paths.expr import PAlt, PClosure, PInv, PLink, PSeq  # noqa: E402
from repro.kernels import ops  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import vecops as TV  # noqa: E402
from repro_torch.core.batch import BatchPool as TPool  # noqa: E402
from repro_torch.core.paths import PathEngine as TPathEngine  # noqa: E402
from repro_torch.core.paths import expr as TX  # noqa: E402
from repro_torch.kernels import frontier_dedup as FD  # noqa: E402
from repro_torch.kernels import sorted_search as SSR  # noqa: E402

REF_BACKENDS = ("numpy", "jax", "pallas")
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


# ---------------------------------------------------------------------------
# sorted_search
# ---------------------------------------------------------------------------


def _search_case(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()) % 1000)
    if name == "empty keys":
        return np.zeros(0, np.int32), rng.randint(-5, 50, 300).astype(np.int32)
    keys = np.sort(rng.randint(0, 400, 2500)).astype(np.int32)  # with repeats
    if name == "empty queries":
        return keys, np.zeros(0, np.int32)
    # below, above, on and between keys
    q = np.concatenate([rng.randint(-50, 450, 700), keys[rng.randint(0, len(keys), 300)],
                        [-1, 0, 399, 400, 10_000]]).astype(np.int32)
    if name == "one key":
        return keys[:1].copy(), q
    return keys, q


SEARCH_CASES = ("dups and gaps", "empty keys", "empty queries", "one key")


@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("case", SEARCH_CASES)
def test_sorted_search_matches_reference(backend, side, case):
    keys, q = _search_case(case)
    want = np.asarray(ops.sorted_search(keys, q, side, backend=backend))
    got = SSR.sorted_search(T(keys), T(q), side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(SSR.sorted_search_plain(T(keys), T(q), side).numpy(), want)


def test_sorted_search_counts_real_keys_only():
    """A query of INT32_MAX, side right: numpy counts the n keys; the
    Pallas kernel also counts its INT32_MAX padding. The port is numpy's."""
    keys = np.array([1, 5, 5, 9], np.int32)
    q = np.array([I32_MAX, I32_MIN, 5], np.int32)
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            SSR.sorted_search(T(keys), T(q), side).numpy(), RV.sorted_search(keys, q, side))
    assert int(np.asarray(ops.sorted_search(keys, q, "right", backend="pallas"))[0]) > len(keys)


def test_sorted_search_refuses_bad_input():
    with pytest.raises(ValueError, match="side"):
        SSR.sorted_search(T([1]), T([1]), "middle")
    with pytest.raises(ValueError, match="int32"):
        SSR.sorted_search(torch.tensor([1, 2]), T([1]))


# the kernel's layout: a bucket step over every B-th key, B = ceil(n /
# samples), then a binary search inside the bucket. Small sample counts
# make buckets of many keys at test sizes.
SAMPLE_COUNTS = (1, 7, 64, SSR.SAMPLES)


def _bucket_case(name):
    """Keys and queries that probe the bucket layout with ``samples``
    samples: runs of duplicates across bucket edges, n not a power of two,
    n below, at and above the sample count."""
    rng = np.random.RandomState(zlib.crc32(name.encode()) % 1000)
    n = {"n=1": 1, "n=63": 63, "n=65": 65, "n=1000": 1000, "one run": 500}[name]
    keys = (np.full(n, 3, np.int32) if name == "one run"
            else np.sort(rng.randint(0, max(2, n // 8), n)).astype(np.int32))
    q = np.concatenate([keys, keys - 1, keys + 1, rng.randint(-5, n // 8 + 5, 200),
                        [I32_MIN, I32_MIN + 1]]).astype(np.int32)
    return keys, q


BUCKET_CASES = ("n=1", "n=63", "n=65", "n=1000", "one run")


@pytest.mark.parametrize("samples", SAMPLE_COUNTS)
@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("case", BUCKET_CASES)
def test_sorted_search_bucket_model_matches_reference(case, backend, samples):
    keys, q = _bucket_case(case)
    for side in ("left", "right"):
        want = np.asarray(ops.sorted_search(keys, q, side, backend=backend))
        got = SSR.sorted_search_plain(T(keys), T(q), side, samples=samples)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("samples", SAMPLE_COUNTS)
def test_sorted_search_bucket_model_at_the_extremes(samples):
    """n = 0, and queries at INT32_MIN and INT32_MAX over keys that reach
    both ends, against the numpy oracle (the Pallas kernel counts its
    INT32_MAX padding there)."""
    keys = np.array([I32_MIN, I32_MIN, -7, 0, 0, 0, 5, I32_MAX - 1, I32_MAX, I32_MAX], np.int32)
    q = np.array([I32_MIN, I32_MIN + 1, -8, 0, 4, 5, I32_MAX - 1, I32_MAX], np.int32)
    for k in (keys, keys[:0], keys[:1], keys[-1:]):
        for side in ("left", "right"):
            np.testing.assert_array_equal(
                SSR.sorted_search_plain(T(k), T(q), side, samples=samples).numpy(),
                RV.sorted_search(k, q, side))


@pytest.mark.parametrize("case", SEARCH_CASES + BUCKET_CASES)
def test_sorted_search_range_matches_two_searches(case):
    keys, q = (_search_case if case in SEARCH_CASES else _bucket_case)(case)
    lo, hi = SSR.sorted_search_range(T(keys), T(q))
    assert lo.dtype == hi.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), SSR.sorted_search(T(keys), T(q), "left").numpy())
    np.testing.assert_array_equal(hi.numpy(), SSR.sorted_search(T(keys), T(q), "right").numpy())


def test_sorted_search_range_refuses_bad_input():
    with pytest.raises(ValueError, match="int32"):
        SSR.sorted_search_range(T([1, 2]), torch.tensor([1]))
    with pytest.raises(ValueError, match="device"):
        SSR.sorted_search_range(T([1]).to("meta"), T([1]).to("meta"))


# ---------------------------------------------------------------------------
# frontier_dedup
# ---------------------------------------------------------------------------


def _lexsorted(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order].astype(np.int32), lo[order].astype(np.int32)


def _dedup_case(name):
    rng = np.random.RandomState(len(name) * 31)
    hi, lo = _lexsorted(rng.randint(0, 30, 1500), rng.randint(0, 60, 1500))
    u = np.unique(np.stack([hi, lo], 1), axis=0)
    vis = u[rng.rand(len(u)) < 0.4]
    vh, vl = vis[:, 0].astype(np.int32), vis[:, 1].astype(np.int32)
    none = np.zeros(0, np.int32)
    if name == "random with visited":
        return hi, lo, vh, vl
    if name == "empty visited":
        return hi, lo, none, none
    if name == "empty candidates":
        return none, none, vh, vl
    if name == "all duplicates":
        return np.full(700, 4, np.int32), np.full(700, 9, np.int32), vh, vl
    if name == "all visited":
        return hi, lo, u[:, 0].astype(np.int32), u[:, 1].astype(np.int32)
    if name == "duplicates across the 512 block":
        # runs of equal pairs straddling candidate 512 and 1024
        hi = np.repeat(np.arange(200, dtype=np.int32), 7)[:1400]
        lo = np.zeros(1400, np.int32)
        return hi, lo, vh[:50], vl[:50]
    raise KeyError(name)


DEDUP_CASES = ("random with visited", "empty visited", "empty candidates", "all duplicates",
               "all visited", "duplicates across the 512 block")


@pytest.mark.parametrize("backend", REF_BACKENDS)
@pytest.mark.parametrize("case", DEDUP_CASES)
def test_frontier_dedup_matches_reference(backend, case):
    ch, cl, vh, vl = _dedup_case(case)
    want = np.asarray(ops.frontier_dedup(ch, cl, vh, vl, backend=backend), dtype=bool)
    got = FD.frontier_dedup(T(ch), T(cl), T(vh), T(vl))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(FD.frontier_dedup_plain(T(ch), T(cl), T(vh), T(vl)).numpy(),
                                  want)


def test_frontier_dedup_first_candidate_has_no_sentinel():
    """(INT32_MIN, INT32_MIN) first: numpy keeps it, the Pallas kernel
    drops it (its neighbour padding). The port is numpy's."""
    ch = np.array([I32_MIN, I32_MIN, 3], np.int32)
    cl = np.array([I32_MIN, I32_MIN, 4], np.int32)
    none = np.zeros(0, np.int32)
    want = RV.frontier_dedup(ch, cl, none, none)
    np.testing.assert_array_equal(want, [True, False, True])
    np.testing.assert_array_equal(FD.frontier_dedup(T(ch), T(cl), T(none), T(none)).numpy(), want)


def test_frontier_dedup_orders_signed_pairs():
    """Signed pairs (outside the engine's domain, where numpy's composite
    key breaks): the plain version, like the CUDA kernel, compares the two
    int32 columns as signed values; a set-based oracle pins it."""
    rng = np.random.RandomState(5)
    vals = np.array([I32_MIN, -7, -1, 0, 1, 9, I32_MAX])
    ch, cl = _lexsorted(rng.choice(vals, 400), rng.choice(vals, 400))
    vis = np.unique(np.stack(_lexsorted(rng.choice(vals, 30), rng.choice(vals, 30)), 1), axis=0)
    seen = {tuple(p) for p in vis.tolist()}
    want = [(j == 0 or (ch[j], cl[j]) != (ch[j - 1], cl[j - 1])) and (ch[j], cl[j]) not in seen
            for j in range(len(ch))]
    got = FD.frontier_dedup(T(ch), T(cl), T(vis[:, 0]), T(vis[:, 1]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_merge_sorted_pairs_matches_reference():
    rng = np.random.RandomState(2)
    u = np.unique(np.stack([rng.randint(0, 40, 900), rng.randint(0, 40, 900)], 1), axis=0)
    pick = rng.rand(len(u)) < 0.5
    a, b = u[pick].astype(np.int32), u[~pick].astype(np.int32)
    none = np.zeros(0, np.int32)
    for ah, al, bh, bl in ((a[:, 0], a[:, 1], b[:, 0], b[:, 1]), (none, none, b[:, 0], b[:, 1]),
                           (a[:, 0], a[:, 1], none, none)):
        want = RV.merge_sorted_pairs(ah, al, bh, bl)
        tb_hi, tb_lo = T(bh), T(bl)
        got = TV.merge_sorted_pairs(T(ah), T(al), tb_hi, tb_lo)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        if len(bh):  # callers recycle b's buffer: the result must not alias it
            assert got[0].data_ptr() != tb_hi.data_ptr()


# ---------------------------------------------------------------------------
# the frontier engine
# ---------------------------------------------------------------------------


def _ref_store(edges):
    s = RStore()
    for p, a, b in edges:
        s.add(f":n{a}", f":{p}", f":n{b}")
    return s.build()


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


def _rand_edges(seed, n_nodes, n_edges):
    rng = np.random.RandomState(seed)
    return [("pq"[rng.randint(2)], int(rng.randint(n_nodes)), int(rng.randint(n_nodes)))
            for _ in range(n_edges)]


GRAPHS = {
    "chain": [("p", i, i + 1) for i in range(12)] + [("q", i, i + 2) for i in range(0, 10, 3)],
    "cycles": [("p", 0, 1), ("p", 1, 2), ("p", 2, 0), ("q", 2, 3), ("q", 3, 3), ("p", 4, 4)],
    "random": _rand_edges(11, 30, 90),
    "random dense": _rand_edges(12, 12, 80),
}

EXPRS = {
    "link": PLink(":p"),
    "inverse": PInv(PLink(":p")),
    "sequence": PSeq((PLink(":p"), PLink(":q"))),
    "alternation": PAlt((PLink(":p"), PInv(PLink(":q")))),
    "plus": PClosure(PLink(":p"), 1),
    "star": PClosure(PLink(":p"), 0),
    "optional": PClosure(PLink(":p"), 0, 1),
    "plus of alternation": PClosure(PAlt((PLink(":p"), PLink(":q"))), 1),
    "sequence of closure": PSeq((PClosure(PLink(":p"), 1), PLink(":q"))),
    "unknown predicate": PClosure(PLink(":nope"), 1),
}


def _port_expr(e):
    """The same AST in the port's classes."""
    if isinstance(e, PLink):
        return TX.PLink(e.pred)
    if isinstance(e, PInv):
        return TX.PInv(_port_expr(e.sub))
    if isinstance(e, PSeq):
        return TX.PSeq(tuple(_port_expr(p) for p in e.parts))
    if isinstance(e, PAlt):
        return TX.PAlt(tuple(_port_expr(p) for p in e.parts))
    return TX.PClosure(_port_expr(e.sub), e.min_hops, e.max_hops)


@pytest.fixture(scope="module")
def graph_stores():
    out = {}
    for name, edges in GRAPHS.items():
        ref = _ref_store(edges)
        out[name] = (ref, _port_store(ref))
    return out


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("expr", sorted(EXPRS))
def test_path_engine_matches_reference(graph_stores, graph, expr):
    ref_store, port_store = graph_stores[graph]
    want = RPathEngine(ref_store, RPool(), backend="numpy").evaluate(EXPRS[expr])
    pool = TPool("cpu")
    got = TPathEngine(port_store, pool).evaluate(_port_expr(EXPRS[expr]))
    np.testing.assert_array_equal(got.src.numpy(), want.src)
    np.testing.assert_array_equal(got.dst.numpy(), want.dst)
    c = pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("expr", ["plus", "star", "optional", "sequence", "plus of alternation"])
@pytest.mark.parametrize("graph", ["random", "cycles"])
def test_path_engine_seeds_match_reference(graph_stores, graph, expr, reverse):
    ref_store, port_store = graph_stores[graph]
    codes = sorted({ref_store.dict.lookup(f":n{i}") for i in (0, 2, 3, 7)} - {None})
    seeds = np.asarray(codes, np.int32)
    r_eng = RPathEngine(ref_store, RPool(), backend="numpy")
    t_eng = TPathEngine(port_store, TPool("cpu"))
    want = r_eng.evaluate(EXPRS[expr], seeds=seeds, reverse=reverse)
    got = t_eng.evaluate(_port_expr(EXPRS[expr]), seeds=T(seeds), reverse=reverse)
    np.testing.assert_array_equal(got.src.numpy(), want.src)
    np.testing.assert_array_equal(got.dst.numpy(), want.dst)
    assert t_eng.counters.as_dict() == r_eng.counters.as_dict()


def test_path_engine_counters_match_reference(graph_stores):
    ref_store, port_store = graph_stores["random dense"]
    r_eng = RPathEngine(ref_store, RPool(), backend="numpy")
    t_eng = TPathEngine(port_store, TPool("cpu"))
    r_eng.evaluate(EXPRS["plus of alternation"])
    t_eng.evaluate(_port_expr(EXPRS["plus of alternation"]))
    assert dataclasses.asdict(t_eng.counters) == dataclasses.asdict(r_eng.counters)
    assert t_eng.counters.rounds > 1 and t_eng.counters.dedup_ratio < 1.0


# ---------------------------------------------------------------------------
# Engine.execute parity
# ---------------------------------------------------------------------------

CONFIGS = {"merge-off": ("merge", "off"), "default": (None, None),
           "hash-off": ("hash", "off"), "merge-on": ("merge", "on")}

SOCIAL_QUERIES = {
    "reverse closure": "SELECT ?x { ?x :knows+ :person0 }",
    "forward closure joined with a scan": """
        SELECT ?x ?t { :person3 :knows+ ?x . ?x :hasInterest ?t }""",
    "closure joined with a scan, free subject": """
        SELECT ?x ?y ?c { ?x :knows+ ?y . ?y :isLocatedIn ?c }""",
    "reply closure": "SELECT ?m ?r { ?m :replyOf+ ?r }",
    "composition": "SELECT ?x ?y { ?x :knows/:knows ?y }",
    "alternation and inverse": "SELECT ?x ?y { ?x (:knows|^:knows) ?y }",
    "both bound": "SELECT (COUNT(*) AS ?n) { :person1 :knows+ :person0 }",
    "cycles": "SELECT ?x { ?x :knows+ ?x }",
    "zero or more from a constant": "SELECT ?y { :person5 :knows* ?y }",
    "count of a closure": "SELECT (COUNT(*) AS ?n) { ?x :knows+ ?y }",
}

CHAIN_QUERIES = {
    "star": "SELECT ?x ?y { ?x :p* ?y }",
    "optional": "SELECT ?x ?y { ?x :p? ?y }",
    "inverse plus": "SELECT ?x ?y { ?x ^:p+ ?y }",
    "plus of a sequence": "SELECT ?x ?y { ?x (:p/:p)+ ?y }",
    "plus of alternation": "SELECT ?x ?y { ?x (:p|^:p)+ ?y }",
    "bound subject": "SELECT ?y { :n2 :p* ?y }",
    "bound object": "SELECT ?x { ?x :p+ :n8 }",
    # no variable: a 0/1-row existence check (joining it to another
    # pattern would be a cross product, which the port does not run yet)
    "both bound, reachable": "SELECT (COUNT(*) AS ?n) { :n0 :p+ :n5 }",
    "both bound, unreachable": "SELECT (COUNT(*) AS ?n) { :n5 :p+ :n0 }",
    "unknown constant": "SELECT ?y { :nowhere :p+ ?y }",
    "path joined with a scan": "SELECT ?x ?y ?z { ?x :p+ ?y . ?y :q ?z }",
}


def _rows(res, store):
    return Counter(tuple(sorted(r.items())) for r in res.decoded(store.dict))


def _engine_pair(ref_store, port_store, cfg):
    js, sip = CONFIGS[cfg]
    return (REngine(ref_store, RConfig(join_strategy=js, sip=sip)),
            repro_torch.Engine(port_store, repro_torch.EngineConfig(join_strategy=js, sip=sip),
                               device="cpu"))


@pytest.fixture(scope="module")
def social_pair(social_store):
    ref = social_store[0]
    return ref, _port_store(ref)


@pytest.fixture(scope="module")
def chain_pair():
    ref = _ref_store([("p", i, i + 1) for i in range(8)] + [("q", i, i) for i in range(0, 9, 2)]
                     + [("p", 8, 8)])
    return ref, _port_store(ref)


def _check_query(pair, cfg, text):
    ref, port = _engine_pair(*pair, cfg)
    want = ref.execute(text)
    got = port.execute(text)
    assert _rows(got, port.store) == _rows(want, ref.store)
    c = port.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
    return got


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(SOCIAL_QUERIES))
def test_social_path_query_matches_reference(social_pair, cfg, name):
    _check_query(social_pair, cfg, SOCIAL_QUERIES[name])


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(CHAIN_QUERIES))
def test_chain_path_query_matches_reference(chain_pair, cfg, name):
    _check_query(chain_pair, cfg, CHAIN_QUERIES[name])


def test_path_expand_skip_lands_on_the_target(chain_pair):
    """skip() on the sorted primary column: the next batch starts at the
    first pair whose subject is >= the target."""
    from repro_torch.core.algebra import V
    from repro_torch.core.operators.path import PathExpand

    port = chain_pair[1]
    op = PathExpand(port, TX.PClosure(TX.PLink(":p"), 1), V(0), V(1), batch_size=4,
                    pool=TPool("cpu"))
    first = op.next_batch()
    target = int(first.column(0)[0]) + 3
    first.release()
    op.skip(0, target)
    b = op.next_batch()
    assert int(b.column(0)[0]) >= target
    b.release()
    assert op.sorted_by() == 0 and op.can_skip(0) and not op.can_skip(1)


# ---------------------------------------------------------------------------
# chip_smoke.py's closed forms for p1-p5, held against both engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_paths", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the full-size source does not exist at this size
    mod.PATH_QUERIES["p2"] = mod.PATH_QUERIES["p2"].replace(mod.P2_SOURCE, ":person7")
    mod.P2_SOURCE = ":person7"
    return mod


@pytest.mark.parametrize("name", ["p1", "p2", "p3", "p4", "p5"])
def test_path_closed_forms_match_the_engines(chip_smoke, social_pair, name):
    ref_store, port_store = social_pair
    want = chip_smoke.path_closed_forms(ref_store)[name]
    text = chip_smoke.PATH_QUERIES[name]
    ref, port = _engine_pair(ref_store, port_store, "default")
    for engine, store in ((ref, ref_store), (port, port_store)):
        (row,) = engine.execute(text).decoded(store.dict)
        assert row["n"] == want
    assert want > 0


def test_path_engine_makes_one_range_search_per_expansion(graph_stores, monkeypatch):
    """Each successor expansion finds both ends of its ranges with one
    ``sorted_search_range`` call, not a left and a right search."""
    from repro_torch.core.paths import engine as path_engine

    calls = Counter()
    search, expand = path_engine.sorted_search_range, TPathEngine._expand

    def counted_search(*args):
        calls["search"] += 1
        return search(*args)

    def counted_expand(self, *args):
        calls["expand"] += 1
        return expand(self, *args)

    monkeypatch.setattr(path_engine, "sorted_search_range", counted_search)
    monkeypatch.setattr(TPathEngine, "_expand", counted_expand)
    ref_store, port_store = graph_stores["random"]
    want = RPathEngine(ref_store, RPool(), backend="numpy").evaluate(EXPRS["plus of alternation"])
    got = TPathEngine(port_store, TPool("cpu")).evaluate(_port_expr(EXPRS["plus of alternation"]))
    np.testing.assert_array_equal(got.dst.numpy(), want.dst)
    assert calls["expand"] > 0 and calls["search"] == calls["expand"]
