"""The port's adaptive merge join (``AdaptiveMergeJoin``) against the JAX
package's, on the CPU.

The same numpy inputs go through both operators: an accurate build
estimate keeps the merge, a badly low one switches to the hash join, an
over-estimate keeps the merge; rows must be equal as multisets and the
decision counters (``adaptive_switches``, ``adaptive_qerror``) equal. Then
the engine under ``EngineConfig(join_strategy="merge",
adaptive_join="on")``: plans marked ``adaptive`` as the reference marks
them, both branches through ``Engine.execute_plan``, and the LSQB and
BSBM BI queries with the adaptive join on.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core.operators.adaptive_join import AdaptiveMergeJoin as RAdaptive  # noqa: E402
from repro.core.operators.merge_join import MergeJoin as RMergeJoin  # noqa: E402
from repro.core.operators.sort import MaterializedSource as RSource  # noqa: E402
from repro.data.bsbm import BSBM_BI_QUERIES  # noqa: E402
from repro.data.bsbm import generate_ecommerce_graph as ref_bsbm  # noqa: E402
from repro.data.lsqb import LSQB_QUERIES  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import planner as PL  # noqa: E402
from repro_torch.core.batch import BatchPool  # noqa: E402
from repro_torch.core.operators.adaptive_join import AdaptiveMergeJoin  # noqa: E402
from repro_torch.core.operators.hash_join import HashJoin  # noqa: E402
from repro_torch.core.operators.merge_join import MergeJoin  # noqa: E402
from repro_torch.core.operators.sort import MaterializedSource  # noqa: E402
from repro_torch.core.profiler import QERROR_FLAG, q_error  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these inputs are small, and the test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODES = ("inner", "left_outer", "semi", "anti")


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ref_rows(op):
    rows = []
    for b in op.drain():
        c = b.compact()
        rows.extend(tuple(r) for r in c.to_rows_array().tolist())
        c.release()
    return Counter(rows)


def _port_rows(op):
    rows = []
    while (b := op.next_batch()) is not None:
        c = b.compact()
        rows.extend(tuple(r) for r in c.columns[:, : c.n_rows].T.tolist())
        c.release()
    return Counter(rows)


def _inputs(seed=0, n=6000):
    rng = np.random.RandomState(seed)
    l = np.stack([np.sort(rng.randint(-1, 2000, n)), rng.randint(0, 100, n)]).astype(np.int32)
    r = np.stack([rng.randint(-1, 2000, n // 2), rng.randint(0, 100, n // 2)]).astype(np.int32)
    return l, r


def _pair(l, r, mode, est):
    ref = RAdaptive(RSource((0, 1), l, 0, 1024), RSource((0, 2), r, None, 1024), 0,
                    mode=mode, est_build=est)
    pool = BatchPool(CPU)
    port = AdaptiveMergeJoin(MaterializedSource((0, 1), T(l), 0, 1024, pool=pool),
                             MaterializedSource((0, 2), T(r), None, 1024, pool=pool), 0, CPU,
                             mode=mode, est_build=est, pool=pool)
    return ref, port, pool


def test_q_error_matches_reference():
    from repro.core import profiler as RProf

    assert QERROR_FLAG == RProf.QERROR_FLAG
    for est, act in ((0, 0), (10, 3000), (3000, 10), (5.5, 5.5), (1e9, 4000)):
        assert q_error(est, act) == RProf.q_error(est, act)


@pytest.mark.parametrize("branch", ["merge", "hash"])
@pytest.mark.parametrize("mode", MODES)
def test_adaptive_join_both_branches_match_reference(mode, branch):
    l, r = _inputs()
    rs = r[:, np.argsort(r[0], kind="stable")]
    base = _ref_rows(RMergeJoin(RSource((0, 1), l, 0), RSource((0, 2), rs, 0), 0, mode=mode))
    est = float(r.shape[1]) if branch == "merge" else 10.0
    ref, port, pool = _pair(l, r, mode, est)
    assert port.sorted_by() is None
    got = _port_rows(port)
    assert got == _ref_rows(ref) == base
    assert port.stats.extra == {k: ref.stats.extra[k] for k in ("adaptive_switches", "adaptive_qerror")}
    assert f"-> {branch}" in port.stats.detail and port.stats.detail == ref.stats.detail
    inner = port.children()[0]
    assert isinstance(inner, HashJoin if branch == "hash" else MergeJoin)
    if branch == "hash":
        assert port.stats.extra["adaptive_switches"] == 1 and port.stats.extra["adaptive_qerror"] >= 4.0
    c = pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c


def test_adaptive_join_overestimate_keeps_merge():
    """After an over-estimate the sort is cheaper than planned: switching
    would only add a hash build."""
    l, r = _inputs(seed=1, n=4000)
    ref, port, _ = _pair(l, r, "inner", 1e9)
    assert _port_rows(port) == _ref_rows(ref)
    assert port.stats.extra["adaptive_switches"] == ref.stats.extra["adaptive_switches"] == 0


def test_adaptive_join_small_build_keeps_merge():
    """Under 16 rows the sort costs no more than the hash build (4n <=
    n log2 n fails), whatever the q-error."""
    l, r = _inputs(seed=2, n=24)
    ref, port, _ = _pair(l, r, "inner", 1.0)
    assert _port_rows(port) == _ref_rows(ref)
    assert port.stats.extra["adaptive_switches"] == ref.stats.extra["adaptive_switches"] == 0


def test_adaptive_join_reset_decides_again():
    l, r = _inputs(seed=3, n=3000)
    _, port, _ = _pair(l, r, "inner", 10.0)
    first = _port_rows(port)
    port.reset()
    assert port.children()[0] is port.left
    assert _port_rows(port) == first and port.stats.extra["adaptive_switches"] == 1


# ---------------------------------------------------------------------------
# the planner's marks and the engine
# ---------------------------------------------------------------------------


def _store(n=3000, seed=7):
    rng = np.random.RandomState(seed)
    store = RStore()
    for i in range(n):
        store.add(f":s{i:05d}", ":knows", f":o{rng.randint(0, 400):05d}")
    for i in range(n * 2 // 3):
        store.add(f":t{i:05d}", ":likes", f":o{rng.randint(0, 400):05d}")
        store.add(f":t{i:05d}", ":age", int(rng.randint(0, 100)))
    return store.build()


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


Q3 = "SELECT ?a ?x ?g { ?a :knows ?x . ?b :likes ?x . ?b :age ?g }"


@pytest.fixture(scope="module")
def stores():
    ref = _store()
    return ref, _port_store(ref)


def _find(op, cls):
    if isinstance(op, cls):
        return op
    for c in op.children():
        found = _find(c, cls)
        if found is not None:
            return found
    return None


def _force_misestimate(phys, est=10.0):
    """Shrink the planner's build-side estimates in place."""
    if isinstance(phys, PL.PMergeJoin) and isinstance(phys.right, PL.PSort):
        phys.right.est_rows = est
    for f in dataclasses.fields(phys):
        v = getattr(phys, f.name)
        if isinstance(v, PL.Phys):
            _force_misestimate(v, est)


def test_planner_marks_match_reference(stores):
    ref_store, port_store = stores
    cfg = dict(join_strategy="merge", adaptive_join="on")
    ref = REngine(ref_store, RConfig(**cfg))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(**cfg), device="cpu")
    for q in (Q3, "SELECT ?x (COUNT(*) AS ?c) { ?a :knows ?x . ?b :likes ?x } GROUP BY ?x"):
        assert port.explain(q) == ref.explain(q)
    assert "adaptive" in port.explain(Q3)
    off = repro_torch.Engine(port_store, repro_torch.EngineConfig(join_strategy="merge"),
                             device="cpu")
    assert port.explain(Q3).replace(" adaptive", "") == off.explain(Q3)


@pytest.mark.parametrize("forced", [False, True], ids=["as planned", "forced misestimate"])
def test_engine_adaptive_join_matches_merge_path(stores, forced):
    ref_store, port_store = stores
    base = REngine(ref_store, RConfig(join_strategy="merge"))
    want = Counter(map(tuple, base.execute(Q3).rows.tolist()))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(
        join_strategy="merge", adaptive_join="on"), device="cpu")
    node, vt = port.parse(Q3)
    phys = port.plan(node)
    if forced:
        _force_misestimate(phys)
    res = port.execute_plan(phys, vt)
    assert Counter(map(tuple, res.rows.tolist())) == want
    aj = _find(res.root, AdaptiveMergeJoin)
    assert aj is not None and aj.stats.extra["adaptive_switches"] == int(forced)
    assert ("-> hash" in aj.stats.detail) == forced
    off = repro_torch.Engine(port_store, repro_torch.EngineConfig(join_strategy="merge"),
                             device="cpu")
    assert _find(off.execute(Q3).root, AdaptiveMergeJoin) is None


@pytest.fixture(scope="module")
def bsbm_stores():
    ref, _ = ref_bsbm(scale=0.1, seed=7)
    return ref, _port_store(ref)


def _decoded(res, store):
    return Counter(tuple(sorted(r.items())) for r in res.decoded(store.dict))


WORK = [("lsqb", n, LSQB_QUERIES[n]) for n in sorted(LSQB_QUERIES)] + \
       [("bsbm", n, BSBM_BI_QUERIES[n]) for n in sorted(BSBM_BI_QUERIES)]


@pytest.mark.parametrize("store,name,text", WORK, ids=[w[1] for w in WORK])
def test_engine_with_adaptive_join_matches_reference(social_store, bsbm_stores, store, name,
                                                     text):
    if store == "lsqb":
        ref_store = social_store[0]
        port_store = _port_store(ref_store)
    else:
        ref_store, port_store = bsbm_stores
    cfg = dict(join_strategy="merge", adaptive_join="on")
    ref = REngine(ref_store, RConfig(**cfg))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(**cfg), device="cpu")
    assert port.explain(text) == ref.explain(text)
    assert _decoded(port.execute(text), port_store) == _decoded(ref.execute(text), ref_store)
