"""The port's workload history (``query_fingerprint``, the planner's node
fingerprints, ``CardinalityFeedback``) and the engine's cardinality
feedback against the JAX package's, on the CPU.

The same texts and stores go through both packages: template fingerprints
ignore variable names, whitespace and literal values; node fingerprints are
stable and equal to the reference's; the feedback store's EWMA, eviction
and weighted merge give the reference's state; ``"apply"`` re-plans a
misestimated query with its observed cardinalities and marks them
``(source=feedback)``, ``"off"`` plans byte-identically to the default,
``"observe"`` records without re-planning, and the store's version enters
the plan fingerprint under ``"apply"`` only. Traces opened in two threads
keep their dispatches apart.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import telemetry as RTel  # noqa: E402
from repro.core.profiler import collect_stats as rcollect_stats  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import CardinalityFeedback, collect_stats, query_fingerprint, telemetry  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402


def _chain_store(n=120):
    store = RStore()
    for i in range(n):
        store.add(f":p{i}", ":knows", f":p{(i * 7 + 1) % n}")
        store.add(f":p{i}", ":age", 20 + i % 30)
        store.add(f":p{i}", ":interest", f":tag{i % 5}")
    return store.build()


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


@pytest.fixture(scope="module")
def chain():
    ref = _chain_store()
    return ref, _port_store(ref)


def _engine(chain, **cfg):
    return repro_torch.Engine(chain[1], repro_torch.EngineConfig(**cfg), device="cpu")


def _ref_engine(chain, **cfg):
    return REngine(chain[0], RConfig(**cfg))


def _fingerprints(chain, text):
    port = _engine(chain).parse(text)[0]
    ref = _ref_engine(chain).parse(text)[0]
    return query_fingerprint(port), RTel.query_fingerprint(ref)


# ---------------------------------------------------------------------------
# template fingerprints
# ---------------------------------------------------------------------------

SAME_AS_BASE = {
    "renamed": "SELECT  ?person  { ?person :age ?n .  FILTER( ?n > 42 ) }",
    "base": "SELECT ?a { ?a :age ?x . FILTER(?x > 25) }",
}
NOT_BASE = {
    "predicate": "SELECT ?a { ?a :knows ?x . FILTER(?x > 25) }",
    "no filter": "SELECT ?a { ?a :age ?x }",
    "one hop": "SELECT ?a ?b { ?a :knows ?b }",
    "two hops": "SELECT ?a ?c { ?a :knows ?b . ?b :knows ?c }",
}


@pytest.mark.parametrize("text", list(SAME_AS_BASE.values()) + list(NOT_BASE.values()),
                         ids=list(SAME_AS_BASE) + list(NOT_BASE))
def test_query_fingerprint_matches_reference(chain, text):
    """Fingerprints equal the reference's; variable names, whitespace and
    literal values do not enter them, predicates and structure do."""
    port, ref = _fingerprints(chain, text)
    assert port == ref
    base = _fingerprints(chain, SAME_AS_BASE["base"])[0]
    assert (port == base) == (text in SAME_AS_BASE.values())


def test_query_fingerprint_distinguishes_join_shapes(chain):
    one, two = (_fingerprints(chain, NOT_BASE[k])[0] for k in ("one hop", "two hops"))
    assert one != two


# ---------------------------------------------------------------------------
# node fingerprints and the feedback store
# ---------------------------------------------------------------------------


def _plan_fps(n, acc):
    acc.append(n.fp)
    for fld in ("child", "left", "right", "probe", "build"):
        c = getattr(n, fld, None)
        if hasattr(c, "fp"):
            _plan_fps(c, acc)
    return acc


def test_node_fingerprints_stable_and_match_reference(chain):
    q = "SELECT ?a ?b { ?a :knows ?b . ?b :age ?x }"
    eng, ref = _engine(chain), _ref_engine(chain)
    p1 = _plan_fps(eng.plan(eng.parse(q)[0]), [])
    p2 = _plan_fps(eng.plan(eng.parse(q)[0]), [])
    r = _plan_fps(ref.plan(ref.parse(q)[0]), [])
    assert p1 == p2 == r and all(p1)


def _feed(cls):
    fb = cls(alpha=0.5, max_entries=3)
    fb.record("a", 100.0)
    fb.record("a", 200.0)  # EWMA: 0.5*200 + 0.5*100
    fb.record("", 5.0)  # no fingerprint: ignored
    fb.record("b", 10.0)
    fb.record("c", 20.0)
    fb.record("d", 30.0)  # over capacity: the least-observed entry goes
    other = cls()
    other.merge(fb.snapshot())
    third = cls()
    third.record("a", 300.0)
    third.merge({"a": [150.0, 2]})  # count-weighted: 2 at 150 + 1 at 300
    return fb, other, third


def test_cardinality_feedback_ewma_merge_eviction():
    fb, other, third = _feed(CardinalityFeedback)
    rfb, rother, rthird = _feed(RTel.CardinalityFeedback)
    for a, b in ((fb, rfb), (other, rother), (third, rthird)):
        assert a.snapshot() == b.snapshot() and a.version == b.version and len(a) == len(b)
    assert fb.lookup("a") == pytest.approx(150.0) and fb.observations("a") == 2
    assert fb.lookup("missing") is None and len(fb) == 3
    assert other.lookup("a") == fb.lookup("a")
    assert third.lookup("a") == pytest.approx(200.0) and third.observations("a") == 3


# ---------------------------------------------------------------------------
# the feedback loop through the engine
# ---------------------------------------------------------------------------

MISEST = ("SELECT ?a ?c { ?a :knows ?b . ?b :knows ?c . ?c :age ?x . "
          "FILTER(?x > 25) }")


def test_feedback_apply_overrides_estimates_and_shows_source(chain):
    """The second run re-plans with the first one's actual rows: its
    q-errors converge, as the reference's do, and the estimates it used
    show their source."""
    eng = _engine(chain, cardinality_feedback="apply")
    ref = _ref_engine(chain, cardinality_feedback="apply")
    r1, rr1 = eng.execute(MISEST), ref.execute(MISEST)
    assert eng.explain(MISEST) == ref.explain(MISEST)
    r2, rr2 = eng.execute(MISEST), ref.execute(MISEST)
    assert r1.n_rows == r2.n_rows == rr2.n_rows
    q1 = collect_stats(r1.root).get("max_q_error", 1.0)
    q2 = collect_stats(r2.root).get("max_q_error", 1.0)
    assert q1 == rcollect_stats(rr1.root).get("max_q_error", 1.0)
    assert q2 == rcollect_stats(rr2.root).get("max_q_error", 1.0)
    assert q2 <= max(2.0, q1) and q2 <= 2.0
    assert "MISEST" not in r2.explain_analyze()
    assert "(source=feedback)" in eng.explain(MISEST)
    assert "(source=feedback)" in r2.explain_analyze()
    assert eng.feedback.snapshot() == ref.feedback.snapshot()


def test_feedback_off_is_byte_identical_and_observe_changes_nothing(chain):
    default = _engine(chain)
    off = _engine(chain, cardinality_feedback="off")
    obs = _engine(chain, cardinality_feedback="observe")
    assert off.explain(MISEST) == default.explain(MISEST) == _ref_engine(chain).explain(MISEST)
    obs.execute(MISEST)
    assert obs.explain(MISEST) == default.explain(MISEST)
    assert len(obs.feedback) > 0 and off.feedback is None
    robs = _ref_engine(chain, cardinality_feedback="observe")
    robs.execute(MISEST)
    assert obs.feedback.snapshot() == robs.feedback.snapshot()


def test_feedback_shared_store_and_version_in_plan_fingerprint(chain):
    """A caller-shared store fills from an observing engine and steers an
    applying one; only ``"apply"`` folds the version into the plan
    fingerprint, as in the reference."""
    shared = CardinalityFeedback()
    ap = repro_torch.Engine(chain[1], repro_torch.EngineConfig(cardinality_feedback="apply"),
                            device="cpu", feedback=shared)
    obs = repro_torch.Engine(chain[1],
                             repro_torch.EngineConfig(cardinality_feedback="observe"),
                             device="cpu", feedback=shared)
    fp_ap, fp_obs = ap.plan_fingerprint(), obs.plan_fingerprint()
    assert fp_ap == _ref_engine(chain, cardinality_feedback="apply").plan_fingerprint()
    obs.execute(MISEST)
    assert obs.plan_fingerprint() == fp_obs
    assert ap.plan_fingerprint() != fp_ap and ap.feedback is shared
    assert "(source=feedback)" in ap.explain(MISEST)


# ---------------------------------------------------------------------------
# traces in threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tel", [RTel, telemetry], ids=["reference", "port"])
def test_trace_query_threads_do_not_leak_dispatches(tel):
    """Two threads tracing at once each see only their own dispatches: the
    active trace is a context variable, not a global."""
    results = {}
    barrier = threading.Barrier(2)

    def worker(name, n_dispatches):
        tr = tel.QueryTrace(name)
        barrier.wait()
        with tel.trace_query(trace=tr):
            for _ in range(n_dispatches):
                tel.record_dispatch(f"k_{name}", "plain", time.perf_counter(), 1e-6)
                time.sleep(0.001)
        results[name] = tr.ledger

    threads = [threading.Thread(target=worker, args=a) for a in (("alpha", 7), ("beta", 11))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert dict(results["alpha"].counts) == {"k_alpha": 7}
    assert dict(results["beta"].counts) == {"k_beta": 11}
