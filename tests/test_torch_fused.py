"""The port's fused whole-BGP counts (``repro_torch.core.fused``) against the
reference's ``repro.core.fused``, the port's own engine, and an int64
numpy closed form where the reference's int32 arithmetic wraps."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import QuadStore as RefQuadStore  # noqa: E402
from repro.core.fused import fused_chain_count as ref_chain  # noqa: E402
from repro.core.fused import fused_q6_count as ref_q6  # noqa: E402
from repro.data import generate_social_graph as ref_social_graph  # noqa: E402
from repro_torch.core.fused import fused_chain_count, fused_q6_count  # noqa: E402

CHAINS = {
    "chain2": [":knows", ":hasInterest"],
    "chain3": [":knows", ":knows", ":hasInterest"],
}
Q6 = """SELECT (COUNT(*) AS ?c) {
          ?p1 :knows ?p2 . ?p2 :knows ?p3 . ?p3 :hasInterest ?t .
          FILTER (?p1 != ?p3)
        }"""
CHAIN_TEXT = {
    "chain2": "SELECT (COUNT(*) AS ?c) { ?a :knows ?b . ?b :hasInterest ?t }",
    "chain3": "SELECT (COUNT(*) AS ?c) { ?a :knows ?b . ?b :knows ?c . ?c :hasInterest ?t }",
}


@pytest.fixture(scope="module")
def stores():
    """scale -> (port store on the CPU, reference store), from the
    reference test's generator seed, each built once."""
    built = {}

    def get(scale):
        if scale not in built:
            built[scale] = (
                repro_torch.generate_social_graph(scale=scale, seed=9, device="cpu")[0],
                ref_social_graph(scale=scale, seed=9)[0])
        return built[scale]

    return get


def _max_id(store):
    """The largest :knows / :hasInterest subject or object id."""
    q = store.index_array("spoc")
    ids = [store.dict.lookup(":knows"), store.dict.lookup(":hasInterest")]
    e = q[np.isin(q[:, 1], ids)]
    return int(max(e[:, 0].max(), e[:, 2].max()))


def _count(fn, store, name):
    return fn(store) if name == "q6" else fn(store, CHAINS[name])


@pytest.mark.parametrize("name", ["chain2", "chain3", "q6"])
@pytest.mark.parametrize("scale", [0.05, 8])
def test_fused_matches_reference(stores, scale, name):
    port, ref = stores(scale)
    # the reference's int32 composite key and prefix sums cannot have
    # wrapped at this size
    assert (_max_id(ref) + 2) ** 2 < 2**31
    want = _count(ref_q6 if name == "q6" else ref_chain, ref, name)
    got = _count(fused_q6_count if name == "q6" else fused_chain_count, port, name)
    assert got == want > 0


@pytest.mark.parametrize("name", ["chain2", "chain3", "q6"])
def test_fused_matches_port_engine(stores, name):
    port, _ = stores(0.05)
    res = repro_torch.Engine(port, device="cpu").execute(Q6 if name == "q6" else CHAIN_TEXT[name])
    want = int(port.dict.decode(int(res.rows[0, 0])))
    got = _count(fused_q6_count if name == "q6" else fused_chain_count, port, name)
    assert got == want


def test_empty_predicate():
    ref = RefQuadStore()
    ref.add(":a", ":knows", ":b")
    ref.build()
    s = repro_torch.QuadStore(device="cpu")
    s.add(":a", ":knows", ":b")
    s.build()
    assert fused_chain_count(s, [":knows", ":nope"]) == ref_chain(ref, [":knows", ":nope"]) == 0
    assert fused_q6_count(s) == ref_q6(ref) == 0
    assert fused_chain_count(s, [":knows"]) == ref_chain(ref, [":knows"]) == 1


def _closed_form_q6(store):
    """q6 in int64 numpy: Σ over 2-hop :knows paths a->b->c of tags(c),
    less the paths with c == a (each mutual pair (a, b) adds tags(a))."""
    q = store.index_array("spoc").astype(np.int64)
    k = q[q[:, 1] == store.dict.lookup(":knows")]
    ks, ko = k[:, 0], k[:, 2]
    n = int(q[:, [0, 2]].max()) + 1
    tags = np.bincount(q[q[:, 1] == store.dict.lookup(":hasInterest"), 0], minlength=n)
    out = np.zeros(n, dtype=np.int64)
    np.add.at(out, ks, tags[ko])
    comp = np.sort(ks * n + ko)
    rev = ko * n + ks
    pos = np.minimum(np.searchsorted(comp, rev), len(comp) - 1)
    mutual = comp[pos] == rev
    return int(out[ko].sum() - tags[ks[mutual]].sum())


def test_q6_past_the_reference_int32_range():
    """At scale 24 the ids reach 79,199, so (max id + 2)^2 > 2^31: the
    reference's int32 composite key ``subject * base + object`` wraps and
    its fused_q6_count gives 12,681,123, 23 short. The port's int64 keys
    give the closed form."""
    port, _ = repro_torch.generate_social_graph(scale=24, seed=9, device="cpu")
    assert (_max_id(port) + 2) ** 2 > 2**31
    want = _closed_form_q6(port)
    assert want == 12_681_146
    assert fused_q6_count(port) == want
