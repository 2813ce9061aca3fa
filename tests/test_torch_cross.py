"""The port's cross join (``CrossJoin``, the planner's ``PCross``) against
the JAX package's batch engine, on the CPU.

Disconnected BGPs of two and three components, an empty side, a product
past one 4,096-row batch, a FILTER across the components, ``COUNT(*)`` and
``ORDER BY ... LIMIT`` over a product, and the BSBM explore mix e1-e5
(whose e3 is two patterns on one constant subject: a cross product), each
under the reference's default configuration, hash joins without SIP, merge
joins with SIP and merge joins without: the same row multiset as
``repro.core.Engine(engine="barq")`` (the same ordered rows under ORDER
BY), and a balanced buffer pool. Then the operator alone: its variable
order, its windows, ``reset``, and a product past 2^31 rows.
"""

import re
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.data.bsbm import BSBM_EXPLORE_TEMPLATES as REF_EXPLORE  # noqa: E402
from repro.data.bsbm import generate_ecommerce_graph as ref_bsbm  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core.batch import BatchPool  # noqa: E402
from repro_torch.core.operators.cross import CrossJoin  # noqa: E402
from repro_torch.core.operators.sort import MaterializedSource  # noqa: E402
from repro_torch.data import BSBM_EXPLORE_TEMPLATES, instantiate_explore  # noqa: E402

CONFIGS = {"default": (None, None), "hash-off": ("hash", "off"), "merge-on": ("merge", "on"),
           "merge-off": ("merge", "off")}
EXPLORE_INSTANCES = 3  # instantiations of each explore template

QUERIES = {
    "two components": "SELECT ?p ?t { ?p :city :c1 . ?t :tagClass ?k }",
    "three components": "SELECT * { ?p :city :c2 . ?t :tagClass :k0 . ?x :age 25 }",
    "empty right side": "SELECT * { ?p :city :c1 . ?t :tagClass :nothing }",
    "empty left side": "SELECT * { ?p :city :nowhere . ?t :tagClass ?k }",
    # 150 x 60 = 9,000 rows: three batches
    "past one batch": "SELECT ?p ?c ?t ?k { ?p :city ?c . ?t :tagClass ?k }",
    "filter across": "SELECT ?p ?q { ?p :age ?a . ?q :age ?b . FILTER(?a + 3 < ?b) }",
    "count": "SELECT (COUNT(*) AS ?n) { ?p :city ?c . ?t :tagClass ?k . ?x :age 30 }",
    "order by limit": "SELECT ?p ?t ?a { ?p :age ?a . ?t :tagClass :k1 } "
                      "ORDER BY DESC(?a) ?p ?t LIMIT 25",
    "shared constant": "SELECT ?p ?q { ?p :city :c3 . ?q :city :c3 . ?p :age ?a }",
}


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


def _rows(res, store, ordered=False):
    rows = [tuple(sorted(r.items())) for r in res.decoded(store.dict)]
    return rows if ordered else Counter(rows)


def _check(ref_store, port_store, cfg, text, ordered=False):
    js, sip = CONFIGS[cfg]
    ref = REngine(ref_store, RConfig(join_strategy=js, sip=sip))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(join_strategy=js, sip=sip),
                              device="cpu")
    want, got = ref.execute(text), port.execute(text)
    assert _rows(got, port_store, ordered) == _rows(want, ref_store, ordered)
    c = port.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
    return _rows(got, port_store)


@pytest.fixture(scope="module")
def people():
    """150 people in 7 cities with ages from 20 values, 60 tags in 4
    classes."""
    rng = np.random.RandomState(5)
    s = RStore()
    for i in range(150):
        s.add(f":p{i}", ":city", f":c{rng.randint(7)}")
        if rng.rand() < 0.7:
            s.add(f":p{i}", ":age", int(rng.randint(20, 40)))
    for j in range(60):
        s.add(f":t{j}", ":tagClass", f":k{j % 4}")
    ref = s.build()
    return ref, _port_store(ref)


@pytest.fixture(scope="module")
def bsbm():
    ref, meta = ref_bsbm(scale=1, seed=7)
    return ref, _port_store(ref), meta


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_disconnected_bgp_matches_reference(people, cfg, name):
    got = _check(*people, cfg, QUERIES[name], ordered=name == "order by limit")
    n = sum(got.values())
    if name.startswith("empty"):
        assert n == 0
    if name == "past one batch":
        assert n == 150 * 60


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(BSBM_EXPLORE_TEMPLATES))
def test_explore_mix_matches_reference(bsbm, cfg, name):
    ref_store, port_store, meta = bsbm
    assert BSBM_EXPLORE_TEMPLATES[name] == REF_EXPLORE[name]
    rng = np.random.RandomState(len(name) * 7 + int(name[1:]))
    for _ in range(EXPLORE_INSTANCES):
        text = instantiate_explore(BSBM_EXPLORE_TEMPLATES[name], meta, rng)
        got = _check(ref_store, port_store, cfg, text)
        if name == "e3":
            # a product's features times its producers
            product = re.search(r":product\d+", text).group(0)
            d = port_store.dict
            spoc = port_store.index_array("spoc")
            mine = spoc[spoc[:, 0] == d.lookup(product)]
            feats = int((mine[:, 1] == d.lookup(":productFeature")).sum())
            makers = int((mine[:, 1] == d.lookup(":producer")).sum())
            assert sum(got.values()) == feats * makers > 0


def _source(cols, vars_):
    return MaterializedSource(vars_, torch.as_tensor(np.asarray(cols, np.int32)), batch_size=7)


def test_cross_join_emits_the_product_in_windows():
    """Left-major order, the left side's variables then the right side's
    new ones, batches of at most 4,096 rows, and the same rows again after
    ``reset``."""
    rng = np.random.RandomState(1)
    left = rng.randint(0, 50, (2, 73))
    right = rng.randint(0, 50, (3, 61))
    pool = BatchPool("cpu")
    op = CrossJoin(_source(left, (1, 2)), _source(right, (3, 2, 4)), torch.device("cpu"),
                   pool=pool)
    assert op.var_ids() == (1, 2, 3, 4)
    for _ in range(2):
        got, sizes = [], []
        while (b := op.next_batch()) is not None:
            assert bool(b.mask[: b.n_rows].all()) and b.n_rows <= 4096
            sizes.append(b.n_rows)
            got.append(b.columns[:, : b.n_rows].clone())
            b.release()
        got = torch.cat(got, dim=1).numpy()
        li, ri = np.divmod(np.arange(73 * 61), 61)
        want = np.stack([left[0, li], left[1, li], right[0, ri], right[2, ri]])
        np.testing.assert_array_equal(got, want)
        assert sizes == [4096, 73 * 61 - 4096]
        op.reset()
    c = pool.counters()
    assert c["live"] == 0


def test_cross_join_past_two_to_the_31_rows():
    """A product of 50,000 x 50,000 rows: the window base and ``cum`` are
    64-bit, so the last window is exact."""
    left = np.arange(50_000, dtype=np.int32)[None, :]
    right = (np.arange(50_000, dtype=np.int32) + 7)[None, :]
    op = CrossJoin(_source(left, (1,)), _source(right, (2,)), torch.device("cpu"))
    op._ensure()
    total = 50_000 * 50_000
    assert total > 2 ** 31
    op._emitted = total - 5000
    b1, b2 = op.next_batch(), op.next_batch()
    assert op.next_batch() is None
    got = torch.cat([b1.columns[:, : b1.n_rows], b2.columns[:, : b2.n_rows]], dim=1).numpy()
    li, ri = np.divmod(np.arange(total - 5000, total), 50_000)
    np.testing.assert_array_equal(got, np.stack([left[0, li], right[0, ri]]))
