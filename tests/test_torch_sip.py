"""The PyTorch port's sideways information passing against the JAX package's.

On the CPU the port's bloom filter wrappers run their kernels' plain
PyTorch versions, so these tests pin what the CUDA kernels
(``bloom_build``, ``bloom_probe``) must compute: the same numpy inputs,
made from a seed, go through the reference's numpy oracle and its Pallas
kernels in interpret mode, and through the port. Filter words must match
bit for bit (compared as uint32) and membership masks exactly.

Then the runtime: ``SipFilter``, the scan's range and mask modes, and the
engine on the reference's SIP test store, whose rows must equal the
reference's under every combination of ``sip`` and ``join_strategy``.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import vecops as RV  # noqa: E402
from repro.kernels import ops  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import vecops as TV  # noqa: E402
from repro_torch.core.algebra import K, TriplePattern, V  # noqa: E402
from repro_torch.core.operators.scan import IndexScan  # noqa: E402
from repro_torch.core.sip import SipFilter  # noqa: E402
from repro_torch.kernels import bloom_filter as BF  # noqa: E402

NULL_ID = -1


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _u32(words):
    return words.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# bloom_build / bloom_probe against numpy and Pallas
# ---------------------------------------------------------------------------


def _bloom_case(name):
    rng = np.random.RandomState(len(name))
    if name == "empty build":
        return np.zeros(0, np.int32), np.arange(-1, 40, dtype=np.int32)
    if name == "all miss":
        return (np.arange(100, dtype=np.int32),
                np.arange(1 << 20, (1 << 20) + 500, dtype=np.int32))
    if name == "null key":
        return np.asarray([NULL_ID, 3, 7], np.int32), np.asarray([NULL_ID, 3, 7, 8], np.int32)
    if name == "wide domain":
        return (rng.randint(-2, 1 << 22, 3000).astype(np.int32),
                rng.randint(-2, 1 << 22, 4096).astype(np.int32))
    if name == "full int32 range":
        k = rng.randint(-(2 ** 31) + 1, 2 ** 31 - 1, 2500, dtype=np.int64).astype(np.int32)
        return k, np.concatenate([k[::3], k[1::3] ^ 1]).astype(np.int32)
    # "dense": many keys per word, the filter nearly full
    return rng.randint(0, 300, 5000).astype(np.int32), np.arange(-5, 600, dtype=np.int32)


BLOOM_CASES = ("empty build", "all miss", "null key", "wide domain", "full int32 range", "dense")


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
@pytest.mark.parametrize("case", BLOOM_CASES)
def test_bloom_matches_reference(case, backend):
    keys, queries = _bloom_case(case)
    words, lo, hi = BF.bloom_build(T(keys))
    assert words.dtype == torch.int32
    want_words, want_lo, want_hi = ops.bloom_build(keys, backend=backend)
    np.testing.assert_array_equal(_u32(words), np.asarray(want_words, np.uint32))
    assert (lo, hi) == (want_lo, want_hi)
    got = BF.bloom_probe(words, T(queries))
    assert got.dtype == torch.bool
    want = ops.bloom_probe(np.asarray(want_words, np.uint32), queries, backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)
    # no false negatives
    assert got.numpy()[np.isin(queries, keys)].all()
    if case == "empty build":
        assert hi < lo and not got.any()
    if case == "all miss":
        assert got.numpy().mean() < 0.05


@pytest.mark.parametrize("n_words", [1, 2, 64, 1 << 12])
def test_bloom_explicit_word_counts(n_words):
    rng = np.random.RandomState(n_words)
    keys = rng.randint(-1, 1 << 16, 700).astype(np.int32)
    words, _, _ = BF.bloom_build(T(keys), n_words)
    want, _, _ = RV.bloom_build(keys, n_words)
    np.testing.assert_array_equal(_u32(words), want)
    with pytest.raises(ValueError):
        BF.bloom_build(T(keys), 3)


def test_bloom_hash_matches_reference():
    rng = np.random.RandomState(2)
    keys = rng.randint(-(2 ** 31), 2 ** 31 - 1, 4000, dtype=np.int64).astype(np.int32)
    for n_words in (1, 1024, 1 << 20):
        word, bits = TV.bloom_hash(T(keys), n_words)
        want_word, want_bits = RV.bloom_hash(keys, n_words)
        np.testing.assert_array_equal(word.numpy(), want_word)
        np.testing.assert_array_equal(bits.numpy(), want_bits.astype(np.int64))


def test_bloom_n_words_sizing():
    for n in (0, 1, 2, 3, 100, 10_000, 1_369_041, 10 ** 9):
        assert TV.bloom_n_words(n) == RV.bloom_n_words(n)
    assert TV.bloom_n_words(10 ** 9) == 1 << 20


# ---------------------------------------------------------------------------
# SipFilter
# ---------------------------------------------------------------------------


def test_sip_filter_pass_through_without_provider():
    f = SipFilter(var=0)
    assert f.code_range() is None
    assert f.mask(torch.arange(5, dtype=torch.int32)) is None
    g = SipFilter(var=0)
    g.bind(lambda: None)  # nothing derivable from the build side
    assert g.code_range() is None and g.mask(torch.arange(3, dtype=torch.int32)) is None


def test_sip_filter_range_and_mask():
    f = SipFilter(var=0)
    calls = []
    f.bind(lambda: calls.append(1) or ("keys", T(np.asarray([10, 20, 30], np.int32))))
    assert f.code_range() == (10, 30)
    m = f.mask(T(np.asarray([5, 10, 20, 25, 30, 99], np.int32))).tolist()
    assert m[1] and m[2] and m[4]  # members are kept
    assert not m[0] and not m[5]  # outside the range: pruned
    assert calls == [1]  # the provider runs once


def test_sip_filter_empty_build_prunes_everything():
    f = SipFilter(var=0)
    f.bind(lambda: ("keys", T(np.zeros(0, np.int32))))
    lo, hi = f.code_range()
    assert hi < lo
    assert not f.mask(torch.arange(100, dtype=torch.int32)).any()


def test_sip_filter_range_only_provider():
    f = SipFilter(var=0)
    f.bind(lambda: ("range", 5, 9))
    assert f.code_range() == (5, 9)
    assert f.mask(T(np.asarray([4, 5, 9, 10], np.int32))).tolist() == [False, True, True, False]


# ---------------------------------------------------------------------------
# the scan's SIP modes
# ---------------------------------------------------------------------------


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


@pytest.fixture(scope="module")
def scan_store():
    store = RStore()
    for i in range(200):
        store.add(f":s{i:03d}", ":p", f":o{i % 7}")
    return _port_store(store.build())


def _scan_rows(scan, var):
    vals, batches = [], 0
    while True:
        b = scan.next_batch()
        if b is None:
            return vals, batches
        batches += 1
        vals.extend(b.column(var)[b.mask[: b.n_rows]].tolist())
        b.release()


def test_scan_sip_range_narrowing(scan_store):
    """On the sorted var the filter seeks: only the range's rows are read."""
    pat = TriplePattern(V(0), K(":p"), V(1))
    lo, hi = scan_store.dict.lookup(":s050"), scan_store.dict.lookup(":s059")
    lo, hi = min(lo, hi), max(lo, hi)
    f = SipFilter(var=0)
    f.bind(lambda: ("range", lo, hi))
    scan = IndexScan(scan_store, pat, want_sorted_var=0, sip_filters=[f])
    assert scan.sorted_by() == 0
    vals, _ = _scan_rows(scan, 0)
    assert sorted(vals) == list(range(lo, hi + 1)) and len(vals) == 10
    assert scan.offset == scan._end < len(scan.range)  # it stopped at the range's end
    scan.reset()  # a reset scan narrows again
    assert sorted(_scan_rows(scan, 0)[0]) == sorted(vals)


def test_scan_sip_empty_build_reads_nothing(scan_store):
    f = SipFilter(var=0)
    f.bind(lambda: ("keys", T(np.zeros(0, np.int32))))
    scan = IndexScan(scan_store, TriplePattern(V(0), K(":p"), V(1)), want_sorted_var=0,
                     sip_filters=[f])
    assert _scan_rows(scan, 0) == ([], 0)


def test_scan_sip_mask_mode_on_an_unsorted_var(scan_store):
    """A filter on an unsorted var cannot seek: it masks batches, and a
    batch it prunes completely is not passed up."""
    pat = TriplePattern(V(0), K(":p"), V(1))
    base = IndexScan(scan_store, pat, want_sorted_var=0)
    ov = 1
    assert base.sorted_by() == 0 and not base.can_skip(ov)
    all_vals, _ = _scan_rows(base, ov)
    keep = np.unique(all_vals)[:2].astype(np.int32)
    f = SipFilter(var=ov)
    f.bind(lambda: ("keys", T(keep)))
    from repro_torch.core.adaptive import AdaptiveBatchSizer

    scan = IndexScan(scan_store, pat, want_sorted_var=0, sip_filters=[f],
                     sizer=AdaptiveBatchSizer(initial=8, enabled=False))
    vals, batches = _scan_rows(scan, ov)
    assert set(vals) <= set(keep.tolist())
    assert len(vals) == int(np.isin(all_vals, keep).sum()) > 0
    assert batches < -(-len(all_vals) // 8)  # fully pruned batches were skipped
    with pytest.raises(ValueError):
        scan.skip(ov, 3)


def test_scan_sip_code_range(scan_store):
    pat = TriplePattern(V(0), K(":p"), V(1))
    scan = IndexScan(scan_store, pat, want_sorted_var=0)
    vals, _ = _scan_rows(IndexScan(scan_store, pat, want_sorted_var=0), 0)
    assert scan.sip_code_range() == (min(vals), max(vals))
    dead = IndexScan(scan_store, TriplePattern(V(0), K(":nope"), V(1)), want_sorted_var=0)
    assert dead.sip_code_range() == (0, -1)


# ---------------------------------------------------------------------------
# engine parity on the reference's SIP store
# ---------------------------------------------------------------------------


def _chain_store():
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


CHAIN_Q = (
    "SELECT ?a ?f { ?a :r1 ?b . ?b :r2 ?c . ?c :r3 ?d . "
    "?d :r4 ?e . ?e :r5 ?f }"
)

PARITY_QUERIES = [
    CHAIN_Q,
    "SELECT ?a ?c { ?a :r1 ?b . ?b :r2 ?c }",
    "SELECT ?b ?d { ?b :r2 ?c . ?c :r3 ?d . ?d :r4 ?e }",
    "SELECT ?a ?b ?c { ?a :r1 ?b . OPTIONAL { ?b :r2 ?c } }",
    "SELECT ?b { ?b :r2 ?c . MINUS { ?b :r2 :c1 } }",
    "SELECT ?b ?c { ?b :r2 ?c . FILTER NOT EXISTS { ?c :r3 :d3 } }",
    "SELECT ?c (COUNT(?b) AS ?n) { ?b :r2 ?c . ?c :r3 ?d } GROUP BY ?c",
]


@pytest.fixture(scope="module")
def chain_stores():
    ref = _chain_store()
    return ref, _port_store(ref)


@pytest.mark.parametrize("sip", [None, "on", "off"])
@pytest.mark.parametrize("join_strategy", [None, "hash", "merge"])
@pytest.mark.parametrize("qi", range(len(PARITY_QUERIES)))
def test_engine_parity_sip(chain_stores, qi, join_strategy, sip):
    ref_store, store = chain_stores
    q = PARITY_QUERIES[qi]
    ref = REngine(ref_store, RConfig(join_strategy=join_strategy, sip=sip))
    port = repro_torch.Engine(
        store, repro_torch.EngineConfig(join_strategy=join_strategy, sip=sip), device="cpu")
    assert port.explain(q) == ref.explain(q)
    want = Counter(map(tuple, ref.execute(q).rows.tolist()))
    assert Counter(map(tuple, port.execute(q).rows.tolist())) == want
    c = port.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c


def test_sip_is_on_the_path(chain_stores):
    """Under sip="on" the chain query's plan carries SIP annotations and
    the port builds and probes bloom filters for them."""
    _, store = chain_stores
    port = repro_torch.Engine(store, repro_torch.EngineConfig(sip="on"), device="cpu")
    assert "sip=" in port.explain(CHAIN_Q)
    built, probed = [], []
    orig_build, orig_probe = BF.bloom_build_plain, BF.bloom_probe_plain
    BF.bloom_build_plain = lambda *a: built.append(1) or orig_build(*a)
    BF.bloom_probe_plain = lambda *a: probed.append(1) or orig_probe(*a)
    try:
        port.execute(CHAIN_Q)
    finally:
        BF.bloom_build_plain, BF.bloom_probe_plain = orig_build, orig_probe
    assert built and probed
