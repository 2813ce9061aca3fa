"""The fused SIP mask and the radix partition's layouts, on the CPU.

``sip_mask`` computes a scan batch's whole SIP mask (every filter's range
and bloom test, the rows past ``n_rows`` cleared) in one launch of the
bloom probe kernel; on the CPU it runs ``sip_mask_plain``. These tests hold
the plain version against the composition the scan used before (one
``SipFilter.mask`` and one ``with_mask`` per filter) and against the JAX
package's ``SipFilter.mask``, on seeded numpy inputs: one, two and more
filters than one launch's descriptor holds, range-only filters, empty
ranges, NULL codes, short batches, masks already partly False and codes
viewed at every 4-byte phase. Then the scan: one call per batch carrying
all of its filters, the batch's ownership rules, and engine parity with
the reference on q5, whose scans carry two filters.

``radix_partition`` on key views at every 4-byte phase, with lengths not a
multiple of 4, 8,192 partitions and skewed keys, against the numpy oracle
and the Pallas kernel in interpret mode; and the wrapper's host-side
layout (``pid_offset``, ``launch_shape``).
"""

import re
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import vecops as RV  # noqa: E402
from repro.core.sip import SipFilter as RSipFilter  # noqa: E402
from repro.data.lsqb import LSQB_QUERIES  # noqa: E402
from repro.kernels import ops  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core.algebra import K, TriplePattern, V  # noqa: E402
from repro_torch.core.batch import BatchPool, ColumnBatch  # noqa: E402
from repro_torch.core.operators.scan import IndexScan  # noqa: E402
from repro_torch.core.sip import SipFilter  # noqa: E402
from repro_torch.kernels import bloom_filter as BF  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import radix_partition as RP  # noqa: E402

NULL_ID = -1
INT32_MIN = -(2 ** 31)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# sip_mask_plain against the unfused composition and the reference
# ---------------------------------------------------------------------------


def _filter_spec(rng, kind):
    """(build keys or None, lo, hi) of one filter: a bloom filter over
    random build keys, a range only, or an empty range."""
    if kind == "bloom":
        keys = rng.randint(-1, 400, rng.randint(20, 200)).astype(np.int32)
        return keys, int(keys.min()), int(keys.max())
    if kind == "range":
        lo = int(rng.randint(-1, 200))
        return None, lo, lo + int(rng.randint(0, 200))
    return None, 10, 9  # empty: hi < lo


SIP_CASES = {
    # name: (filter kinds, capacity, n_rows, mask partly False, code phase)
    "one filter": (("bloom",), 4096, 4096, False, 0),
    "two filters": (("bloom", "bloom"), 4096, 4096, False, 0),
    "more filters than a descriptor": (("bloom",) * 3 + ("range", "bloom", "bloom"),
                                      4096, 4096, False, 0),
    "range only": (("range",), 4096, 4096, False, 0),
    "range beside a bloom filter": (("range", "bloom"), 1024, 1000, False, 0),
    "empty range": (("empty", "bloom"), 512, 512, False, 0),
    "n_rows below capacity": (("bloom",), 4096, 2049, False, 0),
    "mask partly False": (("bloom", "bloom"), 2048, 1999, True, 0),
    "codes at phase 1": (("bloom", "bloom"), 1025, 1023, True, 1),
    "codes at phase 2": (("bloom",), 1026, 1026, False, 2),
    "codes at phase 3": (("bloom", "range"), 1027, 1001, True, 3),
    "one row": (("bloom",), 32, 1, False, 0),
    "no rows": (("bloom",), 32, 0, True, 0),
}


def _sip_case(name):
    """Seeded inputs of ``SIP_CASES[name]``: (mask (capacity,), n_rows,
    filter specs, codes columns as numpy arrays of capacity rows, the
    code matrix whose row views the port gets)."""
    kinds, cap, n, partly, phase = SIP_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    specs = [_filter_spec(rng, k) for k in kinds]
    # codes in [-1, 500): NULLs, members, non-members; rows past n_rows NULL
    mat = rng.randint(-1, 500, (len(kinds) + 1, cap)).astype(np.int32)
    mat[:, n:] = NULL_ID
    mask = np.zeros(cap, bool)
    mask[:n] = rng.rand(n) < 0.7 if partly else True
    return mask, n, specs, mat, phase


def _port_filters(specs, mat, phase, n_rows):
    """The port's filter terms over row views of ``mat``: flattened, each
    column starting ``phase`` elements past a 16-byte boundary."""
    cap = mat.shape[1]
    flat = torch.zeros(mat.size + 8, dtype=torch.int32)
    terms = []
    for k, (keys, lo, hi) in enumerate(specs):
        start = 4 * (k * (cap // 4 + 2)) + phase
        flat[start: start + cap] = T(mat[k])
        codes = flat[start: start + n_rows]
        assert codes.storage_offset() % 4 == phase
        words = None if keys is None else BF.bloom_build(T(keys))[0]
        terms.append((codes, words, lo, hi))
    return terms


def _unfused(mask, n_rows, terms):
    """The scan's SIP step before this kernel: per filter, SipFilter.mask's
    range and probe, a zeroed full-capacity mask, and with_mask's AND."""
    out = mask.clone()
    for codes, words, lo, hi in terms:
        m = (codes >= lo) & (codes <= hi)
        if words is not None:
            m &= BF.bloom_probe_plain(words, codes)
        full = torch.zeros(mask.shape[0], dtype=torch.bool)
        full[:n_rows] = m
        out &= full
    return out


def _reference_mask(specs, mat, n_rows):
    """The JAX package's SipFilter.mask of each filter over rows [0,
    n_rows), ANDed."""
    want = np.ones(n_rows, bool)
    for k, (keys, lo, hi) in enumerate(specs):
        f = RSipFilter(var=0, backend="numpy")
        f.bind((lambda keys=keys: ("keys", keys)) if keys is not None
               else (lambda lo=lo, hi=hi: ("range", lo, hi)))
        want &= f.mask(mat[k, :n_rows])
    return want


@pytest.mark.parametrize("case", sorted(SIP_CASES))
def test_sip_mask_plain_matches_unfused_and_reference(case):
    mask_np, n, specs, mat, phase = _sip_case(case)
    terms = _port_filters(specs, mat, phase, n)
    mask = T(mask_np)
    want = _unfused(mask, n, terms)
    # in place
    got = mask.clone()
    assert BF.sip_mask(got, n, terms) is got
    assert torch.equal(got, want)
    # into a fresh mask, the input left as it was
    out = torch.empty_like(mask)
    assert torch.equal(BF.sip_mask_plain(mask, n, terms, out=out), want)
    assert torch.equal(mask, T(mask_np))
    # the reference's SipFilter.mask on the filled rows; the rest cleared
    ref = _reference_mask(specs, mat, n) & mask_np[:n]
    np.testing.assert_array_equal(got[:n].numpy(), ref)
    assert not got[n:].any()


def test_sip_mask_without_a_mask_is_the_filters_membership():
    mask_np, n, specs, mat, phase = _sip_case("two filters")
    terms = _port_filters(specs, mat, phase, n)
    got = BF.sip_mask(None, n, terms)
    assert got.shape == (n,) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), _reference_mask(specs, mat, n))
    # SipFilter.mask is that call with the filter's one term
    f = SipFilter(var=0)
    f.bind(lambda: ("keys", T(specs[0][0])))
    np.testing.assert_array_equal(f.mask(terms[0][0]).numpy(),
                                  _reference_mask(specs[:1], mat, n))


def test_sip_mask_clamps_ranges_past_int32():
    codes = T(np.asarray([INT32_MIN, -1, 0, 7, 2 ** 31 - 1], np.int32))
    got = BF.sip_mask(None, 5, [(codes, None, -(2 ** 40), 2 ** 40)])
    assert got.all()
    assert not BF.sip_mask(None, 5, [(codes, None, 2 ** 33, 2 ** 34)]).any()
    assert BF.sip_mask(None, 5, [(codes, None, 0, 2 ** 34)]).tolist() == [
        False, False, True, True, True]


def test_sip_mask_refuses_bad_inputs():
    codes = torch.arange(8, dtype=torch.int32)
    mask = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="n_rows"):
        BF.sip_mask(mask, 9, [(codes, None, 0, 3)])
    with pytest.raises(ValueError, match="rows"):
        BF.sip_mask(torch.ones(16, dtype=torch.bool), 9, [(codes, None, 0, 3)])
    with pytest.raises(ValueError, match="power of two"):
        BF.sip_mask(mask, 8, [(codes, torch.zeros(3, dtype=torch.int32), 0, 3)])
    with pytest.raises(ValueError, match="bool"):
        BF.sip_mask(codes, 8, [(codes, None, 0, 3)])
    with pytest.raises(ValueError, match="contiguous"):
        BF.sip_mask(mask, 4, [(codes[::2], None, 0, 3)])


def test_sip_descriptor_holds_the_kernel_layout():
    """Per filter four 64-bit words: codes and words pointers, the words'
    index mask, and (lo, hi) as two int32 halves; then the filter count;
    then per filter its counter pair's pointer, or 0. Ranges are cut to
    int32 and an empty one stays empty."""
    codes = torch.arange(8, dtype=torch.int32)
    words = torch.zeros(64, dtype=torch.int32)
    pair = torch.zeros(2, dtype=torch.int64)
    d = BF._descriptor([(codes, words, -5, 2 ** 40), (codes, None, 3, 2)], [None, pair])
    assert len(d) == 5 * BF.SIP_TERMS + 1 == BF._DESC_WORDS
    assert d[4 * BF.SIP_TERMS + 1] == 0 and d[4 * BF.SIP_TERMS + 2] == pair.data_ptr()
    assert all(d[4 * BF.SIP_TERMS + 1 + k] == 0 for k in range(2, BF.SIP_TERMS))
    assert d[0] == codes.data_ptr() and d[1] == words.data_ptr() and d[2] == 63
    half = lambda w, k: int(np.int32(np.uint32((w >> (32 * k)) & 0xFFFFFFFF)))  # noqa: E731
    assert (half(d[3], 0), half(d[3], 1)) == (-5, 2 ** 31 - 1)
    assert d[4] == codes.data_ptr() and d[5] == 0 and d[6] == 0
    assert (half(d[7], 0), half(d[7], 1)) == (0, -1)
    assert d[4 * BF.SIP_TERMS] == 2


def _reference_filter(keys, lo, hi):
    f = RSipFilter(var=0, backend="numpy")
    f.bind((lambda: ("keys", keys)) if keys is not None else (lambda: ("range", lo, hi)))
    return f


@pytest.mark.parametrize("case", sorted(SIP_CASES))
def test_sip_mask_counts_each_filter_as_the_reference(case):
    """Each filter's counter pairs, a zeroed pair a batch as ``SipFilter``
    gives them, summed over two batches: the rows of [0, n_rows) that it
    alone rejects, whatever the mask holds, and the batches where it has
    words and a code fell inside its range: the reference SipFilter's
    ``rows_pruned`` and ``probe_dispatches``."""
    mask_np, n, specs, mat, phase = _sip_case(case)
    terms = _port_filters(specs, mat, phase, n)
    refs = [_reference_filter(*spec) for spec in specs]
    total = torch.zeros(len(terms), 2, dtype=torch.int64)
    for _ in range(2):
        pairs = [torch.zeros(2, dtype=torch.int64) for _ in terms]
        BF.sip_mask(T(mask_np), n, terms, counts=pairs)
        total += torch.stack(pairs)
        for k, f in enumerate(refs):
            f.mask(mat[k, :n])
    assert total.tolist() == [[f.rows_pruned, f.probe_dispatches] for f in refs]
    with pytest.raises(ValueError, match="counter pair"):
        BF.sip_mask(T(mask_np), n, terms, counts=pairs[:-1] + [torch.zeros(2)])


def test_sip_mask_counts_no_launch_on_the_cpu():
    mask_np, n, specs, mat, phase = _sip_case("more filters than a descriptor")
    before = (BF.probe_launches, BF.wordless_launches)
    BF.sip_mask(T(mask_np), n, _port_filters(specs, mat, phase, n))
    assert (BF.probe_launches, BF.wordless_launches) == before


# ---------------------------------------------------------------------------
# the scan and the batch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan_store():
    from repro.core import QuadStore as RStore

    store = RStore()
    for i in range(300):
        store.add(f":s{i:03d}", ":p", f":o{i % 11}")
    ref = store.build()
    terms = [ref.dict.decode(i) for i in range(len(ref.dict))]
    return store_from_arrays(ref.index_array("spoc"), terms, device="cpu")


@pytest.fixture()
def recorded(monkeypatch):
    """Every sip_mask call's filter count and whether it wrote in place."""
    calls = []
    real = BF.sip_mask

    def rec(mask, n_rows, filters, out=None, counts=None):
        calls.append((len(filters), out is None))
        return real(mask, n_rows, filters, out, counts)

    monkeypatch.setattr(BF, "sip_mask", rec)
    return calls


@pytest.mark.parametrize("pooled", [True, False])
def test_scan_masks_each_batch_with_one_call(scan_store, recorded, pooled):
    """Two filters on the scan's unsorted var and one on its sorted var:
    one sip_mask call per batch carries all three, and the rows kept are
    the unfiltered scan's rows that pass every filter."""
    from repro_torch.core.adaptive import AdaptiveBatchSizer

    pat = TriplePattern(V(0), K(":p"), V(1))
    objs = sorted({scan_store.dict.lookup(f":o{i}") for i in range(11)})
    subj = sorted(scan_store.dict.lookup(f":s{i:03d}") for i in range(300))
    specs = [(1, np.asarray(objs[:6], np.int32)), (1, np.asarray(objs[3:], np.int32)),
             (0, np.asarray(subj[::3], np.int32))]
    filters = []
    for var, keys in specs:
        f = SipFilter(var=var)
        f.bind(lambda keys=keys: ("keys", T(keys)))
        filters.append(f)
    pool = BatchPool("cpu") if pooled else None
    scan = IndexScan(scan_store, pat, want_sorted_var=0, sip_filters=filters, pool=pool,
                     sizer=AdaptiveBatchSizer(initial=32, enabled=False))
    rows, batches = [], 0
    while (b := scan.next_batch()) is not None:
        batches += 1
        keep = b.mask[: b.n_rows]
        rows += list(zip(b.column(0)[keep].tolist(), b.column(1)[keep].tolist()))
        assert not b.mask[b.n_rows:].any()
        b.release()
    assert batches and recorded == [(3, pooled)] * len(recorded)
    assert len(recorded) >= batches  # fully pruned batches were masked too
    full = IndexScan(scan_store, pat, want_sorted_var=0)
    want = []
    while (b := full.next_batch()) is not None:
        want += list(zip(b.column(0).tolist(), b.column(1).tolist()))
    keep = {int(x) for x in objs[3:6]}
    sub = {int(x) for x in subj[::3]}
    assert Counter(rows) == Counter(r for r in want if r[1] in keep and r[0] in sub)


@pytest.mark.parametrize("pooled", [True, False])
def test_path_expand_masks_each_batch_with_one_call(scan_store, recorded, pooled):
    """PathExpand's SIP step is the scan's: one sip_mask call per emitted
    batch carries every filter on its variables (a filter on another
    variable is left out), and the pairs kept are the unfiltered path's
    pairs that pass every filter."""
    from repro_torch.core.operators.path import PathExpand
    from repro_torch.core.paths import expr as TX

    objs = sorted({scan_store.dict.lookup(f":o{i}") for i in range(11)})
    subj = sorted(scan_store.dict.lookup(f":s{i:03d}") for i in range(300))
    specs = [(1, ("keys", T(np.asarray(objs[:7], np.int32)))),
             (0, ("range", subj[40], subj[250])), (7, ("range", 0, -1))]
    filters = []
    for var, payload in specs:
        f = SipFilter(var=var)
        f.bind(lambda payload=payload: payload)
        filters.append(f)

    def pairs(sip):
        op = PathExpand(scan_store, TX.PClosure(TX.PLink(":p"), 1), V(0), V(1), batch_size=32,
                        pool=BatchPool("cpu") if pooled else None, sip_filters=sip)
        got, batches = [], 0
        while (b := op.next_batch()) is not None:
            batches += 1
            keep = b.mask[: b.n_rows]
            got += list(zip(b.column(0)[keep].tolist(), b.column(1)[keep].tolist()))
            assert not b.mask[b.n_rows:].any()
            b.release()
        return got, batches

    rows, batches = pairs(filters)
    assert batches and recorded == [(2, pooled)] * batches
    want, _ = pairs(())
    keep = {int(x) for x in objs[:7]}
    assert Counter(rows) == Counter(r for r in want
                                    if r[1] in keep and subj[40] <= r[0] <= subj[250])


def test_batch_sip_mask_ownership():
    """A pooled batch is narrowed in place and its buffers move to the
    result; an unpooled one gets a fresh mask and keeps its own."""
    codes = [torch.arange(10, dtype=torch.int32), torch.arange(10, dtype=torch.int32) % 4]
    term = lambda b: [(b.column(1), None, 1, 2)]  # noqa: E731
    pool = BatchPool("cpu")
    b = ColumnBatch.from_columns((0, 1), codes, "cpu", capacity=32, pool=pool)
    mask = b.mask
    got = b.with_sip_mask(term(b))
    assert got.mask is mask and got.pool is pool and b.pool is None
    assert got.mask.tolist() == [c in (1, 2) for c in codes[1].tolist()] + [False] * 22
    u = ColumnBatch.from_columns((0, 1), codes, "cpu", capacity=32)
    before = u.mask.clone()
    got = u.with_sip_mask(term(u))
    assert got.mask is not u.mask and torch.equal(u.mask, before) and got.pool is None
    assert got.n_active == 5


@pytest.fixture(scope="module")
def q5_engines(social_store):
    ref_store = social_store[0]
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    store = store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")
    return ref_store, store


@pytest.mark.parametrize("cfg", [(None, None), ("hash", "on"), ("hash", "off"),
                                 ("merge", "on")])
@pytest.mark.parametrize("name", ["q4", "q5", "q6"])
def test_sip_queries_match_the_reference_through_one_call(q5_engines, recorded, cfg, name):
    """q4-q6 under four configurations: the reference's rows; with SIP,
    every scan batch is masked by one call, and q5's carry two filters."""
    ref_store, store = q5_engines
    ref = REngine(ref_store, RConfig(join_strategy=cfg[0], sip=cfg[1]))
    port = repro_torch.Engine(store, repro_torch.EngineConfig(join_strategy=cfg[0],
                                                              sip=cfg[1]), device="cpu")
    q = LSQB_QUERIES[name]
    want = Counter(map(tuple, ref.execute(q).rows.tolist()))
    assert Counter(map(tuple, port.execute(q).rows.tolist())) == want
    if cfg[1] == "off":
        assert recorded == []
    elif cfg == (None, None):
        assert recorded
        assert any(k == 2 for k, _ in recorded) == (name == "q5")


# ---------------------------------------------------------------------------
# radix_partition
# ---------------------------------------------------------------------------


def _radix_keys(rng, n, kind):
    if kind == "uniform":
        return rng.randint(INT32_MIN, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    if kind == "all NULL":
        return np.full(n, NULL_ID, np.int32)
    if kind == "all equal":
        return np.full(n, 12345, np.int32)
    if kind == "sorted runs":
        return np.sort(rng.randint(0, max(n // 20, 1), n)).astype(np.int32)
    # zipf: a few heavy keys, NULLs among them
    return (rng.zipf(1.3, n) % 5000 - 1).astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "all NULL", "all equal", "sorted runs", "zipf"])
@pytest.mark.parametrize("n_parts", [1, 16, 1024, 8192])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_radix_partition_on_key_views(offset, n_parts, kind):
    """Keys as a view at every 4-byte phase of a longer column, lengths
    not a multiple of 4."""
    n = 4093 + offset
    rng = np.random.RandomState(n_parts + offset)
    keys = _radix_keys(rng, n, kind)
    buf = np.zeros(n + 8, np.int32)
    buf[offset: offset + n] = keys
    view = T(buf)[offset: offset + n]
    assert view.is_contiguous() and view.storage_offset() == offset
    pid, hist = RP.radix_partition(view, n_parts)
    want_pid, want_hist = ops.radix_partition(keys, n_parts, backend="numpy")
    np.testing.assert_array_equal(pid.numpy(), want_pid)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    assert int(hist.sum()) == n


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_radix_partition_8192_parts_matches_pallas(kind):
    rng = np.random.RandomState(7)
    keys = _radix_keys(rng, 3001, kind)
    keys = keys[keys != INT32_MIN]  # the Pallas kernel's padding value
    pid, hist = RP.radix_partition(T(keys), RP.MAX_PARTS)
    pal_pid, pal_hist = ops.radix_partition(keys, RP.MAX_PARTS, backend="pallas")
    np.testing.assert_array_equal(pid.numpy(), pal_pid)
    np.testing.assert_array_equal(hist.numpy(), pal_hist)
    np.testing.assert_array_equal(pid.numpy(), RV.hash_partition(keys, RP.MAX_PARTS))


@pytest.mark.parametrize("n", [0, 4096, 4097, RP.LARGE_FROM - 1, RP.LARGE_FROM,
                               RP.SMALL_P_UPTO_KEYS, 3_891_273])
def test_radix_partition_launch_shape_fits_the_card(n):
    """The batch instance up to BATCH_UPTO keys, the small one below
    LARGE_FROM (and with few partitions below SMALL_P_UPTO_KEYS), one
    histogram a block; the large one otherwise, with sub-histogram copies
    a power of two, at most MAX_COPIES and one a warp, fewer as P grows,
    and its blocks' copies within an SM's shared memory. MAX_PARTS stays
    8,192."""
    assert RP.MAX_PARTS == 8192
    for p in (1 << k for k in range(14)):
        inst, copies = RP.launch_shape(n, p)
        bps = RP.LARGE_BLOCKS_PER_SM if inst == RP.LARGE else RP.SMALL_BLOCKS_PER_SM
        if n <= RP.BATCH_UPTO:
            assert inst == RP.BATCH
        elif n < RP.LARGE_FROM or (p <= RP.SMALL_P_PARTS and n < RP.SMALL_P_UPTO_KEYS):
            assert inst == RP.SMALL
        else:
            assert inst == RP.LARGE
        if inst != RP.LARGE:
            assert (bps, copies) == (RP.SMALL_BLOCKS_PER_SM, 1)
            continue
        assert bps == RP.LARGE_BLOCKS_PER_SM
        assert copies & (copies - 1) == 0 and 1 <= copies <= min(RP.MAX_COPIES,
                                                                 RP.LARGE_THREADS // 32)
        assert bps * (copies * p * 4 + RP.BLOCK_RESERVE) <= RP.SM_SMEM
        assert copies <= max(1, 4096 // p)
    if n >= RP.SMALL_P_UPTO_KEYS:
        assert RP.launch_shape(n, 1024)[1] == 4 and RP.launch_shape(n, 8192)[1] == 1


def test_radix_partition_instances_match_the_source():
    """The wrapper's shapes are the constants radix_partition_limits
    exports, one value each in the source; the library compiles the three
    instances alone, each with its blocks per SM, and its launch takes the
    instance and copies only."""
    src = (build.CSRC / "radix_partition.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b([A-Z_]+) = (\d+)", src)}
    assert (consts["LARGE_THREADS"], consts["LARGE_VEC"], consts["LARGE_BLOCKS_PER_SM"]) == (
        RP.LARGE_THREADS, RP.VEC, RP.LARGE_BLOCKS_PER_SM)
    assert (consts["SMALL_THREADS"], consts["SMALL_BLOCKS_PER_SM"]) == (
        RP.SMALL_THREADS, RP.SMALL_BLOCKS_PER_SM)
    assert consts["SMEM_MAX"] == build.SMEM_MAX
    assert (consts["INSTANCE_SMALL"], consts["INSTANCE_BATCH"], consts["INSTANCE_LARGE"]) == (
        RP.SMALL, RP.BATCH, RP.LARGE)
    launches = re.findall(r"return launch<[^>]*?(\w+_BLOCKS_PER_SM)>", src)
    assert launches == ["LARGE_BLOCKS_PER_SM", "SMALL_BLOCKS_PER_SM", "SMALL_BLOCKS_PER_SM"]

    class Lib:
        def __init__(self, vals):
            self.vals = vals

        def radix_partition_limits(self, *refs):
            for r, x in zip(refs, self.vals):
                r._obj.value = x

    want = (RP.LARGE_THREADS, RP.VEC, RP.LARGE_BLOCKS_PER_SM, RP.SMALL_THREADS,
            RP.SMALL_BLOCKS_PER_SM, build.SMEM_MAX)
    RP._check_limits.__wrapped__(Lib(want))
    with pytest.raises(RuntimeError, match="kernel shapes"):
        RP._check_limits.__wrapped__(Lib((*want[:2], 2, *want[3:])))


def test_radix_copies_fit_shared_memory():
    for bps in (1, 2, 4):
        for p in (1, 1024, 4096, 8192):
            c = RP.copies_for(p, bps, 512, 16)
            assert c & (c - 1) == 0 and bps * (c * p * 4 + RP.BLOCK_RESERVE) <= RP.SM_SMEM
    assert RP.copies_for(1024, 2, 512, 16) == 16 and RP.copies_for(8192, 2, 512, 16) == 2


@pytest.mark.parametrize("keys_phase", [0, 1, 2, 3])
@pytest.mark.parametrize("buf_phase", [0, 1, 2, 3])
def test_radix_pid_offset_lays_pids_on_the_keys_phase(keys_phase, buf_phase):
    keys_ptr, buf_ptr = 4096 + 4 * keys_phase, 1 << 20 | 4 * buf_phase
    off = RP.pid_offset(keys_ptr, buf_ptr)
    assert 0 <= off < RP.VEC and (buf_ptr + 4 * off - keys_ptr) % 16 == 0
