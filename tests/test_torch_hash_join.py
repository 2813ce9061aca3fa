"""The PyTorch port's radix-partitioned hash join against the JAX package's.

On the CPU the port's wrappers run their kernels' plain PyTorch versions,
so these tests pin what the CUDA kernels (``radix_partition``,
``hash_probe``) must compute. The same numpy inputs, made from a seed, go
through the reference's kernel dispatch (``repro.kernels.ops``: the numpy
oracle, the jax reference and the Pallas kernels in interpret mode) and
through the port. Every output is an integer and must be exact.

Where the oracles differ the comparison says so: the numpy oracle's
single-key probe returns ``lo = 0`` for an absent key, where the Pallas
kernel and the jax reference return its insertion position; the port
follows the latter and is held to the numpy oracle on matched runs only.
The Pallas partition kernel treats INT32_MIN as padding (pid -1) while
the numpy oracle gives it a real pid; the port follows numpy, and the
Pallas comparison leaves INT32_MIN out of its keys.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import vecops as RV  # noqa: E402
from repro.core.algebra import Cmp, Lit, VarRef  # noqa: E402
from repro.core.batch import BatchPool as RPool  # noqa: E402
from repro.core.dictionary import Dictionary as RDict  # noqa: E402
from repro.core.operators.hash_join import HashJoin as RHashJoin  # noqa: E402
from repro.core.operators.sort import MaterializedSource as RSource  # noqa: E402
from repro.kernels import ops  # noqa: E402

from repro_torch.core import algebra as TA  # noqa: E402
from repro_torch.core import vecops as TV  # noqa: E402
from repro_torch.core.batch import BatchPool as TPool  # noqa: E402
from repro_torch.core.dictionary import Dictionary as TDict  # noqa: E402
from repro_torch.core.operators.hash_join import HashJoin as THashJoin  # noqa: E402
from repro_torch.core.operators.sort import MaterializedSource as TSource  # noqa: E402
from repro_torch.kernels import hash_join as HJ  # noqa: E402
from repro_torch.kernels import radix_partition as RP  # noqa: E402

CPU = torch.device("cpu")
MODES = ("inner", "left_outer", "semi", "anti")
INT32_MIN = np.iinfo(np.int32).min


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy()


def _keys(rng, n, with_min=True):
    """Keys over the whole int32 range, with NULL (-1) runs; INT32_MIN
    (a real key for numpy and the port) only when asked."""
    k = rng.randint(INT32_MIN + 1, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    k[rng.rand(n) < 0.1] = -1
    if with_min and n > 3:
        k[3] = INT32_MIN
    return k


# ---------------------------------------------------------------------------
# vecops: hashing and packing
# ---------------------------------------------------------------------------


def test_hash_arithmetic_matches_reference():
    rng = np.random.RandomState(0)
    k = _keys(rng, 5000)
    h = rng.randint(0, 2 ** 31 - 1, 5000).astype(np.int32)
    for p in (1, 2, 64, 1024):
        np.testing.assert_array_equal(N(TV.hash_partition(T(k), p)), RV.hash_partition(k, p))
    np.testing.assert_array_equal(N(TV.mix_pair(None, T(k))), RV.mix_pair(None, k))
    np.testing.assert_array_equal(N(TV.mix_pair(T(h), T(k))), RV.mix_pair(h, k))
    # a pair whose mix is INT32_MIN is remapped to 0, as in the reference
    lo = np.asarray([INT32_MIN ^ 0], np.int32)
    hi = np.zeros(1, np.int32)
    assert RV.mix_pair(hi, lo)[0] == 0 == int(TV.mix_pair(T(hi), T(lo))[0])
    np.testing.assert_array_equal(N(TV._pair_comp(T(h), T(k))), RV._pair_comp(h, k))
    for p in (1, 2, 1024, 4096):
        assert TV._pid_shift(p) == RV._pid_shift(p)


@pytest.mark.parametrize("spans", [[9, 7], [5, 3, 4], [1 << 21, 1 << 21], [1 << 40, 1 << 40]])
def test_pack_group_keys_fixed_spans_matches_reference(spans):
    rng = np.random.RandomState(len(spans))
    cols = np.stack([rng.randint(-1, min(s, 1 << 30) + 4, 300) for s in spans]).astype(np.int32)
    want = RV.pack_group_keys(cols, spans=spans)
    got = TV.pack_group_keys(T(cols), spans=spans)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(N(got), want)


def test_hash_build_order_matches_reference():
    rng = np.random.RandomState(5)
    k = _keys(rng, 3000)
    pid = RV.hash_partition(k, 16)
    np.testing.assert_array_equal(
        N(TV.hash_build_order(T(pid), None, T(k), 16)), RV.hash_build_order(pid, None, k, 16))
    assert TV.hash_build_order(T(pid[:0]), None, T(k[:0]), 16).shape == (0,)


# ---------------------------------------------------------------------------
# radix_partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [1, 2, 64, 1024])
@pytest.mark.parametrize("n", [0, 1, 2047, 2049, 10_000])
def test_radix_partition_matches_reference(n, n_parts):
    rng = np.random.RandomState(n + n_parts)
    keys = _keys(rng, n)
    pid, hist = RP.radix_partition(T(keys), n_parts)
    assert pid.dtype == hist.dtype == torch.int32 and hist.shape == (n_parts,)
    want_pid, want_hist = ops.radix_partition(keys, n_parts, backend="numpy")
    np.testing.assert_array_equal(N(pid), want_pid)
    np.testing.assert_array_equal(N(hist), want_hist)
    # the Pallas kernel in interpret mode, without its padding value
    keys_p = keys[keys != INT32_MIN]
    pid, hist = RP.radix_partition(T(keys_p), n_parts)
    pal_pid, pal_hist = ops.radix_partition(keys_p, n_parts, backend="pallas")
    np.testing.assert_array_equal(N(pid), pal_pid)
    np.testing.assert_array_equal(N(hist), pal_hist)


def test_radix_partition_refuses_bad_part_counts():
    keys = T(np.arange(10, dtype=np.int32))
    for p in (0, 3, 2 * RP.MAX_PARTS):
        with pytest.raises(ValueError):
            RP.radix_partition(keys, p)


# ---------------------------------------------------------------------------
# hash_build / hash_probe
# ---------------------------------------------------------------------------


def _pair_keys(rng, n, oversized):
    if oversized:
        # hi beyond 2^21: (pid, key) no longer fits one int64 word at P=1024
        hi = rng.randint(1 << 21, 1 << 22, n).astype(np.int32)
    else:
        hi = rng.randint(0, 40, n).astype(np.int32)
    lo = rng.randint(0, 60, n).astype(np.int32)
    return hi, lo


def _build_keys(kind, rng, n):
    if kind == "single":
        k = rng.randint(-1, max(n // 3, 2), n).astype(np.int32)
        return None, k
    return _pair_keys(rng, n, oversized=kind == "oversized pair")


KINDS = ("single", "pair", "oversized pair")


@pytest.mark.parametrize("n_parts", [1, 16, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_hash_build_matches_reference(kind, n_parts):
    rng = np.random.RandomState(n_parts + len(kind))
    for n in (0, 1, 3000):
        bh, bl = _build_keys(kind, rng, n)
        order, starts = HJ.hash_build(None if bh is None else T(bh), T(bl), n_parts)
        want_order, want_starts = ops.hash_build(bh, bl, n_parts, backend="numpy")
        np.testing.assert_array_equal(N(order), want_order)
        np.testing.assert_array_equal(N(starts), want_starts)
        assert order.dtype == starts.dtype == torch.int32


def _probe_case(kind, n_parts, seed, n_b=3000, n_q=700):
    """A built layout and probe keys: half drawn from the build (present),
    half made up (mostly absent), with NULL keys on single-key probes."""
    rng = np.random.RandomState(seed)
    bh, bl = _build_keys(kind, rng, n_b)
    order, starts = ops.hash_build(bh, bl, n_parts, backend="numpy")
    pick = rng.randint(0, n_b, n_q // 2)
    if bh is None:
        ql = np.concatenate([bl[pick], rng.randint(-1, 5000, n_q - n_q // 2)]).astype(np.int32)
        ql[::17] = -1
        qh = None
    else:
        oh, ol = _pair_keys(rng, n_q - n_q // 2, oversized=kind == "oversized pair")
        qh = np.concatenate([bh[pick], oh]).astype(np.int32)
        ql = np.concatenate([bl[pick], ol + 30]).astype(np.int32)
    skh = None if bh is None else bh[order]
    return skh, bl[order], qh, ql, starts


def _port_probe(skh, skl, qh, ql, starts):
    lo, hi = HJ.hash_probe(T(starts), None if skh is None else T(skh), T(skl),
                           None if qh is None else T(qh), T(ql))
    return N(lo), N(hi)


@pytest.mark.parametrize("backend", ["pallas", "jax"])
@pytest.mark.parametrize("n_parts", [1, 16, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_hash_probe_matches_pallas_and_jax_exactly(kind, n_parts, backend):
    skh, skl, qh, ql, starts = _probe_case(kind, n_parts, seed=n_parts + 7)
    lo, hi = _port_probe(skh, skl, qh, ql, starts)
    spid = np.repeat(np.arange(n_parts, dtype=np.int32), np.diff(starts))
    want_lo, want_hi = ops.hash_probe(spid, skh, skl, qh, ql, starts, n_parts, backend=backend)
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)
    assert (hi > lo).sum() >= len(ql) // 2  # the present half matched
    assert (hi == lo).any()  # and some keys are absent


@pytest.mark.parametrize("n_parts", [1, 16, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_hash_probe_matches_numpy_on_matched_runs(kind, n_parts):
    skh, skl, qh, ql, starts = _probe_case(kind, n_parts, seed=n_parts + 11)
    lo, hi = _port_probe(skh, skl, qh, ql, starts)
    spid = np.repeat(np.arange(n_parts, dtype=np.int32), np.diff(starts))
    # the operator's call, with its per-build cache (direct-addressed
    # tables for single keys: lo = 0 for an absent key)
    want_lo, want_hi = ops.hash_probe(spid, skh, skl, qh, ql, starts, n_parts,
                                      backend="numpy", cache={})
    np.testing.assert_array_equal(hi - lo, want_hi - want_lo)
    matched = hi > lo
    np.testing.assert_array_equal(lo[matched], want_lo[matched])
    # [lo, hi) holds exactly the probe key
    for i in np.nonzero(matched)[0][:50]:
        assert (skl[lo[i]:hi[i]] == ql[i]).all()


def test_hash_probe_empty_sides_give_zeros():
    starts = T(np.zeros(5, np.int32))
    keys = T(np.arange(6, dtype=np.int32))
    none = T(np.zeros(0, np.int32))
    for build, probe in ((none, keys), (keys, none)):
        lo, hi = HJ.hash_probe(starts, None, build, None, probe)
        assert lo.shape == hi.shape == probe.shape and not lo.any() and not hi.any()
    with pytest.raises(ValueError):
        HJ.hash_probe(starts, keys, keys, None, keys)  # mixed key forms


# ---------------------------------------------------------------------------
# the HashJoin operator against the reference's
# ---------------------------------------------------------------------------


def _ref_join(l, r, lv, rv, keys, mode, **kw):
    pool = RPool()
    j = RHashJoin(RSource(lv, np.asarray(l, np.int32), None, batch_size=8, pool=pool),
                  RSource(rv, np.asarray(r, np.int32), None, batch_size=8, pool=pool),
                  keys, mode, pool=pool, backend="numpy", **kw)
    rows = []
    for b in j.drain():
        c = b.compact()
        rows.extend(tuple(x) for x in c.to_rows_array().tolist())
        c.release()
    return sorted(rows)


def _drain(op):
    rows = []
    while True:
        b = op.next_batch()
        if b is None:
            break
        c = b.compact()
        rows.extend(tuple(x) for x in c.columns[:, : c.n_rows].T.tolist())
        c.release()
    return sorted(rows)


def _port_join(l, r, lv, rv, keys, mode, n_parts=None, pool=True, sorted_var=None,
               batch=8, **kw):
    tp = TPool(CPU) if pool else None
    j = THashJoin(TSource(lv, T(np.asarray(l, np.int32)), sorted_var, batch_size=batch, pool=tp),
                  TSource(rv, T(np.asarray(r, np.int32)), None, batch_size=batch, pool=tp),
                  keys, CPU, mode, pool=tp, n_parts=n_parts, **kw)
    return j, tp


def _port_rows(*args, **kw):
    j, tp = _port_join(*args, **kw)
    rows = _drain(j)
    if tp is not None:
        c = tp.counters()
        assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
    return rows


@pytest.mark.parametrize("n_parts", [None, 1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_hash_join_single_key_matches_reference(mode, n_parts):
    for seed in range(6):
        rng = np.random.RandomState(seed)
        nl, nr = rng.randint(0, 45), rng.randint(0, 45)
        kr = (2, 3, 12)[seed % 3]  # 2 and 3: heavy skew
        l = [rng.randint(-1, kr, nl), rng.randint(0, 5, nl)]  # vars (0, 1)
        r = [rng.randint(-1, kr, nr), rng.randint(0, 5, nr)]  # vars (0, 2)
        want = _ref_join(l, r, (0, 1), (0, 2), (0,), mode)
        assert _port_rows(l, r, (0, 1), (0, 2), (0,), mode, n_parts=n_parts) == want, seed


@pytest.mark.parametrize("mode", MODES)
def test_hash_join_multi_key_matches_reference(mode):
    for seed in range(6):
        rng = np.random.RandomState(100 + seed)
        nl, nr = rng.randint(1, 35), rng.randint(1, 35)
        l = [rng.randint(-1, 5, nl), rng.randint(0, 3, nl)]  # vars (0, 1)
        r = [rng.randint(-1, 5, nr), rng.randint(0, 3, nr), rng.randint(10, 13, nr)]
        want = _ref_join(l, r, (0, 1), (0, 1, 2), (0, 1), mode)
        assert _port_rows(l, r, (0, 1), (0, 1, 2), (0, 1), mode) == want, seed


@pytest.mark.parametrize("mode", MODES)
def test_hash_join_extra_shared_var_matches_reference(mode):
    """A shared variable outside the hash key is verified pairwise."""
    rng = np.random.RandomState(7)
    l = [rng.randint(0, 6, 40), rng.randint(0, 3, 40)]
    r = [rng.randint(0, 6, 30), rng.randint(0, 3, 30), rng.randint(0, 9, 30)]
    want = _ref_join(l, r, (0, 1), (0, 1, 2), (0,), mode)
    assert _port_rows(l, r, (0, 1), (0, 1, 2), (0,), mode) == want


@pytest.mark.parametrize("mode", MODES)
def test_hash_join_span_overflow_fallback(mode):
    """Key values near 2^31 in two columns overflow the 62-bit pack: the
    join hashes the primary key and verifies the other pairwise."""
    rng = np.random.RandomState(3)
    base = (1 << 31) - 4
    lk = rng.randint(0, 4, 25).astype(np.int64) + base
    rk = rng.randint(0, 4, 25).astype(np.int64) + base
    l = [np.asarray(c, np.int32) for c in (lk, lk - rng.randint(0, 2, 25), rng.randint(0, 3, 25))]
    r = [np.asarray(c, np.int32) for c in (rk, rk - rng.randint(0, 2, 25), rng.randint(0, 3, 25))]
    want = _ref_join(l, r, (0, 1, 2), (0, 1, 3), (0, 1), mode)
    j, _ = _port_join(l, r, (0, 1, 2), (0, 1, 3), (0, 1), mode)
    assert _drain(j) == want
    assert j._spans is None and j._pair_vars  # the fallback engaged


def test_hash_join_empty_key_degenerate_cross():
    l = [np.arange(3), np.arange(3) + 10]
    for mode in MODES:
        for nr in (0, 4):
            r = [np.arange(nr) + 100]
            want = _ref_join(l, r, (0, 1), (2,), (), mode)
            assert _port_rows(l, r, (0, 1), (2,), (), mode) == want, (mode, nr)


@pytest.mark.parametrize("seed", range(5))
def test_hash_join_left_outer_condition(seed):
    """OPTIONAL {...} FILTER: a probe row whose matches all fail the
    condition still emits NULL-extended."""
    rng = np.random.RandomState(seed)
    rd, td = RDict(), TDict()
    for v in range(20):
        rd.encode(v)
        td.encode(v)
    nl, nr = rng.randint(1, 25), rng.randint(0, 25)
    l = [rng.randint(0, 6, nl), rng.randint(0, 20, nl)]
    r = [rng.randint(0, 6, nr), rng.randint(0, 20, nr)]
    want = _ref_join(l, r, (0, 1), (0, 2), (0,), "left_outer",
                     post_filter=Cmp(">", VarRef(2), Lit(9)), dictionary=rd)
    got = _port_rows(l, r, (0, 1), (0, 2), (0,), "left_outer",
                     post_filter=TA.Cmp(">", TA.VarRef(2), TA.Lit(9)), dictionary=td)
    assert got == want


def test_hash_join_skip_floor_keeps_pending_rows():
    """A parent's skip() must not drop already-expanded rows at or above
    the target."""
    n = 50
    lk = np.arange(n, dtype=np.int32)
    l = [lk, lk + 100]
    r = [np.repeat(lk, 2), np.repeat(lk, 2) + 200]
    j, _ = _port_join(l, r, (0, 1), (0, 2), (0,), "inner", pool=False, sorted_var=0, batch=64)
    assert j.sorted_by() == 0
    b = j.next_batch()  # prime: the expansion is pending
    got = set(map(tuple, b.compact().columns[:, : b.n_rows].T.tolist()))
    j.skip(0, 10)
    got |= set(_drain(j))
    want = {(k, k + 100, k + 200) for k in range(10, n)}
    assert want <= got
    assert all(row[0] >= 10 or row in got for row in want)


def test_hash_join_sip_keys_and_reset():
    """sip_keys builds on demand and returns the build key column; a reset
    join runs again from the start."""
    l = [np.asarray([1, 2, 3, 4], np.int32), np.asarray([5, 6, 7, 8], np.int32)]
    r = [np.asarray([2, 4, 4, 9], np.int32), np.asarray([0, 1, 2, 3], np.int32)]
    j, _ = _port_join(l, r, (0, 1), (0, 2), (0,), "inner", pool=False)
    assert sorted(j.sip_keys(0).tolist()) == [2, 4, 4, 9]
    first = _drain(j)
    j.reset()
    assert _drain(j) == first == _ref_join(l, r, (0, 1), (0, 2), (0,), "inner")
