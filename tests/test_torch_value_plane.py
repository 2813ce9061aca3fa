"""The PyTorch port's float64 value plane against the JAX package, on the
CPU.

The reference's ``Engine`` runs the numpy backend by default, whose
expression VM and segmented reductions compute in float64. The port's
numeric decodes, ``expr_eval`` and ``segment_scan`` do too. These cases use
values that float32 cannot hold (0.1, 1/3, 2^24 + 1, 2^24 + 0.4): a FILTER
at 2^24, a BIND at 0.1, a BIND of 70 terms (210 instructions, 70
constants) and SUM, AVG, MIN, MAX and COUNT per group with their DISTINCT
forms, each under the default configuration, merge/off, hash/off and
hash/on against ``repro.core.Engine(engine="barq")``, and the kernels'
plain versions against the reference's numpy functions.

Tolerances: rows must be equal, except SUM and AVG over values that are
not exactly summable. Those are decoded and compared within a relative
1e-12: numpy's ``np.add.at`` adds sequentially, the scan adds in its fixed
tree order. Expression values, errors, MIN, MAX and COUNT must be equal.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import algebra as RA  # noqa: E402
from repro.core.batch import ColumnBatch as RBatch  # noqa: E402
from repro.core.exprs import compile_expr as r_compile  # noqa: E402
from repro.core.exprs.vm import prepare_inputs as r_prepare  # noqa: E402
from repro.kernels import ops  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import algebra as TA  # noqa: E402
from repro_torch.core import vecops as TV  # noqa: E402
from repro_torch.core.batch import ColumnBatch as TBatch  # noqa: E402
from repro_torch.core.dictionary import Dictionary as TDict  # noqa: E402
from repro_torch.core.exprs import compile_expr as t_compile  # noqa: E402
from repro_torch.core.exprs.vm import prepare_inputs as t_prepare  # noqa: E402
from repro_torch.kernels import expr_eval as EE  # noqa: E402
from repro_torch.kernels import segment_scan as SS  # noqa: E402

CONFIGS = {"default": (None, None), "merge-off": ("merge", "off"),
           "hash-off": ("hash", "off"), "hash-on": ("hash", "on")}
# values float32 cannot hold, beside exact ones
NOT_F32 = [16777217, 0.1, 1 / 3, 2 ** 24 + 0.4, 123456789.123, 1e-3, 0.7]
VALUES = NOT_F32 + [16777216, 7, -2.5]
REL = 1e-12  # SUM and AVG: sequential against tree-ordered float64 sums


@pytest.fixture(scope="module")
def value_store():
    """60 items in four groups: the first 30 take VALUES in turn, the rest
    draws of 0.1, 1/3, 2^24 + 0.4, 0.2 and 5.0 (so DISTINCT drops some)."""
    rng = np.random.RandomState(1)
    s = RStore()
    for i in range(60):
        x = VALUES[i % len(VALUES)] if i < 30 else float(
            rng.choice([0.1, 1 / 3, 2 ** 24 + 0.4, 0.2, 5.0]))
        s.add(f":i{i}", ":x", x)
        s.add(f":i{i}", ":g", f":g{i % 4}")
    ref = s.build()
    terms = [ref.dict.decode(i) for i in range(len(ref.dict))]
    return ref, store_from_arrays(ref.index_array("spoc"), terms, device="cpu")


TERMS_70 = " + ".join(f"?x * {k + 0.5}" for k in range(1, 71))
_AGGS = "(SUM({d}?x) AS ?sum) (AVG({d}?x) AS ?avg) (MIN({d}?x) AS ?lo) (MAX({d}?x) AS ?hi) " \
        "(COUNT({d}?x) AS ?n)"
VALUE_QUERIES = {
    "filter above 2^24": "SELECT ?i ?x { ?i :x ?x . FILTER(?x > 16777216) }",
    "bind x * 3": "SELECT ?i ?x ?y { ?i :x ?x . BIND(?x * 3 AS ?y) }",
    "bind of 70 terms": f"SELECT ?i ?y {{ ?i :x ?x . BIND({TERMS_70} AS ?y) }}",
    "aggregates per group": "SELECT ?g " + _AGGS.format(d="")
                            + " { ?i :g ?g . ?i :x ?x } GROUP BY ?g",
    "distinct aggregates per group": "SELECT ?g " + _AGGS.format(d="DISTINCT ")
                                     + " { ?i :g ?g . ?i :x ?x } GROUP BY ?g",
}
SUMMED = ("sum", "avg")


def _sorted_rows(res, store):
    return sorted((tuple(sorted(r.items())) for r in res.decoded(store.dict)), key=repr)


def _assert_rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, gv), (_, wv) in zip(g, w):
            if k in SUMMED:
                assert math.isclose(gv, wv, rel_tol=REL), (k, gv, wv)
            else:
                assert gv == wv, (k, gv, wv)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(VALUE_QUERIES))
def test_value_query_matches_reference(value_store, cfg, name):
    ref_store, port_store = value_store
    js, sip = CONFIGS[cfg]
    ref = REngine(ref_store, RConfig(join_strategy=js, sip=sip))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(join_strategy=js, sip=sip),
                              device="cpu")
    text = VALUE_QUERIES[name]
    want = _sorted_rows(ref.execute(text), ref_store)
    got = _sorted_rows(port.execute(text), port_store)
    _assert_rows_match(got, want)
    rows = [dict(r) for r in got]
    if name == "filter above 2^24":
        assert 16777217 in [r["x"] for r in rows]
        assert 16777216 not in [r["x"] for r in rows]
    if name == "bind x * 3":
        assert {r["y"] for r in rows if r["x"] == 0.1} == {0.30000000000000004}
    c = port.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c


def _bind70(A):
    x = A.VarRef(0)
    e = A.Arith("*", x, A.Lit(1.5))
    for k in range(2, 71):
        e = A.Arith("+", e, A.Arith("*", x, A.Lit(k + 0.5)))
    return e


def test_expr_eval_float64_matches_numpy_oracle():
    """The 70-term BIND (210 instructions, 70 constants, 3 registers) and
    comparisons at 2^24 over values float32 cannot hold: prepared inputs,
    values and errors equal the numpy oracle's exactly."""
    rd, td = _dicts()
    rng = np.random.RandomState(9)
    codes = rng.randint(-1, len(VALUES) + 2, 400).astype(np.int32)
    rbatch = RBatch.from_columns((0,), [codes], capacity=len(codes))
    tbatch = TBatch.from_columns((0,), [torch.from_numpy(codes)], torch.device("cpu"),
                                 capacity=len(codes))
    cmp = lambda A: A.Or((A.Cmp(">", A.VarRef(0), A.Lit(16777216)),  # noqa: E731
                           A.Cmp("<", A.Arith("*", A.VarRef(0), A.Lit(3)), A.Lit(0.3))))
    for make, mode in ((_bind70, "value"), (cmp, "mask")):
        rprog, tprog = r_compile(make(RA), rd, mode), t_compile(make(TA), td, mode)
        if make is _bind70:
            assert (len(tprog.instrs), len(tprog.consts), tprog.n_regs) == (210, 70, 3)
        ri, rf = r_prepare(rprog, rbatch, rd)
        ti, tf = t_prepare(tprog, tbatch, td)
        np.testing.assert_array_equal(ti.numpy(), ri)
        np.testing.assert_array_equal(tf.numpy(), rf)
        want_v, want_e = ops.expr_eval(rprog, ri, rf, backend="numpy")
        got_v, got_e = EE.expr_eval(tprog, ti, tf)
        assert got_v.dtype == torch.float64
        np.testing.assert_array_equal(got_e.numpy(), want_e)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    # 16777217 > 2^24 holds, and 0.1 * 3 < 0.3 does not (0.30000000000000004)
    true = ((got_v != 0) & ~got_e).numpy()
    assert true[codes == rd.lookup(16777217)].all() and (codes == rd.lookup(16777217)).any()
    assert not true[codes == rd.lookup(0.1)].any() and (codes == rd.lookup(0.1)).any()


def _dicts():
    from repro.core.dictionary import Dictionary as RDict

    rd, td = RDict(), TDict()
    for v in VALUES + ['"text"', ":iri"]:
        assert rd.encode(v) == td.encode(v)
    return rd, td


@pytest.mark.parametrize("func", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("n,max_run", [(3000, 40), (20000, 3000)])
def test_segment_reduce_float64_matches_numpy(func, n, max_run):
    """Per-run reductions of values float32 cannot hold, against the
    reference's numpy segment_reduce: MIN, MAX and COUNT equal, SUM within
    a relative 1e-12. 20,000 rows are five 4,096-row tiles."""
    rng = np.random.RandomState(n + len(func))
    lens = rng.randint(1, max_run + 1, n)
    keys = np.repeat(np.arange(n), lens)[:n].astype(np.int32)
    vals = rng.choice(np.array(NOT_F32, dtype=np.float64), n)
    want_k, want_v = ops.segment_reduce(keys, vals, func, backend="numpy")
    got_k, got_v = TV.segment_reduce(torch.from_numpy(keys), torch.from_numpy(vals), func)
    assert got_v.dtype == torch.float64
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    if func == "sum":
        np.testing.assert_allclose(got_v.numpy(), want_v, rtol=REL, atol=0)
    else:
        np.testing.assert_array_equal(got_v.numpy(), want_v)


@pytest.mark.parametrize("tile", [(32, 1), (32, 4), (64, 2)])
def test_segment_scan_tile_model_float64_across_windows(tile):
    """One run and runs of 300 over more than 32 small tiles (the
    look-back's windows), float64 values float32 cannot hold: each
    inclusive scan within a relative 1e-12 of numpy's sequential float64
    scan, MIN and MAX equal."""
    n = 40 * tile[0] * tile[1] + 17
    rng = np.random.RandomState(n)
    vals = rng.choice(np.array(NOT_F32, dtype=np.float64), n)
    for keys in (np.zeros(n, np.int32), (np.arange(n) // 300).astype(np.int32)):
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        for op in ("sum", "min", "max"):
            got = SS.segment_scan_plain(torch.from_numpy(keys), torch.from_numpy(vals), op,
                                        *tile).numpy()
            acc = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
            want = np.concatenate([acc.accumulate(v) for v in np.split(vals, starts[1:])])
            if op == "sum":
                np.testing.assert_allclose(got, want, rtol=REL, atol=0)
            else:
                np.testing.assert_array_equal(got, want)
