"""The port's interpreted expression walk (``core/expressions.py``) and its
batch↔row adapters, on the CPU.

The walk is held against the reference's ``eval_expr_mask`` /
``eval_expr_values`` on the same seeded columns (random expression trees,
and the three-valued pins of the reference's tests), against the port's
own VM (whose plain version runs here) for compilable expressions, and on
the reference's refusals. The adapters are held on their copies, batch
shapes, skips and the pool's counters.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import algebra as RA  # noqa: E402
from repro.core.batch import ColumnBatch as RBatch  # noqa: E402
from repro.core.dictionary import Dictionary as RDict  # noqa: E402
from repro.core.expressions import eval_expr_mask as r_mask  # noqa: E402
from repro.core.expressions import eval_expr_values as r_values  # noqa: E402
from repro.data.lsqb import generate_social_graph as ref_social  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import algebra as A  # noqa: E402
from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, bucket_for  # noqa: E402
from repro_torch.core.dictionary import Dictionary  # noqa: E402
from repro_torch.core.expressions import eval_expr_mask, eval_expr_values  # noqa: E402
from repro_torch.core.exprs import compile_expr  # noqa: E402
from repro_torch.core.exprs.vm import eval_program_mask, eval_program_values  # noqa: E402
from repro_torch.core.legacy import operators as LOP  # noqa: E402
from repro_torch.core.operators import adapters  # noqa: E402
from repro_torch.core.operators.adapters import BatchToRow, RowToBatch  # noqa: E402
from repro_torch.core.operators.base import close_tree  # noqa: E402
from repro_torch.core.operators.scan import IndexScan  # noqa: E402
from repro_torch.core.operators.simple import FilterOp  # noqa: E402
from repro_torch.core.operators.sort import MaterializedSource  # noqa: E402

CPU = torch.device("cpu")

# variable layout of the seeded batches (as the reference's tests lay it):
#   ?v0 ?v1  numeric columns (codes == int values), with NULLs
#   ?v2      divisor column (0 rows produce division errors)
#   ?v3      term column (strings / IRIs / numbers, NULLs)
NUM_RANGE = 21
TERMS = ['"apple"', '"applesauce"', '"banana"', '""', ":iri1", ":iri2", 2.5]


def _dicts():
    """The same dictionary in both packages."""
    out = []
    for cls in (RDict, Dictionary):
        d = cls()
        for v in range(NUM_RANGE):  # code i <-> term int(i)
            d.encode(int(v))
        codes = [d.encode(t) for t in TERMS]
        out.append(d)
    return out[0], out[1], codes


def _columns(rng, n, term_codes, null_frac=0.15):
    a = rng.randint(0, NUM_RANGE, n).astype(np.int32)
    b = rng.randint(0, NUM_RANGE, n).astype(np.int32)
    div = rng.choice([0, 1, 2, 4], n).astype(np.int32)
    t = rng.choice(term_codes + [NULL_ID], n).astype(np.int32)
    for col in (a, b):
        col[rng.rand(n) < null_frac] = NULL_ID
    return [a, b, div, t]


def _batches(cols, capacity=None):
    cap = capacity or max(len(cols[0]), 1)
    ref = RBatch.from_columns((0, 1, 2, 3), cols, capacity=cap)
    port = ColumnBatch.from_columns((0, 1, 2, 3), [torch.from_numpy(c) for c in cols], CPU,
                                    capacity=cap)
    return ref, port


def _port_expr(e):
    """The port's algebra node for a reference algebra node."""
    if isinstance(e, tuple):
        return tuple(_port_expr(x) for x in e)
    if not dataclasses.is_dataclass(e):
        return e
    fields = {f.name: _port_expr(getattr(e, f.name)) for f in dataclasses.fields(e)}
    return getattr(A, type(e).__name__)(**fields)


# ---------------------------------------------------------------------------
# random expression trees (the reference's generators, over its algebra)
# ---------------------------------------------------------------------------


def _gen_num(draw, depth):
    kind = draw(st.integers(0, 5 if depth > 0 else 1))
    if kind == 0:
        return RA.VarRef(draw(st.integers(0, 1)))
    if kind == 1:
        return RA.Lit(int(draw(st.integers(0, NUM_RANGE - 1))))
    if kind == 2:
        return RA.Arith(draw(st.sampled_from(["+", "-", "*"])),
                        _gen_num(draw, depth - 1), _gen_num(draw, depth - 1))
    if kind == 3:  # division errors: the divisor column has zero rows
        return RA.Arith("/", _gen_num(draw, depth - 1), RA.VarRef(2))
    if kind == 4:
        return RA.Func("if", (_gen_bool(draw, depth - 1),
                              _gen_num(draw, depth - 1), _gen_num(draw, depth - 1)))
    return RA.Func("coalesce", (_gen_num(draw, depth - 1), _gen_num(draw, depth - 1)))


_STR_FUNCS = ("strstarts", "strends", "contains", "regex")
_STR_ARGS = ('"ap"', '"a"', '"e"', '"an"', '"^a.p"', '""')


def _gen_bool(draw, depth):
    kind = draw(st.integers(0, 9 if depth > 0 else 4))
    if kind == 0:
        return RA.Cmp(draw(st.sampled_from(["<", "<=", ">", ">="])),
                      _gen_num(draw, depth - 1), _gen_num(draw, depth - 1))
    if kind == 1:  # code-domain equality (vars / constants / the term col)
        lhs = RA.VarRef(draw(st.integers(0, 3)))
        rhs = draw(st.sampled_from([RA.VarRef(0), RA.VarRef(3), RA.Lit(3), RA.Lit('"apple"'),
                                    RA.Lit(":iri1"), RA.Lit(":absent")]))
        return RA.Cmp(draw(st.sampled_from(["=", "!="])), lhs, rhs)
    if kind == 2:
        return RA.Bound(draw(st.integers(0, 3)))
    if kind == 3:
        f = draw(st.sampled_from(_STR_FUNCS))
        return RA.Func(f, (RA.VarRef(3), RA.Lit(draw(st.sampled_from(_STR_ARGS)))))
    if kind == 4:
        return RA.Func(draw(st.sampled_from(["isnumeric", "isiri", "isliteral"])),
                       (draw(st.sampled_from([RA.VarRef(3), RA.Lit('"x"'), RA.Lit(":i")])),))
    if kind == 5:
        return RA.Not(_gen_bool(draw, depth - 1))
    if kind == 6:
        terms = tuple(_gen_bool(draw, depth - 1) for _ in range(draw(st.integers(2, 3))))
        return (RA.And if draw(st.integers(0, 1)) else RA.Or)(terms)
    if kind == 7:
        return RA.Func("in", (RA.VarRef(draw(st.integers(0, 1))),
                              RA.Lit(1), RA.Lit(5), RA.Lit(9)))
    if kind == 8:  # term EBV, sameTerm, and computed values in boolean context
        return draw(st.sampled_from([
            RA.VarRef(3), RA.Func("sameterm", (RA.VarRef(0), RA.VarRef(1))),
            RA.Func("sameterm", (RA.Lit('"a"'), RA.Lit('"a"'))),
            RA.Arith("-", RA.VarRef(0), RA.VarRef(1)),
        ]))
    # IF/COALESCE with raw term branches: EBV must apply per branch
    if draw(st.integers(0, 1)):
        return RA.Func("coalesce", (RA.VarRef(draw(st.integers(0, 3))),
                                    _gen_bool(draw, depth - 1)))
    return RA.Func("if", (_gen_bool(draw, depth - 1),
                          _gen_bool(draw, depth - 1), _gen_bool(draw, depth - 1)))


def _drawn_batches(data, n_max):
    rd, pd, codes = _dicts()
    n = data.draw(st.integers(0, n_max))  # 0 == empty batch
    rng = np.random.RandomState(data.draw(st.integers(0, 2**31 - 1)))
    cols = _columns(rng, n, codes)
    cap = data.draw(st.sampled_from([None, bucket_for(max(n, 1))]))
    return rd, pd, _batches(cols, cap)


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_walk_mask_matches_reference_and_vm(data):
    expr = _gen_bool(data.draw, depth=3)
    rd, pd, (rb, pb) = _drawn_batches(data, 200)
    want = r_mask(expr, rb, rd)
    got = eval_expr_mask(_port_expr(expr), pb, pd)
    assert got.dtype == torch.bool and got.shape == (pb.capacity,)
    np.testing.assert_array_equal(got.numpy(), want)
    vm = eval_program_mask(compile_expr(_port_expr(expr), pd, "mask"), pb, pd)
    np.testing.assert_array_equal(vm.numpy(), want)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_walk_values_match_reference_and_vm(data):
    expr = _gen_num(data.draw, depth=3)
    rd, pd, (rb, pb) = _drawn_batches(data, 150)
    want_v, want_ok = r_values(expr, rb, rd)
    got_v, got_ok = eval_expr_values(_port_expr(expr), pb, pd)
    assert got_v.dtype == torch.float64
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_array_equal(got_v.numpy()[want_ok], want_v[want_ok])
    vm_v, vm_ok = eval_program_values(compile_expr(_port_expr(expr), pd, "value"), pb, pd)
    np.testing.assert_array_equal(vm_ok.numpy(), want_ok)
    np.testing.assert_array_equal(vm_v.numpy()[want_ok], want_v[want_ok])


# ---------------------------------------------------------------------------
# three-valued pins (the reference's regression cases)
# ---------------------------------------------------------------------------


def _rows(*cols):
    """Two-variable batches (?v0, ?v1) of the given code rows."""
    return _batches([np.asarray(c, np.int32) for c in cols])


def _pin(expr, batches, d_pair, expect):
    (rb, pb), (rd, pd) = batches, d_pair
    want = r_mask(expr, rb, rd)
    pe = _port_expr(expr)
    got = eval_expr_mask(pe, pb, pd).numpy()
    vm = eval_program_mask(compile_expr(pe, pd, "mask"), pb, pd).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vm, want)
    assert got.tolist()[: len(expect)] == expect


def test_three_valued_pins():
    rd, pd, _ = _dicts()
    d = (rd, pd)
    eq = RA.Cmp("=", RA.VarRef(0), RA.VarRef(1))
    # NOT(error) stays error: an unbound ?a satisfies neither ?a = ?b nor its NOT
    _pin(eq, _rows([NULL_ID], [3]), d, [False])
    _pin(RA.Not(eq), _rows([NULL_ID], [3]), d, [False])
    # true || error == true; false || error stays error
    bound_a = _rows([3], [NULL_ID])
    _pin(RA.Or((RA.Cmp("=", RA.VarRef(0), RA.Lit(3)), RA.Cmp("=", RA.VarRef(1), RA.Lit(5)))),
         bound_a, d, [True])
    _pin(RA.Or((RA.Cmp("=", RA.VarRef(0), RA.Lit(4)), RA.Cmp("=", RA.VarRef(1), RA.Lit(5)))),
         bound_a, d, [False])
    # Kleene AND: false && error == false, so !(false && error) == true
    _pin(RA.Not(RA.And((RA.Cmp("=", RA.VarRef(0), RA.Lit(4)),
                        RA.Cmp("=", RA.VarRef(1), RA.Lit(5))))), bound_a, d, [True])
    # IF / COALESCE in a FILTER take a term's EBV ("apple" true, unbound falls through)
    apple = pd.lookup('"apple"')
    terms = _rows([apple, NULL_ID], [5, 5])
    for e in (RA.Func("coalesce", (RA.VarRef(0), RA.Lit(0))),
              RA.Func("if", (RA.Bound(0), RA.VarRef(0), RA.Lit(0)))):
        _pin(e, terms, d, [True, False])
    # IN keeps term identity beside a computed item
    _pin(RA.Func("in", (RA.VarRef(0), RA.Lit('"apple"'), RA.Arith("+", RA.VarRef(1), RA.Lit(0)))),
         _rows([apple, 5], [0, 5]), d, [True, True])
    # two distinct constants absent from the dictionary are unequal terms
    _pin(RA.Cmp("=", RA.Lit('"nope"'), RA.Lit('"also-nope"')), _rows([0], [0]), d, [False])
    # division by zero is an error, which COALESCE recovers from
    ge = RA.Cmp(">=", RA.Arith("/", RA.VarRef(0), RA.VarRef(1)), RA.Lit(0))
    _pin(ge, _rows([3], [0]), d, [False])
    _pin(RA.Not(ge), _rows([3], [0]), d, [False])
    _pin(RA.Cmp(">=", RA.Func("coalesce", (RA.Arith("/", RA.VarRef(0), RA.VarRef(1)), RA.Lit(7))),
                RA.Lit(7)), _rows([3], [0]), d, [True])


@pytest.mark.parametrize("expr", [
    RA.Func("sameterm", (RA.Arith("+", RA.VarRef(0), RA.Lit(1)), RA.VarRef(1))),
    RA.Func("regex", (RA.VarRef(3), RA.VarRef(0))),
    RA.Func("strstarts", (RA.VarRef(3), RA.VarRef(0))),
    RA.Func("contains", (RA.VarRef(3), RA.Arith("+", RA.VarRef(0), RA.Lit(1)))),
    RA.Func("isiri", (RA.Arith("+", RA.VarRef(0), RA.Lit(1)),)),
    RA.Func("strlen", (RA.VarRef(3),)),
], ids=["sameterm", "regex", "strstarts", "contains", "isiri", "unknown"])
def test_walk_refuses_as_the_reference_does(expr):
    rd, pd, codes = _dicts()
    rb, pb = _batches(_columns(np.random.RandomState(1), 16, codes))
    with pytest.raises((TypeError, ValueError)) as want:
        r_mask(expr, rb, rd)
    with pytest.raises(want.type, match=str(want.value).replace("(", r"\(").replace(")", r"\)")):
        eval_expr_mask(_port_expr(expr), pb, pd)


@pytest.fixture(scope="module")
def social_stores():
    ref, _ = ref_social(scale=0.02, seed=1)
    terms = [ref.dict.decode(i) for i in range(len(ref.dict))]
    return ref, store_from_arrays(ref.index_array("spoc"), terms, device="cpu")


@pytest.mark.parametrize("engine", ["barq", "legacy", "mixed"])
@pytest.mark.parametrize("flt", ["REGEX(?q, ?p)", "SAMETERM(?p + 1, ?q)"], ids=["regex", "sameterm"])
def test_uncompilable_filters_refused_alike_by_every_engine(social_stores, engine, flt):
    """The planner marks them uncompilable; the walk refuses them at the
    first batch or row with the reference's TypeError."""
    ref, port = social_stores
    q = f"SELECT ?p ?q {{ ?p :knows ?q . FILTER({flt}) }}"
    with pytest.raises(TypeError) as want:
        REngine(ref, RConfig(engine=engine)).execute(q)
    with pytest.raises(TypeError, match=str(want.value)):
        repro_torch.Engine(port, repro_torch.EngineConfig(engine=engine), device="cpu").execute(q)


def test_filter_op_marks_the_walk(social_stores):
    """``program=False`` (the planner's mark) runs the walk, with the same
    rows as the VM; only a program carries the "[vm]" detail."""
    _, port = social_stores
    pat = A.TriplePattern(A.V(0), A.K(":knows"), A.V(1))
    expr = A.Or((A.Cmp("<", A.VarRef(0), A.VarRef(1)), A.Func("isiri", (A.VarRef(1),))))
    walk = FilterOp(IndexScan(port, pat), expr, port.dict, program=False)
    vm = FilterOp(IndexScan(port, pat), expr, port.dict)
    assert (walk.program, walk.stats.detail, vm.stats.detail) == (None, "", "[vm]")

    def rows(op):
        out = []
        while (b := op.next_batch()) is not None:
            out.extend(map(tuple, b.columns[:, b.mask].T.tolist()))
        return sorted(out)

    assert rows(walk) == rows(vm)
    # no dictionary to compile against: the walk, over codes alone
    ne = A.Cmp("!=", A.VarRef(0), A.VarRef(1))
    bare = FilterOp(IndexScan(port, pat), ne, None)
    assert bare.program is None
    assert rows(bare) == rows(FilterOp(IndexScan(port, pat), ne, port.dict))


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------


def _sorted_source(n, batch, pool=None, null_every=0):
    rng = np.random.RandomState(n)
    keys = np.sort(rng.randint(0, max(n // 3, 1), n)).astype(np.int32)
    vals = rng.randint(0, 50, n).astype(np.int32)
    if null_every:
        vals[::null_every] = NULL_ID
    cols = torch.from_numpy(np.stack([keys, vals]))
    return MaterializedSource((0, 1), cols, 0, batch_size=batch, pool=pool), keys, vals


def test_batch_to_row_copies_each_batch_once(monkeypatch):
    calls = []
    real = adapters.host_rows

    def counting(b):
        calls.append(b.n_rows)
        return real(b)

    monkeypatch.setattr(adapters, "host_rows", counting)
    src, keys, vals = _sorted_source(1000, 64, null_every=7)
    op = BatchToRow(src)
    rows = op.drain()
    assert len(calls) == op.stats.extra["host_copies"] == 16 and sum(calls) == 1000
    want = [{0: int(k)} if v == NULL_ID else {0: int(k), 1: int(v)} for k, v in zip(keys, vals)]
    assert rows == want  # NULL cells are left out of the row, as unbound


def test_batch_to_row_takes_active_rows_only():
    src, keys, vals = _sorted_source(100, 100)
    d = Dictionary()
    for v in range(50):  # code i <-> term int(i)
        d.encode(v)
    flt = FilterOp(src, A.Cmp(">", A.VarRef(1), A.Lit(25)), d)
    rows = BatchToRow(flt).drain()
    assert rows == [{0: int(k), 1: int(v)} for k, v in zip(keys, vals) if v > 25]


@pytest.mark.parametrize("target_at", [0.3, 0.55, 0.9])
def test_batch_to_row_skips_mid_batch(target_at):
    src, keys, vals = _sorted_source(400, 128)
    op = BatchToRow(src)
    first = [op.next_row() for _ in range(10)]
    target = int(keys[int(len(keys) * target_at)])
    op.skip(0, target)
    rest = op.drain()
    lo = int(np.searchsorted(keys, target))
    assert first == [{0: int(k), 1: int(v)} for k, v in zip(keys[:10], vals[:10])]
    assert rest == [{0: int(k), 1: int(v)} for k, v in zip(keys[lo:], vals[lo:])]


class _Rows(LOP.RowOperator):
    def __init__(self, rows, vars_, sorted_var=None):
        self.rows, self._vars, self._sv, self.i = rows, vars_, sorted_var, 0
        super().__init__("Rows")

    def var_ids(self):
        return self._vars

    def sorted_by(self):
        return self._sv

    def _next(self):
        if self.i >= len(self.rows):
            return None
        self.i += 1
        return self.rows[self.i - 1]

    def _skip(self, var, target):
        while self.i < len(self.rows) and self.rows[self.i][var] < target:
            self.i += 1

    def _reset(self):
        self.i = 0


@pytest.mark.parametrize("batch_size", [1, bucket_for(100) - 1, bucket_for(100)])
@pytest.mark.parametrize("pooled", [False, True])
def test_row_to_batch_shapes(batch_size, pooled):
    rows = [{0: i, 1: 3 * i} if i % 5 else {0: i} for i in range(150)]
    pool = BatchPool(CPU) if pooled else None
    op = RowToBatch(_Rows(rows, (0, 1), 0), CPU, batch_size=batch_size, pool=pool)
    got = []
    while (b := op.next_batch()) is not None:
        assert b.capacity == bucket_for(batch_size) and b.sorted_by == 0
        assert 0 < b.n_rows <= batch_size and b.n_active == b.n_rows
        assert (b.columns[:, b.n_rows:] == NULL_ID).all() and not b.mask[b.n_rows:].any()
        got.extend(b.columns[:, : b.n_rows].T.tolist())
        b.release()
    assert got == [[r[0], r.get(1, NULL_ID)] for r in rows]
    assert op.stats.extra["uploads"] == -(-150 // batch_size)
    if pooled:
        c = pool.counters()
        assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"]


def test_row_to_batch_forwards_skip():
    rows = [{0: i, 1: i} for i in range(100)]
    op = RowToBatch(_Rows(rows, (0, 1), 0), CPU, batch_size=10)
    op.next_batch().release()
    op.skip(0, 55)
    b = op.next_batch()
    assert b.columns[0, : b.n_rows].tolist() == list(range(55, 65))


def test_pool_balances_after_an_early_close(social_stores):
    """A query torn down mid-stream leaves no pooled buffer out: BatchToRow
    hands each batch back once it is on the host."""
    _, port = social_stores
    pool = BatchPool(CPU)
    scan = IndexScan(port, A.TriplePattern(A.V(0), A.K(":knows"), A.V(1)), pool=pool)
    op = RowToBatch(BatchToRow(scan), CPU, batch_size=32, pool=pool)
    op.next_batch().release()
    close_tree(op)
    c = pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
    engine = repro_torch.Engine(port, repro_torch.EngineConfig(engine="mixed"), device="cpu")
    res = engine.execute("SELECT ?p ?q { ?p :knows ?q } ORDER BY ?q LIMIT 3")
    assert res.n_rows == 3
    c = engine.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
