"""The PyTorch port's kernels (``repro_torch.kernels``) against the JAX
package's kernel dispatch (``repro.kernels.ops``).

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests pin what the CUDA kernels must compute: the same numpy inputs, made
from a seed, go through the reference's numpy backend (the oracle) and its
Pallas backend (interpret mode), and through the port.

Tolerances: integer outputs and code-domain / integer-valued results are
exact. The port's value plane is float64, as the numpy oracle's: expression
values and errors equal the oracle's exactly, on any values. Against the
float32 Pallas mirrors, port values are compared after rounding to float32,
on float32-exact inputs, and must be equal; float sums against the Pallas
doubling scan get ``rtol=1e-5`` (another summation order, in float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import algebra as RA  # noqa: E402
from repro.core import vecops as RV  # noqa: E402
from repro.core.batch import ColumnBatch as RBatch  # noqa: E402
from repro.core.dictionary import Dictionary as RDict  # noqa: E402
from repro.core.exprs import compile_expr as r_compile  # noqa: E402
from repro.core.exprs import disassemble as r_disassemble  # noqa: E402
from repro.core.exprs.vm import prepare_inputs as r_prepare  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.kernels.segment_reduce import segment_scan_pallas  # noqa: E402

from repro_torch.core import algebra as TA  # noqa: E402
from repro_torch.core import vecops as TV  # noqa: E402
from repro_torch.core.batch import ColumnBatch as TBatch  # noqa: E402
from repro_torch.core.dictionary import Dictionary as TDict  # noqa: E402
from repro_torch.core.exprs import bytecode as TB  # noqa: E402
from repro_torch.core.exprs import compile_expr as t_compile  # noqa: E402
from repro_torch.core.exprs import disassemble as t_disassemble  # noqa: E402
from repro_torch.core.exprs.vm import prepare_inputs as t_prepare  # noqa: E402
from repro_torch.kernels import expr_eval as EE  # noqa: E402
from repro_torch.kernels import gather_emit as GE  # noqa: E402
from repro_torch.kernels import join_expand as JE  # noqa: E402
from repro_torch.kernels import segment_scan as SS  # noqa: E402

CPU = torch.device("cpu")


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# join_expand
# ---------------------------------------------------------------------------


def _groups(rng, g, max_l, max_r, unit_left=False, unit_right=False):
    llens = np.ones(g, np.int32) if unit_left else rng.randint(1, max_l + 1, g).astype(np.int32)
    rlens = np.ones(g, np.int32) if unit_right else rng.randint(1, max_r + 1, g).astype(np.int32)
    lstarts = np.cumsum(np.concatenate([[0], llens[:-1]])).astype(np.int32)
    rstarts = np.cumsum(np.concatenate([[0], rlens[:-1]])).astype(np.int32)
    return lstarts, llens, rstarts, rlens, RV.group_output_offsets(llens, rlens)


JOIN_EXPAND_CASES = {
    # name: (groups, max left run, max right run, unit left, unit right, base, count)
    "groups beyond G_MAX": (2100, 2, 3, False, False, 5, 3000),
    "unit left runs": (300, 1, 30, True, False, 0, None),
    "unit right runs": (300, 30, 1, False, True, 7, None),
    "count beyond 4096": (90, 9, 9, False, False, 0, 5000),
    "tail past the total": (40, 3, 3, False, False, 10, 200),
}


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
@pytest.mark.parametrize("case", sorted(JOIN_EXPAND_CASES))
def test_join_expand_matches_reference(backend, case):
    g, ml, mr, ul, ur, base, count = JOIN_EXPAND_CASES[case]
    rng = np.random.RandomState(g + ml * 7 + mr)
    ls, ll, rs, rl, cum = _groups(rng, g, ml, mr, ul, ur)
    total = int(cum[-1])
    if count is None:
        count = total - base
    got_l, got_r = JE.join_expand(T(ls), T(ll), T(rs), T(rl), T(cum), base, count)
    assert got_l.dtype == torch.int32 and got_r.dtype == torch.int32
    n_valid = max(0, min(count, total - base))
    want_l, want_r = ops.join_expand(ls, ll, rs, rl, cum, base, n_valid, backend=backend)
    np.testing.assert_array_equal(got_l.numpy()[:n_valid], want_l)
    np.testing.assert_array_equal(got_r.numpy()[:n_valid], want_r)
    # slots past the grand total are invalid in both outputs
    assert (got_l.numpy()[n_valid:] == -1).all() and (got_r.numpy()[n_valid:] == -1).all()


@pytest.mark.parametrize("where", ["head", "tail"])
def test_join_expand_totals_beyond_int32(where):
    """A cum total beyond 2^31: int64 offsets as in the numpy path (the
    Pallas path narrows cum to int32, so it is not asked)."""
    rng = np.random.RandomState(5)
    ls, ll, rs, rl, cum = _groups(rng, 20000, 1000, 1000)
    total = int(cum[-1])
    assert total > 2 ** 31
    base = 3 if where == "head" else total - 4096 - 17
    want = RV.expand_cross(ls, ll, rs, rl, cum, base, 4096)
    got = JE.join_expand(T(ls), T(ll), T(rs), T(rl), T(cum), base, 4096)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("side", ["small tile", "large tile"])
def test_join_expand_tile_choice_matches_reference(side):
    """The wrapper runs at the tile the kernel takes for the window's size
    (small below ``LARGE_FROM`` slots, large from it); on each side of that
    choice it equals the numpy reference, at an unaligned base."""
    count = JE.LARGE_FROM - 1 if side == "small tile" else JE.LARGE_FROM + 77
    assert JE.tile_for(count) == (JE.TILE_SMALL if side == "small tile" else JE.TILE_LARGE)
    rng = np.random.RandomState(9)
    ls, ll, rs, rl, cum = _groups(rng, 20000, 4, 8)
    base = 1234
    assert int(cum[-1]) > base + count
    want = RV.expand_cross(ls, ll, rs, rl, cum, base, count)
    got = JE.join_expand(T(ls), T(ll), T(rs), T(rl), T(cum), base, count)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_join_expand_checks_its_inputs():
    rng = np.random.RandomState(1)
    ls, ll, rs, rl, cum = _groups(rng, 5, 2, 2)
    with pytest.raises(ValueError, match="cum"):
        JE.join_expand(T(ls), T(ll), T(rs), T(rl), T(cum.astype(np.int32)), 0, 4)
    with pytest.raises(ValueError, match="lstarts"):
        JE.join_expand(T(ls.astype(np.int64)), T(ll), T(rs), T(rl), T(cum), 0, 4)
    empty = torch.zeros(0, dtype=torch.int32)
    li, ri = JE.join_expand(empty, empty, empty, empty, torch.zeros(1, dtype=torch.int64), 0, 3)
    assert li.tolist() == [-1, -1, -1] and ri.tolist() == [-1, -1, -1]


def _split(size, rng):
    """(llens, rlens) of one group with ``size`` output slots."""
    if size % 2 == 0 and rng.rand() < 0.5:
        return 2, size // 2
    return (1, size) if rng.rand() < 0.5 else (size, 1)


def _tiled_groups(rng, tile, n_tiles, empty_first=False):
    """Groups laid out against tiles of ``tile`` slots: each tile starts
    with a run of 0-6 empty groups (left or right run empty) and is then
    cut into random groups, some of which run into the next tile. With
    ``empty_first`` the run has 1-6 groups and no group runs into the next
    tile, so every tile's first slot opens on a run of empty groups."""
    ll, rl = [], []
    for _ in range(n_tiles):
        for _ in range(rng.randint(1 if empty_first else 0, 7)):
            ll.append(0 if rng.rand() < 0.5 else rng.randint(1, 4))
            rl.append(0 if ll[-1] else rng.randint(1, 4))
        left = tile
        while left > 0:
            size = min(left, rng.randint(1, tile // 4 + 2))
            if not empty_first and rng.rand() < 0.2:  # a group that runs into the next tile
                size += rng.randint(1, tile // 2)
            a, b = _split(size, rng)
            ll.append(a)
            rl.append(b)
            left -= size
    llens, rlens = np.asarray(ll, np.int32), np.asarray(rl, np.int32)
    lstarts = np.cumsum(np.concatenate([[0], llens[:-1]])).astype(np.int32)
    rstarts = np.cumsum(np.concatenate([[0], rlens[:-1]])).astype(np.int32)
    return lstarts, llens, rstarts, rlens, RV.group_output_offsets(llens, rlens)


def _one_group(tiles, tile):
    """A single group of ``tiles * tile`` slots (8 left rows)."""
    ll, rl = np.asarray([8], np.int32), np.asarray([tiles * tile // 8], np.int32)
    z = np.zeros(1, np.int32)
    return z, ll, z.copy(), rl, RV.group_output_offsets(ll, rl)


TILED_CASES = {
    # name: (groups(rng, tile), base(tile, total), count(tile, total))
    "groups crossing tiles": (lambda rng, tl: _groups(rng, 400, 5, 5), lambda tl, n: 0,
                              lambda tl, n: n),
    "empty runs at tile starts": (lambda rng, tl: _tiled_groups(rng, tl, 6, empty_first=True),
                                  lambda tl, n: 0,
                                  lambda tl, n: n + 5),
    "a tile inside one group": (lambda rng, tl: _one_group(5, tl), lambda tl, n: tl + 3,
                                lambda tl, n: 2 * tl),
    "unaligned base and count": (lambda rng, tl: _tiled_groups(rng, tl, 5), lambda tl, n: 7,
                                 lambda tl, n: 3 * tl + 13),
}


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
@pytest.mark.parametrize("tile", [32, 64, 256])
@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_join_expand_tiles_match_reference(backend, tile, case):
    """The plain version's tile model (the kernel's start search, scatter
    of group starts and max-scan) at small tiles, so groups, empty-group
    runs and the valid range cross many tile edges."""
    make, base_of, count_of = TILED_CASES[case]
    rng = np.random.RandomState(tile + len(case))
    ls, ll, rs, rl, cum = make(rng, tile)
    total = int(cum[-1])
    base, count = base_of(tile, total), count_of(tile, total)
    if case == "empty runs at tile starts":
        # every tile of this layout opens on a run of empty groups
        starts = set(cum[:-1][(ll * rl) == 0].tolist())
        assert set(range(0, total, tile)) <= starts
    got_l, got_r = JE.join_expand_plain(T(ls), T(ll), T(rs), T(rl), T(cum), base, count, tile)
    n_valid = max(0, min(count, total - base))
    want_l, want_r = ops.join_expand(ls, ll, rs, rl, cum, base, n_valid, backend=backend)
    np.testing.assert_array_equal(got_l.numpy()[:n_valid], want_l)
    np.testing.assert_array_equal(got_r.numpy()[:n_valid], want_r)
    assert (got_l.numpy()[n_valid:] == -1).all() and (got_r.numpy()[n_valid:] == -1).all()


@pytest.mark.parametrize("tile", [32, 64, 256])
def test_join_expand_tiles_beyond_int32(tile):
    """Tiles over a total beyond 2^31, against the numpy path (the Pallas
    path narrows cum to int32)."""
    rng = np.random.RandomState(11)
    ls, ll, rs, rl, cum = _groups(rng, 20000, 1000, 1000)
    total = int(cum[-1])
    assert total > 2 ** 31
    base = total - 5 * tile - 9
    want = RV.expand_cross(ls, ll, rs, rl, cum, base, 5 * tile + 9)
    got = JE.join_expand_plain(T(ls), T(ll), T(rs), T(rl), T(cum), base, 6 * tile, tile)
    np.testing.assert_array_equal(got[0].numpy()[:5 * tile + 9], want[0])
    np.testing.assert_array_equal(got[1].numpy()[:5 * tile + 9], want[1])
    assert (got[0].numpy()[5 * tile + 9:] == -1).all()


# ---------------------------------------------------------------------------
# gather_emit
# ---------------------------------------------------------------------------


def _ge_case(rng, kl, kr, nl, nr, c, virtual_frac):
    lcols = rng.randint(0, 6, (kl, nl)).astype(np.int32)
    rcols = rng.randint(0, 6, (kr, nr)).astype(np.int32)
    li = rng.randint(0, nl, c).astype(np.int32)
    if nr == 0:
        ri = np.full(c, -1, np.int32)
    else:
        ri = rng.randint(0, nr, c).astype(np.int32)
        ri[rng.rand(c) < virtual_frac] = -1
    return lcols, rcols, li, ri


GATHER_CASES = {
    # name: (kl, kr, nl, nr, c, virtual fraction, lsel, rsel, pairs)
    "plain emit": (2, 2, 50, 40, 100, 0.0, (0, 1), (1,), ()),
    "virtual rows, one pair": (3, 3, 700, 300, 1000, 0.25, (0, 1, 2), (2,), ((0, 0),)),
    "-1 emit rows, two pairs": (3, 3, 80, 60, 200, 0.2, (0, -1, 2), (-1, 1), ((0, 0), (2, 1))),
    "mask only": (3, 3, 80, 60, 200, 0.2, (), (), ((1, 2),)),
    "empty right side": (2, 3, 90, 0, 150, 0.0, (0, 1), (0, 2), ((0, 1),)),
    "long output": (4, 1, 64, 64, 5000, 0.0, (0, 1, 2, 3), (0,), ((3, 0),)),
}


def _port_gather(lcols, rcols, li, ri, lsel, rsel, pairs, **kw):
    return GE.gather_emit(
        T(lcols), None if rcols is None else T(rcols), T(li), None if ri is None else T(ri),
        GE.EmitPlan(lsel, rsel, pairs), **kw,
    )


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_emit_matches_reference(backend, case):
    kl, kr, nl, nr, c, vf, lsel, rsel, pairs = GATHER_CASES[case]
    rng = np.random.RandomState(kl * 31 + nl + c)
    lcols, rcols, li, ri = _ge_case(rng, kl, kr, nl, nr, c, vf)
    want_b, want_m = ops.gather_emit(lcols, rcols, li, ri, lsel, rsel, pairs, backend=backend)
    got_b, got_m = _port_gather(lcols, rcols, li, ri, lsel, rsel, pairs)
    assert got_b.shape == (len(lsel) + len(rsel), c) and got_m.dtype == torch.bool
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b).reshape(got_b.shape))
    np.testing.assert_array_equal(got_m.numpy(), want_m)


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_gather_emit_without_right_side(backend):
    """The concat path: no right source, -1 emit rows NULL-fill."""
    rng = np.random.RandomState(7)
    lcols, _, li, _ = _ge_case(rng, 3, 1, 80, 1, 200, 0.0)
    want_b, _ = ops.gather_emit(lcols, None, li, None, (0, -1, 2), (), (), backend=backend)
    got_b, got_m = _port_gather(lcols, None, li, None, (0, -1, 2), (), ())
    assert (got_b.numpy()[1] == -1).all() and bool(got_m.all())
    np.testing.assert_array_equal(got_b.numpy(), want_b)


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_gather_emit_out_offset(backend):
    """The pooled zero-copy path writes into the destination at an offset
    and leaves the rest of it alone."""
    rng = np.random.RandomState(3)
    lcols, rcols, li, ri = _ge_case(rng, 2, 2, 50, 50, 64, 0.1)
    want_out = np.full((4, 300), 99, np.int32)
    ops.gather_emit(lcols, rcols, li, ri, (0, 1), (0,), ((1, 1),), backend=backend,
                    out=want_out, out_offset=100)
    out = torch.full((4, 300), 99, dtype=torch.int32)
    view, _ = _port_gather(lcols, rcols, li, ri, (0, 1), (0,), ((1, 1),),
                           out=out, out_offset=100)
    np.testing.assert_array_equal(out.numpy(), want_out)
    assert view.data_ptr() == out[:, 100:].data_ptr()


def test_emit_plan_caps_raise_and_name_the_cap():
    """A plan at the caps is one launch; one past either cap builds as
    chunks within the caps (rows in order, pairs in order, the first chunk
    writing the mask, later ones ANDing) and gives the numpy oracle's block
    and mask."""
    at = GE.EmitPlan(range(GE.MAX_ROWS - 3), range(3), [(0, 0)] * GE.MAX_PAIRS)
    assert len(at.chunks) == 1
    rng = np.random.RandomState(5)
    lcols, rcols, li, ri = _ge_case(rng, GE.MAX_ROWS + 1, 4, 70, 50, 400, 0.2)
    for lsel, rsel, pairs, n_chunks in (
            (range(GE.MAX_ROWS + 1), (), (), 2),
            (range(GE.MAX_ROWS - 3), range(4), (), 2),
            ((0,), (), [(k, k % 4) for k in range(GE.MAX_PAIRS + 1)], 2)):
        plan = GE.EmitPlan(lsel, rsel, pairs)
        assert len(plan.chunks) == n_chunks
        assert [r0 for r0, _, _ in plan.chunks] == [0, GE.MAX_ROWS]
        assert all(s.n_rows <= GE.MAX_ROWS and s.n_pairs <= GE.MAX_PAIRS
                   for _, s, _ in plan.chunks)
        want_b, want_m = ops.gather_emit(lcols, rcols, li, ri, tuple(lsel), tuple(rsel),
                                         tuple(pairs), backend="numpy")
        got_b, got_m = _port_gather(lcols, rcols, li, ri, lsel, rsel, pairs)
        np.testing.assert_array_equal(got_b.numpy(), want_b)
        np.testing.assert_array_equal(got_m.numpy(), want_m)


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_emit_plan_at_the_caps_matches_reference(backend):
    rng = np.random.RandomState(17)
    lcols, rcols, li, ri = _ge_case(rng, 12, 6, 90, 70, 300, 0.2)
    lsel = tuple(range(11)) + (-1,)
    rsel = (5, -1, 0, 3)
    pairs = ((0, 0), (11, 1), (3, 3), (7, 5))
    assert len(lsel) + len(rsel) == GE.MAX_ROWS and len(pairs) == GE.MAX_PAIRS
    want_b, want_m = ops.gather_emit(lcols, rcols, li, ri, lsel, rsel, pairs, backend=backend)
    got_b, got_m = _port_gather(lcols, rcols, li, ri, lsel, rsel, pairs)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_m.numpy(), want_m)


def test_emit_plan_reuses_emitted_left_rows_only():
    plan = GE.EmitPlan((2, 0, -1), (1,), ((0, 1), (1, 0), (2, 2)))
    (_, s, _), = plan.chunks
    assert list(s.pair_reuse)[:3] == [1, -1, 0]
    assert list(s.row)[:4] == [2, 0, -1, 1] and s.n_left == 3
    # in a wide plan a pair reuses a left row of its own chunk only
    wide = GE.EmitPlan(range(18), (0,), [(k, 0) for k in (0, 1, 2, 3, 17, 5)])
    (_, s0, _), (_, s1, _) = wide.chunks
    assert list(s0.pair_reuse) == [0, 1, 2, 3]
    assert list(s1.pair_reuse)[:2] == [1, -1] and s1.n_left == 2 and s1.n_rows == 3


def test_emit_plan_pair_reuse_with_an_empty_right_side():
    """A pair whose left row is emitted still compares against 0 when the
    right side is empty, though the emitted right value is NULL."""
    rng = np.random.RandomState(23)
    lcols = rng.randint(0, 3, (2, 40)).astype(np.int32)
    rcols = np.zeros((2, 0), np.int32)
    li = rng.randint(0, 40, 120).astype(np.int32)
    ri = np.where(rng.rand(120) < 0.3, -1, 0).astype(np.int32)
    args = (lcols, rcols, li, ri, (0, 1), (1,), ((0, 0),))
    want_b, want_m = ops.gather_emit(*args, backend="numpy")
    got_b, got_m = _port_gather(*args)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert (got_b.numpy()[2] == -1).all()
    np.testing.assert_array_equal(got_m.numpy(), (ri < 0) | (lcols[0, li] == 0))
    assert 0 < int(got_m.sum()) < 120


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_emit_plan_from_host_ints(backend):
    """A plan built from numpy integers and ranges gives the reference's
    block and mask."""
    rng = np.random.RandomState(29)
    lcols, rcols, li, ri = _ge_case(rng, 3, 3, 60, 50, 256, 0.1)
    plan = GE.EmitPlan(np.arange(3), range(1, 3), np.asarray([[2, 0]]))
    assert plan.lsel == (0, 1, 2) and plan.rsel == (1, 2) and plan.pairs == ((2, 0),)
    assert all(type(x) is int for x in plan.lsel + plan.rsel + plan.pairs[0])
    want_b, want_m = ops.gather_emit(lcols, rcols, li, ri, (0, 1, 2), (1, 2), ((2, 0),),
                                     backend=backend)
    got_b, got_m = GE.gather_emit(T(lcols), T(rcols), T(li), T(ri), plan)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_m.numpy(), want_m)


# ---------------------------------------------------------------------------
# expr_eval (through both compilers)
# ---------------------------------------------------------------------------

NUM_RANGE = 21
TERMS = [int(v) for v in range(NUM_RANGE)] + [
    '"apple"', '"applesauce"', '"banana"', '""', ":iri1", ":iri2", 2.5,
]


def _expr(A, name):
    """Expression ``name`` built from the algebra module ``A`` (the
    reference's or the port's: the same tree in both packages)."""
    V, L = A.VarRef, A.Lit
    if name == "code domain":
        return A.And((A.Or((A.Cmp("=", V(0), V(1)), A.Cmp("!=", V(0), V(3)))),
                      A.Or((A.Cmp("=", V(0), L(3)), A.Not(A.Cmp("!=", V(1), L(5))))),
                      A.Or((A.Bound(1), A.Func("strstarts", (V(3), L('"app"')))))))
    if name == "arithmetic":
        return A.Or((A.Cmp("<", A.Arith("+", V(0), V(1)), L(12)),
                     A.Cmp(">=", A.Arith("-", V(0), V(1)), L(4)),
                     A.Cmp("<=", A.Arith("*", V(0), V(2)), L(9)),
                     A.Cmp(">", A.Arith("/", V(1), V(2)), L(3))))
    if name == "division by zero":
        return A.Cmp("!=", A.Arith("/", V(0), V(2)), L(2))
    if name == "if / coalesce":
        return A.Func("if", (A.Cmp("=", A.Arith("*", V(0), V(1)), L(12)),
                             A.Func("coalesce", (A.Cmp(">", A.Arith("/", V(0), V(2)), L(1)),
                                                 A.Cmp("!=", V(1), L(4)))),
                             A.Cmp("<", V(1), V(0))))
    if name == "numeric tests":
        return A.And((A.Func("isnumeric", (V(3),)), A.Cmp(">", V(3), L(2))))
    if name == "all opcodes":
        return A.And((
            _expr(A, "code domain"),
            A.Func("if", (A.Cmp("<", V(0), L(10)),
                          A.Cmp("<=", A.Arith("+", V(0), V(1)), L(30)),
                          A.Cmp(">", A.Arith("-", V(0), V(1)), L(-2)))),
            A.Func("coalesce", (A.Cmp(">=", A.Arith("/", V(0), V(2)), L(1)),
                                A.Cmp("=", A.Arith("*", V(0), V(1)), L(12)))),
            A.Cmp("!=", A.Arith("*", V(1), V(2)), L(4)),
        ))
    raise KeyError(name)


EXPRS = ("code domain", "arithmetic", "division by zero", "if / coalesce",
         "numeric tests", "all opcodes")


def _inputs(name, n=300, seed=0):
    """The same program and input block in both packages."""
    rd, td = RDict(), TDict()
    for t in TERMS:
        assert rd.encode(t) == td.encode(t)
    rprog = r_compile(_expr(RA, name), rd, "mask")
    tprog = t_compile(_expr(TA, name), td, "mask")
    rng = np.random.RandomState(seed)
    cols = [rng.randint(0, NUM_RANGE, n), rng.randint(0, NUM_RANGE, n),
            rng.choice([0, 1, 2, 4], n), rng.randint(0, len(TERMS), n)]
    for c in (cols[0], cols[1], cols[3]):
        c[rng.rand(n) < 0.15] = -1  # NULL codes
    cols = [c.astype(np.int32) for c in cols]
    rbatch = RBatch.from_columns((0, 1, 2, 3), cols, capacity=n)
    tbatch = TBatch.from_columns((0, 1, 2, 3), [T(c) for c in cols], CPU, capacity=n)
    return rprog, tprog, rd, td, rbatch, tbatch


@pytest.mark.parametrize("name", EXPRS)
def test_expr_programs_compile_identically(name):
    rprog, tprog, *_ = _inputs(name)
    assert t_disassemble(tprog) == r_disassemble(rprog)
    assert tprog.instrs == rprog.instrs and tprog.consts == rprog.consts


def test_expr_programs_reach_every_opcode():
    seen = set()
    for name in EXPRS:
        seen |= {i[0] for i in _inputs(name)[1].instrs}
    assert seen == set(range(23))
    assert {i[0] for i in _inputs("all opcodes")[1].instrs} == set(range(23))


@pytest.mark.parametrize("name", EXPRS)
def test_expr_prepare_inputs_matches_reference(name):
    """Code columns, predicate tables and numeric decodes (NaN for NULL
    and non-numeric terms) as the reference builds them, in float64."""
    rprog, tprog, rd, td, rbatch, tbatch = _inputs(name)
    ri, rf = r_prepare(rprog, rbatch, rd)
    ti, tf = t_prepare(tprog, tbatch, td)
    np.testing.assert_array_equal(ti.numpy(), ri)
    assert tf.dtype == torch.float64 and rf.dtype == np.float64
    np.testing.assert_array_equal(tf.numpy(), rf)


@pytest.mark.parametrize("name", EXPRS)
def test_expr_eval_matches_pallas_exactly(name):
    rprog, tprog, rd, td, rbatch, tbatch = _inputs(name)
    icols, fcols = r_prepare(rprog, rbatch, rd)
    want_v, want_e = ops.expr_eval(rprog, icols, fcols, backend="pallas")
    got_v, got_e = EE.expr_eval(tprog, T(icols), T(fcols))
    assert got_v.dtype == torch.float64 and got_e.dtype == torch.bool
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    # the inputs are float32-exact: the float64 values round to Pallas's
    np.testing.assert_array_equal(got_v.numpy().astype(np.float32), want_v)


@pytest.mark.parametrize("name", EXPRS)
def test_expr_eval_matches_numpy_oracle(name):
    rprog, tprog, rd, td, rbatch, tbatch = _inputs(name, seed=1)
    icols, fcols = r_prepare(rprog, rbatch, rd)
    want_v, want_e = ops.expr_eval(rprog, icols, fcols, backend="numpy")
    got_v, got_e = EE.expr_eval(tprog, T(icols), T(fcols))
    got_v, got_e = got_v.numpy(), got_e.numpy()
    np.testing.assert_array_equal((got_v != 0) & ~got_e, (want_v != 0) & ~want_e)
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_v, want_v)


def test_expr_eval_special_rows():
    """NULL codes, NaN numerics and 1/0 on hand-picked rows."""
    rd, td = RDict(), TDict()
    for t in TERMS:
        rd.encode(t), td.encode(t)
    e = lambda A: A.Or((A.Cmp(">", A.Arith("/", A.VarRef(0), A.VarRef(1)), A.Lit(1)),  # noqa: E731
                        A.Cmp("=", A.VarRef(0), A.Lit(3))))
    rprog, tprog = r_compile(e(RA), rd, "mask"), t_compile(e(TA), td, "mask")
    a = np.array([3, 3, -1, 4, rd.lookup('"apple"'), 6], np.int32)
    b = np.array([0, 1, 2, 0, 2, rd.lookup('"banana"')], np.int32)
    rbatch = RBatch.from_columns((0, 1), [a, b], capacity=len(a))
    icols, fcols = r_prepare(rprog, rbatch, rd)
    want = ops.expr_eval(rprog, icols, fcols, backend="numpy")
    got = EE.expr_eval(tprog, T(icols), T(fcols))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy() != 0, want[0] != 0)
    # 3/0 errs but 3 = 3 is true; NULL and 4/0 and "apple"/2 and 6/"banana" err
    assert ((got[0].numpy() != 0) & ~got[1].numpy()).tolist() == [
        True, True, False, False, False, False]


def _hand_program(instrs, n_regs, consts, n_num=1):
    return TB.ExprProgram(instrs=tuple(instrs), n_regs=n_regs, out_reg=0, consts=tuple(consts),
                          code_vars=(), num_vars=tuple(range(n_num)), tables=(), source_ops=1)


def test_expr_eval_refuses_programs_beyond_its_caps():
    """Programs past the previous kernel's caps (96 instructions, 64
    constants, 48 registers) run, and equal the float64 numpy oracle."""
    rng = np.random.RandomState(4)
    n = 200
    fcols = rng.standard_normal((1, n))
    fcols[0, ::7] = np.nan
    # 97 instructions, 70 constants: r0 = x * c0 + x * c1 + ... (3 registers)
    consts = [float(c) for c in rng.standard_normal(70)] + [float("inf")]
    long = [(TB.LOAD_NUM, 1, 0, 0, 0), (TB.LOAD_CONST, 0, 0, 0, 0), (TB.MUL, 0, 1, 0, 0)]
    for k in range(1, 47):
        long += [(TB.LOAD_CONST, 2, k, 0, 0), (TB.MUL, 2, 1, 2, 0), (TB.ADD, 0, 0, 2, 0)]
    # 49 registers, each x / c_k, summed
    wide = [(TB.LOAD_NUM, 48, 0, 0, 0)]
    for r in range(48):
        wide += [(TB.LOAD_CONST, r, r, 0, 0), (TB.DIV, r, 48, r, 0)]
    wide += [(TB.ADD, 0, 0, r, 0) for r in range(1, 49)]
    icols = np.zeros((1, n), np.int32)
    for instrs, n_regs in ((long, 3), (wide, 49)):
        prog = _hand_program(instrs, n_regs, consts)
        assert len(prog.instrs) > 96 or prog.n_regs > 48
        want_v, want_e = ops.expr_eval(prog, icols, fcols, backend="numpy")
        got_v, got_e = EE.expr_eval(prog, T(icols), T(fcols))
        np.testing.assert_array_equal(got_e.numpy(), want_e)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    # a non-finite constant errs on every row, as in the oracle
    inf = _hand_program([(TB.LOAD_CONST, 0, 70, 0, 0)], 1, consts)
    got_v, got_e = EE.expr_eval(inf, T(icols), T(fcols))
    assert bool(got_e.all()) and not bool(got_v.any())


def test_expr_program_words_hold_the_kernel_layout():
    """The device buffer: 8 int32 words an instruction, (op, dst, a, b, c)
    and, for LOAD_CONST, the float64 constant's bits in words 5 and 6."""
    consts = (0.1, float("inf"), -2.5)
    prog = _hand_program([(TB.LOAD_NUM, 1, 0, 0, 0), (TB.LOAD_CONST, 0, 2, 0, 0),
                          (TB.LOAD_CONST, 2, 0, 0, 0), (TB.IF, 0, 1, 0, 2),
                          (TB.LOAD_CONST, 1, 1, 0, 0)], 3, consts)
    words = EE.program_words(prog)
    assert words.shape == (5, EE.INSTR_WORDS) and words.dtype == np.int32
    np.testing.assert_array_equal(words[:, :5], np.asarray(prog.instrs))
    loads = [k for k, ins in enumerate(prog.instrs) if ins[0] == TB.LOAD_CONST]
    got = words[loads, 5:7].copy().view(np.float64).reshape(-1)
    np.testing.assert_array_equal(got, [consts[prog.instrs[k][2]] for k in loads])
    assert not words[[0, 3], 5:].any()
    np.testing.assert_array_equal(EE.program_buffer(prog, CPU).numpy(), words)
    with pytest.raises(ValueError, match="by value"):  # longer than the registers instance takes
        EE.short_program(prog)
    short_prog = _hand_program(prog.instrs[:EE.SHORT_INSTRS], 3, consts)
    # the registers instance reads only the by-value struct
    short, address = EE.short_program(short_prog)
    assert address and list(short) == EE.program_words(short_prog).reshape(-1).tolist()


def test_expr_launch_shapes():
    """Short programs take the registers instance; longer ones shared
    planes, at fewer threads while they exceed a block's shared memory, then
    global planes."""
    def prog(n_instr, n_regs, n_num=1):
        return _hand_program([(TB.LOAD_NUM, 0, 0, 0, 0)] * n_instr, n_regs, (), n_num)

    assert EE.launch_shape(prog(1, 1)) == (EE.THREADS, "registers")
    assert EE.launch_shape(prog(EE.SHORT_INSTRS, EE.SHORT_REGS)) == (EE.THREADS, "registers")
    assert EE.launch_shape(prog(EE.SHORT_INSTRS + 1, 2)) == (EE.THREADS, "shared")
    assert EE.launch_shape(prog(3, EE.SHORT_REGS + 1)) == (EE.THREADS, "shared")
    assert EE.smem_bytes(prog(300, 100), 128, "shared") == 32 * EE.WINDOW + 128 * (8 + 900)
    assert EE.smem_bytes(prog(300, 100), 128, "global") == 32 * EE.WINDOW
    assert EE.smem_bytes(prog(5, 2), 64, "shared") == 32 * 5 + 64 * (8 + 18)
    assert EE.window(prog(5, 2)) == 5 and EE.window(prog(300, 2)) == EE.WINDOW
    assert EE.smem_bytes(prog(3, 2), 128, "registers") == 0
    assert EE.launch_shape(prog(900, 300)) == (64, "shared")
    assert EE.launch_shape(prog(3000, 1000)) == (EE.THREADS, "global")
    for n_regs in (1, 50, 400, 806, 807, 2000):
        t, inst = EE.launch_shape(prog(900, n_regs))
        assert EE.fits(prog(900, n_regs), t, inst)
        assert (inst == "global") == (EE.smem_bytes(prog(900, n_regs), 32, "shared")
                                      > EE.SMEM_MAX)


def test_expr_eval_refuses_malformed_programs():
    """The one refusal left, on the CPU as on the card: an operand outside
    the program's registers, constants or input columns."""
    icols, fcols = torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4), dtype=torch.float64)
    for instrs, what in (([(TB.ADD, 0, 0, 3, 0)], "operand"),
                         ([(TB.LOAD_CONST, 0, 5, 0, 0)], "operand"),
                         ([(TB.LOAD_NUM, 0, 1, 0, 0)], "operand"),
                         ([(99, 0, 0, 0, 0)], "opcode")):
        with pytest.raises(ValueError, match=what):
            EE.expr_eval(_hand_program(instrs, 2, (1.0,)), icols, fcols)


# ---------------------------------------------------------------------------
# segment_scan and the segmented reduction around it
# ---------------------------------------------------------------------------


def _keys(rng, kind, n=3000):
    if kind == "runs across 1024":
        return np.sort(rng.randint(0, 4, n)).astype(np.int32)
    if kind == "one run":
        return np.full(n, 7, np.int32)
    if kind == "all distinct":
        return np.arange(n, dtype=np.int32) * 3
    return np.sort(rng.randint(0, n // 10, n)).astype(np.int32)


KEY_KINDS = ("runs across 1024", "one run", "all distinct", "short runs")


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
@pytest.mark.parametrize("func", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_segment_reduce_matches_reference(backend, func, kind):
    rng = np.random.RandomState(len(kind) * 13 + len(func))
    keys = _keys(rng, kind)
    vals = rng.randn(len(keys)).astype(np.float32).astype(np.float64)
    want_k, want_v = ops.segment_reduce(keys, vals, func, backend=backend)
    got_k, got_v = TV.segment_reduce(T(keys), T(vals), func)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    if func == "sum":
        np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got_v.numpy(), want_v)


@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_segment_scan_matches_pallas_scan(op, kind):
    """The whole inclusive scan, not only the run ends, against the Pallas
    kernel; integer-valued sums are exact."""
    rng = np.random.RandomState(len(kind) + len(op))
    keys = _keys(rng, kind)
    vals = (np.ones(len(keys)) if op == "count" else rng.randint(-40, 40, len(keys)))
    vals = vals.astype(np.float32)
    want = np.asarray(segment_scan_pallas(keys, vals, "sum" if op == "count" else op))
    got = SS.segment_scan(T(keys), T(vals.astype(np.float64)), op)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_scan_checks_its_inputs():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="float64"):
        SS.segment_scan(keys, torch.zeros(4, dtype=torch.float32), "sum")
    with pytest.raises(ValueError, match="op"):
        SS.segment_scan(keys, torch.zeros(4, dtype=torch.float64), "avg")
    assert SS.segment_scan(keys[:0], torch.zeros(0, dtype=torch.float64), "max").shape == (0,)


# the kernel's layout at small tiles (threads, items per thread), so that
# many tiles, and look-back windows of 32 tiles, occur at test sizes
SMALL_TILES = ((32, 1), (32, 4), (64, 2))
_PALLAS_SCANS = {}


def _pallas_scan(kind, op, keys, vals):
    key = (kind, op)
    if key not in _PALLAS_SCANS:
        _PALLAS_SCANS[key] = np.asarray(segment_scan_pallas(keys, vals, op))
    return _PALLAS_SCANS[key]


def _tiled_keys(kind, n=3000):
    """Keys whose runs meet the tile edges of SMALL_TILES in every way."""
    rng = np.random.RandomState(len(kind))
    if kind == "one run over every tile":
        return np.full(n, -5, np.int32)
    if kind == "runs across tile edges":
        return np.repeat(np.arange(n // 100, dtype=np.int32), 100)[:n]
    if kind == "runs ending at tile edges":
        return np.repeat(np.arange(n // 64 + 1, dtype=np.int32), 64)[:n]
    return _keys(rng, kind, n)


TILED_KINDS = ("one run over every tile", "runs across tile edges",
               "runs ending at tile edges") + KEY_KINDS


@pytest.mark.parametrize("tile", SMALL_TILES)
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("kind", TILED_KINDS)
def test_segment_scan_tiled_model_matches_pallas(kind, op, tile):
    """Per-thread items, warp and tile scans and the look-back carry, at
    small tiles, against the Pallas kernel; integer-valued sums are exact."""
    keys = _tiled_keys(kind)
    rng = np.random.RandomState(len(kind) + len(op))
    vals = (np.ones(len(keys)) if op == "count" else rng.randint(-40, 40, len(keys)))
    vals = vals.astype(np.float32)
    want = _pallas_scan(kind, op, keys, vals)
    got = SS.segment_scan_plain(T(keys), None if op == "count" else T(vals.astype(np.float64)),
                                op, *tile)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", SMALL_TILES + ((SS.THREADS, SS.ITEMS),))
def test_segment_scan_tiled_model_float_values(tile):
    """Float sums within 1e-5 of the Pallas kernel; min and max exact, NaN
    and infinities included."""
    keys = _tiled_keys("runs across tile edges", 5000)
    rng = np.random.RandomState(3)
    vals = rng.standard_normal(len(keys)).astype(np.float32)
    for op in ("sum", "min", "max"):
        if op != "sum":
            vals = vals.copy()
            vals[rng.randint(0, len(vals), 20)] = np.nan
            vals[rng.randint(0, len(vals), 20)] = np.inf
            vals[rng.randint(0, len(vals), 20)] = -np.inf
        want = np.asarray(segment_scan_pallas(keys, vals, op))
        got = SS.segment_scan_plain(T(keys), T(vals.astype(np.float64)), op, *tile).numpy()
        if op == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


def test_segment_scan_look_back_crosses_windows():
    """One run over 200 tiles of 32: each tile's carry walks back through
    more than one 32-tile window to tile 0."""
    keys = np.full(200 * 32, 9, np.int32)
    vals = np.arange(len(keys), dtype=np.float64) % 7
    got = SS.segment_scan_plain(T(keys), T(vals), "sum", 32, 1).numpy()
    np.testing.assert_array_equal(got, np.cumsum(vals))
    got = SS.segment_scan_plain(T(keys), T(vals), "max", 32, 1).numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(vals))


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_segment_scan_count_without_values(kind):
    """count with no values sums ones the kernel makes itself; with values
    it sums them, as before."""
    keys = _keys(np.random.RandomState(7), kind)
    ones = np.ones(len(keys), np.float64)
    want = np.asarray(segment_scan_pallas(keys, ones.astype(np.float32), "sum"))
    np.testing.assert_array_equal(SS.segment_scan(T(keys), None, "count").numpy(), want)
    np.testing.assert_array_equal(SS.segment_scan(T(keys), T(ones), "count").numpy(), want)
    want_k, want_v = ops.segment_reduce(keys, None, "count", backend="numpy")
    got_k, got_v = TV.segment_reduce(T(keys), None, "count")
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


def test_segment_scan_needs_values_beyond_count():
    with pytest.raises(ValueError, match="needs values"):
        SS.segment_scan(torch.zeros(4, dtype=torch.int32), None, "sum")


# ---------------------------------------------------------------------------
# the plain torch helpers around the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(0, 1), (1, 1), (500, 7), (2000, 900)])
def test_run_boundaries_and_probe_groups(n, k):
    rng = np.random.RandomState(n + k)
    lk = np.sort(rng.randint(0, k, n)).astype(np.int32)
    rk = np.sort(rng.randint(0, k, n // 2 + 1)).astype(np.int32)
    for want, got in zip(RV.run_boundaries(lk), TV.run_boundaries(T(lk))):
        np.testing.assert_array_equal(got.numpy(), want)
    lv, rv = RV.run_boundaries(lk)[0], RV.run_boundaries(rk)[0]
    for want, got in zip(RV.probe_groups(lv, rv), TV.probe_groups(T(lv), T(rv))):
        np.testing.assert_array_equal(got.numpy(), want)
    ll, rl = rng.randint(0, 5, 40).astype(np.int32), rng.randint(0, 5, 40).astype(np.int32)
    got = TV.group_output_offsets(T(ll), T(rl))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), RV.group_output_offsets(ll, rl))


@pytest.mark.parametrize("k,span", [(1, 50), (3, 50), (2, 2 ** 31 - 2)])
def test_pack_group_keys_orders_like_reference(k, span):
    """Packed keys (or the dense-rank fallback) give the same order and
    the same groups as the reference's."""
    rng = np.random.RandomState(k)
    cols = rng.randint(-1, span, (k, 400)).astype(np.int32)
    want = RV.pack_group_keys(cols)
    got = TV.pack_group_keys(T(cols)).numpy()
    np.testing.assert_array_equal(np.argsort(got, kind="stable"), np.argsort(want, kind="stable"))
    np.testing.assert_array_equal(np.unique(got, return_inverse=True)[1],
                                  np.unique(want, return_inverse=True)[1])
