"""Emit plans wider than one ``gather_emit`` launch, on the PyTorch port,
against the JAX package, on the CPU.

A plan of more than ``MAX_ROWS`` emitted rows or ``MAX_PAIRS`` pairs runs
on the card as several launches over the same ``li``/``ri``, each writing
its own rows and ANDing its pairs into the mask. Here the plain version
runs each such plan whole, and ``_chunked_plain`` repeats the kernel's
launches one by one (a chunk's rows at its offset, the first chunk writing
the mask, later chunks with pairs clearing it), so that the split is held
against the whole plan and against the reference's numpy ``gather_emit``.
The engine cases (an 18-property star, joins on six shared variables, a
UNION that concatenates 20-column batches) run under the default
configuration, merge/off, hash/off and hash/on with every plain call
replaced by ``_chunked_plain``, against ``repro.core.Engine(engine="barq")``.

Tolerances: none. Every output is a dictionary code or a bool, so blocks,
masks and decoded rows must be equal.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.kernels import ops  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core.batch import ColumnBatch, concat_batches  # noqa: E402
from repro_torch.kernels import gather_emit as GE  # noqa: E402

CPU = torch.device("cpu")
CONFIGS = {"default": (None, None), "merge-off": ("merge", "off"),
           "hash-off": ("hash", "off"), "hash-on": ("hash", "on")}
_WHOLE = GE.gather_emit_plain


def _chunked_plain(lcols, rcols, li, ri, plan, out=None, out_offset=0):
    """The kernel's launches of ``plan``, one plain call per chunk, held
    against the whole plan's plain result."""
    c = int(li.shape[0])
    want_b, want_m = _WHOLE(lcols, rcols, li, ri, plan)
    block = torch.full((plan.n_rows, c), 7, dtype=torch.int32)
    mask = torch.zeros(c, dtype=torch.bool)
    for r0, s, _ in plan.chunks:
        rows = list(s.row)[:s.n_rows]
        pairs = list(zip(s.pair_left, s.pair_right))[:s.n_pairs]
        sub = GE.EmitPlan(rows[:s.n_left], rows[s.n_left:], pairs)
        b, m = _WHOLE(lcols, rcols, li, ri, sub)
        block[r0: r0 + s.n_rows] = b
        if r0 == 0:
            mask = m.clone()
        elif s.n_pairs:
            mask &= m
    assert torch.equal(block, want_b) and torch.equal(mask, want_m)
    _chunked_plain.wide += len(plan.chunks) > 1
    if out is None:
        return block, mask
    view = out[:plan.n_rows, out_offset: out_offset + c]
    view.copy_(block)
    return view, mask


_chunked_plain.wide = 0


def _case(rng, kl, kr, nl, nr, c, vf):
    lcols = rng.randint(0, 3, (kl, nl)).astype(np.int32)
    rcols = rng.randint(0, 3, (kr, nr)).astype(np.int32)
    li = rng.randint(0, nl, c).astype(np.int32)
    ri = rng.randint(0, nr, c).astype(np.int32)
    ri[rng.rand(c) < vf] = -1
    return lcols, rcols, li, ri


# name: (lsel, rsel, pairs) past the caps
WIDE_PLANS = {
    "20 rows, 6 pairs": (tuple(range(16)) + (-1, 17), (0, 3), [(k, k % 4) for k in range(6)]),
    "pairs only": ((), (), [(k, (k + 1) % 4) for k in range(6)]),
    "right rows past a chunk edge": (tuple(range(14)), (0, 1, -1, 3, 2), [(0, 0)]),
    "three chunks": (tuple(range(18)) * 2, (1,), [(k, 0) for k in range(9)]),
}


@pytest.mark.parametrize("name", sorted(WIDE_PLANS))
def test_wide_plan_chunks_match_reference(name):
    """Each chunk within the caps, rows and pairs split in order, and the
    launches together equal the whole plan and the numpy oracle."""
    lsel, rsel, pairs = WIDE_PLANS[name]
    rng = np.random.RandomState(len(name))
    lcols, rcols, li, ri = _case(rng, 18, 4, 60, 40, 500, 0.2)
    plan = GE.EmitPlan(lsel, rsel, pairs)
    assert len(plan.chunks) > 1
    assert all(s.n_rows <= GE.MAX_ROWS and s.n_pairs <= GE.MAX_PAIRS for _, s, _ in plan.chunks)
    assert sum(s.n_rows for _, s, _ in plan.chunks) == plan.n_rows
    assert sum(s.n_pairs for _, s, _ in plan.chunks) == len(plan.pairs)
    want_b, want_m = ops.gather_emit(lcols, rcols, li, ri, tuple(lsel), tuple(rsel),
                                     tuple(pairs), backend="numpy")
    t = [torch.from_numpy(x) for x in (lcols, rcols, li, ri)]
    got_b, got_m = _chunked_plain(*t, plan)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b).reshape(got_b.shape))
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    got_b, got_m = GE.gather_emit(*t, plan)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b).reshape(got_b.shape))
    np.testing.assert_array_equal(got_m.numpy(), want_m)


def test_concat_of_a_20_column_batch():
    """concat_batches builds a plan over every output column: 20 here, NULL
    where the source lacks the variable, at an offset into the output."""
    rng = np.random.RandomState(2)
    wide = ColumnBatch.from_columns(
        tuple(range(20)), [torch.from_numpy(rng.randint(0, 9, 50).astype(np.int32))
                           for _ in range(20)], CPU)
    wide = wide.with_mask(torch.from_numpy(rng.rand(wide.capacity) < 0.7))
    narrow = ColumnBatch.from_columns((3, 19, 21), [torch.arange(30, dtype=torch.int32)] * 3, CPU)
    out = concat_batches([narrow, wide], CPU, tuple(range(22)))
    sel = wide.selection_vector().numpy()
    cols = out.columns.numpy()[:, :out.n_rows]
    assert out.n_rows == 30 + len(sel)
    for v in range(22):
        want_n = np.arange(30) if v in (3, 19, 21) else np.full(30, -1)
        want_w = wide.columns.numpy()[v, sel] if v < 20 else np.full(len(sel), -1)
        np.testing.assert_array_equal(cols[v], np.concatenate([want_n, want_w]))
    assert len(GE.EmitPlan(range(22)).chunks) == 2


@pytest.fixture(scope="module")
def wide_store():
    """20 subjects with 18 properties each, over three values; 20 others
    with six properties, the first ten copying a subject's first six
    values and every fourth changing its sixth, so that joins on six
    variables match wholly, partly and not at all."""
    rng = np.random.RandomState(0)
    s = RStore()
    vals = rng.randint(0, 3, (20, 18))
    for i in range(20):
        for k in range(18):
            s.add(f":s{i}", f":p{k}", f":v{vals[i, k]}")
    for j in range(20):
        for k in range(6):
            v = int(vals[j, k]) if j < 10 else int(rng.randint(0, 3))
            if j % 4 == 3 and k == 5:
                v = (v + 1) % 3
            s.add(f":t{j}", f":q{k}", f":v{v}")
    ref = s.build()
    terms = [ref.dict.decode(i) for i in range(len(ref.dict))]
    return ref, store_from_arrays(ref.index_array("spoc"), terms, device="cpu")


_STAR = " ".join(f"?s :p{k} ?o{k} ." for k in range(18))
_SIX_S = " ".join(f"?s :p{k} ?{v} ." for k, v in enumerate("abcdef"))
_SIX_T = " ".join(f"?t :q{k} ?{v} ." for k, v in enumerate("abcdef"))
WIDE_QUERIES = {
    "18-property star": f"SELECT * {{ {_STAR} }}",
    "join on six variables": f"SELECT * {{ {{ {_SIX_S} }} {{ {_SIX_T} }} }}",
    "optional on six variables": f"SELECT * {{ {_SIX_S} OPTIONAL {{ {_SIX_T} }} }}",
    "minus on six variables": f"SELECT * {{ {_SIX_S} MINUS {{ {_SIX_T} }} }}",
    "union of 20-column batches": f"SELECT * {{ {{ {_STAR} }} UNION {{ ?s :q0 ?x }} }}",
}
WIDE_EMITS = ("18-property star", "union of 20-column batches")
# rows the reference returns for each query on wide_store
WIDE_ROWS = {"18-property star": 20, "join on six variables": 9,
             "optional on six variables": 20, "minus on six variables": 11,
             "union of 20-column batches": 40}


def _rows(res, store):
    return Counter(tuple(sorted(r.items())) for r in res.decoded(store.dict))


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(WIDE_QUERIES))
def test_wide_query_matches_reference(wide_store, monkeypatch, cfg, name):
    ref_store, port_store = wide_store
    js, sip = CONFIGS[cfg]
    monkeypatch.setattr(GE, "gather_emit_plain", _chunked_plain)
    _chunked_plain.wide = 0
    ref = REngine(ref_store, RConfig(join_strategy=js, sip=sip))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(join_strategy=js, sip=sip),
                              device="cpu")
    want, got = ref.execute(WIDE_QUERIES[name]), port.execute(WIDE_QUERIES[name])
    assert sum(_rows(want, ref_store).values()) == WIDE_ROWS[name]
    assert _rows(got, port_store) == _rows(want, ref_store)
    if name in WIDE_EMITS or cfg == "merge-off":
        # a plan past the caps ran as chunks: 19 or 20 emitted rows, or on
        # the merge path one key and five pairs (the hash join packs the
        # six variables into one key)
        assert _chunked_plain.wide > 0
    c = port.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
