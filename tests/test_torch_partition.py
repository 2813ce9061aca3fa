"""The port's out-of-core execution against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the reference's
operators (``repro.core.partition``, the grace ``HashJoin``, the
partitioned aggregates, the merge join's spilling window) and through the
port's (``device="cpu"``, the kernels' plain versions). Partition ids and
blocks must be equal, rows equal as multisets, and the spill counters
(``spill_files``, ``spill_bytes``, ``grace_partitions``,
``repartitions``, ``adaptive_switches``) equal; no spill file may outlive
an operator's close, nor a query that fails half way. Then the engine:
the LSQB and BSBM BI queries at scale 1 under ``memory_budget`` 0 and 64
KiB with ``spill_dir``.
"""

import glob
import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Engine as REngine  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import QuadStore as RStore  # noqa: E402
from repro.core import partition as RP  # noqa: E402
from repro.core.algebra import AggSpec as RAgg  # noqa: E402
from repro.core.batch import BatchPool as RPool  # noqa: E402
from repro.core.dictionary import Dictionary as RDict  # noqa: E402
from repro.core.operators import aggregate as RA  # noqa: E402
from repro.core.operators import merge_join as RMJ  # noqa: E402
from repro.core.operators.hash_join import HashJoin as RHashJoin  # noqa: E402
from repro.core.operators.sort import MaterializedSource as RSource  # noqa: E402
from repro.data.bsbm import BSBM_BI_QUERIES  # noqa: E402
from repro.data.bsbm import generate_ecommerce_graph as ref_bsbm  # noqa: E402
from repro.data.lsqb import LSQB_QUERIES  # noqa: E402
from repro.data.lsqb import generate_social_graph as ref_social  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core.algebra import AggSpec as TAgg  # noqa: E402
from repro_torch.core.batch import BatchPool as TPool  # noqa: E402
from repro_torch.core.dictionary import Dictionary as TDict  # noqa: E402
from repro_torch.core.operators import aggregate as TA  # noqa: E402
from repro_torch.core.operators import merge_join as TMJ  # noqa: E402
from repro_torch.core.operators import simple as TSimple  # noqa: E402
from repro_torch.core.operators.base import close_tree  # noqa: E402
from repro_torch.core.operators.hash_join import HashJoin as THashJoin  # noqa: E402
from repro_torch.core.operators.sort import MaterializedSource as TSource  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these inputs are small, and the test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
MODES = ("inner", "left_outer", "semi", "anti")
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
COUNTERS = ("spill_files", "spill_bytes", "grace_partitions", "repartitions",
            "adaptive_switches", "hash_build_rows")


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _leaks(d):
    return glob.glob(os.path.join(str(d), "*.npy"))


def _edge_keys(rng, n):
    """int32 keys over the whole range with NULL (-1), INT32_MIN and
    INT32_MAX among them."""
    k = rng.randint(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    k[rng.rand(n) < 0.1] = -1
    k[:3] = (I32_MIN, I32_MAX, -1)
    return k


# ---------------------------------------------------------------------------
# partition ids and fan-out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [2, 8, 64, 1024])
@pytest.mark.parametrize("level", range(5))
def test_partition_ids_match_reference(level, n_parts):
    rng = np.random.RandomState(level * 31 + n_parts)
    lo, hi = _edge_keys(rng, 3000), _edge_keys(rng, 3000)
    hi_pos = (hi & 0x7FFFFFFF).astype(np.int32)  # packed key halves: hi >= 0
    for h in (None, hi_pos):
        want = RP.partition_ids(h, lo, n_parts, level)
        got = TP.partition_ids(None if h is None else T(h), T(lo), n_parts, level)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    for k in (1, 2, 3):
        cols = [lo, hi, _edge_keys(rng, 3000)][:k]
        want = RP.partition_ids_multi(cols, n_parts, level)
        got = TP.partition_ids_multi([T(c) for c in cols], n_parts, level)
        np.testing.assert_array_equal(got.numpy(), want)


def test_edge_keys_hash_as_their_uint32_patterns():
    """-1 hashes as 0xFFFFFFFF and INT32_MIN as 0x80000000, as numpy's
    astype(np.uint32) reads them."""
    keys = np.asarray([-1, I32_MIN, I32_MAX, 0], np.int32)
    for level in range(4):
        mult = TP._LEVEL_MULTS[level]
        want = [((u * mult) % (1 << 32)) >> 16 & 1023 for u in (0xFFFFFFFF, 1 << 31, I32_MAX, 0)]
        assert TP.partition_ids_multi([T(keys)], 1024, level).tolist() == want
        assert TP.partition_ids(None, T(keys), 1024, level).tolist() == want


def test_next_pow2_matches_reference():
    for x in (0, 1, 2, 3, 5, 8, 1000, 4097):
        assert TP.next_pow2(x) == RP.next_pow2(x)


@pytest.mark.parametrize("n_parts", [2, 8, 256])
def test_split_block_matches_reference(n_parts):
    rng = np.random.RandomState(n_parts)
    cols = rng.randint(-1, 100, (3, 2000)).astype(np.int32)
    pids = RP.partition_ids_multi([cols[0]], n_parts)
    want = RP.split_block(cols, pids, n_parts)
    got = TP.split_block(T(cols), T(pids), n_parts)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# PartitionedRelation
# ---------------------------------------------------------------------------


def _rel_pair(tmp_path, n_vars, n_parts, budget):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    ref = RP.PartitionedRelation(n_vars, n_parts, spill_dir=str(ref_dir), budget_bytes=budget)
    port = TP.PartitionedRelation(n_vars, n_parts, CPU, spill_dir=str(port_dir),
                                  budget_bytes=budget)
    return ref, port, port_dir


@pytest.mark.parametrize("budget", [None, 0, 8_000, 40_000])
def test_partitioned_relation_accounting_matches_reference(tmp_path, budget):
    rng = np.random.RandomState(5)
    ref, port, port_dir = _rel_pair(tmp_path, 2, 16, budget)
    for i in range(8):
        cols = rng.randint(-1, 1 << 16, (2, 500 + 300 * i)).astype(np.int32)
        pids = RP.partition_ids_multi([cols[0]], 16)
        ref.append(cols, pids)
        port.append(T(cols), TP.partition_ids_multi([T(cols[0])], 16))
        np.testing.assert_array_equal(port.part_rows, ref.part_rows)
        assert (port.spill_files, port.spill_bytes, port.resident_bytes, port.total_rows) == (
            ref.spill_files, ref.spill_bytes, ref.resident_bytes, ref.total_rows)
        assert len(_leaks(port_dir)) == port.spill_files
    if budget is None:
        assert port.spill_files == 0  # without a budget it stays resident
    else:
        assert port.spill_files > 0
    np.testing.assert_array_equal(port.load(3).numpy(), ref.load(3))
    for p in range(16):
        np.testing.assert_array_equal(port.take(p).numpy(), ref.take(p))
        assert port.resident_bytes == ref.resident_bytes
        assert port.take(p).shape == (2, 0)
    assert not _leaks(port_dir)
    ref.close()
    port.close()
    port.close()  # idempotent


def test_partitioned_relation_chunks_own_their_memory(tmp_path):
    """A chunk is a copy, not a view into the scattered block: the
    resident bytes describe what the relation holds."""
    port = TP.PartitionedRelation(1, 4, CPU)
    cols = torch.arange(4000, dtype=torch.int32)[None, :]
    port.append(cols, TP.partition_ids_multi([cols[0]], 4))
    chunks = [c for p in range(4) for c in port._chunks[p]]
    assert sum(c.untyped_storage().nbytes() for c in chunks) == port.resident_bytes == 16_000
    port.close()


def test_partitioned_relation_spill_failure_raises_and_cleans_up(tmp_path, monkeypatch):
    port = TP.PartitionedRelation(1, 4, CPU, spill_dir=str(tmp_path), budget_bytes=100)

    def broken(path, arr):
        open(path, "wb").write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(TP.np, "save", broken)
    cols = torch.arange(400, dtype=torch.int32)[None, :]
    with pytest.raises(OSError, match="disk full"):
        port.append(cols, TP.partition_ids_multi([cols[0]], 4))
    port.close()
    assert not _leaks(tmp_path)


# ---------------------------------------------------------------------------
# the grace hash join
# ---------------------------------------------------------------------------


def _ref_rows(op):
    rows = []
    for b in op.drain():
        c = b.compact()
        rows.extend(tuple(r) for r in c.to_rows_array().tolist())
        c.release()
    return Counter(rows)


def _port_rows(op):
    rows = []
    while (b := op.next_batch()) is not None:
        c = b.compact()
        rows.extend(tuple(r) for r in c.columns[:, : c.n_rows].T.tolist())
        c.release()
    return Counter(rows)


def _join_pair(tmp_path, l, r, lv, rv, keys, mode, **kw):
    """The reference's and the port's HashJoin over the same inputs, each
    spilling into a directory of its own (kw: memory_budget, grace,
    post_filter pairs)."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir(exist_ok=True)
    port_dir.mkdir(exist_ok=True)
    l, r = np.asarray(l, np.int32), np.asarray(r, np.int32)
    rp, tp = RPool(), TPool(CPU)
    ref = RHashJoin(RSource(lv, l, None, batch_size=512, pool=rp),
                    RSource(rv, r, None, batch_size=512, pool=rp),
                    keys, mode, pool=rp, backend="numpy", spill_dir=str(ref_dir), **kw)
    port = THashJoin(TSource(lv, T(l), None, batch_size=512, pool=tp),
                     TSource(rv, T(r), None, batch_size=512, pool=tp),
                     keys, CPU, mode, pool=tp, spill_dir=str(port_dir), **kw)
    return ref, port, tp, port_dir


def _check_join(tmp_path, l, r, lv, rv, keys, mode, **kw):
    ref, port, tp, port_dir = _join_pair(tmp_path, l, r, lv, rv, keys, mode, **kw)
    want, got = _ref_rows(ref), _port_rows(port)
    assert got == want
    ref_extra = {k: v for k, v in ref.stats.extra.items() if k in COUNTERS}
    assert {k: v for k, v in port.stats.extra.items() if k in COUNTERS} == ref_extra
    ref.close()
    close_tree(port)
    assert not _leaks(port_dir)
    c = tp.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
    return port, ref_extra


def _join_inputs(kind, rng, n):
    """(l, r, lv, rv, keys) for one key, two keys, or two keys whose spans
    overflow the 62-bit pack (the join hashes one and verifies the other
    pairwise)."""
    if kind == "one key":
        return ([rng.randint(-1, 400, n), rng.randint(0, 50, n)],
                [rng.randint(-1, 500, n // 2), rng.randint(0, 50, n // 2)],
                (0, 1), (0, 2), (0,))
    if kind == "two keys":
        return ([rng.randint(-1, 40, n), rng.randint(0, 30, n), rng.randint(0, 9, n)],
                [rng.randint(-1, 40, n // 2), rng.randint(0, 30, n // 2),
                 rng.randint(0, 9, n // 2)],
                (0, 1, 2), (0, 1, 3), (0, 1))
    base = (1 << 31) - 40
    lk, rk = rng.randint(0, 40, n) + base, rng.randint(0, 40, n // 2) + base
    return ([lk, lk - rng.randint(0, 2, n), rng.randint(0, 9, n)],
            [rk, rk - rng.randint(0, 2, n // 2), rng.randint(0, 9, n // 2)],
            (0, 1, 2), (0, 1, 3), (0, 1))


@pytest.mark.parametrize("kind", ["one key", "two keys", "span overflow"])
@pytest.mark.parametrize("mode", MODES)
def test_grace_join_matches_reference(tmp_path, mode, kind):
    rng = np.random.RandomState(len(kind) + len(mode))
    l, r, lv, rv, keys = _join_inputs(kind, rng, 6000)
    layouts = []
    orig = THashJoin._build_resident

    def recording(self, bcols):
        orig(self, bcols)
        layouts.append(self._pair_vars)

    THashJoin._build_resident = recording
    try:
        port, extra = _check_join(tmp_path, l, r, lv, rv, keys, mode,
                                  memory_budget=6_000, grace=True)
    finally:
        THashJoin._build_resident = orig
    assert extra["spill_files"] > 0 and extra["grace_partitions"] == 32
    if kind == "span overflow":
        # partitions holding the largest keys overflow the pack and verify
        # the second key pairwise; the layout resets for the others
        assert set(layouts) == {(), (1,)}


@pytest.mark.parametrize("mode", MODES)
def test_grace_join_null_keys_and_probe_only_partitions(tmp_path, mode):
    """NULL (-1) keys join each other; most probe keys have no build rows,
    so whole partitions are probe-only (anti and left_outer NULL-extend
    them through the leftovers)."""
    rng = np.random.RandomState(11)
    n = 4000
    lk = np.where(rng.rand(n) < 0.2, -1, rng.randint(0, 5000, n))
    rk = np.where(rng.rand(n // 4) < 0.3, -1, rng.randint(0, 6, n // 4))
    l = [lk, rng.randint(0, 7, n)]
    r = [rk, rng.randint(0, 7, n // 4)]
    port, extra = _check_join(tmp_path, l, r, (0, 1), (0, 2), (0,), mode,
                              memory_budget=3_000, grace=True, grace_parts=64)
    assert extra["grace_partitions"] == 64


def test_grace_join_left_outer_condition(tmp_path):
    """OPTIONAL { ... } FILTER under grace: left_outer rows tracked per
    probe chunk, NULL-extended where every match fails the condition."""
    from repro.core.algebra import Cmp, Lit, VarRef
    from repro_torch.core import algebra as TAlg

    rng = np.random.RandomState(12)
    rd, td = RDict(), TDict()
    for v in range(20):
        rd.encode(v)
        td.encode(v)
    l = [rng.randint(0, 300, 3000), rng.randint(0, 20, 3000)]
    r = [rng.randint(0, 300, 2000), rng.randint(0, 20, 2000)]
    ref, port, _, port_dir = _join_pair(tmp_path, l, r, (0, 1), (0, 2), (0,), "left_outer",
                                        memory_budget=4_000, grace=True)
    ref.post_filter, ref.dictionary = Cmp(">", VarRef(2), Lit(9)), rd
    ref.post_program = None
    port = THashJoin(port.probe, port.build, (0,), CPU, "left_outer", pool=port.pool,
                     post_filter=TAlg.Cmp(">", TAlg.VarRef(2), TAlg.Lit(9)), dictionary=td,
                     memory_budget=4_000, spill_dir=str(port_dir), grace=True)
    assert port._needs_tracking()
    assert _port_rows(port) == _ref_rows(ref)
    assert port.stats.extra["spill_files"] == ref.stats.extra["spill_files"] > 0
    close_tree(port)
    ref.close()
    assert not _leaks(port_dir)


@pytest.mark.parametrize("mode", ["semi", "inner"])
def test_grace_join_skew_recursion_matches_reference(tmp_path, mode):
    """80% of the build on one key: its partition blows the budget and
    re-partitions (then builds resident, its keys all equal)."""
    rng = np.random.RandomState(8)
    n = 8000
    # the inner join emits (probe rows on 7) x 6,400: keep them few there
    hot = 0.8 if mode == "semi" else 0.01
    lk = np.where(rng.rand(n // 4) < hot, 7, rng.randint(0, 2000, n // 4))
    rk = np.where(rng.rand(n) < 0.8, 7, rng.randint(0, 2000, n))
    l = [lk, rng.randint(0, 10, n // 4)]
    r = [rk, rng.randint(0, 10, n)]
    _, extra = _check_join(tmp_path, l, r, (0, 1), (0, 2), (0,), mode,
                           memory_budget=n * 8 // 10, grace=True)
    assert extra["repartitions"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_runtime_switch_to_grace_matches_reference(tmp_path, mode):
    """No planner directive: the materialised build is over the budget and
    the probe is unsorted, so the join goes grace at run time."""
    rng = np.random.RandomState(9)
    n = 6000
    l = [rng.randint(0, n, n), rng.randint(0, 5, n)]
    r = [rng.randint(0, n, n), rng.randint(0, 5, n)]
    port, extra = _check_join(tmp_path, l, r, (0, 1), (0, 2), (0,), mode,
                              memory_budget=n * 8 // 4)
    assert extra["adaptive_switches"] == 1 and "grace" in port.stats.detail
    assert port.sorted_by() is None


def test_grace_sip_keys_load_every_partition(tmp_path):
    rng = np.random.RandomState(13)
    l = [rng.randint(0, 500, 2000), rng.randint(0, 5, 2000)]
    r = [rng.randint(0, 500, 3000), rng.randint(0, 5, 3000)]
    ref, port, _, port_dir = _join_pair(tmp_path, l, r, (0, 1), (0, 2), (0,), "inner",
                                        memory_budget=4_000, grace=True)
    assert sorted(port.sip_keys(0).tolist()) == sorted(ref.sip_keys(0).tolist())
    assert port.sorted_by() is None
    files = len(_leaks(port_dir))
    assert files > 0
    assert _port_rows(port) == _ref_rows(ref)  # sip_keys freed nothing
    close_tree(port)
    ref.close()
    assert not _leaks(port_dir)


def test_grace_join_reset_reruns(tmp_path):
    rng = np.random.RandomState(14)
    l = [rng.randint(0, 300, 2000), rng.randint(0, 5, 2000)]
    r = [rng.randint(0, 300, 2000), rng.randint(0, 5, 2000)]
    ref, port, _, port_dir = _join_pair(tmp_path, l, r, (0, 1), (0, 2), (0,), "inner",
                                        memory_budget=3_000, grace=True)
    first = _port_rows(port)
    port.reset()
    assert not _leaks(port_dir)
    assert _port_rows(port) == first == _ref_rows(ref)
    close_tree(port)
    ref.close()


# ---------------------------------------------------------------------------
# partitioned GROUP BY and DISTINCT
# ---------------------------------------------------------------------------


def _agg_inputs(seed, n):
    rng = np.random.RandomState(seed)
    cols = np.stack([rng.randint(0, 40, n), rng.randint(0, 25, n),
                     rng.randint(-1, 300, n)]).astype(np.int32)
    rd, td = RDict(), TDict()
    for v in range(300):  # the aggregated codes are numbers
        x = v * 0.5 if v % 3 else v
        assert rd.encode(x) == td.encode(x) == v
    return cols, rd, td


@pytest.mark.parametrize("distinct", [False, True])
def test_partitioned_group_by_matches_reference(tmp_path, distinct):
    cols, rd, td = _agg_inputs(11 + distinct, 12_000)
    specs = [("count", None, 10), ("count", 2, 11), ("sum", 2, 12), ("min", 2, 13),
             ("max", 2, 14), ("avg", 2, 15)]
    raggs = [RAgg(f, v, distinct and v is not None, o) for f, v, o in specs]
    taggs = [TAgg(f, v, distinct and v is not None, o) for f, v, o in specs]
    (tmp_path / "port").mkdir()
    ref = RA.PartitionedGroupBy(RSource((0, 1, 2), cols, None, 1024), (0, 1), raggs, rd,
                                memory_budget=10_000, spill_dir=str(tmp_path), n_parts=8)
    port = TA.PartitionedGroupBy(TSource((0, 1, 2), T(cols), None, 1024), (0, 1), taggs, td,
                                 CPU, memory_budget=10_000, spill_dir=str(tmp_path / "port"),
                                 n_parts=8)

    def decoded(rows, d):
        return Counter(tuple(d.decode(c) if c >= 0 else None for c in r) for r in rows)

    want, got = _ref_rows(ref), _port_rows(port)
    assert sum(got.values()) == sum(want.values()) == 40 * 25
    assert decoded(got, td) == decoded(want, rd)
    assert {k: port.stats.extra[k] for k in ("spill_files", "spill_bytes", "grace_partitions")} == {
        k: ref.stats.extra[k] for k in ("spill_files", "spill_bytes", "grace_partitions")}
    assert port.stats.extra["spill_files"] > 0
    close_tree(port)
    ref.close()
    assert not _leaks(tmp_path / "port")


@pytest.mark.parametrize("n_vars", [1, 2, 3])
def test_partitioned_distinct_matches_reference(tmp_path, n_vars):
    cols, _, _ = _agg_inputs(12, 12_000)
    cols = cols[:n_vars]
    (tmp_path / "port").mkdir()
    ref = RA.PartitionedDistinct(RSource(tuple(range(n_vars)), cols, None, 1024),
                                 memory_budget=8_000, spill_dir=str(tmp_path), n_parts=8)
    port = TA.PartitionedDistinct(TSource(tuple(range(n_vars)), T(cols), None, 1024), CPU,
                                  memory_budget=8_000, spill_dir=str(tmp_path / "port"),
                                  n_parts=8)
    assert _port_rows(port) == _ref_rows(ref)
    assert (port.stats.extra["spill_files"], port.stats.extra["spill_bytes"]) == (
        ref.stats.extra["spill_files"], ref.stats.extra["spill_bytes"])
    assert port.sorted_by() is None
    close_tree(port)
    ref.close()
    assert not _leaks(tmp_path / "port")


# ---------------------------------------------------------------------------
# the merge join's spilling window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_merge_window_spill_matches_reference(tmp_path, monkeypatch, mode):
    """With the threshold made small in both packages, the right window
    spills while draining (one hot key of many rows amid others), keeps
    trimming on its resident keys and emits from the spill file."""
    monkeypatch.setattr(RMJ, "_SPILL_THRESHOLD_ROWS", 256)
    monkeypatch.setattr(TMJ, "_SPILL_THRESHOLD_ROWS", 256)
    rng = np.random.RandomState(15)
    lk = np.sort(np.concatenate([[500] * 3, rng.randint(0, 1000, 600)]))
    rk = np.sort(np.concatenate([[500] * 700, rng.randint(0, 1000, 1500)]))
    l = np.stack([lk, rng.randint(0, 9, lk.size), rng.randint(0, 4, lk.size)]).astype(np.int32)
    r = np.stack([rk, rng.randint(0, 9, rk.size), rng.randint(0, 4, rk.size)]).astype(np.int32)
    (tmp_path / "port").mkdir()
    ref = RMJ.MergeJoin(RSource((0, 1, 3), l, 0, 64), RSource((0, 2, 3), r, 0, 64), 0, mode,
                        spill_dir=str(tmp_path))
    port = TMJ.MergeJoin(TSource((0, 1, 3), T(l), 0, 64), TSource((0, 2, 3), T(r), 0, 64), 0,
                         CPU, mode, spill_dir=str(tmp_path / "port"))
    plain = TMJ.MergeJoin(TSource((0, 1, 3), T(l), 0, 64), TSource((0, 2, 3), T(r), 0, 64), 0,
                          CPU, mode)
    got = _port_rows(port)
    assert got == _ref_rows(ref) == _port_rows(plain)
    assert port._rwin.spills > 0 and plain._rwin.spills == 0
    close_tree(port)
    ref.close()
    assert not _leaks(tmp_path / "port")


def test_spilled_window_serves_keys_and_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(TMJ, "_SPILL_THRESHOLD_ROWS", 8)
    from repro_torch.core.batch import ColumnBatch

    w = TMJ._Window((0, 1), 0, CPU, spill_dir=str(tmp_path))
    keys = torch.arange(20, dtype=torch.int32) // 2
    w.append_batch(ColumnBatch.from_columns((0, 1), [keys, keys * 10], CPU))
    assert w.spilled and len(_leaks(tmp_path)) == 1
    assert w.trim_below(3) == 6 and w.last_key() == 9
    assert w.keys.tolist() == keys[6:].tolist()
    src, idx = w.source(torch.tensor([0, 5, 13], dtype=torch.int32))
    assert src[:, idx.long()].tolist() == [[3, 5, 9], [30, 50, 90]]
    w.append_batch(ColumnBatch.from_columns((0, 1), [keys[:1] + 10, keys[:1]], CPU))
    assert w.spilled  # re-materialised, then over the threshold again
    assert len(_leaks(tmp_path)) == 1 and w.spills == 2
    w.close()
    assert not _leaks(tmp_path)


# ---------------------------------------------------------------------------
# no spill file outlives a failed query
# ---------------------------------------------------------------------------


class _Bomb(RuntimeError):
    pass


def _join_store(n=4000, seed=13):
    rng = np.random.RandomState(seed)
    store = RStore()
    for i in range(n):
        store.add(f":s{i:05d}", ":knows", f":o{rng.randint(0, 50):05d}")
        store.add(f":s{i:05d}", ":name", f":n{rng.randint(0, 30):05d}")
        store.add(f":t{i:05d}", ":likes", f":o{rng.randint(0, 50):05d}")
        store.add(f":t{i:05d}", ":age", int(rng.randint(0, 90)))
    return store.build()


def _port_store(ref_store):
    terms = [ref_store.dict.decode(i) for i in range(len(ref_store.dict))]
    return store_from_arrays(ref_store.index_array("spoc"), terms, device="cpu")


@pytest.fixture(scope="module")
def join_stores():
    ref = _join_store()
    return ref, _port_store(ref)


LEAK_QUERIES = {
    "join": "SELECT ?s ?o ?n { ?s :knows ?o . ?s :name ?n }",
    "group": "SELECT ?o (COUNT(*) AS ?c) { ?s :knows ?o . ?s :name ?n } GROUP BY ?o",
    "distinct": "SELECT DISTINCT ?o ?n { ?s :knows ?o . ?s :name ?n }",
    "merge": "SELECT ?a ?x ?g { ?a :knows ?x . ?b :likes ?x . ?b :age ?g }",
}


def _failing_project(monkeypatch, after_batches):
    orig = TSimple.ProjectOp.next_batch
    state = {"n": 0}

    def boom(self):
        if state["n"] >= after_batches:
            raise _Bomb("downstream failure")
        state["n"] += 1
        return orig(self)

    monkeypatch.setattr(TSimple.ProjectOp, "next_batch", boom)


def _count_calls(monkeypatch, cls, name):
    counter = {"n": 0}
    orig = getattr(cls, name)

    def counting(self, *a, **kw):
        counter["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, name, counting)
    return counter


def test_merge_join_spill_not_leaked_on_error(tmp_path, monkeypatch, join_stores):
    monkeypatch.setattr(TMJ, "_SPILL_THRESHOLD_ROWS", 64)
    spills = _count_calls(monkeypatch, TMJ._Window, "_spill")
    _failing_project(monkeypatch, 1)
    eng = repro_torch.Engine(join_stores[1], repro_torch.EngineConfig(
        spill_dir=str(tmp_path), join_strategy="merge"), device="cpu")
    assert "MergeJoin" in eng.explain(LEAK_QUERIES["merge"])
    with pytest.raises(_Bomb):
        eng.execute(LEAK_QUERIES["merge"])
    assert spills["n"] > 0
    assert not _leaks(tmp_path)


@pytest.mark.parametrize("name,marker", [("join", "grace"), ("distinct", "Distinct[partitioned")])
def test_partitioned_spill_not_leaked_on_error(tmp_path, monkeypatch, join_stores, name, marker):
    spills = _count_calls(monkeypatch, TP.PartitionedRelation, "_spill_partition")
    _failing_project(monkeypatch, 1)
    eng = repro_torch.Engine(join_stores[1], repro_torch.EngineConfig(
        spill_dir=str(tmp_path), memory_budget=20_000, join_strategy="hash"), device="cpu")
    assert marker in eng.explain(LEAK_QUERIES[name])
    with pytest.raises(_Bomb):
        eng.execute(LEAK_QUERIES[name])
    assert spills["n"] > 0
    assert not _leaks(tmp_path)


def test_partitioned_group_by_spill_not_leaked_on_error(tmp_path, monkeypatch, join_stores):
    """Die inside the partition-at-a-time loop: partitions not yet taken
    still hold spill files when the exception unwinds."""
    spills = _count_calls(monkeypatch, TP.PartitionedRelation, "_spill_partition")
    orig = TA.SortGroupBy._aggregate_block
    calls = {"n": 0}

    def bomb(self, cols, need, avars):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise _Bomb("mid-aggregation failure")
        return orig(self, cols, need, avars)

    monkeypatch.setattr(TA.SortGroupBy, "_aggregate_block", bomb)
    eng = repro_torch.Engine(join_stores[1], repro_torch.EngineConfig(
        spill_dir=str(tmp_path), memory_budget=8_000), device="cpu")
    assert "Group[partitioned" in eng.explain(LEAK_QUERIES["group"])
    with pytest.raises(_Bomb):
        eng.execute(LEAK_QUERIES["group"])
    assert spills["n"] > 0
    assert not _leaks(tmp_path)


@pytest.mark.parametrize("name", sorted(LEAK_QUERIES))
def test_budgeted_engine_matches_reference_on_the_join_store(tmp_path, join_stores, name):
    ref_store, port_store = join_stores
    cfg = dict(memory_budget=20_000, join_strategy="hash")
    (tmp_path / "ref").mkdir()
    ref = REngine(ref_store, RConfig(spill_dir=str(tmp_path / "ref"), **cfg))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(
        spill_dir=str(tmp_path), **cfg), device="cpu")
    text = LEAK_QUERIES[name]
    assert port.explain(text) == ref.explain(text)
    got, want = port.execute(text), ref.execute(text)
    assert _decoded(got, port_store) == _decoded(want, ref_store)
    assert not _leaks(tmp_path)


# ---------------------------------------------------------------------------
# the engine on the LSQB and BSBM BI stores under a budget
# ---------------------------------------------------------------------------


def _decoded(res, store):
    return Counter(tuple(sorted(r.items())) for r in res.decoded(store.dict))


@pytest.fixture(scope="module")
def engine_stores(social_store):
    """LSQB and BSBM at scale 1, where 64 KiB sends the larger builds and
    groups out of core, and small ones (LSQB 0.04, BSBM 0.02), where a
    budget of 0 (every blocking operator partitioned, every append
    spilled) stays quick."""
    lsqb, _ = ref_social(scale=1.0, seed=42)
    bsbm, _ = ref_bsbm(scale=1.0, seed=7)
    small_bsbm, _ = ref_bsbm(scale=0.02, seed=7)
    return {(64 << 10, "lsqb"): (lsqb, _port_store(lsqb)),
            (64 << 10, "bsbm"): (bsbm, _port_store(bsbm)),
            (0, "lsqb"): (social_store[0], _port_store(social_store[0])),
            (0, "bsbm"): (small_bsbm, _port_store(small_bsbm))}


# q8 and b6 emit the largest results; at scale 1 they take a minute on the
# CPU whatever the budget, so 64 KiB runs them on the card only
# (chip_smoke.py's breadth phase)
WORK = [(b, "lsqb", n, LSQB_QUERIES[n]) for b in (0, 64 << 10) for n in sorted(LSQB_QUERIES)
        if (b, n) != (64 << 10, "q8")] + \
       [(b, "bsbm", n, BSBM_BI_QUERIES[n]) for b in (0, 64 << 10) for n in sorted(BSBM_BI_QUERIES)
        if (b, n) != (64 << 10, "b6")]


@pytest.mark.parametrize("budget,store,name,text", WORK,
                         ids=[f"{w[2]}-{w[0]}" for w in WORK])
def test_engine_under_budget_matches_reference(tmp_path, engine_stores, budget, store,
                                               name, text):
    ref_store, port_store = engine_stores[(budget, store)]
    (tmp_path / "ref").mkdir()
    ref = REngine(ref_store, RConfig(memory_budget=budget, spill_dir=str(tmp_path / "ref")))
    port = repro_torch.Engine(port_store, repro_torch.EngineConfig(
        memory_budget=budget, spill_dir=str(tmp_path)), device="cpu")
    assert port.explain(text) == ref.explain(text)
    try:
        want = ref.execute(text)
    except AssertionError as e:
        # the reference's planner fault: under a budget it may put a grace
        # hash join (no order) under a merge join; the port refuses the
        # same plan the same way, before anything runs
        assert "sorted by join var" in str(e)
        with pytest.raises(ValueError, match="sorted by the join var"):
            port.execute(text)
    else:
        assert _decoded(port.execute(text), port_store) == _decoded(want, ref_store)
    assert not _leaks(tmp_path)
    c = port.pool.counters()
    assert c["live"] == 0 and c["allocs"] == c["releases"] + c["pooled"], c
