"""The edges of the port's hash_probe and frontier_dedup against the JAX
package's kernels.

The CUDA kernels answer a probe key with a group of lanes searching k-ary
and read its run from the lower bound, and merge a tile of candidates
against its window of the visited set staged in shared memory. On the CPU
the wrappers run the plain versions, so these tests pin what the kernels
must compute at the inputs where those designs have edges: one partition,
runs longer than a group of lanes, runs that end at their partition's
last row, probe batches that leave a group partly past the end, column
slices at every 16-byte phase, visited sets dense in the candidates'
range, and one or a few candidates. The same numpy inputs go through the
reference's numpy oracle, its jax reference and its Pallas kernels in
interpret mode (``repro.kernels.ops``), and every output must be exact.
The last tests hold the host-side shapes the wrappers pass to the
kernels, and the build's hash of the headers the sources include.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import expr_eval as EE  # noqa: E402
from repro_torch.kernels import frontier_dedup as FD  # noqa: E402
from repro_torch.kernels import hash_join as HJ  # noqa: E402

I32_MIN = -(2 ** 31)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


# ---------------------------------------------------------------------------
# hash_probe
# ---------------------------------------------------------------------------


def _run_build(rng, n, max_run, n_parts):
    """``n`` single keys in runs of 1 to ``max_run`` rows (every third
    integer, so the next one is absent), laid out by the reference."""
    lens = rng.randint(1, max_run + 1, n)
    keys = (np.repeat(np.arange(len(lens)), lens)[:n] * 3 + 1).astype(np.int32)
    keys = keys[rng.permutation(n)]
    order, starts = ops.hash_build(None, keys, n_parts, backend="numpy")
    return keys[order], starts


def _edge_probes(rng, skl, starts):
    """Every key, each partition's last row, absent keys beside present
    ones, NULL (-1)."""
    present = np.unique(skl)
    last = skl[starts[1:][starts[1:] > starts[:-1]] - 1]
    return np.concatenate([present, last, present[:40] + 1, [-1, 0]]).astype(np.int32)


PROBE_EDGES = {
    # (rows, longest run, partitions)
    "one partition": (3000, 6, 1),
    "one partition, runs past 32 rows": (3000, 120, 1),
    "runs past 32 rows": (3000, 120, 16),
    "runs ending at their partition's end": (2500, 300, 64),
    "most partitions empty": (200, 60, 1024),
}


def _probe_edge(name):
    rng = np.random.RandomState(len(name))
    n, max_run, n_parts = PROBE_EDGES[name]
    skl, starts = _run_build(rng, n, max_run, n_parts)
    return skl, starts, n_parts, _edge_probes(rng, skl, starts)


def _port_lo_hi(starts, skl, q):
    lo, hi = HJ.hash_probe(T(starts), None, T(skl), None, T(q))
    return lo.numpy(), hi.numpy()


@pytest.mark.parametrize("backend", ["pallas", "jax"])
@pytest.mark.parametrize("name", sorted(PROBE_EDGES))
def test_hash_probe_edges_match_pallas_and_jax_exactly(name, backend):
    skl, starts, n_parts, q = _probe_edge(name)
    lo, hi = _port_lo_hi(starts, skl, q)
    spid = np.repeat(np.arange(n_parts, dtype=np.int32), np.diff(starts))
    want_lo, want_hi = ops.hash_probe(spid, None, skl, None, q, starts, n_parts, backend=backend)
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)
    run = hi - lo
    assert run.max() > 32 or PROBE_EDGES[name][1] <= 32  # runs longer than a group
    ends = set(starts[1:][starts[1:] > starts[:-1]].tolist())
    assert any(h in ends for h in hi[run > 0].tolist())  # runs ending at a partition's end


@pytest.mark.parametrize("name", sorted(PROBE_EDGES))
def test_hash_probe_edges_match_numpy_on_matched_runs(name):
    skl, starts, n_parts, q = _probe_edge(name)
    lo, hi = _port_lo_hi(starts, skl, q)
    spid = np.repeat(np.arange(n_parts, dtype=np.int32), np.diff(starts))
    want_lo, want_hi = ops.hash_probe(spid, None, skl, None, q, starts, n_parts,
                                      backend="numpy", cache={})
    np.testing.assert_array_equal(hi - lo, want_hi - want_lo)
    matched = hi > lo
    np.testing.assert_array_equal(lo[matched], want_lo[matched])
    for i in np.nonzero(matched)[0]:
        assert (skl[lo[i]:hi[i]] == q[i]).all()


@pytest.mark.parametrize("c", [1, 7, 33, 257])
def test_hash_probe_partial_groups_match_jax(c):
    """Batches that end inside a group of lanes, or a block, give each key
    the answer it has in a full batch."""
    skl, starts, n_parts, q = _probe_edge("runs past 32 rows")
    q = np.resize(q, c)
    lo, hi = _port_lo_hi(starts, skl, q)
    spid = np.repeat(np.arange(n_parts, dtype=np.int32), np.diff(starts))
    want_lo, want_hi = ops.hash_probe(spid, None, skl, None, q, starts, n_parts, backend="jax")
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)
    full_lo, full_hi = _port_lo_hi(starts, skl, np.resize(q, 4 * c + 3))
    np.testing.assert_array_equal(full_lo[:c], lo)
    np.testing.assert_array_equal(full_hi[:c], hi)


def test_hash_probe_int32_min_key_matches_jax():
    """A probe key of INT32_MIN (its mix is INT32_MIN) finds its run."""
    rng = np.random.RandomState(3)
    keys = np.concatenate([np.full(50, I32_MIN), rng.randint(-1, 400, 2000)]).astype(np.int32)
    for n_parts in (1, 16):
        order, starts = ops.hash_build(None, keys, n_parts, backend="numpy")
        skl = keys[order]
        q = np.array([I32_MIN, I32_MIN + 1, -1, 5, 2 ** 31 - 1], np.int32)
        lo, hi = _port_lo_hi(starts, skl, q)
        spid = np.repeat(np.arange(n_parts, dtype=np.int32), np.diff(starts))
        want_lo, want_hi = ops.hash_probe(spid, None, skl, None, q, starts, n_parts,
                                          backend="jax")
        np.testing.assert_array_equal(lo, want_lo)
        np.testing.assert_array_equal(hi, want_hi)
        assert hi[0] - lo[0] == 50


# ---------------------------------------------------------------------------
# frontier_dedup
# ---------------------------------------------------------------------------


def _lexsorted(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order].astype(np.int32), lo[order].astype(np.int32)


def _dense_visited(hi_span, lo_span):
    vh = np.repeat(np.arange(hi_span, dtype=np.int32), lo_span)
    vl = np.tile(np.arange(lo_span, dtype=np.int32), hi_span)
    return vh, vl


def _dedup_edge(name):
    rng = np.random.RandomState(len(name) * 7)
    ch, cl = _lexsorted(rng.randint(0, 8, 3000), rng.randint(0, 700, 3000))
    none = np.zeros(0, np.int32)
    u = np.unique(np.stack([ch, cl], 1), axis=0)
    vis = u[rng.rand(len(u)) < 0.5]
    vh, vl = vis[:, 0].astype(np.int32), vis[:, 1].astype(np.int32)
    if name == "dense visited":
        # every pair of the candidates' range but its top: a tile's window
        # holds far more visited pairs than candidates
        return (ch, cl, *_dense_visited(8, 600))
    if name == "dense visited, empty window":
        return (ch + 100, cl, *_dense_visited(8, 600))
    if name.startswith("c="):
        n = int(name[2:].split(",")[0])
        return (ch[:n], cl[:n], vh, vl) if "visited" in name else (ch[:n], cl[:n], none, none)
    if name == "all equal":
        return np.full(3000, 6, np.int32), np.full(3000, 1, np.int32), vh, vl
    if name == "all equal, visited":
        return np.full(3000, 6, np.int32), np.full(3000, 1, np.int32), vh[:1] * 0 + 6, vl[:1] * 0 + 1
    raise KeyError(name)


DEDUP_EDGES = ("dense visited", "dense visited, empty window", "c=1", "c=1, visited", "c=7",
               "c=7, visited", "all equal", "all equal, visited")


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
@pytest.mark.parametrize("case", DEDUP_EDGES)
def test_frontier_dedup_edges_match_reference(backend, case):
    ch, cl, vh, vl = _dedup_edge(case)
    want = np.asarray(ops.frontier_dedup(ch, cl, vh, vl, backend=backend), dtype=bool)
    got = FD.frontier_dedup(T(ch), T(cl), T(vh), T(vl))
    np.testing.assert_array_equal(got.numpy(), want)


def _at_offset(x, off):
    """``x`` inside a larger tensor at element offset ``off``: a slice with
    another 16-byte phase, as PathEngine._link's index slices are."""
    big = torch.zeros(len(x) + 8, dtype=torch.int32)
    big[off: off + len(x)] = T(x)
    return big[off: off + len(x)]


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
@pytest.mark.parametrize("offsets", [(1, 1), (3, 3), (1, 3), (0, 2)])
def test_frontier_dedup_on_misaligned_slices_matches_reference(offsets, backend):
    ch, cl, vh, vl = _dedup_edge("dense visited")
    hi, lo = _at_offset(ch, offsets[0]), _at_offset(cl, offsets[1])
    assert hi.is_contiguous() and hi.storage_offset() == offsets[0]
    none = np.zeros(0, np.int32)
    for v_hi, v_lo in ((vh, vl), (none, none)):
        want = np.asarray(ops.frontier_dedup(ch, cl, v_hi, v_lo, backend=backend), dtype=bool)
        np.testing.assert_array_equal(FD.frontier_dedup(hi, lo, T(v_hi), T(v_lo)).numpy(), want)


# ---------------------------------------------------------------------------
# host-side shapes and the build
# ---------------------------------------------------------------------------


def test_hash_probe_group_is_a_compiled_instance():
    """The library compiles one group size, a power of two from 8 to 32,
    and its launch takes no shape argument (the sweep's other sizes are
    built from the same source by kernel_sweep.py)."""
    src = (build.CSRC / "hash_probe.cu").read_text()
    (group,) = re.findall(r"constexpr int GROUP = (\d+);", src)
    assert int(group) in (8, 16, 32)
    assert re.findall(r"return launch<(\w+)>", src) == ["GROUP"]
    assert "group" not in src[src.index('extern "C" int hash_probe_launch'):]


def test_frontier_dedup_shapes():
    src = (build.CSRC / "frontier_dedup.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"(\w+_(?:THREADS|ITEMS)) = (\d+)", src)}
    assert (consts["SMALL_THREADS"], consts["SMALL_ITEMS"]) == FD.SMALL_TILE
    assert (consts["LARGE_THREADS"], consts["LARGE_ITEMS"]) == FD.LARGE_TILE
    assert len(re.findall(r"return launch<", src)) == 2  # the two tiles alone
    chunk = 8 * FD.CHUNK
    big = FD.LARGE_FROM
    # small launches: the small tile, every window searched (no chunk)
    for c, v in ((1, 0), (1, 1), (4096, 242_000), (big - 1, 0), (big - 1, 1)):
        assert FD.launch_shape(c, v) == (*FD.SMALL_TILE, 0)
    # large ones: the large tile, with a chunk of visited pairs unless the
    # visited set is empty; the small tile where the visited set is too
    # large for the candidates to stage
    assert FD.launch_shape(big, 0) == (*FD.LARGE_TILE, 0)
    assert FD.launch_shape(1 << 20, 480_000) == (*FD.LARGE_TILE, chunk)
    assert FD.launch_shape(big, FD.STAGED_UP_TO * big) == (*FD.LARGE_TILE, chunk)
    assert FD.launch_shape(big, FD.STAGED_UP_TO * big + 1) == (*FD.SMALL_TILE, 0)
    assert FD.launch_shape(1 << 20, 4_000_000) == (*FD.SMALL_TILE, 0)
    assert chunk <= 48 * 1024  # no opt-in to more shared memory at the chosen chunk
    assert FD.smem_bytes(16384) == 131072  # past 48 KB: the launch asks for it
    assert FD.smem_bytes(FD.SMEM_MAX // 8) == FD.SMEM_MAX
    for bad in (0, FD.SMEM_MAX // 8 + 1):
        with pytest.raises(ValueError, match="chunk"):
            FD.smem_bytes(bad)


def test_frontier_dedup_limits_match_the_library_export():
    """The wrapper's tiles and limits are those frontier_dedup_limits
    exports, one value each in the source; the card's shared memory is one
    constant for every wrapper."""
    src = (build.CSRC / "frontier_dedup.cu").read_text()
    assert re.search(r"SMEM_MAX = (\d+);", src).group(1) == str(build.SMEM_MAX)
    assert FD.SMEM_MAX == EE.SMEM_MAX == build.SMEM_MAX
    assert "PAIR_BYTES = 2 * sizeof(int)" in src and FD.PAIR_BYTES == 8

    class Lib:
        def __init__(self, vals):
            self.vals = vals

        def frontier_dedup_limits(self, *refs):
            for r, x in zip(refs, self.vals):
                r._obj.value = x
            return 0

    FD._check_limits(Lib((*FD.SMALL_TILE, *FD.LARGE_TILE, FD.PAIR_BYTES, FD.SMEM_MAX)))
    with pytest.raises(RuntimeError, match="kernel shapes"):
        FD._check_limits(Lib((*FD.SMALL_TILE, 256, 16, FD.PAIR_BYTES, FD.SMEM_MAX)))


@pytest.mark.parametrize("buf", [0, 4, 512, 1000, 1 << 40])
@pytest.mark.parametrize("hi_off,lo_off", [(0, 0), (1, 1), (2, 2), (3, 3), (1, 3), (2, 0)])
def test_frontier_dedup_mask_lies_on_the_tile_phase(hi_off, lo_off, buf):
    """The mask starts on the kernel's tile phase: the columns' 16-byte
    phase (in elements) when they share one, else 0; modulo 16, so every
    thread's 4, 8 or 16 mask bytes are one aligned store."""
    hi_ptr, lo_ptr = 4096 + 4 * hi_off, 8192 + 4 * lo_off
    off = FD.mask_offset(hi_ptr, lo_ptr, buf)
    assert 0 <= off < 16
    shift = hi_off if hi_off == lo_off else 0
    assert (buf + off) % 16 == shift


def test_frontier_dedup_sizes_count_launches_only():
    """The size counters move with launches: a CPU call runs the plain
    version and counts nothing."""
    FD.reset_sizes()
    launches = FD.launches
    ch, cl, vh, vl = _dedup_edge("c=7, visited")
    FD.frontier_dedup(T(ch), T(cl), T(vh), T(vl))
    assert FD.sizes() == {"candidates": 0, "max_candidates": 0, "max_visited": 0}
    assert FD.launches == launches


def test_build_hashes_the_headers(tmp_path, monkeypatch):
    """Every header a source includes is one the digest hashes, and an edit
    to a header changes the digest (the library is named by it)."""
    for src in build.sources():
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert build.CSRC / inc in build.headers()

    class _Version:
        stdout = "nvcc fake"

    monkeypatch.setattr(build.subprocess, "run", lambda *a, **k: _Version())
    head = tmp_path / "x.cuh"
    head.write_text("one")
    monkeypatch.setattr(build, "headers", lambda: [head])
    first = build._digest(build.sources(), "nvcc")
    head.write_text("two")
    assert build._digest(build.sources(), "nvcc") != first
