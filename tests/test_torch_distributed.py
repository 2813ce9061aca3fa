"""The port's distributed exchange (``repro_torch.core.distributed``) against
the reference's ``repro.core.distributed``.

Both sides run once for the module, at the same time: eight gloo ranks of
the port (eight processes over a ``file://`` rendezvous, no network), and
one process of the reference on eight placeholder XLA devices. Both take
the reference test's inputs and a skewed pair under a tight capacity
factor, on all eight and on worlds of 3 and 6 (the port's first ranks, the
reference's first devices): sizes that are not a power of two, where the
reference routes by ``h & (P - 1)`` and leaves some ranks empty. The port
also runs on groups of 1, 2 and 4 of its ranks."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as D  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 8
SUBGROUPS = (1, 2, 4)
ODD_WORLDS = (3, 6)  # not powers of two: held against the reference's meshes

# the inputs, as code both sides run: the reference test's relations
# (RandomState(1), 4,096 x 2,048 rows, keys in [0, 300), cap_factor 4.0,
# 512 groups, 16,384 output slots a device), and a skewed pair (60% of the
# keys one value, 4,093 rows: padding too) under cap_factor 1.25
_INPUTS = textwrap.dedent(
    """
    import collections, json
    import numpy as np

    def inputs():
        rng = np.random.RandomState(1)
        NL, NR = 4096, 2048
        lkeys = rng.randint(0, 300, NL).astype(np.int32)
        rkeys = rng.randint(0, 300, NR).astype(np.int32)
        lrows = np.stack([lkeys, rng.randint(0, 99, NL).astype(np.int32)])
        rrows = np.stack([rkeys, rng.randint(0, 99, NR).astype(np.int32)])
        return lrows, rrows

    def skewed():
        rng = np.random.RandomState(2)
        def rel(n):
            keys = np.where(rng.rand(n) < 0.6, 7, rng.randint(0, 300, n)).astype(np.int32)
            return np.stack([keys, rng.randint(0, 99, n).astype(np.int32)])
        return rel(4093), rel(2045)

    STANDARD = dict(cap_factor=4.0, groups=512, out_cap=16384)
    TIGHT = dict(cap_factor=1.25, groups=512, out_cap=1 << 16)
    SENT = int(np.iinfo(np.int32).max)

    def summarise(count, overflow, gkeys, gcounts, gof, keys, n, mof):
        groups = sorted((int(k), int(c)) for k, c in zip(gkeys, gcounts)
                        if k != SENT and c > 0)
        mat = collections.Counter(int(k) for k in keys if k != SENT)
        return dict(count=int(count), overflow=int(overflow), groups=groups,
                    group_overflow=int(gof), mat_n=int(n), mat_overflow=int(mof),
                    mat_keys=sorted(mat.items()))
    """
)

_PORT_RANK = _INPUTS + textwrap.dedent(
    """
    import sys
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D

    torch.set_num_threads(1)
    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    assert D.engine_group("cpu") is dist.group.WORLD

    def run(group, lrows, rrows, cap_factor, groups, out_cap):
        L, R = D.shard_relation(lrows, group), D.shard_relation(rrows, group)
        count, of = D.make_join_count(group, cap_factor)(L, R)
        gk, gc, gof = D.make_group_count(group, cap_factor, groups)(L)
        k, li, ri, n, mof = D.make_join_materialize(group, out_cap, cap_factor)(L, R)
        # li / ri index the rank's sorted relations: -1 exactly past its keys
        assert bool(((li >= 0) == (k != SENT)).all() and ((ri >= 0) == (li >= 0)).all())
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, (gk.tolist(), gc.tolist(), k.tolist()), group=group)
        return summarise(count, of, [x for p in parts for x in p[0]],
                         [x for p in parts for x in p[1]], gof,
                         [x for p in parts for x in p[2]], n, mof)

    res = {str(world): run(dist.group.WORLD, *inputs(), **STANDARD),
           "tight": run(dist.group.WORLD, *skewed(), **TIGHT)}
    for size in %r:
        sub = dist.new_group(list(range(size)))
        if rank < size:
            # the same slots in all: 16,384 a rank of eight
            res[str(size)] = run(sub, *inputs(), **dict(STANDARD, out_cap=16384 * world // size))
    for size in %r:
        sub = dist.new_group(list(range(size)))
        if rank < size:
            res["world%%d" %% size] = run(sub, *inputs(), **STANDARD)
            res["tight%%d" %% size] = run(sub, *skewed(), **TIGHT)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
    """ % (SUBGROUPS, ODD_WORLDS)
)

_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    """
) + _INPUTS + textwrap.dedent(
    """
    import sys
    import jax
    from repro.core import distributed as D

    assert len(jax.devices()) == 8

    def run(lrows, rrows, cap_factor, groups, out_cap, mesh=D.engine_mesh()):
        L, R = D.shard_relation(mesh, lrows), D.shard_relation(mesh, rrows)
        count, of = D.make_join_count(mesh, cap_factor=cap_factor)(L, R)
        gk, gc, gof = D.make_group_count(mesh, cap_factor=cap_factor,
                                         max_groups_per_dev=groups)(L)
        k, li, ri, n, mof = D.make_join_materialize(
            mesh, out_cap_per_device=out_cap, cap_factor=cap_factor)(L, R)
        return summarise(count, of, np.asarray(gk).ravel(), np.asarray(gc).ravel(), gof,
                         np.asarray(k).ravel(), n, mof)

    res = {"8": run(*inputs(), **STANDARD), "tight": run(*skewed(), **TIGHT)}
    for size in %r:
        mesh = D.engine_mesh(jax.devices()[:size])
        res["world%%d" %% size] = run(*inputs(), **STANDARD, mesh=mesh)
        res["tight%%d" %% size] = run(*skewed(), **TIGHT, mesh=mesh)
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)
    """ % (ODD_WORLDS,)
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, reference) results: the eight port ranks and the reference
    process run side by side."""
    tmp = tmp_path_factory.mktemp("exchange")
    (tmp / "rank.py").write_text(_PORT_RANK)
    (tmp / "reference.py").write_text(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "reference.py"), str(tmp / "ref.json")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, str(tmp / "rank.py"), str(r), str(N_RANKS),
                                f"file://{tmp / 'rendezvous'}", str(tmp / "port.json")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for r in range(N_RANKS)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return (json.loads((tmp / "port.json").read_text()),
            json.loads((tmp / "ref.json").read_text()))


def _oracle():
    """The reference test's count and per-key matches, from Counters."""
    rng = np.random.RandomState(1)
    lkeys = rng.randint(0, 300, 4096).astype(np.int32)
    rkeys = rng.randint(0, 300, 2048).astype(np.int32)
    lc, rc = np.bincount(lkeys, minlength=300), np.bincount(rkeys, minlength=300)
    per_key = [[k, int(lc[k] * rc[k])] for k in range(300) if lc[k] * rc[k] > 0]
    groups = [[k, int(lc[k])] for k in range(300) if lc[k] > 0]
    return int((lc * rc).sum()), per_key, groups


def test_eight_ranks_match_the_reference(runs):
    port, ref = runs
    count, per_key, groups = _oracle()
    got, want = port[str(N_RANKS)], ref["8"]
    assert got == want
    assert got["count"] == got["mat_n"] == count
    assert got["overflow"] == got["mat_overflow"] == got["group_overflow"] == 0
    assert got["mat_keys"] == per_key
    assert got["groups"] == groups


def test_overflow_counts_match_the_reference(runs):
    """Under overflow the reference's scatter is undefined (clamped rows
    overwrite slot cap - 1), so only the exchange's overflow counts, which
    include the routed padding rows, are compared."""
    port, ref = runs
    got, want = port["tight"], ref["tight"]
    assert got["overflow"] > 0 and got["group_overflow"] > 0
    assert (got["overflow"], got["group_overflow"]) == (want["overflow"], want["group_overflow"])


@pytest.mark.parametrize("size", SUBGROUPS)
def test_group_sizes_give_the_same_answers(runs, size):
    port, _ = runs
    assert port[str(size)] == port[str(N_RANKS)]


@pytest.mark.parametrize("size", ODD_WORLDS)
def test_odd_worlds_match_the_reference(runs, size):
    """A world of 3 or 6 ranks: count, groups, the materialisation and every
    overflow equal the reference's on as many devices, and the count and
    groups the Counters' (the inputs' keys are all in range)."""
    port, ref = runs
    count, per_key, groups = _oracle()
    got, want = port[f"world{size}"], ref[f"world{size}"]
    assert got == want
    assert got["count"] == count and got["groups"] == groups
    assert got["overflow"] == got["group_overflow"] == 0


@pytest.mark.parametrize("size", ODD_WORLDS)
def test_odd_worlds_overflow_counts_match_the_reference(runs, size):
    """The skewed pair under the tight capacity factor on 3 and 6 ranks:
    the exchange's overflow counts (padding rows routed like the
    reference's) equal the reference's."""
    port, ref = runs
    got, want = port[f"tight{size}"], ref[f"tight{size}"]
    assert got["overflow"] > 0 and got["group_overflow"] > 0
    assert (got["overflow"], got["group_overflow"]) == (want["overflow"], want["group_overflow"])


def _bucket_oracle(rows, keys, n_parts, cap):
    h = ((keys.astype(np.uint64) * 0x9E3779B1) & 0xFFFFFFFF) >> 16
    pid = (h & (n_parts - 1)).astype(np.int64)
    buf_rows = np.full((rows.shape[0], n_parts, cap), D.SENTINEL, dtype=np.int32)
    buf_keys = np.full((n_parts, cap), D.SENTINEL, dtype=np.int32)
    overflow = 0
    for p in range(n_parts):
        idx = np.flatnonzero(pid == p)
        overflow += max(0, len(idx) - cap)
        idx = idx[:cap]
        buf_rows[:, p, : len(idx)] = rows[:, idx]
        buf_keys[p, : len(idx)] = keys[idx]
    return buf_rows, buf_keys, overflow


@pytest.mark.parametrize("n_parts,cap_factor,skew,overflows", [
    (8, 4.0, 0.0, False), (8, 0.9, 0.0, True), (8, 2.0, 0.3, True), (1, 1.0, 0.3, False),
    (64, 1.5, 0.3, True), (3, 4.0, 0.0, False), (3, 1.0, 0.3, True), (6, 2.0, 0.0, False),
    (6, 1.5, 0.3, True), (12, 2.0, 0.3, True)])
def test_bucket_matches_numpy(n_parts, cap_factor, skew, overflows):
    """Buckets, positions and overflow against a loop over the buckets;
    ``skew`` of the keys are one value, and the first seven are padding."""
    rng = np.random.RandomState(3)
    n = 5000
    keys = np.where(rng.rand(n) < skew, 11, rng.randint(-5, 2**31 - 1, n)).astype(np.int32)
    keys[:7] = D.SENTINEL
    rows = np.stack([keys, rng.randint(0, 99, n).astype(np.int32),
                     np.arange(n, dtype=np.int32)])
    cap = D.bucket_cap(n, cap_factor, n_parts)
    buf_rows, buf_keys, overflow = D._bucket(torch.from_numpy(rows), torch.from_numpy(keys),
                                             n_parts, cap)
    want_rows, want_keys, want_of = _bucket_oracle(rows, keys, n_parts, cap)
    np.testing.assert_array_equal(buf_rows.numpy(), want_rows)
    np.testing.assert_array_equal(buf_keys.numpy(), want_keys)
    assert int(overflow) == want_of
    assert (want_of > 0) == overflows


def test_engine_group_on_the_cpu_is_one_gloo_rank():
    import torch.distributed as dist

    group = D.engine_group("cpu")
    try:
        assert dist.get_backend(group) == "gloo" and dist.get_world_size(group) == 1
        assert D.group_device(group) == torch.device("cpu")
        rows = np.array([[3, 1, 3, 2], [0, 1, 2, 3]], dtype=np.int32)
        shard = D.shard_relation(rows, group)
        assert shard.tolist() == rows.tolist()
        count, of = D.make_join_count(group)(shard, shard)
        assert (int(count), int(of)) == (6, 0)
    finally:
        dist.destroy_process_group()
