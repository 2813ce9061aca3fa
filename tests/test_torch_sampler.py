"""The port's neighbour samplers and data pipeline against the reference's.

The five sampler and pipeline cases of the reference's
``tests/test_pipeline_serve.py`` run on the port (on the CPU, the kernels'
plain versions), and each port result is held against the reference's on
the same seeded numpy inputs: CSR draws, BARQ draws (the merge join on the
port's store, carried across from the reference's with
``store_from_arrays``), whole blocks and pipeline batches must be equal
array for array; token and recsys batches likewise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import QuadStore as RStore  # noqa: E402
from repro.models.gnn import sampler as RS  # noqa: E402
from repro.pipeline import data as RD  # noqa: E402

from repro_torch.convert import store_from_arrays  # noqa: E402
from repro_torch.models.gnn.sampler import BARQSampler, CSRSampler, SampledBlock  # noqa: E402
from repro_torch.pipeline.data import (  # noqa: E402
    GraphPipeline,
    block_to_model_inputs,
    recsys_batch,
    token_batch,
)


def _graph(seed=0, n=60, m=400):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, m).astype(np.int32)
    dst = rng.randint(0, n, m).astype(np.int32)
    keep = src != dst
    return np.unique(np.stack([src[keep], dst[keep]]), axis=1), n


@pytest.fixture()
def small_graph():
    return _graph()


def _adj(edge_index):
    adj = {}
    for s, d in edge_index.T:
        adj.setdefault(int(s), set()).add(int(d))
    return adj


def _ref_store(edge_index, n):
    """The reference test's node-id store: term i is node i."""
    store = RStore()
    for i in range(max(n, 2)):
        store.dict.encode(i)
    pred = store.dict.encode(":edge")
    g = store.dict.encode(":default")
    quads = np.stack([edge_index[0], np.full(edge_index.shape[1], pred, np.int32),
                      edge_index[1], np.full(edge_index.shape[1], g, np.int32)], axis=1)
    store.add_encoded(quads)
    return store.build()


def _stores(edge_index, n):
    ref = _ref_store(edge_index, n)
    terms = [ref.dict.decode(i) for i in range(len(ref.dict))]
    return ref, store_from_arrays(ref.index_array("spoc"), terms, device="cpu")


def _assert_blocks_equal(got: SampledBlock, want):
    for f in ("nodes", "edge_src", "edge_dst", "seed_mask", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_csr_sampler_neighbors_valid(small_graph):
    edge_index, n = small_graph
    adj = _adj(edge_index)
    s = CSRSampler(edge_index, n, seed=0)
    seeds = np.arange(n, dtype=np.int32)
    nbrs = s.sample_neighbors(seeds, 5)
    for i in range(n):
        got = {int(x) for x in nbrs[i] if x >= 0}
        assert got <= adj.get(i, set())
        assert len(got) == min(len(adj.get(i, set())), 5) or len(got) <= 5
    np.testing.assert_array_equal(
        nbrs, RS.CSRSampler(edge_index, n, seed=0).sample_neighbors(seeds, 5))


def test_barq_sampler_matches_adjacency(small_graph):
    """The engine-backed sampler draws from exactly the CSR sampler's
    neighbour sets, and the reference's draws."""
    edge_index, n = small_graph
    adj = _adj(edge_index)
    ref, store = _stores(edge_index, n)
    s = BARQSampler(store, ":edge", seed=0, device="cpu")
    seeds = np.arange(n, dtype=np.int32)
    nbrs = s.sample_neighbors(seeds, 4)
    for i in range(n):
        got = {int(x) for x in nbrs[i] if x >= 0}
        assert got <= adj.get(i, set()), f"node {i}"
    np.testing.assert_array_equal(
        nbrs, RS.BARQSampler(ref, ":edge", seed=0).sample_neighbors(seeds, 4))


def test_block_assembly_local_indices(small_graph):
    edge_index, n = small_graph
    s = CSRSampler(edge_index, n, seed=1)
    labels = np.arange(n, dtype=np.int32) % 7
    block = s.sample_block(np.asarray([0, 1, 2, 3], np.int32), [3, 2], labels)
    n_total = len(block.nodes)
    assert block.seed_mask[:4].all()
    assert (block.edge_src >= -1).all()
    for e in (block.edge_src, block.edge_dst):
        assert e.max() < n_total
    inputs = block_to_model_inputs(block, d_feat=8)
    assert inputs["x"].shape == (n_total, 8)
    assert np.isfinite(inputs["x"]).all()
    want = RS.CSRSampler(edge_index, n, seed=1).sample_block(
        np.asarray([0, 1, 2, 3], np.int32), [3, 2], labels)
    _assert_blocks_equal(block, want)
    ref_inputs = RD.block_to_model_inputs(want, d_feat=8)
    for k in inputs:
        np.testing.assert_array_equal(inputs[k], ref_inputs[k], err_msg=k)


def test_graph_pipeline_deterministic(small_graph):
    edge_index, n = small_graph
    labels = np.zeros(n, np.int32)
    p1 = GraphPipeline(CSRSampler(edge_index, n, seed=5), labels, n, 8, [3, 2], seed=2)
    p2 = GraphPipeline(CSRSampler(edge_index, n, seed=5), labels, n, 8, [3, 2], seed=2)
    b1, b2 = p1.batch(7), p2.batch(7)
    np.testing.assert_array_equal(b1.nodes, b2.nodes)
    ref = RD.GraphPipeline(RS.CSRSampler(edge_index, n, seed=5), labels, n, 8, [3, 2], seed=2)
    _assert_blocks_equal(b1, ref.batch(7))


def test_token_and_recsys_batches_resumable():
    a = token_batch(1, 5, 4, 16, 100)
    b = token_batch(1, 5, 4, 16, 100)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = recsys_batch(1, 5, 8, 4, 3, [10, 10, 10])
    d = recsys_batch(1, 5, 8, 4, 3, [10, 10, 10])
    np.testing.assert_array_equal(c["sparse"], d["sparse"])
    assert c["labels"].shape == (8,)
    ra, rc = RD.token_batch(1, 5, 4, 16, 100), RD.recsys_batch(1, 5, 8, 4, 3, [10, 10, 10])
    for k in a:
        np.testing.assert_array_equal(a[k], ra[k], err_msg=k)
    for k in c:
        np.testing.assert_array_equal(c[k], rc[k], err_msg=k)


@pytest.mark.parametrize("graph_seed,n,m,fanouts,batch_nodes", [
    (0, 60, 400, [3, 2], 8),      # degrees mostly above the fanout: the draws decide
    (4, 300, 6000, [15, 10], 32),  # graphsage-reddit's fanouts
    (9, 50, 120, [25, 10], 16),    # degrees below the fanout: whole lists, padding
])
def test_barq_pipeline_blocks_equal_the_reference(graph_seed, n, m, fanouts, batch_nodes):
    """Three pipeline steps through BARQSampler: every block equal to the
    reference's for the same seeds, and to a CSR sampler's over the same
    edges (the same draws, neighbours in the same order)."""
    edge_index, n = _graph(graph_seed, n, m)
    ref, store = _stores(edge_index, n)
    labels = (np.arange(n) % 41).astype(np.int32)
    got = GraphPipeline(BARQSampler(store, ":edge", seed=0, device="cpu"), labels, n,
                        batch_nodes, fanouts, seed=3)
    want = RD.GraphPipeline(RS.BARQSampler(ref, ":edge", seed=0), labels, n, batch_nodes,
                            fanouts, seed=3)
    csr = GraphPipeline(CSRSampler(edge_index, n, seed=0), labels, n, batch_nodes, fanouts,
                        seed=3)
    for step in range(3):
        b = got.batch(step)
        _assert_blocks_equal(b, want.batch(step))
        _assert_blocks_equal(b, csr.batch(step))
        assert len(b.nodes) == batch_nodes * (1 + fanouts[0] + fanouts[0] * fanouts[1])


def test_merge_join_emits_objects_in_the_references_order(small_graph):
    """Within a subject, the port's merge join emits the objects in the
    reference's order (the draws index into these lists)."""
    edge_index, n = small_graph
    ref, store = _stores(edge_index, n)
    uniq = np.unique(edge_index[0]).astype(np.int32)
    ss, oo = BARQSampler(store, ":edge", seed=0, device="cpu")._edges_of(uniq)
    r = RS.BARQSampler(ref, ":edge", seed=0)
    per_seed = {}
    from repro.core.algebra import K, TriplePattern, V
    from repro.core.operators.merge_join import MergeJoin
    from repro.core.operators.scan import IndexScan
    from repro.core.operators.sort import MaterializedSource

    v_s, v_o = r.vt.var("s"), r.vt.var("o")
    join = MergeJoin(MaterializedSource((v_s,), uniq[None, :], v_s, name="Seeds"),
                     IndexScan(ref, TriplePattern(V(v_s), K(":edge"), V(v_o)),
                               want_sorted_var=v_s), v_s)
    while True:
        b = join.next_batch()
        if b is None:
            break
        cb = b.compact()
        for s_val, o_val in zip(cb.column(v_s).tolist(), cb.column(v_o).tolist()):
            per_seed.setdefault(s_val, []).append(o_val)
    got = {}
    for s_val, o_val in zip(ss.tolist(), oo.tolist()):
        got.setdefault(s_val, []).append(o_val)
    assert got == per_seed and len(got) == len(uniq)


def test_barq_sampler_refuses_a_store_on_another_device(small_graph):
    edge_index, n = small_graph
    _, store = _stores(edge_index, n)
    with pytest.raises(ValueError, match="store"):
        BARQSampler(store, ":edge", device="meta")
