"""The port's GNN models (``repro_torch.models.gnn``) against the reference's
on the CPU.

The reference draws the parameters and the graphs (``GNN.init``,
``GNN.make_graph_inputs``; the port's own draw from a ``torch.Generator``
and cannot equal them); a tenth of the edges, and for DimeNet of the
triplets, are padded with -1, as the sampler pads; the parameters come
across through ``convert.gnn_params_from_arrays``. Tolerances: logits and
loss to rtol 1e-5, each gradient leaf to rtol 1e-4 and atol 1e-6 (the
scatters add in another order) against ``jax.value_and_grad(GNN.loss)``.
DimeNet's reduced loss is about 244 and its gradients reach about 1e3, so
its absolute floors scale with each array's largest magnitude: 1e-5 of it
for the logits, 1e-4 for a gradient leaf (observed: 1.9e-6 and 1.4e-5; the
reference's own compiled and op-by-op logits differ by 1.5e-6 of it).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.steps import _gnn_graph_shape as ref_graph_shape  # noqa: E402
from repro.models.gnn import common as RC  # noqa: E402
from repro.models.gnn import models as RG  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import gnn_params_from_arrays  # noqa: E402
from repro_torch.launch.steps import _gnn_graph_shape  # noqa: E402
from repro_torch.models.gnn import common as C  # noqa: E402
from repro_torch.models.gnn import models as G  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves, value_and_grad  # noqa: E402

GNN_IDS = ("graphsage-reddit", "gat-cora", "gin-tu", "dimenet")
SMALL = {"n_nodes": 128, "n_edges": 512, "d_feat": 24, "n_classes": 6}
OUT_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _case(arch_id, seed=0):
    """(reference cfg, port cfg, reference params, port params, numpy graph)."""
    arch = ref_config(arch_id)
    arch = dataclasses.replace(arch, shapes={"full_graph_sm": {**arch.shapes["full_graph_sm"],
                                                               **SMALL}})
    rcfg = arch.reduced_model
    gshape = ref_graph_shape(arch, "full_graph_sm", rcfg)
    rp = RG.init(jax.random.PRNGKey(seed), rcfg, gshape)
    g = {k: np.array(v) for k, v in RG.make_graph_inputs(gshape, rng_seed=seed).items()}
    rng = np.random.RandomState(seed)
    pad = rng.rand(len(g["edge_src"])) < 0.1
    g["edge_src"][pad] = -1
    g["edge_dst"][pad] = -1
    if "trip_kj" in g:
        tpad = rng.rand(len(g["trip_kj"])) < 0.1
        g["trip_kj"][tpad] = -1
        g["trip_ji"][tpad] = -1
    g["label_mask"] = (rng.rand(len(g["label_mask"])) < 0.7).astype(np.float32)
    pp = gnn_params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    return rcfg, get_config(arch_id).reduced_model, rp, pp, g


def _tg(g):
    return {k: torch.from_numpy(v.copy()) for k, v in g.items()}


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_logits_loss_and_gradients_match_the_reference(arch_id):
    rcfg, cfg, rp, pp, g = _case(arch_id)
    jg = jax.tree.map(jnp.asarray, g)
    tg = _tg(g)
    scaled = arch_id == "dimenet"
    want = np.asarray(RG.apply(rp, rcfg, jg))
    np.testing.assert_allclose(G.apply(pp, cfg, tg).detach().numpy(), want, rtol=OUT_RTOL,
                               atol=OUT_RTOL * np.abs(want).max() if scaled else 1e-6)
    rl, rgr = jax.value_and_grad(RG.loss)(rp, rcfg, jg)
    pl, pgr = value_and_grad(lambda p, x: G.loss(p, cfg, x))(pp, tg)
    np.testing.assert_allclose(float(pl), float(rl), rtol=OUT_RTOL)
    ref_leaves = jax.tree_util.tree_leaves(rgr)
    assert len(leaves(pgr)) == len(ref_leaves)
    for (path, got), want in zip(flatten_with_paths(pgr), ref_leaves):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all(), path
        atol = GRAD_RTOL * np.abs(want).max() if scaled else GRAD_ATOL
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL, atol=atol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_init_has_the_references_tree(arch_id):
    """The port draws its own values into the reference's names, shapes and
    dtypes, from a seed or a generator, on the device asked for."""
    arch = get_config(arch_id)
    gshape = _gnn_graph_shape(arch, "full_graph_sm", arch.reduced_model)
    ref = RG.init(jax.random.PRNGKey(0), ref_config(arch_id).reduced_model,
                  ref_graph_shape(ref_config(arch_id), "full_graph_sm",
                                  ref_config(arch_id).reduced_model))
    a = G.init(3, arch.reduced_model, gshape, device="cpu")
    b = G.init(torch.Generator().manual_seed(3), arch.reduced_model, gshape, device="cpu")
    want = [(tuple(getattr(k, "key", str(getattr(k, "idx", k))) for k in p), x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [(p, tuple(x.shape)) for p, x in flatten_with_paths(a)] == want
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32


def test_make_graph_inputs_shapes_and_ranges():
    shape = G.GraphShape(n_nodes=64, n_edges=200, d_feat=5, n_classes=3, n_triplets=50)
    g = G.make_graph_inputs(shape, rng_seed=4, device="cpu")
    spec = RG.graph_input_specs(RG.GraphShape(64, 200, 5, 3, 50))
    assert sorted(g) == sorted(spec)
    for k, v in g.items():
        assert tuple(v.shape) == spec[k].shape and str(v.dtype).split(".")[1] == \
            str(spec[k].dtype), k
    assert 0 <= int(g["edge_src"].min()) and int(g["edge_src"].max()) < 64
    assert 0 <= int(g["trip_kj"].min()) and int(g["trip_ji"].max()) < 200
    assert int(g["labels"].max()) < 3
    again = G.make_graph_inputs(shape, rng_seed=4, device="cpu")
    assert all(torch.equal(g[k], again[k]) for k in g)


def _softmax_case(all_padded):
    rng = np.random.RandomState(2)
    n, e = 6, 14
    scores = (rng.randn(e, 2) * 3).astype(np.float32)
    dst = rng.randint(0, n - 1, e).astype(np.int32)  # node n - 1 has no incoming edge
    dst[[3, 9]] = -1
    if all_padded:
        dst[:] = -1
    return scores, dst, n


@pytest.mark.parametrize("all_padded", [False, True], ids=["isolated-node", "all-padded"])
def test_edge_softmax_is_finite_with_its_gradients(all_padded):
    """A node with no incoming edge, and a graph whose edges are all
    padding: finite weights and finite gradients in both packages, equal
    to each other; padded edges weigh 0 and a node's weights add to 1."""
    scores, dst, n = _softmax_case(all_padded)
    w = np.random.RandomState(3).randn(*scores.shape).astype(np.float32)

    def ref_obj(s):
        return jnp.sum(RC.edge_softmax(s, jnp.asarray(dst), n) * w)

    rv = np.asarray(RC.edge_softmax(jnp.asarray(scores), jnp.asarray(dst), n))
    rgrad = np.asarray(jax.grad(ref_obj)(jnp.asarray(scores)))
    st = torch.from_numpy(scores).requires_grad_(True)
    pv = C.edge_softmax(st, torch.from_numpy(dst), n)
    (pg,) = torch.autograd.grad((pv * torch.from_numpy(w)).sum(), st)
    for x in (rv, rgrad, pv.detach().numpy(), pg.numpy()):
        assert np.isfinite(x).all()
    np.testing.assert_allclose(pv.detach().numpy(), rv, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pg.numpy(), rgrad, rtol=1e-5, atol=1e-6)
    pad = dst < 0
    assert (pv.detach().numpy()[pad] == 0).all()
    sums = np.zeros((n, 2), np.float32)
    np.add.at(sums, dst[~pad], pv.detach().numpy()[~pad])
    has = np.isin(np.arange(n), dst[~pad])
    np.testing.assert_allclose(sums[has], 1.0, rtol=1e-6)


def test_scatters_match_the_reference():
    """Sum, mean and max per destination with padding and empty nodes
    (max of an empty node: 0), gather of padded sources, degree norm."""
    rng = np.random.RandomState(7)
    n = 9
    msgs = rng.randn(30, 4).astype(np.float32)
    dst = rng.randint(0, n - 2, 30).astype(np.int32)
    src = rng.randint(0, n, 30).astype(np.int32)
    dst[::7] = -1
    src[::7] = -1
    x = rng.randn(n, 4).astype(np.float32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    for fn in ("scatter_sum", "scatter_mean", "scatter_max"):
        np.testing.assert_allclose(getattr(C, fn)(t(msgs), t(dst), n).numpy(),
                                   np.asarray(getattr(RC, fn)(j(msgs), j(dst), n)),
                                   rtol=1e-6, atol=1e-7, err_msg=fn)
    assert (C.scatter_max(t(msgs), t(dst), n).numpy()[n - 2:] == 0).all()
    np.testing.assert_array_equal(C.gather_src(t(x), t(src)).numpy(),
                                  np.asarray(RC.gather_src(j(x), j(src))))
    np.testing.assert_allclose(C.degree_norm(t(src), t(dst), n).numpy(),
                               np.asarray(RC.degree_norm(j(src), j(dst), n)), rtol=1e-6)


def test_partitioned_dimenet_waits_for_5e():
    """The edge-partitioned loss (which once raised, naming 5e) on one rank:
    every edge and triplet in the one block, the node partials' sum the
    identity, the loss and every gradient the plain loss's, exactly. Over
    ranks it is held against the reference's in
    ``tests/test_torch_sharded_steps.py``."""
    from repro_torch.parallel.sharding import MeshAxes

    _, cfg, _, pp, g = _case("dimenet")
    tg = _tg(g)
    axes = MeshAxes()
    loss, grads = value_and_grad(
        lambda p: G.dimenet_loss_partitioned(p, cfg, tg, axes, axes.resolve("dp+mp")))(pp)
    want, want_grads = value_and_grad(lambda p: G.loss(p, cfg, tg))(pp)
    assert float(loss) == float(want) and np.isfinite(float(loss))
    for a, b in zip(leaves(grads), leaves(want_grads)):
        assert torch.equal(a, b)
