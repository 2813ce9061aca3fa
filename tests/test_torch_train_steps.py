"""One train step of each of the ten architectures: the port's
``build_step(...).fn`` against the reference's, and the launcher.

Both sides take the reference test's smoke shapes
(``tests/test_arch_smoke.py``: LM batch 4 x 64 tokens, GNN graphs of 128
nodes and 512 edges, DCN batch 64), the reduced models, the reference's
parameters (carried across by ``convert``; an LM's layers stacked, as the
port trains them) and the same inputs. The reference's step runs under
``jax.jit`` outside ``compat.set_mesh``: inside it, its Explicit smoke
mesh turns ``with_sharding_constraint`` into an assertion that fails for
the LMs and DCN (``tests/test_arch_smoke.py::test_reduced_train_step``).

Tolerances. ``lr`` is equal and ``opt["step"]`` is 1. GNN and DCN
(float32): loss and ``grad_norm`` to rtol 1e-5. LMs (bfloat16 compute;
the reference's own compiled and op-by-op gradients differ by up to 1.3%
of a leaf's largest magnitude on the dense models and 13-68% on the MoE
ones, where a token near a routing tie changes experts): loss within 2e-3,
``grad_norm`` to rtol 1e-2. New parameters: AdamW's first step moves an
entry by about ``lr`` times the sign of its gradient, so an entry whose
gradient is near zero may move the other way in the other package; every
entry lies within ``2 lr`` of the reference's, and the share of entries
further than ``1e-3 lr`` from it is at most 1% (GNN, DCN; observed at most
0.04%), 3% (dense LMs; observed at most 1.3%) or 15% (MoE LMs; observed at
most 9.4%).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.launch.steps import _gnn_graph_shape as ref_graph_shape  # noqa: E402
from repro.launch.steps import build_step as ref_build_step  # noqa: E402
from repro.models.gnn import models as RG  # noqa: E402
from repro.pipeline.data import recsys_batch, token_batch  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402

from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.launch.steps import _gnn_graph_shape, _pad512, build_step  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train.tree import leaves, tree_map  # noqa: E402

SMOKE_SHAPES = {
    "lm": {"train_4k": {"global_batch": 4, "seq_len": 64}},
    "gnn": {"full_graph_sm": {"n_nodes": 128, "n_edges": 512, "d_feat": 24, "n_classes": 6}},
    "recsys": {"train_batch": {"batch": 64}},
}
OPT = dict(warmup_steps=2, total_steps=10)
FAR_SHARE = {"f32": 0.01, "dense": 0.03, "moe": 0.15}


def _smoke(get, arch_id):
    arch = get(arch_id)
    shape_name, override = next(iter(SMOKE_SHAPES[arch.kind].items()))
    return dataclasses.replace(arch, shapes={shape_name: {**arch.shapes[shape_name],
                                                          **override}}), shape_name


def _inputs(arch, shape_name):
    """(reference params, reference inputs, port params) of the smoke cell."""
    key, red = jax.random.PRNGKey(0), arch.reduced_model
    if arch.kind == "lm":
        from repro.models.transformer import init_params

        rp = init_params(red, key)
        d = token_batch(0, 0, 4, 64, red.vocab)
        pp = TF.stack_layers(CV.transformer_params_from_arrays(
            jax.tree.map(np.asarray, rp), get_config(arch.name).reduced_model, device="cpu"))
        return rp, (d["tokens"], d["labels"]), pp
    if arch.kind == "gnn":
        gshape = ref_graph_shape(arch, shape_name, red)
        rp = RG.init(key, red, gshape)
        g = {k: np.asarray(v) for k, v in RG.make_graph_inputs(gshape).items()}
        return rp, (g,), CV.gnn_params_from_arrays(jax.tree.map(np.asarray, rp), "cpu")
    from repro.models.recsys.dcn import init_params as dcn_init

    rp = dcn_init(red, key)
    d = recsys_batch(0, 0, 64, red.n_dense, red.n_sparse,
                     [red.table_rows(i) for i in range(red.n_sparse)])
    return (rp, (d["dense"], d["sparse"], d["labels"]),
            CV.dcn_params_from_arrays(jax.tree.map(np.asarray, rp), "cpu"))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_train_step_matches_the_reference(arch_id):
    rarch, shape_name = _smoke(ref_config, arch_id)
    parch, _ = _smoke(get_config, arch_id)
    rp, args, pp = _inputs(rarch, shape_name)
    rb = ref_build_step(rarch, shape_name, make_smoke_mesh(), RO.OptimizerConfig(**OPT),
                        use_reduced=True)
    r_new, r_opt, rm = jax.jit(rb.fn)(rp, RO.init_opt_state(rp), *args)
    pb = build_step(parch, shape_name, None, OptimizerConfig(**OPT), use_reduced=True)
    targs = tree_map(lambda a: torch.from_numpy(np.array(a)), args)
    p_new, p_opt, pm = pb.fn(pp, init_opt_state(pp), *targs)

    kind = "f32" if parch.kind != "lm" else ("moe" if parch.reduced_model.moe else "dense")
    loss, want_loss = float(pm["loss"]), float(rm["loss"])
    assert np.isfinite(loss)
    if kind == "f32":
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5)
    else:
        assert abs(loss - want_loss) <= 2e-3
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-2)
    lr = float(rm["lr"])
    assert float(pm["lr"]) == lr and int(p_opt["step"]) == 1 == int(r_opt["step"])
    ref_leaves = jax.tree_util.tree_leaves(r_new)
    assert len(leaves(p_new)) == len(ref_leaves)
    far = total = 0
    moved = False
    for got, want, old in zip(leaves(p_new), ref_leaves, leaves(pp)):
        assert got.shape == want.shape and got.dtype == old.dtype
        d = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert d.max() <= 2 * lr * (1 + 1e-3)
        far += int((d > 1e-3 * lr).sum())
        total += d.size
        moved = moved or not torch.equal(got, old)
    assert moved and far <= FAR_SHARE[kind] * total, (far, total)


def test_bundles_of_every_cell_build_and_refuse_what_5e_holds():
    """Every (arch, shape) cell builds a bundle at the full configs, and so
    do the reference's ZeRO knobs (which once raised, naming 5e) on every
    LM's ``train_4k`` and ``gnn_impl="partitioned"`` on every DimeNet shape:
    one rank's layouts are the whole tensors, ZeRO changes nothing there,
    and the partitioned loss takes the node arrays whole. Over the
    production meshes the layouts are held against the reference's in
    ``tests/test_torch_layouts.py``."""
    from repro_torch.configs import all_cells
    from repro.configs import all_cells as ref_cells
    from repro_torch.parallel.sharding import shard_shape
    from repro_torch.train.tree import leaves as tree_leaves

    assert all_cells() == ref_cells()
    for arch_id, shape in all_cells():
        b = build_step(get_config(arch_id), shape)
        assert b.description and len(b.abstract_args) == len(b.in_shardings)
        for x, sp in zip(tree_leaves(b.abstract_args), tree_leaves(b.in_shardings)):
            assert x.device.type == "meta" and shard_shape(x.shape, sp, b.axes) == x.shape
    for arch_id in ("qwen3-8b", "deepseek-7b", "command-r-plus-104b", "qwen3-moe-30b-a3b",
                    "moonshot-v1-16b-a3b"):
        lm = get_config(arch_id)
        base = build_step(lm, "train_4k")
        for knobs in ({"zero_params": True}, {"zero_opt": True},
                      {"zero_params": True, "zero_opt": True}):
            arch = dataclasses.replace(lm, shapes={"t": {**lm.shapes["train_4k"], **knobs}})
            b = build_step(arch, "t")
            assert [x.shape for x in tree_leaves(b.abstract_args)] == [
                x.shape for x in tree_leaves(base.abstract_args)]
    dn = get_config("dimenet")
    for shape in dn.shapes:
        arch = dataclasses.replace(dn, shapes={shape: {**dn.shapes[shape],
                                                       "gnn_impl": "partitioned"}})
        gspecs = build_step(arch, shape).in_shardings[2]
        for k, sp in gspecs.items():
            edge = k in ("edge_src", "edge_dst", "trip_kj", "trip_ji")
            assert tuple(sp)[:1] == ((("data", "model"),) if edge else (None,)), (k, sp)
    gs = get_config("graphsage-reddit")
    shape = _gnn_graph_shape(gs, "minibatch_lg", gs.model)
    assert (shape.n_nodes, shape.n_edges) == (169984, 168960) == (_pad512(169_984),
                                                                  _pad512(168_960))


def test_recsys_serve_and_retrieval_bundles_match_the_reference():
    rarch, pa = ref_config("dcn-v2"), get_config("dcn-v2")
    rp, (dense, sparse, _), pp = _inputs(_smoke(ref_config, "dcn-v2")[0], "train_batch")
    for shape in ("serve_p99", "retrieval_cand"):
        rarch_s = dataclasses.replace(rarch, shapes={shape: {**rarch.shapes[shape], "batch": 64}})
        pa_s = dataclasses.replace(pa, shapes={shape: {**pa.shapes[shape], "batch": 64}})
        rb = ref_build_step(rarch_s, shape, make_smoke_mesh(), use_reduced=True)
        pb = build_step(pa_s, shape, None, use_reduced=True)
        args = (dense, sparse)
        if shape == "retrieval_cand":
            args += (np.random.RandomState(0).randn(512, 32).astype(np.float32),)
        want = np.asarray(jax.jit(rb.fn)(rp, *args))
        got = pb.fn(pp, *(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_checkpoints_and_resumes(tmp_path):
    """graphsage-reddit's minibatch_lg cut to 32 seeds: 12 steps lower the
    loss and land checkpoints at 3, 6, ... (every max(12 // 4, 10) = 10 and
    the last); a second run to 16 resumes at 12."""
    over = {"batch_nodes": 32, "fanouts": (5, 3), "d_feat": 32, "n_classes": 8}
    res, trainer = LT.run("graphsage-reddit", "minibatch_lg", 12, str(tmp_path), lr=3e-2,
                          override_shape=over, device="cpu")
    losses = [m["loss"] for m in trainer.metrics_history]
    assert res["step"] == 12 and len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert trainer.ckpt.all_steps() == [10, 12]
    res2, trainer2 = LT.run("graphsage-reddit", "minibatch_lg", 16, str(tmp_path), lr=3e-2,
                            override_shape=over, device="cpu")
    assert res2["step"] == 16 and [m["step"] for m in trainer2.metrics_history] == [13, 14, 15,
                                                                                    16]


def test_launcher_main_passes_its_smoke_override(tmp_path, monkeypatch, capsys):
    """``main`` trains at the cut shape (the reference builds the cut and
    never passes it on)."""
    seen = {}
    real = LT.run

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(LT, "run", spy)
    monkeypatch.setattr("sys.argv", ["train", "--arch", "dcn-v2", "--steps", "3", "--ckpt-dir",
                                     str(tmp_path), "--device", "cpu"])
    LT.main()
    assert seen["override_shape"] == {"batch": 256}
    assert "final:" in capsys.readouterr().out
