"""The port's layouts (``launch/steps.py``, ``parallel/sharding.py``)
against the reference's, leaf by leaf, on both production meshes.

Every cell of ``all_cells()``, plus the LM ``train_4k`` cells under each
ZeRO knob, both MoE configurations under ``moe_impl="ep_psum"`` and every
DimeNet shape under ``gnn_impl="partitioned"``, is built by both packages:
the reference on an ``AbstractMesh`` (no devices), the port on a
``DeviceMesh`` over a ``fake`` process group of 256 or 512 ranks (nothing
runs). Each argument leaf's spec equals the reference's ``PartitionSpec``
entry by entry, its dtype the reference's, and its shard shape
``NamedSharding.shard_shape``; a rank's argument bytes are the reference's
sum over the same shards, exactly. The LM cells' model FLOPs equal the
reference's ``model_flops`` exactly; at one rank, the dry run's FLOPs equal
``FlopCounterMode`` of the plain reduced step, exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import all_cells as ref_cells  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch.roofline import model_flops as ref_model_flops  # noqa: E402
from repro.launch.steps import build_step as ref_build_step  # noqa: E402

from repro_torch.configs import all_cells, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
          "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
LM_IDS = [a for a, _ in all_cells() if get_config(a).kind == "lm"]


def _variants():
    """(arch id, shape, knobs) of every cell and every knob variant."""
    out = [(a, s, {}) for a, s in all_cells()]
    for a in dict.fromkeys(LM_IDS):
        out += [(a, "train_4k", {"zero_params": True}), (a, "train_4k", {"zero_opt": True}),
                (a, "train_4k", {"zero_params": True, "zero_opt": True})]
        if get_config(a).model.moe is not None:
            out += [(a, s, {"moe_impl": "ep_psum"}) for s in get_config(a).shapes]
    out += [("dimenet", s, {"gnn_impl": "partitioned"}) for s in get_config("dimenet").shapes]
    return out


VARIANTS = _variants()


def _with(arch, shape, knobs):
    return dataclasses.replace(arch, shapes={shape: {**arch.shapes[shape], **knobs}})


def _reference(arch_id, shape, knobs, mesh_name):
    """[(spec entries, shard shape, dtype name)] of every argument leaf."""
    b = ref_build_step(_with(ref_config(arch_id), shape, knobs), shape, MESHES[mesh_name])
    shs = jax.tree.leaves(b.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    abs_ = jax.tree.leaves(b.abstract_args)
    assert len(shs) == len(abs_)
    return [(tuple(s.spec), tuple(s.shard_shape(a.shape)), str(a.dtype))
            for s, a in zip(shs, abs_)]


@pytest.fixture(scope="module")
def port_layouts():
    """{(arch, shape, knobs, mesh): ([(entries, shard shape, dtype)], the
    rank's argument bytes)}, built over fake groups of 256 and 512 ranks."""
    out = {}
    for mesh_name, world in (("single", 256), ("multi", 512)):
        with dryrun.fake_group(world):
            mesh = make_production_mesh(multi_pod=mesh_name == "multi", device="cpu")
            for arch_id, shape, knobs in VARIANTS:
                b = build_step(_with(get_config(arch_id), shape, knobs), shape, mesh)
                rows = [(tuple(s), SH.shard_shape(a.shape, s, b.axes), str(a.dtype).replace("torch.", ""))
                        for s, a in zip(leaves(b.in_shardings), leaves(b.abstract_args))]
                out[(arch_id, shape, str(sorted(knobs.items())), mesh_name)] = (
                    rows, SH.tree_bytes(b.local_args()))
    return out


def test_cells_are_the_references():
    assert all_cells() == ref_cells() and len(all_cells()) == 40


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch_id,shape,knobs", VARIANTS,
                         ids=[f"{a}-{s}-{'-'.join(k) or 'base'}" for a, s, k in VARIANTS])
def test_layouts_match_the_reference(port_layouts, arch_id, shape, knobs, mesh_name):
    got, arg_bytes = port_layouts[(arch_id, shape, str(sorted(knobs.items())), mesh_name)]
    want = _reference(arch_id, shape, knobs, mesh_name)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    want_bytes = sum(int(np.prod(s)) * np.dtype(jax.numpy.dtype(d)).itemsize for _, s, d in want)
    assert arg_bytes == want_bytes


@pytest.mark.parametrize("arch_id,shape", [(a, s) for a, s in all_cells()
                                           if get_config(a).kind == "lm"])
def test_model_flops_are_the_references(arch_id, shape):
    arch, rarch = get_config(arch_id), ref_config(arch_id)
    sh = rarch.shapes[shape]
    d = sh["global_batch"] * (sh["seq_len"] if sh["step"] in ("train", "prefill") else 1)
    want = ref_model_flops("lm", rarch.model, sh, d, sh["step"] == "train")
    assert dryrun.useful_flops(arch, shape) == want > 0


def test_model_flops_of_three_train_cells():
    """qwen3-8b 4.7616e16, qwen3-moe-30b-a3b 1.9138e16, command-r-plus-104b
    6.5312e17 for ``train_4k`` (4 significant figures)."""
    for arch_id, want in (("qwen3-8b", 4.7616e16), ("qwen3-moe-30b-a3b", 1.9138e16),
                          ("command-r-plus-104b", 6.5312e17)):
        got = dryrun.useful_flops(get_config(arch_id), "train_4k")
        assert abs(got - want) / want < 5e-5, (arch_id, got)


@pytest.mark.parametrize("arch_id,shape,over", [
    ("qwen3-8b", "train_4k", dict(global_batch=2, seq_len=16)),
    ("qwen3-moe-30b-a3b", "decode_32k", dict(global_batch=2, seq_len=16)),
    ("graphsage-reddit", "full_graph_sm", dict(n_nodes=100, n_edges=300, d_feat=8)),
    ("dcn-v2", "train_batch", dict(batch=16)),
])
def test_one_rank_dry_run_counts_the_plain_step(tmp_path, arch_id, shape, over):
    from torch.utils.flop_counter import FlopCounterMode

    rec = dryrun.run_cell(arch_id, shape, False, str(tmp_path), overrides=over, use_reduced=True,
                          mesh_shape=(1, 1))
    assert rec["status"] == "ok", rec.get("traceback")
    b = build_step(_with(get_config(arch_id), shape, over), shape, None, use_reduced=True)
    with FlopCounterMode(display=False) as fc:
        b.fn(*b.local_args())
    assert rec["cost"]["flops_per_device"] == fc.get_total_flops() > 0
    assert rec["collectives"]["total_bytes"] == 0
    assert rec["memory"]["argument_bytes"] == SH.tree_bytes(b.abstract_args)
