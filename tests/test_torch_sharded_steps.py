"""The port's steps over ranks (``launch/steps.py`` on a ``DeviceMesh``)
against the reference's sharded steps and the port's own one-rank steps.

Both sides run once for the module, side by side: four gloo ranks of the
port (four processes over a ``file://`` rendezvous, no network) and one
process of the reference a mesh on four XLA CPU devices, whose mesh has Auto
axes (with the default Explicit axes its ``with_sharding_constraint``
asserts, as ``tests/test_arch_smoke.py::test_reduced_train_step`` shows).
Each computes every case on a (2, 2) and on a (1, 4) ("data", "model")
mesh: the (1, 4) mesh splits the reduced qwen3's two kv heads mid-head.
The port's rank 0 also runs each case on one rank, and counts the FLOPs
and collectives of one step for the dry run's check.

Every case starts from the same seeded numpy parameters on both sides
(each leaf from its tree path, through the packages' shared leaf names)
and the same inputs. Tolerances:
  float32 models (GNN, DCN): the loss to 1e-6 relative; the gradients, as
    the first AdamW moment (0.1 x the clipped gradient), within 1e-5 of
    each leaf's largest; retrieval scores to 1e-5 relative;
  LMs (bfloat16 compute): the tolerances of ``tests/test_torch_train_steps.py``
    (loss within 2e-3, ``grad_norm`` to 1e-2, each new parameter within
    2 lr, at most 3% (dense) or 15% (MoE) of them further than 1e-3 lr),
    but for the MoE loss, within 5e-3: the reference's own MoE loss moves
    1.9e-3 between its (2, 2) and (1, 4) meshes (a routing tie in bfloat16),
    and the port's (2, 2) loss lies 2.7e-3 from it and 1.6e-4 from the
    port's one-rank loss; logits within 1/32, the compiled reference's
    tolerance of ``tests/test_torch_lm.py``, and cache keys and values
    within 1/16 plus two bfloat16 ulps (2^-6 relative): the port's one-rank
    cache already lies 1/32 and 2.5 ulps from the reference's, and a key
    near zero after the qk-norm moves 0.038 when its projection is split
    over ranks (the matmul adds in another order); positions equal.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 4
MESHES = ((2, 2), (1, 4))
LM_ATOL = 1 / 32
CACHE_ATOL, CACHE_RTOL = 1 / 16, 2 ** -6  # two bfloat16 ulps
FAR_SHARE = {"dense": 0.03, "moe": 0.15}
LOSS_TOL = {"dense": 2e-3, "moe": 5e-3}

# the cases and their inputs, as code both sides run
_CASES = textwrap.dedent(
    """
    import dataclasses, zlib
    import numpy as np

    CASES = [
        dict(key="lm_train", arch="qwen3-8b", shape="train_4k",
             over=dict(global_batch=4, seq_len=32, zero_params=True, zero_opt=True)),
        dict(key="lm_prefill", arch="qwen3-8b", shape="prefill_32k",
             over=dict(global_batch=4, seq_len=32)),
        dict(key="lm_decode", arch="qwen3-8b", shape="decode_32k",
             over=dict(global_batch=4, seq_len=32)),
        dict(key="lm_long", arch="qwen3-8b", shape="long_500k",
             over=dict(global_batch=1, seq_len=64, window=16)),
        dict(key="lm_train_sp", arch="qwen3-8b", shape="train_4k",
             over=dict(global_batch=4, seq_len=32, seq_parallel=True, microbatches=2)),
        dict(key="moe_train", arch="qwen3-moe-30b-a3b", shape="train_4k",
             over=dict(global_batch=4, seq_len=32, moe_impl="ep_psum")),
        dict(key="moe_scatter", arch="qwen3-moe-30b-a3b", shape="train_4k",
             over=dict(global_batch=4, seq_len=32)),
        dict(key="dimenet_part", arch="dimenet", shape="molecule",
             over=dict(batch=8, gnn_impl="partitioned")),
        dict(key="dimenet", arch="dimenet", shape="molecule", over=dict(batch=8)),
        dict(key="sage", arch="graphsage-reddit", shape="full_graph_sm",
             over=dict(n_nodes=500, n_edges=2000, d_feat=24, n_classes=6)),
        dict(key="gat", arch="gat-cora", shape="full_graph_sm",
             over=dict(n_nodes=500, n_edges=2000, d_feat=24, n_classes=6)),
        dict(key="dcn_train", arch="dcn-v2", shape="train_batch", over=dict(batch=64)),
        dict(key="dcn_retrieval", arch="dcn-v2", shape="retrieval_cand",
             over=dict(n_candidates=1024)),
    ]
    OPT = dict(warmup_steps=2, total_steps=10)
    W = 4  # ranks in both meshes

    def arch_of(get_config, case):
        arch = get_config(case["arch"])
        red = arch.reduced_model
        if case["arch"] == "qwen3-moe-30b-a3b":  # no capacity drops
            red = dataclasses.replace(red, moe=dataclasses.replace(red.moe, capacity_factor=8.0))
        if case["arch"] == "dcn-v2":  # tables of 20,480 rows: split over mp
            red = dataclasses.replace(red, max_table_rows=20000)
        shapes = {case["shape"]: {**arch.shapes[case["shape"]], **case["over"]}}
        return dataclasses.replace(arch, reduced_model=red, shapes=shapes)

    def leaf(name, shape, dtype="float32"):
        rng = np.random.RandomState(zlib.crc32(name.encode()))
        if name.endswith("scale"):
            return np.ones(shape, np.float32)
        if len(shape) < 2:
            return np.zeros(shape, np.float32) if dtype == "float32" else np.zeros(shape, dtype)
        return (rng.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

    def graph(n, e, t, d_feat, n_classes, local_triplets, seed=3):
        rng = np.random.RandomState(seed)
        g = dict(x=rng.randn(n, d_feat).astype(np.float32),
                 edge_src=rng.randint(0, n, e).astype(np.int32),
                 edge_dst=rng.randint(0, n, e).astype(np.int32),
                 labels=rng.randint(0, n_classes, n).astype(np.int32),
                 label_mask=(rng.rand(n) < 0.8).astype(np.float32))
        pad = rng.rand(e) < 0.05
        g["edge_src"][pad] = -1
        g["edge_dst"][pad] = -1
        if t:
            hi = e // W if local_triplets else e  # a block's triplets index its edges
            g["trip_kj"] = rng.randint(0, hi, t).astype(np.int32)
            g["trip_ji"] = rng.randint(0, hi, t).astype(np.int32)
            g["trip_kj"][rng.rand(t) < 0.05] = -1
            g["pos"] = rng.randn(n, 3).astype(np.float32)
        return g

    def inputs(case, arch, gshape=None):
        from repro.pipeline.data import recsys_batch, token_batch
        sh = arch.shapes[case["shape"]]
        red = arch.reduced_model
        if arch.kind == "lm":
            b, s = sh["global_batch"], sh["seq_len"]
            if sh["step"] in ("train", "prefill"):
                d = token_batch(0, 0, b, s, red.vocab)
                return (d["tokens"], d["labels"]) if sh["step"] == "train" else (d["tokens"],)
            rng = np.random.RandomState(5)
            cache_len = min(s, sh.get("window") or s)
            shape = (red.n_layers, b, cache_len, red.n_kv_heads, red.head_dim)
            k, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
            pos = np.full((red.n_layers, b, cache_len), -1, np.int32)
            if sh.get("window"):
                now = 40
                for p in range(now - cache_len, now):
                    pos[:, :, p % cache_len] = p
                at = np.full((b, 1), now, np.int32)
            else:
                fill = rng.randint(3, cache_len - 1, b)
                for i, f in enumerate(fill):
                    pos[:, i, :f] = np.arange(f)
                at = fill[:, None].astype(np.int32)
            tok = rng.randint(0, red.vocab, (b, 1)).astype(np.int32)
            return (dict(k=k, v=v, pos=pos), tok, at)
        if arch.kind == "gnn":
            return (graph(gshape.n_nodes, gshape.n_edges, gshape.n_triplets, gshape.d_feat,
                          gshape.n_classes, sh.get("gnn_impl") == "partitioned"),)
        rows = [red.table_rows(i) for i in range(red.n_sparse)]
        if sh["step"] == "recsys_train":
            d = recsys_batch(0, 0, sh["batch"], red.n_dense, red.n_sparse, rows)
            return (d["dense"], d["sparse"], d["labels"])
        d = recsys_batch(0, 1, 1, red.n_dense, red.n_sparse, rows)
        nc = -(-sh["n_candidates"] // 512) * 512
        cands = np.random.RandomState(7).randn(nc, red.mlp_dims[-1]).astype(np.float32)
        return (d["dense"], d["sparse"], cands)
    """
)

_PORT_RANK = _CASES + textwrap.dedent(
    """
    import sys, time
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, _gnn_graph_shape
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import flatten_with_paths, leaves, tree_map, unflatten

    torch.set_num_threads(1)
    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)

    def to_t(a):
        return torch.from_numpy(np.array(a))

    def global_args(case, arch, bundle):
        red = arch.reduced_model
        params = unflatten(bundle.abstract_args[0], [
            to_t(leaf("/".join(p), tuple(x.shape))).to(x.dtype)
            for p, x in flatten_with_paths(bundle.abstract_args[0])])
        gshape = _gnn_graph_shape(arch, case["shape"], red) if arch.kind == "gnn" else None
        ins = inputs(case, arch, gshape)
        ins = tree_map(to_t, ins)
        if arch.kind == "lm" and arch.shapes[case["shape"]]["step"] == "decode":
            ins[0]["k"] = ins[0]["k"].to(torch.bfloat16)
            ins[0]["v"] = ins[0]["v"].to(torch.bfloat16)
        opt = (init_opt_state(params),) if len(bundle.abstract_args) > len(ins) + 1 else ()
        return (params,) + opt + tuple(ins)

    def named(prefix, tree):
        return {prefix + "/".join(p): x.detach().float().numpy() if x.dtype == torch.bfloat16
                else x.detach().numpy() for p, x in flatten_with_paths(tree)}

    def results(bundle, outs):
        if bundle.out_shardings is None:
            return outs
        specs = bundle.out_shardings
        if isinstance(outs, tuple):
            return tuple(o if s is None else SH.gather_tree(o, s, bundle.axes)
                         for o, s in zip(outs, specs))
        return SH.gather_tree(outs, specs, bundle.axes)

    res, counts, times = {}, {}, {}
    for shape in (tuple(m) for m in %r):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        tag = "x".join(map(str, shape))
        for case in CASES:
            arch = arch_of(get_config, case)
            t0 = time.time()
            bundle = build_step(arch, case["shape"], mesh, OptimizerConfig(**OPT), use_reduced=True)
            args = global_args(case, arch, bundle)
            local = tuple(SH.shard_tree(a, s, bundle.axes) for a, s in zip(args, bundle.in_shardings))
            bundle.axes.tally.reset()
            with FlopCounterMode(display=False) as fc:
                outs = bundle.fn(*local)
            counts[f"{tag}/{case['key']}"] = dict(flops=fc.get_total_flops(),
                                                  collectives=bundle.axes.tally.record())
            res.update(named(f"{tag}/{case['key']}/", results(bundle, outs)))
            if case["key"] == "dcn_train" and shape == (2, 2):
                # a checkpoint of the split state, restored on every rank
                params, opt = outs[0], outs[1]
                ck = CheckpointManager(out + ".ckpt", async_save=False)
                specs = (bundle.out_shardings[0], bundle.out_shardings[1])
                ck.save(1, (params, opt), shardings=(bundle.axes, specs))
                dist.barrier()
                back, _ = ck.restore(1, (params, opt), shardings=(bundle.axes, specs))
                same = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves((params, opt))))
                res["ckpt/restored_equal_%%d" %% rank] = np.array(same)
                # the Trainer over the split state: 3 steps straight, and 2
                # then a resume to 3 from the checkpoint
                def train(total, d):
                    def step(state, batch):
                        p, o, m = bundle.fn(*state, *batch)
                        return (p, o), m

                    tr = Trainer(TrainerConfig(total_steps=total, ckpt_every=1, ckpt_dir=d,
                                               log_every=100),
                                 step, lambda: (local[0], local[1]), lambda i: local[2:],
                                 state_shardings=(bundle.axes, specs))
                    tr.run()
                    dist.barrier()
                    return tr.state
                straight = train(3, out + ".straight")
                train(2, out + ".resumed")
                resumed = train(3, out + ".resumed")
                res["ckpt/trainer_resumed_equal_%%d" %% rank] = np.array(all(
                    torch.equal(a, b) for a, b in zip(leaves(straight), leaves(resumed))))
            times[f"{tag}/{case['key']}"] = time.time() - t0
    if rank == 0:
        for case in CASES:  # one rank, the whole tensors
            arch = arch_of(get_config, case)
            bundle = build_step(arch, case["shape"], None, OptimizerConfig(**OPT), use_reduced=True)
            args = global_args(case, arch, bundle)
            if case["key"] == "dimenet_part":
                # one block of every edge: the blocks' triplets indexed globally
                g = args[-1]
                t, e = g["trip_kj"].shape[0], g["edge_src"].shape[0]
                off = (torch.arange(t) // (t // W) * (e // W)).to(torch.int32)
                for k in ("trip_kj", "trip_ji"):
                    g[k] = torch.where(g[k] >= 0, g[k] + off, g[k])
            res.update(named(f"1/{case['key']}/", bundle.fn(*args)))
        np.savez(out, **res)
        with open(out + ".json", "w") as f:
            json.dump(dict(counts=counts, times=times), f)
    else:
        res = {k: v for k, v in res.items() if k.startswith("ckpt/")}
        np.savez(out + "_%%d" %% rank, **res)
    dist.destroy_process_group()
    """ % (MESHES,)
).replace("import sys, time", "import json, sys, time")

_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    """
) + _CASES + textwrap.dedent(
    """
    import sys, time
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import compat
    from repro.configs import get_config
    from repro.launch.steps import build_step, _gnn_graph_shape
    from repro.train.optimizer import OptimizerConfig, init_opt_state

    assert len(jax.devices()) == 4

    def path_name(path):
        return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)

    def named(prefix, tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {prefix + path_name(p): np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
                else np.asarray(x) for p, x in flat}

    res, times = {}, {}
    for shape in [tuple(MESHES[int(sys.argv[2])])]:
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        tag = "x".join(map(str, shape))
        for case in CASES:
            t0 = time.time()
            arch = arch_of(get_config, case)
            b = build_step(arch, case["shape"], mesh, OptimizerConfig(**OPT), use_reduced=True)
            flat, tdef = jax.tree_util.tree_flatten_with_path(b.abstract_args[0])
            params = jax.tree_util.tree_unflatten(
                tdef, [jnp.asarray(leaf(path_name(p), tuple(x.shape))) for p, x in flat])
            gshape = (_gnn_graph_shape(arch, case["shape"], arch.reduced_model)
                      if arch.kind == "gnn" else None)
            ins = inputs(case, arch, gshape)
            if arch.kind == "lm" and arch.shapes[case["shape"]]["step"] == "decode":
                ins = ({"k": jnp.asarray(ins[0]["k"], jnp.bfloat16),
                        "v": jnp.asarray(ins[0]["v"], jnp.bfloat16),
                        "pos": ins[0]["pos"]},) + ins[1:]
            opt = (init_opt_state(params),) if len(b.abstract_args) > len(ins) + 1 else ()
            args = jax.device_put((params,) + opt + tuple(ins), b.in_shardings)
            with compat.set_mesh(mesh):
                out = jax.jit(b.fn, in_shardings=b.in_shardings,
                              out_shardings=b.out_shardings)(*args)
            res.update(named(f"{tag}/{case['key']}/", out))
            times[f"{tag}/{case['key']}"] = time.time() - t0
    np.savez(sys.argv[1], **res)
    with open(sys.argv[1] + ".json", "w") as f:
        json.dump(times, f)
    """
).replace("import sys, time", "import json, sys, time\nMESHES = %r" % (MESHES,))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, reference, port counts and times): the four port ranks and
    the reference process run side by side."""
    tmp = tmp_path_factory.mktemp("sharded")
    (tmp / "rank.py").write_text(_PORT_RANK)
    (tmp / "reference.py").write_text(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "reference.py"), str(tmp / f"ref{i}.npz"),
                               str(i)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(len(MESHES))]
    procs += [subprocess.Popen([sys.executable, str(tmp / "rank.py"), str(r), str(N_RANKS),
                                f"file://{tmp / 'rendezvous'}", str(tmp / "port")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for r in range(N_RANKS)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=400)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    port = dict(np.load(tmp / "port.npz"))
    for r in range(1, N_RANKS):
        port.update(dict(np.load(tmp / f"port_{r}.npz")))
    meta = json.loads((tmp / "port.json").read_text())
    ref = {}
    for i in range(len(MESHES)):
        ref.update(dict(np.load(tmp / f"ref{i}.npz")))
    return port, ref, meta, tmp


def _tree(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _against(runs, mesh, case):
    """(the port's results on ``mesh``, [(what, the reference's), (what,
    the port's one-rank results)])."""
    port, ref, _, _ = runs
    got = _tree(port, f"{mesh}/{case}/")
    wants = [("reference", _tree(ref, f"{mesh}/{case}/")), ("one rank", _tree(port, f"1/{case}/"))]
    for what, want in wants:
        assert got and got.keys() == want.keys(), (what, sorted(set(got) ^ set(want))[:5])
    return got, wants


MESH_IDS = ["x".join(map(str, m)) for m in MESHES]


@pytest.mark.parametrize("mesh", MESH_IDS)
@pytest.mark.parametrize("case", ["dimenet_part", "dimenet", "sage", "gat", "dcn_train"])
def test_float32_train_steps_match(runs, mesh, case):
    """Loss to 1e-6 relative, gradients (the first moments) within 1e-5 of
    each leaf's largest, ``grad_norm`` to 1e-5 and ``lr`` equal."""
    got, wants = _against(runs, mesh, case)
    for what, want in wants:
        np.testing.assert_allclose(got["2/loss"], want["2/loss"], rtol=1e-6, err_msg=what)
        np.testing.assert_allclose(got["2/grad_norm"], want["2/grad_norm"], rtol=1e-5,
                                   err_msg=what)
        assert got["2/lr"] == want["2/lr"]
        mus = [k for k in want if k.startswith("1/mu/")]
        assert mus
        for k in mus:
            bound = 1e-5 * max(float(np.abs(want[k]).max()), 1e-30)
            assert float(np.abs(got[k] - want[k]).max()) <= bound, (what, k)


@pytest.mark.parametrize("mesh", MESH_IDS)
@pytest.mark.parametrize("case", ["lm_train", "lm_train_sp", "moe_train", "moe_scatter"])
def test_lm_train_steps_match(runs, mesh, case):
    """qwen3-8b under ZeRO-1 and ZeRO-3, and with its activations split over
    the sequence (``seq_parallel``) in two microbatches; qwen3-moe with its
    experts over mp, dispatching by ``ep_psum`` and by the capacity scatter
    (slots across the data-parallel ranks): the bfloat16 tolerances of
    ``tests/test_torch_train_steps.py``."""
    got, wants = _against(runs, mesh, case)
    kind = "moe" if case.startswith("moe") else "dense"
    for what, want in wants:
        assert abs(float(got["2/loss"]) - float(want["2/loss"])) <= LOSS_TOL[kind], what
        np.testing.assert_allclose(got["2/grad_norm"], want["2/grad_norm"], rtol=1e-2,
                                   err_msg=what)
        lr = float(want["2/lr"])
        assert float(got["2/lr"]) == lr and int(got["1/step"]) == 1
        far = total = 0
        for k in (k for k in want if k.startswith("0/")):
            d = np.abs(got[k] - want[k])
            assert d.max() <= 2 * lr * (1 + 1e-3), (what, k)
            far += int((d > 1e-3 * lr).sum())
            total += d.size
        assert far <= FAR_SHARE[kind] * total, (what, far, total)


@pytest.mark.parametrize("mesh", MESH_IDS)
@pytest.mark.parametrize("case", ["lm_prefill", "lm_decode", "lm_long"])
def test_serving_steps_match(runs, mesh, case):
    """Prefill into the sequence-split cache, decode against it (the
    owner's write, the log-sum-exp combine), the batch-1 sliding window:
    logits and cache within 1/32, cache positions equal."""
    got, wants = _against(runs, mesh, case)
    for what, want in wants:
        for k in want:
            if k.endswith("pos"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=what)
            else:
                np.testing.assert_allclose(got[k], want[k],
                                           atol=LM_ATOL if k == "0" else CACHE_ATOL,
                                           rtol=0 if k == "0" else CACHE_RTOL,
                                           err_msg=f"{what} {k}")


@pytest.mark.parametrize("mesh", MESH_IDS)
def test_retrieval_matches(runs, mesh):
    """Candidates split over every axis: each rank's best 100, gathered,
    the best 100 of those."""
    got, wants = _against(runs, mesh, "dcn_retrieval")
    for what, want in wants:
        assert got[""].shape == (1, 100)
        np.testing.assert_allclose(got[""], want[""], rtol=1e-5, atol=1e-6, err_msg=what)


def test_trainer_resumes_a_split_state(runs):
    """dcn-v2 on the (2, 2) mesh through the ``Trainer`` with its
    ``state_shardings``: two steps, a checkpoint of the full arrays, a
    resume to the third step, bit-equal on every rank to three steps run
    straight."""
    port = runs[0]
    assert all(bool(port[f"ckpt/trainer_resumed_equal_{r}"]) for r in range(N_RANKS))


def test_checkpoint_of_a_split_state_restores_on_one_rank(runs):
    """dcn-v2's state after its step on the (2, 2) mesh: every rank gets
    its own shards back, and one rank restores the whole arrays."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_step
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import flatten_with_paths, tree_map

    port, _, _, tmp = runs
    assert all(bool(port[f"ckpt/restored_equal_{r}"]) for r in range(N_RANKS))
    arch = get_config("dcn-v2")
    red = arch.reduced_model.__class__(max_table_rows=20000, mlp_dims=(64, 64, 32))
    import dataclasses

    arch = dataclasses.replace(arch, reduced_model=red,
                               shapes={"train_batch": {**arch.shapes["train_batch"], "batch": 64}})
    abstract = build_step(arch, "train_batch", None, use_reduced=True).abstract_args[:2]
    like = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype), abstract)
    state, manifest = CheckpointManager(str(tmp / "port.ckpt")).restore(1, like)
    assert manifest["step"] == 1
    for path, x in flatten_with_paths(state):
        np.testing.assert_array_equal(x.numpy(), port["2x2/dcn_train/" + "/".join(path)])


@pytest.mark.parametrize("case", ["lm_train", "lm_decode", "sage"])
def test_dry_run_counts_what_a_gloo_rank_counts(runs, tmp_path, case):
    """The dry run of a reduced cell on a fake (2, 2) group counts the FLOPs
    and collectives that rank 0 of the gloo run counted for the same step."""
    from repro_torch.launch import dryrun

    _, _, meta, _ = runs
    arch = {"lm_train": "qwen3-8b", "lm_decode": "qwen3-8b", "sage": "graphsage-reddit"}[case]
    shape = {"lm_train": "train_4k", "lm_decode": "decode_32k", "sage": "full_graph_sm"}[case]
    over = {"lm_train": dict(global_batch=4, seq_len=32, zero_params=True, zero_opt=True),
            "lm_decode": dict(global_batch=4, seq_len=32),
            "sage": dict(n_nodes=500, n_edges=2000, d_feat=24, n_classes=6)}[case]
    rec = dryrun.run_cell(arch, shape, False, str(tmp_path), overrides=over, use_reduced=True,
                          mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    want = meta["counts"][f"2x2/{case}"]
    assert rec["cost"]["flops_per_device"] == want["flops"] > 0
    assert rec["collectives"] == want["collectives"]
