"""The port's training substrate (``repro_torch.train``, ``parallel/compression``)
against the reference's on the CPU.

  * the reference's 14 substrate cases (``tests/test_train_substrate.py``:
    checkpoint, optimizer, trainer, compression, ``global_norm``) on the
    port's API, one parametrised test;
  * AdamW, ``lr_at`` and ``global_norm`` against the reference on the same
    numpy trees (a clipped step, a decay mask, 1-D leaves, 20 steps in a
    row) to rtol 1e-6 (absolute floor: 1e-6 of the leaf's largest value);
  * a checkpoint the reference's manager wrote (a graphsage parameter and
    AdamW tree) restored by the port's, leaf for leaf and bit-equal;
  * ``quantize_int8`` / ``compress_tree`` bit-equal to the reference's, and
    ``psum_compressed`` on 1 and 2 gloo ranks against the reference's under
    ``shard_map`` on 1 and 2 XLA CPU devices (separate processes, a
    ``file://`` rendezvous).
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
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.parallel import compression as RC  # noqa: E402
from repro.train import checkpoint as RCK  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402

from repro_torch.convert import gnn_params_from_arrays, opt_state_from_arrays  # noqa: E402
from repro_torch.parallel.compression import (  # noqa: E402
    compress_tree, decompress_tree, init_residuals, quantize_int8,
)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptimizerConfig, adamw_update, global_norm, init_opt_state, lr_at,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6  # float32 AdamW against the reference


def _np_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(8, 16).astype(np.float32),
            "nested": {"b": rng.randn(4).astype(np.float32), "step": np.int32(3)}}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _same(got, want):
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y))


# ---------------------------------------------------------------------------
# the reference's 14 cases on the port
# ---------------------------------------------------------------------------


def case_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _t(_np_tree())
    mgr.save(10, t)
    mgr.wait()
    restored, manifest = mgr.restore(None, tree_map(torch.zeros_like, t))
    assert manifest["step"] == 10
    for a, b in zip(leaves(t), leaves(restored)):
        assert torch.equal(a, b)


def case_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _t(_np_tree()))
        mgr.wait()
    assert mgr.all_steps() == [3, 4]


def case_checkpoint_crash_leaves_no_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(5, _t(_np_tree()))
    # a crash mid-write of a later step: an orphan tmp dir
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert mgr.latest_step() == 5  # tmp ignored
    mgr.save(7, _t(_np_tree()))  # gc removes the orphan
    assert not (tmp_path / "step_000000009.tmp").exists()


def case_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _t(_np_tree()))
    bad = {"a": torch.zeros(2, 2), "nested": {"b": torch.zeros(4), "step": torch.tensor(0)}}
    with pytest.raises(ValueError):
        mgr.restore(1, bad)


def case_optimizer_lr_schedule(tmp_path):
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    assert float(lr_at(cfg, 0)) == 0.0
    assert float(lr_at(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_at(cfg, 110)) == pytest.approx(0.1, rel=1e-2)


def case_optimizer_adamw_descends_quadratic(tmp_path):
    cfg = OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = init_opt_state(params)
    for _ in range(150):
        params, opt, _ = adamw_update(cfg, params, {"w": 2 * params["w"]}, opt)
    assert float(params["w"].abs().max()) < 0.1


def case_optimizer_clipping(tmp_path):
    cfg = OptimizerConfig(clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.ones(4)}
    _, _, metrics = adamw_update(cfg, params, {"w": torch.full((4,), 1e6)},
                                 init_opt_state(params))
    assert float(metrics["grad_norm"]) > 1e5  # reported pre-clip


def _trainer(tmp_path, total=20, fault_hook=None, ckpt_every=5):
    cfg = OptimizerConfig(lr=0.05, warmup_steps=1, total_steps=total)

    def init_state():
        p = {"w": torch.tensor([4.0])}
        return (p, init_opt_state(p))

    def train_step(state, batch):
        p, o = state
        loss = torch.sum((p["w"] - 1.0) ** 2) + 0.0 * batch
        p, o, m = adamw_update(cfg, p, {"w": 2 * (p["w"] - 1.0)}, o)
        return (p, o), {"loss": loss, **m}

    return Trainer(TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                                 ckpt_dir=str(tmp_path), log_every=100),
                   train_step, init_state, lambda step: torch.tensor(float(step)),
                   fault_hook=fault_hook)


def case_trainer_runs_and_checkpoints(tmp_path):
    t = _trainer(tmp_path)
    out = t.run()
    assert out["step"] == 20 and not out["preempted"]
    assert t.ckpt.latest_step() == 20


def case_trainer_resume_from_checkpoint(tmp_path):
    _trainer(tmp_path, total=10).run()
    # a new trainer continues to 20 from step 10 without redoing work
    t2 = _trainer(tmp_path, total=20)
    out = t2.run()
    assert out["step"] == 20
    assert len(t2.metrics_history) == 10  # only steps 10..20


def case_trainer_crash_retry_restores(tmp_path):
    crashes = {"n": 0}

    def fault(step):
        if step == 7 and crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("injected node failure")

    out = _trainer(tmp_path, total=12, fault_hook=fault).run()
    assert out["step"] == 12
    assert crashes["n"] == 1  # crashed once, resumed from the step-5 checkpoint


def case_trainer_crash_budget_exhausted(tmp_path):
    def fault(step):
        raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError):
        _trainer(tmp_path, total=5, fault_hook=fault).run()


def case_compression_error_feedback_reduces_bias(tmp_path):
    rng = np.random.RandomState(0)
    g_true = {"w": torch.from_numpy(rng.randn(1000).astype(np.float32))}
    res = init_residuals(g_true)
    acc, acc_ref = torch.zeros(1000), torch.zeros(1000)
    for _ in range(50):
        qs, ss, res = compress_tree(g_true, res)
        acc = acc + decompress_tree(qs, ss, g_true)["w"]
        acc_ref = acc_ref + g_true["w"]
    # accumulated compressed gradients converge to the true sum
    assert float(torch.linalg.norm(acc - acc_ref) / torch.linalg.norm(acc_ref)) < 0.01


def case_compression_single_shot_error_bounded(tmp_path):
    x = torch.linspace(-3, 3, 512)
    qs, ss, _ = compress_tree({"w": x}, init_residuals({"w": x}))
    deq = decompress_tree(qs, ss, {"w": x})
    assert float((deq["w"] - x).abs().max()) <= float(ss["w"]) * 0.51


def case_global_norm(tmp_path):
    assert float(global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])})) == \
        pytest.approx(5.0)


REFERENCE_CASES = [v for k, v in dict(globals()).items() if k.startswith("case_")]


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=lambda f: f.__name__[5:])
def test_reference_substrate_case(case, tmp_path):
    case(tmp_path)


def test_all_fourteen_reference_cases_are_ported():
    assert len(REFERENCE_CASES) == 14


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------


def _opt_trees(rng):
    params = {"dense": {"w": rng.randn(6, 5).astype(np.float32),
                        "b": rng.randn(5).astype(np.float32)},
              "layers": [{"w": rng.randn(3, 4, 2).astype(np.float32),
                          "scale": (1 + 0.1 * rng.randn(4)).astype(np.float32)}
                         for _ in range(2)],
              "emb": rng.randn(7, 3).astype(np.float32)}
    return params


def _no_decay(path):
    return path[0] != "emb" and path[-1] != "b"


@pytest.mark.parametrize("clip,mask", [(1.0, False), (1e3, False), (0.5, True)],
                         ids=["clipped", "unclipped", "clipped-decay-mask"])
def test_adamw_matches_the_reference_over_20_steps(clip, mask):
    """20 steps on the same numpy gradients (large enough that a clip of 1
    or 0.5 scales them), 1-D leaves undecayed, a decay mask over paths;
    parameters, moments and metrics to rtol 1e-6."""
    rng = np.random.RandomState(3)
    params = _opt_trees(rng)
    grads = [tree_map(lambda p: (3 * rng.randn(*p.shape)).astype(np.float32), params)
             for _ in range(20)]
    cfg = dict(lr=1e-2, warmup_steps=5, total_steps=30, clip_norm=clip, weight_decay=0.1)
    rcfg, pcfg = RO.OptimizerConfig(**cfg), OptimizerConfig(**cfg)
    seen = []

    def ref_mask(path):
        seen.append(path)
        return _no_decay(path)

    rp, rs = jax.tree.map(jnp.asarray, params), RO.init_opt_state(jax.tree.map(jnp.asarray,
                                                                                params))
    pp = _t(params)
    ps = init_opt_state(pp)
    paths = []

    def port_mask(path):
        paths.append(path)
        return _no_decay(path)

    clipped = 0
    for g in grads:
        rp, rs, rm = RO.adamw_update(rcfg, rp, jax.tree.map(jnp.asarray, g), rs,
                                     ref_mask if mask else None)
        pp, ps, pm = adamw_update(pcfg, pp, _t(g), ps, port_mask if mask else None)
        for a, b in zip(leaves(pp) + leaves(ps["mu"]) + leaves(ps["nu"]),
                        jax.tree_util.tree_leaves((rp, rs["mu"], rs["nu"]))):
            b = np.asarray(b)
            # the floor: a moment whose two terms cancel keeps their
            # rounding (the sums of squares add in another order)
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=RTOL * np.abs(b).max())
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=RTOL)
        assert int(ps["step"]) == int(rs["step"]) and ps["step"].dtype == torch.int32
        clipped += float(pm["grad_norm"]) > clip
    assert clipped == (20 if clip < 10 else 0)
    if mask:
        assert paths[: len(seen) // 20] == seen[: len(seen) // 20]
        assert ("layers", "1", "scale") in paths and ("emb",) in paths


def test_lr_schedule_and_global_norm_match_the_reference():
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1),
                dict(lr=3e-4, warmup_steps=0, total_steps=7), dict(warmup_steps=100)):
        rc, pc = RO.OptimizerConfig(**cfg), OptimizerConfig(**cfg)
        for step in (0, 1, 5, 10, 11, 60, 109, 110, 500):
            np.testing.assert_allclose(float(lr_at(pc, step)), float(RO.lr_at(rc, step)),
                                       rtol=RTOL, atol=1e-12)
    tree = _opt_trees(np.random.RandomState(4))
    np.testing.assert_allclose(float(global_norm(_t(tree))),
                               float(RO.global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=RTOL)


def test_tree_paths_are_the_references():
    tree = _opt_trees(np.random.RandomState(5))
    want = [tuple(getattr(k, "key", str(getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in flatten_with_paths(tree)] == want


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _graphsage_state():
    """The reference's graphsage-reddit reduced parameters (one step of
    AdamW taken, so the moments are not zero) as numpy trees."""
    from repro.configs import get_config as ref_config
    from repro.launch.steps import _gnn_graph_shape
    from repro.models.gnn import models as RG

    arch = ref_config("graphsage-reddit")
    gshape = _gnn_graph_shape(arch, "full_graph_sm", arch.reduced_model)
    params = RG.init(jax.random.PRNGKey(0), arch.reduced_model, gshape)
    grads = jax.tree.map(lambda p: jnp.sin(p * 3.0), params)
    params, opt, _ = RO.adamw_update(RO.OptimizerConfig(), params, grads,
                                     RO.init_opt_state(params))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


def test_reference_written_checkpoint_restores_bit_equal(tmp_path):
    params, opt = _graphsage_state()
    ref = RCK.CheckpointManager(str(tmp_path), async_save=False)
    ref.save(7, (params, opt))
    like = (gnn_params_from_arrays(params, device="cpu"), opt_state_from_arrays(opt, "cpu"))
    like = tree_map(torch.zeros_like, like)
    got, manifest = CheckpointManager(str(tmp_path)).restore(None, like)
    assert manifest["step"] == 7
    assert len(leaves(got)) == len(jax.tree_util.tree_leaves((params, opt)))
    _same(got, (params, opt))
    assert got[1]["step"].dtype == torch.int32 and int(got[1]["step"]) == 1


def test_port_written_checkpoint_restores_in_the_reference(tmp_path):
    """The other way: same file names, leaf names, shapes and dtypes."""
    params, opt = _graphsage_state()
    state = (gnn_params_from_arrays(params, device="cpu"), opt_state_from_arrays(opt, "cpu"))
    CheckpointManager(str(tmp_path), async_save=False).save(3, state)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_000000003"]
    got, manifest = RCK.CheckpointManager(str(tmp_path)).restore(
        None, jax.tree.map(np.zeros_like, (params, opt)))
    _same(state, got)
    assert manifest["keys"] == [k for k, _ in RCK._flatten((params, opt))[0]]


def test_bfloat16_leaves_round_trip(tmp_path):
    t = {"w": torch.randn(5, 3).to(torch.bfloat16), "s": torch.tensor(2, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, t)
    got, manifest = mgr.restore(1, tree_map(torch.zeros_like, t))
    assert torch.equal(got["w"], t["w"]) and got["w"].dtype == torch.bfloat16
    assert manifest["dtypes"] == {"s": "int32", "w": "bfloat16"}


def test_save_copies_before_the_writer_thread_starts(tmp_path):
    """A leaf written in place right after ``save`` returns (as the next
    step may) does not reach the checkpoint."""
    w = torch.arange(6, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w})
    w.add_(100.0)
    mgr.wait()
    got, _ = mgr.restore(1, {"w": torch.zeros(6)})
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_quantize_and_compress_tree_are_bit_equal():
    rng = np.random.RandomState(6)
    grads = {"a": (rng.randn(33, 7) * 4).astype(np.float32),
             "b": [rng.randn(129).astype(np.float32), np.zeros(5, np.float32)]}
    res = tree_map(lambda g: (0.01 * rng.randn(*g.shape)).astype(np.float32), grads)
    q, s = quantize_int8(torch.from_numpy(grads["a"]))
    rq, rs = RC.quantize_int8(jnp.asarray(grads["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    got = compress_tree(_t(grads), _t(res))
    want = RC.compress_tree(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res))
    for g, w in zip(got, want):
        _same(g, w)
    assert leaves(got[0])[0].dtype == torch.int8
    _same(decompress_tree(got[0], got[1], _t(grads)),
          RC.decompress_tree(want[0], want[1], jax.tree.map(jnp.asarray, grads)))


_PSUM_INPUTS = textwrap.dedent(
    """
    import json, sys
    import numpy as np

    def rank_tree(r):
        rng = np.random.RandomState(10 + r)
        g = {"a": (rng.randn(9, 4) * (r + 1)).astype(np.float32),
             "b": [rng.randn(17).astype(np.float32)]}
        res = {"a": (0.01 * rng.randn(9, 4)).astype(np.float32),
               "b": [(0.01 * rng.randn(17)).astype(np.float32)]}
        return g, res

    def dump(path, results):
        with open(path, "w") as f:
            json.dump(results, f)
    """
)

_PSUM_PORT = _PSUM_INPUTS + textwrap.dedent(
    """
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.compression import psum_compressed
    from repro_torch.train.tree import leaves, tree_map

    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    if world > 1:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    g, res = rank_tree(rank)
    t = lambda x: tree_map(lambda a: torch.from_numpy(a), x)
    mean, new_r = psum_compressed(t(g), t(res), dist.group.WORLD if world > 1 else None)
    dump(out % rank, {"mean": [x.tolist() for x in leaves(mean)],
                      "res": [x.tolist() for x in leaves(new_r)]})
    if world > 1:
        dist.destroy_process_group()
    """
)

_PSUM_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    """
) + _PSUM_INPUTS + textwrap.dedent(
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.parallel.compression import psum_compressed

    out = {}
    for n in (1, 2):
        mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
        trees = [rank_tree(r) for r in range(n)]
        stack = lambda i: jax.tree.map(lambda *a: jnp.stack(a), *[t[i] for t in trees])

        def local(g, r):
            g, r = jax.tree.map(lambda a: a[0], (g, r))
            m, nr = psum_compressed(g, r, "x")
            return jax.tree.map(lambda a: a[None], (m, nr))

        m, nr = shard_map(local, mesh=mesh, in_specs=(P("x"), P("x")),
                          out_specs=(P("x"), P("x")))(stack(0), stack(1))
        out[str(n)] = [{"mean": [np.asarray(x)[r].tolist() for x in jax.tree.leaves(m)],
                        "res": [np.asarray(x)[r].tolist() for x in jax.tree.leaves(nr)]}
                       for r in range(n)]
    dump(sys.argv[1], out)
    """
)


def test_psum_compressed_matches_the_references_shard_map(tmp_path):
    """One and two gloo ranks of the port beside the reference's
    ``shard_map`` on one and two XLA devices: each rank's mean and new
    residuals bit-equal."""
    (tmp_path / "rank.py").write_text(_PSUM_PORT)
    (tmp_path / "reference.py").write_text(_PSUM_REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmds = [[sys.executable, str(tmp_path / "reference.py"), str(tmp_path / "ref.json")],
            [sys.executable, str(tmp_path / "rank.py"), "0", "1", "", str(tmp_path / "one%d.json")]]
    cmds += [[sys.executable, str(tmp_path / "rank.py"), str(r), "2",
              f"file://{tmp_path / 'rendezvous'}", str(tmp_path / "two%d.json")] for r in range(2)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert json.loads((tmp_path / "one0.json").read_text()) == ref["1"][0]
    for r in range(2):
        assert json.loads((tmp_path / f"two{r}.json").read_text()) == ref["2"][r]
    # the two ranks agree on the mean, which is not either rank's gradient
    assert ref["2"][0]["mean"] == ref["2"][1]["mean"] != ref["1"][0]["mean"]
