"""The port's recsys models (``repro_torch.models.recsys``: EmbeddingBag and
DCN-v2) against the reference's on the CPU.

Parameters are the reference's (``init_params`` from a PRNG key, through
``convert.dcn_params_from_arrays``); inputs are ``recsys_batch``'s seeded
numpy. DCN is held at its reduced config (``max_table_rows=1000``), with
quotient-remainder tables (``qr_threshold=500``: 12 of the 26 tables) and
with bfloat16 tables. Tolerances: float32 logits and loss to rtol 1e-5,
gradient leaves to rtol 1e-4 / atol 1e-6; with bfloat16 tables, whose
gradients the reference adds in bfloat16 (each table's rows over the
batch, in an order of its own), a table's gradient is held to 1/64 of its
largest magnitude and every other leaf as in float32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.recsys import dcn as RD  # noqa: E402
from repro.models.recsys import embedding as RE  # noqa: E402
from repro.parallel.sharding import MeshAxes as RAxes  # noqa: E402
from repro.pipeline.data import recsys_batch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import dcn_params_from_arrays  # noqa: E402
from repro_torch.models.recsys import dcn as D  # noqa: E402
from repro_torch.models.recsys import embedding as E  # noqa: E402
from repro_torch.parallel.sharding import MeshAxes  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves, value_and_grad  # noqa: E402

OUT_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_TABLE_TOL = 1 / 64  # of the table gradient's largest magnitude

VARIANTS = {"float32": {}, "qr": {"qr_threshold": 500}, "bf16": {"table_dtype": "bf16"}}


def _f32(x):
    x = x.detach() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _case(variant, batch=64, seed=0):
    rcfg = dataclasses.replace(ref_config("dcn-v2").reduced_model, **VARIANTS[variant])
    cfg = dataclasses.replace(get_config("dcn-v2").reduced_model, **VARIANTS[variant])
    rp = RD.init_params(rcfg, jax.random.PRNGKey(seed))
    pp = dcn_params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    d = recsys_batch(seed, 0, batch, cfg.n_dense, cfg.n_sparse,
                     [cfg.table_rows(i) for i in range(cfg.n_sparse)])
    return rcfg, cfg, rp, pp, d


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_loss_and_gradients_match_the_reference(variant):
    rcfg, cfg, rp, pp, d = _case(variant)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    np.testing.assert_allclose(
        D.logits(pp, cfg, MeshAxes(), t["dense"], t["sparse"]).detach().numpy(),
        np.asarray(RD.logits(rp, rcfg, RAxes(), j["dense"], j["sparse"])), rtol=OUT_RTOL,
        atol=1e-6)
    rl, rg = jax.value_and_grad(RD.loss_fn)(rp, rcfg, RAxes(), j["dense"], j["sparse"],
                                            j["labels"])
    pl, pg = value_and_grad(lambda p, *a: D.loss_fn(p, cfg, MeshAxes(), *a))(
        pp, t["dense"], t["sparse"], t["labels"])
    np.testing.assert_allclose(float(pl), float(rl), rtol=OUT_RTOL)
    ref_leaves = jax.tree_util.tree_leaves(rg)
    assert len(leaves(pg)) == len(ref_leaves)
    n_qr = 0
    for (path, got), want in zip(flatten_with_paths(pg), ref_leaves):
        assert got.dtype == {"bfloat16": torch.bfloat16}.get(str(want.dtype), torch.float32)
        got, want = _f32(got), _f32(want)
        name = "/".join(path)
        n_qr += path[-1] == "q"
        if variant == "bf16" and path[0] == "tables":
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got - want).max() <= BF16_TABLE_TOL * scale, name
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    assert n_qr == (sum(cfg.table_rows(i) > 500 for i in range(26)) if variant == "qr" else 0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_has_the_references_tree(variant):
    rcfg, cfg, rp, _, _ = _case(variant)
    got = D.init_params(cfg, 1, device="cpu")
    want = [(tuple(getattr(k, "key", str(getattr(k, "idx", k))) for k in p), x.shape,
             str(x.dtype)) for p, x in jax.tree_util.tree_flatten_with_path(rp)[0]]
    assert [(p, tuple(x.shape), str(x.dtype).split(".")[1]) for p, x in
            flatten_with_paths(got)] == want
    again = D.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(again)))


def test_full_criteo_padding_rule():
    cfg, rcfg = get_config("dcn-v2").model, ref_config("dcn-v2").model
    rows = [cfg.padded_rows(i) for i in range(26)]
    assert rows == [rcfg.padded_rows(i) for i in range(26)]
    assert sum(rows) == 33_763_622 and cfg.d_interact == 429


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_the_reference(combiner):
    """Bags of several indices with -1 padding, an empty bag, weights."""
    rng = np.random.RandomState(3)
    table = rng.randn(50, 8).astype(np.float32)
    idx = rng.randint(-1, 50, 40).astype(np.int32)
    idx[::5] = -1
    seg = np.sort(rng.randint(0, 9, 40)).astype(np.int32)  # bag 9 stays empty
    w = rng.rand(40).astype(np.float32)
    for weights in (None, w):
        got = E.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                              torch.from_numpy(seg), 10, combiner,
                              None if weights is None else torch.from_numpy(weights))
        want = RE.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), 10,
                                combiner, None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    one = E.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(one.numpy(),
                                  np.asarray(RE.embedding_bag(jnp.asarray(table),
                                                              jnp.asarray(idx))))
    assert (one.numpy()[idx < 0] == 0).all()
    with pytest.raises(ValueError):
        E.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), combiner="max",
                        segment_ids=torch.from_numpy(seg), n_segments=10)


def test_qr_lookup_and_retrieval_match_the_reference():
    rng = np.random.RandomState(4)
    q, r = rng.randn(6, 4).astype(np.float32), rng.randn(5, 4).astype(np.float32)
    idx = np.array([0, 7, 29, -1, 12], np.int32)
    np.testing.assert_array_equal(
        E.qr_embedding_lookup(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(idx),
                              5).numpy(),
        np.asarray(RE.qr_embedding_lookup(jnp.asarray(q), jnp.asarray(r), jnp.asarray(idx), 5)))
    rcfg, cfg, rp, pp, d = _case("float32", batch=2)
    cands = rng.randn(700, cfg.mlp_dims[-1]).astype(np.float32)
    got = D.retrieval_scores(pp, cfg, MeshAxes(), torch.from_numpy(d["dense"]),
                             torch.from_numpy(d["sparse"]), torch.from_numpy(cands))
    want = RD.retrieval_scores(rp, rcfg, RAxes(), jnp.asarray(d["dense"]),
                               jnp.asarray(d["sparse"]), jnp.asarray(cands))
    assert got.shape == (2, 100)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_param_specs_wait_for_5e():
    """The dcn specs (which once raised, naming 5e) against the reference's
    on both production meshes' axes, leaf by leaf: tables of 16,384 rows or
    more split by rows over mp (at their padded sizes), the rest
    replicated; the full tables, a cut at 20,000 rows (some split) and the
    reduced 1,000 (none)."""
    from jax.sharding import AbstractMesh, PartitionSpec

    for max_rows in (0, 20000, 1000):
        _specs_match(max_rows, AbstractMesh, PartitionSpec)


def _specs_match(max_rows, AbstractMesh, PartitionSpec):
    rcfg = dataclasses.replace(ref_config("dcn-v2").model, max_table_rows=max_rows)
    cfg = dataclasses.replace(get_config("dcn-v2").model, max_table_rows=max_rows)
    for names in (("data", "model"), ("pod", "data", "model")):
        raxes = RAxes.for_mesh(AbstractMesh((2,) * len(names), names))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            RD.param_specs(rcfg, raxes), is_leaf=lambda x: isinstance(x, PartitionSpec))
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(sp)
                for path, sp in flat}
        got = {"/".join(path): tuple(sp) for path, sp in
               flatten_with_paths(D.param_specs(cfg, MeshAxes(dp=names[:-1])))}
        assert got == want
        split = sorted(k for k, v in got.items() if v == ("model", None))
        n = sum(cfg.table_rows(i) >= 16384 for i in range(cfg.n_sparse))
        assert len(split) == n and (n > 0) == (max_rows != 1000)
