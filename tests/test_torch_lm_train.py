"""The port's LM training path (``models.transformer.grads_fn`` over the
stacked-layer parameters) against the reference's ``grads_fn`` on the CPU.

Parameters are the reference's (``init_params`` from a PRNG key), carried
across and stacked as the port trains them; tokens are ``token_batch``'s
(batch 4 x 64). The compute is bfloat16, so the comparison is against the
compiled reference with these tolerances: loss within 2e-3 (observed at
most 2e-4: whole models are not bit-equal, as PR 26 found for the logits),
each gradient leaf within a fraction of its largest magnitude: 2.5% for
qwen3-8b (observed 1.3%; the reference's own compiled and op-by-op
gradients differ by 1.3%), 20% for qwen3-moe-30b-a3b (observed 9.4%; the
reference's own two differ by 13%, a token near a routing tie changing
experts).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro.parallel.sharding import MeshAxes as RAxes  # noqa: E402
from repro.pipeline.data import token_batch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import transformer_params_from_arrays  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.parallel.sharding import MeshAxes  # noqa: E402
from repro_torch.train.tree import flatten_with_paths, leaves, tree_map  # noqa: E402

LOSS_ATOL = 2e-3
LEAF_FRACTION = {"qwen3-8b": 0.025, "qwen3-moe-30b-a3b": 0.2}


def _case(arch_id, microbatches=1, remat="none"):
    rcfg = dataclasses.replace(ref_config(arch_id).reduced_model, microbatches=microbatches)
    cfg = dataclasses.replace(get_config(arch_id).reduced_model, microbatches=microbatches,
                              remat=remat)
    rp = RTF.init_params(rcfg, jax.random.PRNGKey(0))
    p = TF.stack_layers(transformer_params_from_arrays(jax.tree.map(np.asarray, rp), cfg,
                                                       device="cpu"))
    d = token_batch(0, 0, 4, 64, cfg.vocab)
    return rcfg, cfg, rp, p, d


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch_id", list(LEAF_FRACTION))
def test_grads_fn_matches_the_reference(arch_id, microbatches):
    rcfg, cfg, rp, p, d = _case(arch_id, microbatches)
    rl, rg = jax.jit(lambda p_, t, l: RTF.grads_fn(p_, rcfg, RAxes(), t, l))(
        rp, d["tokens"], d["labels"])
    pl, pg = TF.grads_fn(p, cfg, MeshAxes(), torch.from_numpy(d["tokens"]),
                         torch.from_numpy(d["labels"]))
    assert abs(float(pl) - float(rl)) <= LOSS_ATOL
    ref_flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(leaves(pg)) == len(ref_flat)
    for (path, got), (rpath, want) in zip(flatten_with_paths(pg), ref_flat):
        assert path == tuple(str(getattr(k, "key", k)) for k in rpath)
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= LEAF_FRACTION[arch_id], ("/".join(path), err)


def test_microbatches_average_the_halves():
    """grads_fn over 2 microbatches is the mean of the two halves' losses
    and float32 gradients, bit for bit."""
    _, cfg, _, p, d = _case("qwen3-8b", 2)
    tok, lab = torch.from_numpy(d["tokens"]), torch.from_numpy(d["labels"])
    loss, grads = TF.grads_fn(p, cfg, MeshAxes(), tok, lab)
    one = dataclasses.replace(cfg, microbatches=1)
    halves = [TF.grads_fn(p, one, MeshAxes(), tok[i * 2:(i + 1) * 2], lab[i * 2:(i + 1) * 2])
              for i in range(2)]
    zero = torch.zeros((), dtype=torch.float32)
    assert torch.equal(loss, (zero + halves[0][0] + halves[1][0]) / 2)
    want = tree_map(lambda a, b: (torch.zeros_like(a) + a + b) / 2, halves[0][1], halves[1][1])
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads), leaves(want)))
    with pytest.raises(ValueError, match="microbatches"):
        TF.grads_fn(p, dataclasses.replace(cfg, microbatches=3), MeshAxes(), tok, lab)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recomputes_to_the_same_gradients(remat):
    _, cfg, _, p, d = _case("qwen3-moe-30b-a3b", remat="none")
    args = (MeshAxes(), torch.from_numpy(d["tokens"]), torch.from_numpy(d["labels"]))
    base = TF.grads_fn(p, cfg, *args)
    again = TF.grads_fn(p, dataclasses.replace(cfg, remat=remat), *args)
    assert torch.equal(base[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(base[1]), leaves(again[1])))


def test_stacked_and_listed_layers_give_the_same_loss():
    _, cfg, _, p, d = _case("qwen3-8b")
    listed = dict(p, layers=TF.layer_list(p["layers"], cfg.n_layers))
    assert isinstance(listed["layers"], list) and len(listed["layers"]) == cfg.n_layers
    args = (MeshAxes(), torch.from_numpy(d["tokens"]), torch.from_numpy(d["labels"]))
    assert torch.equal(TF.loss_fn(p, cfg, *args), TF.loss_fn(listed, cfg, *args))
    back = TF.stack_layers(listed)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(p)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_is_finite_and_the_references(dtype):
    """Where exp(-x) overflows, the written-out silu's own derivative is
    0 * inf; the port's is the closed form, as jax.nn.silu's."""
    x = np.array([-200.0, -90.0, -5.0, -0.5, 0.0, 0.7, 3.0, 100.0], np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.silu(v)).astype(jnp.float32))(
        jnp.asarray(x).astype(jd)), np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    (got,) = torch.autograd.grad(L.silu(xt).float().sum(), xt)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == "float32" else 2 ** -7,
                               atol=1e-7 if dtype == "float32" else 2 ** -8)
    with torch.no_grad():
        assert torch.equal(L.silu(xt), L._silu(xt))
