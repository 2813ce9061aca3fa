"""The port's LM stack (``repro_torch.models``: layers, MoE, transformer,
configs) against the reference's on the CPU.

Parameters are drawn by the reference (``init_params`` from a PRNG key, or
seeded numpy for single layers) and carried across with
``convert.transformer_params_from_arrays``; inputs are seeded numpy. Two
references, with their tolerances:

  * the reference evaluated op by op (``jax.disable_jit()``: each primitive
    its own XLA call, each result rounded to its dtype, as in PyTorch's
    eager mode): the port is bit-exact on the layers, and within
    ``EAGER_ATOL`` on whole models (the CPU matmul libraries add in
    different orders at a few shapes);
  * the reference as it runs (``jit`` / ``scan``: XLA fuses elementwise
    chains and keeps float32 between them): logits within
    ``COMPILED_ATOL``.

Decode against prefill uses the reference's own test tolerance, 1e-3.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro.parallel.sharding import MeshAxes as RAxes  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import transformer_params_from_arrays  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402

LM_IDS = ARCH_IDS[:5]
BF16 = torch.bfloat16
EAGER_ATOL = 1 / 128  # logits, whole reduced models, against the op-by-op reference
COMPILED_ATOL = 1 / 32  # logits, against the compiled reference (observed <= 1/64)
DECODE_TOL = 1e-3  # decode against prefill (tests/test_arch_smoke.py)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _bf(x):
    """The same bfloat16 values in both packages."""
    return jnp.asarray(x).astype(jnp.bfloat16), _t(x, BF16)


def _eager(fn, *args, **kw):
    with jax.disable_jit():
        return fn(*args, **kw)


def _models(arch_id, cf=None):
    rcfg = dataclasses.replace(ref_config(arch_id).reduced_model, remat="none")
    cfg = dataclasses.replace(get_config(arch_id).reduced_model, remat="none")
    if cf is not None and cfg.moe is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    rp = RTF.init_params(rcfg, jax.random.PRNGKey(0))
    p = transformer_params_from_arrays(jax.tree.map(np.asarray, rp), cfg, device="cpu")
    return rcfg, rp, cfg, p


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_configs_are_the_references(arch_id):
    got, want = get_config(arch_id), ref_config(arch_id)
    assert (got.name, got.kind, got.source, got.shapes) == (want.name, want.kind, want.source,
                                                           want.shapes)
    for mine, theirs in ((got.model, want.model), (got.reduced_model, want.reduced_model)):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert a == b
        assert mine.param_count() == theirs.param_count()
        assert mine.active_param_count() == theirs.active_param_count()


@pytest.mark.parametrize("arch_id", ARCH_IDS[5:])
def test_gnn_and_recsys_configs_wait_for_their_slice(arch_id):
    """The GNN and recsys configs have come (slice 5d): each equals the
    reference's, field for field."""
    got, want = get_config(arch_id), ref_config(arch_id)
    assert (got.name, got.kind, got.source, got.shapes) == (want.name, want.kind, want.source,
                                                           want.shapes)
    for mine, theirs in ((got.model, want.model), (got.reduced_model, want.reduced_model)):
        assert type(mine).__name__ == type(theirs).__name__
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_qwen3_8b_full_size_is_7_57b_parameters():
    assert round(get_config("qwen3-8b").model.param_count() / 1e9, 2) == 7.57


# ---------------------------------------------------------------------------
# layers, bit for bit against the op-by-op reference
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, 32).astype(np.float32) * 3
    scale = rng.rand(32).astype(np.float32) + 0.5
    pos = rng.randint(0, 5000, (2, 7)).astype(np.int32)
    xj, xt = _bf(x)
    np.testing.assert_array_equal(
        _np(L.rmsnorm({"scale": _t(scale)}, xt).float()),
        _np(_eager(RL.rmsnorm, {"scale": jnp.asarray(scale)}, xj)))
    for theta in (1e6, 1e4):
        got = L.rope(xt, _t(pos, torch.int32), theta).float().numpy()
        want = _np(_eager(RL.rope, xj, jnp.asarray(pos), theta))
        # float32 sin / cos of angles up to 5,000 rad: libraries differ in the last bits
        np.testing.assert_allclose(got, want, atol=2 ** -7 * 4, rtol=0)
        assert (got == want).mean() > 0.99


def _attn_params(rng, cfg):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.randn(d, h * hd), "wk": rng.randn(d, k * hd), "wv": rng.randn(d, k * hd),
         "wo": rng.randn(h * hd, d)}
    p = {n: (w / np.sqrt(w.shape[0])).astype(np.float32) for n, w in p.items()}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": (rng.rand(hd) + 0.5).astype(np.float32)}
        p["k_norm"] = {"scale": (rng.rand(hd) + 0.5).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(_t, p)
    return jp, tp


@pytest.mark.parametrize("qk_norm,window", [(True, None), (False, None), (True, 4)])
def test_attention_prefill(qk_norm, window):
    rng = np.random.RandomState(1)
    rcfg = RL.AttnConfig(64, 4, 2, 16, qk_norm=qk_norm)
    cfg = L.AttnConfig(64, 4, 2, 16, qk_norm=qk_norm)
    jp, tp = _attn_params(rng, cfg)
    xj, xt = _bf(rng.randn(2, 9, 64).astype(np.float32))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    want = _eager(RL.attention, jp, rcfg, xj, jnp.asarray(pos), window=window)
    got = L.attention(tp, cfg, xt, _t(pos, torch.int32), window=window)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_attention_decode_dump_slot_and_rolling_window():
    """Rows at position -1 write slot S - 1 (the dump slot) and keep -1
    there; positions past S wrap (a window shorter than the positions)."""
    rng = np.random.RandomState(2)
    S, b = 6, 3
    rcfg, cfg = RL.AttnConfig(64, 4, 2, 16, True), L.AttnConfig(64, 4, 2, 16, True)
    jp, tp = _attn_params(rng, cfg)
    ck = rng.randn(b, S, 2, 16).astype(np.float32)
    cv = rng.randn(b, S, 2, 16).astype(np.float32)
    cp = np.asarray([[0, 1, 2, 3, 4, -1], [6, 7, 8, 9, 4, 5], [-1] * S], np.int32)
    for step, positions in enumerate(([[5], [-1], [0]], [[-1], [10], [1]], [[6], [11], [-1]])):
        positions = np.asarray(positions, np.int32)
        xj, xt = _bf(rng.randn(b, 1, 64).astype(np.float32))
        ckj, ckt = _bf(ck)
        cvj, cvt = _bf(cv)
        want = _eager(RL.attention_decode, jp, rcfg, xj, ckj, cvj, jnp.asarray(cp),
                      jnp.asarray(positions))
        got = L.attention_decode(tp, cfg, xt, ckt.clone(), cvt.clone(), _t(cp, torch.int32),
                                 _t(positions, torch.int32))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.float().numpy(), _np(w), err_msg=f"step {step}")
        for i, p in enumerate(positions[:, 0]):
            assert got[3][i, p % S] == p  # -1 lands in slot S - 1
        ck, cv, cp = (_np(want[1]), _np(want[2]), np.asarray(want[3]))


def test_mlp_embedding_logits_and_cross_entropy():
    rng = np.random.RandomState(3)
    p = {"w_gate": rng.randn(32, 96), "w_up": rng.randn(32, 96), "w_down": rng.randn(96, 32)}
    p = {n: (w / np.sqrt(w.shape[0])).astype(np.float32) for n, w in p.items()}
    xj, xt = _bf(rng.randn(2, 5, 32).astype(np.float32) * 2)
    np.testing.assert_array_equal(
        L.mlp(jax.tree.map(_t, p), xt).float().numpy(),
        _np(_eager(RL.mlp, jax.tree.map(jnp.asarray, p), xj)))
    table = (rng.randn(50, 32) * 0.02).astype(np.float32)
    toks = rng.randint(0, 50, (2, 5)).astype(np.int32)
    h = _eager(RL.embed, {"table": jnp.asarray(table)}, jnp.asarray(toks))
    ht = L.embed({"table": _t(table)}, _t(toks, torch.int32))
    np.testing.assert_array_equal(ht.float().numpy(), _np(h))
    lg = _eager(RL.logits_from_hidden, {"table": jnp.asarray(table)}, xj)
    lt = L.logits_from_hidden({"table": _t(table)}, xt)
    np.testing.assert_array_equal(lt.float().numpy(), _np(lg))
    labels = rng.randint(0, 50, (2, 5)).astype(np.int32)
    ce = float(_eager(RL.cross_entropy, lg, jnp.asarray(labels), 50))
    assert abs(float(L.cross_entropy(lt, _t(labels, torch.int32), 50)) - ce) <= 1e-6 * abs(ce)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_case(cf, router_bias=0.0, seed=4, n=(2, 12)):
    rng = np.random.RandomState(seed)
    rcfg = RM.MoEConfig(n_experts=8, top_k=2, d_expert_ff=48, capacity_factor=cf)
    cfg = TM.MoEConfig(n_experts=8, top_k=2, d_expert_ff=48, capacity_factor=cf)
    d = 32
    p = {"w_router": rng.randn(d, 8) / np.sqrt(d),
         "experts": {"w_gate": rng.randn(8, d, 48) / np.sqrt(d),
                     "w_up": rng.randn(8, d, 48) / np.sqrt(d),
                     "w_down": rng.randn(8, 48, d) / np.sqrt(48)}}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.randn(*n, d).astype(np.float32)
    if router_bias:
        # every token's first choice is expert 0: it fills, the rest drop
        x[..., 0] = np.abs(x[..., 0]) + 3.0
        p["w_router"][0] = 0.0
        p["w_router"][0, 0] = router_bias
    xj, xt = _bf(x)
    return rcfg, cfg, jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p), xj, xt


def _quirk_rows(cfg, top_e):
    """Tokens whose expert-0 output the reference loses: a kept
    assignment in (expert 0, slot cap - 1) with a dropped assignment after
    it in the flattened order (the reference writes each dropped one there
    as zeros, the last write winning)."""
    n, k = top_e.shape
    cap = TM.capacity(n, cfg)
    slot = TM.expert_slots(top_e, cfg.n_experts).numpy()
    flat = top_e.reshape(-1).numpy()
    last = [i for i in range(n * k) if flat[i] == 0 and slot[i] == cap - 1]
    dropped = np.flatnonzero(slot >= cap)
    return {i // k for i in last if (dropped > i).any()}, len(dropped)


@pytest.mark.parametrize("cf,impl", [(8.0, "scatter"), (0.5, "scatter"), (1.0, "scatter"),
                                     (0.5, "ep_psum")])
def test_moe_block_matches_the_reference(cf, impl):
    """No drops (cf 8), drops (0.5, 1.0): equal to the reference on every
    token it keeps whole; ep_psum on one rank is the scatter path."""
    rcfg, cfg, jp, tp, xj, xt = _moe_case(cf)
    rcfg, cfg = dataclasses.replace(rcfg, impl=impl), dataclasses.replace(cfg, impl=impl)
    want = _np(_eager(RM.moe_block, jp, rcfg, RAxes(), xj)).reshape(-1, 32)
    got = TM.moe_block(tp, cfg, SH.MeshAxes(), xt).float().numpy().reshape(-1, 32)
    _, _, top_e = TM.route(tp, cfg, xt.reshape(-1, 32))
    lost, n_dropped = _quirk_rows(cfg, top_e)
    assert (n_dropped == 0) == (cf == 8.0)
    keep = [i for i in range(got.shape[0]) if i not in lost]
    np.testing.assert_array_equal(got[keep], want[keep])
    compiled = _np(RM.moe_block(jp, rcfg, RAxes(), xj)).reshape(-1, 32)
    np.testing.assert_allclose(got[keep], compiled[keep], atol=COMPILED_ATOL, rtol=0)


def test_moe_expert0_quirk_the_port_keeps_the_output():
    """Every token routes first to expert 0, which fills at its capacity
    of 8: the reference zeroes expert 0's last slot with the dropped rows
    written after it, so token 7 loses its expert-0 output; the port keeps
    it, and equals the reference on every other token."""
    rcfg, cfg, jp, tp, xj, xt = _moe_case(1.25, router_bias=20.0)
    want = _np(_eager(RM.moe_block, jp, rcfg, RAxes(), xj)).reshape(-1, 32)
    got = TM.moe_block(tp, cfg, SH.MeshAxes(), xt).float().numpy().reshape(-1, 32)
    _, top_p, top_e = TM.route(tp, cfg, xt.reshape(-1, 32))
    lost, n_dropped = _quirk_rows(cfg, top_e)
    assert lost == {7} and n_dropped > 0
    others = [i for i in range(24) if i != 7]
    # the second experts' weights are around e^-60 here: XLA flushes the
    # denormal products to zero, PyTorch keeps them
    np.testing.assert_allclose(got[others], want[others], atol=1e-30, rtol=0)
    # token 7 by hand, in float32: its two experts' outputs, weighted
    x7 = xt.reshape(-1, 32)[7].float()
    we = {k: v.to(BF16).float() for k, v in tp["experts"].items()}
    out = 0
    for e, w in zip(top_e[7].tolist(), top_p[7].tolist()):
        g = x7 @ we["w_gate"][e]
        out = out + w * ((g * torch.sigmoid(g) * (x7 @ we["w_up"][e])) @ we["w_down"][e])
    out = out.numpy()
    assert np.abs(got[7] - out).max() < 0.05 < np.abs(want[7] - out).max()


def test_moe_load_balance_loss():
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(8), 24).astype(np.float32)
    top_e = np.argsort(-probs, axis=1)[:, :2].astype(np.int32)
    want = float(_eager(RM.load_balance_loss, jnp.asarray(probs), jnp.asarray(top_e), 8))
    got = float(TM.load_balance_loss(_t(probs), _t(top_e, torch.int32), 8))
    assert abs(got - want) <= 1e-6


def test_more_than_one_rank_waits_for_its_slice(tmp_path):
    """``constrain`` and ``ep_psum`` (which once raised over more ranks,
    naming the slice) on a fake two-rank group, a (1, 2) mesh: ``constrain``
    is the identity on a tensor that is its spec's shard and raises on one
    that is not; ``ep_psum`` on rank 0 computes only its four experts'
    assignments (the partial that, summed over the ranks, is the block's
    output: the rank's part of the one-rank output, exactly) and makes the
    one all-reduce over mp."""
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh

    axes = SH.MeshAxes.for_mesh(None)
    x = torch.ones(2, 3)
    assert SH.constrain(x, axes, "dp", None) is x
    assert axes.resolve("dp+mp") == ("data", "model") and axes == SH.MeshAxes()
    rcfg, cfg, jp, tp, xj, xt = _moe_case(8.0)
    cfg = dataclasses.replace(cfg, impl="ep_psum")
    one = TM.moe_block(tp, cfg, axes, xt)
    with fake_group(2):
        two = SH.MeshAxes.for_mesh(make_mesh((1, 2), ("data", "model"), device="cpu"))
        assert two.world == 2 and two.index("model") == 0
        assert SH.constrain(x, two, None, "mp", full=(2, 6)) is x
        with pytest.raises(ValueError, match="shard"):
            SH.constrain(x, two, None, "mp", full=(2, 8))
        half = {**tp, "experts": {k: v[: cfg.n_experts // 2] for k, v in tp["experts"].items()}}
        got = TM.moe_block(half, cfg, two, xt)
        two.tally.reset()
        y = TF._leave(got, two, False)
        assert two.tally.calls["all-reduce"] == 1 and y.shape == got.shape
    # rank 0's partial: the tokens' outputs from experts 0-3 only
    _, top_p, top_e = TM.route(tp, cfg, xt.reshape(-1, xt.shape[-1]))
    slot = TM.expert_slots(top_e, cfg.n_experts)
    want = TM._dispatch(xt.reshape(-1, xt.shape[-1]), top_p, top_e, slot,
                        TM.capacity(top_e.shape[0], cfg), half["experts"], 0,
                        cfg.n_experts // 2).reshape(got.shape)
    assert torch.equal(got, want)
    assert not torch.equal(got, one)


# ---------------------------------------------------------------------------
# whole reduced models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_reduced_model_logits_match_the_reference(arch_id):
    """forward_hidden and prefill's logits on 2 x 12 seeded tokens (MoE at
    capacity factor 8, no drops), against the op-by-op and the compiled
    reference; and the loss."""
    rcfg, rp, cfg, p = _models(arch_id, cf=8.0)
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    tt = _t(toks, torch.int32)
    axes = SH.MeshAxes()
    h = TF.forward_hidden(p, cfg, axes, tt).float().numpy()
    logits, cache = TF.prefill(p, cfg, axes, tt)
    logits = logits.float().numpy()
    with jax.disable_jit():
        eh = _np(RTF.forward_hidden(rp, rcfg, RAxes(), jnp.asarray(toks)))
        el, ecache = RTF.prefill(rp, rcfg, RAxes(), jnp.asarray(toks))
    np.testing.assert_allclose(h, eh, atol=EAGER_ATOL * 8, rtol=0)
    np.testing.assert_allclose(logits, _np(el), atol=EAGER_ATOL, rtol=0)
    assert logits.shape == (2, 1, cfg.vocab)
    cl, ccache = RTF.prefill(rp, rcfg, RAxes(), jnp.asarray(toks))
    np.testing.assert_allclose(logits, _np(cl), atol=COMPILED_ATOL, rtol=0)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ccache["pos"]))
    labels = np.roll(toks, -1, axis=1)
    loss = float(TF.loss_fn(p, cfg, axes, tt, _t(labels, torch.int32)))
    want = float(RTF.loss_fn(rp, rcfg, RAxes(), jnp.asarray(toks), jnp.asarray(labels)))
    assert np.isfinite(loss) and abs(loss - want) <= 1e-2


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_reduced_decode_matches_prefill(arch_id):
    """The reference's test (tests/test_arch_smoke.py) on the port, for
    every LM config, at its 1e-3; and the decode logits against the
    reference's decode."""
    rcfg, rp, cfg, p = _models(arch_id, cf=8.0)
    toks = np.random.RandomState(6).randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    tt = _t(toks, torch.int32)
    axes = SH.MeshAxes()
    logits_p, _ = TF.prefill(p, cfg, axes, tt)
    cache = TF.init_cache(cfg, 2, 12, device="cpu")
    rcache = RTF.init_cache(rcfg, 2, 12)
    for t in range(12):
        logits_d, cache = TF.decode_step(p, cfg, axes, cache, tt[:, t:t + 1],
                                         torch.full((2, 1), t, dtype=torch.int32))
        rl, rcache = RTF.decode_step(rp, rcfg, RAxes(), rcache, jnp.asarray(toks[:, t:t + 1]),
                                     jnp.full((2, 1), t, jnp.int32))
        np.testing.assert_allclose(logits_d.float().numpy(), _np(rl), atol=COMPILED_ATOL,
                                   rtol=0)
    np.testing.assert_allclose(logits_p.float().numpy(), logits_d.float().numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_sliding_window_decode_matches_windowed_prefill():
    """cfg.window with a rolling cache of the window's length: decoding 12
    tokens through a 4-slot cache gives the logits of a prefill masked to
    the window, and the reference's windowed decode."""
    rcfg, rp, cfg, p = _models("qwen3-8b")
    rcfg, cfg = dataclasses.replace(rcfg, window=4), dataclasses.replace(cfg, window=4)
    toks = np.random.RandomState(7).randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    tt = _t(toks, torch.int32)
    axes = SH.MeshAxes()
    logits_p, _ = TF.prefill(p, cfg, axes, tt)
    cache = TF.init_cache(cfg, 2, 4, device="cpu")
    rcache = RTF.init_cache(rcfg, 2, 4)
    for t in range(12):
        logits_d, cache = TF.decode_step(p, cfg, axes, cache, tt[:, t:t + 1],
                                         torch.full((2, 1), t, dtype=torch.int32))
        rl, rcache = RTF.decode_step(rp, rcfg, RAxes(), rcache, jnp.asarray(toks[:, t:t + 1]),
                                     jnp.full((2, 1), t, jnp.int32))
    assert sorted(cache["pos"][0, 0].tolist()) == [8, 9, 10, 11]
    np.testing.assert_allclose(logits_p.float().numpy(), logits_d.float().numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    np.testing.assert_allclose(logits_d.float().numpy(), _np(rl), atol=COMPILED_ATOL, rtol=0)


def test_init_params_is_seeded_and_shaped():
    cfg = get_config("qwen3-moe-30b-a3b").reduced_model
    a = TF.init_params(cfg, 3, device="cpu")
    b = TF.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    rp = RTF.init_params(cfg_ref := ref_config("qwen3-moe-30b-a3b").reduced_model,
                         jax.random.PRNGKey(0))
    ref = transformer_params_from_arrays(jax.tree.map(np.asarray, rp), cfg_ref, device="cpu")
    flat_a, flat_b, flat_r = (jax.tree_util.tree_leaves(x) for x in (a, b, ref))
    assert len(flat_a) == len(flat_r)
    for x, y, r in zip(flat_a, flat_b, flat_r):
        assert torch.equal(x, y) and x.shape == r.shape and x.dtype == r.dtype
    n = sum(x.numel() for x in flat_a)
    assert n == cfg.param_count() + 2 * cfg.head_dim * cfg.n_layers  # + the qk norms
    served = TF.for_serving(a)
    assert served["layers"][0]["moe"]["experts"]["w_up"].dtype == BF16
    assert served["layers"][0]["ln1"]["scale"].dtype == torch.float32
