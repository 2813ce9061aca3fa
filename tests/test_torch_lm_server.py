"""The port's continuous-batching LM server (``repro_torch.serve.lm_server``)
on the CPU: the reference's three cases (``tests/test_lm_server.py``) on
the port — outputs equal offline greedy decoding whatever the admission
order and slot reuse — and the port's tokens equal to the reference
``LMServer``'s for the same parameters (the reference's, carried across
with ``convert.transformer_params_from_arrays``) and the same requests.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro.serve.lm_server import LMServer as RServer  # noqa: E402
from repro.serve.lm_server import Request as RRequest  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import transformer_params_from_arrays  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.parallel.sharding import MeshAxes  # noqa: E402
from repro_torch.serve.lm_server import LMServer, Request  # noqa: E402


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced_model, remat="none")
    rcfg = dataclasses.replace(ref_config("qwen3-8b").reduced_model, remat="none")
    rparams = RTF.init_params(rcfg, jax.random.PRNGKey(0))
    params = transformer_params_from_arrays(jax.tree.map(np.asarray, rparams), cfg,
                                            device="cpu")
    return cfg, params, rcfg, rparams


def _offline_greedy(cfg, params, prompt, max_new):
    axes = MeshAxes()
    cache = TF.init_cache(cfg, 1, 256, device="cpu")
    logits = None
    for t, tok in enumerate(prompt):
        logits, cache = TF.decode_step(params, cfg, axes, cache,
                                       torch.tensor([[tok]], dtype=torch.int32),
                                       torch.tensor([[t]], dtype=torch.int32))
    out = []
    pos = len(prompt)
    last = int(torch.argmax(logits[0, 0]))
    for _ in range(max_new):
        out.append(last)
        logits, cache = TF.decode_step(params, cfg, axes, cache,
                                       torch.tensor([[last]], dtype=torch.int32),
                                       torch.tensor([[pos]], dtype=torch.int32))
        pos += 1
        last = int(torch.argmax(logits[0, 0]))
    return out


def test_server_matches_offline_greedy(model):
    cfg, params, _, _ = model
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, rng.randint(3, 7)).astype(np.int32)
               for _ in range(5)]
    server = LMServer(cfg, params, n_slots=3, cache_len=64, device="cpu")
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, prompt=p, max_new=4))
    results = server.run_until_drained()
    assert set(results) == set(range(5))
    for i, p in enumerate(prompts):
        assert results[i] == _offline_greedy(cfg, params, p.tolist(), 4), f"request {i}"


def test_slot_reuse_isolated(model):
    """A second tenant of a freed slot must not see stale KV entries."""
    cfg, params, _, _ = model
    rng = np.random.RandomState(1)
    p1 = rng.randint(0, cfg.vocab, 5).astype(np.int32)
    p2 = rng.randint(0, cfg.vocab, 4).astype(np.int32)
    server = LMServer(cfg, params, n_slots=1, cache_len=64, device="cpu")
    server.submit(Request(rid=0, prompt=p1, max_new=3))
    server.submit(Request(rid=1, prompt=p2, max_new=3))
    results = server.run_until_drained()
    assert results[1] == _offline_greedy(cfg, params, p2.tolist(), 3)
    assert (server.cache["pos"] == -1).all()  # the retired slot is invalidated


def test_adaptive_admission_reacts(model):
    cfg, params, _, _ = model
    server = LMServer(cfg, params, n_slots=4, cache_len=32, device="cpu")
    rng = np.random.RandomState(2)
    for i in range(6):
        server.submit(Request(rid=i, prompt=rng.randint(0, cfg.vocab, 3).astype(np.int32),
                              max_new=2))
    server.run_until_drained()
    assert server.sizer.size <= server.n_slots


@pytest.mark.parametrize("n_slots,cache_len,max_new", [(3, 64, 8), (1, 64, 5), (4, 16, 20)])
def test_tokens_equal_the_reference_server(model, n_slots, cache_len, max_new):
    """The same requests through both servers give the same tokens; the
    last case runs requests into the cache's end (retired at cache_len-1).
    The port equals the reference server run op by op (``disable_jit``,
    every result rounded to bfloat16 as in PyTorch), and the compiled
    reference server wherever that agrees with its own op-by-op run: XLA's
    fusion keeps float32 inside elementwise chains, which can turn a near
    tie in the last case (request 2's third token) the other way."""
    cfg, params, rcfg, rparams = model
    rng = np.random.RandomState(10 + n_slots)
    prompts = [rng.randint(0, cfg.vocab, rng.randint(3, 9)).astype(np.int32)
               for _ in range(6)]

    def serve(server, request):
        for i, p in enumerate(prompts):
            server.submit(request(rid=i, prompt=p, max_new=max_new))
        return server.run_until_drained(), server.steps

    got, steps = serve(LMServer(cfg, params, n_slots=n_slots, cache_len=cache_len,
                                device="cpu"), Request)
    with jax.disable_jit():
        eager, eager_steps = serve(RServer(rcfg, rparams, n_slots=n_slots,
                                           cache_len=cache_len), RRequest)
    compiled, _ = serve(RServer(rcfg, rparams, n_slots=n_slots, cache_len=cache_len),
                        RRequest)
    assert got == eager and steps == eager_steps
    for rid, tokens in compiled.items():
        if tokens == eager[rid]:
            assert got[rid] == tokens, rid
    assert sum(compiled[r] == eager[r] for r in compiled) >= len(prompts) - 1


def test_server_holds_bfloat16_weights_once(model):
    cfg, params, _, _ = model
    server = LMServer(cfg, params, n_slots=2, cache_len=16, device="cpu")
    assert server.params["layers"][0]["mlp"]["w_up"].dtype == torch.bfloat16
    assert server.params["embed"]["table"].dtype == torch.bfloat16
    assert server.params["ln_f"]["scale"].dtype == torch.float32
    assert params["layers"][0]["mlp"]["w_up"].dtype == torch.float32  # the caller's untouched
    with pytest.raises(ValueError, match="parameters are on"):
        LMServer(cfg, params, device="meta")
