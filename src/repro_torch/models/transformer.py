"""Decoder-only transformer LM (dense and MoE), GQA, qk-norm, KV-cache
decode, sliding-window serving: the reference's ``models/transformer.py``
on PyTorch.

Covers the five LM architectures (qwen3-8b, deepseek-7b,
command-r-plus-104b, qwen3-moe-30b-a3b, moonshot-v1-16b-a3b). Parameters
are dicts of tensors with the reference's names. Serving holds ``layers``
as a list with one dict a layer (``convert.transformer_params_from_arrays``
unstacks the reference's arrays); training holds them as the reference
does, one dict of tensors stacked on a leading layer axis (``stack_layers``),
so AdamW's rules, which read a leaf's rank, and checkpoints see the
reference's tree. ``forward_hidden`` and ``loss_fn`` take either; the
layers run in a loop. ``remat`` other than ``"none"`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``; ``"dots"`` keeps
nothing either, which changes memory, not results); ``unroll_layers`` and
``seq_parallel`` change nothing on one rank. The KV cache is updated in
place by ``decode_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, init_moe, moe_block
from repro_torch.parallel.sharding import MeshAxes, constrain
from repro_torch.train.tree import tree_map, value_and_grad

_F32, _BF16, _I32 = torch.float32, torch.bfloat16, torch.int32


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 1e6
    moe: Optional[MoEConfig] = None
    window: Optional[int] = None  # sliding-window serving (long_500k)
    remat: str = "full"  # none | full | dots (training; accepted here)
    unroll_layers: bool = False  # the reference's dry run (accepted here)
    seq_parallel: bool = False  # shard activations over (dp, mp)
    microbatches: int = 1  # gradient accumulation (training)

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
        )

    def param_count(self) -> int:
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_expert_ff + d * self.moe.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + v * d + d

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d = self.d_model
        attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = self.moe.top_k * 3 * d * self.moe.d_expert_ff + d * self.moe.n_experts
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + self.vocab * d + d


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(cfg: TransformerConfig, gen: torch.Generator, device, dtype):
    p = {
        "ln1": L.init_rmsnorm(cfg.d_model, device),
        "ln2": L.init_rmsnorm(cfg.d_model, device),
        "attn": L.init_attention(gen, cfg.attn, device, dtype),
    }
    if cfg.moe:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe, device, dtype)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, device, dtype)
    return p


def init_params(cfg: TransformerConfig, gen: Union[int, torch.Generator], device=None,
                dtype: torch.dtype = _F32) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` (a generator on ``device``, or
    a seed for one) on ``device`` (None is the CUDA card). Matmul weights
    are drawn in float32 and held in ``dtype`` (bfloat16 halves a full-size
    model's memory: the values a server's cast gives); norm scales stay
    float32."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, dev, dtype),
        "layers": [_init_layer(cfg, gen, dev, dtype) for _ in range(cfg.n_layers)],
        "ln_f": L.init_rmsnorm(cfg.d_model, dev),
    }


def for_serving(params: Dict[str, Any]) -> Dict[str, Any]:
    """The parameters with every matmul weight (2-D and up) in bfloat16,
    the value each use's cast to the activations' dtype gives, cast once;
    norm scales stay float32. Tensors already in bfloat16 are shared."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x.to(_BF16) if x.dim() >= 2 else x

    return walk(params)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------


def _ffn(lp, cfg: TransformerConfig, axes: MeshAxes, x: torch.Tensor) -> torch.Tensor:
    return moe_block(lp["moe"], cfg.moe, axes, x) if cfg.moe else L.mlp(lp["mlp"], x)


def _layer_fwd(cfg: TransformerConfig, axes: MeshAxes, h, lp, positions):
    if cfg.seq_parallel:
        h = constrain(h, axes, "dp", "mp", None)
    else:
        h = constrain(h, axes, "dp", None, None)
    a = L.attention(lp["attn"], cfg.attn, L.rmsnorm(lp["ln1"], h), positions,
                    causal=True, window=cfg.window)
    h = h + a
    return h + _ffn(lp, cfg, axes, L.rmsnorm(lp["ln2"], h))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=_I32, device=device).expand(b, s)


def stack_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """The parameters with ``layers`` stacked on a leading axis, the
    reference's layout (new tensors; the others are shared)."""
    def stack(xs):
        if isinstance(xs[0], dict):
            return {k: stack([x[k] for x in xs]) for k in xs[0]}
        return torch.stack(xs)

    return {**params, "layers": stack(list(params["layers"]))}


def layer_list(layers, n_layers: int):
    """One dict a layer: ``layers`` itself where it is a list, else views
    of the stacked tensors (``unbind``, whose backward stacks the layers'
    gradients)."""
    if isinstance(layers, list):
        return layers

    def split(x):
        if isinstance(x, dict):
            return {k: split(v) for k, v in x.items()}
        return torch.unbind(x, 0)

    def pick(x, i):
        return {k: pick(v, i) for k, v in x.items()} if isinstance(x, dict) else x[i]

    parts = split(layers)
    return [pick(parts, i) for i in range(n_layers)]


def forward_hidden(params, cfg: TransformerConfig, axes: MeshAxes, tokens: torch.Tensor):
    b, s = tokens.shape
    h = L.embed(params["embed"], tokens)
    positions = _positions(b, s, tokens.device)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for lp in layer_list(params["layers"], cfg.n_layers):
        if remat:
            h = checkpoint(_layer_fwd, cfg, axes, h, lp, positions, use_reentrant=False)
        else:
            h = _layer_fwd(cfg, axes, h, lp, positions)
    return L.rmsnorm(params["ln_f"], h)


def loss_fn(params, cfg: TransformerConfig, axes: MeshAxes, tokens, labels):
    h = forward_hidden(params, cfg, axes, tokens)
    logits = L.logits_from_hidden(params["embed"], h)
    logits = constrain(logits, axes, "dp", None, "mp")
    return L.cross_entropy(logits, labels, cfg.vocab)


def grads_fn(params, cfg: TransformerConfig, axes: MeshAxes, tokens, labels):
    """(loss, grads) with optional gradient accumulation over microbatches
    (cfg.microbatches splits the batch axis; peak activation memory divides
    accordingly). Accumulated gradients are float32, as the reference's."""
    vg = value_and_grad(loss_fn)
    if cfg.microbatches <= 1:
        return vg(params, cfg, axes, tokens, labels)
    m = cfg.microbatches
    b = tokens.shape[0]
    if b % m:
        raise ValueError(f"grads_fn: batch {b} does not divide into {m} microbatches")
    tok_m = tokens.reshape(m, b // m, -1)
    lab_m = labels.reshape(m, b // m, -1)
    loss_sum = torch.zeros((), dtype=_F32, device=tokens.device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params)
    for i in range(m):
        loss, g = vg(params, cfg, axes, tok_m[i], lab_m[i])
        grads = tree_map(torch.add, grads, g)
        loss_sum = loss_sum + loss
    return loss_sum / m, tree_map(lambda g: g / m, grads)


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, cache_len: int, device=None):
    """An empty cache on ``device`` (None is the CUDA card): keys and
    values (L, batch, cache_len, kv, hd) bfloat16, positions -1."""
    dev = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (cfg.n_layers, batch, cache_len, kv, hd)
    return {
        "k": torch.zeros(shape, dtype=_BF16, device=dev),
        "v": torch.zeros(shape, dtype=_BF16, device=dev),
        "pos": torch.full((cfg.n_layers, batch, cache_len), -1, dtype=_I32, device=dev),
    }


def prefill(params, cfg: TransformerConfig, axes: MeshAxes, tokens: torch.Tensor):
    """Run the prompt, return (last-token logits (b, 1, V), filled cache).
    Cache length = prompt length."""
    b, s = tokens.shape
    h = L.embed(params["embed"], tokens)
    positions = _positions(b, s, tokens.device)
    mask = L.causal_mask(positions, cfg.window)
    ks, vs = [], []
    for lp in params["layers"]:
        h = constrain(h, axes, "dp", None, None)
        x = L.rmsnorm(lp["ln1"], h)
        q, k, v = L._qkv(lp["attn"], cfg.attn, x, positions)
        probs = L._masked_softmax(L._gqa_scores(q, k, cfg.attn), mask)
        a = L._gqa_mix(probs, v, cfg.attn).reshape(b, s, -1) @ lp["attn"]["wo"].to(h.dtype)
        h = h + a
        h = h + _ffn(lp, cfg, axes, L.rmsnorm(lp["ln2"], h))
        ks.append(k)
        vs.append(v)
    h = L.rmsnorm(params["ln_f"], h)
    logits = L.logits_from_hidden(params["embed"], h[:, -1:, :])
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "pos": _positions(b, s, tokens.device).expand(cfg.n_layers, b, s).clone(),
    }
    return logits, cache


def decode_step(params, cfg: TransformerConfig, axes: MeshAxes, cache, token: torch.Tensor,
                pos: torch.Tensor):
    """token: (b, 1) int32; pos: (b, 1) int32 absolute position (-1: the
    row writes the dump slot and attends to nothing it keeps).
    Returns (logits (b, 1, V), cache): the cache is updated in place, a
    rolling buffer of length cache_len (= window for sliding-window
    serving)."""
    h = L.embed(params["embed"], token)
    for i, lp in enumerate(params["layers"]):
        h = constrain(h, axes, "dp", None, None)
        x = L.rmsnorm(lp["ln1"], h)
        a, _, _, _ = L.attention_decode(lp["attn"], cfg.attn, x, cache["k"][i], cache["v"][i],
                                        cache["pos"][i], pos)
        h = h + a
        h = h + _ffn(lp, cfg, axes, L.rmsnorm(lp["ln2"], h))
    h = L.rmsnorm(params["ln_f"], h)
    logits = L.logits_from_hidden(params["embed"], h)
    logits = constrain(logits, axes, "dp", None, "mp")
    return logits, cache
