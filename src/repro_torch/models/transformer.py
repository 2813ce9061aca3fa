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
reference's tree. Every function takes either; the layers run in a loop.
``remat`` other than ``"none"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``; ``"dots"`` keeps nothing either, which changes
memory, not results); ``unroll_layers`` changes nothing here. The KV cache
is updated in place by ``decode_step``.

Over a mesh (``MeshAxes`` with more than one rank) each function is one
rank's program over the shards ``param_specs`` / ``cache_specs`` give it,
Megatron style: the embedding and the logits are split over the vocabulary
(a masked local lookup and one all-reduce; a cross entropy with max, sum-exp
and label-logit all-reduces), attention over heads (``wq`` / ``wo`` local,
``wk`` / ``wv`` all-gathered where a rank's heads need more than its
columns, as at 16 ranks, where 8 kv heads split mid-head), the MLP over
``d_ff``, MoE experts over mp. A sublayer's input enters the model axis
before its norm (``copy_to``; an all-gather of the sequence under
``seq_parallel``) and its output leaves it by an all-reduce (a
reduce-scatter of the sequence), so every leaf replicated over a mesh axis
holds a share of its gradient that sums to the whole over that axis
(``sharding.sync_grads``). The decode cache is split over the sequence:
the new token is written by the rank that owns its slot, and attention
combines the ranks' partial softmaxes by their log-sum-exp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, init_moe, moe_block
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import MeshAxes, Spec, constrain
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




def param_shapes(cfg: TransformerConfig, dtype: torch.dtype = _F32) -> Dict[str, Any]:
    """The training tree (layers stacked) as meta tensors: shapes and
    dtypes only, nothing allocated."""
    return stack_layers(init_params(cfg, torch.Generator(), device="meta", dtype=dtype))


def param_specs(cfg: TransformerConfig, axes: MeshAxes):
    """The reference's layout of the training tree: the vocabulary, heads,
    ``d_ff`` and MoE experts over mp, the rest replicated."""
    mp = axes.mp

    def rule(path, leaf):
        name = path[-1]
        stacked = path[0] == "layers"  # leading L axis

        def wrap(*dims):
            return Spec(*((None,) + dims if stacked else dims))

        if name == "table":
            return Spec(mp, None)  # vocab-sharded embedding
        if name == "scale":
            return wrap(None) if leaf.dim() == (2 if stacked else 1) else Spec(None)
        if "experts" in path:
            return wrap(mp, None, None)  # (L, E, d, f): experts over mp
        if name == "w_router":
            return wrap(None, None)
        if name in ("wq", "wk", "wv", "w_gate", "w_up"):
            return wrap(None, mp)
        if name in ("wo", "w_down"):
            return wrap(mp, None)
        return Spec(*([None] * leaf.dim()))

    return SH.tree_spec(param_shapes(cfg), rule)


# ---------------------------------------------------------------------------
# one rank's pieces over the model axis (identities on one rank)
# ---------------------------------------------------------------------------


def _mp(axes: MeshAxes) -> int:
    return axes.size(axes.mp)


def _enter(x: torch.Tensor, axes: MeshAxes, sp: bool) -> torch.Tensor:
    """A sublayer's input, whole on every rank of the model axis."""
    return SH.all_gather(x, axes, axes.mp, 1) if sp else SH.copy_to(x, axes, axes.mp)


def _leave(y: torch.Tensor, axes: MeshAxes, sp: bool) -> torch.Tensor:
    """A sublayer's partial output summed over the model axis."""
    return SH.reduce_scatter(y, axes, axes.mp, 1) if sp else SH.all_reduce(y, axes, axes.mp)


def _embed(p_embed, tokens: torch.Tensor, axes: MeshAxes) -> torch.Tensor:
    """The embedding over a vocabulary split on mp: each rank looks up the
    tokens in its rows (zeros elsewhere), one all-reduce adds them."""
    if _mp(axes) == 1:
        return L.embed(p_embed, tokens)
    table = p_embed["table"]
    vl = table.shape[0]
    t = tokens.long() - axes.index(axes.mp) * vl
    mine = (t >= 0) & (t < vl)
    rows = torch.where(mine[..., None], table[torch.where(mine, t, 0)], 0.0)
    return SH.all_reduce(rows, axes, axes.mp).to(_BF16)


def _token_losses_tp(logits: torch.Tensor, labels: torch.Tensor, axes: MeshAxes):
    """Per-token ``logsumexp - logit[label]`` over a vocabulary split on
    mp, in float32 (the max carries no gradient: the result does not
    depend on it)."""
    lf = logits.to(_F32)
    vl = lf.shape[-1]
    m = SH.all_reduce(lf.detach().amax(-1), axes, axes.mp, op="max")
    lse = torch.log(SH.all_reduce(torch.exp(lf - m[..., None]).sum(-1), axes, axes.mp)) + m
    t = labels.long() - axes.index(axes.mp) * vl
    mine = (t >= 0) & (t < vl)
    ll = torch.gather(lf, -1, torch.where(mine, t, 0)[..., None])[..., 0]
    return lse - SH.all_reduce(torch.where(mine, ll, 0.0), axes, axes.mp)


def _local_heads(cfg: L.AttnConfig, axes: MeshAxes):
    """(first head, heads, first kv head, kv heads past the last) of this
    rank's query heads."""
    mp, h, kv = _mp(axes), cfg.n_heads, cfg.n_kv_heads
    if h % mp:
        raise ValueError(f"wq: {h} heads do not divide over {mp} ranks of {axes.mp!r}")
    hl = h // mp
    h0 = axes.index(axes.mp) * hl
    g = h // kv
    if hl % g and g % hl:
        raise ValueError(f"wq: {hl} heads a rank do not align with kv groups of {g}")
    return h0, hl, h0 // g, (h0 + hl - 1) // g + 1


def _kv_weight(p, name: str, axes: MeshAxes, lo: int, hi: int, hd: int) -> torch.Tensor:
    """The columns of ``wk`` / ``wv`` of kv heads [lo, hi): the local shard
    where it holds exactly those, else the all-gathered weight's."""
    w = p[name]
    if _mp(axes) > 1:
        cols = w.shape[1]
        if cols == (hi - lo) * hd and axes.index(axes.mp) * cols == lo * hd:
            return w
        w = SH.all_gather(w, axes, axes.mp, 1)
    return w[:, lo * hd:hi * hd]


def _qkv(p, cfg: L.AttnConfig, x: torch.Tensor, positions: torch.Tensor, axes: MeshAxes,
         lo: int, hi: int):
    """This rank's query heads and kv heads [lo, hi), normed and rotated
    as ``layers._qkv``."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, -1, hd)
    kk = (x @ _kv_weight(p, "wk", axes, lo, hi, hd).to(x.dtype)).reshape(b, s, -1, hd)
    v = (x @ _kv_weight(p, "wv", axes, lo, hi, hd).to(x.dtype)).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q)
        kk = L.rmsnorm(p["k_norm"], kk)
    q = L.rope(q, positions, cfg.rope_theta)
    kk = L.rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _attend(p, cfg: L.AttnConfig, q, k, v, mask, axes: MeshAxes) -> torch.Tensor:
    """This rank's heads of masked attention, through its rows of ``wo``:
    a partial output (b, s, d) that sums over mp."""
    b, s, hl, _ = q.shape
    local = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=k.shape[2])
    probs = L._masked_softmax(L._gqa_scores(q, k, local), mask)
    return L._gqa_mix(probs, v, local).reshape(b, s, -1) @ p["wo"].to(q.dtype)


def _attention(p, cfg: L.AttnConfig, x, positions, axes: MeshAxes, window=None):
    _, _, lo, hi = _local_heads(cfg, axes)
    q, k, v = _qkv(p, cfg, x, positions, axes, lo, hi)
    return _attend(p, cfg, q, k, v, L.causal_mask(positions, window), axes)


def _ffn(lp, cfg: TransformerConfig, axes: MeshAxes, x: torch.Tensor) -> torch.Tensor:
    """The MLP or MoE block: a partial output over mp."""
    return moe_block(lp["moe"], cfg.moe, axes, x) if cfg.moe else L.mlp(lp["mlp"], x)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------


def _sp(cfg: TransformerConfig, axes: MeshAxes) -> bool:
    return cfg.seq_parallel and _mp(axes) > 1


def _layer_fwd(cfg: TransformerConfig, axes: MeshAxes, h, lp, positions):
    sp = _sp(cfg, axes)
    if cfg.seq_parallel:
        h = constrain(h, axes, "dp", "mp", None)
    else:
        h = constrain(h, axes, "dp", None, None)
    x = L.rmsnorm(lp["ln1"], _enter(h, axes, sp))
    h = h + _leave(_attention(lp["attn"], cfg.attn, x, positions, axes, cfg.window), axes, sp)
    x = L.rmsnorm(lp["ln2"], _enter(h, axes, sp))
    return h + _leave(_ffn(lp, cfg, axes, x), axes, sp)


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
    """The final-norm hidden states (b, s, d), whole on every rank of the
    model axis."""
    b, s = tokens.shape
    sp = _sp(cfg, axes)
    h = _embed(params["embed"], tokens, axes)
    if sp:
        h = SH.split(h, axes, axes.mp, 1)
    positions = _positions(b, s, tokens.device)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for lp in layer_list(params["layers"], cfg.n_layers):
        if remat:
            h = checkpoint(_layer_fwd, cfg, axes, h, lp, positions, use_reentrant=False)
        else:
            h = _layer_fwd(cfg, axes, h, lp, positions)
    return L.rmsnorm(params["ln_f"], _enter(h, axes, sp))


def loss_fn(params, cfg: TransformerConfig, axes: MeshAxes, tokens, labels):
    """The mean token cross entropy; over a mesh, this rank's share of it
    (its tokens' sum over the global count), which sums to the loss over
    the data-parallel ranks."""
    h = forward_hidden(params, cfg, axes, tokens)
    logits = constrain(L.logits_from_hidden(params["embed"], h), axes, "dp", None, "mp")
    if axes.world == 1:
        return L.cross_entropy(logits, labels, cfg.vocab)
    if _mp(axes) == 1:
        lf = logits.to(_F32)
        per = torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    else:
        per = _token_losses_tp(logits, labels, axes)
    return per.sum() / (per.numel() * axes.size(axes.resolve("dp")))


def grads_fn(params, cfg: TransformerConfig, axes: MeshAxes, tokens, labels, prepare=None):
    """(loss, grads) with optional gradient accumulation over microbatches
    (cfg.microbatches splits the batch axis; peak activation memory divides
    accordingly). Accumulated gradients are float32, as the reference's.
    ``prepare`` maps ``params`` to the tree the model reads, inside the
    differentiated function (ZeRO-3's all-gathers)."""
    def loss(p, t, l):
        return loss_fn(prepare(p) if prepare else p, cfg, axes, t, l)

    vg = value_and_grad(loss)
    if cfg.microbatches <= 1:
        return vg(params, tokens, labels)
    m = cfg.microbatches
    b = tokens.shape[0]
    if b % m:
        raise ValueError(f"grads_fn: batch {b} does not divide into {m} microbatches")
    tok_m = tokens.reshape(m, b // m, -1)
    lab_m = labels.reshape(m, b // m, -1)
    loss_sum = torch.zeros((), dtype=_F32, device=tokens.device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params)
    for i in range(m):
        li, g = vg(params, tok_m[i], lab_m[i])
        grads = tree_map(torch.add, grads, g)
        loss_sum = loss_sum + li
    return loss_sum / m, tree_map(lambda g: g / m, grads)


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------


def cache_shapes(cfg: TransformerConfig, batch: int, cache_len: int):
    """The cache as meta tensors (the reference's ``ShapeDtypeStruct``s)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (cfg.n_layers, batch, cache_len, kv, hd)
    return {
        "k": torch.empty(shape, dtype=_BF16, device="meta"),
        "v": torch.empty(shape, dtype=_BF16, device="meta"),
        "pos": torch.empty((cfg.n_layers, batch, cache_len), dtype=_I32, device="meta"),
    }


def cache_specs(axes: MeshAxes):
    """Batch over dp, the sequence over mp (split-K decode)."""
    dp, mp = axes.resolve("dp"), axes.mp
    return {"k": Spec(None, dp, mp, None, None), "v": Spec(None, dp, mp, None, None),
            "pos": Spec(None, dp, mp)}


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
    Cache length = prompt length. Over a mesh: this rank's vocabulary
    columns of the logits and its sequence slice of the cache."""
    b, s = tokens.shape
    acfg = cfg.attn
    h = _embed(params["embed"], tokens, axes)
    positions = _positions(b, s, tokens.device)
    mask = L.causal_mask(positions, cfg.window)
    _, _, lo, hi = _local_heads(acfg, axes)
    if s % _mp(axes):
        raise ValueError(f"cache: {s} positions do not divide over {_mp(axes)} ranks of "
                         f"{axes.mp!r}")
    sl = s // _mp(axes)
    seq = slice(axes.index(axes.mp) * sl, (axes.index(axes.mp) + 1) * sl)
    ks, vs = [], []
    for lp in layer_list(params["layers"], cfg.n_layers):
        h = constrain(h, axes, "dp", None, None)
        x = L.rmsnorm(lp["ln1"], h)
        q, k, v = _qkv(lp["attn"], acfg, x, positions, axes, 0, cfg.n_kv_heads)
        a = _attend(lp["attn"], acfg, q, k[:, :, lo:hi], v[:, :, lo:hi], mask, axes)
        h = h + SH.all_reduce(a, axes, axes.mp)
        h = h + SH.all_reduce(_ffn(lp, cfg, axes, L.rmsnorm(lp["ln2"], h)), axes, axes.mp)
        ks.append(k[:, seq])
        vs.append(v[:, seq])
    h = L.rmsnorm(params["ln_f"], h)
    logits = L.logits_from_hidden(params["embed"], h[:, -1:, :])
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "pos": _positions(b, s, tokens.device)[:, seq].expand(cfg.n_layers, b, -1).clone(),
    }
    return logits, cache


def _attention_decode(p, cfg: L.AttnConfig, x, ck, cv, cp, positions, axes: MeshAxes):
    """One token against a cache split over the sequence on mp: the query
    heads and the new key and value are all-gathered, the token is written
    by the rank that owns its slot, each rank's partial softmax over its
    slice is combined by log-sum-exp (max, then sums of the rescaled
    weights and of the weighted values), and the rank's heads go through
    its rows of ``wo``: a partial output that sums over mp."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h0, hl, _, _ = _local_heads(cfg, axes)
    q = (x @ p["wq"].to(x.dtype)).reshape(b, 1, hl, hd)
    k_new = SH.all_gather(x @ p["wk"].to(x.dtype), axes, axes.mp, 2).reshape(b, 1, kv, hd)
    v_new = SH.all_gather(x @ p["wv"].to(x.dtype), axes, axes.mp, 2).reshape(b, 1, kv, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q)
        k_new = L.rmsnorm(p["k_norm"], k_new)
    q = SH.all_gather(L.rope(q, positions, cfg.rope_theta), axes, axes.mp, 2)
    k_new = L.rope(k_new, positions, cfg.rope_theta)

    sl = ck.shape[1]
    slot = torch.remainder(positions[:, 0], sl * _mp(axes)).long()
    own = (slot // sl) == axes.index(axes.mp)
    li = slot % sl
    rows = torch.arange(b, device=x.device)
    ck[rows, li] = torch.where(own[:, None, None], k_new[:, 0], ck[rows, li])
    cv[rows, li] = torch.where(own[:, None, None], v_new[:, 0], cv[rows, li])
    cp[rows, li] = torch.where(own, positions[:, 0].to(cp.dtype), cp[rows, li])

    scores = L._gqa_scores(q, ck, cfg)  # (b, 1, h, S_local)
    valid = (cp >= 0) & (cp <= positions[:, :1])
    scores = torch.where(valid[:, None, None, :], scores, L.NEG)
    m = SH.all_reduce(scores.amax(-1, keepdim=True), axes, axes.mp, op="max")
    e = torch.exp(scores - m)
    den = SH.all_reduce(e.sum(-1, keepdim=True), axes, axes.mp)
    g = h // kv
    o = torch.einsum("bqkgs,bskh->bqkgh", e.reshape(b, 1, kv, g, sl), cv.to(_F32))
    o = SH.all_reduce(o.reshape(b, 1, h, hd), axes, axes.mp) / den
    out = o[:, :, h0:h0 + hl].to(x.dtype).reshape(b, 1, hl * hd)
    return out @ p["wo"].to(x.dtype)


def decode_step(params, cfg: TransformerConfig, axes: MeshAxes, cache, token: torch.Tensor,
                pos: torch.Tensor):
    """token: (b, 1) int32; pos: (b, 1) int32 absolute position (-1: the
    row writes the dump slot and attends to nothing it keeps).
    Returns (logits (b, 1, V), cache): the cache is updated in place, a
    rolling buffer of length cache_len (= window for sliding-window
    serving). Over a mesh: this rank's vocabulary columns of the logits;
    the cache is its sequence slice."""
    h = _embed(params["embed"], token, axes)
    for i, lp in enumerate(layer_list(params["layers"], cfg.n_layers)):
        h = constrain(h, axes, "dp", None, None)
        x = L.rmsnorm(lp["ln1"], h)
        if _mp(axes) == 1:
            a, _, _, _ = L.attention_decode(lp["attn"], cfg.attn, x, cache["k"][i],
                                            cache["v"][i], cache["pos"][i], pos)
        else:
            a = SH.all_reduce(_attention_decode(lp["attn"], cfg.attn, x, cache["k"][i],
                                                cache["v"][i], cache["pos"][i], pos, axes),
                              axes, axes.mp)
        h = h + a
        h = h + SH.all_reduce(_ffn(lp, cfg, axes, L.rmsnorm(lp["ln2"], h)), axes, axes.mp)
    h = L.rmsnorm(params["ln_f"], h)
    logits = L.logits_from_hidden(params["embed"], h)
    logits = constrain(logits, axes, "dp", None, "mp")
    return logits, cache
