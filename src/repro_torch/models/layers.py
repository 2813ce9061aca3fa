"""Shared transformer layers (the reference's ``models/layers.py``):
RMSNorm, rotary embedding, GQA attention (optionally qk-norm, sliding
window), SwiGLU MLP, embedding, cross entropy. Functions on tensors with
the reference's names: ``init_*`` returns a dict of parameters, and the
matching function takes ``(params, x, ...)``.

Mixed precision as in the reference: parameters float32 (a server may
hold the matmul weights in bfloat16, the same values its casts give),
activations bfloat16 (each weight cast to the activation's dtype at its
matmul), norms, RoPE, softmax and logsumexp in float32. Attention is
written out (``einsum`` and a softmax masked at -1e30, not a fused
attention call, whose masking and precision differ); its scores are float32
products of float32 copies of q and k, as the reference's
``preferred_element_type=float32``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

_F32, _BF16 = torch.float32, torch.bfloat16
NEG = -1e30  # the mask value of a score


def _dense_init(gen: torch.Generator, shape, scale=None, device=None, dtype=_F32):
    if device is not None and torch.device(device).type == "meta":  # shapes only
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=_F32, device=device) * scale
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, device=None):
    return {"scale": torch.ones((dim,), dtype=_F32, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    ``x1 * cos`` promotes to float32, as in JAX."""
    hd = x.shape[-1]
    half = hd // 2
    # theta stays a Python number: a tensor made from it would be a
    # host-to-device copy, a host sync on the card, twice a layer
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=_F32, device=x.device) / half))
    ang = positions[..., None].to(_F32) * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + optional qk-norm)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    use_bias: bool = False


def init_attention(gen: torch.Generator, cfg: AttnConfig, device=None, dtype=_F32):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, h * hd), device=device, dtype=dtype),
        "wk": _dense_init(gen, (d, k * hd), device=device, dtype=dtype),
        "wv": _dense_init(gen, (d, k * hd), device=device, dtype=dtype),
        "wo": _dense_init(gen, (h * hd, d), device=device, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device)
        p["k_norm"] = init_rmsnorm(hd, device)
    return p


def _qkv(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    kk = (x @ p["wk"].to(x.dtype)).reshape(b, s, k, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, k, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        kk = rmsnorm(p["k_norm"], kk)
    q = rope(q, positions, cfg.rope_theta)
    kk = rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """q: (b, sq, h, hd), k: (b, sk, kv, hd) -> (b, sq, h, sk) float32."""
    b, sq, h, hd = q.shape
    kv = cfg.n_kv_heads
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd).to(_F32)
    s = torch.einsum("bqkgh,bskh->bqkgs", qg, k.to(_F32))
    return s.reshape(b, sq, h, k.shape[1]) / math.sqrt(hd)


def _gqa_mix(probs: torch.Tensor, v: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """probs: (b, sq, h, sk) float32, v: (b, sk, kv, hd) -> (b, sq, h, hd)."""
    b, sq, h, sk = probs.shape
    kv = cfg.n_kv_heads
    g = h // kv
    pg = probs.reshape(b, sq, kv, g, sk)
    out = torch.einsum("bqkgs,bskh->bqkgh", pg.to(v.dtype), v)
    return out.reshape(b, sq, h, -1)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.softmax(torch.where(mask, scores, NEG), dim=-1)


def causal_mask(positions: torch.Tensor, window: Optional[int] = None,
                causal: bool = True) -> torch.Tensor:
    """(b, s, 1, s) keys each query may see; positions (b, s)."""
    ii = positions[:, :, None, None]  # query pos
    jj = positions[:, None, None, :]  # key pos
    mask = jj <= ii if causal else torch.ones_like(jj <= ii)
    if window is not None:
        mask = mask & (jj > ii - window)
    return mask


def attention(p, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Full self-attention over x: (b, s, d)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    scores = _gqa_scores(q, k, cfg)
    probs = _masked_softmax(scores, causal_mask(positions, window, causal))
    out = _gqa_mix(probs, v, cfg)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def attention_decode(p, cfg: AttnConfig, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor, positions: torch.Tensor):
    """One-token decode: x (b, 1, d); cache_{k,v} (b, S, kv, hd) already
    rope'd; cache_pos (b, S) int32 key positions (-1 = empty slot). The
    token is written at slot ``positions % S`` (a rolling buffer for a
    sliding window; position -1 lands in slot S - 1, the dump slot), into
    the caches given. Returns (out, cache_k, cache_v, cache_pos)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    slot = torch.remainder(positions[:, 0], cache_k.shape[1]).long()
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k_new[:, 0]
    cache_v[rows, slot] = v_new[:, 0]
    cache_pos[rows, slot] = positions[:, 0].to(cache_pos.dtype)

    scores = _gqa_scores(q, cache_k, cfg)  # (b, 1, h, S)
    valid = (cache_pos >= 0) & (cache_pos <= positions[:, :1])
    probs = _masked_softmax(scores, valid[:, None, None, :])
    out = _gqa_mix(probs, cache_v, cfg)
    out = out.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v, cache_pos


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, device=None, dtype=_F32):
    return {
        "w_gate": _dense_init(gen, (d_model, d_ff), device=device, dtype=dtype),
        "w_up": _dense_init(gen, (d_model, d_ff), device=device, dtype=dtype),
        "w_down": _dense_init(gen, (d_ff, d_model), device=device, dtype=dtype),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.reciprocal(1 + torch.exp(-x))


class _SiLU(torch.autograd.Function):
    """``_silu`` with the derivative ``s (1 + x (1 - s))``, s the sigmoid:
    differentiating ``_silu`` itself gives 0 * inf = NaN where ``exp(-x)``
    overflows (x below about -88 in float32)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _silu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * (s * (1 + x * (1 - s)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    step in ``x``'s dtype: how the reference's ``jax.nn.silu`` evaluates a
    bfloat16 tensor (``F.silu`` rounds once and differs in the last bit).
    Under autograd its derivative is the sigmoid's closed form, finite
    everywhere, as the reference's."""
    if x.requires_grad and torch.is_grad_enabled():
        return _SiLU.apply(x)
    return _silu(x)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    g = silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding + loss
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, device=None, dtype=_F32):
    return {"table": _dense_init(gen, (vocab, d_model), scale=0.02, device=device, dtype=dtype)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()].to(_BF16)


def logits_from_hidden(p_embed, h: torch.Tensor) -> torch.Tensor:
    return h @ p_embed["table"].T.to(h.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean over tokens of logsumexp(logits) - logits[label], in float32."""
    lf = logits.to(_F32)
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - label_logit)
