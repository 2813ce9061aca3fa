"""Mixture-of-Experts FFN block (the reference's ``models/moe.py``): top-k
routing with capacity-based scatter dispatch (GShard-style capacity,
sort-free placement).

Tokens go into per-expert buffers of static capacity
C = ceil(tokens * top_k / E * capacity_factor) (overflow dropped, probs
renormalised over the top k), the expert FFNs run as one batched product
over the stacked (E, d, f) weights, and the results are added back
weighted by the router probabilities. A Switch-style load-balancing loss
is ``load_balance_loss``.

Only kept assignments are written into the buffers. The reference also
writes every dropped assignment, as a zero row, into (expert 0, slot
C - 1); where expert 0's last slot holds a kept token, that token's
expert-0 output is then lost. The port computes that token's output, and
is held to the reference where the reference keeps it.

Over a mesh the experts are split over mp and the tokens, whole on every
rank of the model axis, over dp. Each rank routes every token, places only
the assignments to its own experts and returns a partial output that sums
over mp (the caller's all-reduce; shared experts are split over ``d_ff``
like an MLP). ``impl="ep_psum"`` ranks and caps the assignments among the
rank's own tokens, as the reference's ``shard_map`` does; ``"scatter"``
among all the data-parallel ranks' tokens, as its global capacity scatter
does: the per-expert counts of the earlier ranks are all-gathered and
offset the slots, and the capacity is that of the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, silu
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import MeshAxes

_F32, _I64 = torch.float32, torch.int64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0  # dense always-on experts (DeepSeek-style)
    # dispatch implementation: "scatter" (capacity scatter) or "ep_psum"
    # (expert parallelism: each rank computes its expert shard, one sum
    # over the ranks combines them)
    impl: str = "scatter"


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, device=None,
             dtype=_F32) -> Dict:
    e, f = cfg.n_experts, cfg.d_expert_ff
    p = {
        "w_router": _dense_init(gen, (d_model, e), device=device, dtype=dtype),
        "experts": {
            "w_gate": _dense_init(gen, (e, d_model, f), device=device, dtype=dtype),
            "w_up": _dense_init(gen, (e, d_model, f), device=device, dtype=dtype),
            "w_down": _dense_init(gen, (e, f, d_model), device=device, dtype=dtype),
        },
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": _dense_init(gen, (d_model, fs), device=device, dtype=dtype),
            "w_up": _dense_init(gen, (d_model, fs), device=device, dtype=dtype),
            "w_down": _dense_init(gen, (fs, d_model), device=device, dtype=dtype),
        }
    return p


def moe_block(p, cfg: MoEConfig, axes: MeshAxes, x: torch.Tensor) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d); over a mesh, this rank's partial output."""
    if cfg.impl not in ("scatter", "ep_psum"):
        raise ValueError(f"moe_block: unknown impl {cfg.impl!r}")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    _, top_p, top_e = route(p, cfg, xt)
    slot = expert_slots(top_e, cfg.n_experts)
    n_tokens = b * s
    tokens = axes.resolve("dp") if axes.batch_split else None
    if cfg.impl == "scatter" and axes.size(tokens) > 1:
        # slots among every data-parallel rank's tokens, in rank order
        flat = top_e.reshape(-1)
        counts = torch.zeros(cfg.n_experts, dtype=flat.dtype, device=flat.device)
        counts = counts.scatter_add_(0, flat, torch.ones_like(flat))
        every = SH.all_gather(counts[None], axes, tokens, 0)
        before = every[: axes.index(tokens)].sum(0)
        slot = slot + before[top_e.reshape(-1)]
        n_tokens *= axes.size(tokens)
    if cfg.n_experts % axes.size(axes.mp):
        raise ValueError(f"experts: {cfg.n_experts} do not divide over {axes.size(axes.mp)} ranks "
                         f"of {axes.mp!r}")
    e_local = cfg.n_experts // axes.size(axes.mp)
    out = _dispatch(xt, top_p, top_e, slot, capacity(n_tokens, cfg), p["experts"],
                    axes.index(axes.mp) * e_local, e_local)
    if cfg.n_shared_experts:
        out = out + _shared(p, xt)
    return out.reshape(b, s, d)


def route(p, cfg: MoEConfig, xt: torch.Tensor):
    """Router probabilities (n, E) float32 and the top-k (probs
    renormalised, experts), as ``jax.lax.top_k`` orders them."""
    logits = (xt @ p["w_router"].to(xt.dtype)).to(_F32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    return int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def expert_slots(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's slot in its expert's buffer: its rank among the
    expert's assignments in token order (a stable sort of the flattened
    experts)."""
    flat_e = top_e.reshape(-1)
    nk = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype,
                                                      device=top_e.device))
    rank_sorted = torch.arange(nk, dtype=_I64, device=top_e.device) - start[sorted_e]
    return torch.empty(nk, dtype=_I64, device=top_e.device).scatter_(0, order, rank_sorted)


def _dispatch(xt, top_p, top_e, slot, cap: int, we, e_lo: int, e_local: int) -> torch.Tensor:
    """The assignments to experts [e_lo, e_lo + e_local) with a slot below
    ``cap`` through those experts' FFNs (``we``: their stacked weights),
    added into their tokens weighted by their router probabilities."""
    n, d = xt.shape
    k = top_e.shape[1]
    flat_e = top_e.reshape(-1) - e_lo
    keep = (flat_e >= 0) & (flat_e < e_local) & (slot < cap)
    token_idx = torch.arange(n, device=xt.device).repeat_interleave(k)

    # kept assignments into their (expert, slot) rows; the others into one
    # row past the buffers, discarded (no host read of the count)
    dump = e_local * cap
    dest = torch.where(keep, flat_e * cap + slot, dump)
    buf = torch.zeros((dump + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((dest,), xt[token_idx])
    buf = buf[:dump].reshape(e_local, cap, d)

    g = silu(torch.bmm(buf, we["w_gate"].to(xt.dtype)))
    u = torch.bmm(buf, we["w_up"].to(xt.dtype))
    y = torch.bmm(g * u, we["w_down"].to(xt.dtype))

    # combine: each assignment's expert output weighted by its router prob,
    # added into its token in assignment order
    safe = torch.where(keep, dest, 0)
    out_flat = y.reshape(dump, d)[safe]
    w = torch.where(keep, top_p.reshape(-1), 0.0).to(xt.dtype)
    parts = (out_flat * w[:, None]).reshape(n, k, d)
    out = torch.zeros((n, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        out = out + parts[:, j]
    return out


def _shared(p, xt: torch.Tensor) -> torch.Tensor:
    sh = p["shared"]
    gs = silu(xt @ sh["w_gate"].to(xt.dtype))
    us = xt @ sh["w_up"].to(xt.dtype)
    return (gs * us) @ sh["w_down"].to(xt.dtype)


def load_balance_loss(router_probs: torch.Tensor, top_e: torch.Tensor, n_experts: int):
    """Switch-transformer aux loss: E * sum_e f_e * P_e."""
    me = torch.mean(F.one_hot(top_e[..., 0].long(), n_experts).to(_F32), dim=0)
    pe = torch.mean(router_probs, dim=0)
    return n_experts * torch.sum(me * pe)
