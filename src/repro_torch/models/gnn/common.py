"""GNN message-passing primitives (the reference's ``models/gnn/common.py``)
on PyTorch.

Message passing is an edge-index gather, a transform, and a scatter over
node ids. Edge lists have static shapes with -1 padding: a padded edge
gathers zeros and scatters into a dump row past the last node, which is
dropped. Sums are ``index_add`` (on the card the adds land in no fixed
order, as XLA's ``segment_sum`` on a TPU); maxima are ``scatter_reduce``
with ``amax``, whose gradient, as the reference's, is split evenly over
ties.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.parallel import sharding as SH

_F32 = torch.float32


class Shards:
    """How one rank holds a graph's node (and edge) rows: split over the
    mesh entry ``entry`` in rank order, or whole (``LOCAL``: one rank, or
    rows every rank holds). Its methods are the identity where the entry
    has one rank.

      ``gather``  every rank's rows (all-gather; gradient reduce-scattered);
      ``reduce``  this rank's rows of a sum over the ranks of a whole-graph
                  partial (reduce-scatter; gradient all-gathered);
      ``psum``    a whole-graph partial summed over the ranks, its gradient
                  summed too;
      ``total``   a sum (or ``op="max"``) over the ranks, no gradient.
    """

    def __init__(self, axes: Optional[SH.MeshAxes] = None, entry=None):
        self.axes = axes or SH.MeshAxes()
        self.entry = entry

    @property
    def ranks(self) -> int:
        return self.axes.size(self.entry)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return SH.all_gather(x, self.axes, self.entry, 0)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return SH.reduce_scatter(x, self.axes, self.entry, 0)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return SH.all_reduce(x, self.axes, self.entry, grad="all_reduce")

    def total(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return SH.all_reduce(x.detach(), self.axes, self.entry, op=op)


LOCAL = Shards()


def _dense(gen: torch.Generator, shape, scale=None, device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=gen, dtype=_F32, device=device) * scale


def _dump(edge_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Destination rows with padding sent to the dump row ``n_nodes``."""
    return torch.where(edge_dst >= 0, edge_dst, n_nodes).long()


def gather_src(x: torch.Tensor, edge_src: torch.Tensor) -> torch.Tensor:
    """x: (N, F); edge_src: (E,) int32 with -1 padding -> (E, F)."""
    msg = x[torch.clamp(edge_src, min=0).long()]
    return torch.where((edge_src >= 0)[:, None], msg, 0.0)


def scatter_sum(msgs: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """msgs: (E, F) -> (N, F) summed per destination (padding -> dump row)."""
    out = torch.zeros((n_nodes + 1,) + tuple(msgs.shape[1:]), dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add(0, _dump(edge_dst, n_nodes), msgs)[:n_nodes]


def scatter_max(msgs: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-destination maximum; a node with no incoming edge (and any
    non-finite maximum) is 0, as in the reference."""
    idx = _dump(edge_dst, n_nodes)[:, None].expand_as(msgs)
    init = torch.full((n_nodes + 1,) + tuple(msgs.shape[1:]), -math.inf, dtype=msgs.dtype,
                      device=msgs.device)
    out = init.scatter_reduce(0, idx, msgs, "amax", include_self=True)[:n_nodes]
    return torch.where(torch.isfinite(out), out, 0.0)


def scatter_mean(msgs: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int,
                 shards: Shards = LOCAL) -> torch.Tensor:
    """Per-destination mean; with ``shards``, the mean over every rank's
    edges at this rank's rows."""
    s = shards.reduce(scatter_sum(msgs, edge_dst, n_nodes))
    ones = torch.where(edge_dst >= 0, 1.0, 0.0).to(msgs.dtype)[:, None]
    cnt = shards.reduce(scatter_sum(ones, edge_dst, n_nodes))
    return s / torch.clamp(cnt, min=1.0)


def edge_softmax(scores: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int,
                 shards: Shards = LOCAL) -> torch.Tensor:
    """Per-destination softmax over incoming edge scores.
    scores: (E, H) -> normalized (E, H). Padding edges get weight 0. The
    padded scores are masked before the ``exp`` (exp(-inf) = 0), so no
    branch autograd differentiates holds an infinity or a NaN. With
    ``shards`` the edges are this rank's and the maxima and sums run over
    every rank's (the shift carries no gradient there: the softmax does not
    depend on it)."""
    pad = (edge_dst < 0)[:, None]
    neg = torch.where(pad, -math.inf, scores)
    mx = scatter_max(neg, edge_dst, n_nodes)  # (N, H)
    if shards.ranks > 1:
        mx = shards.total(mx, op="max")
    safe = torch.clamp(edge_dst, min=0).long()
    shifted = torch.exp(torch.where(pad, -math.inf, scores - mx[safe]))
    shifted = torch.where(pad, 0.0, shifted)
    denom = shards.psum(scatter_sum(shifted, edge_dst, n_nodes))
    return shifted / torch.clamp(denom[safe], min=1e-16)


def degree_norm(edge_src: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """GCN-style 1/sqrt(d_i d_j) per edge."""
    ones = torch.where(edge_dst >= 0, 1.0, 0.0)[:, None]
    deg = scatter_sum(ones, edge_dst, n_nodes)[:, 0] + 1.0
    si = torch.clamp(edge_src, min=0).long()
    di = torch.clamp(edge_dst, min=0).long()
    return torch.rsqrt(deg[si] * deg[di])


def cross_entropy_nodes(logits: torch.Tensor, labels: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        shards: Shards = LOCAL) -> torch.Tensor:
    """The (masked) mean over nodes; with ``shards``, this rank's nodes'
    share of it (their sum over every rank's count)."""
    lf = logits.to(_F32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[:, None])[:, 0]
    per = lse - ll
    if mask is not None:
        return torch.sum(per * mask) / torch.clamp(shards.total(torch.sum(mask)), min=1.0)
    if shards.ranks > 1:
        return torch.sum(per) / (per.numel() * shards.ranks)
    return torch.mean(per)
