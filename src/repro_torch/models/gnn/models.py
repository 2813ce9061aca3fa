"""The four GNN architectures (the reference's ``models/gnn/models.py``) on
PyTorch.

  graphsage-reddit  [arXiv:1706.02216]  2L, d=128, mean aggregator, 25-10 fanout
  gat-cora          [arXiv:1710.10903]  2L, d=8, 8 heads, attention aggregator
  gin-tu            [arXiv:1810.00826]  5L, d=64, sum aggregator, learnable eps
  dimenet           [arXiv:2003.03123]  6 blocks, d=128, bilinear=8, sph=7, rad=6

All take a graph of padded static shapes: node features (N, F), edge lists
``edge_src`` / ``edge_dst`` (E,) int32 with -1 padding, labels and a label
mask, and for DimeNet 3-D positions and triplet lists. Each has
``init(gen, cfg, shape, device)``, ``apply(params, cfg, g)`` and
``loss(params, cfg, g)``. Parameters are dicts (and lists) of tensors with
the reference's names and shapes; ``init`` draws from a
``torch.Generator``, so its values are not the reference's
(``convert.gnn_params_from_arrays`` carries those across).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.models.gnn import common as C
from repro_torch.models.layers import silu
from repro_torch.parallel import sharding as SH

_F32, _I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class GraphShape:
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 16
    n_triplets: int = 0  # DimeNet only
    n_graphs: int = 1  # batched molecule graphs


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # graphsage | gat | gin | dimenet
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "mean"
    # dimenet extras
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6


def _generator(gen: Union[int, torch.Generator], dev: torch.device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=dev).manual_seed(int(gen))


def make_graph_inputs(shape: GraphShape, rng_seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """A random graph of ``shape`` on ``device`` (None is the CUDA card),
    drawn from a generator seeded with ``rng_seed``."""
    dev = resolve_device(device)
    gen = _generator(rng_seed, dev)
    n, e = shape.n_nodes, shape.n_edges

    def ints(size, hi):
        return torch.randint(0, hi, (size,), generator=gen, dtype=_I32, device=dev)

    g = {
        "x": torch.randn((n, shape.d_feat), generator=gen, dtype=_F32, device=dev),
        "edge_src": ints(e, n),
        "edge_dst": ints(e, n),
        "labels": ints(n, shape.n_classes),
        "label_mask": torch.ones((n,), dtype=_F32, device=dev),
    }
    if shape.n_triplets:
        # triplets (k->j->i): indices into the edge list
        g["trip_kj"] = ints(shape.n_triplets, e)
        g["trip_ji"] = ints(shape.n_triplets, e)
        g["pos"] = torch.randn((n, 3), generator=gen, dtype=_F32, device=dev)
    return g


def graph_input_shapes(shape: GraphShape) -> Dict[str, torch.Tensor]:
    """The inputs of ``make_graph_inputs`` as meta tensors (the
    reference's ``graph_input_specs``)."""
    def meta(size, dtype):
        return torch.empty(size, dtype=dtype, device="meta")

    s = {
        "x": meta((shape.n_nodes, shape.d_feat), _F32),
        "edge_src": meta((shape.n_edges,), _I32),
        "edge_dst": meta((shape.n_edges,), _I32),
        "labels": meta((shape.n_nodes,), _I32),
        "label_mask": meta((shape.n_nodes,), _F32),
    }
    if shape.n_triplets:
        s["trip_kj"] = meta((shape.n_triplets,), _I32)
        s["trip_ji"] = meta((shape.n_triplets,), _I32)
        s["pos"] = meta((shape.n_nodes, 3), _F32)
    return s


# ---------------------------------------------------------------------------
# GraphSAGE (mean aggregator)
# ---------------------------------------------------------------------------


def init_graphsage(gen, cfg: GNNConfig, shape: GraphShape, device):
    dims = [shape.d_feat] + [cfg.d_hidden] * cfg.n_layers
    layers = [{"w_self": C._dense(gen, (dims[i], dims[i + 1]), device=device),
               "w_neigh": C._dense(gen, (dims[i], dims[i + 1]), device=device)}
              for i in range(cfg.n_layers)]
    return {"layers": layers,
            "w_out": C._dense(gen, (cfg.d_hidden, shape.n_classes), device=device)}


def apply_graphsage(params, cfg: GNNConfig, g, shards: C.Shards = C.LOCAL):
    x = g["x"]
    n = x.shape[0] * shards.ranks
    for lp in params["layers"]:
        msgs = C.gather_src(shards.gather(x), g["edge_src"])
        agg = C.scatter_mean(msgs, g["edge_dst"], n, shards)
        x = torch.relu(x @ lp["w_self"] + agg @ lp["w_neigh"])
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)
    return x @ params["w_out"]


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------


def init_gat(gen, cfg: GNNConfig, shape: GraphShape, device):
    layers = []
    d_in = shape.d_feat
    for i in range(cfg.n_layers):
        h = cfg.n_heads if i < cfg.n_layers - 1 else 1
        d_out = cfg.d_hidden if i < cfg.n_layers - 1 else shape.n_classes
        layers.append({
            "w": C._dense(gen, (d_in, h * d_out), device=device),
            "a_src": C._dense(gen, (h, d_out), device=device),
            "a_dst": C._dense(gen, (h, d_out), device=device),
        })
        d_in = h * d_out
    return {"layers": layers}


def apply_gat(params, cfg: GNNConfig, g, shards: C.Shards = C.LOCAL):
    x = g["x"]
    nl = x.shape[0]
    n = nl * shards.ranks
    n_layers = len(params["layers"])
    src, dst = g["edge_src"], g["edge_dst"]
    ssafe, dsafe = torch.clamp(src, min=0).long(), torch.clamp(dst, min=0).long()
    for i, lp in enumerate(params["layers"]):
        h, d_out = lp["a_src"].shape
        z = shards.gather((x @ lp["w"]).reshape(nl, h, d_out))
        s_src = torch.einsum("nhd,hd->nh", z, lp["a_src"])
        s_dst = torch.einsum("nhd,hd->nh", z, lp["a_dst"])
        scores = F.leaky_relu(s_src[ssafe] + s_dst[dsafe], 0.2)  # (E, H)
        alpha = C.edge_softmax(scores, dst, n, shards)  # (E, H)
        msgs = z[ssafe] * alpha[:, :, None]  # (E, H, D)
        agg = shards.reduce(C.scatter_sum(msgs.reshape(-1, h * d_out), dst, n))
        agg = agg.reshape(nl, h, d_out)
        if i < n_layers - 1:
            x = F.elu(agg).reshape(nl, h * d_out)
        else:
            x = agg.mean(dim=1)
    return x


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------


def init_gin(gen, cfg: GNNConfig, shape: GraphShape, device):
    dims = [shape.d_feat] + [cfg.d_hidden] * cfg.n_layers
    layers = [{"eps": torch.zeros((), dtype=_F32, device=device),  # learnable
               "w1": C._dense(gen, (dims[i], cfg.d_hidden), device=device),
               "w2": C._dense(gen, (cfg.d_hidden, dims[i + 1]), device=device)}
              for i in range(cfg.n_layers)]
    return {"layers": layers,
            "w_out": C._dense(gen, (cfg.d_hidden, shape.n_classes), device=device)}


def apply_gin(params, cfg: GNNConfig, g, shards: C.Shards = C.LOCAL):
    x = g["x"]
    n = x.shape[0] * shards.ranks
    for lp in params["layers"]:
        msgs = C.gather_src(shards.gather(x), g["edge_src"])
        agg = shards.reduce(C.scatter_sum(msgs, g["edge_dst"], n))
        h = (1.0 + lp["eps"]) * x + agg
        x = torch.relu(torch.relu(h @ lp["w1"]) @ lp["w2"])
    return x @ params["w_out"]


# ---------------------------------------------------------------------------
# DimeNet (directional message passing; the reference's simplified basis)
# ---------------------------------------------------------------------------


def init_dimenet(gen, cfg: GNNConfig, shape: GraphShape, device):
    d = cfg.d_hidden
    p = {
        "embed_x": C._dense(gen, (shape.d_feat, d), device=device),
        "rbf_w": C._dense(gen, (cfg.n_radial, d), device=device),
        "edge_mlp": C._dense(gen, (3 * d, d), device=device),
        "blocks": [],
        "out_w1": C._dense(gen, (d, d), device=device),
        "out_w2": C._dense(gen, (d, shape.n_classes), device=device),
    }
    for _ in range(cfg.n_layers):
        p["blocks"].append({
            "w_kj": C._dense(gen, (d, d), device=device),
            "w_sbf": C._dense(gen, (cfg.n_spherical * cfg.n_radial, cfg.n_bilinear),
                              device=device),
            "w_bil": torch.randn((cfg.n_bilinear, d, d), generator=gen, dtype=_F32,
                                 device=device) / math.sqrt(d),
            "w_rbf": C._dense(gen, (cfg.n_radial, d), device=device),
            "w_upd1": C._dense(gen, (d, d), device=device),
            "w_upd2": C._dense(gen, (d, d), device=device),
        })
    return p


def _bessel_rbf(dist: torch.Tensor, n_radial: int, cutoff: float = 5.0) -> torch.Tensor:
    """sin(n pi d/c)/d radial basis [DimeNet eq. 7]."""
    d = torch.clamp(dist, min=1e-3)[:, None]
    n = torch.arange(1, n_radial + 1, dtype=_F32, device=dist.device)[None, :]
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d


def _angular_sbf(angle, dist, n_spherical: int, n_radial: int, cutoff: float = 5.0):
    """The reference's simplified spherical basis: cos(l*angle) x Bessel(d)
    outer products."""
    ls = torch.arange(n_spherical, dtype=_F32, device=angle.device)[None, :]
    ca = torch.cos(angle[:, None] * ls)
    rb = _bessel_rbf(dist, n_radial, cutoff)  # (T, n_radial)
    return (ca[:, :, None] * rb[:, None, :]).reshape(angle.shape[0], -1)


def apply_dimenet(params, cfg: GNNConfig, g, shards: C.Shards = C.LOCAL):
    node_out = dimenet_node_messages(params, cfg, g, shards)
    h = silu(node_out @ params["out_w1"])
    return h @ params["out_w2"]


def dimenet_node_messages(params, cfg: GNNConfig, g, shards: C.Shards = C.LOCAL):
    """Everything up to (and including) the edge→node scatter. With
    ``shards`` the node, edge and triplet rows are this rank's (triplets
    index the global edge list): node embeddings and positions, edge
    vectors and each block's kj messages are all-gathered, and the
    triplet-to-edge and edge-to-node sums reduce-scattered to this rank's
    rows."""
    x = shards.gather(g["x"] @ params["embed_x"])  # (N, d)
    pos = shards.gather(g["pos"])
    src, dst = g["edge_src"], g["edge_dst"]
    ssafe, dsafe = torch.clamp(src, min=0).long(), torch.clamp(dst, min=0).long()
    evalid = (src >= 0)[:, None]

    dvec = pos[dsafe] - pos[ssafe]  # (E, 3)
    dist = torch.linalg.vector_norm(dvec + 1e-9, dim=-1)
    rbf = _bessel_rbf(dist, cfg.n_radial)  # (E, n_radial)

    m = torch.cat([x[ssafe], x[dsafe], rbf @ params["rbf_w"]], dim=-1)
    m = silu(m @ params["edge_mlp"]) * evalid  # (E, d) edge messages

    kj, ji = torch.clamp(g["trip_kj"], min=0).long(), torch.clamp(g["trip_ji"], min=0).long()
    tvalid = (g["trip_kj"] >= 0) & (g["trip_ji"] >= 0)
    dvec_all, dist_all = shards.gather(dvec), shards.gather(dist)
    # angle between edge kj and edge ji
    v1, v2 = dvec_all[kj], dvec_all[ji]
    cosang = torch.sum(v1 * v2, -1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1), min=1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = _angular_sbf(angle, dist_all[kj], cfg.n_spherical, cfg.n_radial)  # (T, S*R)

    n_edges = src.shape[0] * shards.ranks
    for blk in params["blocks"]:
        # directional message passing: edge kj -> edge ji modulated by angle
        mk = shards.gather(silu(m @ blk["w_kj"]))[kj]  # (T, d)
        sb = sbf @ blk["w_sbf"]  # (T, n_bilinear)
        inter = torch.einsum("tb,bde,td->te", sb, blk["w_bil"], mk)  # (T, d)
        inter = torch.where(tvalid[:, None], inter, 0.0)
        agg = shards.reduce(torch.zeros((n_edges, inter.shape[1]), dtype=inter.dtype,
                                        device=inter.device).index_add(0, ji, inter))  # (E, d)
        upd = m + silu((agg + rbf @ blk["w_rbf"]) @ blk["w_upd1"])
        m = silu(upd @ blk["w_upd2"]) * evalid

    return shards.reduce(C.scatter_sum(m, dst, x.shape[0]))


EDGE_KEYS = ("edge_src", "edge_dst", "trip_kj", "trip_ji")


def dimenet_loss_partitioned(params, cfg: GNNConfig, g, axes: SH.MeshAxes, entry):
    """The reference's edge-partitioned DimeNet (DistDGL-style locality),
    one rank's program: node features, positions and labels whole on every
    rank; this rank's block of the edge and triplet arrays (split over the
    mesh ``entry``, every axis in the reference), with the locality
    contract that its triplets index its own edge block. All directional
    message passing is local; the one collective is the sum of the (N, d)
    node partials over the entry, whose gradient is summed too. The loss
    after it is the same on every rank, so each returns its share (over the
    entry's ranks), and the gradients sum over them."""
    node_out = C.Shards(axes, entry).psum(dimenet_node_messages(params, cfg, g))
    h = silu(node_out @ params["out_w1"])
    loss = C.cross_entropy_nodes(h @ params["out_w2"], g["labels"], g.get("label_mask"))
    return loss / axes.size(entry)


# ---------------------------------------------------------------------------
# dispatch + loss
# ---------------------------------------------------------------------------

_INIT = {
    "graphsage": init_graphsage,
    "gat": init_gat,
    "gin": init_gin,
    "dimenet": init_dimenet,
}
_APPLY = {
    "graphsage": apply_graphsage,
    "gat": apply_gat,
    "gin": apply_gin,
    "dimenet": apply_dimenet,
}


def init(gen: Union[int, torch.Generator], cfg: GNNConfig, shape: GraphShape, device=None):
    """Parameters on ``device`` (None is the CUDA card) drawn from ``gen``
    (a generator on that device, or a seed for one)."""
    dev = resolve_device(device)
    return _INIT[cfg.kind](_generator(gen, dev), cfg, shape, dev)


def param_shapes(cfg: GNNConfig, shape: GraphShape):
    """The parameter tree as meta tensors (nothing allocated)."""
    return init(torch.Generator(), cfg, shape, device="meta")


def apply(params, cfg: GNNConfig, g, shards: C.Shards = C.LOCAL):
    """Logits of the nodes; with ``shards``, of this rank's node rows."""
    return _APPLY[cfg.kind](params, cfg, g, shards)


def loss(params, cfg: GNNConfig, g, shards: C.Shards = C.LOCAL):
    """The masked node cross entropy; with ``shards`` (node and edge rows
    split over a mesh entry, the reference's ``dp+mp`` layout), this rank's
    share of it: its node rows' sum over every rank's count."""
    logits = apply(params, cfg, g, shards)
    return C.cross_entropy_nodes(logits, g["labels"], g.get("label_mask"), shards)
