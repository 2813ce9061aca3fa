"""DCN-v2 [arXiv:2008.13535] (the reference's ``models/recsys/dcn.py``) on
PyTorch: 13 dense + 26 sparse features, embed_dim 16, 3 full-rank cross
layers, MLP 1024-1024-512, sigmoid CTR head.

Sparse embedding tables use Criteo-style vocab sizes (heavy-tailed; the
full tables hold 33,763,622 padded rows). Four shapes: train (65k batch),
p99 online (512), bulk offline scoring (262k), and retrieval scoring of 1M
candidates against one query via a dot-product tower (one batched matmul
and a top-k). Parameters are dicts of tensors with the reference's names;
``init_params`` draws from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.recsys.embedding import embedding_bag, init_table, qr_embedding_lookup
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import MeshAxes, Spec, constrain

_F32 = torch.float32

# Criteo Kaggle display-advertising vocab sizes (26 categorical fields),
# the standard rounded sizes of the DLRM reference implementations.
CRITEO_VOCABS: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
    5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
    7046547, 18, 15, 286181, 105, 142572,
)


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp_dims: Tuple[int, ...] = (1024, 1024, 512)
    vocab_sizes: Tuple[int, ...] = CRITEO_VOCABS
    max_table_rows: int = 0  # 0 = full Criteo sizes; >0 clips (smoke tests)
    table_dtype: str = "float32"  # bf16 halves table memory + grad traffic
    qr_threshold: int = 0  # >0: quotient-remainder for tables above this

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def table_rows(self, i: int) -> int:
        v = self.vocab_sizes[i % len(self.vocab_sizes)]
        return min(v, self.max_table_rows) if self.max_table_rows else v

    def padded_rows(self, i: int) -> int:
        """Tables of 16,384 rows and more pad to a multiple of 512 (the
        reference's row-sharding rule); lookups stay mod table_rows, so
        padding rows are never addressed."""
        v = self.table_rows(i)
        return int(-(-v // 512) * 512) if v >= 16384 else v


def _uses_qr(cfg: DCNConfig, i: int) -> bool:
    return bool(cfg.qr_threshold) and cfg.table_rows(i) > cfg.qr_threshold


_QR_COLLISIONS = 4096


def init_params(cfg: DCNConfig, gen: Union[int, torch.Generator], device=None) -> Dict:
    """Parameters on ``device`` (None is the CUDA card) drawn from ``gen``
    (a generator on that device, or a seed for one)."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    dt = torch.bfloat16 if cfg.table_dtype == "bf16" else _F32
    tables = {}
    for i in range(cfg.n_sparse):
        if _uses_qr(cfg, i):
            # quotient-remainder trick [arXiv:1909.02107]: two small tables
            q_rows = int(-(-cfg.table_rows(i) // _QR_COLLISIONS))
            q_rows = int(-(-q_rows // 512) * 512)
            tables[f"t{i}"] = {
                "q": init_table(gen, q_rows, cfg.embed_dim, device=dev).to(dt),
                "r": init_table(gen, _QR_COLLISIONS, cfg.embed_dim, device=dev).to(dt),
            }
        else:
            tables[f"t{i}"] = init_table(gen, cfg.padded_rows(i), cfg.embed_dim,
                                         device=dev).to(dt)
    d = cfg.d_interact
    cross = [{"w": torch.randn((d, d), generator=gen, dtype=_F32, device=dev) / math.sqrt(d),
              "b": torch.zeros((d,), dtype=_F32, device=dev)}
             for _ in range(cfg.n_cross_layers)]
    dims = (d,) + cfg.mlp_dims
    mlp = [{"w": torch.randn((dims[i], dims[i + 1]), generator=gen, dtype=_F32, device=dev)
            / math.sqrt(dims[i]),
            "b": torch.zeros((dims[i + 1],), dtype=_F32, device=dev)}
           for i in range(len(cfg.mlp_dims))]
    w_out = torch.randn((cfg.mlp_dims[-1] + d, 1), generator=gen, dtype=_F32, device=dev) * 0.01
    return {"tables": tables, "cross": cross, "mlp": mlp, "w_out": w_out}


def param_shapes(cfg: DCNConfig) -> Dict:
    """The parameter tree as meta tensors (nothing allocated)."""
    return init_params(cfg, torch.Generator(), device="meta")


def param_specs(cfg: DCNConfig, axes: MeshAxes):
    """Tables of 16,384 rows or more split by rows over mp; the rest (the
    small tables, the quotient-remainder sub-tables, the dense layers)
    replicated."""
    def rule(path, leaf):
        if path and path[0] == "tables" and leaf.dim() == 2:
            return Spec(axes.mp, None) if leaf.shape[0] >= 16384 else Spec(None, None)
        return Spec(*([None] * leaf.dim()))

    return SH.tree_spec(param_shapes(cfg), rule)


def features(params, cfg: DCNConfig, axes: MeshAxes, dense, sparse) -> torch.Tensor:
    """dense: (B, 13) float32; sparse: (B, 26) int32 -> (B, d_interact).
    Over a mesh the rows are this rank's batch; a table split over mp is
    looked up in this rank's rows (zeros elsewhere), and one all-reduce over
    mp adds the split tables' lookups, its gradient summed over mp too (the
    rank's loss is a share, as everything after it is replicated)."""
    mp = axes.size(axes.mp)
    embs, split = [], []
    for i in range(cfg.n_sparse):
        idx = sparse[:, i] % cfg.table_rows(i)
        t = params["tables"][f"t{i}"]
        if isinstance(t, dict):  # quotient-remainder compressed table
            e = qr_embedding_lookup(t["q"], t["r"], idx, _QR_COLLISIONS)
        elif mp > 1 and t.shape[0] * mp >= 16384:  # this rank's rows of a split table
            local = idx.long() - axes.index(axes.mp) * t.shape[0]
            mine = (local >= 0) & (local < t.shape[0])
            e = torch.where(mine[:, None], embedding_bag(t, torch.where(mine, local, 0)), 0.0)
            split.append(i)
        else:
            e = embedding_bag(t, idx)  # (B, dim) bag of 1
        embs.append(e.to(_F32))
    if split:
        summed = SH.all_reduce(torch.stack([embs[i] for i in split]), axes, axes.mp,
                               grad="all_reduce")
        for j, i in enumerate(split):
            embs[i] = summed[j]
    x = torch.cat([torch.log1p(torch.abs(dense))] + embs, dim=-1)
    return constrain(x, axes, "dp", None)


def interact(params, cfg: DCNConfig, x0: torch.Tensor) -> torch.Tensor:
    """DCN-v2 cross network: x_{l+1} = x0 * (W x_l + b) + x_l, then MLP."""
    x = x0
    for lp in params["cross"]:
        x = x0 * (x @ lp["w"] + lp["b"]) + x
    h = x
    for lp in params["mlp"]:
        h = torch.relu(h @ lp["w"] + lp["b"])
    return torch.cat([x, h], dim=-1)


def logits(params, cfg: DCNConfig, axes: MeshAxes, dense, sparse) -> torch.Tensor:
    x0 = features(params, cfg, axes, dense, sparse)
    z = interact(params, cfg, x0)
    return (z @ params["w_out"])[:, 0]


def loss_fn(params, cfg: DCNConfig, axes: MeshAxes, dense, sparse, labels) -> torch.Tensor:
    """The mean logistic loss; over a mesh, this rank's share: its batch's
    sum over the global batch, over the mp ranks that repeat it."""
    lg = logits(params, cfg, axes, dense, sparse).to(_F32)
    y = labels.to(_F32)
    per = torch.clamp(lg, min=0) - lg * y + torch.log1p(torch.exp(-torch.abs(lg)))
    if axes.world == 1:
        return torch.mean(per)
    dp = axes.size(axes.resolve("dp"))
    return per.sum() / (per.numel() * dp * axes.size(axes.mp))


# -- retrieval scoring: 1 query vs n_candidates ------------------------------------


def query_embedding(params, cfg: DCNConfig, axes: MeshAxes, dense, sparse) -> torch.Tensor:
    """Query tower: the MLP branch output as the query vector (B, d_q)."""
    h = features(params, cfg, axes, dense, sparse)
    for lp in params["mlp"]:
        h = torch.relu(h @ lp["w"] + lp["b"])
    return h


def retrieval_scores(params, cfg: DCNConfig, axes: MeshAxes, dense, sparse,
                     candidates: torch.Tensor) -> torch.Tensor:
    """candidates: (n_cand, d_q) item tower embeddings; over a mesh, this
    rank's block of them (split over every axis). Scores = one batched
    matmul + top-k (the 100 best, descending), never a loop: each rank's
    best 100, all-gathered, and the best 100 of those."""
    q = query_embedding(params, cfg, axes, dense, sparse)  # (B, d_q)
    cands = constrain(candidates, axes, "dp+mp", None)
    scores = q @ cands.T  # (B, n_cand)
    every = axes.resolve("dp+mp")
    if axes.size(every) == 1:
        return torch.topk(scores, 100, dim=-1).values
    best = torch.topk(scores, min(100, scores.shape[-1]), dim=-1).values
    return torch.topk(SH.all_gather(best, axes, every, 1), 100, dim=-1).values
