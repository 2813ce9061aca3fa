"""EmbeddingBag (the reference's ``models/recsys/embedding.py``): a row
gather and a segment sum (``index_add``), with -1 padding, sum or mean
bags, per-index weights, and the quotient-remainder lookup
[arXiv:1909.02107] for huge vocabularies."""

from __future__ import annotations

from typing import Optional

import torch


def init_table(gen: torch.Generator, n_rows: int, dim: int, scale: float = 0.01,
               device=None) -> torch.Tensor:
    return torch.randn((n_rows, dim), generator=gen, dtype=torch.float32, device=device) * scale


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    n_segments: Optional[int] = None,
    combiner: str = "sum",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather rows and segment-reduce.

    indices: (nnz,) int32 (-1 = padding); segment_ids: (nnz,) bag id per
    index (None => one index per bag, identity). Returns (n_segments, dim).
    """
    valid = indices >= 0
    rows = table[torch.clamp(indices, min=0).long()]
    rows = torch.where(valid[:, None], rows, 0.0)
    if weights is not None:
        rows = rows * weights[:, None]
    if segment_ids is None:
        return rows
    if n_segments is None:
        raise ValueError("embedding_bag: segment_ids needs n_segments")
    seg = segment_ids.long()
    s = torch.zeros((n_segments, rows.shape[1]), dtype=rows.dtype,
                    device=rows.device).index_add(0, seg, rows)
    if combiner == "sum":
        return s
    if combiner == "mean":
        cnt = torch.zeros(n_segments, dtype=torch.float32, device=rows.device).index_add(
            0, seg, valid.to(torch.float32))
        return s / torch.clamp(cnt[:, None], min=1.0)
    raise ValueError(combiner)


def qr_embedding_lookup(q_table: torch.Tensor, r_table: torch.Tensor,
                        indices: torch.Tensor, n_collisions: int) -> torch.Tensor:
    """Quotient-remainder trick: emb[i] = Q[i // m] * R[i % m]."""
    safe = torch.clamp(indices, min=0).long()
    out = q_table[safe // n_collisions] * r_table[safe % n_collisions]
    return torch.where((indices >= 0)[:, None], out, 0.0)
