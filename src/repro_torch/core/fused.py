"""Fused whole-BGP counts on the device (the reference's ``core/fused.py``).

For hot query shapes the engine counts without materialising the join:

  fused_chain_count — COUNT(*) of p1 ⋈ p2 ⋈ … ⋈ pk chains: weights
                      propagate right to left through prefix sums over
                      the subject-sorted relations; intermediates never
                      exist.
  fused_q6_count    — the paper's Figure-1 query (two :knows hops, the
                      interests of the last person, FILTER ?a != ?c), with
                      the inequality in closed form:
                         count = Σ chains − Σ_{mutual (a, b)} tags(a).

A predicate's (subject, object) rows are views of the store's PSOC index
columns on the device, cut at the bounds ``QuadStore.build`` kept on the
host (``predicate_range``). Each relation is sorted by subject, so the
matching rows of a key form one run; its bounds come from the
``sorted_search_range`` kernel. Run sums come from int64 prefix sums, and
the q6 correction's (subject, object) composite key is int64 as well: the
reference builds both in int32 (x64 is off in its JAX build), which wraps
once (max id + 2)^2 passes 2^31. The answer is read to the host once, at
the end.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.storage import QuadStore
from repro_torch.kernels.sorted_search import sorted_search_range

_I64 = torch.int64


def _pred_edges_sorted_by_subject(store: QuadStore, pred: str) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """(subjects, objects) of one predicate's rows, subject-sorted: views of
    the PSOC index columns."""
    rng = store.predicate_range(store.dict.lookup(pred))
    cols = store.index_columns("psoc")
    return cols[1][rng.lo: rng.hi], cols[2][rng.lo: rng.hi]


def _count_per_key(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Rows of ``sorted_keys`` equal to each query (int64)."""
    lo, hi = sorted_search_range(sorted_keys, queries)
    return (hi - lo).to(_I64)


def _fold_weights(next_subj: torch.Tensor, w_next: torch.Tensor,
                  cur_obj: torch.Tensor) -> torch.Tensor:
    """weight(edge e of the current relation) = Σ weights of the next
    relation's rows whose subject equals e.object: a run sum through the
    int64 prefix sums of ``w_next``."""
    cw = torch.cat([w_next.new_zeros(1), torch.cumsum(w_next, 0)])
    lo, hi = sorted_search_range(next_subj, cur_obj)
    return cw[hi] - cw[lo]


def fused_chain_count(store: QuadStore, preds: List[str]) -> int:
    """COUNT(*) of ?x0 p1 ?x1 . ?x1 p2 ?x2 . … (a left-deep chain BGP)."""
    rels = [_pred_edges_sorted_by_subject(store, p) for p in preds]
    if any(int(s.shape[0]) == 0 for s, _ in rels):
        return 0
    w = torch.ones(int(rels[-1][0].shape[0]), dtype=_I64, device=store.device)
    for i in range(len(rels) - 2, -1, -1):
        w = _fold_weights(rels[i + 1][0], w, rels[i][1])
    return int(w.sum())


def _q6_count(k_subj: torch.Tensor, k_obj: torch.Tensor, i_subj: torch.Tensor) -> torch.Tensor:
    # tags(c) for every knows edge (b, c)
    w2 = _count_per_key(i_subj, k_obj)
    # chains through each first-hop edge (a, b) = Σ_{(b, c)} tags(c)
    total = _fold_weights(k_subj, w2, k_obj).sum()
    # the correction for ?a != ?c: a chain with c == a exists iff (b, a) is
    # a knows edge; each mutual pair contributes tags(a). Membership through
    # composite keys: the relation is (subject, object)-sorted already.
    s, o = k_subj.to(_I64), k_obj.to(_I64)
    base = torch.maximum(s.max(), o.max()) + 2
    comp = s * base + o
    rev = o * base + s
    pos = torch.searchsorted(comp, rev).clamp_(max=int(comp.shape[0]) - 1)
    mutual = comp[pos] == rev
    tags_a = _count_per_key(i_subj, k_subj)
    return total - torch.where(mutual, tags_a, 0).sum()


def fused_q6_count(store: QuadStore, knows: str = ":knows",
                   interest: str = ":hasInterest") -> int:
    """The paper's Figure-1 query, fused: no row is materialised."""
    k_subj, k_obj = _pred_edges_sorted_by_subject(store, knows)
    i_subj, _ = _pred_edges_sorted_by_subject(store, interest)
    if int(k_subj.shape[0]) == 0 or int(i_subj.shape[0]) == 0:
        return 0
    return int(_q6_count(k_subj, k_obj, i_subj))
