"""Neighbour samplers for minibatch GNN training (GraphSAGE fanout 25-10 /
15-10 shapes), as in the reference package.

Two implementations with the same output contract (padded static-shape
subgraph blocks):

  * CSRSampler   — classic CSR-adjacency uniform fanout sampling (numpy);
  * BARQSampler  — the same sampling as BARQ merge joins over the sorted
    quad store on its device: seeds ⋈ :edge triples is a (sorted seeds ×
    index scan) merge join, and a group is capped at the fanout on the
    host. This is the engine acting as the framework's data pipeline.

Both draw from ``np.random.RandomState(seed)`` in the reference's order, and
BARQSampler lists a seed's neighbours in the order the merge join emits
them (the scan's, objects ascending within a subject), so the same seed
gives the reference's blocks.

Output block (for L=2 layers, seeds B, fanouts f1, f2):
  nodes:   (B + B*f1 + B*f1*f2,) int32 global node ids (-1 padding)
  edge_src/edge_dst: (B*f1 + B*f1*f2,) int32 *local* indices into nodes
  seed_mask: which local nodes are seeds (loss is computed there)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.algebra import K, TriplePattern, V, VarTable
from repro_torch.core.device import resolve_device
from repro_torch.core.operators.merge_join import MergeJoin
from repro_torch.core.operators.scan import IndexScan
from repro_torch.core.operators.sort import MaterializedSource
from repro_torch.core.storage import QuadStore


@dataclasses.dataclass
class SampledBlock:
    nodes: np.ndarray  # (n_total,) global ids, -1 pad
    edge_src: np.ndarray  # (n_edges,) local idx, -1 pad
    edge_dst: np.ndarray
    seed_mask: np.ndarray  # (n_total,) bool
    labels: np.ndarray  # (n_total,) int32 (global label table gathered)


class CSRSampler:
    def __init__(self, edge_index: np.ndarray, n_nodes: int, seed: int = 0):
        """edge_index: (2, E) src->dst. Builds CSR over outgoing edges."""
        src, dst = edge_index
        order = np.argsort(src, kind="stable")
        self.dst_sorted = dst[order].astype(np.int32)
        self.indptr = np.searchsorted(
            src[order], np.arange(n_nodes + 1), side="left"
        ).astype(np.int64)
        self.n_nodes = n_nodes
        self.rng = np.random.RandomState(seed)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """(len(nodes), fanout) neighbor ids, -1 padded."""
        out = np.full((len(nodes), fanout), -1, dtype=np.int32)
        for i, u in enumerate(nodes):
            if u < 0:
                continue
            lo, hi = self.indptr[u], self.indptr[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            if deg <= fanout:
                out[i, :deg] = self.dst_sorted[lo:hi]
            else:
                sel = self.rng.choice(deg, size=fanout, replace=False)
                out[i] = self.dst_sorted[lo + sel]
        return out

    def sample_block(self, seeds: np.ndarray, fanouts: List[int],
                     labels: Optional[np.ndarray] = None) -> SampledBlock:
        return _assemble_block(self, seeds, fanouts, labels)


class BARQSampler:
    """Fanout sampling as merge joins over the quad store. ``device`` is
    the store's: None is the CUDA card (raises where there is none), and a
    store on another device is refused."""

    def __init__(self, store: QuadStore, edge_pred, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if store.device != self.device:
            raise ValueError(f"BARQSampler: the store is on {store.device}, not {self.device}")
        self.store = store
        self.edge_pred = edge_pred
        self.rng = np.random.RandomState(seed)
        self.vt = VarTable()
        self.n_nodes = len(store.dict)

    def _edges_of(self, uniq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(subjects, objects) of every :edge triple whose subject is in the
        sorted ``uniq``, in the merge join's emission order: the join runs
        on the device, each output batch's two columns are gathered there,
        and the pairs come to the host in one copy."""
        v_s, v_o = self.vt.var("s"), self.vt.var("o")
        seeds = torch.from_numpy(uniq[None, :]).to(self.device)
        seeds_src = MaterializedSource((v_s,), seeds, v_s, name="Seeds")
        scan = IndexScan(
            self.store,
            TriplePattern(V(v_s), K(self.edge_pred), V(v_o)),
            want_sorted_var=v_s,
        )
        join = MergeJoin(seeds_src, scan, v_s, self.device)
        blocks = []
        while True:
            b = join.next_batch()
            if b is None:
                break
            cb = b.compact()
            if cb.n_rows:
                idx = [cb.col_index(v_s), cb.col_index(v_o)]
                blocks.append(cb.columns[idx, : cb.n_rows])
            cb.release()
        if not blocks:
            empty = np.zeros(0, np.int32)
            return empty, empty
        pairs = torch.cat(blocks, dim=1).cpu().numpy()
        return pairs[0], pairs[1]

    def sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """Join sorted seeds against the (?s :edge ?o) scan; cap each
        group at ``fanout`` rows."""
        valid = nodes[nodes >= 0]
        if len(valid) == 0:
            return np.full((len(nodes), fanout), -1, np.int32)
        uniq = np.unique(valid).astype(np.int32)
        ss, oo = self._edges_of(uniq)
        # a seed's neighbours, kept in emission order (the reference's lists)
        order = np.argsort(ss, kind="stable")
        ss, oo = ss[order], oo[order]
        los = np.searchsorted(ss, nodes, side="left")
        his = np.searchsorted(ss, nodes, side="right")
        out = np.full((len(nodes), fanout), -1, dtype=np.int32)
        for i in range(len(nodes)):
            lo, deg = los[i], his[i] - los[i]
            if nodes[i] < 0 or deg == 0:
                continue
            if deg <= fanout:
                out[i, :deg] = oo[lo: lo + deg]
            else:
                sel = self.rng.choice(deg, size=fanout, replace=False)
                out[i] = oo[lo + sel]
        return out

    def sample_block(self, seeds: np.ndarray, fanouts: List[int],
                     labels: Optional[np.ndarray] = None) -> SampledBlock:
        return _assemble_block(self, seeds, fanouts, labels)


def _assemble_block(sampler, seeds: np.ndarray, fanouts: List[int],
                    labels: Optional[np.ndarray]) -> SampledBlock:
    seeds = np.asarray(seeds, dtype=np.int32)
    levels = [seeds]
    edges_src_g: List[np.ndarray] = []
    edges_dst_g: List[np.ndarray] = []
    frontier = seeds
    for f in fanouts:
        nbrs = sampler.sample_neighbors(frontier, f)  # (len(frontier), f)
        src = nbrs.reshape(-1)
        dst = np.repeat(frontier, f)
        dst = np.where(src >= 0, dst, -1)
        edges_src_g.append(src)
        edges_dst_g.append(dst)
        levels.append(src)
        frontier = src
    nodes = np.concatenate(levels)
    n_total = len(nodes)
    # map global -> local (first occurrence wins; padding stays -1)
    local = {}
    nodes_local = np.full(n_total, -1, np.int32)
    for i, u in enumerate(nodes.tolist()):
        if u < 0:
            continue
        if u not in local:
            local[u] = i
        nodes_local[i] = local[u]

    def to_local(arr):
        return np.asarray(
            [local.get(int(u), -1) if u >= 0 else -1 for u in arr], np.int32
        )

    e_src = to_local(np.concatenate(edges_src_g))
    e_dst = to_local(np.concatenate(edges_dst_g))
    seed_mask = np.zeros(n_total, bool)
    seed_mask[: len(seeds)] = seeds >= 0
    lab = np.zeros(n_total, np.int32)
    if labels is not None:
        ok = nodes >= 0
        lab[ok] = labels[nodes[ok]]
    return SampledBlock(nodes, e_src, e_dst, seed_mask, lab)
