"""Deterministic, resumable data pipelines (numpy, as in the reference
package).

Every batch is a pure function of (seed, step) — restart/resume needs no
replay log, and elastic re-sharding just changes how the same global batch
is split. Token batches are synthetic (zipfian unigram text
analogue); graph pipelines wrap the neighbor samplers; recsys batches
mirror Criteo field statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> Dict:
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2**31 - 1))
    # zipfian unigrams: realistic softmax difficulty without a corpus
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq + 1), p=probs).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def recsys_batch(seed: int, step: int, batch: int, n_dense: int, n_sparse: int,
                 vocab_sizes) -> Dict:
    rng = np.random.RandomState((seed * 997 + step) % (2**31 - 1))
    dense = rng.lognormal(0, 2, size=(batch, n_dense)).astype(np.float32)
    sparse = np.stack(
        [rng.randint(0, max(int(v), 1), size=batch) for v in vocab_sizes[:n_sparse]],
        axis=1,
    ).astype(np.int32)
    # clicks correlated with a hidden linear signal for learnability
    w = np.random.RandomState(seed).randn(n_dense)
    logit = np.log1p(dense) @ w * 0.3 - 0.5
    labels = (rng.rand(batch) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


@dataclasses.dataclass
class GraphPipeline:
    """Minibatch GNN pipeline over a neighbor sampler (CSR or BARQ-backed)."""

    sampler: object  # CSRSampler | BARQSampler (repro_torch.models.gnn.sampler)
    labels: np.ndarray
    n_seed_nodes: int
    batch_nodes: int
    fanouts: List[int]
    seed: int = 0

    def batch(self, step: int):
        rng = np.random.RandomState((self.seed * 7919 + step) % (2**31 - 1))
        seeds = rng.randint(0, self.n_seed_nodes, self.batch_nodes).astype(np.int32)
        return self.sampler.sample_block(seeds, self.fanouts, self.labels)


def block_to_model_inputs(block, d_feat: int, feature_fn: Optional[Callable] = None):
    """SampledBlock -> the dict the GNN models consume. Features default to
    deterministic hashes of global node id (id-keyed synthetic features)."""
    n = len(block.nodes)
    if feature_fn is None:
        base = (block.nodes.astype(np.int64) % 977).astype(np.float32)[:, None]
        freq = np.arange(1, d_feat + 1, dtype=np.float32)[None, :]
        x = np.sin(base * freq / 977.0)
    else:
        x = feature_fn(block.nodes)
    return {
        "x": x.astype(np.float32),
        "edge_src": block.edge_src,
        "edge_dst": block.edge_dst,
        "labels": block.labels,
        "label_mask": block.seed_mask.astype(np.float32),
    }
