"""Architecture config registry (``--arch <id>``), as in the reference
package.

Each architecture has one module exporting ``ARCH`` with its published
configuration, its shape set and ``reduced_model``, a small variant of the
same family for tests on the CPU. ``all_cells`` lists every (arch, shape).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

ARCH_IDS: Tuple[str, ...] = (
    "qwen3-8b",
    "deepseek-7b",
    "command-r-plus-104b",
    "qwen3-moe-30b-a3b",
    "moonshot-v1-16b-a3b",
    "graphsage-reddit",
    "dimenet",
    "gin-tu",
    "gat-cora",
    "dcn-v2",
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    kind: str  # lm | gnn | recsys
    model: Any  # TransformerConfig | GNNConfig | DCNConfig
    shapes: Dict[str, Dict[str, Any]]
    source: str = ""
    reduced_model: Optional[Any] = None  # smoke-test variant
    notes: str = ""


_MODULES = {aid: f"repro_torch.configs.{aid.replace('-', '_')}" for aid in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """Every (arch, shape) cell."""
    return tuple((aid, shape) for aid in ARCH_IDS for shape in get_config(aid).shapes)


# Shared shape sets -----------------------------------------------------------

LM_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(step="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(step="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(step="decode", seq_len=32768, global_batch=128),
    # long-context decode: served with a sliding-window KV cache — window 8192
    "long_500k": dict(step="decode", seq_len=524288, global_batch=1, window=8192),
}

GNN_SHAPES: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": dict(
        step="gnn_full", n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7
    ),
    "minibatch_lg": dict(
        step="gnn_minibatch",
        n_graph_nodes=232965,
        n_graph_edges=114615892,
        batch_nodes=1024,
        fanouts=(15, 10),
        d_feat=602,
        n_classes=41,
    ),
    "ogb_products": dict(
        step="gnn_full", n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47
    ),
    "molecule": dict(
        step="gnn_molecule",
        n_nodes=30,
        n_edges=64,
        batch=128,
        d_feat=16,
        n_classes=16,
    ),
}

RECSYS_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(step="recsys_train", batch=65536),
    "serve_p99": dict(step="recsys_serve", batch=512),
    "serve_bulk": dict(step="recsys_serve", batch=262144),
    "retrieval_cand": dict(step="recsys_retrieval", batch=1, n_candidates=1000000),
}
