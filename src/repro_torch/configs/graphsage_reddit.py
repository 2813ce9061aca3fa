"""graphsage-reddit [arXiv:1706.02216]: 2L d_hidden=128 mean aggregator,
sample sizes 25-10 (minibatch_lg uses the assigned 15-10 fanout)."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.models import GNNConfig

ARCH = ArchConfig(
    name="graphsage-reddit",
    kind="gnn",
    model=GNNConfig(name="graphsage-reddit", kind="graphsage", n_layers=2,
                    d_hidden=128, aggregator="mean"),
    reduced_model=GNNConfig(name="graphsage-smoke", kind="graphsage", n_layers=2,
                            d_hidden=16, aggregator="mean"),
    shapes=GNN_SHAPES,
    source="arXiv:1706.02216",
)
