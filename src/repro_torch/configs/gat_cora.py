"""gat-cora [arXiv:1710.10903]: 2L d_hidden=8 n_heads=8 attention aggregator."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.models import GNNConfig

ARCH = ArchConfig(
    name="gat-cora",
    kind="gnn",
    model=GNNConfig(name="gat-cora", kind="gat", n_layers=2, d_hidden=8,
                    n_heads=8, aggregator="attn"),
    reduced_model=GNNConfig(name="gat-smoke", kind="gat", n_layers=2, d_hidden=8,
                            n_heads=4, aggregator="attn"),
    shapes=GNN_SHAPES,
    source="arXiv:1710.10903",
)
