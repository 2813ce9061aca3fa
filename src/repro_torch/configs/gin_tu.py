"""gin-tu [arXiv:1810.00826]: 5L d_hidden=64 sum aggregator, learnable eps."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.models import GNNConfig

ARCH = ArchConfig(
    name="gin-tu",
    kind="gnn",
    model=GNNConfig(name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
                    aggregator="sum"),
    reduced_model=GNNConfig(name="gin-smoke", kind="gin", n_layers=3, d_hidden=16,
                            aggregator="sum"),
    shapes=GNN_SHAPES,
    source="arXiv:1810.00826",
)
