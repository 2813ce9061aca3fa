"""dimenet [arXiv:2003.03123]: 6 interaction blocks, d_hidden=128,
n_bilinear=8, n_spherical=7, n_radial=6. Triplet lists are capped per shape
(static-shape budget; DESIGN.md §4)."""
from repro_torch.configs.base import ArchConfig, GNN_SHAPES
from repro_torch.models.gnn.models import GNNConfig

ARCH = ArchConfig(
    name="dimenet",
    kind="gnn",
    model=GNNConfig(name="dimenet", kind="dimenet", n_layers=6, d_hidden=128,
                    n_bilinear=8, n_spherical=7, n_radial=6),
    reduced_model=GNNConfig(name="dimenet-smoke", kind="dimenet", n_layers=2,
                            d_hidden=32, n_bilinear=4, n_spherical=3, n_radial=4),
    shapes=GNN_SHAPES,
    source="arXiv:2003.03123",
)
