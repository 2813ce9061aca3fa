"""dcn-v2 [arXiv:2008.13535]: 13 dense + 26 sparse (embed_dim 16), 3
full-rank cross layers, MLP 1024-1024-512."""
from repro_torch.configs.base import ArchConfig, RECSYS_SHAPES
from repro_torch.models.recsys.dcn import DCNConfig

ARCH = ArchConfig(
    name="dcn-v2",
    kind="recsys",
    model=DCNConfig(),
    reduced_model=DCNConfig(max_table_rows=1000, mlp_dims=(64, 64, 32)),
    shapes=RECSYS_SHAPES,
    source="arXiv:2008.13535",
)
