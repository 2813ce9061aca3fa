"""Configurations: the engine's (``barq_engine``: defaults and the
distributed join's dry-run shapes) and the ten model architectures'
(``base``: ``get_config``, ``all_cells``, one module each)."""

from repro_torch.configs.base import ARCH_IDS, ArchConfig, all_cells, get_config  # noqa: F401
