"""Configurations: the engine's (``barq_engine``: defaults and the
distributed join's dry-run shapes) and the LM architectures' (``base``:
``get_config``, one module each)."""

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config  # noqa: F401
