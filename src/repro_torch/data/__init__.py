"""Data generators."""

from repro_torch.data.lsqb import LSQB_QUERIES, generate_social_graph  # noqa: F401
