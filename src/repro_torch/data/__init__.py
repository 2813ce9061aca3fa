"""Data generators."""

from repro_torch.data.bsbm import (  # noqa: F401
    BSBM_BI_QUERIES,
    BSBM_EXPLORE_TEMPLATES,
    generate_ecommerce_graph,
    instantiate_explore,
)
from repro_torch.data.lsqb import LSQB_QUERIES, generate_social_graph  # noqa: F401
