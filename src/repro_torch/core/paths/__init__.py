"""Vectorized property-path subsystem (SPARQL 1.1 paths, DESIGN.md §8) on
the device.

Path expressions compile to edge *relations* (sorted (src, dst) int32
pair tensors) and closures run as semi-naive delta-frontier BFS where
every round expands the whole frontier with the kernels the join
operators use (``join_expand`` + ``gather_emit``), plus ``sorted_search``
for successor ranges and ``frontier_dedup`` for the delta frontier.
"""

from repro_torch.core.paths.expr import (
    PAlt,
    PathExpr,
    PClosure,
    PInv,
    PLink,
    PSeq,
    path_repr,
)
from repro_torch.core.paths.engine import PathEngine, PathResult

__all__ = [
    "PAlt",
    "PClosure",
    "PInv",
    "PLink",
    "PSeq",
    "PathExpr",
    "PathEngine",
    "PathResult",
    "path_repr",
]
