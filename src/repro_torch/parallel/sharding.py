"""Mesh-axis roles over a process group (the reference's
``parallel/sharding.py``, with a ``torch.distributed`` process group in the
place of its device mesh).

Models describe sharding against *logical* roles — dp (the data-parallel
batch axis), mp (the model / tensor-parallel axis) — and ``MeshAxes``
binds the roles to concrete axis names. Here one process group stands for
the mesh: serving runs on one rank, where ``constrain`` is the identity.
Layouts over more ranks (the reference's ``spec`` / ``tree_spec`` and the
transformer's ``param_specs`` / ``cache_specs``) come with the
tensor-parallel slice; ``constrain`` raises on a group of more than one
rank until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...] = ("data",)
    mp: str = "model"
    # the process group the roles map onto; None is one rank
    group: Any = dataclasses.field(default=None, compare=False)

    @staticmethod
    def for_mesh(group) -> "MeshAxes":
        """The roles over ``group`` (a process group, or None for one
        rank): data parallelism over the group's ranks."""
        return MeshAxes(dp=("data",), mp="model", group=group)

    @property
    def world(self) -> int:
        """Ranks in the group (1 without one)."""
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    def resolve(self, role: Optional[str]):
        """role -> concrete axis entry."""
        if role is None:
            return None
        if role == "dp":
            return self.dp if len(self.dp) > 1 else self.dp[0]
        if role == "mp":
            return self.mp
        if role == "dp+mp":  # fully flattened (e.g. GNN node dim)
            return tuple(self.dp) + (self.mp,)
        raise ValueError(role)


def constrain(x, axes: MeshAxes, *roles: Optional[str]):
    """A logical sharding constraint: the identity on one rank."""
    for r in roles:
        axes.resolve(r)
    if axes.world == 1:
        return x
    raise NotImplementedError(
        "constrain: sharded layouts over more than one rank come with the "
        "tensor-parallel serving slice")
