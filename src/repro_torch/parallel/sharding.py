"""Mesh-axis roles, partition specs and the counted collectives (the
reference's ``parallel/sharding.py`` over a ``torch.distributed``
``DeviceMesh``).

Models describe sharding against *logical* roles — dp (the data-parallel
batch axis), mp (the model / tensor-parallel axis) — and ``MeshAxes``
binds them to the mesh's dimension names: ("data", "model") on one pod,
("pod", "data", "model") on two, where dp is ("pod", "data"). A ``Spec``
gives one entry a dimension of a tensor: None (replicated), an axis name,
or a tuple of names (the dimension split over their flattened product, the
first name major), as the reference's ``PartitionSpec``.

The port runs one program a rank over its shards (no DTensor): a rank holds
exactly the shard of every leaf its spec gives it (``shard_shape``,
``shard_tree``), and the model code calls its collectives explicitly,
Megatron style. Every collective goes through this module and is counted
on the ``Tally`` its ``MeshAxes`` owns: calls and output bytes a kind
(all-gather, all-reduce, reduce-scatter, all-to-all, collective-permute),
the reference's ``collective_bytes`` convention. The autograd forms pair a
collective with its transpose:

  ``copy_to``         identity forward, all-reduce backward;
  ``all_reduce``      all-reduce forward, identity backward (``grad="identity"``),
                      or all-reduce backward too (``grad="all_reduce"``: the
                      reference's ``psum`` in a ``shard_map``);
  ``all_gather``      all-gather forward, reduce-scatter backward;
  ``reduce_scatter``  reduce-scatter forward, all-gather backward;
  ``split``           this rank's chunk forward, all-gather backward.

Over an entry of size 1 each is the identity and counts nothing, so one
rank (``mesh=None``) runs the same code with no collective.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.train.tree import flatten_with_paths, leaves, unflatten

Entry = Union[None, str, Tuple[str, ...]]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def names_of(entry: Entry) -> Tuple[str, ...]:
    """The axis names of a spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Spec:
    """A partition spec: one entry a dimension (None, an axis name or a
    tuple of names). Iterates, indexes and compares as the tuple of its
    entries, as the reference's ``PartitionSpec`` does; a tree of specs
    holds them as leaves."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Entry):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, Spec):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"

    def padded(self, ndim: int) -> Tuple[Entry, ...]:
        """The entries with trailing None up to ``ndim`` dimensions."""
        if len(self.entries) > ndim:
            raise ValueError(f"{self!r} has more entries than a rank-{ndim} tensor")
        return self.entries + (None,) * (ndim - len(self.entries))


class Tally:
    """Collective calls and output bytes a kind, counted on one rank."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = {k: 0 for k in KINDS}
        self.calls = {k: 0 for k in KINDS}

    def add(self, kind: str, out: torch.Tensor) -> None:
        self.bytes[kind] += out.numel() * out.element_size()
        self.calls[kind] += 1

    def record(self) -> Dict[str, Any]:
        """The reference's ``collective_bytes`` record."""
        return {"per_kind_bytes": dict(self.bytes), "per_kind_counts": dict(self.calls),
                "total_bytes": sum(self.bytes.values())}


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...] = ("data",)
    mp: str = "model"
    # the DeviceMesh the roles map onto; None is one rank
    mesh: Any = dataclasses.field(default=None, compare=False)
    # whether the program's batch is split over dp (False: every rank holds
    # it whole, as the batch-1 long-context layout does)
    batch_split: bool = dataclasses.field(default=True, compare=False)
    tally: Tally = dataclasses.field(default_factory=Tally, compare=False, repr=False)
    _groups: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        """The roles over ``mesh`` (a ``DeviceMesh``, or None for one
        rank): dp is ("pod", "data") where the mesh has a pod axis."""
        if mesh is None:
            return MeshAxes()
        names = tuple(mesh.mesh_dim_names)
        dp = ("pod", "data") if "pod" in names else ("data",)
        for n in dp + ("model",):
            if n not in names:
                raise ValueError(f"MeshAxes: the mesh's dimensions {names} lack {n!r}")
        return MeshAxes(dp=dp, mp="model", mesh=mesh)

    def resolve(self, role: Optional[str]) -> Entry:
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

    # -- the mesh ------------------------------------------------------------

    @property
    def names(self) -> Tuple[str, ...]:
        """Every axis of the mesh, in its order."""
        if self.mesh is None:
            return tuple(self.dp) + (self.mp,)
        return tuple(self.mesh.mesh_dim_names)

    def _dim(self, name: str) -> int:
        if name not in self.names:
            raise ValueError(f"no mesh axis {name!r} in {self.names}")
        return self.names.index(name)

    def size(self, entry: Entry) -> int:
        """Ranks along ``entry`` (1 without a mesh)."""
        if self.mesh is None:
            for n in names_of(entry):
                self._dim(n)
            return 1
        return math.prod(int(self.mesh.size(self._dim(n))) for n in names_of(entry))

    @property
    def world(self) -> int:
        return self.size(self.names)

    def index(self, entry: Entry) -> int:
        """This rank's flattened coordinate along ``entry`` (first name
        major)."""
        if self.mesh is None:
            return 0
        coord = self.mesh.get_coordinate()
        i = 0
        for n in names_of(entry):
            d = self._dim(n)
            i = i * int(self.mesh.size(d)) + int(coord[d])
        return i

    def group(self, entry: Entry):
        """The process group of the ranks along ``entry`` that share this
        rank's other coordinates (None where the entry has one rank). The
        groups of a multi-axis entry are made on first use, on every rank
        at once, as ``torch.distributed`` requires."""
        names = names_of(entry)
        if self.size(names) == 1:
            return None
        if len(names) == 1:
            return self.mesh.get_group(names[0])
        dims = [self._dim(n) for n in names]
        if dims != sorted(dims):
            raise ValueError(f"entry {entry!r} does not follow the mesh's axis order {self.names}")
        key = tuple(names)
        if key not in self._groups:
            import torch.distributed as dist

            ranks = self.mesh.mesh
            rest = [d for d in range(ranks.dim()) if d not in dims]
            rows = ranks.permute(*rest, *dims).reshape(-1, self.size(names))
            mine, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in rows])
            self._groups[key] = mine
        return self._groups[key]


def spec(axes: MeshAxes, *roles: Optional[str]) -> Spec:
    """spec(axes, 'dp', None, 'mp') -> Spec over concrete axes."""
    return Spec(*[axes.resolve(r) for r in roles])


def tree_spec(param_tree, rule_fn) -> Any:
    """A tree of specs shaped as ``param_tree``: ``rule_fn(path, leaf)``
    for each leaf, ``path`` the tuple of its keys (list indices as
    strings), as the reference's ``tree_spec`` gives it."""
    flat = flatten_with_paths(param_tree)
    return unflatten(param_tree, [rule_fn(path, leaf) for path, leaf in flat])


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------


def shard_shape(shape, sp: Spec, axes: MeshAxes, name: str = "") -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` under ``sp``;
    raises, naming the leaf, where a dimension does not divide."""
    out = []
    for i, (dim, e) in enumerate(zip(shape, sp.padded(len(shape)))):
        k = axes.size(e)
        if dim % k:
            raise ValueError(f"{name or 'leaf'}: dimension {i} of {tuple(shape)} does not divide "
                             f"over {e!r} ({k} ranks) in {sp!r}")
        out.append(dim // k)
    return tuple(out)


def local_slices(shape, sp: Spec, axes: MeshAxes, name: str = "") -> Tuple[slice, ...]:
    """This rank's slice of each dimension of a tensor of ``shape``."""
    local = shard_shape(shape, sp, axes, name)
    return tuple(slice(axes.index(e) * n, (axes.index(e) + 1) * n)
                 for n, e in zip(local, sp.padded(len(shape))))


def spec_leaves(specs, tree):
    """[(leaf name, leaf, spec)] of a tree and its tree of specs, in leaf
    order."""
    sl = leaves(specs)
    flat = flatten_with_paths(tree)
    if len(sl) != len(flat):
        raise ValueError(f"a tree of {len(flat)} leaves against {len(sl)} specs")
    return [("/".join(p), x, s) for (p, x), s in zip(flat, sl)]


def shard_tree(tree, specs, axes: MeshAxes):
    """A global tree -> this rank's shards (new tensors)."""
    out = [x[local_slices(x.shape, s, axes, n)].clone() for n, x, s in spec_leaves(specs, tree)]
    return unflatten(tree, out)


def gather_tree(tree, specs, axes: MeshAxes):
    """This rank's shards -> the global tree (every rank gets it)."""
    out = []
    for _, x, s in spec_leaves(specs, tree):
        for d, e in enumerate(s.padded(x.dim())):
            x = _gather(x, axes, e, d)
        out.append(x)
    return unflatten(tree, out)


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def constrain(x: torch.Tensor, axes: MeshAxes, *roles: Optional[str], full=None):
    """A layout assertion on this rank's tensor: the identity. Where the
    global shape ``full`` is given, ``x`` must be its shard under the
    roles' spec."""
    sp = spec(axes, *roles)
    if full is not None:
        want = shard_shape(tuple(full), sp, axes)
        if tuple(x.shape) != want:
            raise ValueError(f"constrain: a local {tuple(x.shape)} is not the shard {want} of "
                             f"{tuple(full)} under {sp!r}")
    return x


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_OPS = {"sum": "SUM", "max": "MAX"}


def _all_reduce(x: torch.Tensor, axes: MeshAxes, entry: Entry, op: str = "sum") -> torch.Tensor:
    g = axes.group(entry)
    if g is None:
        return x
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]), group=g)
    axes.tally.add("all-reduce", out)
    return out


def _gather(x: torch.Tensor, axes: MeshAxes, entry: Entry, dim: int) -> torch.Tensor:
    g = axes.group(entry)
    if g is None:
        return x
    import torch.distributed as dist

    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] * axes.size(entry),) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():  # renamed in later releases; both names work here
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, xt, group=g)
    axes.tally.add("all-gather", out)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, axes: MeshAxes, entry: Entry, dim: int) -> torch.Tensor:
    g = axes.group(entry)
    if g is None:
        return x
    import torch.distributed as dist

    k = axes.size(entry)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % k:
        raise ValueError(f"reduce_scatter: {xt.shape[0]} rows do not divide over {k} ranks")
    out = torch.empty((xt.shape[0] // k,) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, xt, group=g)
    axes.tally.add("reduce-scatter", out)
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, axes: MeshAxes, entry: Entry, dim: int) -> torch.Tensor:
    k = axes.size(entry)
    if x.shape[dim] % k:
        raise ValueError(f"split: dimension {dim} of {tuple(x.shape)} does not divide over {k}")
    n = x.shape[dim] // k
    return x.narrow(dim, axes.index(entry) * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, entry):
        ctx.axes, ctx.entry = axes, entry
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes, ctx.entry), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, entry, grad_reduces):
        ctx.axes, ctx.entry, ctx.grad_reduces = axes, entry, grad_reduces
        return _all_reduce(x, axes, entry)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_reduces:
            g = _all_reduce(g, ctx.axes, ctx.entry)
        return g, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, entry, dim):
        ctx.axes, ctx.entry, ctx.dim = axes, entry, dim
        return _gather(x, axes, entry, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.axes, ctx.entry, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, entry, dim):
        ctx.axes, ctx.entry, ctx.dim = axes, entry, dim
        return _scatter(x, axes, entry, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axes, ctx.entry, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, entry, dim):
        ctx.axes, ctx.entry, ctx.dim = axes, entry, dim
        return _chunk(x, axes, entry, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axes, ctx.entry, ctx.dim), None, None, None


def _grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def copy_to(x: torch.Tensor, axes: MeshAxes, entry: Entry) -> torch.Tensor:
    """Identity forward, all-reduce (sum) of the gradient over ``entry``."""
    if axes.size(entry) == 1 or not _grad(x):
        return x
    return _CopyTo.apply(x, axes, entry)


def all_reduce(x: torch.Tensor, axes: MeshAxes, entry: Entry, op: str = "sum",
               grad: str = "identity") -> torch.Tensor:
    """Sum (or ``op="max"``, which carries no gradient) over ``entry``.
    The gradient passes unchanged (``grad="identity"``) or is summed over
    the entry too (``grad="all_reduce"``)."""
    if grad not in ("identity", "all_reduce"):
        raise ValueError(f"all_reduce: grad={grad!r}")
    if axes.size(entry) == 1:
        return x
    if op != "sum" or not _grad(x):
        return _all_reduce(x.detach() if op != "sum" else x, axes, entry, op)
    return _AllReduce.apply(x, axes, entry, grad == "all_reduce")


def all_gather(x: torch.Tensor, axes: MeshAxes, entry: Entry, dim: int = 0) -> torch.Tensor:
    """The ranks' chunks along ``dim`` concatenated in rank order."""
    if axes.size(entry) == 1:
        return x
    if not _grad(x):
        return _gather(x, axes, entry, dim)
    return _AllGather.apply(x, axes, entry, dim)


def reduce_scatter(x: torch.Tensor, axes: MeshAxes, entry: Entry, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum over ``entry``."""
    if axes.size(entry) == 1:
        return x
    if not _grad(x):
        return _scatter(x, axes, entry, dim)
    return _ReduceScatter.apply(x, axes, entry, dim)


def split(x: torch.Tensor, axes: MeshAxes, entry: Entry, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a tensor every rank of ``entry``
    holds whole."""
    if axes.size(entry) == 1:
        return x
    if not _grad(x):
        return _chunk(x, axes, entry, dim)
    return _Split.apply(x, axes, entry, dim)


def sync_grads(grads, specs, axes: MeshAxes):
    """Each gradient summed over the mesh axes its leaf's spec leaves out
    (the ranks holding the same shard), one all-reduce a set of axes and
    dtype over the leaves flattened together. Every per-rank program of the
    port leaves on each rank a share of the gradient that sums to the whole
    over those ranks."""
    items = spec_leaves(specs, grads)
    out = [x for _, x, _ in items]
    buckets: Dict[Tuple, list] = {}
    for i, (_, x, s) in enumerate(items):
        used = {n for e in s for n in names_of(e)}
        rest = tuple(n for n in axes.names if n not in used)
        if axes.size(rest) > 1:
            buckets.setdefault((rest, x.dtype), []).append(i)
    for (rest, _), idx in buckets.items():
        flat = _all_reduce(torch.cat([out[i].reshape(-1) for i in idx]), axes, rest)
        offs = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[offs:offs + n].view_as(out[i])
            offs += n
    return unflatten(grads, out)


def replica_mask(sp: Spec, axes: MeshAxes) -> bool:
    """Whether this rank is the first holder of its shard of a leaf under
    ``sp`` (coordinate 0 along every axis the spec leaves out)."""
    used = {n for e in sp for n in names_of(e)}
    return all(axes.index(n) == 0 for n in axes.names if n not in used)
