"""Production meshes (the reference's ``launch/mesh.py``) as
``torch.distributed`` device meshes over the default process group.

Single pod: (16, 16) = 256 ranks, dimensions (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, dimensions (pod, data, model) — the pod
dimension extends data parallelism across pods.

Functions, not module constants: importing this module touches no process
group. The default group must exist with the mesh's world size (the dry
run makes a ``fake`` one of 256 or 512 ranks; a real run makes NCCL or
gloo). The mesh is on the CUDA card unless the caller passes
``device="cpu"``; without a card that raises, naming CUDA.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a mesh of CPU ranks")
        return "cuda"
    return torch.device(device).type


def make_mesh(shape: Sequence[int], names: Tuple[str, ...], device=None):
    """A ``DeviceMesh`` of ``shape`` over the default group, ranks laid out
    row-major (the last dimension fastest)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = _device_type(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group (init_process_group first)")
    n = 1
    for s in shape:
        n *= int(s)
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh: a {tuple(shape)} mesh needs {n} ranks, the default group "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(dev, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(device=None):
    """The one-rank mesh with the production dimension names."""
    return make_mesh((1, 1), ("data", "model"), device)
