"""Gradient compression for the data-parallel all-reduce: error-feedback
int8 quantization (the reference's ``parallel/compression.py``).

Each leaf is quantized to int8 with a per-leaf float32 scale before the
cross-replica sum and dequantized after; the quantization residual is
carried to the next step (error feedback keeps the compressed SGD unbiased
in the limit). ``psum_compressed`` runs the reference's ``shard_map``
all-reduce over a ``torch.distributed`` process group: one ``MAX``
all-reduce of the local scales, one int32 ``SUM`` all-reduce of the
quantized values (integers add exactly), rescaled by the shared scale.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.train.tree import leaves, tree_map, unflatten

_F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(_F32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def _compress_one(g, r):
    corrected = g.to(_F32) + r
    q, s = quantize_int8(corrected)
    return q, s, corrected - dequantize_int8(q, s)


def compress_tree(grads, residuals):
    """(quantized tree, scales tree, new residuals). ``residuals`` carries
    the error-feedback state (same structure as grads, float32)."""
    parts = [_compress_one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return tuple(unflatten(grads, [p[i] for p in parts]) for i in range(3))


def decompress_tree(qs, ss, like):
    return tree_map(lambda q, s, l: dequantize_int8(q, s).to(l.dtype), qs, ss, like)


def _world(group) -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    if group is not None:
        raise ValueError("psum_compressed: a group was given but no process group is set up")
    return 1


def psum_compressed(grads, residuals, group=None):
    """Error-feedback int8 all-reduce of a gradient tree over ``group``
    (None: the default group, or this process alone where there is none).
    Returns (the mean of the ranks' gradients, new residuals)."""
    import torch.distributed as dist

    n = _world(group)

    def one(g, r):
        corrected = g.to(_F32) + r
        # a scale shared by the ranks, so the integer sum is coherent
        local_max = torch.clamp(torch.max(torch.abs(corrected)), min=1e-12)
        if n > 1:
            dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
        scale = local_max / 127.0
        q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int32)
        total = q.clone()
        if n > 1:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.to(_F32) * scale / n
        residual = corrected - q.to(_F32) * scale
        return mean.to(g.dtype), residual

    parts = [one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return unflatten(grads, [p[0] for p in parts]), unflatten(grads, [p[1] for p in parts])


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params)
