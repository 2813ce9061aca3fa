"""AdamW and its schedule (the reference's ``train/optimizer.py``) over
trees of tensors.

The rules are the reference's: global-norm clipping by
``min(1, clip / max(gnorm, 1e-9))``, bias correction at the incremented
step, weight decay only on leaves of two or more dimensions that
``decay_mask(path)`` allows (paths as ``train.tree`` gives them), the
update in float32 cast back to each parameter's dtype. The update is
functional: it returns new trees and writes none of its inputs, so a
checkpoint's host copy can never see a half-updated state. Every result
stays on the device (the metrics are device scalars): no host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.train.tree import flatten_with_paths, leaves, tree_map, unflatten

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine down to
    ``lr * min_lr_ratio`` at ``total_steps``; float32, on ``step``'s
    device (the CPU for a Python number)."""
    step = torch.as_tensor(step).to(_F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict[str, Any]:
    """Zero moments shaped (and typed) as the parameters, step 0 (int32 on
    the first leaf's device)."""
    dev = leaves(params)[0].device
    zeros = tree_map(torch.zeros_like, params)
    return {"mu": zeros, "nu": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, axes=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, added in leaf
    order. Over a mesh (``axes``, with the leaves' ``specs``) the leaves
    are this rank's shards: each shard's squares are counted once, by its
    first holder (a leaf replicated over an axis is counted on coordinate 0
    of it), and one all-reduce over the mesh adds the ranks' sums."""
    if axes is None or axes.world == 1:
        total = None
        for x in leaves(tree):
            sq = torch.sum(torch.square(x.to(_F32)))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    from repro_torch.parallel import sharding as SH

    total = torch.zeros((), dtype=_F32, device=leaves(tree)[0].device)
    for x, sp in zip(leaves(tree), leaves(specs)):
        if SH.replica_mask(sp, axes):
            total = total + torch.sum(torch.square(x.to(_F32)))
    return torch.sqrt(SH.all_reduce(total, axes, axes.names))


def adamw_update(cfg: OptimizerConfig, params, grads, state,
                 decay_mask: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                 gnorm: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, metrics); metrics are the gradient's
    norm before clipping and the step's learning rate. ``gnorm`` is the
    norm where the caller has it (``grads`` a slice of the gradients, as
    under ZeRO-1)."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(_F32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    flat_p = flatten_with_paths(params)
    out_p, out_mu, out_nu = [], [], []
    for (path, p), g, mu, nu in zip(flat_p, leaves(grads), leaves(state["mu"]),
                                    leaves(state["nu"])):
        g = g.to(_F32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        upd = mhat / (torch.sqrt(nhat) + cfg.eps)
        do_decay = True if decay_mask is None else decay_mask(path)
        pf = p.to(_F32)
        if do_decay and p.dim() >= 2:
            newp = pf - lr * (upd + cfg.weight_decay * pf)
        else:
            newp = pf - lr * upd
        out_p.append(newp.to(p.dtype))
        out_mu.append(mu)
        out_nu.append(nu)
    new_state = {"mu": unflatten(params, out_mu), "nu": unflatten(params, out_nu),
                 "step": step}
    return unflatten(params, out_p), new_state, {"grad_norm": gnorm, "lr": lr}
