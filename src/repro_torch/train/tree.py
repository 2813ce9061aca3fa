"""Parameter trees: nested dicts, lists and tuples of tensors (the port's
stand-in for JAX pytrees), and gradients of a loss over one.

Leaves are visited in JAX's order: a dict's keys sorted, a list or tuple by
index. A leaf's path is the tuple of its keys as strings (a list index
``i`` is ``str(i)``), the tuples the reference's ``adamw_update`` hands its
``decay_mask``; joined with ``/`` it is the leaf's name in a checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in JAX's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [((), tree)]
    out = []
    for key, sub in kids:
        out.extend(((key,) + p, leaf) for p, leaf in flatten_with_paths(sub))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped as ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map: trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` over the first argument, a tree of tensors:
    ``(loss, grads)`` with grads a tree of the same structure, each in its
    parameter's dtype (zeros where the loss does not reach a leaf)."""
    def run(params, *args, **kw):
        flat = leaves(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss = loss_fn(unflatten(params, live), *args, **kw)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(params, grads)

    return run
