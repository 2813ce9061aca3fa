"""Carry a store or a model across from plain arrays.

``store_from_arrays`` rebuilds a store from encoded quads and the terms of
their dictionary in code order — both plain numpy / Python values, such as
a reference ``QuadStore``'s SPOC index array and its decoded terms — so the
two engines run over identical codes. ``transformer_params_from_arrays``
turns a transformer's parameter tree of numpy arrays, laid out as the
reference lays it out (layers stacked on a leading axis), into the port's
parameters, so the two packages compute with the same weights;
``gnn_params_from_arrays``, ``dcn_params_from_arrays`` and
``opt_state_from_arrays`` do the same for the GNN and DCN parameter trees
and an AdamW state (a bfloat16 array, numpy's ``ml_dtypes`` type, keeps its
bits).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dictionary import Dictionary, Term
from repro_torch.core.storage import QuadStore


def store_from_arrays(quads: np.ndarray, terms: Sequence[Term], device=None) -> QuadStore:
    """A store on ``device`` (None = the CUDA card) whose term ``i`` has
    code ``i`` and which holds the (N, 4) int32 ``quads``."""
    quads = np.asarray(quads)
    if quads.ndim != 2 or quads.shape[1] != 4:
        raise ValueError(f"quads must be (N, 4), got {quads.shape}")
    d = Dictionary()
    for i, term in enumerate(terms):
        if d.encode(term) != i:
            raise ValueError(f"term {term!r} repeats: codes would not line up")
    if quads.size and (quads.min() < 0 or quads.max() >= len(terms)):
        raise ValueError("a quad names a code outside the term list")
    store = QuadStore(d, device=device)
    store.add_encoded(quads.astype(np.int32))
    return store.build()


def transformer_params_from_arrays(tree: Dict[str, Any], cfg, device=None) -> Dict[str, Any]:
    """The port's parameters (``models.transformer``) on ``device`` (None is
    the CUDA card) from ``tree``: nested dicts of numpy arrays with the
    reference's names, ``tree["layers"]`` stacked on a leading axis of
    ``cfg.n_layers`` (``moe.experts`` on the expert axis after it). Values
    and dtypes are kept."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    def walk(x, pick=None):
        if isinstance(x, dict):
            return {k: walk(v, pick) for k, v in x.items()}
        a = np.asarray(x)
        return tensor(a if pick is None else a[pick])

    layers = tree["layers"]
    lead = {np.asarray(a).shape[0] for a in _leaves(layers)}
    if lead != {cfg.n_layers}:
        raise ValueError(f"layers are stacked on {sorted(lead)}, not {cfg.n_layers}")
    return {
        "embed": walk(tree["embed"]),
        "layers": [walk(layers, i) for i in range(cfg.n_layers)],
        "ln_f": walk(tree["ln_f"]),
    }


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _tree(x, dev):
    if isinstance(x, dict):
        return {k: _tree(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, dev) for v in x)
    return _tensor(x, dev)


def gnn_params_from_arrays(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A GNN's parameters (``models.gnn.models``) on ``device`` (None is
    the CUDA card) from the reference's tree of numpy arrays: the same
    dicts and lists, values and dtypes."""
    if "layers" not in tree and "blocks" not in tree:
        raise ValueError("a GNN tree has 'layers' (or DimeNet's 'blocks')")
    return _tree(tree, resolve_device(device))


def dcn_params_from_arrays(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """DCN-v2's parameters (``models.recsys.dcn``) on ``device`` from the
    reference's tree: tables (bfloat16 ones kept in bfloat16), cross and
    MLP layers, ``w_out``."""
    if set(tree) != {"tables", "cross", "mlp", "w_out"}:
        raise ValueError(f"a DCN tree has tables, cross, mlp and w_out, not {sorted(tree)}")
    return _tree(tree, resolve_device(device))


def opt_state_from_arrays(state: Dict[str, Any], device=None) -> Dict[str, Any]:
    """An AdamW state (``train.optimizer``: ``mu``, ``nu``, ``step``) on
    ``device`` from the reference's, the moments laid out as its
    parameters (an LM's layers stay stacked, as the port trains them)."""
    if set(state) != {"mu", "nu", "step"}:
        raise ValueError(f"an AdamW state has mu, nu and step, not {sorted(state)}")
    dev = resolve_device(device)
    return {"mu": _tree(state["mu"], dev), "nu": _tree(state["nu"], dev),
            "step": _tensor(np.asarray(state["step"], np.int32), dev)}


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x
