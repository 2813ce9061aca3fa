"""Carry a store or a model across from plain arrays.

``store_from_arrays`` rebuilds a store from encoded quads and the terms of
their dictionary in code order — both plain numpy / Python values, such as
a reference ``QuadStore``'s SPOC index array and its decoded terms — so the
two engines run over identical codes. ``transformer_params_from_arrays``
turns a transformer's parameter tree of numpy arrays, laid out as the
reference lays it out (layers stacked on a leading axis), into the port's
parameters, so the two packages compute with the same weights.
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


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x
