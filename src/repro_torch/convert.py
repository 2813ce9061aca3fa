"""Carry a store across from plain arrays.

``store_from_arrays`` rebuilds a store from encoded quads and the terms of
their dictionary in code order — both plain numpy / Python values, such as
a reference ``QuadStore``'s SPOC index array and its decoded terms — so the
two engines run over identical codes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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
