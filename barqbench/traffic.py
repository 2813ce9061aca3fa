"""The one traffic generator: it turns a mix file (``mixes/<traffic>.json``)
and ``--seed`` into an endless stream of rounds of requests.

A round is a seed-drawn permutation of the mix's queries, each as many
times as its ``count`` (default 1), so every seed sends the same set of
queries in another order. The constants of each round are drawn from the
mix's ``constants_seed``, not from ``--seed``: every seed sends the same
requests in each round, in another order, so the seed does not change the
work. A ``%NAME%`` placeholder in a query's text takes a value of
parameter ``NAME``, drawn by its kind:

- ``prefix`` and ``count``: the next of a seed-drawn permutation of
  ``prefix`` + 0 .. count - 1, where ``count`` is a number or a key of the
  graph's sizes (``meta``), walked in order, so no two requests of one run
  share it until the permutation wraps; or ``walk``: the same over the
  list ``meta[walk]``;
- ``uniform``: ``[lo, hi]``, a whole number drawn between the two, both
  included;
- ``table`` and ``key``: a value of the list ``meta[table][value of key]``
  (the parameter ``key`` names is drawn first), distinct from the values
  the request drew from the same table before;
- ``fixed``: the value itself.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterator, List, Optional

import numpy as np

PLACEHOLDER = re.compile(r"%([A-Z_0-9]+)%")


@dataclasses.dataclass(frozen=True)
class Request:
    name: str  # the mix's query name
    text: str
    consts: Dict[str, str]


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from any whole number."""
    entropy = 2 * abs(int(seed)) + (seed < 0)
    return [int(s) for s in np.random.SeedSequence(entropy).generate_state(n)]


class _Walk:
    def __init__(self, spec: dict, meta: dict, rng: np.random.RandomState):
        if "walk" in spec:
            self.values = meta[spec["walk"]]
        else:
            count = spec["count"]
            count = meta[count] if isinstance(count, str) else int(count)
            self.values = [f"{spec['prefix']}{i}" for i in range(count)]
        self.order = rng.permutation(len(self.values))
        self.pos = 0

    def next(self) -> str:
        v = self.values[self.order[self.pos % len(self.order)]]
        self.pos += 1
        return v


def _draw(name: str, spec: dict, walks: Dict[str, _Walk], meta: dict, consts: Dict[str, str],
          taken: Dict[str, set], rng: np.random.RandomState) -> str:
    if "fixed" in spec:
        return str(spec["fixed"])
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return str(rng.randint(lo, hi + 1))
    if "table" in spec:
        pool = meta[spec["table"]][consts[spec["key"]]]
        used = taken.setdefault(spec["table"], set())
        free = [v for v in pool if v not in used] or pool
        v = free[rng.randint(len(free))]
        used.add(v)
        return v
    return walks[name].next()


def rounds(mix: dict, meta: dict, seed: int,
           constants_seed: Optional[int] = None) -> Iterator[List[Request]]:
    """Rounds in an order drawn from ``seed``, with constants drawn from
    ``constants_seed`` (the mix's own where it is not given)."""
    order = np.random.RandomState(seed)
    rng = np.random.RandomState(mix["constants_seed"] if constants_seed is None
                                else constants_seed)
    params = mix.get("params", {})
    walks = {k: _Walk(v, meta, rng) for k, v in sorted(params.items())
             if "prefix" in v or "walk" in v}
    names = [n for n in sorted(mix["queries"]) for _ in range(mix["queries"][n].get("count", 1))]
    while True:
        out = []
        for name in names:
            text = mix["queries"][name]["text"]
            keys = list(dict.fromkeys(PLACEHOLDER.findall(text)))
            consts: Dict[str, str] = {}
            taken: Dict[str, set] = {}
            # a table's key is drawn before the values looked up by it
            for key in sorted(keys, key=lambda k: "table" in params[k]):
                consts[key] = _draw(key, params[key], walks, meta, consts, taken, rng)
            for key in keys:
                text = text.replace(f"%{key}%", consts[key])
            out.append(Request(name, text, consts))
        yield [out[i] for i in order.permutation(len(out))]
