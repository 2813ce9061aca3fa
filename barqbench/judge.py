"""The comparison that decides ``correct``.

Every request served after warm-up is judged: the rows the timed path
returned, decoded to terms, against the reference's answer for the same
query and constants, as multisets of rows. One number comes out,
``wrong_answers``: requests whose rows differ from the reference's, or that
raised. It is exact: its limit is 0.

A query spec in the mix may add ``order`` (``{"by": column, "desc":
true}``) with ``offset`` and ``limit``. The rows must then be rows of the
answer, in order by that column, and their keys must be those of the
answer's rows at positions ``offset`` .. ``offset + limit`` once sorted:
rows tied on the key may come in any order and either side of the cut.
The order is the engine's (DESIGN.md §7): numbers by value, then every
other term by its dictionary code, which is the order in which the store
loaded the terms; ``rank`` gives that key for a term.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional, Sequence, Tuple


def canon(term):
    """A term as compared: numbers as floats (an int and a float of one
    value are one answer), IRIs and strings as they are."""
    if isinstance(term, (int, float)) and not isinstance(term, bool):
        return float(term)
    return term


def compare(got: Sequence[tuple], want: Sequence[tuple], spec: dict,
            rank: Callable[[object], tuple]) -> bool:
    """Whether one answer is the reference's."""
    gk = [tuple(canon(t) for t in r) for r in got]
    wk = [tuple(canon(t) for t in r) for r in want]
    order, offset, limit = spec.get("order"), spec.get("offset", 0), spec.get("limit")
    if order is None:
        return Counter(gk) == Counter(wk)
    n = max(0, len(wk) - offset)
    if limit is not None:
        n = min(n, limit)
    if len(gk) != n or Counter(gk) - Counter(wk):
        return False
    col = spec["columns"].index(order["by"])
    sign = -1 if order.get("desc") else 1

    def key(row):
        k = rank(row[col])
        return tuple(sign * x for x in k)

    got_keys = [key(r) for r in got]
    want_keys = sorted(key(r) for r in want)[offset: offset + n]
    return got_keys == sorted(got_keys) and Counter(got_keys) == Counter(want_keys)


def judge(answers: Sequence[Tuple[str, Optional[list]]], reference: Sequence[list],
          specs: Dict[str, dict], rank: Callable[[object], tuple]) -> Dict[str, float]:
    """The checks over all judged requests. ``answers`` holds (query name,
    decoded rows or None where the request raised); ``reference`` the
    reference's rows for each."""
    wrong = 0
    for (name, got), want in zip(answers, reference):
        wrong += got is None or not compare(got, want, specs[name], rank)
    return {"wrong_answers": wrong}


def verdict(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the mix gives a limit is within it."""
    return all(checks[k] <= v for k, v in limits.items())


def ranker(graph) -> Callable[[object], tuple]:
    """The engine's ORDER BY key of a term of ``graph``: numbers by value
    first, then other terms by the order the store loaded them in."""

    def rank(term):
        if isinstance(term, (int, float)) and not isinstance(term, bool):
            return (0, float(term))
        return (1, graph.lookup(term))

    return rank
