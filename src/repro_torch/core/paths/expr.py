"""Property-path expression AST (SPARQL 1.1 §9.1 subset).

Grammar covered (parser.py):

    Path     := Alt
    Alt      := Seq ('|' Seq)*
    Seq      := Step ('/' Step)*
    Step     := '^' Elt | Elt
    Elt      := Primary ('+' | '*' | '?')?
    Primary  := <constant predicate> | '(' Path ')'

The AST is deliberately tiny and hashable: the planner estimates over it,
the engine compiles it to edge relations, and explain/profile print it via
``path_repr``. Predicates are stored as *terms* (strings), not dictionary
codes — encoding happens inside the engine, which is the only layer that
owns a store.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union


@dataclasses.dataclass(frozen=True)
class PLink:
    """A single constant predicate step."""

    pred: object  # Term (str / number)


@dataclasses.dataclass(frozen=True)
class PInv:
    """Inverse step ``^p`` — follow edges object→subject."""

    sub: "PathExpr"


@dataclasses.dataclass(frozen=True)
class PSeq:
    """Sequence ``a/b`` — relational composition, left to right."""

    parts: Tuple["PathExpr", ...]


@dataclasses.dataclass(frozen=True)
class PAlt:
    """Alternation ``a|b`` — union of pair relations."""

    parts: Tuple["PathExpr", ...]


@dataclasses.dataclass(frozen=True)
class PClosure:
    """Closure: ``+`` (min_hops=1), ``*`` (min_hops=0) and ``?``
    (min_hops=0, max_hops=1)."""

    sub: "PathExpr"
    min_hops: int  # 0 or 1
    max_hops: int = -1  # -1 = unbounded


PathExpr = Union[PLink, PInv, PSeq, PAlt, PClosure]


def path_repr(e: PathExpr) -> str:
    """Canonical display form (used by explain/profile/tests)."""
    if isinstance(e, PLink):
        return str(e.pred)
    if isinstance(e, PInv):
        return f"^{_paren(e.sub)}"
    if isinstance(e, PSeq):
        return "/".join(_paren(p) for p in e.parts)
    if isinstance(e, PAlt):
        return "|".join(_paren(p) for p in e.parts)
    if isinstance(e, PClosure):
        if e.max_hops == 1:
            mod = "?"
        elif e.min_hops == 0:
            mod = "*"
        else:
            mod = "+"
        return f"{_paren(e.sub)}{mod}"
    raise TypeError(type(e))


def _paren(e: PathExpr) -> str:
    if isinstance(e, (PSeq, PAlt)):
        return f"({path_repr(e)})"
    return path_repr(e)


def matches_zero_length(e: PathExpr) -> bool:
    """True if the path matches the empty (zero-hop) walk; a bound
    endpoint then pairs with itself even when absent from the graph."""
    if isinstance(e, PClosure):
        return e.min_hops == 0
    if isinstance(e, PSeq):
        return all(matches_zero_length(p) for p in e.parts)
    if isinstance(e, PAlt):
        return any(matches_zero_length(p) for p in e.parts)
    if isinstance(e, PInv):
        return matches_zero_length(e.sub)
    return False


def simple_transitive_pred(e: PathExpr):
    """The predicate term if ``e`` is exactly ``p+`` (the legacy
    RowTransitivePath shape), else None."""
    if (
        isinstance(e, PClosure)
        and e.min_hops == 1
        and e.max_hops == -1
        and isinstance(e.sub, PLink)
    ):
        return e.sub.pred
    return None
