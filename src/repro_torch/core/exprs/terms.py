"""Per-term semantics shared by the expression VM and the legacy tree walk.

SPARQL term tests and string predicates are *functions of the term alone*
(not of the row), so the VM evaluates them once per distinct dictionary
entry and broadcasts the result to rows with one vectorized ``take``
(DESIGN.md §9.4). The legacy interpreted walk applies the same per-term
functions row-by-row. Sharing this module is what guarantees the two
evaluation regimes agree bit-for-bit.

Every predicate returns trinary {FALSE, TRUE, ERROR}: SPARQL builtins
raise a type error on non-string / non-matching operands, and three-valued
logic must see that as 'error', not 'false' (SparqLog's EBV tables).

Term shapes in this engine (core/dictionary.py): python int/float are
numeric literals; a str starting with '"' is a string literal (quotes kept
in the stored term, typed-literal shorthand '"lex"^^dt' allowed); any
other str is an IRI / prefixed name.
"""

from __future__ import annotations

import re
from typing import Callable, Tuple

from repro_torch.core.dictionary import Term

FALSE, TRUE, ERROR = 0, 1, 2


def _as_tri(b: bool) -> int:
    return TRUE if b else FALSE


def is_string_literal(term: Term) -> bool:
    return isinstance(term, str) and term.startswith('"')


def is_iri(term: Term) -> bool:
    return isinstance(term, str) and not term.startswith('"')


def lexical(term: Term) -> str:
    """Lexical form of a string literal (quotes / datatype tag stripped)."""
    assert isinstance(term, str)
    end = term.rfind('"')
    return term[1:end] if end > 0 else term[1:]


def _str_arg(term: Term) -> str:
    """Argument coercion for string predicates: literal lexical form only;
    numbers and IRIs are a type error (strict SPARQL 17.4.3)."""
    if not is_string_literal(term):
        raise TypeError(term)
    return lexical(term)


def _const_str(arg: Term) -> str:
    """Constant pattern argument: accept a quoted literal or a bare str."""
    if isinstance(arg, str):
        return lexical(arg) if arg.startswith('"') else arg
    raise TypeError(f"string constant expected, got {arg!r}")


def ebv(term: Term) -> int:
    """Effective boolean value of a term (SPARQL 17.2.2): numbers by value
    (0 and NaN are false), string literals by emptiness, IRIs have no EBV
    (type error)."""
    if isinstance(term, bool):
        return _as_tri(term)
    if isinstance(term, (int, float)):
        return _as_tri(term == term and term != 0)  # NaN -> false per xsd
    if is_string_literal(term):
        return _as_tri(len(lexical(term)) > 0)
    return ERROR


def term_predicate(name: str, args: Tuple[Term, ...]) -> Callable[[Term], int]:
    """The trinary per-term function for a builtin test. ``args`` are the
    constant arguments (pattern strings, regex flags); the term being
    tested is the callable's input."""
    if name == "ebv":
        return ebv
    if name == "isnumeric":
        return lambda t: _as_tri(isinstance(t, (int, float)))
    if name == "isiri":
        return lambda t: _as_tri(is_iri(t))
    if name == "isliteral":
        return lambda t: _as_tri(
            isinstance(t, (int, float)) or is_string_literal(t)
        )
    if name in ("strstarts", "strends", "contains"):
        pat = _const_str(args[0])

        def _sp(t: Term, name=name, pat=pat) -> int:
            try:
                s = _str_arg(t)
            except TypeError:
                return ERROR
            if name == "strstarts":
                return _as_tri(s.startswith(pat))
            if name == "strends":
                return _as_tri(s.endswith(pat))
            return _as_tri(pat in s)

        return _sp
    if name == "regex":
        flags = 0
        if len(args) > 1 and "i" in _const_str(args[1]):
            flags |= re.IGNORECASE
        rx = re.compile(_const_str(args[0]), flags)

        def _re(t: Term, rx=rx) -> int:
            try:
                s = _str_arg(t)
            except TypeError:
                return ERROR
            return _as_tri(rx.search(s) is not None)

        return _re
    raise ValueError(f"unknown term predicate {name!r}")
