"""Bidirectional term dictionary (paper §2.2.1).

Maps RDF terms (IRIs, literals, numbers) to dense int32 IDs so that all
performance-critical computation — joins, grouping, sorting, filtering on
equality — runs over numbers. A float64 *numeric side-array* supports the
paper's noted exceptions (FILTER / BIND / ORDER BY evaluate expressions over
term values): numeric comparisons decode via one vectorized ``take`` instead
of per-row string parsing.

Hardware adaptation (DESIGN.md §2): IDs are int32, not the paper's int64 —
TPUs have no native 64-bit integer path.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

Term = Union[str, int, float]


class Dictionary:
    """Insertion-ordered bidirectional term <-> int32 id mapping."""

    def __init__(self) -> None:
        self._term_to_id: Dict[Term, int] = {}
        self._id_to_term: List[Term] = []
        self._numeric: List[float] = []
        # the numeric side-array, extended in place as terms are added
        self._numeric_buf = np.empty(0, dtype=np.float64)
        self._numeric_filled = 0

    def __len__(self) -> int:
        return len(self._id_to_term)

    # -- encoding ----------------------------------------------------------

    def encode(self, term: Term) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._id_to_term)
            if tid >= np.iinfo(np.int32).max:
                raise OverflowError("dictionary exceeds int32 id space")
            self._term_to_id[term] = tid
            self._id_to_term.append(term)
            self._numeric.append(_numeric_value(term))
        return tid

    def encode_many(self, terms: Sequence[Term]) -> np.ndarray:
        return np.fromiter(
            (self.encode(t) for t in terms), dtype=np.int32, count=len(terms)
        )

    def lookup(self, term: Term) -> Optional[int]:
        """Encode-free lookup; None if the term is not in the store."""
        return self._term_to_id.get(term)

    # -- decoding ----------------------------------------------------------

    def decode(self, tid: int) -> Term:
        return self._id_to_term[tid]

    def decode_many(self, ids: Iterable[int]) -> List[Optional[Term]]:
        return [None if i < 0 else self._id_to_term[i] for i in ids]

    # -- vectorized value access (side-array) --------------------------------

    def numeric_array(self) -> np.ndarray:
        """float64 (n_terms,) — NaN for non-numeric terms. A view (not to be
        written) of a buffer that grows by doubling, so reading it after
        each encode copies only the new entries."""
        n, lo = len(self._numeric), self._numeric_filled
        if n > len(self._numeric_buf):
            buf = np.empty(max(n, 2 * len(self._numeric_buf), 1024), dtype=np.float64)
            buf[:lo] = self._numeric_buf[:lo]
            self._numeric_buf = buf
        if lo < n:
            self._numeric_buf[lo:n] = self._numeric[lo:n]
            self._numeric_filled = n
        return self._numeric_buf[:n]

    def numeric_value(self, tid: int) -> float:
        """The numeric value of one id (NaN for NULL / non-numeric)."""
        return self._numeric[tid] if tid >= 0 else float("nan")

    def numeric_of(self, ids: np.ndarray) -> np.ndarray:
        arr = self.numeric_array()
        out = np.full(ids.shape, np.nan)
        valid = ids >= 0
        out[valid] = arr[ids[valid]]
        return out


def _numeric_value(term: Term) -> float:
    if isinstance(term, bool):
        return float(term)
    if isinstance(term, (int, float)):
        return float(term)
    if isinstance(term, str):
        # typed literal shorthand '"12.5"^^xsd:decimal' or plain numeric text
        s = term
        if s.startswith('"') and "^^" in s:
            s = s[1 : s.index('"', 1)]
        try:
            return float(s)
        except ValueError:
            return float("nan")
    return float("nan")
