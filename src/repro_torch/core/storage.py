"""Sorted quad storage on the device (paper §2.2.1).

Each index order keeps its four quad columns as contiguous int32 tensors on
the store's device, sorted lexicographically by the order's permutation —
the reference's per-column index copies, moved to device memory.
``range_for_pattern`` and ``seek`` (the merge join's ``skip()``) are
``torch.searchsorted`` probes with needles in the column dtype. The host
copies are the index arrays (``index_array``), made lazily for each order
something reads: SPOC for the planner's statistics, and the orders the row
engine scans, which it searches with ``np.searchsorted``
(``host_range_for_pattern``, ``host_seek``) so that a row scan, a skip or
a path over the store never waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dictionary import Dictionary, Term
from repro_torch.core.vecops import lexsort

# column roles in a quad
S, P, O, C = 0, 1, 2, 3

INDEX_ORDERS: Dict[str, Tuple[int, int, int, int]] = {
    "spoc": (S, P, O, C),
    "posc": (P, O, S, C),
    "ospc": (O, S, P, C),
    # predicate-subject order: lets ?s <p> ?o scans come out sorted by
    # subject, which is what BGP merge joins on subjects want.
    "psoc": (P, S, O, C),
}


@dataclasses.dataclass
class ScanRange:
    """A contiguous row range [lo, hi) within one index."""

    index: str
    lo: int
    hi: int

    def __len__(self) -> int:
        return self.hi - self.lo


class QuadStore:
    """Sorted quad indexes on one device + a host dictionary."""

    def __init__(self, dictionary: Optional[Dictionary] = None,
                 device=None) -> None:
        """``device=None`` is the CUDA card (raises where there is none)."""
        self.dict = dictionary or Dictionary()
        self.device = resolve_device(device)
        self._index_cols: Dict[str, List[torch.Tensor]] = {}
        self._host: Dict[str, np.ndarray] = {}
        self._pending: list = []
        self._pred_rows: Dict[int, Tuple[int, int]] = {}
        self.n_quads = 0

    # -- loading -------------------------------------------------------------

    def add(self, s: Term, p: Term, o: Term, g: Term = ":default") -> None:
        self._pending.append(
            (
                self.dict.encode(s),
                self.dict.encode(p),
                self.dict.encode(o),
                self.dict.encode(g),
            )
        )

    def add_encoded(self, quads: np.ndarray) -> None:
        """Bulk-add already-encoded (N, 4) int32 quads."""
        self._pending.append(np.asarray(quads, dtype=np.int32))

    def build(self) -> "QuadStore":
        """Deduplicate, sort every index order on the device, and freeze."""
        parts = []
        for item in self._pending:
            if isinstance(item, np.ndarray):
                parts.append(item.reshape(-1, 4))
            else:
                parts.append(np.asarray([item], dtype=np.int32))
        raw = (
            np.concatenate(parts, axis=0)
            if parts
            else np.zeros((0, 4), dtype=np.int32)
        )
        self._pending = []
        quads = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device).T.contiguous()
        # dedupe (RDF graphs are sets of triples): sort SPOC, drop repeats
        quads = quads[:, lexsort((quads[3], quads[2], quads[1], quads[0]))]
        if quads.shape[1] > 1:
            keep = torch.ones(quads.shape[1], dtype=torch.bool, device=self.device)
            keep[1:] = (quads[:, 1:] != quads[:, :-1]).any(dim=0)
            quads = quads[:, keep]
        self.n_quads = int(quads.shape[1])
        self._host = {}
        for name, perm in INDEX_ORDERS.items():
            cols = quads[list(perm)]
            if name != "spoc":
                cols = cols[:, lexsort((cols[3], cols[2], cols[1], cols[0]))]
            self._index_cols[name] = [cols[i].contiguous() for i in range(4)]
        # each predicate's rows of the PSOC index, read to the host once here
        # so that cutting a predicate's edges (the fused counts) waits for
        # nothing
        preds, counts = torch.unique_consecutive(self._index_cols["psoc"][0],
                                                 return_counts=True)
        ends = counts.cumsum(0)
        self._pred_rows = {p: (e - c, e) for p, c, e in
                           zip(*torch.stack([preds.long(), counts, ends]).tolist())}
        return self

    def device_bytes(self) -> int:
        return sum(c.numel() * c.element_size()
                   for cols in self._index_cols.values() for c in cols)

    # -- pattern evaluation ----------------------------------------------------

    def index_array(self, name: str) -> np.ndarray:
        """(N, 4) int32 host copy of one index, columns in index order (the
        planner's statistics read SPOC once)."""
        arr = self._host.get(name)
        if arr is None:
            arr = torch.stack(self._index_cols[name], dim=1).cpu().numpy()
            self._host[name] = arr
        return arr

    def index_columns(self, name: str) -> List[torch.Tensor]:
        return self._index_cols[name]

    def predicate_range(self, pid: Optional[int]) -> ScanRange:
        """The PSOC rows of predicate ``pid`` (empty for an unknown one),
        from the bounds ``build`` kept on the host: no device read."""
        lo, hi = self._pred_rows.get(pid, (0, 0))
        return ScanRange("psoc", lo, hi)

    def choose_index(
        self, bound: Sequence[Optional[int]], want_sorted_role: Optional[int]
    ) -> str:
        """Pick the index whose order puts bound roles first and the desired
        output-sort role next. ``bound`` is (s, p, o, c) with None = free."""
        best, best_score = "spoc", -1
        for name, perm in INDEX_ORDERS.items():
            score = 0
            i = 0
            while i < 4 and bound[perm[i]] is not None:
                score += 4
                i += 1
            n_bound = sum(b is not None for b in bound)
            if score // 4 < n_bound:
                continue  # some bound role is not in the prefix: unusable
            if want_sorted_role is not None and i < 4 and perm[i] == want_sorted_role:
                score += 2
            if score > best_score:
                best, best_score = name, score
        if best_score < 0:
            return "spoc"
        return best

    def range_for_pattern(
        self, index: str, bound: Sequence[Optional[int]]
    ) -> ScanRange:
        """Binary-search the row range matching the bound prefix."""
        cols = self._index_cols[index]
        perm = INDEX_ORDERS[index]
        lo, hi = 0, self.n_quads
        for col_pos in range(4):
            v = bound[perm[col_pos]]
            if v is None:
                break
            col = cols[col_pos][lo:hi]
            needle = torch.tensor([v], dtype=col.dtype, device=col.device)
            offs = torch.cat([
                torch.searchsorted(col, needle),
                torch.searchsorted(col, needle, right=True),
            ]).tolist()
            lo, hi = lo + offs[0], lo + offs[1]
        return ScanRange(index, lo, hi)

    def read(self, rng: ScanRange, start: int, count: int) -> List[torch.Tensor]:
        """Up to ``count`` rows at offset ``start`` within the range, as the
        four column slices in index order (views, no copy)."""
        lo = rng.lo + start
        hi = min(lo + count, rng.hi)
        return [c[lo:hi] for c in self._index_cols[rng.index]]

    def seek(self, rng: ScanRange, start: int, sort_col_pos: int, target: int) -> int:
        """skip(): offset (>= start) of first row whose key at ``sort_col_pos``
        within the index order is >= target."""
        col = self._index_cols[rng.index][sort_col_pos][rng.lo + start: rng.hi]
        needle = torch.tensor([target], dtype=col.dtype, device=col.device)
        return start + int(torch.searchsorted(col, needle))

    # -- host-side search over the index arrays (the row engine) -------------

    def host_range_for_pattern(
        self, index: str, bound: Sequence[Optional[int]]
    ) -> ScanRange:
        """``range_for_pattern`` over the host copy of the index."""
        arr = self.index_array(index)
        perm = INDEX_ORDERS[index]
        lo, hi = 0, len(arr)
        for col_pos in range(4):
            v = bound[perm[col_pos]]
            if v is None:
                break
            # a needle in the column dtype: a Python int would make numpy
            # cast the whole column before searching
            col, v = arr[lo:hi, col_pos], np.int32(v)
            lo, hi = (lo + int(np.searchsorted(col, v, side="left")),
                      lo + int(np.searchsorted(col, v, side="right")))
        return ScanRange(index, lo, hi)

    def host_seek(self, rng: ScanRange, start: int, sort_col_pos: int, target: int) -> int:
        """``seek`` over the host copy of the index."""
        col = self.index_array(rng.index)[rng.lo + start: rng.hi, sort_col_pos]
        return start + int(np.searchsorted(col, np.int32(target), side="left"))

    # -- stats for the optimizer ------------------------------------------------

    def pattern_cardinality(self, bound: Sequence[Optional[int]]) -> int:
        idx = self.choose_index(bound, None)
        return len(self.range_for_pattern(idx, bound))
