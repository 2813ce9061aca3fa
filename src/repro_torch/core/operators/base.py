"""Vector Volcano operator API (paper §3.1), as in the reference package.

Each operator pulls *batches* from its children via ``next_batch()`` and may
reposition sorted children via ``skip()`` — BARQ's distinguishing addition to
the vectorized pull model. ``reset()`` restarts iteration. The reference's
per-operator runtime statistics (EXPLAIN ANALYZE) are not ported; the
out-of-core and adaptive operators keep the reference's ``stats.extra``
counters under its key names in a plain ``extra`` dict (``spill_bytes``,
``spill_files``, ``grace_partitions``, ``repartitions``,
``hash_build_rows``, ``adaptive_switches``, ``adaptive_qerror``) and their
decision in ``detail``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.batch import ColumnBatch


class BatchOperator:
    """Base class: pull-based batch iteration with skip support."""

    def __init__(self, name: str, detail: str = "") -> None:
        self.name = name
        self.detail = detail
        self.extra: Dict[str, float] = {}

    def next_batch(self) -> Optional[ColumnBatch]:
        """The next output batch, or None when exhausted."""
        raise NotImplementedError

    def skip(self, var: int, target: int) -> None:
        """Reposition so subsequent batches only contain rows with
        column ``var`` >= ``target``. Only valid if ``sorted_by() == var``."""
        raise NotImplementedError(f"{self.name} does not support skip()")

    def reset(self) -> None:
        """Restart iteration from the beginning."""
        raise NotImplementedError

    # -- metadata -------------------------------------------------------------

    def var_ids(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def sorted_by(self) -> Optional[int]:
        return None

    def supports_skip(self) -> bool:
        return self.sorted_by() is not None

    def children(self) -> List["BatchOperator"]:
        return []

    # -- resource teardown -----------------------------------------------------

    def _close(self) -> None:
        """Per-operator teardown hook: release buffers only."""


class CloseError(RuntimeError):
    """One or more ``_close`` hooks raised during tree teardown. The walk
    still visited every operator first; ``errors`` carries each failure as
    (operator name, exception)."""

    def __init__(self, errors) -> None:
        self.errors = list(errors)
        detail = "; ".join(
            f"{name}: {type(e).__name__}: {e}" for name, e in self.errors
        )
        super().__init__(
            f"{len(self.errors)} operator close() failure(s): {detail}"
        )


def close_tree(op) -> None:
    """Walk an operator tree (batch or row; duck-typed on ``children``) and
    invoke every ``_close`` hook. An exception from one hook doesn't stop
    the walk — a failed unlink must not leak the rest of the tree's spill
    files — but it is not swallowed either: after every operator has been
    visited, the collected failures re-raise as one ``CloseError``."""
    stack = [op]
    errors = []
    while stack:
        o = stack.pop()
        cl = getattr(o, "_close", None)
        if cl is not None:
            try:
                cl()
            except Exception as e:  # keep closing siblings first
                errors.append((getattr(o, "name", type(o).__name__), e))
        ch = getattr(o, "children", None)
        if ch is not None:
            try:
                stack.extend(ch())
            except Exception as e:
                errors.append((type(o).__name__, e))
    if errors:
        raise CloseError(errors)
