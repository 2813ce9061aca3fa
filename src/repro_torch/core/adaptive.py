"""Adaptive batch sizing (paper §3.4).

A scan has no information on how its parent will consume the batch; a fixed
batch size overfetches badly under skip-heavy consumers (merge joins in
OLTP-style plans) and underfetches under scan-heavy consumers (pipeline
breakers like Sort). BARQ observes the pattern of next()/skip()/reset()
calls the operator *receives* and adapts the number of rows produced per
next() call.

Controller policy (bucketed to powers of two for the static-shape compile
cache, DESIGN.md §2):
  * every skip() between two next() calls is evidence of selective
    consumption -> shrink (halve);
  * a streak of next() calls with no intervening skip() is evidence of
    full consumption -> grow (double), saturating at ``max_size``.
The paper's profile (Listing 3c vs 3b) shows exactly this behaviour: scans
under a skip-heavy merge join settle small, pipeline-breaker inputs grow to
the cap. ``reset()`` restores the initial size (a new consumer epoch).
"""

from __future__ import annotations

from repro_torch.core.batch import MAX_BATCH, MIN_BATCH


class AdaptiveBatchSizer:
    def __init__(
        self,
        initial: int = 64,
        min_size: int = MIN_BATCH,
        max_size: int = MAX_BATCH,
        grow_streak: int = 2,
        enabled: bool = True,
    ) -> None:
        self.min_size = min_size
        self.max_size = max_size
        self.initial = max(min(initial, max_size), min_size)
        self.grow_streak = grow_streak
        self.enabled = enabled
        self._size = self.initial
        self._streak = 0  # consecutive next() calls without a skip()
        self._skipped_since_next = False

    @property
    def size(self) -> int:
        return self._size

    def on_next(self) -> int:
        """Called when the operator receives next(); returns rows to produce."""
        if not self.enabled:
            return self._size
        if self._skipped_since_next:
            self._skipped_since_next = False
            self._streak = 0
            self._size = max(self.min_size, self._size // 2)
        else:
            self._streak += 1
            if self._streak >= self.grow_streak:
                self._streak = 0
                self._size = min(self.max_size, self._size * 2)
        return self._size

    def on_skip(self) -> None:
        self._skipped_since_next = True

    def on_reset(self) -> None:
        self._size = self.initial
        self._streak = 0
        self._skipped_since_next = False
