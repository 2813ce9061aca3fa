"""Sideways information passing: the runtime SipFilter handle.

A SipFilter carries a summary of a join's build side — the min/max code
range plus a blocked bloom filter over the build keys — sideways from the
join that produces it into the probe-side scans, which consume it before
the join sees their rows:

  * a scan sorted by the filtered variable seeks to the range's low end
    and stops past its high end, and bloom-masks inside the range;
  * an unsorted scan applies the range and bloom test as a batch mask:
    every filter of the batch in one ``sip_mask`` launch (``term``).

No false negatives, so SIP is a pure prefilter: the same multiset of rows
with SIP on or off.

The filter is lazy: the translator binds a provider closure onto the
exporting join, and the first consuming scan forces it. Providers return
("keys", tensor) for a bloom + range summary, ("range", lo, hi) for a
range only, or None, which leaves the filter a pass-through.

Each filter counts, for every batch a consumer tests, the rows it pruned
and whether it probed its words (a code fell inside its range), as the
reference counts a filter: one row of ``counts`` a batch, filled by the
mask's own launch, so counting takes no launch and no host read. A
consumer's stats keep its filters with the batches each had seen after
its last batch (``sip_seen``); the reference's ``sip_pruned_rows`` and
``sip_probe_dispatches`` are the sums up to there (``sip_totals``), read
back with the query's row counts.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.bloom_filter import SipTerm, bloom_build, sip_mask

# the counter rows a filter's table starts with; it doubles when full
_FIRST_ROWS = 64


class SipFilter:
    def __init__(self, var: int):
        self.var = var
        self._provider: Optional[Callable] = None
        self._ready = False
        self._available = False
        self.words: Optional[torch.Tensor] = None
        self.lo = 0
        self.hi = -1  # (0, -1) == provably empty build side
        # per batch tested, in order: rows pruned, bloom probe (0 or 1)
        self.batches = 0
        self.counts: Optional[torch.Tensor] = None  # (rows, 2) int64

    # -- producer side -----------------------------------------------------

    def bind(self, provider: Callable) -> None:
        """Attach the build-side summary provider (translator wiring)."""
        self._provider = provider

    def ensure(self) -> None:
        if self._ready:
            return
        self._ready = True
        payload = self._provider() if self._provider is not None else None
        if payload is None:
            return  # pass-through: nothing derivable from the build side
        if payload[0] == "keys":
            self.words, self.lo, self.hi = bloom_build(payload[1].contiguous())
        else:  # ("range", lo, hi)
            _, self.lo, self.hi = payload
        self._available = True

    # -- consumer side -----------------------------------------------------

    def code_range(self) -> Optional[Tuple[int, int]]:
        """(lo, hi) inclusive build-key range, or None for pass-through.
        hi < lo means the build side is empty: nothing can match."""
        self.ensure()
        return (self.lo, self.hi) if self._available else None

    def term(self, codes: torch.Tensor) -> Optional[SipTerm]:
        """The filter over ``codes`` as ``sip_mask`` takes it, ``(codes,
        words or None, lo, hi)``, or None for pass-through."""
        self.ensure()
        if not self._available:
            return None
        return codes, self.words, self.lo, self.hi

    def next_counts(self, device: torch.device) -> torch.Tensor:
        """The zeroed (2,) counter row of the next batch tested."""
        if self.counts is None or self.batches == int(self.counts.shape[0]):
            grown = torch.zeros((max(_FIRST_ROWS, 2 * self.batches), 2), dtype=torch.int64,
                                device=device)
            if self.counts is not None:
                grown[: self.batches] = self.counts
            self.counts = grown
        self.batches += 1
        return self.counts[self.batches - 1]

    def mask(self, codes: torch.Tensor) -> Optional[torch.Tensor]:
        """Bool keep-mask over ``codes`` (range and bloom membership), or
        None for pass-through. May keep non-members (bloom false
        positives), never drops a member. The bloom probe launches on
        every batch: testing first whether any code is in range would be a
        host read per batch, and the AND gives the same mask."""
        t = self.term(codes)
        return None if t is None else sip_mask(None, int(codes.shape[0]), [t])


def apply_sip(b, filters: Sequence[SipFilter]):
    """``b`` masked by every filter of ``filters`` over its variable's
    column, each filter counting this batch in its next counter row: one
    ``sip_mask`` launch."""
    pairs = [(f, t) for f, t in ((f, f.term(b.column(f.var))) for f in filters)
             if t is not None]
    if not pairs:
        return b
    return b.with_sip_mask([t for _, t in pairs],
                           [f.next_counts(b.device) for f, _ in pairs])


def sip_seen(stats, filters: Sequence[SipFilter]) -> None:
    """Record on ``stats`` that its operator's counters are ``filters``'
    sums as they stand now, after its latest batch (the reference sets
    them after every batch)."""
    stats.sip = [(f, f.batches) for f in filters]


def sip_totals(seen: Sequence[Tuple[SipFilter, int]]) -> Optional[torch.Tensor]:
    """The (2,) int64 device sums (pruned rows, bloom probes) over each
    filter's first batches as ``sip_seen`` recorded them, or None where
    no batch was counted."""
    parts: List[torch.Tensor] = [f.counts[:n].sum(0) for f, n in seen if n]
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum(0)
