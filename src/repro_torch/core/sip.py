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
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.bloom_filter import SipTerm, bloom_build, sip_mask


class SipFilter:
    def __init__(self, var: int):
        self.var = var
        self._provider: Optional[Callable] = None
        self._ready = False
        self._available = False
        self.words: Optional[torch.Tensor] = None
        self.lo = 0
        self.hi = -1  # (0, -1) == provably empty build side

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

    def mask(self, codes: torch.Tensor) -> Optional[torch.Tensor]:
        """Bool keep-mask over ``codes`` (range and bloom membership), or
        None for pass-through. May keep non-members (bloom false
        positives), never drops a member. The bloom probe launches on
        every batch: testing first whether any code is in range would be a
        host read per batch, and the AND gives the same mask."""
        t = self.term(codes)
        return None if t is None else sip_mask(None, int(codes.shape[0]), [t])
