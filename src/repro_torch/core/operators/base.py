"""Vector Volcano operator API (paper §3.1), as in the reference package.

Each operator pulls *batches* from its children via ``next_batch()`` and may
reposition sorted children via ``skip()`` — BARQ's distinguishing addition to
the vectorized pull model. ``reset()`` restarts iteration. The public
methods keep per-operator runtime statistics (``OpStats``) for EXPLAIN
ANALYZE, cardinality feedback and the query trace, and call the
implementation hooks ``_next`` / ``_skip`` / ``_reset`` that every operator
overrides instead.

Counting an operator's output rows never waits for the device. A batch
whose active count is known on the host (``ColumnBatch.dense``: every row
of the filled prefix is active) adds that integer. Any other batch adds its
mask's sum into a slot of a small int64 buffer on the batch's device (one
reduction launch, no read back); the executor turns every operator's
pending device count into a host integer with one copy per query
(``pending_counts`` / ``settle_counts``). ``stats.results`` read before
that settles the one operator it is read on.

Counters in ``stats.extra`` are host values written straight into the
dict, apart from the SIP filters' pruned rows and bloom probes, which the
filters count on the device (``core.sip``): an operator that tests
filters records them in ``stats.sip``, and their sums join the same one
copy a query, landing in ``extra`` when it settles. ``HostTimer`` times
the ``_ms`` counters.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import batch as _batch
from repro_torch.core.batch import ColumnBatch
from repro_torch.core.sip import sip_totals

# per-batch device counts an operator keeps before folding them into one
_SLOTS = 256

# kernel launches the row counting has made in this process (a per-batch
# reduction, a fold of the slots, the settle's sums and stack), for the
# card's launch accounting; like the kernels' counters, never reset here
count_launches = 0


class _DeviceCount:
    """Active rows of the batches an operator emitted with masks only the
    device knows: one int64 slot per batch, folded into ``carry`` when the
    slots run out."""

    __slots__ = ("buf", "n", "carry")

    def __init__(self, device: torch.device) -> None:
        self.buf = torch.empty(_SLOTS, dtype=torch.int64, device=device)
        self.n = 0
        self.carry: Optional[torch.Tensor] = None

    def add(self, mask: torch.Tensor) -> None:
        global count_launches
        if self.n == _SLOTS:
            s = self.buf.sum()
            self.carry = s if self.carry is None else self.carry + s
            self.n = 0
            count_launches += 1 if self.carry is s else 2
        torch.sum(mask, dim=0, out=self.buf[self.n])
        self.n += 1
        count_launches += 1

    def total(self) -> torch.Tensor:
        """A 0-d device tensor: the rows counted so far (not read back)."""
        global count_launches
        t = self.buf[: self.n].sum()
        count_launches += 1 if self.carry is None else 2
        return t if self.carry is None else t + self.carry


class OpStats:
    __slots__ = (
        "name",
        "detail",
        "_results",
        "_pending",
        "batches",
        "next_calls",
        "skip_calls",
        "reset_calls",
        "wall_time",
        "rows_scanned",
        "est_rows",
        "est_source",
        "node_fp",
        "extra",
        "sip",
    )

    def __init__(self, name: str, detail: str = "") -> None:
        self.name = name
        self.detail = detail
        self._results = 0  # output rows (active) settled on the host
        self._pending: Optional[_DeviceCount] = None  # rows counted on the device
        self.batches = 0  # output batches
        self.next_calls = 0  # next() calls received
        self.skip_calls = 0  # skip() calls received
        self.reset_calls = 0
        self.wall_time = 0.0  # host seconds inside this operator (self+children)
        self.rows_scanned = 0  # storage rows read (scans only; overfetch metric)
        # planner cardinality estimate for this operator's Phys node, or
        # None when lowering had no estimate (EXPLAIN ANALYZE input)
        self.est_rows: Optional[float] = None
        # where the estimate came from: "stats" (cost model) or "feedback"
        # (observed-cardinality override)
        self.est_source: str = "stats"
        # the Phys node's stable fingerprint (planner), or None for
        # programmatically built trees / adapters — the key the executor
        # records actual cardinalities under
        self.node_fp: Optional[str] = None
        # operator-specific counters (spill bytes, host copies, ...); the
        # profiler prints and aggregates them generically
        self.extra: dict = {}
        # the SIP filters this operator tests, each with the batches it had
        # counted after the operator's latest batch (``core.sip.sip_seen``),
        # until the query settles their sums into ``extra``
        self.sip: Optional[list] = None

    @property
    def results(self) -> int:
        """Output rows, a host int. A pending device count is read back
        here (one host sync) unless the executor has settled it."""
        if self._pending is not None:
            self.settle(int(self._pending.total()))
        return self._results

    @results.setter
    def results(self, value: int) -> None:
        self._pending = None
        self._results = int(value)

    def count(self, b: ColumnBatch) -> None:
        """Add ``b``'s active rows: the host int where the batch knows it,
        else one reduction into a device slot."""
        if b.dense or not b.n_rows:
            self._results += b.n_rows
            return
        if self._pending is None:
            self._pending = _DeviceCount(b.device)
        self._pending.add(b.mask[: b.n_rows])

    def pending(self) -> Optional[torch.Tensor]:
        """The device count not yet read back (0-d int64), or None."""
        return None if self._pending is None else self._pending.total()

    def settle(self, device_rows: int) -> None:
        """Fold the value of ``pending()`` into the host count."""
        self._pending = None
        self._results += int(device_rows)


class HostTimer:
    """Calls of one kind and their summed host time: on the card the time
    to prepare and enqueue their launches (and any sync inside them), as
    ``kernel_wall_s`` is. ``with timer:`` times one call."""

    __slots__ = ("calls", "wall_s", "_t0")

    def __init__(self) -> None:
        self.calls = 0
        self.wall_s = 0.0

    def __enter__(self) -> "HostTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.calls += 1
        self.wall_s += time.perf_counter() - self._t0

    @property
    def ms(self) -> float:
        """The summed time in ms, as the reference rounds it."""
        return round(self.wall_s * 1e3, 3)


SIP_KEYS = ("sip_pruned_rows", "sip_probe_dispatches")


class _SipCount:
    """One of an operator's two SIP counters, settled like its row count."""

    __slots__ = ("stats", "key")

    def __init__(self, stats: OpStats, key: str) -> None:
        self.stats, self.key = stats, key

    def settle(self, value: int) -> None:
        self.stats.extra[self.key] = int(value)
        self.stats.sip = None


def pending_counts(root) -> Tuple[list, Optional[torch.Tensor]]:
    """What in ``root``'s tree (batch or row operators) is still on the
    device, each with a ``settle(value)``: the stats whose row counts
    are, and the SIP counters (``_SipCount``); and their values stacked
    into one int64 device tensor (None when everything is on the host).
    SIP counters with no batch counted are set to 0 here."""
    stats: list = []
    values: List[torch.Tensor] = []
    stack = [root]
    while stack:
        op = stack.pop()
        st = op.stats
        if st._pending is not None:
            stats.append(st)
            values.append(st.pending())
        if st.sip is not None:
            tot = sip_totals(st.sip)
            for k, key in enumerate(SIP_KEYS):
                if tot is None:
                    st.extra[key] = 0
                else:
                    stats.append(_SipCount(st, key))
                    values.append(tot[k])
            if tot is None:
                st.sip = None
        stack.extend(op.children())
    global count_launches
    if not stats:
        return stats, None
    count_launches += 1
    return stats, torch.stack(values)


def settle_counts(root) -> None:
    """Turn every pending device row count in ``root``'s tree into a host
    int with one device-to-host copy, or none when every count is on the
    host already."""
    stats, dev = pending_counts(root)
    if dev is not None:
        for s, v in zip(stats, dev.tolist()):  # the one copy
            s.settle(v)


class BatchOperator:
    """Base class: pull-based batch iteration with skip support."""

    def __init__(self, name: str, detail: str = "") -> None:
        self.stats = OpStats(name, detail)

    # -- public API (wrapped for stats) --------------------------------------

    def next_batch(self) -> Optional[ColumnBatch]:
        """The next output batch, or None when exhausted."""
        st = self.stats
        st.next_calls += 1
        san = _batch._SANITIZER
        if san is not None:
            # pool-sanitizer attribution scope: batches acquired while this
            # operator runs carry its name, so leak / use-after-release
            # reports name the allocating operator
            san.push_op(st.name)
        t0 = time.perf_counter()
        try:
            b = self._next()
        finally:
            st.wall_time += time.perf_counter() - t0
            if san is not None:
                san.pop_op()
        if b is not None:
            st.batches += 1
            st.count(b)
        return b

    def skip(self, var: int, target: int) -> None:
        """Reposition so subsequent batches only contain rows with
        column ``var`` >= ``target``. Only valid if ``sorted_by() == var``."""
        self.stats.skip_calls += 1
        t0 = time.perf_counter()
        try:
            self._skip(var, target)
        finally:
            self.stats.wall_time += time.perf_counter() - t0

    def reset(self) -> None:
        """Restart iteration from the beginning."""
        self.stats.reset_calls += 1
        self._reset()

    # -- metadata -------------------------------------------------------------

    def var_ids(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def sorted_by(self) -> Optional[int]:
        return None

    def supports_skip(self) -> bool:
        return self.sorted_by() is not None

    def can_skip(self, var: Optional[int]) -> bool:
        """True iff skip(var, ...) is valid on this operator."""
        return var is not None and self.sorted_by() == var

    def children(self) -> List["BatchOperator"]:
        return []

    # -- resource teardown -----------------------------------------------------

    def close(self) -> None:
        """Release buffers and spill files for this operator and its whole
        subtree. Stats survive."""
        close_tree(self)

    def _close(self) -> None:
        """Per-operator teardown hook: release buffers only."""

    # -- implementation hooks ---------------------------------------------------

    def _next(self) -> Optional[ColumnBatch]:
        raise NotImplementedError

    def _skip(self, var: int, target: int) -> None:
        raise NotImplementedError(f"{self.stats.name} does not support skip()")

    def _reset(self) -> None:
        raise NotImplementedError

    # -- convenience --------------------------------------------------------------

    def drain(self) -> List[ColumnBatch]:
        """Every non-empty output batch (reads each batch's active count)."""
        out = []
        while True:
            b = self.next_batch()
            if b is None:
                return out
            if b.n_active:
                out.append(b)


class CloseError(RuntimeError):
    """One or more ``_close`` hooks raised during tree teardown. The walk
    still visited every operator first; ``errors`` carries each failure as
    (operator name, exception)."""

    def __init__(self, errors: Sequence) -> None:
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
                st = getattr(o, "stats", None)
                errors.append((st.name if st is not None else type(o).__name__, e))
        ch = getattr(o, "children", None)
        if ch is not None:
            try:
                stack.extend(ch())
            except Exception as e:
                errors.append((type(o).__name__, e))
    if errors:
        raise CloseError(errors)
