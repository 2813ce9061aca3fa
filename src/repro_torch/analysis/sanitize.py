"""Pool sanitizer — runtime shadow ownership tracking, as in the reference
package's ``analysis/sanitize.py``, over device buffers.

The BatchPool ownership protocol is a single-owner MOVE discipline
enforced by convention: exactly one holder owns a pooled batch's buffers;
``release()`` returns them; ``with_mask``/``with_sip_mask``/``compact``
MOVE them. A violation doesn't fail at the faulting line — it corrupts
whatever query recycles the buffer next.

``EngineConfig.sanitize`` (env ``BARQ_SANITIZE=1``) swaps the arena for a
``SanitizingBatchPool``:

  * released buffers are **poisoned** on their own device: the released
    region of the columns is filled with ``POISON`` and of the mask with
    True (two fill launches on the card, no host read), so stale reads
    through an aliased view produce loud garbage instead of plausible ids;
  * touching a batch after its release/MOVE raises ``SanitizeError``
    naming the operator that allocated it and the creation site;
  * returning the same buffers to the pool twice raises;
  * ``drain()`` (and ``leaks()``) report batches that were never released,
    with their creation sites.

Tracking lives in a process-global ``PoolSanitizer`` installed into
``repro_torch.core.batch._SANITIZER``; its state is host Python, so no
check reads device memory. The hooks in ColumnBatch are a single ``is
None`` test when no sanitizing pool has ever been constructed, and batches
from plain pools stay untracked either way — ``sanitize=False`` behavior
is unchanged.
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import batch as _B
from repro_torch.core.batch import BatchPool, ColumnBatch

# int32 sentinel written over every released column buffer: any value this
# large is outside every dictionary, so a stale read fails loudly downstream
POISON = np.int32(-559038737)  # 0xDEADBEEF as int32


class SanitizeError(RuntimeError):
    """A BatchPool ownership-protocol violation, attributed to the
    allocating operator and creation site."""


def _creation_site() -> str:
    """file:line of the nearest caller outside batch.py / sanitize.py —
    frame-walk instead of traceback.extract_stack to keep per-allocation
    cost in the nanoseconds."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(("batch.py", "sanitize.py")):
            return f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class PoolSanitizer:
    """Shadow ownership table for batches of sanitizing pools.

    States per tracked batch: LIVE (in ``_live``) → RELEASED or MOVED
    (tombstone attribute ``_san_state`` on the batch object itself, so
    id-reuse after GC can never misattribute). Batches from plain pools
    are never entered and every hook is a dict-miss no-op for them."""

    def __init__(self) -> None:
        self._live: Dict[int, dict] = {}  # id(batch) -> info
        self._op_stack: List[str] = []
        # batches GC'd while still owning buffers: the release discipline
        # was violated even though Python reclaimed the memory
        self.gc_leaks: List[dict] = []
        self.use_after_release_errors = 0
        self.double_release_errors = 0

    # -- operator attribution (pushed by BatchOperator.next_batch) ----------

    def push_op(self, name: str) -> None:
        self._op_stack.append(name)

    def pop_op(self) -> None:
        if self._op_stack:
            self._op_stack.pop()

    def current_op(self) -> str:
        return self._op_stack[-1] if self._op_stack else "<no operator>"

    # -- lifecycle hooks (called from repro_torch.core.batch) ---------------

    def on_create(self, b: ColumnBatch) -> None:
        if not getattr(b.pool, "_sanitized", False):
            return
        info = {
            "op": self.current_op(),
            "site": _creation_site(),
            "vars": b.var_ids,
            "capacity": b.capacity,
            "pool": b.pool,
            "key": id(b),
        }
        info["ref"] = weakref.ref(b, lambda _ref, info=info: self._on_gc(info))
        self._live[id(b)] = info
        b.__dict__["_san_state"] = None  # LIVE

    def _on_gc(self, info: dict) -> None:
        if self._live.get(info["key"]) is info:
            del self._live[info["key"]]
            self.gc_leaks.append(info)

    def on_release(self, b: ColumnBatch) -> None:
        info = self._live.pop(id(b), None)
        if info is not None:
            b.__dict__["_san_state"] = ("released", self.current_op(), info)

    def on_move(self, src: ColumnBatch, dst: ColumnBatch) -> None:
        info = self._live.pop(id(src), None)
        if info is None:
            return
        src.__dict__["_san_state"] = ("moved", self.current_op(), info)
        dst_info = dict(info, key=id(dst))
        dst_info["ref"] = weakref.ref(
            dst, lambda _ref, info=dst_info: self._on_gc(info)
        )
        self._live[id(dst)] = dst_info
        dst.__dict__["_san_state"] = None

    def on_access(self, b: ColumnBatch) -> None:
        state = b.__dict__.get("_san_state")
        if state is None:
            return
        kind, by_op, info = state
        self.use_after_release_errors += 1
        raise SanitizeError(
            f"use-after-{kind}: batch vars={info['vars']} "
            f"cap={info['capacity']} allocated by {info['op']} at "
            f"{info['site']} was {kind} by {by_op}; current operator "
            f"{self.current_op()} must not touch it"
        )

    def double_release(self, pool: "SanitizingBatchPool") -> None:
        self.double_release_errors += 1
        raise SanitizeError(
            f"double-release: buffers already sitting in the pool returned "
            f"again by {self.current_op()} — two batches share ownership"
        )

    # -- reporting ----------------------------------------------------------

    def leaks(self, pool: Optional[BatchPool] = None) -> List[dict]:
        """Batches still owning buffers (never released/moved), plus any
        GC'd without release; optionally filtered to one pool."""
        out = [
            dict(info)
            for info in self._live.values()
            if pool is None or info["pool"] is pool
        ]
        out.extend(
            dict(info)
            for info in self.gc_leaks
            if pool is None or info["pool"] is pool
        )
        return out

    def leak_report(self, pool: Optional[BatchPool] = None) -> List[str]:
        return [
            f"leaked batch vars={i['vars']} cap={i['capacity']} "
            f"allocated by {i['op']} at {i['site']}"
            for i in self.leaks(pool)
        ]

    def clear(self, pool: Optional[BatchPool] = None) -> None:
        if pool is None:
            self._live.clear()
            self.gc_leaks.clear()
        else:
            self._live = {
                k: v for k, v in self._live.items() if v["pool"] is not pool
            }
            self.gc_leaks = [v for v in self.gc_leaks if v["pool"] is not pool]


_GLOBAL: Optional[PoolSanitizer] = None


def global_sanitizer() -> PoolSanitizer:
    """The process-wide tracker shared by every SanitizingBatchPool (one
    table keeps the ColumnBatch hooks a single global check)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = PoolSanitizer()
    return _GLOBAL


class SanitizingBatchPool(BatchPool):
    """Drop-in BatchPool with shadow ownership tracking + poisoned frees.

    Construction installs the global sanitizer into the batch module's
    hook point; plain pools created before or after are unaffected
    (their batches are never entered into the table)."""

    _sanitized = True

    def __init__(self, device: torch.device, max_per_bucket: int = 32,
                 sanitizer: Optional[PoolSanitizer] = None) -> None:
        super().__init__(device, max_per_bucket)
        self.sanitizer = sanitizer if sanitizer is not None else global_sanitizer()
        _B._SANITIZER = self.sanitizer
        # ids of column buffers currently sitting in the free stacks —
        # the double-release detector
        self._free_ids: Set[int] = set()

    def acquire(self, n_vars: int, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
        cols, mask = super().acquire(n_vars, capacity)
        self._free_ids.discard(id(cols))
        return cols, mask

    def release(self, cols: torch.Tensor, mask: torch.Tensor,
                used: Optional[int] = None) -> None:
        if id(cols) in self._free_ids:
            self.sanitizer.double_release(self)
        # poison on the buffers' own device: stale aliased reads see loud
        # garbage, and every padding row looks active so an un-reset mask
        # can't hide one. ``used`` (the batch's n_rows) bounds the region
        # that ever held exposed data — everything past it has been
        # poison/NULL since the last recycle. A fill of a view writes that
        # view only, so a buffer that is a slice of a larger tensor keeps
        # the rest of it.
        if used is None:
            cols.fill_(int(POISON))
            mask.fill_(True)
        elif used:
            cols[:, :used].fill_(int(POISON))
            mask[:used].fill_(True)
        super().release(cols, mask)
        key = (int(cols.shape[0]), int(cols.shape[1]))
        stack = self._free.get(key)
        if stack and stack[-1][0] is cols:  # actually pooled (not dropped)
            self._free_ids.add(id(cols))

    def drain(self) -> None:
        report = self.sanitizer.leak_report(self)
        self._free_ids.clear()
        super().drain()
        if report:
            raise SanitizeError(
                f"{len(report)} batch(es) leaked at drain:\n  "
                + "\n  ".join(report)
            )

    def leaks(self) -> List[dict]:
        return self.sanitizer.leaks(self)
