"""Vectorized merge join with skip() — the paper's core operator (§3.2).

The sort-merge join in three phases, as in the reference package:

  Probe  — find matching *groups* (left range, right range with the same
           key) as runs in the sorted key columns of the current windows;
  Build  — the ``join_expand`` kernel turns the groups into (li, ri)
           gather indices, slot-parallel; ``gather_emit`` then gathers,
           NULL-extends and checks the secondary keys in one launch,
           writing straight into a pooled output batch;
  Skip   — gallop the side whose last key is smaller via child.skip().

Windows are device ring/doubling buffers (append in place, trims are head
bumps). With ``spill_dir`` set, a right window past
``_SPILL_THRESHOLD_ROWS`` live rows writes them to a ``.npy`` file and
frees its device buffer, keeping only its key column on the device: it
goes on trimming and searching groups there, and each emitted batch
gathers the right rows it needs from the file's memory map and uploads
them as that launch's ``gather_emit`` source (one device-to-host read of
the batch's right indices). A later append brings the window back onto
the device and unlinks the file. Left-row match tracking is an int32
count per window row, bumped with ``index_add_`` so no mask has to be
read back per batch. Modes:
inner, left_outer (OPTIONAL, with the post-filter program), semi, anti.
The control flow reads a few device scalars per batch (window keys, group
totals); each is one host synchronisation.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import vecops
from repro_torch.core.adaptive import AdaptiveBatchSizer
from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, bucket_for
from repro_torch.core.operators.base import BatchOperator
from repro_torch.core.operators.simple import expr_mask, resolve_program
from repro_torch.kernels.gather_emit import EmitPlan, gather_emit
from repro_torch.kernels.join_expand import join_expand

_SPILL_THRESHOLD_ROWS = 1 << 20
_WINDOW_MIN_CAP = 256  # rows; first append sizes the buffer (pow2 doubling)


class _Window:
    """Sorted row window for one side: payload columns keyed by the join
    variable, accumulated across child batches and trimmed as the other
    side advances. Live rows occupy ``_buf[:, head:tail]``, or, once
    spilled, ``_host[:, head:tail]`` (a memory map of the spill file) with
    their keys in ``_keys[head:tail]`` on the device."""

    def __init__(self, var_ids: Tuple[int, ...], key_var: int,
                 device: torch.device, pool: Optional[BatchPool] = None,
                 spill_dir: Optional[str] = None):
        self.var_ids = var_ids
        self.key_pos = var_ids.index(key_var)
        self.device = device
        self._buf = torch.empty((len(var_ids), 0), dtype=torch.int32, device=device)
        self._head = 0
        self._tail = 0
        self.exhausted = False
        self.pool = pool  # copy-traffic accounting
        self.spill_dir = spill_dir
        self._spill_path: Optional[str] = None
        self._host: Optional[np.ndarray] = None  # spilled rows (memory map)
        self._keys: Optional[torch.Tensor] = None  # a spilled window's keys
        self.spills = 0

    @property
    def spilled(self) -> bool:
        return self._host is not None

    @property
    def cols(self) -> torch.Tensor:
        """Live rows as an (n_vars, n) device view (resident windows)."""
        if self.spilled:
            raise RuntimeError("a spilled window keeps its rows on the host; use source()")
        return self._buf[:, self._head: self._tail]

    @property
    def keys(self) -> torch.Tensor:
        if self.spilled:
            return self._keys[self._head: self._tail]
        return self._buf[self.key_pos, self._head: self._tail]

    @property
    def n(self) -> int:
        return self._tail - self._head

    def last_key(self) -> int:
        keys = self._keys if self.spilled else self._buf[self.key_pos]
        return int(keys[self._tail - 1])

    def append_batch(self, b: ColumnBatch) -> int:
        n = b.n_active
        if n == 0:
            b.release()
            return 0
        self._reserve(n)
        idx = [b.col_index(v) for v in self.var_ids]
        src = b.columns[idx, : b.n_rows]
        if n != b.n_rows:
            src = src[:, b.selection_vector().long()]
        self._buf[:, self._tail: self._tail + n] = src
        self._tail += n
        if self.pool is not None:
            self.pool.bytes_copied += n * len(self.var_ids) * 4
        b.release()
        if self.spill_dir and self.n > _SPILL_THRESHOLD_ROWS:
            self._spill()
        return n

    def drop_prefix(self, k: int) -> None:
        if k > 0:
            self._head += k  # valid for spilled windows too

    def trim_below(self, key: int) -> int:
        """Drop rows with keys < key; returns number dropped."""
        if self.n == 0:
            return 0
        needle = torch.tensor([key], dtype=torch.int32, device=self.device)
        cut = int(torch.searchsorted(self.keys, needle))
        self.drop_prefix(cut)
        return cut

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        src, idx = self.source(idx)
        return src[:, idx.long()]

    def source(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, indices into them) standing for live rows ``idx``: the
        device view and ``idx`` itself for a resident window; for a
        spilled one, the rows ``idx`` names gathered from the memory map
        and uploaded, and 0..n-1."""
        if not self.spilled:
            return self.cols, idx
        rows = self._host[:, self._head + idx.cpu().numpy().astype(np.int64)]
        n = int(idx.shape[0])
        return (torch.from_numpy(np.ascontiguousarray(rows)).to(self.device),
                torch.arange(n, dtype=torch.int32, device=self.device))

    def close(self) -> None:
        self._drop_spill()
        self._buf = torch.empty((len(self.var_ids), 0), dtype=torch.int32, device=self.device)
        self._head = self._tail = 0

    def _reserve(self, n: int) -> None:
        if self.spilled:
            self._materialize(extra=n)
        cap = int(self._buf.shape[1])
        if self._tail + n <= cap:
            return
        live = self.n
        if live + n <= cap and self._head >= live:
            # shift live rows to the front (regions don't overlap)
            self._buf[:, :live] = self._buf[:, self._head: self._tail]
            if self.pool is not None:
                self.pool.bytes_copied += live * len(self.var_ids) * 4
            self._head, self._tail = 0, live
            return
        new_cap = max(cap, _WINDOW_MIN_CAP)
        while new_cap < live + n:
            new_cap *= 2
        nb = torch.empty((len(self.var_ids), new_cap), dtype=torch.int32, device=self.device)
        nb[:, :live] = self._buf[:, self._head: self._tail]
        if self.pool is not None:
            self.pool.bytes_copied += live * len(self.var_ids) * 4
        self._buf, self._head, self._tail = nb, 0, live

    def _spill(self) -> None:
        """Write the live rows to a spill file, keep their keys on the
        device, and free the device buffer."""
        live = self.cols
        fd, path = tempfile.mkstemp(suffix=".npy", dir=self.spill_dir)
        os.close(fd)
        self._spill_path = path
        np.save(path, live.cpu().numpy())
        self._keys = live[self.key_pos].clone()
        self._host = np.load(path, mmap_mode="r")
        self._buf = torch.empty((len(self.var_ids), 0), dtype=torch.int32, device=self.device)
        self._head, self._tail = 0, int(live.shape[1])
        self.spills += 1

    def _materialize(self, extra: int = 0) -> None:
        live = self.n
        cap = _WINDOW_MIN_CAP
        while cap < live + extra:
            cap *= 2
        nb = torch.empty((len(self.var_ids), cap), dtype=torch.int32, device=self.device)
        nb[:, :live] = torch.from_numpy(
            np.array(self._host[:, self._head: self._tail])).to(self.device)
        if self.pool is not None:
            self.pool.bytes_copied += live * len(self.var_ids) * 4
        self._drop_spill()
        self._buf, self._head, self._tail = nb, 0, live

    def _drop_spill(self) -> None:
        self._host = None
        self._keys = None
        if self._spill_path is not None:
            path, self._spill_path = self._spill_path, None
            os.unlink(path)


class MergeJoin(BatchOperator):
    def __init__(
        self,
        left: BatchOperator,
        right: BatchOperator,
        join_var: int,
        device: torch.device,
        mode: str = "inner",
        post_filter=None,  # Expr over materialized rows (OPTIONAL {...} FILTER)
        dictionary=None,
        sizer: Optional[AdaptiveBatchSizer] = None,
        allow_child_skip: bool = True,
        pool: Optional[BatchPool] = None,
        post_program=None,  # compiled ExprProgram for post_filter (planner)
        spill_dir: Optional[str] = None,  # the right window spills here
    ) -> None:
        if mode not in ("inner", "left_outer", "semi", "anti"):
            raise ValueError(f"unknown join mode {mode!r}")
        if left.sorted_by() != join_var or right.sorted_by() != join_var:
            raise ValueError("merge join inputs must be sorted by the join var")
        self.left = left
        self.right = right
        self.v = join_var
        self.device = device
        self.mode = mode
        self.post_filter = post_filter
        self.dictionary = dictionary
        self.post_program = (
            None if post_filter is None
            else resolve_program(post_filter, dictionary, post_program, "mask")
        )
        self.sizer = sizer or AdaptiveBatchSizer(initial=256)
        self.allow_child_skip = allow_child_skip
        self.pool = pool
        self.spill_dir = spill_dir

        lv, rv = tuple(left.var_ids()), tuple(right.var_ids())
        self.shared = tuple(x for x in lv if x in rv)
        if join_var not in self.shared:
            raise ValueError("join var missing from an input")
        self.secondary = tuple(x for x in self.shared if x != join_var)
        if mode in ("semi", "anti"):
            self._right_out: Tuple[int, ...] = ()
        else:
            self._right_out = tuple(x for x in rv if x not in lv)
        self._out_vars: Tuple[int, ...] = lv + self._right_out

        # static gather_emit plans: emit all left rows, then the right-only
        # rows; secondary keys become pairs (the mask-only plan emits none)
        pairs = [(lv.index(sv), rv.index(sv)) for sv in self.secondary]
        self._plan = EmitPlan(range(len(lv)), [rv.index(x) for x in self._right_out], pairs)
        self._mask_plan = EmitPlan(pairs=pairs)

        self._lwin = _Window(lv, join_var, device, pool)
        self._rwin = _Window(rv, join_var, device, pool, spill_dir)
        # per left-window row: number of surviving matches seen so far
        self._lmatched = torch.zeros(0, dtype=torch.int32, device=device)
        # pending build: (lstarts, llens, rstarts, rlens, cum, emitted, total)
        self._pending: Optional[Tuple] = None
        self._finalize_l_hi: Optional[int] = None
        self._leftover_queue: List[torch.Tensor] = []  # (n_lvars, n) row blocks
        self._done = False
        self._needs_expansion_for_match = bool(self.secondary) or post_filter is not None
        super().__init__("MergeJoin", f"(?v{join_var}) mode={mode}")

    # -- metadata ---------------------------------------------------------------

    def var_ids(self) -> Tuple[int, ...]:
        return self._out_vars

    def sorted_by(self) -> Optional[int]:
        # left_outer interleaves NULL-extended rows after each probe window,
        # breaking global key order; inner/semi/anti preserve it.
        return None if self.mode == "left_outer" else self.v

    def children(self) -> List[BatchOperator]:
        return [self.left, self.right]

    # -- iteration ----------------------------------------------------------------

    def _next(self) -> Optional[ColumnBatch]:
        cap = bucket_for(self.sizer.on_next())
        while True:
            if self._pending is not None:
                out = self._emit_pending(cap)
                if self._pending is None and self._finalize_l_hi is not None:
                    self._finalize_probe()
                if out is not None:
                    return out
                continue
            if self._finalize_l_hi is not None:
                self._finalize_probe()
                continue
            if self._leftover_queue:
                return self._emit_leftovers(cap)
            if self._done:
                return None
            if not self._advance():
                self._done = True

    def _skip(self, var: int, target: int) -> None:
        if var != self.v:
            raise ValueError("skip on non-join var")
        self._pending = None
        self._finalize_l_hi = None
        self._leftover_queue.clear()
        dropped = self._lwin.trim_below(target)
        self._lmatched = self._lmatched[dropped:]
        self._rwin.trim_below(target)
        if self.left.supports_skip():
            self.left.skip(self.v, target)
        if self.right.supports_skip():
            self.right.skip(self.v, target)

    def _close(self) -> None:
        self._lwin.close()
        self._rwin.close()

    def _reset(self) -> None:
        self._close()
        self.left.reset()
        self.right.reset()
        self._lwin = _Window(self._lwin.var_ids, self.v, self.device, self.pool)
        self._rwin = _Window(self._rwin.var_ids, self.v, self.device, self.pool, self.spill_dir)
        self._lmatched = torch.zeros(0, dtype=torch.int32, device=self.device)
        self._pending = None
        self._finalize_l_hi = None
        self._leftover_queue.clear()
        self._done = False

    # -- fetch helpers -------------------------------------------------------------

    def _fetch_left(self) -> bool:
        if self._lwin.exhausted:
            return False
        b = self.left.next_batch()
        if b is None:
            self._lwin.exhausted = True
            return False
        grown = self._lwin.append_batch(b)
        if grown:
            self._lmatched = torch.cat([
                self._lmatched,
                torch.zeros(grown, dtype=torch.int32, device=self.device),
            ])
        return True

    def _fetch_right(self) -> bool:
        if self._rwin.exhausted:
            return False
        b = self.right.next_batch()
        if b is None:
            self._rwin.exhausted = True
            return False
        self._rwin.append_batch(b)
        return True

    # -- state machine ----------------------------------------------------------------

    def _advance(self) -> bool:
        """Create new work (a pending build or queued leftovers).
        Returns False when fully exhausted."""
        while self._lwin.n == 0:
            if not self._fetch_left():
                return False
        while self._rwin.n == 0 and not self._rwin.exhausted:
            self._fetch_right()

        if self._rwin.n == 0:  # right side is empty and exhausted
            if self.mode in ("left_outer", "anti"):
                self._probe(self._lwin.n)
                return True
            return False

        # Probe boundary: right runs with key < the window's last key are
        # complete; the last run may continue into the next right batch.
        if self._rwin.exhausted:
            l_hi = self._lwin.n
        else:
            needle = torch.tensor([self._rwin.last_key()], dtype=torch.int32,
                                  device=self.device)
            l_hi = int(torch.searchsorted(self._lwin.keys, needle))

        if l_hi > 0:
            self._probe(l_hi)
            return True

        # Left frontier is at/above the right boundary: grow the right window.
        l_first = int(self._lwin.keys[0])
        if self.allow_child_skip and self.right.supports_skip() and self._rwin.last_key() < l_first:
            self.right.skip(self.v, l_first)  # Skip phase (paper 3.a)
        self._fetch_right()
        return True

    def _probe(self, l_hi: int) -> None:
        """Probe left rows [0, l_hi) against the right window; queue the
        build. Finalization happens after the build is fully emitted."""
        lkeys = self._lwin.keys[:l_hi]
        lvals, lstarts, llens = vecops.run_boundaries(lkeys)
        rvals, rstarts, rlens = vecops.run_boundaries(self._rwin.keys)
        gl, gr = vecops.probe_groups(lvals, rvals)
        n_groups = int(gl.shape[0])

        if n_groups and not self._needs_expansion_for_match:
            # primary-key membership decides matched: mark the ranges with
            # a +1/-1 boundary diff and a running sum
            d = torch.zeros(l_hi + 1, dtype=torch.int32, device=self.device)
            ls = lstarts[gl].long()
            ll = llens[gl].long()
            one = torch.ones(n_groups, dtype=torch.int32, device=self.device)
            d.index_add_(0, ls, one)
            d.index_add_(0, ls + ll, -one)
            self._lmatched[:l_hi] += (torch.cumsum(d[:-1], 0) > 0).to(torch.int32)

        need_build = n_groups > 0 and (
            self.mode in ("inner", "left_outer") or self._needs_expansion_for_match
        )
        if need_build:
            g_ls, g_ll = lstarts[gl], llens[gl]
            g_rs, g_rl = rstarts[gr], rlens[gr]
            cum = vecops.group_output_offsets(g_ll, g_rl)
            total = int(cum[-1])
            if total > 0:
                self._pending = (g_ls, g_ll, g_rs, g_rl, cum, 0, total)
        self._finalize_l_hi = l_hi

    def _finalize_probe(self) -> None:
        l_hi = self._finalize_l_hi
        self._finalize_l_hi = None
        if self.mode == "semi":
            sel = torch.nonzero(self._lmatched[:l_hi] > 0).flatten()
            if sel.shape[0]:
                self._leftover_queue.append(self._lwin.gather(sel))
        elif self.mode in ("left_outer", "anti"):
            um = torch.nonzero(self._lmatched[:l_hi] == 0).flatten()
            if um.shape[0]:
                self._leftover_queue.append(self._lwin.gather(um))

        self._lwin.drop_prefix(l_hi)
        self._lmatched = self._lmatched[l_hi:]

        if self._lwin.n > 0:
            self._rwin.trim_below(int(self._lwin.keys[0]))
        elif not self._lwin.exhausted:
            # Skip phase: gallop left to the right frontier (inner/semi only —
            # outer/anti must still observe unmatched left rows)
            if (
                self._rwin.n > 0
                and self.allow_child_skip
                and self.mode in ("inner", "semi")
                and self.left.supports_skip()
            ):
                self.left.skip(self.v, int(self._rwin.keys[0]))
            self._fetch_left()
            if self._lwin.n > 0:
                self._rwin.trim_below(int(self._lwin.keys[0]))

    # -- emission ----------------------------------------------------------------

    def _emit_pending(self, cap: int) -> Optional[ColumnBatch]:
        g_ls, g_ll, g_rs, g_rl, cum, emitted, total = self._pending
        count = min(cap, total - emitted)
        li, ri = join_expand(g_ls, g_ll, g_rs, g_rl, cum, emitted, count)
        emitted += count
        self._pending = (
            None if emitted >= total else (g_ls, g_ll, g_rs, g_rl, cum, emitted, total)
        )

        rcols, ri = self._rwin.source(ri)
        if self.mode in ("semi", "anti") and self.post_filter is None:
            # expansion only feeds matched-tracking: fused mask, no columns
            _, mask = gather_emit(self._lwin.cols, rcols, li, ri, self._mask_plan)
            self._lmatched.index_add_(0, li.long(), mask.to(torch.int32))
            return None

        b = ColumnBatch.alloc(
            self._out_vars, bucket_for(max(count, 1)), self.device, self.pool, self.v
        )
        _, mask = gather_emit(self._lwin.cols, rcols, li, ri, self._plan, out=b.columns)
        b.n_rows = count
        if count < b.capacity:
            b.columns[:, count:] = NULL_ID
        b.mask[:count] = mask
        b.dense = not self._plan.pairs  # no pair to test: every row is active
        if self.pool is not None:
            self.pool.bytes_copied += len(self._out_vars) * count * 4
        if self.post_filter is not None:
            # OPTIONAL {...} FILTER condition (VM, or the tree walk)
            b = b.with_mask(expr_mask(self.post_filter, self.post_program, b, self.dictionary))

        if self._needs_expansion_for_match:
            self._lmatched.index_add_(0, li.long(), b.mask[:count].to(torch.int32))

        if self.mode in ("semi", "anti"):
            b.release()
            return None  # expansion only feeds matched-tracking
        if b.n_active:
            return b
        b.release()
        return None

    def _emit_leftovers(self, cap: int) -> ColumnBatch:
        rows = self._leftover_queue.pop(0)
        n = int(rows.shape[1])
        if n > cap:
            self._leftover_queue.insert(0, rows[:, cap:])
            rows = rows[:, :cap]
            n = cap
        out_cols = [rows[i] for i in range(rows.shape[0])]
        for _ in self._right_out:
            out_cols.append(torch.full((n,), NULL_ID, dtype=torch.int32, device=self.device))
        return ColumnBatch.from_columns(
            self._out_vars, out_cols, self.device, self.v, pool=self.pool
        )
