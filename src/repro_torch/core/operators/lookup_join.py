"""Lookup join: the sort-based join for a small unsorted build side.

The build side is materialized once on the device and sorted by the key
(code order); every probe batch is looked up with ``torch.searchsorted``.
Each probe row is then a length-1 left range joined against its build run,
so emission reuses the merge join's ``join_expand`` + ``gather_emit``
kernels (NULL-extending unmatched left_outer rows through a virtual -1
build index). Output preserves probe-side order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, bucket_for
from repro_torch.core.operators.base import BatchOperator
from repro_torch.core.operators.sort import materialize
from repro_torch.kernels.gather_emit import EmitPlan, gather_emit
from repro_torch.kernels.join_expand import join_expand

_I32 = torch.int32


class LookupJoin(BatchOperator):
    def __init__(
        self,
        probe: BatchOperator,
        build: BatchOperator,
        join_var: int,
        device: torch.device,
        mode: str = "inner",
        pool: Optional[BatchPool] = None,
    ) -> None:
        if mode not in ("inner", "left_outer", "semi", "anti"):
            raise ValueError(f"unknown join mode {mode!r}")
        self.probe = probe
        self.build = build
        self.v = join_var
        self.device = device
        self.mode = mode
        self.pool = pool
        pv, bv = tuple(probe.var_ids()), tuple(build.var_ids())
        if join_var not in pv or join_var not in bv:
            raise ValueError("join var missing from an input")
        self.secondary = tuple(x for x in pv if x in bv and x != join_var)
        # left_outer + secondary keys needs per-group survivor tracking —
        # the planner routes that case to MergeJoin
        if mode == "left_outer" and self.secondary:
            raise ValueError("LookupJoin left_outer with secondary join keys; use MergeJoin")
        if mode in ("semi", "anti"):
            self._build_out: Tuple[int, ...] = ()
        else:
            self._build_out = tuple(x for x in bv if x not in pv)
        self._out_vars = pv + self._build_out
        self._built = False
        self._bcols: Optional[torch.Tensor] = None
        self._bkeys: Optional[torch.Tensor] = None
        # static gather_emit plans (the mask-only plan emits no rows)
        pairs = [(pv.index(sv), bv.index(sv)) for sv in self.secondary]
        self._plan = EmitPlan(range(len(pv)), [bv.index(x) for x in self._build_out], pairs)
        self._mask_plan = EmitPlan(pairs=pairs)
        # continuation of an oversized expansion
        self._pending: Optional[Tuple] = None
        super().__init__("LookupJoin", f"(?v{join_var}) mode={mode}")

    def var_ids(self) -> Tuple[int, ...]:
        return self._out_vars

    def sorted_by(self) -> Optional[int]:
        return self.probe.sorted_by()

    def children(self) -> List[BatchOperator]:
        return [self.probe, self.build]

    def _ensure_built(self) -> None:
        if self._built:
            return
        bvars, bcols = materialize(self.build, self.device)
        key = bcols[bvars.index(self.v)]
        order = torch.sort(key, stable=True).indices
        self._bcols = bcols[:, order].contiguous()
        self._bkeys = key[order].contiguous()
        self._built = True

    def _next(self) -> Optional[ColumnBatch]:
        self._ensure_built()
        cap = bucket_for(4096)
        while True:
            if self._pending is not None:
                out = self._emit_pending(cap)
                if out.n_active:
                    return out
                out.release()  # fully masked-out block: recycle
                continue
            pb = self.probe.next_batch()
            if pb is None:
                return None
            cb = pb.compact()
            if cb.n_rows == 0:
                cb.release()
                continue
            keys = cb.column(self.v)
            lo = torch.searchsorted(self._bkeys, keys).to(_I32)
            hi = torch.searchsorted(self._bkeys, keys, right=True).to(_I32)
            lens = hi - lo
            if self.mode in ("semi", "anti"):
                if self.secondary:
                    out = self._secondary_exists(cb, lo, lens, self.mode == "semi")
                else:
                    m = torch.zeros(cb.capacity, dtype=torch.bool, device=self.device)
                    m[: cb.n_rows] = (lens > 0) if self.mode == "semi" else (lens == 0)
                    out = cb.with_mask(m)
                if out.n_active:
                    return out
                out.release()
                continue
            # inner / left_outer: groups = (probe row i, build run lo[i:hi[i]))
            pstarts = torch.arange(cb.n_rows, dtype=_I32, device=self.device)
            plens = torch.ones(cb.n_rows, dtype=_I32, device=self.device)
            if self.mode == "left_outer":
                # unmatched probe rows emit one NULL-extended row: a run of
                # length 1 against a virtual NULL build row
                eff_lens = lens.clamp(min=1)
            else:
                keep = lens > 0
                pstarts, plens = pstarts[keep], plens[keep]
                lo, lens = lo[keep], lens[keep]
                eff_lens = lens
            if pstarts.shape[0] == 0:
                cb.release()
                continue
            cum = vecops.group_output_offsets(plens, eff_lens)
            self._pending = (cb, pstarts, plens, lo, lens, eff_lens, cum, 0, int(cum[-1]))

    def _secondary_exists(self, cb: ColumnBatch, lo, lens,
                          want_match: bool) -> ColumnBatch:
        """semi/anti with secondary keys: a probe row matches if any build
        row in its run agrees on all secondary keys — the fused equality
        mask of gather_emit, reduced per probe row with a scatter."""
        n = cb.n_rows
        hits = torch.zeros(n, dtype=_I32, device=self.device)
        nz = torch.nonzero(lens > 0).flatten()
        if nz.shape[0]:
            pstarts = nz.to(_I32)
            plens = torch.ones(nz.shape[0], dtype=_I32, device=self.device)
            glens = lens[nz].contiguous()
            cum = vecops.group_output_offsets(plens, glens)
            total = int(cum[-1])
            li, ri = join_expand(pstarts, plens, lo[nz].contiguous(), glens, cum, 0, total)
            _, ok = gather_emit(cb.columns, self._bcols, li, ri, self._mask_plan)
            hits.scatter_add_(0, li.long(), ok.to(_I32))
        matched = hits > 0
        m = torch.zeros(cb.capacity, dtype=torch.bool, device=self.device)
        m[:n] = matched if want_match else ~matched
        return cb.with_mask(m)

    def _emit_pending(self, cap: int) -> ColumnBatch:
        cb, pstarts, plens, lo, lens, eff_lens, cum, emitted, total = self._pending
        count = min(cap, total - emitted)
        li, ri = join_expand(pstarts, plens, lo, eff_lens, cum, emitted, count)
        base = emitted
        emitted += count
        done = emitted >= total
        self._pending = None if done else (
            cb, pstarts, plens, lo, lens, eff_lens, cum, emitted, total
        )
        if self.mode == "left_outer":
            # rows from virtual NULL runs (unmatched probe rows): mark their
            # build index -1 so gather_emit NULL-extends them
            slots = base + torch.arange(count, dtype=torch.int64, device=self.device)
            group_of = torch.searchsorted(cum, slots, right=True) - 1
            ri = torch.where(lens[group_of] == 0, -1, ri).to(_I32)
        b = ColumnBatch.alloc(
            self._out_vars, bucket_for(max(count, 1)), self.device, self.pool,
            self.sorted_by(),
        )
        _, mask = gather_emit(cb.columns, self._bcols, li, ri, self._plan, out=b.columns)
        b.n_rows = count
        if count < b.capacity:
            b.columns[:, count:] = NULL_ID
        b.mask[:count] = mask
        b.dense = not self._plan.pairs  # no pair to test: every row is active
        if self.pool is not None:
            self.pool.bytes_copied += len(self._out_vars) * count * 4
        if done:
            cb.release()
        return b

    def _skip(self, var: int, target: int) -> None:
        if self._pending is not None:
            self._pending[0].release()
        self._pending = None
        self.probe.skip(var, target)

    def _reset(self) -> None:
        self.probe.reset()
        self.build.reset()
        if self._pending is not None:
            self._pending[0].release()
        self._pending = None
        self._built = False

    def _close(self) -> None:
        # early teardown mid-expansion: the pending probe batch still owns
        # pooled buffers
        if self._pending is not None:
            self._pending[0].release()
            self._pending = None
