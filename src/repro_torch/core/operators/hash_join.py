"""Radix-partitioned hash join for unsorted inputs.

The build side is materialized once on the device and laid out by
``hash_build``: rows bucketed by multiplicative-hash partition id (the
``radix_partition`` kernel) and key-sorted within each partition. The
probe side streams through untouched: one ``hash_probe`` launch per batch
locates every probe key's contiguous match run. Emission reuses the merge
join's Build machinery: every probe row is a length-1 left range expanded
against its run (``join_expand``) and materialized through ``gather_emit``
into pooled buffers, so probe-side order is preserved.

Join keys: one shared variable hashes its raw code column (NULL_ID == -1
is an ordinary value that equals itself, as in the merge join). Several
shared variables pack through ``vecops.pack_group_keys`` with spans fixed
from the build side (one sentinel slot per column, so out-of-range probe
values never match) into an int64 split as an (hi, lo) int32 pair; if the
span product overflows 62 bits, the join hashes the primary variable and
verifies the rest through ``gather_emit`` equality pairs.

Modes: inner, left_outer (with the LeftJoin condition: a probe row whose
matches all fail it still emits NULL-extended), semi and anti. An empty
key tuple is the constant-key join: inner is the cross product,
left_outer the NULL-extending cross, anti "drop everything iff the build
has a row".

The out-of-core (grace) build is not ported; the translator refuses plans
that ask for it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.core.adaptive import AdaptiveBatchSizer
from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, bucket_for
from repro_torch.core.exprs.vm import eval_program_mask
from repro_torch.core.operators.base import BatchOperator
from repro_torch.core.operators.simple import resolve_program
from repro_torch.core.operators.sort import materialize
from repro_torch.kernels.gather_emit import EmitPlan, gather_emit
from repro_torch.kernels.hash_join import hash_build, hash_probe
from repro_torch.kernels.join_expand import join_expand

_I32 = torch.int32

# target rows per partition: keeps the in-partition binary search shallow
_PART_TARGET = 4096
_MAX_PARTS = 1024


def _n_parts_for(n_build: int) -> int:
    p = 1
    while p * _PART_TARGET < n_build and p < _MAX_PARTS:
        p *= 2
    return p


class HashJoin(BatchOperator):
    # pair-verified semi/anti expand their runs in chunks of this many slots
    _EXISTS_CHUNK = 1 << 16

    def __init__(
        self,
        probe: BatchOperator,
        build: BatchOperator,
        keys: Tuple[int, ...],
        device: torch.device,
        mode: str = "inner",
        post_filter=None,  # LeftJoin condition (OPTIONAL {...} FILTER)
        dictionary=None,
        sizer: Optional[AdaptiveBatchSizer] = None,
        pool: Optional[BatchPool] = None,
        post_program=None,  # compiled ExprProgram for post_filter (planner)
        n_parts: Optional[int] = None,
    ) -> None:
        if mode not in ("inner", "left_outer", "semi", "anti"):
            raise ValueError(f"unknown join mode {mode!r}")
        self.probe = probe
        self.build = build
        self.keys = tuple(keys)
        self.device = device
        self.mode = mode
        self.post_filter = post_filter
        self.dictionary = dictionary
        self.post_program = (
            None if post_filter is None
            else resolve_program(post_filter, dictionary, post_program, "mask")
        )
        self.sizer = sizer or AdaptiveBatchSizer(initial=256)
        self.pool = pool
        self._n_parts_cfg = n_parts

        pv, bv = tuple(probe.var_ids()), tuple(build.var_ids())
        self._pv, self._bv = pv, bv
        shared = tuple(x for x in pv if x in bv)
        if not all(k in shared for k in self.keys):
            raise ValueError(f"hash keys {self.keys} are not all shared ({shared})")
        # shared vars outside the hash key are verified per emitted row via
        # gather_emit equality pairs
        self._extra_shared = tuple(x for x in shared if x not in self.keys)
        if mode in ("semi", "anti"):
            self._build_out: Tuple[int, ...] = ()
        else:
            self._build_out = tuple(x for x in bv if x not in pv)
        self._out_vars = pv + self._build_out
        # per probe-batch schema: the emit plan and the mask-only plan
        self._plans: Dict[Tuple[int, ...], Tuple[EmitPlan, EmitPlan]] = {}

        # build-side state (filled by _ensure_built)
        self._built = False
        self._bcols: Optional[torch.Tensor] = None  # partition-grouped layout
        self._n_build = 0
        self._part_starts: Optional[torch.Tensor] = None
        self._skh: Optional[torch.Tensor] = None
        self._skl: Optional[torch.Tensor] = None
        self._spans: Optional[List[int]] = None  # fixed multi-key pack spans
        self._hash_vars: Tuple[int, ...] = self.keys  # may shrink on overflow
        self._pair_vars: Tuple[int, ...] = self._extra_shared

        # probe-side continuation state
        self._pending: Optional[Tuple] = None
        # (cb, matched) for left_outer batches that track matches per row
        self._track: Optional[Tuple[ColumnBatch, torch.Tensor]] = None
        self._leftovers: List[torch.Tensor] = []  # (n_pv, n) unmatched rows
        # skip() floor: a parent may gallop past `target` while pending
        # expansions still hold rows >= target — those must survive, so the
        # floor masks emitted rows below it instead of dropping the batch
        self._skip_floor: Optional[Tuple[int, int]] = None
        super().__init__("HashJoin")

    # -- metadata ---------------------------------------------------------------

    def var_ids(self) -> Tuple[int, ...]:
        return self._out_vars

    def sorted_by(self) -> Optional[int]:
        # probe order is preserved: expansions walk probe rows in order and
        # plain left_outer NULL rows are emitted in place. Tracked
        # left_outer queues its NULL rows after the batch's expansions.
        if self._needs_tracking():
            return None
        return self.probe.sorted_by()

    def children(self) -> List[BatchOperator]:
        return [self.probe, self.build]

    def _needs_tracking(self) -> bool:
        return self.mode == "left_outer" and (
            self.post_filter is not None or bool(self._pair_vars)
        )

    # -- build phase -------------------------------------------------------------

    def _ensure_built(self) -> None:
        if self._built:
            return
        bvars, bcols = materialize(self.build, self.device)
        self._bv = bvars
        self._plans = {}
        self._n_build = int(bcols.shape[1])
        if self.keys:
            self._build_resident(bcols)
        else:
            self._bcols = bcols
        self._built = True

    def _build_resident(self, bcols: torch.Tensor) -> None:
        n = self._n_build
        kcols = bcols[[self._bv.index(k) for k in self.keys]]
        self._spans = None
        self._hash_vars = self.keys
        self._pair_vars = self._extra_shared
        if len(self.keys) > 1:
            # one sentinel slot per column (max+3) so clamped out-of-range
            # probe values can never collide with a real build key
            maxes = kcols.amax(dim=1).tolist() if n else [-1] * len(self.keys)
            spans = [int(m) + 3 for m in maxes]
            packed = vecops.pack_group_keys(kcols, spans=spans)
            if packed is None:
                # span overflow: hash the primary key, verify the rest via
                # gather_emit equality pairs
                self._hash_vars = self.keys[:1]
                self._pair_vars = self.keys[1:] + self._extra_shared
                bh, bl = None, kcols[0].contiguous()
            else:
                self._spans = spans
                bh = (packed >> 31).to(_I32)
                bl = (packed & 0x7FFFFFFF).to(_I32)
        else:
            bh, bl = None, kcols[0].contiguous()
        n_parts = self._n_parts_cfg or _n_parts_for(n)
        order, self._part_starts = hash_build(bh, bl, n_parts)
        idx = order.long()
        self._bcols = bcols[:, idx].contiguous()
        self._skh = None if bh is None else bh[idx].contiguous()
        self._skl = bl[idx].contiguous()

    def sip_keys(self, var: int) -> torch.Tensor:
        """Build-side key column for a SipFilter export. Runs the build
        phase if needed: the first probe batch would run it anyway, so
        forcing it from a probe-side scan only moves the same work
        earlier. The bloom filter does not depend on the row order."""
        self._ensure_built()
        return self._bcols[self._bv.index(var), : self._n_build]

    # -- probe phase -------------------------------------------------------------

    def _probe_keys(self, cb: ColumnBatch) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        kcols = [cb.column(v) for v in self._hash_vars]
        if self._spans is not None:
            packed = vecops.pack_group_keys(torch.stack(kcols), spans=self._spans)
            return (packed >> 31).to(_I32), (packed & 0x7FFFFFFF).to(_I32)
        return None, kcols[0].contiguous()

    def _run_bounds(self, cb: ColumnBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lo, len) int32 of each probe row's build match run."""
        n = cb.n_rows
        if not self.keys:  # constant-key join: every row matches everything
            return (
                torch.zeros(n, dtype=_I32, device=self.device),
                torch.full((n,), self._n_build, dtype=_I32, device=self.device),
            )
        qh, ql = self._probe_keys(cb)
        lo, hi = hash_probe(self._part_starts, self._skh, self._skl, qh, ql)
        return lo, hi - lo

    def _plan_for(self, cb: ColumnBatch) -> Tuple[EmitPlan, EmitPlan]:
        """The gather_emit plans for this batch's schema: the emit plan and
        the mask-only plan (its pairs alone)."""
        plans = self._plans.get(cb.var_ids)
        if plans is None:
            pairs = [(cb.col_index(v), self._bv.index(v)) for v in self._pair_vars]
            plans = self._plans[cb.var_ids] = (
                EmitPlan([cb.col_index(v) for v in self._pv],
                         [self._bv.index(x) for x in self._build_out], pairs),
                EmitPlan(pairs=pairs),
            )
        return plans

    def next_batch(self) -> Optional[ColumnBatch]:
        self._ensure_built()
        cap = bucket_for(self.sizer.on_next())
        while True:
            if self._pending is not None:
                out = self._emit_pending(cap)
                if self._pending is None and self._track is not None:
                    self._finalize_tracked()
                if out.n_active:
                    return out
                out.release()
                continue
            if self._leftovers:
                return self._emit_leftovers(cap)
            pb = self.probe.next_batch()
            if pb is None:
                return None
            cb = pb.compact()
            if cb.n_rows == 0:
                cb.release()
                continue
            out = self._probe_batch(cb)
            if out is not None:
                if out.n_active:
                    return out
                out.release()

    def _probe_batch(self, cb: ColumnBatch) -> Optional[ColumnBatch]:
        """Consume one compacted probe batch: a masked result (semi/anti),
        or a queued pending expansion (inner/left_outer)."""
        n = cb.n_rows
        lo, lens = self._run_bounds(cb)
        _, mask_plan = self._plan_for(cb)

        if self.mode in ("semi", "anti"):
            if mask_plan.pairs:
                return self._pairwise_exists(cb, lo, lens, mask_plan, want=self.mode == "semi")
            m = torch.zeros(cb.capacity, dtype=torch.bool, device=self.device)
            m[:n] = (lens > 0) if self.mode == "semi" else (lens == 0)
            return cb.with_mask(m)

        if self.mode == "inner" or self._needs_tracking():
            keep = torch.nonzero(lens > 0).flatten().to(_I32)
            if self._needs_tracking():
                self._track = (cb, torch.zeros(n, dtype=_I32, device=self.device))
                if keep.shape[0] == 0:
                    self._finalize_tracked()
                    return None
            elif keep.shape[0] == 0:
                cb.release()
                return None
            klo, klens = lo[keep.long()], lens[keep.long()]
            ones = torch.ones(keep.shape[0], dtype=_I32, device=self.device)
            cum = vecops.group_output_offsets(ones, klens)
            self._pending = (cb, keep, klo, klens, klens, cum, 0, int(cum[-1]))
            return None

        # plain left_outer: an unmatched probe row is a run of length 1
        # against a virtual NULL build row (ri == -1 in gather_emit)
        eff = lens.clamp(min=1)
        pstarts = torch.arange(n, dtype=_I32, device=self.device)
        cum = vecops.group_output_offsets(torch.ones(n, dtype=_I32, device=self.device), eff)
        self._pending = (cb, pstarts, lo, lens, eff, cum, 0, int(cum[-1]))
        return None

    def _pairwise_exists(self, cb: ColumnBatch, lo, lens, mask_plan: EmitPlan,
                         want: bool) -> ColumnBatch:
        """semi/anti with pair-verified keys: a probe row matches iff any
        build row in its run agrees on every pair column. The expansion is
        verified in bounded chunks, so a skewed key's run never
        materializes at once."""
        n = cb.n_rows
        hits = torch.zeros(n, dtype=_I32, device=self.device)
        nz = torch.nonzero(lens > 0).flatten()
        if nz.shape[0]:
            pstarts = nz.to(_I32)
            plens = torch.ones(nz.shape[0], dtype=_I32, device=self.device)
            glo, glens = lo[nz].contiguous(), lens[nz].contiguous()
            cum = vecops.group_output_offsets(plens, glens)
            total = int(cum[-1])
            done = 0
            while done < total:
                count = min(self._EXISTS_CHUNK, total - done)
                li, ri = join_expand(pstarts, plens, glo, glens, cum, done, count)
                _, ok = gather_emit(cb.columns, self._bcols, li, ri, mask_plan)
                hits.index_add_(0, li.long(), ok.to(_I32))
                done += count
        matched = hits > 0
        m = torch.zeros(cb.capacity, dtype=torch.bool, device=self.device)
        m[:n] = matched if want else ~matched
        return cb.with_mask(m)

    # -- emission ----------------------------------------------------------------

    def _emit_pending(self, cap: int) -> ColumnBatch:
        cb, pstarts, lo, lens, eff, cum, emitted, total = self._pending
        count = min(cap, total - emitted)
        ones = torch.ones(pstarts.shape[0], dtype=_I32, device=self.device)
        li, ri = join_expand(pstarts, ones, lo, eff, cum, emitted, count)
        base = emitted
        emitted += count
        done = emitted >= total
        self._pending = None if done else (cb, pstarts, lo, lens, eff, cum, emitted, total)
        if self.mode == "left_outer" and self._track is None:
            # virtual NULL runs: unmatched probe rows gather build index -1
            slots = base + torch.arange(count, dtype=torch.int64, device=self.device)
            group_of = torch.searchsorted(cum, slots, right=True) - 1
            ri = torch.where(lens[group_of] == 0, -1, ri).to(_I32)

        plan, _ = self._plan_for(cb)
        b = ColumnBatch.alloc(
            self._out_vars, bucket_for(max(count, 1)), self.device, self.pool,
            self.sorted_by(),
        )
        _, mask = gather_emit(cb.columns, self._bcols, li, ri, plan, out=b.columns)
        b.n_rows = count
        if count < b.capacity:
            b.columns[:, count:] = NULL_ID
        b.mask[:count] = mask
        if self.pool is not None:
            self.pool.bytes_copied += len(self._out_vars) * count * 4
        if self.post_program is not None:
            b = b.with_mask(eval_program_mask(self.post_program, b, self.dictionary))
        if self._track is not None:
            self._track[1].index_add_(0, li.long(), b.mask[:count].to(_I32))
        if self._skip_floor is not None:
            # applied AFTER match tracking: a skipped row still counts as
            # matched for left_outer bookkeeping, it just isn't re-emitted
            fv, ft = self._skip_floor
            floor = torch.zeros(b.capacity, dtype=torch.bool, device=self.device)
            floor[:count] = cb.columns[cb.col_index(fv), li.long()] >= ft
            b = b.with_mask(floor)
        if done and self._track is None:
            cb.release()
        return b

    def _finalize_tracked(self) -> None:
        cb, matched = self._track
        self._track = None
        um = torch.nonzero(matched == 0).flatten()
        if um.shape[0]:
            idx = [cb.col_index(v) for v in self._pv]
            self._leftovers.append(cb.columns[idx][:, um])
        cb.release()

    def _emit_leftovers(self, cap: int) -> ColumnBatch:
        rows = self._leftovers.pop(0)
        if self._skip_floor is not None:
            fv, ft = self._skip_floor
            rows = rows[:, rows[self._pv.index(fv)] >= ft]
        n = int(rows.shape[1])
        if n > cap:
            self._leftovers.insert(0, rows[:, cap:])
            rows = rows[:, :cap]
            n = cap
        out_cols = [rows[i] for i in range(rows.shape[0])]
        for _ in self._build_out:
            out_cols.append(torch.full((n,), NULL_ID, dtype=_I32, device=self.device))
        return ColumnBatch.from_columns(self._out_vars, out_cols, self.device, pool=self.pool)

    # -- control ----------------------------------------------------------------

    def _drop_pending(self) -> None:
        if self._pending is not None:
            if self._track is None:
                self._pending[0].release()
            self._pending = None
        if self._track is not None:
            self._track[0].release()
            self._track = None
        self._leftovers.clear()

    def skip(self, var: int, target: int) -> None:
        # pending expansions and leftovers may still hold rows >= target:
        # narrow them with a floor mask at emission instead of dropping
        if self._skip_floor is not None and self._skip_floor[0] == var:
            target = max(target, self._skip_floor[1])
        self._skip_floor = (var, target)
        self.probe.skip(var, target)

    def _close(self) -> None:
        # early teardown mid-expansion: pending probe batches still own
        # pooled buffers
        self._drop_pending()

    def reset(self) -> None:
        self._drop_pending()
        self._skip_floor = None
        self.probe.reset()
        self.build.reset()
        self._built = False
        self._bcols = None
        self._part_starts = None
        self._skh = self._skl = None
        self._spans = None
        self._hash_vars = self.keys
        self._pair_vars = self._extra_shared
        self._plans = {}
