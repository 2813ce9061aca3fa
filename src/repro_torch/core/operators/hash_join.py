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

Out of core (grace): under a memory budget the build side fans out into
a ``PartitionedRelation`` (``core/partition.py``) whose largest partitions
spill to ``spill_dir``, the probe side fans out the same way, and the
partitions are joined one at a time, each through the resident build
above (``radix_partition``, ``hash_probe``, ``join_expand``,
``gather_emit``). The planner directs it (``grace``), or a build the plan
sized as resident that materialises over the budget switches at run time
when the probe side is unsorted. A partition whose build still exceeds
the budget re-partitions with the next level's hash, up to three levels;
one whose keys are all equal builds resident. Grace emission follows the
partitions, so it claims no order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.core.adaptive import AdaptiveBatchSizer
from repro_torch.core.batch import NULL_ID, BatchPool, ColumnBatch, bucket_for
from repro_torch.core.operators.base import BatchOperator, HostTimer
from repro_torch.core.operators.simple import expr_mask, resolve_program
from repro_torch.core.operators.sort import materialize
from repro_torch.core.partition import (
    PartitionedRelation,
    fan_in,
    next_pow2,
    partition_ids_multi,
    split_block,
)
from repro_torch.kernels.gather_emit import EmitPlan, gather_emit
from repro_torch.kernels.hash_join import hash_build, hash_probe
from repro_torch.kernels.join_expand import join_expand

_I32 = torch.int32

# target rows per partition: keeps the in-partition binary search shallow
_PART_TARGET = 4096
_MAX_PARTS = 1024


# grace mode: the top-level fan-out when the planner gave none, the
# sub-fan-out of a recursive re-partition, the recursion depth cap (a bucket
# still over budget at level 3 is one hot key and builds resident), and the
# rows of a probe partition handed to the join at a time
_GRACE_DEFAULT_PARTS = 32
_GRACE_SUB_PARTS = 8
_GRACE_MAX_LEVEL = 3
_GRACE_PROBE_CHUNK = 4096


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
        memory_budget: Optional[int] = None,  # bytes; None = resident only
        spill_dir: Optional[str] = None,
        grace: Optional[bool] = None,  # True = planner-directed grace build
        grace_parts: int = 0,  # planner-chosen top-level fan-out (0 = default)
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
        self.memory_budget = memory_budget
        self.spill_dir = spill_dir
        self.grace = grace
        self.grace_parts = grace_parts

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

        # grace state: both sides fanned out by partition_ids_multi, then
        # joined one partition at a time with the resident build above
        self._grace_active = False
        self._build_rel: Optional[PartitionedRelation] = None
        self._probe_rel: Optional[PartitionedRelation] = None
        self._probe_partitioned = False
        # (build block, probe block, level) from re-partitioned skewed
        # buckets, consumed before the next partition is taken
        self._grace_stack: List[Tuple[torch.Tensor, torch.Tensor, int]] = []
        self._next_gp = 0
        self._gp_cols: Optional[torch.Tensor] = None  # current probe block
        self._gp_off = 0

        # probe-side continuation state
        self._pending: Optional[Tuple] = None
        # (cb, matched) for left_outer batches that track matches per row
        self._track: Optional[Tuple[ColumnBatch, torch.Tensor]] = None
        self._leftovers: List[torch.Tensor] = []  # (n_pv, n) unmatched rows
        # skip() floor: a parent may gallop past `target` while pending
        # expansions still hold rows >= target — those must survive, so the
        # floor masks emitted rows below it instead of dropping the batch
        self._skip_floor: Optional[Tuple[int, int]] = None
        super().__init__("HashJoin", f"({','.join(f'?v{k}' for k in keys)}) mode={mode}")
        self._probe_timer = HostTimer()  # hash_probe_ms: host time, all probes

    # -- metadata ---------------------------------------------------------------

    def var_ids(self) -> Tuple[int, ...]:
        return self._out_vars

    def sorted_by(self) -> Optional[int]:
        # probe order is preserved: expansions walk probe rows in order and
        # plain left_outer NULL rows are emitted in place. Tracked
        # left_outer queues its NULL rows after the batch's expansions.
        # Grace emission follows the partitions.
        if self._grace_active or self.grace or self._needs_tracking():
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
        """The build phase. ``hash_build_ms`` is host time (on the card the
        time to enqueue the build, and the syncs inside it)."""
        if self._built:
            return
        timer = HostTimer()
        with timer:
            self._build_phase()
        self._built = True
        self.stats.extra["hash_build_ms"] = timer.ms

    def _build_phase(self) -> None:
        if self.grace and self.keys:
            # planner-directed grace build: the build child streams straight
            # into the partitioned relation and is never resident whole
            self._grace_build_stream()
            return
        bvars, bcols = materialize(self.build, self.device)
        self._bv = bvars
        self._plans = {}
        n = int(bcols.shape[1])
        self.stats.extra["hash_build_rows"] = n
        if not self.keys:
            self._n_build = n
            self._bcols = bcols
        elif (
            self.memory_budget is not None
            and n * len(bvars) * 4 > self.memory_budget
            and self.probe.sorted_by() is None
        ):
            # the plan sized this build as resident but it is over the
            # budget: go grace, where no ancestor relies on probe order
            self._grace_switch_from_block(bcols)
        else:
            self._build_resident(bcols)
            self.stats.extra["hash_partitions"] = self._n_parts

    def _build_resident(self, bcols: torch.Tensor) -> None:
        """Radix-build one device block (the whole build side, or one grace
        partition). The span / pair layout and the emit plans are reset per
        block: a multi-key span overflow in one grace partition must not
        leak its primary-only fallback into the next."""
        n = self._n_build = int(bcols.shape[1])
        kcols = bcols[[self._bv.index(k) for k in self.keys]]
        self._spans = None
        self._hash_vars = self.keys
        self._pair_vars = self._extra_shared
        self._plans = {}
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
        n_parts = self._n_parts = self._n_parts_cfg or _n_parts_for(n)
        order, self._part_starts = hash_build(bh, bl, n_parts)
        idx = order.long()
        self._bcols = bcols[:, idx].contiguous()
        self._skh = None if bh is None else bh[idx].contiguous()
        self._skl = bl[idx].contiguous()

    # -- grace phase -------------------------------------------------------------

    def _init_rels(self, n_parts: int) -> None:
        half = None if self.memory_budget is None else max(self.memory_budget // 2, 1)
        self._build_rel = PartitionedRelation(
            len(self._bv), n_parts, self.device, self.spill_dir, half, self.pool)
        self._probe_rel = PartitionedRelation(
            len(self._pv), n_parts, self.device, self.spill_dir, half, self.pool)
        self._next_gp = 0
        self._grace_stack = []
        self._gp_cols = None
        self._gp_off = 0
        self._probe_partitioned = False
        self.stats.extra["grace_partitions"] = n_parts
        self.stats.extra.setdefault("repartitions", 0)

    def _grace_build_stream(self) -> None:
        self._init_rels(max(2, next_pow2(self.grace_parts or _GRACE_DEFAULT_PARTS)))
        self.stats.extra["hash_build_rows"] = fan_in(self.build, self._build_rel, self._bv, self.keys)
        self._grace_active = True
        self._refresh_grace_stats()

    def _grace_switch_from_block(self, bcols: torch.Tensor) -> None:
        # fan-out sized so that an average partition fits in half the
        # budget (the other half is headroom for the probe partitions)
        nbytes = int(bcols.numel()) * 4
        self._init_rels(min(256, max(2, next_pow2(-(-nbytes // max(self.memory_budget // 2, 1))))))
        pids = partition_ids_multi([bcols[self._bv.index(k)] for k in self.keys],
                                   self._build_rel.n_parts)
        self._build_rel.append(bcols, pids)
        self._grace_active = True
        self.stats.extra["adaptive_switches"] = 1
        self.stats.detail += " grace"
        self._refresh_grace_stats()

    def _refresh_grace_stats(self) -> None:
        rels = [r for r in (self._build_rel, self._probe_rel) if r is not None]
        self.stats.extra["spill_bytes"] = sum(r.spill_bytes for r in rels)
        self.stats.extra["spill_files"] = sum(r.spill_files for r in rels)

    def _grace_next_probe(self) -> Optional[ColumnBatch]:
        """The probe source while grace is active: chunks of the current
        partition's probe block, moving on between partitions. None when
        exhausted, or when leftovers were queued (the caller flushes them
        before asking again)."""
        if not self._probe_partitioned:
            fan_in(self.probe, self._probe_rel, self._pv, self.keys)
            self._probe_partitioned = True
            self._refresh_grace_stats()
        while True:
            if self._gp_cols is not None:
                n = int(self._gp_cols.shape[1])
                if self._gp_off < n:
                    j = min(self._gp_off + _GRACE_PROBE_CHUNK, n)
                    chunk = self._gp_cols[:, self._gp_off: j]
                    self._gp_off = j
                    return ColumnBatch.from_columns(
                        self._pv, list(chunk), self.device, pool=self.pool)
                self._gp_cols = None
            if self._leftovers:
                return None
            if not self._grace_advance():
                return None

    def _grace_advance(self) -> bool:
        """Move to the next joinable (build, probe) partition pair. A
        skewed bucket over the budget re-partitions with the next level's
        hash instead of building an over-budget table."""
        while True:
            if self._grace_stack:
                bblock, pblock, level = self._grace_stack.pop()
            elif self._next_gp < self._build_rel.n_parts:
                g = self._next_gp
                self._next_gp += 1
                bblock = self._build_rel.take(g)
                pblock = self._probe_rel.take(g)
                level = 0
                self._refresh_grace_stats()
            else:
                return False
            if pblock.shape[1] == 0:
                continue
            if bblock.shape[1] == 0:
                # probe-only partition: inner and semi emit nothing; anti
                # and left_outer NULL-extend every probe row through the
                # leftovers (anti has no build columns, so emits them as is)
                if self.mode in ("anti", "left_outer"):
                    self._leftovers.append(pblock)
                    return True
                continue
            if (
                self.memory_budget is not None
                and int(bblock.numel()) * 4 > self.memory_budget
                and level < _GRACE_MAX_LEVEL
                and bblock.shape[1] > 1
                and not self._all_keys_equal(bblock)
            ):
                self._grace_repartition(bblock, pblock, level)
                continue
            self._build_resident(bblock)
            self._gp_cols = pblock
            self._gp_off = 0
            return True

    def _all_keys_equal(self, bblock: torch.Tensor) -> bool:
        kcols = bblock[[self._bv.index(k) for k in self.keys]]
        return bool((kcols == kcols[:, :1]).all())

    def _grace_repartition(self, bblock: torch.Tensor, pblock: torch.Tensor,
                           level: int) -> None:
        g2 = _GRACE_SUB_PARTS
        b_pids = partition_ids_multi([bblock[self._bv.index(k)] for k in self.keys], g2, level + 1)
        p_pids = partition_ids_multi([pblock[self._pv.index(k)] for k in self.keys], g2, level + 1)
        bsubs = dict(split_block(bblock, b_pids, g2))
        empty_b = bblock[:, :0]
        for p, psub in split_block(pblock, p_pids, g2):
            self._grace_stack.append((bsubs.get(p, empty_b), psub, level + 1))
        self.stats.extra["repartitions"] = self.stats.extra.get("repartitions", 0) + 1

    def sip_keys(self, var: int) -> torch.Tensor:
        """Build-side key column for a SipFilter export. Runs the build
        phase if needed: the first probe batch would run it anyway, so
        forcing it from a probe-side scan only moves the same work
        earlier. The bloom filter does not depend on the row order."""
        self._ensure_built()
        self.stats.extra["sip_exports"] = self.stats.extra.get("sip_exports", 0) + 1
        if self._grace_active:
            # every partition's key column, loaded without freeing: the
            # grace drain still needs them
            j = self._bv.index(var)
            return torch.cat([self._build_rel.load(p)[j]
                              for p in range(self._build_rel.n_parts)])
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
        with self._probe_timer:
            lo, hi = hash_probe(self._part_starts, self._skh, self._skl, qh, ql)
        ex = self.stats.extra
        ex["hash_probe_ms"] = self._probe_timer.ms
        ex["hash_probe_rows"] = ex.get("hash_probe_rows", 0) + n
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

    def _next(self) -> Optional[ColumnBatch]:
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
            if self._grace_active:
                pb = self._grace_next_probe()
                if pb is None:
                    if self._leftovers:
                        continue  # the loop's top flushes them
                    return None
            else:
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
        b.dense = not plan.pairs  # no pair to test: every row is active
        if self.pool is not None:
            self.pool.bytes_copied += len(self._out_vars) * count * 4
        if self.post_filter is not None:
            # OPTIONAL {...} FILTER condition (VM, or the tree walk)
            b = b.with_mask(expr_mask(self.post_filter, self.post_program, b, self.dictionary))
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

    def _skip(self, var: int, target: int) -> None:
        # pending expansions and leftovers may still hold rows >= target:
        # narrow them with a floor mask at emission instead of dropping
        if self._skip_floor is not None and self._skip_floor[0] == var:
            target = max(target, self._skip_floor[1])
        self._skip_floor = (var, target)
        self.probe.skip(var, target)

    def _close(self) -> None:
        # early teardown mid-expansion: pending probe batches still own
        # pooled buffers, and grace partitions may hold spill files
        self._drop_pending()
        for rel in (self._build_rel, self._probe_rel):
            if rel is not None:
                rel.close()

    def _reset(self) -> None:
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
        self._close()
        self._grace_active = False
        self._build_rel = self._probe_rel = None
        self._probe_partitioned = False
        self._grace_stack = []
        self._next_gp = 0
        self._gp_cols = None
        self._gp_off = 0
