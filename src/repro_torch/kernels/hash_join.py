"""hash_build / hash_probe: the radix-partitioned hash join's layout and probe.

A join key is an int32 ``(hi, lo)`` pair compared lexicographically as
signed values (``hi`` None means 0: single-variable keys); see the hash
join's section of ``core/vecops.py``.

``hash_build(key_hi, key_lo, n_parts)`` lays the build side out for the
probe: ``radix_partition`` over ``mix_pair(hi, lo)``, then the permutation
``order`` that groups rows by partition id and sorts them by key inside
each partition (a stable library sort of the (pid, key) int64 composite,
as the reference computes it outside any Pallas kernel), and
``part_starts``, the (n_parts + 1,) int32 prefix sum of the histogram.

``hash_probe(part_starts, skey_hi, skey_lo, qkey_hi, qkey_lo)`` returns,
for each probe key, the int32 ``(lo, hi)`` positions in the laid-out build
keys such that rows ``[lo, hi)`` carry exactly that key: ``lo`` is the
number of build rows ordering below ``(pid, hi, lo)`` and ``hi`` the number
at or below it, the probe's partition id ``pid`` computed from its key as
the build's were. For an absent key ``lo == hi`` is its insertion position
(the reference's numpy oracle returns ``lo = 0`` there instead).

CUDA kernel: ``csrc/hash_probe.cu``, which also computes the probe's
partition ids; it answers each probe key with a group of lanes (the
kernel's compile-time ``GROUP``, chosen by ``kernel_sweep.py``'s sweep).
``hash_probe_plain`` is the same function in PyTorch, following the
reference's numpy oracle (a composite ``searchsorted``, and a segmented
binary search for pair keys too wide for the composite); the wrapper takes
it for CPU tensors only.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.kernels import build
from repro_torch.kernels.radix_partition import radix_partition

_I32 = torch.int32
_I64 = torch.int64
launches = 0


def hash_build(key_hi: Optional[torch.Tensor], key_lo: torch.Tensor,
               n_parts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, part_starts) int32 — see module docstring."""
    _check_keys("hash_build", key_hi, key_lo)
    mixed = vecops.mix_pair(key_hi, key_lo).contiguous()
    pid, hist = radix_partition(mixed, n_parts)
    part_starts = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0).to(_I32)])
    return vecops.hash_build_order(pid, key_hi, key_lo, n_parts), part_starts


def hash_probe_plain(part_starts, skey_hi, skey_lo, qkey_hi, qkey_lo):
    dev = qkey_lo.device
    n_parts = int(part_starts.shape[0]) - 1
    n = int(skey_lo.shape[0])
    if n == 0 or int(qkey_lo.shape[0]) == 0:
        z = torch.zeros(int(qkey_lo.shape[0]), dtype=_I32, device=dev)
        return z, z.clone()
    shift = vecops._pid_shift(n_parts)
    qpid = vecops.hash_partition(vecops.mix_pair(qkey_hi, qkey_lo), n_parts)
    packed_b = vecops._pair_comp(skey_hi, skey_lo)
    packed_q = vecops._pair_comp(qkey_hi, qkey_lo)
    if skey_hi is None or (int(packed_b.max()) < (1 << shift)
                           and int(packed_q.max()) < (1 << shift)):
        spid = torch.repeat_interleave(
            torch.arange(n_parts, dtype=_I64, device=dev),
            (part_starts[1:] - part_starts[:-1]).to(_I64), output_size=n,
        )
        comp_b = (spid << shift) | packed_b
        comp_q = (qpid.to(_I64) << shift) | packed_q
        lo = torch.searchsorted(comp_b, comp_q)
        hi = torch.searchsorted(comp_b, comp_q, right=True)
        return lo.to(_I32), hi.to(_I32)
    # oversized pair keys: binary search inside each probe's partition
    # slice, both boundaries advanced one halving step per iteration
    qp = qpid.to(_I64)
    llo, lhi = part_starts[qp].to(_I64), part_starts[qp + 1].to(_I64)
    rlo, rhi = llo.clone(), lhi.clone()
    while True:
        l_act, r_act = llo < lhi, rlo < rhi
        if not bool((l_act | r_act).any()):
            break
        lmid, rmid = (llo + lhi) >> 1, (rlo + rhi) >> 1
        lgo = (packed_b[lmid.clamp(max=n - 1)] < packed_q) & l_act
        rgo = (packed_b[rmid.clamp(max=n - 1)] <= packed_q) & r_act
        llo = torch.where(lgo, lmid + 1, llo)
        lhi = torch.where(l_act & ~lgo, lmid, lhi)
        rlo = torch.where(rgo, rmid + 1, rlo)
        rhi = torch.where(r_act & ~rgo, rmid, rhi)
    return llo.to(_I32), rlo.to(_I32)


def hash_probe(part_starts: torch.Tensor, skey_hi: Optional[torch.Tensor],
               skey_lo: torch.Tensor, qkey_hi: Optional[torch.Tensor],
               qkey_lo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 match-run boundaries per probe key (see module
    docstring). An empty build or probe gives zeros."""
    global launches
    t0 = time.perf_counter()
    _check_keys("hash_probe", skey_hi, skey_lo)
    _check_keys("hash_probe", qkey_hi, qkey_lo)
    if (skey_hi is None) != (qkey_hi is None):
        raise ValueError("hash_probe: build and probe keys differ in form")
    n_parts = int(part_starts.shape[0]) - 1
    if (part_starts.dtype != _I32 or part_starts.dim() != 1 or n_parts < 1
            or n_parts & (n_parts - 1) or not part_starts.is_contiguous()):
        raise ValueError("hash_probe: part_starts must be contiguous int32 (P+1,), P a power of two")
    dev = qkey_lo.device
    for name, x in (("part_starts", part_starts), ("skey_lo", skey_lo)):
        if x.device != dev:
            raise ValueError(f"hash_probe: {name} is on {x.device}, not {dev}")
    c, n = int(qkey_lo.shape[0]), int(skey_lo.shape[0])
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"hash_probe: unsupported device {dev}")
    if n == 0 or c == 0:
        z = torch.zeros(c, dtype=_I32, device=dev)
        return z, z.clone()
    if dev.type == "cpu":
        out = hash_probe_plain(part_starts, skey_hi, skey_lo, qkey_hi, qkey_lo)
        build.ledger("hash_probe", "plain", t0)
        return out
    lo = torch.empty(c, dtype=_I32, device=dev)
    hi = torch.empty(c, dtype=_I32, device=dev)
    lib = build.library()
    build.check(lib.hash_probe_launch(
        part_starts.data_ptr(), n_parts,
        None if skey_hi is None else skey_hi.data_ptr(), skey_lo.data_ptr(),
        None if qkey_hi is None else qkey_hi.data_ptr(), qkey_lo.data_ptr(), c,
        lo.data_ptr(), hi.data_ptr(), build.stream_handle(lo),
    ), "hash_probe")
    launches += 1
    build.ledger("hash_probe", "cuda", t0)
    return lo, hi


def _check_keys(who: str, key_hi, key_lo) -> None:
    if key_lo.dtype != _I32 or key_lo.dim() != 1 or not key_lo.is_contiguous():
        raise ValueError(f"{who}: key lo must be a contiguous 1-D int32 tensor")
    if key_hi is not None and (
        key_hi.dtype != _I32 or key_hi.shape != key_lo.shape
        or not key_hi.is_contiguous() or key_hi.device != key_lo.device
    ):
        raise ValueError(f"{who}: key hi must be a contiguous int32 tensor like key lo")
