"""frontier_dedup: keep a sorted candidate pair iff it is new.

Candidates ``(cand_hi, cand_lo)`` and the visited set ``(vis_hi, vis_lo)``
are int32 pairs, each sorted lexicographically. ``mask[j]`` is True iff
candidate j differs from candidate j - 1 (candidate 0 always does) and is
absent from the visited set: the semi-naive delta of one BFS round of the
property-path engine. With an empty visited set it is plain sort-unique,
the relation dedup of paths and the first-occurrence mask of DISTINCT
aggregates. The contract is the reference's ``vecops.frontier_dedup``.

The Pallas kernel gives the first candidate an INT32_MIN neighbour (its
padding), so it drops a first candidate equal to (INT32_MIN, INT32_MIN);
this function keeps it, as the numpy oracle does. The numpy oracle's
composite key assumes non-negative pairs; the CUDA kernel and the plain
version order pairs as signed int32 values, which is the same order on
the engine's domain (dictionary codes >= -1, shifted by one in DISTINCT).

CUDA kernel: ``csrc/frontier_dedup.cu``. ``frontier_dedup_plain`` is the
same function in PyTorch (the adjacent compare, then ``torch.searchsorted``
on the int64 pair key for membership); the wrapper takes it for CPU
tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.core import vecops
from repro_torch.kernels import build

launches = 0


def frontier_dedup_plain(cand_hi, cand_lo, vis_hi, vis_lo) -> torch.Tensor:
    c = int(cand_hi.shape[0])
    mask = torch.ones(c, dtype=torch.bool, device=cand_hi.device)
    if c == 0:
        return mask
    mask[1:] = (cand_hi[1:] != cand_hi[:-1]) | (cand_lo[1:] != cand_lo[:-1])
    v = int(vis_hi.shape[0])
    if v:
        key_c = vecops._pair_comp(cand_hi, cand_lo)
        key_v = vecops._pair_comp(vis_hi, vis_lo)
        pos = torch.searchsorted(key_v, key_c).clamp_(max=v - 1)
        mask &= key_v[pos] != key_c
    return mask


def frontier_dedup(cand_hi: torch.Tensor, cand_lo: torch.Tensor,
                   vis_hi: torch.Tensor, vis_lo: torch.Tensor) -> torch.Tensor:
    """(C,) bool mask over the sorted candidates (see module docstring)."""
    global launches
    dev = cand_hi.device
    for name, x in (("cand_hi", cand_hi), ("cand_lo", cand_lo),
                    ("vis_hi", vis_hi), ("vis_lo", vis_lo)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"frontier_dedup: {name} must be a contiguous 1-D int32 tensor")
        if x.device != dev:
            raise ValueError(f"frontier_dedup: {name} is on {x.device}, not {dev}")
    if cand_lo.shape != cand_hi.shape or vis_lo.shape != vis_hi.shape:
        raise ValueError("frontier_dedup: a pair's two columns differ in length")
    if dev.type == "cpu":
        return frontier_dedup_plain(cand_hi, cand_lo, vis_hi, vis_lo)
    if dev.type != "cuda":
        raise ValueError(f"frontier_dedup: unsupported device {dev}")
    c = int(cand_hi.shape[0])
    v = int(vis_hi.shape[0])
    mask = torch.empty(c, dtype=torch.bool, device=dev)
    if c == 0:
        return mask
    lib = build.library()
    build.check(lib.frontier_dedup_launch(
        cand_hi.data_ptr(), cand_lo.data_ptr(), c, vis_hi.data_ptr(), vis_lo.data_ptr(),
        v, mask.data_ptr(), build.stream_handle(mask),
    ), "frontier_dedup")
    launches += 1
    return mask
