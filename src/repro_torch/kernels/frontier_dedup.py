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

CUDA kernel: ``csrc/frontier_dedup.cu``: a block covers a tile of
``threads * items`` candidates and stages its window of the visited set in
shared memory, ``CHUNK`` pairs at a time, or searches it where it is long
(``launch_shape``). The tiles are
laid on the candidate columns' 16-byte phase, and the wrapper lays the
mask on the same phase (``mask_offset``), so that a thread's mask bytes go
out in one store. ``frontier_dedup_plain`` is the same function in PyTorch
(the adjacent compare, then ``torch.searchsorted`` on the int64 pair key
for membership); the wrapper takes it for CPU tensors only.

Besides ``launches``, the wrapper counts the sizes it launches on, as plain
integers: ``candidates`` (summed), ``max_candidates`` and ``max_visited``
(``sizes()``, ``reset_sizes()``).
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Tuple

import torch

from repro_torch.core import vecops
from repro_torch.kernels import build

# csrc/frontier_dedup.cu's two compiled tiles, (threads, candidates a
# thread), checked against the library when it loads (_check_limits).
# launch_shape takes the large tile from LARGE_FROM candidates, staging
# CHUNK visited pairs in shared memory at once, while the visited set holds
# at most STAGED_UP_TO pairs a candidate; otherwise the small tile, where
# more blocks fill the card and the kernel searches every window without
# staging (PERF.md's sweep, kernel_sweep.py)
SMALL_TILE = (64, 4)
LARGE_TILE = (256, 8)
LARGE_FROM = 524288
STAGED_UP_TO = 2
CHUNK = 4096
PAIR_BYTES = 8  # a staged visited pair: two int32
SMEM_MAX = build.SMEM_MAX
launches = 0
candidates = 0
max_candidates = 0
max_visited = 0


def sizes() -> dict:
    return {"candidates": candidates, "max_candidates": max_candidates,
            "max_visited": max_visited}


def reset_sizes() -> None:
    global candidates, max_candidates, max_visited
    candidates = max_candidates = max_visited = 0


def launch_shape(c: int, v: int) -> Tuple[int, int, int]:
    """The kernel's (threads, candidates a thread, dynamic shared memory)
    for ``c`` candidates and ``v`` visited pairs: the large tile for a
    large launch with an empty visited set (no shared memory) or a staged
    one (a chunk of CHUNK pairs), else the small tile, whose windows are
    searched (no shared memory)."""
    if c >= LARGE_FROM and v == 0:
        return (*LARGE_TILE, 0)
    if c >= LARGE_FROM and v <= STAGED_UP_TO * c:
        return (*LARGE_TILE, smem_bytes(CHUNK))
    return (*SMALL_TILE, 0)


def smem_bytes(chunk: int) -> int:
    """Shared memory for a chunk of ``chunk`` staged visited pairs."""
    if not 1 <= chunk <= SMEM_MAX // PAIR_BYTES:
        raise ValueError(f"frontier_dedup: a chunk of {chunk} pairs does not fit a block")
    return PAIR_BYTES * chunk


def mask_offset(hi_ptr: int, lo_ptr: int, buf_ptr: int) -> int:
    """Where in a buffer at ``buf_ptr`` the mask starts, so that it lies on
    the kernel's tile phase: the candidate columns' 16-byte phase (in
    int32 elements) when the two columns share one, else 0."""
    phase = (hi_ptr >> 2) & 3
    shift = phase if phase == (lo_ptr >> 2) & 3 else 0
    return (shift - buf_ptr) % 16


@functools.lru_cache(maxsize=1)
def _check_limits(lib) -> None:
    got = [ctypes.c_int() for _ in range(6)]
    lib.frontier_dedup_limits(*[ctypes.byref(x) for x in got])
    want = (*SMALL_TILE, *LARGE_TILE, PAIR_BYTES, SMEM_MAX)
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"frontier_dedup: kernel shapes {[x.value for x in got]} != {want}")


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
    global launches, candidates, max_candidates, max_visited
    t0 = time.perf_counter()
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
        out = frontier_dedup_plain(cand_hi, cand_lo, vis_hi, vis_lo)
        build.ledger("frontier_dedup", "plain", t0)
        return out
    if dev.type != "cuda":
        raise ValueError(f"frontier_dedup: unsupported device {dev}")
    c = int(cand_hi.shape[0])
    v = int(vis_hi.shape[0])
    if c == 0:
        return torch.empty(0, dtype=torch.bool, device=dev)
    buf = torch.empty(c + 15, dtype=torch.bool, device=dev)
    off = mask_offset(cand_hi.data_ptr(), cand_lo.data_ptr(), buf.data_ptr())
    mask = buf[off: off + c]
    lib = build.library()
    _check_limits(lib)
    build.check(lib.frontier_dedup_launch(
        cand_hi.data_ptr(), cand_lo.data_ptr(), c, vis_hi.data_ptr(), vis_lo.data_ptr(),
        v, mask.data_ptr(), *launch_shape(c, v), build.stream_handle(mask),
    ), "frontier_dedup")
    launches += 1
    build.ledger("frontier_dedup", "cuda", t0)
    candidates += c
    max_candidates = max(max_candidates, c)
    max_visited = max(max_visited, v)
    return mask
