"""join_expand: merge-join Build-phase expansion (paper §3.2).

For output slots ``[base, base+count)`` of a grouped cross product, the
``(li, ri)`` int32 gather indices: slot t lies in group g (the last with
``cum[g] <= t``), ``w = t - cum[g]``, ``li = lstarts[g] + w // rlens[g]``,
``ri = rstarts[g] + w % rlens[g]``; slots at or past ``cum[G]`` get -1.
``cum`` is int64 with ``cum[0] = 0``, so totals beyond 2^31 are fine.

CUDA kernel: ``csrc/join_expand.cu``. ``join_expand_plain`` is the same
function in PyTorch, laid out like the kernel: tiles of ``tile`` slots,
each with its first group found by a search, the starts of the non-empty
groups inside it scattered to their positions, and a max-scan that gives
every slot the start of its group, and so the group. The wrapper takes it
for CPU tensors only.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# csrc/join_expand.cu's two tile sizes (slots per block), chosen from the
# window's size (PERF.md's sweep, kernel_sweep.py)
TILE_SMALL = 64
TILE_LARGE = 2048
LARGE_FROM = 131072  # windows of at least this many slots take TILE_LARGE
launches = 0
_I32 = torch.int32
_I64 = torch.int64


def tile_for(count: int) -> int:
    """The kernel's tile for a window of ``count`` slots."""
    return TILE_LARGE if count >= LARGE_FROM else TILE_SMALL


def join_expand_plain(lstarts, llens, rstarts, rlens, cum, base: int, count: int,
                      tile: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's steps in PyTorch (see module docstring), at the
    kernel's tile unless ``tile`` is given."""
    tile = tile_for(count) if tile is None else tile
    dev = lstarts.device
    g_total = int(lstarts.shape[0])
    if g_total == 0 or count == 0:
        neg = torch.full((count,), -1, dtype=_I32, device=dev)
        return neg, neg.clone()
    total = cum[g_total]
    n_tiles = -(-count // tile)
    j0 = torch.arange(n_tiles, dtype=_I64, device=dev) * tile
    t0 = base + j0
    length = (count - j0).clamp(max=tile)
    # each tile's valid positions [v_lo, v_hi)
    v_lo = torch.minimum((-t0).clamp(min=0), length)
    v_hi = torch.minimum((total - t0).clamp(min=0), length)
    live = v_lo < v_hi
    x_lo = t0 + v_lo
    # the block's two searches: its first group and the end of its range
    g_lo = (torch.searchsorted(cum, x_lo, right=True) - 1).clamp_(0, g_total - 1)
    g_hi = torch.searchsorted(cum, t0 + length).clamp_(max=g_total)
    # start position of the group at each position (-1: none), and that
    # group's id, through which the plain version reads its parameters
    start = torch.full((n_tiles, tile), -1, dtype=_I64, device=dev)
    owner = torch.full((n_tiles * tile,), -1, dtype=_I64, device=dev)
    rows = torch.nonzero(live).flatten()
    start[rows, v_lo[rows]] = v_lo[rows]
    owner[rows * tile + v_lo[rows]] = g_lo[rows]
    if rows.shape[0]:
        # every non-empty group that starts strictly inside a live tile's
        # valid range writes its start there
        first, last = int(g_lo[rows[0]]), int(g_hi[rows[-1]])
        g = torch.arange(first + 1, last, dtype=_I64, device=dev)
        c0 = cum[first + 1: last]
        rel = c0 - base
        k = torch.div(rel, tile, rounding_mode="floor")
        pos = rel - k * tile
        kc = k.clamp(0, n_tiles - 1)
        inside = ((cum[first + 2: last + 1] > c0) & (k >= 0) & (k < n_tiles)
                  & live[kc] & (c0 > x_lo[kc]) & (pos < v_hi[kc]))
        start[kc[inside], pos[inside]] = pos[inside]
        # one writer per position; were there two, the smaller id would
        # win here, so a collision cannot hide behind the scan
        owner.scatter_reduce_(0, (kc * tile + pos)[inside], g[inside], "amin",
                              include_self=False)
    p = torch.cummax(start, dim=1).values
    jt = torch.arange(n_tiles, dtype=_I64, device=dev)[:, None]
    g = owner[(jt * tile + p.clamp(min=0)).reshape(-1)][:count].clamp(min=0)
    p = p.reshape(-1)[:count]
    j = torch.arange(count, dtype=_I64, device=dev)
    tj = torch.div(j, tile, rounding_mode="floor")
    pj = j - tj * tile
    valid = (pj >= v_lo[tj]) & (pj < v_hi[tj])
    # w from the group's start in the tile; the tile's first group may
    # have started before the tile
    w = pj - p + torch.where(p == v_lo[tj], x_lo[tj] - cum[g], 0)
    rl = rlens[g].to(_I64).clamp(min=1)
    li = torch.where(valid, lstarts[g].to(_I64) + w // rl, -1).to(_I32)
    ri = torch.where(valid, rstarts[g].to(_I64) + w % rl, -1).to(_I32)
    return li, ri


def join_expand(lstarts, llens, rstarts, rlens, cum, base: int, count: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(li, ri) int32 tensors of length ``count`` (see module docstring)."""
    global launches
    t0 = time.perf_counter()
    shape, dev = lstarts.shape, lstarts.device
    g = shape[0] if len(shape) == 1 else -1
    for name, x in (("lstarts", lstarts), ("llens", llens),
                    ("rstarts", rstarts), ("rlens", rlens)):
        if g < 0 or x.dtype is not _I32 or x.shape != shape or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"join_expand: {name} must be a contiguous int32 (G,) tensor "
                             f"like lstarts, on {dev}")
    if cum.dtype is not _I64 or cum.ndim != 1 or cum.shape[0] != g + 1 \
            or not cum.is_contiguous() or cum.device != dev:
        raise ValueError(f"join_expand: cum must be a contiguous int64 ({g + 1},) tensor on {dev}")
    if count < 0:
        raise ValueError("join_expand: negative count")
    if lstarts.is_cpu:
        out = join_expand_plain(lstarts, llens, rstarts, rlens, cum, base, count)
        build.ledger("join_expand", "plain", t0)
        return out
    if not lstarts.is_cuda:
        raise ValueError(f"join_expand: unsupported device {dev}")
    li = torch.empty(count, dtype=_I32, device=dev)
    ri = torch.empty(count, dtype=_I32, device=dev)
    build.check(build.library().join_expand_launch(
        lstarts.data_ptr(), llens.data_ptr(), rstarts.data_ptr(), rlens.data_ptr(),
        cum.data_ptr(), g, int(base), count, li.data_ptr(), ri.data_ptr(), tile_for(count),
        build.stream_handle(li),
    ), "join_expand")
    launches += 1
    build.ledger("join_expand", "cuda", t0)
    return li, ri
