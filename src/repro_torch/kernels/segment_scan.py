"""segment_scan: segmented inclusive scan over sorted keys.

``out[i]`` combines (sum / count / min / max) the float64 values of the
maximal run of equal int32 keys ending at ``i``; count is a sum of ones.
The value plane is float64, as in the reference's default numpy backend.
Keys must be sorted (equal keys contiguous), as on the grouping path.
``segment_scan(keys, None, "count")`` makes the ones itself; with values,
count sums them.

CUDA kernel: ``csrc/segment_scan.cu``. ``segment_scan_plain`` is the same
function in PyTorch, laid out like the kernel: tiles of ``threads * items``
elements, ``items`` consecutive elements per thread scanned in order, a
doubling scan over the 32 threads of a warp and over the warps of a tile,
and a carry across tiles found by the kernel's look-back (32 predecessor
tiles at a time, back to the nearest one that holds a key change). The
wrapper takes it for CPU tensors only. The kernel sums in this one fixed
order, so its float sums equal the plain version's bit for bit.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.kernels import build

THREADS = 512  # csrc/segment_scan.cu: a block's threads
ITEMS = 8  # elements per thread
TILE = THREADS * ITEMS
_OPS = {"sum": 0, "count": 0, "min": 1, "max": 2}
_IDENT = {"sum": 0.0, "count": 0.0, "min": float("inf"), "max": float("-inf")}
launches = 0


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op in ("sum", "count"):
        return a + b
    return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)


def _shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """``x`` moved ``d`` places up along ``dim`` (the first ``d`` entries
    keep their own values, as ``__shfl_up_sync`` leaves them)."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, d), x.narrow(dim, 0, n - d)], dim=dim)


def _doubling_scan(v: torch.Tensor, f: torch.Tensor, op: str, dim: int, width: int):
    """The kernel's shuffle scan of (flag, value) pairs along ``dim``."""
    idx = torch.arange(v.shape[dim], device=v.device).view(
        [-1 if i == dim % v.dim() else 1 for i in range(v.dim())])
    d = 1
    while d < width:
        v2, f2 = _shift(v, d, dim), _shift(f, d, dim)
        up = idx >= d
        v = torch.where(up & ~f, _combine(op, v2, v), v)
        f = torch.where(up, f | f2, f)
        d *= 2
    return v, f


def _look_back(tile_f: torch.Tensor, tile_v: torch.Tensor, need: torch.Tensor, op: str):
    """Each tile's carry as the kernel's warp-wide look-back finds it: 32
    tile statuses at a time, back to the nearest tile that holds a key
    change (tile 0 always does)."""
    t = int(tile_f.shape[0])
    dev = tile_f.device
    lanes = torch.arange(32, device=dev)
    acc = torch.zeros(t, dtype=torch.float64, device=dev)
    have = torch.zeros(t, dtype=torch.bool, device=dev)
    done = ~need
    hi = torch.arange(t, device=dev) - 1
    while not bool(done.all()):
        j = hi[:, None] - lanes[None, :]
        jc = j.clamp(min=0)
        prefix = torch.where(j >= 0, tile_f[jc], True)
        val = torch.where(j >= 0, tile_v[jc], _IDENT[op])
        found = prefix.any(dim=1)
        stop = torch.where(found, prefix.to(torch.int8).argmax(dim=1), 31)
        x = torch.where(lanes[None, :] <= stop[:, None], val, _IDENT[op])
        o = 16
        while o:
            x = torch.cat([_combine(op, x[:, :o], x[:, o:2 * o]), x[:, o:]], dim=1)
            o >>= 1
        step = torch.where(have, _combine(op, x[:, 0], acc), x[:, 0])
        acc = torch.where(done, acc, step)
        have |= ~done
        done |= found
        hi = hi - 32
    return acc


def segment_scan_plain(keys: torch.Tensor, values: Optional[torch.Tensor], op: str,
                       threads: int = THREADS, items: int = ITEMS) -> torch.Tensor:
    """The kernel's scan in PyTorch (see module docstring); ``threads`` (a
    multiple of 32) and ``items`` set the tile as the kernel's constants do."""
    n = int(keys.shape[0])
    dev = keys.device
    if n == 0:
        return torch.zeros(0, dtype=torch.float64, device=dev)
    warps, tile = threads // 32, threads * items
    nt = -(-n // tile)
    pad = nt * tile - n
    ident = _IDENT[op]
    vals = (torch.ones(n, dtype=torch.float64, device=dev) if values is None
            else values.to(torch.float64))
    k = torch.cat([keys, keys.new_zeros(pad)]).view(nt, warps, 32 * items)
    x = torch.cat([vals, vals.new_full((pad,), ident)]).view(nt, warps, 32, items)
    pos = torch.arange(nt * tile, device=dev).view(nt, warps, 32 * items)
    # head flags; the first of each warp is the warp edge's, settled below
    head = torch.zeros_like(k, dtype=torch.bool)
    head[..., 1:] = k[..., 1:] != k[..., :-1]
    head = (head | (pos >= n)).view(nt, warps, 32, items)
    # each thread's own scan, in order
    cols = [x[..., 0]]
    for j in range(1, items):
        cols.append(torch.where(head[..., j], x[..., j], _combine(op, cols[-1], x[..., j])))
    v = torch.stack(cols, dim=-1)
    # the warp's scan of the thread aggregates
    wv, wf = _doubling_scan(v[..., -1], head.any(dim=-1), op, 2, 32)
    lane = torch.arange(32, device=dev).view(32, 1)
    ev, ef = _shift(wv, 1, 2)[..., None], _shift(wf, 1, 2)[..., None]
    open_ = torch.cumprod((~head).to(torch.int8), dim=-1).bool()
    v = torch.where(open_ & (lane > 0), _combine(op, ev, v), v)
    through = open_ & ((lane == 0) | ~ef)
    # each warp's first flag, and the scan over the warp aggregates
    first_key, last_key = k[..., 0], k[..., -1]
    edge = torch.ones(nt, warps, dtype=torch.bool, device=dev)
    edge[:, 1:] = (pos[:, 1:, 0] >= n) | (first_key[:, 1:] != last_key[:, :-1])
    if nt > 1:
        edge[1:, 0] = first_key[1:, 0] != last_key[:-1, -1]
    xv, xf = _doubling_scan(wv[..., -1], wf[..., -1] | edge, op, 1, warps)
    # the carry across tiles
    carry = _look_back(xf[:, -1], xv[:, -1], ~edge[:, 0], op)[:, None]
    below_v, below_f = _shift(xv, 1, 1), _shift(xf, 1, 1)
    warp_idx = torch.arange(warps, device=dev)
    cv = torch.where(warp_idx == 0, carry,
                     torch.where(below_f, below_v, _combine(op, carry, below_v)))
    take = (~edge)[..., None, None] & through
    v = torch.where(take, _combine(op, cv[..., None, None], v), v)
    return v.reshape(-1)[:n]


def segment_scan(keys: torch.Tensor, values: Optional[torch.Tensor], op: str) -> torch.Tensor:
    """float64 (n,) segmented inclusive scan (see module docstring)."""
    global launches
    t0 = time.perf_counter()
    if op not in _OPS:
        raise ValueError(f"segment_scan: unknown op {op!r}")
    n = int(keys.shape[0])
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("segment_scan: keys must be a contiguous 1-D int32 tensor")
    if values is None:
        if op != "count":
            raise ValueError(f"segment_scan: op {op!r} needs values")
    else:
        if values.dtype != torch.float64 or values.shape != (n,) or not values.is_contiguous():
            raise ValueError("segment_scan: values must be a contiguous float64 tensor like keys")
        if values.device != keys.device:
            raise ValueError("segment_scan: keys and values lie on different devices")
    if keys.device.type == "cpu":
        out = segment_scan_plain(keys, values, op)
        build.ledger("segment_scan", "plain", t0)
        return out
    if keys.device.type != "cuda":
        raise ValueError(f"segment_scan: unsupported device {keys.device}")
    out = torch.empty(n, dtype=torch.float64, device=keys.device)
    if n == 0:
        return out
    tiles = -(-n // TILE)
    # the look-back's ticket counter, tile states and tile values
    scratch = (torch.zeros(1 + 2 * tiles, dtype=torch.int64, device=keys.device)
               if tiles > 1 else None)
    lib = build.library()
    build.check(lib.segment_scan_launch(
        keys.data_ptr(), None if values is None else values.data_ptr(), out.data_ptr(), n,
        _OPS[op], None if scratch is None else scratch.data_ptr(), build.stream_handle(out),
    ), "segment_scan")
    launches += 1
    build.ledger("segment_scan", "cuda", t0)
    return out
