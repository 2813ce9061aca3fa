"""gather_emit: fused join emission.

Gathers the emitted rows of two int32 sources through the ``(li, ri)``
index vectors, NULL-extends virtual right rows (``ri == -1``), and folds the
secondary join-key equalities ``pairs`` into a bool validity mask — the
contract of the reference's ``vecops.gather_emit``:

  lcols: (KL, NL) int32 left source, rows contiguous (any row stride);
  rcols: (KR, NR) int32 right source, or None;
  li, ri: (C,) int32 gather indices (ri may be None); ri == -1 marks a
         virtual NULL row whose right outputs are NULL and whose pair
         comparisons pass;
  lsel, rsel: (nl,), (nr,) int32 source-row ids to emit; -1 emits NULL;
  pairs: (P, 2) int32 (left row, right row) equality pairs;
  out / out_offset: optional destination; rows [0, nl+nr) of
         ``out[:, out_offset:out_offset+C]`` are written in place.

Returns ``(block, mask)``: the (nl+nr, C) emitted block (a view of ``out``
when given) and the (C,) bool mask.

CUDA kernel: ``csrc/gather_emit.cu``. ``gather_emit_plain`` is the same
function in PyTorch; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

NULL = -1
launches = 0


def index_tensor(rows: Sequence[int], device) -> torch.Tensor:
    """A small int32 row-id vector (emit selections) on ``device``."""
    return torch.tensor(list(rows), dtype=torch.int32, device=device).reshape(-1)


def pairs_tensor(pairs: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """(P, 2) int32 equality pairs on ``device``."""
    return torch.tensor(
        [list(p) for p in pairs], dtype=torch.int32, device=device
    ).reshape(-1, 2)


def gather_emit_plain(lcols, rcols, li, ri, lsel, rsel, pairs,
                      out: Optional[torch.Tensor] = None, out_offset: int = 0):
    c = int(li.shape[0])
    lsel_l, rsel_l, pairs_l = lsel.tolist(), rsel.tolist(), pairs.tolist()
    nl = len(lsel_l)
    k = nl + len(rsel_l)
    if out is None:
        view = torch.empty((k, c), dtype=torch.int32, device=li.device)
    else:
        view = out[:k, out_offset: out_offset + c]
    lidx = li.long()
    if ri is None:
        rvalid, ric = None, None
    else:
        rvalid = ri >= 0
        ric = torch.where(rvalid, ri, 0).long()
    r_empty = rcols is None or rcols.shape[1] == 0
    for j, row in enumerate(lsel_l):
        if row < 0:
            view[j] = NULL
        else:
            view[j] = lcols[row, lidx]
    for j, row in enumerate(rsel_l):
        if row < 0 or r_empty:
            view[nl + j] = NULL
        else:
            view[nl + j] = torch.where(rvalid, rcols[row, ric], NULL)
    mask = torch.ones(c, dtype=torch.bool, device=li.device)
    for lrow, rrow in pairs_l:
        lv = lcols[lrow, lidx]
        rv = torch.zeros(c, dtype=torch.int32, device=li.device) if r_empty else rcols[rrow, ric]
        eq = lv == rv
        mask &= eq if rvalid is None else (~rvalid | eq)
    return view, mask


def _check_2d(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"gather_emit: {name} must be a 2-D int32 tensor with contiguous rows")


def _check_1d(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"gather_emit: {name} must be a contiguous 1-D int32 tensor")


def gather_emit(lcols, rcols, li, ri, lsel, rsel, pairs,
                out: Optional[torch.Tensor] = None, out_offset: int = 0):
    """Fused gather + NULL-extension + pair mask (see module docstring)."""
    global launches
    dev = li.device
    _check_2d("lcols", lcols)
    _check_1d("li", li)
    _check_1d("lsel", lsel)
    _check_1d("rsel", rsel)
    c = int(li.shape[0])
    r_empty = rcols is None or rcols.shape[1] == 0
    if rcols is not None:
        _check_2d("rcols", rcols)
    if ri is not None:
        _check_1d("ri", ri)
        if ri.shape[0] != c:
            raise ValueError("gather_emit: li and ri differ in length")
    elif not r_empty and (rsel.shape[0] or pairs.shape[0]):
        raise ValueError("gather_emit: right rows requested without ri")
    if pairs.dtype != torch.int32 or pairs.dim() != 2 or pairs.shape[1] != 2 \
            or not pairs.is_contiguous():
        raise ValueError("gather_emit: pairs must be a contiguous (P, 2) int32 tensor")
    k = int(lsel.shape[0]) + int(rsel.shape[0])
    if out is not None:
        _check_2d("out", out)
        if out.shape[0] < k or out.shape[1] < out_offset + c:
            raise ValueError("gather_emit: out is too small for the block")
    for name, x in (("lcols", lcols), ("rcols", rcols), ("ri", ri), ("lsel", lsel),
                    ("rsel", rsel), ("pairs", pairs), ("out", out)):
        if x is not None and x.device != dev:
            raise ValueError(f"gather_emit: {name} is on {x.device}, not {dev}")
    if dev.type == "cpu":
        return gather_emit_plain(lcols, rcols, li, ri, lsel, rsel, pairs, out, out_offset)
    if dev.type != "cuda":
        raise ValueError(f"gather_emit: unsupported device {dev}")
    if out is None:
        out = torch.empty((k, c), dtype=torch.int32, device=dev)
        out_offset = 0
    mask = torch.empty(c, dtype=torch.bool, device=dev)
    lib = build.library()
    build.check(lib.gather_emit_launch(
        lcols.data_ptr(), lcols.stride(0),
        0 if r_empty else rcols.data_ptr(), 0 if r_empty else rcols.stride(0),
        int(r_empty), li.data_ptr(), None if ri is None else ri.data_ptr(), c,
        lsel.data_ptr(), int(lsel.shape[0]), rsel.data_ptr(), int(rsel.shape[0]),
        pairs.data_ptr(), int(pairs.shape[0]),
        out.data_ptr() + 4 * int(out_offset), out.stride(0), mask.data_ptr(),
        build.stream_handle(li),
    ), "gather_emit")
    launches += 1
    return out[:k, out_offset: out_offset + c], mask
