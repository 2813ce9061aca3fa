"""gather_emit: fused join emission.

Gathers the emitted rows of two int32 sources through the ``(li, ri)``
index vectors, NULL-extends virtual right rows (``ri == -1``), and folds the
secondary join-key equalities into a bool validity mask — the contract of
the reference's ``vecops.gather_emit``:

  lcols: (KL, NL) int32 left source, rows contiguous (any row stride);
  rcols: (KR, NR) int32 right source, or None;
  li, ri: (C,) int32 gather indices (ri may be None); ri == -1 marks a
         virtual NULL row whose right outputs are NULL and whose pair
         comparisons pass;
  plan: an ``EmitPlan`` — ``lsel``, ``rsel``, the source-row ids to emit
         (-1 emits NULL), and ``pairs``, the (left row, right row)
         equality pairs;
  out / out_offset: optional destination; rows [0, nl+nr) of
         ``out[:, out_offset:out_offset+C]`` are written in place.

Returns ``(block, mask)``: the (nl+nr, C) emitted block (a view of ``out``
when given) and the (C,) bool mask.

CUDA kernel: ``csrc/gather_emit.cu``, which takes the plan as a by-value
kernel parameter of at most ``MAX_ROWS`` emitted rows and ``MAX_PAIRS``
pairs. A wider plan is split, when it is built, into chunks within those
caps over the same ``li``/``ri``: chunk k writes its own rows ``[r_k, r_k +
n_k)`` of the block, the first chunk writes the mask and every later chunk
with pairs ANDs its pairs into it, one launch each. ``gather_emit_plain`` is
the same function in PyTorch over the whole plan, reading its host tuples;
the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Iterable, Optional, Tuple

import torch

from repro_torch.kernels import build

NULL = -1
# csrc/gather_emit.cu's caps for one launch: over twice the widest plan of
# the LSQB, path and BSBM BI queries (5 emitted rows, 1 pair), so each of
# their plans is one launch; a wider plan is several
MAX_ROWS = 16
MAX_PAIRS = 4
launches = 0
_I32 = torch.int32


class _EmitPlanC(ctypes.Structure):
    """Mirror of ``struct EmitPlan`` in csrc/gather_emit.cu: one launch's
    chunk of a plan."""

    _fields_ = [
        ("n_left", ctypes.c_int),
        ("n_rows", ctypes.c_int),
        ("n_pairs", ctypes.c_int),
        ("row", ctypes.c_int * MAX_ROWS),
        ("pair_left", ctypes.c_int * MAX_PAIRS),
        ("pair_right", ctypes.c_int * MAX_PAIRS),
        ("pair_reuse", ctypes.c_int * MAX_PAIRS),
    ]


class EmitPlan:
    """What one ``gather_emit`` call emits: ``lsel`` left and ``rsel``
    right source rows (-1 emits NULL) and the ``pairs`` (left row, right
    row) that must be equal. Built once on the host per operator (or per
    probe schema), and packed into the by-value structs of its launches:
    one for a plan within ``MAX_ROWS`` rows and ``MAX_PAIRS`` pairs, else
    ``max(ceil(rows / MAX_ROWS), ceil(pairs / MAX_PAIRS))`` chunks, chunk k
    taking rows ``[k * MAX_ROWS, (k + 1) * MAX_ROWS)`` and pairs ``[k *
    MAX_PAIRS, (k + 1) * MAX_PAIRS)``; ``chunks`` holds (first row,
    struct) per launch."""

    __slots__ = ("lsel", "rsel", "pairs", "n_rows", "chunks")

    def __init__(self, lsel: Iterable[int] = (), rsel: Iterable[int] = (),
                 pairs: Iterable[Tuple[int, int]] = ()):
        self.lsel = tuple(int(x) for x in lsel)
        self.rsel = tuple(int(x) for x in rsel)
        self.pairs = tuple((int(a), int(b)) for a, b in pairs)
        self.n_rows = len(self.lsel) + len(self.rsel)
        if any(a < 0 or b < 0 for a, b in self.pairs):
            raise ValueError("gather_emit: pair rows must be non-negative")
        rows, nl = self.lsel + self.rsel, len(self.lsel)
        n_chunks = max(1, -(-len(rows) // MAX_ROWS), -(-len(self.pairs) // MAX_PAIRS))
        chunks = []
        for k in range(n_chunks):
            r0 = k * MAX_ROWS
            crows = rows[r0: r0 + MAX_ROWS]
            cpairs = self.pairs[k * MAX_PAIRS: (k + 1) * MAX_PAIRS]
            cleft = rows[r0: min(nl, r0 + MAX_ROWS)]
            s = _EmitPlanC()
            s.n_left, s.n_rows, s.n_pairs = len(cleft), len(crows), len(cpairs)
            for j, row in enumerate(crows):
                s.row[j] = row
            for p, (a, b) in enumerate(cpairs):
                s.pair_left[p], s.pair_right[p] = a, b
                s.pair_reuse[p] = cleft.index(a) if a in cleft else -1
            chunks.append((r0, s, ctypes.addressof(s)))
        self.chunks = tuple(chunks)


@functools.lru_cache(maxsize=1)
def _check_limits(lib) -> None:
    got = [ctypes.c_int() for _ in range(3)]
    lib.gather_emit_limits(*[ctypes.byref(x) for x in got])
    want = (MAX_ROWS, MAX_PAIRS, ctypes.sizeof(_EmitPlanC))
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"gather_emit: kernel caps {[x.value for x in got]} != {want}")


def gather_emit_plain(lcols, rcols, li, ri, plan: EmitPlan,
                      out: Optional[torch.Tensor] = None, out_offset: int = 0):
    c = int(li.shape[0])
    nl = len(plan.lsel)
    k = plan.n_rows
    if out is None:
        view = torch.empty((k, c), dtype=_I32, device=li.device)
    else:
        view = out[:k, out_offset: out_offset + c]
    lidx = li.long()
    if ri is None:
        rvalid, ric = None, None
    else:
        rvalid = ri >= 0
        ric = torch.where(rvalid, ri, 0).long()
    r_empty = rcols is None or rcols.shape[1] == 0
    for j, row in enumerate(plan.lsel):
        if row < 0:
            view[j] = NULL
        else:
            view[j] = lcols[row, lidx]
    for j, row in enumerate(plan.rsel):
        if row < 0 or r_empty:
            view[nl + j] = NULL
        else:
            view[nl + j] = torch.where(rvalid, rcols[row, ric], NULL)
    mask = torch.ones(c, dtype=torch.bool, device=li.device)
    for lrow, rrow in plan.pairs:
        lv = lcols[lrow, lidx]
        rv = torch.zeros(c, dtype=_I32, device=li.device) if r_empty else rcols[rrow, ric]
        eq = lv == rv
        mask &= eq if rvalid is None else (~rvalid | eq)
    return view, mask


def _check_2d(name: str, x: torch.Tensor) -> None:
    if x.dtype is not _I32 or x.ndim != 2 or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"gather_emit: {name} must be a 2-D int32 tensor with contiguous rows")


def _check_1d(name: str, x: torch.Tensor) -> None:
    if x.dtype is not _I32 or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"gather_emit: {name} must be a contiguous 1-D int32 tensor")


def gather_emit(lcols, rcols, li, ri, plan: EmitPlan,
                out: Optional[torch.Tensor] = None, out_offset: int = 0):
    """Fused gather + NULL-extension + pair mask (see module docstring)."""
    global launches
    t0 = time.perf_counter()
    dev = li.device
    _check_2d("lcols", lcols)
    _check_1d("li", li)
    c = li.shape[0]
    r_empty = rcols is None or rcols.shape[1] == 0
    if rcols is not None:
        _check_2d("rcols", rcols)
    if ri is not None:
        _check_1d("ri", ri)
        if ri.shape[0] != c:
            raise ValueError("gather_emit: li and ri differ in length")
    elif not r_empty and (plan.rsel or plan.pairs):
        raise ValueError("gather_emit: right rows requested without ri")
    k = plan.n_rows
    if out is not None:
        _check_2d("out", out)
        if out.shape[0] < k or out.shape[1] < out_offset + c:
            raise ValueError("gather_emit: out is too small for the block")
    for name, x in (("lcols", lcols), ("rcols", rcols), ("ri", ri), ("out", out)):
        if x is not None and x.device != dev:
            raise ValueError(f"gather_emit: {name} is on {x.device}, not {dev}")
    if li.is_cpu:
        res = gather_emit_plain(lcols, rcols, li, ri, plan, out, out_offset)
        build.ledger("gather_emit", "plain", t0)
        return res
    if not li.is_cuda:
        raise ValueError(f"gather_emit: unsupported device {dev}")
    lib = build.library()
    _check_limits(lib)
    mask = torch.empty(c, dtype=torch.bool, device=dev)
    if out is None:
        block = out = torch.empty((k, c), dtype=_I32, device=dev)
        out_offset = 0
    else:
        block = out[:k, out_offset: out_offset + c]
    base = out.data_ptr() + 4 * out_offset
    for r0, s, address in plan.chunks:
        # a later chunk without pairs leaves the mask alone
        m = mask if r0 == 0 or s.n_pairs else None
        build.check(lib.gather_emit_launch(
            address, lcols.data_ptr(), lcols.stride(0),
            None if r_empty else rcols.data_ptr(), 0 if r_empty else rcols.stride(0),
            r_empty, li.data_ptr(), None if ri is None else ri.data_ptr(), c,
            base + 4 * r0 * out.stride(0), out.stride(0), None if m is None else m.data_ptr(),
            int(r0 > 0), build.stream_handle(li),
        ), "gather_emit")
        launches += 1
        t0 = build.ledger("gather_emit", "cuda", t0)
    return block, mask
