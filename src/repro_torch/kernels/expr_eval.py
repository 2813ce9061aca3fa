"""expr_eval: evaluate a compiled expression program over an input block.

``icols`` (KI, n) int32 holds dictionary codes (NULL = -1) and trinary
predicate columns, ``fcols`` (KF, n) float32 the numeric decodes (NaN =
non-numeric or NULL). Returns the output register's float32 value and
bool error per row, with the semantics of the reference's ``vm._interp``
on its float32 plane.

CUDA kernel: ``csrc/expr_eval.cu``, one bytecode interpreter for every
program; the program travels as a by-value kernel parameter, so programs
beyond the kernel's instruction, constant or register caps are refused.
``expr_eval_plain`` is the same interpreter in PyTorch; the wrapper takes
it for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.exprs import bytecode as B
from repro_torch.core.exprs import terms as T
from repro_torch.kernels import build

MAX_INSTR = 96
MAX_CONSTS = 64
MAX_REGS = 48
launches = 0


class _ExprProg(ctypes.Structure):
    """Mirror of ``struct ExprProg`` in csrc/expr_eval.cu."""

    _fields_ = [
        ("n_instr", ctypes.c_int),
        ("n_regs", ctypes.c_int),
        ("out_reg", ctypes.c_int),
        ("n_consts", ctypes.c_int),
        ("instr", ctypes.c_int * (MAX_INSTR * 5)),
        ("consts", ctypes.c_float * MAX_CONSTS),
        ("const_err", ctypes.c_ubyte * MAX_CONSTS),
    ]


def check_program(prog: B.ExprProgram) -> None:
    """Raise when the program exceeds the kernel's fixed caps."""
    if len(prog.instrs) > MAX_INSTR:
        raise ValueError(f"expr_eval: {len(prog.instrs)} instructions exceed {MAX_INSTR}")
    if len(prog.consts) > MAX_CONSTS:
        raise ValueError(f"expr_eval: {len(prog.consts)} constants exceed {MAX_CONSTS}")
    if prog.n_regs > MAX_REGS:
        raise ValueError(f"expr_eval: {prog.n_regs} registers exceed {MAX_REGS}")


@functools.lru_cache(maxsize=256)
def _prog_struct(prog: B.ExprProgram) -> _ExprProg:
    check_program(prog)
    s = _ExprProg()
    s.n_instr = len(prog.instrs)
    s.n_regs = prog.n_regs
    s.out_reg = prog.out_reg
    s.n_consts = len(prog.consts)
    for k, ins in enumerate(prog.instrs):
        for j, x in enumerate(ins):
            s.instr[5 * k + j] = int(x)
    with np.errstate(over="ignore"):
        c32 = np.asarray(prog.consts, dtype=np.float64).astype(np.float32)
    for k, (c64, c) in enumerate(zip(prog.consts, c32.tolist())):
        s.consts[k] = c
        s.const_err[k] = 0 if math.isfinite(c64) else 1
    return s


@functools.lru_cache(maxsize=1)
def _check_limits(lib) -> None:
    got = [ctypes.c_int() for _ in range(4)]
    lib.expr_eval_limits(*[ctypes.byref(x) for x in got])
    want = (MAX_INSTR, MAX_CONSTS, MAX_REGS, ctypes.sizeof(_ExprProg))
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"expr_eval: kernel caps {[x.value for x in got]} != {want}")


def expr_eval_plain(prog: B.ExprProgram, icols: torch.Tensor,
                    fcols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = int(icols.shape[1])
    dev = icols.device
    vals = [None] * prog.n_regs
    errs = [None] * prog.n_regs
    no_err = torch.zeros(n, dtype=torch.bool, device=dev)
    null = icols == -1 if prog.n_icols else None
    f32 = torch.float32

    def truthy(r):
        return vals[r] != 0

    for op, dst, a, b, c in prog.instrs:
        if op == B.LOAD_NUM:
            vals[dst], errs[dst] = fcols[a].to(f32), torch.isnan(fcols[a])
        elif op == B.LOAD_CONST:
            k = prog.consts[a]
            with np.errstate(over="ignore"):
                kf = float(np.float32(k))
            v = torch.full((n,), kf, dtype=f32, device=dev)
            vals[dst] = torch.where(torch.isfinite(v), v, 0)
            errs[dst] = torch.full((n,), not math.isfinite(k), dtype=torch.bool, device=dev)
        elif op == B.BOUND:
            vals[dst], errs[dst] = (~null[a]).to(f32), no_err
        elif op in (B.EQ_CODE, B.NE_CODE):
            eq = icols[a] == icols[b]
            vals[dst] = (eq if op == B.EQ_CODE else ~eq).to(f32)
            errs[dst] = null[a] | null[b]
        elif op in (B.EQ_CONST, B.NE_CONST):
            eq = icols[a] == b
            vals[dst] = (eq if op == B.EQ_CONST else ~eq).to(f32)
            errs[dst] = null[a]
        elif op == B.TEST:
            tri = icols[a]
            vals[dst] = (tri == T.TRUE).to(f32)
            errs[dst] = (tri == T.ERROR) | null[b]
        elif op in B.ARITH_OPS:
            x, y = vals[a], vals[b]
            v = _ARITH[op](x, y)
            fin = torch.isfinite(v)
            vals[dst] = torch.where(fin, v, 0)
            errs[dst] = errs[a] | errs[b] | ~fin
        elif op in B.CMP_OPS:
            vals[dst] = _CMP[op](vals[a], vals[b]).to(f32)
            errs[dst] = errs[a] | errs[b]
        elif op == B.NOT:
            vals[dst], errs[dst] = (~truthy(a)).to(f32), errs[a]
        elif op == B.AND:
            fa = ~truthy(a) & ~errs[a]
            fb = ~truthy(b) & ~errs[b]
            vals[dst] = (truthy(a) & truthy(b) & ~errs[a] & ~errs[b]).to(f32)
            errs[dst] = (errs[a] | errs[b]) & ~fa & ~fb
        elif op == B.OR:
            ta = truthy(a) & ~errs[a]
            tb = truthy(b) & ~errs[b]
            vals[dst] = (ta | tb).to(f32)
            errs[dst] = (errs[a] | errs[b]) & ~ta & ~tb
        elif op == B.IF:
            take = truthy(a)
            vals[dst] = torch.where(take, vals[b], vals[c])
            errs[dst] = errs[a] | torch.where(take, errs[b], errs[c])
        elif op == B.COALESCE:
            vals[dst] = torch.where(errs[a], vals[b], vals[a])
            errs[dst] = errs[a] & errs[b]
        else:  # pragma: no cover - opcode set is closed
            raise ValueError(f"bad opcode {op}")
    return vals[prog.out_reg], errs[prog.out_reg]


_ARITH = {
    B.ADD: lambda x, y: x + y,
    B.SUB: lambda x, y: x - y,
    B.MUL: lambda x, y: x * y,
    B.DIV: lambda x, y: x / y,
}
_CMP = {
    B.LT: lambda x, y: x < y,
    B.LE: lambda x, y: x <= y,
    B.GT: lambda x, y: x > y,
    B.GE: lambda x, y: x >= y,
    B.EQ_NUM: lambda x, y: x == y,
    B.NE_NUM: lambda x, y: x != y,
}


def expr_eval(prog: B.ExprProgram, icols: torch.Tensor,
              fcols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value float32 (n,), error bool (n,)) of ``prog`` over the block."""
    global launches
    if icols.dtype != torch.int32 or icols.dim() != 2 or not icols.is_contiguous():
        raise ValueError("expr_eval: icols must be a contiguous (KI, n) int32 tensor")
    if fcols.dtype != torch.float32 or fcols.dim() != 2 or not fcols.is_contiguous():
        raise ValueError("expr_eval: fcols must be a contiguous (KF, n) float32 tensor")
    n = int(icols.shape[1])
    if fcols.shape[1] != n or icols.shape[0] < prog.n_icols or fcols.shape[0] < prog.n_fcols:
        raise ValueError("expr_eval: input block does not match the program")
    if fcols.device != icols.device:
        raise ValueError("expr_eval: icols and fcols lie on different devices")
    dev = icols.device
    if dev.type == "cpu":
        return expr_eval_plain(prog, icols, fcols)
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: unsupported device {dev}")
    lib = build.library()
    _check_limits(lib)
    s = _prog_struct(prog)
    val = torch.empty(n, dtype=torch.float32, device=dev)
    err = torch.empty(n, dtype=torch.bool, device=dev)
    build.check(lib.expr_eval_launch(
        ctypes.addressof(s), icols.data_ptr(), fcols.data_ptr(), n,
        val.data_ptr(), err.data_ptr(), build.stream_handle(val),
    ), "expr_eval")
    launches += 1
    return val, err
