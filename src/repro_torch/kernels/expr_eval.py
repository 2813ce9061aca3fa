"""expr_eval: evaluate a compiled expression program over an input block.

``icols`` (KI, n) int32 holds dictionary codes (NULL = -1) and trinary
predicate columns, ``fcols`` (KF, n) float64 the numeric decodes (NaN =
non-numeric or NULL). Returns the output register's float64 value and
bool error per row, with the semantics of the reference's ``vm._interp``
on its float64 plane (the reference's default numpy backend), bit for bit.

CUDA kernel: ``csrc/expr_eval.cu``, one bytecode interpreter for every
program. The program lives in one device buffer per program and device
(``program_buffer``), uploaded once and cached; a launch passes its
address, and each block stages it into shared memory. Where a row's
registers live is chosen per program (``launch_shape``): a program of at
most ``SHORT_INSTRS`` instructions and ``SHORT_REGS`` registers travels by
value (``short_program``), and is not uploaded, to an instance that keeps
them in real registers; a longer one keeps them, with its inputs, in
shared-memory planes of ``threads`` values sized per launch
(``smem_bytes``, the one place that lays a block's shared memory out), or,
when those do not fit in a block even at 32 threads, in global-memory
planes. No instruction, constant or register count is refused. The
kernel's own caps are checked against this module's once, when the
library loads (``_check_limits``).
``expr_eval_plain`` is the same interpreter in PyTorch; the wrapper takes
it for CPU tensors only. Both run ``check_program``, which refuses only a
malformed program: an opcode or an operand outside the program's
registers, constants or input columns.
"""

from __future__ import annotations

import ctypes
import functools
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.exprs import bytecode as B
from repro_torch.core.exprs import terms as T
from repro_torch.kernels import build

THREADS = 128  # a block's threads (kernel_sweep.py)
SMEM_MAX = build.SMEM_MAX  # a block's dynamic shared memory, opted in
SHORT_INSTRS = 4  # the "registers" instance's instructions, by value
SHORT_REGS = 4  # and registers
WINDOW = 256  # instructions staged in shared memory at a time
INSTR_WORDS = 8  # int32 words per instruction in the program buffer
INSTANCES = {"registers": 0, "shared": 1, "global": 2}  # csrc/expr_eval.cu's modes
launches = 0
_F64 = torch.float64

# opcodes whose operands name registers: (a, b, c) used, by opcode
_REG_OPERANDS = {op: (True, True, False) for op in (*B.ARITH_OPS, *B.CMP_OPS, B.AND, B.OR,
                                                    B.COALESCE)}
_REG_OPERANDS.update({B.NOT: (True, False, False), B.IF: (True, True, True)})
# opcodes whose operands name code columns
_CODE_OPERANDS = {B.BOUND: (True, False), B.EQ_CODE: (True, True), B.NE_CODE: (True, True),
                  B.EQ_CONST: (True, False), B.NE_CONST: (True, False), B.TEST: (True, True)}


@functools.lru_cache(maxsize=256)
def check_program(prog: B.ExprProgram) -> None:
    """Raise on a malformed program (the kernel reads its operands without
    bounds checks): an unknown opcode, or a register, constant or input
    column outside the program's own."""
    regs, n_ic, n_fc = prog.n_regs, prog.n_icols, prog.n_fcols
    if not 0 <= prog.out_reg < regs:
        raise ValueError(f"expr_eval: output register {prog.out_reg} outside {regs} registers")
    for k, (op, dst, a, b, c) in enumerate(prog.instrs):
        ok = 0 <= dst < regs
        if op in _REG_OPERANDS:
            ok = ok and all(0 <= r < regs for r, used in zip((a, b, c), _REG_OPERANDS[op])
                            if used)
        elif op in _CODE_OPERANDS:
            ok = ok and all(0 <= r < n_ic for r, used in zip((a, b), _CODE_OPERANDS[op]) if used)
        elif op == B.LOAD_NUM:
            ok = ok and 0 <= a < n_fc
        elif op == B.LOAD_CONST:
            ok = ok and 0 <= a < len(prog.consts)
        else:
            raise ValueError(f"expr_eval: instruction {k} has unknown opcode {op}")
        if not ok:
            raise ValueError(f"expr_eval: instruction {k} {(op, dst, a, b, c)} names an "
                             f"operand outside the program")


def program_words(prog: B.ExprProgram) -> np.ndarray:
    """The program as the kernel reads it: ``INSTR_WORDS`` int32 per
    instruction (op, dst, a, b, c, then for LOAD_CONST the float64
    constant's low and high words, padding); the kernel takes a constant's
    error bit from the constant itself (not finite)."""
    words = np.zeros((len(prog.instrs), INSTR_WORDS), dtype=np.int32)
    if prog.instrs:
        words[:, :5] = np.asarray(prog.instrs, dtype=np.int64).astype(np.int32)
        consts = np.asarray(prog.consts, dtype=np.float64).reshape(-1)
        load = words[:, 0] == B.LOAD_CONST
        if load.any():
            words[load, 5:7] = consts.view(np.int32).reshape(-1, 2)[words[load, 2]]
    return words


@functools.lru_cache(maxsize=256)
def program_buffer(prog: B.ExprProgram, device: torch.device) -> torch.Tensor:
    """``program_words`` on ``device``, which the "shared" and "global"
    instances read: uploaded once per program and device, then used by
    every launch."""
    return torch.from_numpy(program_words(prog)).to(device)


@functools.lru_cache(maxsize=256)
def short_program(prog: B.ExprProgram):
    """(the by-value struct of ``program_words`` that the "registers"
    instance takes, its address): packed once per program of at most
    ``SHORT_INSTRS`` instructions; the launch carries it, so nothing is
    uploaded for that instance."""
    if len(prog.instrs) > SHORT_INSTRS:
        raise ValueError(f"expr_eval: {len(prog.instrs)} instructions do not travel by value")
    words = program_words(prog)
    short = (ctypes.c_int32 * (SHORT_INSTRS * INSTR_WORDS))()
    short[:words.size] = words.reshape(-1).tolist()
    return short, ctypes.addressof(short)


def window(prog: B.ExprProgram) -> int:
    """Instructions a block stages in shared memory at a time."""
    return min(max(len(prog.instrs), 1), WINDOW)


def smem_bytes(prog: B.ExprProgram, threads: int, instance: str) -> int:
    """A block's shared memory (csrc/expr_eval.cu): none for "registers";
    the program window, 32 bytes an instruction, then, for "shared", per
    thread 8 bytes a numeric input, 4 a code input, and 9 a register (its
    float64 value and its error byte)."""
    if instance == "registers":
        return 0
    per_thread = 8 * prog.n_fcols + 4 * prog.n_icols + 9 * prog.n_regs
    return 32 * window(prog) + (threads * per_thread if instance == "shared" else 0)


def launch_shape(prog: B.ExprProgram, threads: int = THREADS) -> Tuple[int, str]:
    """(threads a block, instance) for ``prog``: "registers" for a program
    within ``SHORT_INSTRS`` instructions and ``SHORT_REGS`` registers;
    else "shared" at ``threads``, halved down to 32 while the planes exceed
    ``SMEM_MAX``; else "global" at ``threads``."""
    if fits(prog, threads, "registers"):
        return threads, "registers"
    t = threads
    while smem_bytes(prog, t, "shared") > SMEM_MAX and t > 32:
        t //= 2
    if smem_bytes(prog, t, "shared") > SMEM_MAX:
        return threads, "global"
    return t, "shared"


def fits(prog: B.ExprProgram, threads: int, instance: str) -> bool:
    """Whether the kernel takes ``prog`` in ``instance`` at ``threads``."""
    if instance == "registers":
        return len(prog.instrs) <= SHORT_INSTRS and prog.n_regs <= SHORT_REGS
    return smem_bytes(prog, threads, instance) <= SMEM_MAX


def expr_eval_plain(prog: B.ExprProgram, icols: torch.Tensor,
                    fcols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    check_program(prog)
    n = int(icols.shape[1])
    dev = icols.device
    vals = [None] * prog.n_regs
    errs = [None] * prog.n_regs
    no_err = torch.zeros(n, dtype=torch.bool, device=dev)
    null = icols == -1 if prog.n_icols else None

    def truthy(r):
        return vals[r] != 0

    for op, dst, a, b, c in prog.instrs:
        if op == B.LOAD_NUM:
            vals[dst], errs[dst] = fcols[a].to(_F64), torch.isnan(fcols[a])
        elif op == B.LOAD_CONST:
            k = float(prog.consts[a])
            fin = math.isfinite(k)
            vals[dst] = torch.full((n,), k if fin else 0.0, dtype=_F64, device=dev)
            errs[dst] = torch.full((n,), not fin, dtype=torch.bool, device=dev)
        elif op == B.BOUND:
            vals[dst], errs[dst] = (~null[a]).to(_F64), no_err
        elif op in (B.EQ_CODE, B.NE_CODE):
            eq = icols[a] == icols[b]
            vals[dst] = (eq if op == B.EQ_CODE else ~eq).to(_F64)
            errs[dst] = null[a] | null[b]
        elif op in (B.EQ_CONST, B.NE_CONST):
            eq = icols[a] == b
            vals[dst] = (eq if op == B.EQ_CONST else ~eq).to(_F64)
            errs[dst] = null[a]
        elif op == B.TEST:
            tri = icols[a]
            vals[dst] = (tri == T.TRUE).to(_F64)
            errs[dst] = (tri == T.ERROR) | null[b]
        elif op in B.ARITH_OPS:
            x, y = vals[a], vals[b]
            v = _ARITH[op](x, y)
            fin = torch.isfinite(v)
            vals[dst] = torch.where(fin, v, 0)
            errs[dst] = errs[a] | errs[b] | ~fin
        elif op in B.CMP_OPS:
            vals[dst] = _CMP[op](vals[a], vals[b]).to(_F64)
            errs[dst] = errs[a] | errs[b]
        elif op == B.NOT:
            vals[dst], errs[dst] = (~truthy(a)).to(_F64), errs[a]
        elif op == B.AND:
            fa = ~truthy(a) & ~errs[a]
            fb = ~truthy(b) & ~errs[b]
            vals[dst] = (truthy(a) & truthy(b) & ~errs[a] & ~errs[b]).to(_F64)
            errs[dst] = (errs[a] | errs[b]) & ~fa & ~fb
        elif op == B.OR:
            ta = truthy(a) & ~errs[a]
            tb = truthy(b) & ~errs[b]
            vals[dst] = (ta | tb).to(_F64)
            errs[dst] = (errs[a] | errs[b]) & ~ta & ~tb
        elif op == B.IF:
            take = truthy(a)
            vals[dst] = torch.where(take, vals[b], vals[c])
            errs[dst] = errs[a] | torch.where(take, errs[b], errs[c])
        elif op == B.COALESCE:
            vals[dst] = torch.where(errs[a], vals[b], vals[a])
            errs[dst] = errs[a] & errs[b]
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


@functools.lru_cache(maxsize=1)
def _check_limits(lib) -> None:
    got = [ctypes.c_int() for _ in range(4)]
    lib.expr_eval_limits(*[ctypes.byref(x) for x in got])
    want = (SHORT_INSTRS, SHORT_REGS, 4 * SHORT_INSTRS * INSTR_WORDS, SMEM_MAX)
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"expr_eval: kernel caps {[x.value for x in got]} != {want}")


def expr_eval(prog: B.ExprProgram, icols: torch.Tensor,
              fcols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value float64 (n,), error bool (n,)) of ``prog`` over the block."""
    t0 = time.perf_counter()
    if icols.dtype != torch.int32 or icols.dim() != 2 or not icols.is_contiguous():
        raise ValueError("expr_eval: icols must be a contiguous (KI, n) int32 tensor")
    if fcols.dtype != _F64 or fcols.dim() != 2 or not fcols.is_contiguous():
        raise ValueError("expr_eval: fcols must be a contiguous (KF, n) float64 tensor")
    n = int(icols.shape[1])
    if fcols.shape[1] != n or icols.shape[0] < prog.n_icols or fcols.shape[0] < prog.n_fcols:
        raise ValueError("expr_eval: input block does not match the program")
    if fcols.device != icols.device:
        raise ValueError("expr_eval: icols and fcols lie on different devices")
    dev = icols.device
    if dev.type == "cpu":
        out = expr_eval_plain(prog, icols, fcols)
        build.ledger("expr_eval", "plain", t0)
        return out
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: unsupported device {dev}")
    return _launch(prog, icols, fcols, *launch_shape(prog), t0=t0)


def _launch(prog: B.ExprProgram, icols: torch.Tensor, fcols: torch.Tensor, threads: int,
            instance: str, t0: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel's ``instance`` at ``threads`` on CUDA inputs that
    ``expr_eval`` has checked; ``kernel_sweep.py`` times the shapes that
    ``launch_shape`` does not pick through it."""
    global launches
    if t0 is None:
        t0 = time.perf_counter()
    check_program(prog)
    if not fits(prog, threads, instance):
        raise ValueError(f"expr_eval: the {instance} instance at {threads} threads does not "
                         f"take this program")
    lib = build.library()
    _check_limits(lib)
    dev = icols.device
    n = int(icols.shape[1])
    regs = instance == "registers"
    buf = None if regs else program_buffer(prog, dev)
    short = short_program(prog)[1] if regs else None
    val = torch.empty(n, dtype=_F64, device=dev)
    err = torch.empty(n, dtype=torch.bool, device=dev)
    gv = ge = None
    if instance == "global":
        gv = torch.empty(prog.n_regs * n, dtype=_F64, device=dev)
        ge = torch.empty(prog.n_regs * n, dtype=torch.uint8, device=dev)
    build.check(lib.expr_eval_launch(
        short, None if buf is None else buf.data_ptr(), len(prog.instrs), window(prog),
        prog.n_regs, prog.n_icols, prog.n_fcols, prog.out_reg, icols.data_ptr(),
        fcols.data_ptr(), n, val.data_ptr(), err.data_ptr(), threads, INSTANCES[instance],
        smem_bytes(prog, threads, instance), None if gv is None else gv.data_ptr(),
        None if ge is None else ge.data_ptr(), build.stream_handle(val),
    ), "expr_eval")
    launches += 1
    build.ledger("expr_eval", "cuda", t0)
    return val, err
