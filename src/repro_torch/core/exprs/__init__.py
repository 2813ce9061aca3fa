"""Vectorized expression subsystem: the compiler and bytecode (host) and
the VM executor (``vm``, device; imported explicitly)."""

from repro_torch.core.exprs.bytecode import ExprProgram, TableSpec, disassemble
from repro_torch.core.exprs.compiler import ExprCompileError, compile_expr

__all__ = [
    "ExprProgram",
    "TableSpec",
    "ExprCompileError",
    "compile_expr",
    "disassemble",
]
