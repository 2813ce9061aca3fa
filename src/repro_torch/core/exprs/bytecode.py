"""Bytecode format of the vectorized expression VM (DESIGN.md §9).

A compiled expression is a flat, register-based, straight-line program: a
tuple of ``(opcode, dst, a, b, c)`` int32 instructions plus the static
input plan. Registers are *columns*: the executor holds a value plane
(float64 on the numpy oracle, float32 on the jnp / Pallas backends) and a
parallel boolean **error plane** — SPARQL's three-valued logic carried
explicitly, so ``!``/``&&``/``||``/``COALESCE``/``IF`` are exact
(true / false / error per row).

Operand domains follow the paper's §2.2.1 split:

  * code-domain ops (EQ_CODE, EQ_CONST, BOUND, TEST) read int32 dictionary
    codes straight from the input block ``icols`` — equality, bound-ness,
    term tests and dictionary-domain string predicates never decode;
  * value-domain ops (LOAD_NUM, arithmetic, ordered comparisons) run over
    the pre-decoded float block ``fcols`` (one vectorized ``take`` through
    the dictionary's numeric side-array per referenced column).

Booleans live in the value plane as 0.0/1.0, so logic ops and IF/COALESCE
are plane-agnostic. The program is a frozen, hashable dataclass: it is the
static argument that specializes the jit'd jnp reference and the fused
Pallas kernel (one compiled kernel per program, one dispatch per batch).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.dictionary import Term

# ---------------------------------------------------------------------------
# opcodes
# ---------------------------------------------------------------------------

(
    LOAD_NUM,    # dst <- fcols[a]; err = isnan
    LOAD_CONST,  # dst <- consts[a]; err = non-finite const (folded 1/0)
    BOUND,       # dst <- icols[a] != NULL; err = false
    EQ_CODE,     # dst <- icols[a] == icols[b]; err = either NULL
    NE_CODE,     # dst <- icols[a] != icols[b]; err = either NULL
    EQ_CONST,    # dst <- icols[a] == b (code constant); err = icols[a] NULL
    NE_CONST,    # dst <- icols[a] != b; err = icols[a] NULL
    TEST,        # dst <- icols[a] (trinary pred column); err also on icols[b] NULL
    ADD,         # dst <- r[a] + r[b]; err propagates, nonfinite -> err
    SUB,
    MUL,
    DIV,         # division by zero / nonfinite -> err (xsd:decimal semantics)
    LT,          # dst <- r[a] < r[b]; err propagates
    LE,
    GT,
    GE,
    EQ_NUM,      # value-domain equality (computed operands)
    NE_NUM,
    NOT,         # dst <- !truthy(r[a]); err = r[a].err
    AND,         # Kleene: false dominates error
    OR,          # Kleene: true dominates error
    IF,          # dst <- truthy(r[a]) ? r[b] : r[c]; cond error -> error
    COALESCE,    # dst <- r[a] unless its row errs, else r[b]
) = range(23)

OP_NAMES = (
    "load_num", "load_const", "bound", "eq_code", "ne_code", "eq_const",
    "ne_const", "test", "add", "sub", "mul", "div", "lt", "le", "gt", "ge",
    "eq_num", "ne_num", "not", "and", "or", "if", "coalesce",
)

# instruction classes (used by the executor and the disassembler)
CODE_OPS = frozenset((BOUND, EQ_CODE, NE_CODE, EQ_CONST, NE_CONST, TEST))
ARITH_OPS = {ADD: "+", SUB: "-", MUL: "*", DIV: "/"}
CMP_OPS = {LT: "<", LE: "<=", GT: ">", GE: ">=", EQ_NUM: "=", NE_NUM: "!="}

Instr = Tuple[int, int, int, int, int]  # (op, dst, a, b, c)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """A dictionary-domain predicate input: ``func(args...)`` evaluated once
    per distinct term (terms.term_predicate), broadcast to rows with one
    take. Materializes as a trinary {0,1,2} int32 row of ``icols``."""

    func: str
    args: Tuple[Term, ...]
    var: int  # the tested variable (its code column carries NULL-ness)


@dataclasses.dataclass(frozen=True)
class ExprProgram:
    """A compiled expression. Frozen + hashable: jit static argument.

    Input block layout (built per batch by vm.prepare_inputs):
      icols[0 : len(code_vars)]              int32 code columns, NULL = -1;
      icols[len(code_vars) : + len(tables)]  trinary predicate columns;
      fcols[0 : len(num_vars)]               float numeric decodes (NaN =
                                             non-numeric or NULL).
    """

    instrs: Tuple[Instr, ...]
    n_regs: int
    out_reg: int
    consts: Tuple[float, ...]
    code_vars: Tuple[int, ...]
    num_vars: Tuple[int, ...]
    tables: Tuple[TableSpec, ...]
    source_ops: int  # pre-folding/CSE node count of the algebra tree

    @property
    def n_icols(self) -> int:
        return len(self.code_vars) + len(self.tables)

    @property
    def n_fcols(self) -> int:
        return len(self.num_vars)

    def vars(self) -> Tuple[int, ...]:
        out = self.code_vars + tuple(t.var for t in self.tables) + self.num_vars
        return tuple(dict.fromkeys(out))


def disassemble(prog: ExprProgram) -> str:
    """Human-readable listing (tests pin compiler output against this)."""
    lines = []
    for op, dst, a, b, c in prog.instrs:
        nm = OP_NAMES[op]
        if op == LOAD_CONST:
            lines.append(f"r{dst} = const {prog.consts[a]}")
        elif op == LOAD_NUM:
            lines.append(f"r{dst} = num ?v{prog.num_vars[a]}")
        elif op == BOUND:
            lines.append(f"r{dst} = bound ?v{prog.code_vars[a]}")
        elif op in (EQ_CODE, NE_CODE):
            s = "==" if op == EQ_CODE else "!="
            lines.append(
                f"r{dst} = code ?v{prog.code_vars[a]} {s} ?v{prog.code_vars[b]}"
            )
        elif op in (EQ_CONST, NE_CONST):
            s = "==" if op == EQ_CONST else "!="
            lines.append(f"r{dst} = code ?v{prog.code_vars[a]} {s} #{b}")
        elif op == TEST:
            t = prog.tables[a - len(prog.code_vars)]
            lines.append(f"r{dst} = {t.func}{t.args} ?v{t.var}")
        elif op in ARITH_OPS:
            lines.append(f"r{dst} = r{a} {ARITH_OPS[op]} r{b}")
        elif op in CMP_OPS:
            lines.append(f"r{dst} = r{a} {CMP_OPS[op]} r{b}")
        elif op == NOT:
            lines.append(f"r{dst} = !r{a}")
        elif op in (AND, OR):
            lines.append(f"r{dst} = r{a} {'&&' if op == AND else '||'} r{b}")
        elif op == IF:
            lines.append(f"r{dst} = if r{a} then r{b} else r{c}")
        elif op == COALESCE:
            lines.append(f"r{dst} = coalesce(r{a}, r{b})")
        else:  # pragma: no cover - exhaustive above
            lines.append(f"r{dst} = {nm} {a} {b} {c}")
    lines.append(f"ret r{prog.out_reg}  [{prog.n_regs} regs]")
    return "\n".join(lines)
