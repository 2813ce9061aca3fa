// expr_eval: one bytecode-interpreting kernel for every compiled expression
// program (FILTER / BIND / join post-filters).
//
// Replaces the Pallas TPU kernel expr_eval_pallas
// (src/repro/kernels/expr_eval.py). Inputs are the program's input block:
// icols (KI, n) int32 dictionary codes and trinary predicate columns, fcols
// (KF, n) float32 numeric decodes (NaN = non-numeric or NULL). Outputs are
// the output register's float32 value and its error bit per row, with the
// semantics of the reference interpreter vm._interp: NaN and non-finite
// handling, Kleene AND/OR, IF and COALESCE over the error plane.
//
// What bounds it on the H100: bytes. A program reads a few input columns
// and writes 5 bytes per row; the handful of float operations per row are
// far below the card's arithmetic rate. At 4096-row batches the launch
// dominates.
//
// Design: the TPU kernel unrolled each program at trace time into its own
// kernel. Here one kernel interprets any program: the instructions and
// constants travel as a by-value kernel parameter (well under the 4 KB
// limit), each thread evaluates one row with its register file in
// fixed-size local arrays, and because every thread of a warp executes the
// same instruction stream the opcode switch never diverges. One build
// serves every query; no compiler runs per program. Arithmetic uses the
// round-to-nearest intrinsics so no multiply-add is contracted, which keeps
// the float32 results identical to the reference's float32 plane.

#include <cuda_runtime.h>
#include <math.h>

#define EXPR_MAX_INSTR 96
#define EXPR_MAX_CONSTS 64
#define EXPR_MAX_REGS 48

struct ExprProg {
  int n_instr;
  int n_regs;
  int out_reg;
  int n_consts;
  int instr[EXPR_MAX_INSTR * 5];
  float consts[EXPR_MAX_CONSTS];
  unsigned char const_err[EXPR_MAX_CONSTS];
};

namespace {

enum {
  LOAD_NUM = 0, LOAD_CONST, BOUND, EQ_CODE, NE_CODE, EQ_CONST, NE_CONST, TEST,
  ADD, SUB, MUL, DIV, LT, LE, GT, GE, EQ_NUM, NE_NUM, NOT, AND, OR, IF,
  COALESCE
};

constexpr int TRI_TRUE = 1;
constexpr int TRI_ERROR = 2;

__global__ void expr_eval_kernel(const ExprProg prog,
                                 const int* __restrict__ icols,
                                 const float* __restrict__ fcols, long long n,
                                 float* __restrict__ val,
                                 bool* __restrict__ err) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[EXPR_MAX_REGS];
  bool e[EXPR_MAX_REGS];
  for (int k = 0; k < prog.n_instr; ++k) {
    const int op = prog.instr[5 * k];
    const int dst = prog.instr[5 * k + 1];
    const int a = prog.instr[5 * k + 2];
    const int b = prog.instr[5 * k + 3];
    const int c = prog.instr[5 * k + 4];
    switch (op) {
      case LOAD_NUM: {
        const float x = fcols[a * n + i];
        v[dst] = x;
        e[dst] = isnan(x);
        break;
      }
      case LOAD_CONST: {
        const float x = prog.consts[a];
        v[dst] = isfinite(x) ? x : 0.0f;
        e[dst] = prog.const_err[a] != 0;
        break;
      }
      case BOUND:
        v[dst] = icols[a * n + i] != -1 ? 1.0f : 0.0f;
        e[dst] = false;
        break;
      case EQ_CODE:
      case NE_CODE: {
        const int x = icols[a * n + i];
        const int y = icols[b * n + i];
        const bool eq = x == y;
        v[dst] = (op == EQ_CODE ? eq : !eq) ? 1.0f : 0.0f;
        e[dst] = x == -1 || y == -1;
        break;
      }
      case EQ_CONST:
      case NE_CONST: {
        const int x = icols[a * n + i];
        const bool eq = x == b;
        v[dst] = (op == EQ_CONST ? eq : !eq) ? 1.0f : 0.0f;
        e[dst] = x == -1;
        break;
      }
      case TEST: {
        const int tri = icols[a * n + i];
        v[dst] = tri == TRI_TRUE ? 1.0f : 0.0f;
        e[dst] = tri == TRI_ERROR || icols[b * n + i] == -1;
        break;
      }
      case ADD:
      case SUB:
      case MUL:
      case DIV: {
        const float x = v[a];
        const float y = v[b];
        float r;
        if (op == ADD) {
          r = __fadd_rn(x, y);
        } else if (op == SUB) {
          r = __fsub_rn(x, y);
        } else if (op == MUL) {
          r = __fmul_rn(x, y);
        } else {
          r = __fdiv_rn(x, y);
        }
        const bool fin = isfinite(r);
        v[dst] = fin ? r : 0.0f;
        e[dst] = e[a] || e[b] || !fin;
        break;
      }
      case LT:
      case LE:
      case GT:
      case GE:
      case EQ_NUM:
      case NE_NUM: {
        const float x = v[a];
        const float y = v[b];
        bool r;
        if (op == LT) {
          r = x < y;
        } else if (op == LE) {
          r = x <= y;
        } else if (op == GT) {
          r = x > y;
        } else if (op == GE) {
          r = x >= y;
        } else if (op == EQ_NUM) {
          r = x == y;
        } else {
          r = x != y;
        }
        v[dst] = r ? 1.0f : 0.0f;
        e[dst] = e[a] || e[b];
        break;
      }
      case NOT:
        v[dst] = v[a] != 0.0f ? 0.0f : 1.0f;
        e[dst] = e[a];
        break;
      case AND: {
        const bool ta = v[a] != 0.0f, tb = v[b] != 0.0f;
        const bool ea = e[a], eb = e[b];
        const bool fa = !ta && !ea, fb = !tb && !eb;
        v[dst] = (ta && tb && !ea && !eb) ? 1.0f : 0.0f;
        e[dst] = (ea || eb) && !fa && !fb;
        break;
      }
      case OR: {
        const bool ea = e[a], eb = e[b];
        const bool ta = v[a] != 0.0f && !ea, tb = v[b] != 0.0f && !eb;
        v[dst] = (ta || tb) ? 1.0f : 0.0f;
        e[dst] = (ea || eb) && !ta && !tb;
        break;
      }
      case IF: {
        const bool take = v[a] != 0.0f;
        const bool ea = e[a];
        v[dst] = take ? v[b] : v[c];
        e[dst] = ea || (take ? e[b] : e[c]);
        break;
      }
      case COALESCE: {
        const bool ea = e[a];
        v[dst] = ea ? v[b] : v[a];
        e[dst] = ea && e[b];
        break;
      }
      default:
        break;
    }
  }
  val[i] = v[prog.out_reg];
  err[i] = e[prog.out_reg];
}

}  // namespace

extern "C" int expr_eval_launch(const ExprProg* prog, const int* icols,
                                const float* fcols, long long n, float* val,
                                bool* err, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  expr_eval_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      *prog, icols, fcols, n, val, err);
  return (int)cudaGetLastError();
}

extern "C" int expr_eval_limits(int* max_instr, int* max_consts,
                                int* max_regs, int* prog_bytes) {
  *max_instr = EXPR_MAX_INSTR;
  *max_consts = EXPR_MAX_CONSTS;
  *max_regs = EXPR_MAX_REGS;
  *prog_bytes = (int)sizeof(ExprProg);
  return 0;
}
