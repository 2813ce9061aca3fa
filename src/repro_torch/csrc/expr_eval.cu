// expr_eval: one bytecode-interpreting kernel for every compiled expression
// program (FILTER / BIND / join post-filters).
//
// Replaces the Pallas TPU kernel expr_eval_pallas
// (src/repro/kernels/expr_eval.py). Inputs are the program's input block:
// icols (KI, n) int32 dictionary codes and trinary predicate columns, fcols
// (KF, n) float64 numeric decodes (NaN = non-numeric or NULL). Outputs are
// the output register's float64 value and its error bit per row, with the
// semantics of the reference interpreter vm._interp on its float64 plane
// (the reference's default numpy backend): NaN and non-finite handling,
// Kleene AND/OR, IF and COALESCE over the error plane.
//
// What bounds it on the H100: bytes at large n (a few 4- or 8-byte input
// columns read, 9 bytes a row written); at the main path's 4096-row
// batches, latency: each instruction is a dependent chain of an
// instruction read, operand reads, the operation and a write.
//
// Design: the TPU kernel unrolled each program at trace time into its own
// kernel. Here one kernel interprets any program, so one build serves every
// query and no compiler runs per program.
//   * The program lives in device memory, one buffer per program uploaded
//     once by the wrapper: 8 int32 words per instruction (op, dst, a, b, c,
//     and for LOAD_CONST the float64 constant's low and high words). The
//     launch passes its address, so no instruction or constant count is
//     capped. A block stages it into shared memory, a window of win
//     instructions (the wrapper's WINDOW, 256) at a time, with one
//     coalesced read issued before the inputs' reads, so that both round
//     trips overlap: a uniform read from device memory per instruction
//     costs each SM an L2 round trip (PERF.md). Every thread
//     then reads the same instruction, a broadcast, so the dispatch never
//     diverges. The dispatch tests the opcode's class with uniform
//     branches and selects inside a class, rather than a switch, whose
//     jump table costs an indexed constant load per instruction.
//   * A thread evaluates one row. Its registers live, with its inputs, in
//     shared memory as planes [reg][thread]: a double and an error byte
//     per register, so a warp's access to one register is 32 consecutive
//     doubles (or bytes), free of bank conflicts. The planes are sized per
//     launch from the program as dynamic shared memory, opted in above
//     48 KB. A register file indexed by run-time operands in a plain array
//     would live in local memory (PERF.md: -Xptxas -v of the previous
//     kernel). Two more instances, picked by the wrapper from the
//     program's shape:
//       REGISTERS: a program of at most SHORT_INSTRS instructions and
//         SHORT_REGS registers, such as a FILTER's one comparison, travels
//         whole by value (128 bytes), so it waits for no fetch, and keeps
//         its registers in real registers; its inputs are read where an
//         instruction names them.
//       GLOBAL: a program whose planes exceed a block's 227 KB even at 32
//         threads gets register planes [reg][row] in global memory from the
//         wrapper and reads its inputs from device memory.
//   * Small blocks (THREADS in the wrapper) spread a 4096-row batch over
//     many SMs.
//   * Arithmetic uses the float64 round-to-nearest intrinsics, so no
//     multiply-add is contracted and every result equals numpy's float64
//     bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum {
  LOAD_NUM = 0, LOAD_CONST, BOUND, EQ_CODE, NE_CODE, EQ_CONST, NE_CONST, TEST,
  ADD, SUB, MUL, DIV, LT, LE, GT, GE, EQ_NUM, NE_NUM, NOT, AND, OR, IF,
  COALESCE
};
enum { REGISTERS = 0, SHARED = 1, GLOBAL = 2 };

constexpr int TRI_TRUE = 1;
constexpr int TRI_ERROR = 2;
constexpr int SHORT_INSTRS = 4;  // the REGISTERS instance's instructions (128 bytes)
constexpr int SHORT_REGS = 4;    // and registers
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory, opted in
constexpr int SMEM_DEFAULT = 48 * 1024;

// Register files: v(r) / e(r) read register r, set(r, ...) writes it.
// LocalRegs keeps them in real registers: four named values (a program of
// SHORT_INSTRS instructions writes at most that many registers), read
// through a tree of selects on r's bits and written through selects on r
// (named members, not an array, so that the compiler keeps them out of
// local memory whatever order it unrolls and promotes in), and the error
// bits as one bit mask.
struct LocalRegs {
  static_assert(SHORT_REGS == 4, "LocalRegs names four registers");
  double r0 = 0.0, r1 = 0.0, r2 = 0.0, r3 = 0.0;
  unsigned em = 0;
  __device__ __forceinline__ double v(int r) const {  // a tree of selects on r's bits
    const double x01 = r & 1 ? r1 : r0, x23 = r & 1 ? r3 : r2;
    return r & 2 ? x23 : x01;
  }
  __device__ __forceinline__ bool e(int r) const { return (em >> r) & 1u; }
  __device__ __forceinline__ void set(int r, double x, bool b) {
    r0 = r == 0 ? x : r0;
    r1 = r == 1 ? x : r1;
    r2 = r == 2 ? x : r2;
    r3 = r == 3 ? x : r3;
    em = (em & ~(1u << r)) | ((unsigned)b << r);
  }
};

template <typename Idx>
struct PlaneRegs {  // planes in shared or global memory
  double* vp;
  unsigned char* ep;
  Idx stride;
  __device__ __forceinline__ double v(int r) const { return vp[r * stride]; }
  __device__ __forceinline__ bool e(int r) const { return ep[r * stride] != 0; }
  __device__ __forceinline__ void set(int r, double x, bool b) {
    vp[r * stride] = x;
    ep[r * stride] = b;
  }
};

// Inputs: ic(r) the code column r, fc(r) the numeric column r, of the row,
// from shared-memory planes or straight from device memory.
template <typename Idx>
struct PlaneInputs {
  const int* icp;
  const double* fcp;
  Idx stride;
  __device__ __forceinline__ int ic(int r) const { return icp[r * stride]; }
  __device__ __forceinline__ double fc(int r) const { return fcp[r * stride]; }
};

// A short program, whole, by value.
struct ShortProgram {
  int4 w[2 * SHORT_INSTRS];
};

// One instruction (w0 = op, dst, a, b; w1 = c, constant low, high, -).
// Three uniform branches pick the opcode's class; inside a class every
// variant but a division is computed and the opcode selects, so the
// dependent chain of an instruction is its operand reads, one operation
// and the write.
template <class Regs, class In>
__device__ __forceinline__ void step(const int4 w0, const int4 w1, Regs& R, const In& X) {
  const int op = w0.x, a = w0.z, b = w0.w;
  double rv;
  bool re;
  if (op >= ADD) {  // register operands: ADD .. COALESCE
    const int rb = op == NOT ? a : b;  // NOT has no second operand
    const double x = R.v(a), y = R.v(rb);
    const bool ea = R.e(a), eb = R.e(rb);
    if (op <= DIV) {
      double r;
      if (op == DIV) {
        r = __ddiv_rn(x, y);
      } else {  // x - y is x + (-y), bit for bit
        const double sum = __dadd_rn(x, op == SUB ? -y : y), prod = __dmul_rn(x, y);
        r = op == MUL ? prod : sum;
      }
      const bool fin = isfinite(r);
      rv = fin ? r : 0.0;
      re = ea || eb || !fin;
    } else if (op <= NE_NUM) {
      const bool r = op == LT ? x < y : op == LE ? x <= y : op == GT ? x > y
                   : op == GE ? x >= y : op == EQ_NUM ? x == y : x != y;
      rv = r ? 1.0 : 0.0;
      re = ea || eb;
    } else {  // NOT, AND, OR, IF, COALESCE
      const bool ta = x != 0.0, tb = y != 0.0;
      const bool pa = ta && !ea, pb = tb && !eb;        // definitely true
      const bool fa = !ta && !ea, fb = !tb && !eb;      // definitely false
      double z = y;
      bool ez = eb;
      if (op == IF && !ta) {  // IF takes b when a is truthy, else c
        z = R.v(w1.x);
        ez = R.e(w1.x);
      }
      if (op == NOT) {
        rv = ta ? 0.0 : 1.0;
        re = ea;
      } else if (op == AND || op == OR) {
        const bool v = op == AND ? pa && pb : pa || pb;
        rv = v ? 1.0 : 0.0;
        re = (ea || eb) && (op == AND ? !fa && !fb : !pa && !pb);
      } else if (op == IF) {
        rv = z;
        re = ea || ez;
      } else {  // COALESCE
        rv = ea ? y : x;
        re = ea && eb;
      }
    }
  } else if (op >= BOUND) {  // the code domain: BOUND .. TEST
    const bool pair = op == EQ_CODE || op == NE_CODE || op == TEST;
    const int x = X.ic(a), yc = X.ic(pair ? b : a);  // both reads in flight together
    const int y = pair ? yc : b;
    const bool eq = x == y;
    if (op == BOUND) {
      rv = x != -1 ? 1.0 : 0.0;
      re = false;
    } else if (op == TEST) {
      rv = x == TRI_TRUE ? 1.0 : 0.0;
      re = x == TRI_ERROR || y == -1;
    } else {
      rv = (op == EQ_CODE || op == EQ_CONST) == eq ? 1.0 : 0.0;
      re = x == -1 || (pair && y == -1);
    }
  } else if (op == LOAD_CONST) {
    const double x = __hiloint2double(w1.z, w1.y);
    re = !isfinite(x);
    rv = re ? 0.0 : x;
  } else {  // LOAD_NUM
    const double x = X.fc(a);
    rv = x;
    re = isnan(x);
  }
  R.set(w0.y, rv, re);
}

// The program over one thread's row, window by window from shared memory.
// p0: this thread's word of the first window, read before the inputs were,
// so that both round trips overlap.
template <class Regs, class In>
__device__ __forceinline__ void interpret(const int4* __restrict__ instr, int n_instr, int win,
                                          int4* s_prog, int4 p0, bool active, Regs& R,
                                          const In& X) {
  const int T = blockDim.x, tid = threadIdx.x;
  for (int base = 0; base < n_instr; base += win) {
    const int cnt = min(win, n_instr - base);
    if (base == 0) {
      if (tid < 2 * cnt) s_prog[tid] = p0;
      for (int j = tid + T; j < 2 * cnt; j += T) s_prog[j] = __ldg(instr + j);
    } else {
      __syncthreads();  // every thread is done with the last window
      for (int j = tid; j < 2 * cnt; j += T) s_prog[j] = __ldg(instr + 2 * base + j);
    }
    __syncthreads();
    if (!active) continue;
    int4 w0 = s_prog[0], w1 = s_prog[1];
    for (int k = 0; k < cnt; ++k) {
      const int4 c0 = w0, c1 = w1;
      if (k + 1 < cnt) {  // the next instruction, read while this one runs
        w0 = s_prog[2 * k + 2];
        w1 = s_prog[2 * k + 3];
      }
      step(c0, c1, R, X);
    }
  }
}

// SHARED and GLOBAL: the program from device memory, staged per block.
template <int MODE>
__global__ void expr_eval_kernel(const int4* __restrict__ instr, int n_instr, int win,
                                 int n_regs, int n_ic, int n_fc, int out_reg,
                                 const int* __restrict__ icols,
                                 const double* __restrict__ fcols, long long n,
                                 double* __restrict__ val, bool* __restrict__ err,
                                 double* __restrict__ gv, unsigned char* __restrict__ ge) {
  // Shared memory: the program window [win][2], then (SHARED only) the
  // numeric inputs, the value planes, the code inputs and the error planes,
  // each [column or register][thread]; the wrapper sizes it
  // (kernels/expr_eval.py: smem_bytes).
  extern __shared__ int4 smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * T + tid;
  const bool active = i < n;
  const long long row = active ? i : 0;  // inactive threads read row 0, store nothing
  int4* s_prog = smem;                   // [win][2]
  const int4 p0 = tid < 2 * min(win, n_instr) ? __ldg(instr + tid) : make_int4(0, 0, 0, 0);
  if constexpr (MODE == SHARED) {
    double* s_fc = reinterpret_cast<double*>(s_prog + 2 * win);  // [n_fc][T]
    double* s_v = s_fc + n_fc * T;                               // [n_regs][T]
    int* s_ic = reinterpret_cast<int*>(s_v + n_regs * T);        // [n_ic][T]
    unsigned char* s_e = reinterpret_cast<unsigned char*>(s_ic + n_ic * T);  // [n_regs][T]
    for (int r = 0; r < n_ic; ++r) s_ic[r * T + tid] = icols[r * n + row];
    for (int r = 0; r < n_fc; ++r) s_fc[r * T + tid] = fcols[r * n + row];
    PlaneRegs<int> regs{s_v + tid, s_e + tid, T};
    interpret(instr, n_instr, win, s_prog, p0, active, regs,
              PlaneInputs<int>{s_ic + tid, s_fc + tid, T});
    if (active) {
      val[i] = regs.v(out_reg);
      err[i] = regs.e(out_reg);
    }
  } else {
    PlaneRegs<long long> regs{gv + row, ge + row, n};
    interpret(instr, n_instr, win, s_prog, p0, active, regs,
              PlaneInputs<long long>{icols + row, fcols + row, n});
    if (active) {
      val[i] = regs.v(out_reg);
      err[i] = regs.e(out_reg);
    }
  }
}

// REGISTERS: a program of at most SHORT_INSTRS instructions and SHORT_REGS
// registers, whole in the launch's parameters (constant indices, so it
// stays in parameter space), its registers in real registers, its inputs
// read from device memory where an instruction names them.
__global__ void expr_eval_kernel(const ShortProgram prog, int n_instr, int out_reg,
                                 const int* __restrict__ icols, const double* __restrict__ fcols,
                                 long long n, double* __restrict__ val, bool* __restrict__ err) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  LocalRegs regs;
  const PlaneInputs<long long> in{icols + i, fcols + i, n};
  static_assert(SHORT_INSTRS == 4, "the steps are written out");
  if (n_instr > 0) step(prog.w[0], prog.w[1], regs, in);
  if (n_instr > 1) step(prog.w[2], prog.w[3], regs, in);
  if (n_instr > 2) step(prog.w[4], prog.w[5], regs, in);
  if (n_instr > 3) step(prog.w[6], prog.w[7], regs, in);
  val[i] = regs.v(out_reg);
  err[i] = regs.e(out_reg);
}

}  // namespace

// prog: the program buffer, n_instr instructions of 8 int32 words (op, dst,
// a, b, c, the constant's low and high words, padding), staged win at a
// time; short_prog: the same words in a ShortProgram, read by the REGISTERS
// mode only (0; n_instr <= SHORT_INSTRS, n_regs <= SHORT_REGS; prog may
// then be null). n_ic / n_fc: the program's input columns. threads: a
// block's threads. mode: REGISTERS, SHARED (1) or GLOBAL (2, with gv / ge
// register planes of n_regs * n doubles and bytes). smem: a SHARED or
// GLOBAL block's dynamic shared memory, as the wrapper lays it out.
extern "C" int expr_eval_launch(const void* short_prog, const void* prog, int n_instr, int win,
                                int n_regs, int n_ic, int n_fc, int out_reg, const int* icols,
                                const double* fcols, long long n, double* val, bool* err,
                                int threads, int mode, long long smem, double* gv,
                                unsigned char* ge, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool fits = mode == REGISTERS ? short_prog != nullptr && n_instr <= SHORT_INSTRS &&
                                            n_regs <= SHORT_REGS
                                      : (mode == SHARED || (gv != nullptr && ge != nullptr)) &&
                                            prog != nullptr && win > 0 && smem > 0 &&
                                            smem <= SMEM_MAX;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0 || n_regs <= 0 || n_instr < 0 ||
      mode < REGISTERS || mode > GLOBAL || !fits)
    return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == REGISTERS) {
    expr_eval_kernel<<<blocks, threads, 0, st>>>(*static_cast<const ShortProgram*>(short_prog),
                                                n_instr, out_reg, icols, fcols, n, val, err);
    return (int)cudaGetLastError();
  }
  auto kernel = mode == SHARED ? expr_eval_kernel<SHARED> : expr_eval_kernel<GLOBAL>;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, (size_t)smem, st>>>(static_cast<const int4*>(prog), n_instr, win,
                                               n_regs, n_ic, n_fc, out_reg, icols, fcols, n,
                                               val, err, gv, ge);
  return (int)cudaGetLastError();
}

// The caps the wrapper plans with, checked once when the library loads.
extern "C" int expr_eval_limits(int* short_instrs, int* short_regs, int* short_bytes,
                                int* smem_max) {
  *short_instrs = SHORT_INSTRS;
  *short_regs = SHORT_REGS;
  *short_bytes = (int)sizeof(ShortProgram);
  *smem_max = SMEM_MAX;
  return 0;
}
