"""Sweep the compiled shapes of join_expand, gather_emit and expr_eval on
the card.

The port compiles two instances of join_expand and gather_emit and picks
one from the input (join_expand: a tile for small windows and one for
large; gather_emit: a short unroll for narrow plans and one to the caps).
This script compiles the candidates from the same sources into its own
library under ``build/kernel_sweep/`` — a small ``.cu`` that includes the
source and exports each instance of its ``launch`` template — checks each
instance against the plain PyTorch version, and prints its device time per
launch (``torch.profiler``, as ``chip_smoke.py`` measures). expr_eval's
instance and block size are launch arguments: every instance that takes a
program is swept through the wrapper's launch (``expr_eval._launch``,
which ``expr_eval`` calls at ``launch_shape``'s choice) at 32 to 256
threads on six
programs, at 4,096 and 2^20 rows. The script also
prints ``nvcc -Xptxas -v`` and the local-memory (LDL / STL) and
shared-memory (LDS / STS) instruction counts of ``cuobjdump -sass`` for
``expr_eval.cu``. With ``--parent DIR`` it also builds and times
``DIR/src/repro_torch/csrc/expr_eval.cu`` with its wrapper's by-value
program (an earlier commit's float32 kernel, on the programs it takes),
and reports the same compiler output for it.

    python3 kernel_sweep.py [--parent DIR] [--json OUT]

Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import expr_eval as EE  # noqa: E402
from repro_torch.kernels import gather_emit as GE  # noqa: E402
from repro_torch.kernels import join_expand as JE  # noqa: E402

OUT_DIR = ROOT / "build" / "kernel_sweep"
# (threads, tile) candidates for join_expand
JE_SHAPES = ((64, 64), (64, 256), (128, 128), (128, 256), (128, 512), (128, 1024),
             (256, 256), (256, 1024), (256, 2048), (256, 4096), (512, 1024), (512, 2048),
             (512, 4096))
# (rows, pairs) unrolls of gather_emit
GE_UNROLLS = ((8, 2), (16, 4))
COUNTS = (4096, 16384, 65536, 131072, 262144, 524288, 1 << 20)
EE_THREADS = (32, 64, 128, 256)
EE_ROWS = (4096, 1 << 20)
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _instances_source() -> str:
    lines = [f'#include "{build.CSRC / "join_expand.cu"}"']
    for t, tl in JE_SHAPES:
        lines.append(
            f"extern \"C\" int je_{t}_{tl}(const int* ls, const int* rs, const int* rl, "
            f"const long long* cum, int G, long long base, long long count, int* li, int* ri, "
            f"void* st) {{ if (count <= 0) return 0; return launch<{t}, {tl}>(ls, rs, rl, cum, "
            f"G, base, count, li, ri, (cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


def _emit_source() -> str:
    lines = [f'#include "{build.CSRC / "gather_emit.cu"}"']
    for rows, pairs in GE_UNROLLS:
        lines.append(
            f"extern \"C\" int ge_{rows}_{pairs}(const EmitPlan* plan, const int* lc, "
            f"long long ls, const int* rc, long long rs, int re, const int* li, const int* ri, "
            f"long long C, int* out, long long os, bool* mask, void* st) {{ "
            f"launch<{rows}, {pairs}>(*plan, lc, ls, rc, rs, re, li, ri, C, out, os, mask, "
            f"(cudaStream_t)st); return (int)cudaGetLastError(); }}")
    return "\n".join(lines) + "\n"


def build_libraries(parent):
    """Compile the instance libraries (and the parent's kernel), one nvcc
    each, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {"je": _instances_source(), "ge": _emit_source()}
    srcs = {}
    for name, text in jobs.items():
        srcs[name] = OUT_DIR / f"{name}_sweep.cu"
        srcs[name].write_text(text)
    if parent is not None:
        srcs["parent_ee"] = Path(parent) / "src" / "repro_torch" / "csrc" / "expr_eval.cu"
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-shared", str(src), "-o", str(OUT_DIR / f"{name}.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in srcs.items()}
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    for t, tl in JE_SHAPES:
        getattr(libs["je"], f"je_{t}_{tl}").argtypes = [P, P, P, P, I, L, L, P, P, P]
    for rows, pairs in GE_UNROLLS:
        getattr(libs["ge"], f"ge_{rows}_{pairs}").argtypes = [P, P, L, P, L, I, P, P, L, P, L,
                                                              P, P]
    if "parent_ee" in libs:
        libs["parent_ee"].expr_eval_launch.argtypes = [P, P, P, L, P, P, P]
    return libs


def compiler_report(parent):
    """expr_eval.cu's (and the parent's) ``-Xptxas -v`` lines and SASS
    counts of local (LDL / STL) and shared (LDS / STS) loads and stores."""
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    srcs = {"this tree": build.CSRC / "expr_eval.cu"}
    if parent is not None:
        srcs["parent"] = Path(parent) / "src" / "repro_torch" / "csrc" / "expr_eval.cu"
    out = {}
    for name, src in srcs.items():
        obj = OUT_DIR / f"ee_{name.replace(' ', '_')}.o"
        cc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                             str(obj)], capture_output=True, text=True, check=True)
        sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                              check=True).stdout
        ops = [next((w for w in ln.split()[1:] if not w.startswith("@")), "").split(".")[0]
               for ln in sass.splitlines() if ln.strip().startswith("/*")]
        out[name] = {"ptxas": [ln for ln in cc.stderr.splitlines() if "ptxas" in ln],
                     "sass": {op: sum(1 for o in ops if o == op)
                              for op in ("LDL", "STL", "LDS", "STS", "LDG")}}
        CS.log(f"expr_eval.cu ({name}): {json.dumps(out[name])}")
    return out


def _expand_fn(libs, which, args, base, count):
    ls, ll, rs, rl, cum = args
    li = torch.empty(count, dtype=torch.int32, device=ls.device)
    ri = torch.empty_like(li)
    st = build.stream_handle(li)
    g = int(ls.shape[0])
    f = getattr(libs["je"], f"je_{which[0]}_{which[1]}")

    def run():
        build.check(f(ls.data_ptr(), rs.data_ptr(), rl.data_ptr(), cum.data_ptr(), g,
                      base, count, li.data_ptr(), ri.data_ptr(), st), "join_expand")
        return li, ri
    return run


def sweep_join_expand(libs, rng, dev):
    q6 = CS._groups(rng, 40000, 4, 8, dev)
    wide = CS._groups(rng, 400_000, 4, 8, dev)  # about 4.5M slots: every window valid
    one = CS._group_tensors(np.asarray([8]), np.asarray([1 << 17]), dev)
    windows = [("4096 slots over 40,000 groups", q6, int(q6[4][-1]) // 2, 4096)]
    windows += [(f"{c} slots over 400,000 groups", wide, 0, c) for c in COUNTS[1:]]
    windows.append(("one group of 2^20 slots", one, 0, 1 << 20))
    variants = [(f"{t}x{tl}", (t, tl)) for t, tl in JE_SHAPES]
    res = {}
    for label, args, base, count in windows:
        want = JE.join_expand_plain(*args, base, count)
        row = {}
        for name, which in variants:
            fn = _expand_fn(libs, which, args, base, count)
            li, ri = fn()
            CS.require(torch.equal(li, want[0]) and torch.equal(ri, want[1]),
                       f"join_expand {name} disagrees with the plain version ({label})")
            tl = which[1]
            got = JE.join_expand_plain(*args, base, count, tile=tl)
            CS.require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                       f"join_expand_plain at tile {tl} disagrees ({label})")
            row[name] = CS.device_ms(fn, 200, kernel="join_expand")
        row["wrapper"] = CS.device_ms(lambda: JE.join_expand(*args, base, count), 200,
                                      kernel="join_expand")
        res[label] = row
        CS.log(f"join_expand {label}: {json.dumps(row)}")
    return res


def sweep_gather_emit(libs, rng, dev):
    nsrc, c = 1_000_000, 4096
    lcols = torch.from_numpy(rng.randint(0, 4, (3, nsrc)).astype(np.int32)).to(dev)
    rcols = torch.from_numpy(rng.randint(0, 4, (3, nsrc)).astype(np.int32)).to(dev)
    groups = CS._groups(rng, 40000, 4, 8, dev)
    jli, jri = JE.join_expand(*groups, int(groups[4][-1]) // 2, c)
    rli = torch.from_numpy(rng.randint(0, nsrc, c).astype(np.int32)).to(dev)
    rri = torch.from_numpy(np.where(rng.rand(c) < 0.1, -1, rng.randint(0, nsrc, c))
                           .astype(np.int32)).to(dev)
    bli = torch.from_numpy(rng.randint(0, nsrc, 1 << 20).astype(np.int32)).to(dev)
    bri = torch.from_numpy(rng.randint(-1, nsrc, 1 << 20).astype(np.int32)).to(dev)
    plan = GE.EmitPlan((0, 1, 2), (1, 2), ((0, 0),))
    res = {}
    for label, li, ri in (("join-shaped, 4096 slots", jli, jri),
                          ("random, 4096 slots", rli, rri), ("random, 2^20 slots", bli, bri)):
        want = GE.gather_emit_plain(lcols, rcols, li, ri, plan)
        n = int(li.shape[0])
        row = {}
        for rows, pairs in GE_UNROLLS:
            f = getattr(libs["ge"], f"ge_{rows}_{pairs}")
            out = torch.empty((plan.n_rows, n), dtype=torch.int32, device=dev)
            mask = torch.empty(n, dtype=torch.bool, device=dev)
            st = build.stream_handle(li)

            def run(f=f, out=out, mask=mask, st=st):
                build.check(f(plan.chunks[0][2], lcols.data_ptr(), lcols.stride(0),
                              rcols.data_ptr(), rcols.stride(0), 0, li.data_ptr(),
                              ri.data_ptr(), n, out.data_ptr(), out.stride(0),
                              mask.data_ptr(), st), "gather_emit")

            run()
            CS.require(torch.equal(out, want[0]) and torch.equal(mask, want[1]),
                       f"gather_emit {rows}x{pairs} disagrees with the plain version ({label})")
            row[f"unroll {rows} rows, {pairs} pairs"] = CS.device_ms(run, 200,
                                                                   kernel="gather_emit")
        res[label] = row
        CS.log(f"gather_emit {label}: {json.dumps(row)}")
    return res


def _load_parent_expr_eval(parent):
    """The parent's expr_eval wrapper module, for its by-value program."""
    import importlib.util

    path = Path(parent) / "src" / "repro_torch" / "kernels" / "expr_eval.py"
    spec = importlib.util.spec_from_file_location("parent_expr_eval", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_expr_eval(libs, rng, dev, parent):
    """Each program at each block size and row count through the wrapper,
    against the plain version bit for bit; the parent's float32 kernel on
    the programs within its caps, on the same inputs rounded to float32."""
    prog23, d = CS.all_opcode_program()
    progs = {"23-opcode program": prog23, "q6 FILTER": CS.q6_filter_program(d),
             "BIND(?x * 3)": CS.times3_program(d), "70-term BIND": CS.bind70_program(d),
             "100 registers": CS.many_register_program(100),
             "300 registers": CS.many_register_program(300)}
    pmod = _load_parent_expr_eval(parent) if parent is not None else None
    res = {}
    for n in EE_ROWS:
        for label, prog in progs.items():
            ic = torch.from_numpy(rng.randint(-1, 21, (max(prog.n_icols, 1), n))
                                  .astype(np.int32)).to(dev)
            fc = torch.from_numpy(rng.choice(CS.NOT_F32, (max(prog.n_fcols, 1), n))).to(dev)
            want_v, want_e = EE.expr_eval_plain(prog, ic, fc)
            row = {}
            for inst in EE.INSTANCES:
                for t in EE_THREADS:
                    if not EE.fits(prog, t, inst) or (inst == "global" and t != EE.THREADS):
                        continue
                    fn = lambda t=t, inst=inst: EE._launch(  # noqa: E731
                        prog, ic, fc, t, inst)
                    v, e = fn()
                    CS.require(torch.equal(v.view(torch.int64), want_v.view(torch.int64))
                               and torch.equal(e, want_e),
                               f"expr_eval {inst} at {t} threads disagrees ({label}, n={n})")
                    row[f"{inst}, {t} threads"] = CS.device_ms(fn, 200, kernel="expr_eval")
            if pmod is not None and len(prog.instrs) <= pmod.MAX_INSTR \
                    and prog.n_regs <= pmod.MAX_REGS and len(prog.consts) <= pmod.MAX_CONSTS:
                s = pmod._prog_struct(prog)
                f32 = fc.to(torch.float32)
                val = torch.empty(n, dtype=torch.float32, device=dev)
                err = torch.empty(n, dtype=torch.bool, device=dev)
                f = libs["parent_ee"].expr_eval_launch

                def run(s=s, f32=f32, val=val, err=err, f=f, ic=ic):
                    build.check(f(ctypes.addressof(s), ic.data_ptr(), f32.data_ptr(), n,
                                  val.data_ptr(), err.data_ptr(), build.stream_handle(val)),
                                "parent expr_eval")

                run()
                CS.require(torch.equal(err, want_e) or prog.n_fcols > 0,
                           f"parent expr_eval's error plane differs ({label})")
                row["parent (float32, 256 threads)"] = CS.device_ms(run, 200,
                                                                   kernel="expr_eval")
            res[f"{label}, n={n}"] = row
            CS.log(f"expr_eval {label}, n={n}: {json.dumps(row)}")
    # q6's FILTER on inputs the L2 cache does not hold, as a query's batches
    # arrive: a 64 MB write between launches evicts them (not timed)
    prog, n = progs["q6 FILTER"], EE_ROWS[0]
    flush = torch.empty(1 << 23, dtype=torch.float64, device=dev)
    ic = torch.from_numpy(rng.randint(-1, 3000, (prog.n_icols, n)).astype(np.int32)).to(dev)
    fc = torch.full((1, n), float("nan"), dtype=torch.float64, device=dev)
    row = {"registers, wrapper": CS.device_ms(
        lambda: (flush.zero_(), EE.expr_eval(prog, ic, fc)), 200, kernel="expr_eval")}
    if pmod is not None:
        s, f32 = pmod._prog_struct(prog), fc.to(torch.float32)
        val = torch.empty(n, dtype=torch.float32, device=dev)
        err = torch.empty(n, dtype=torch.bool, device=dev)
        f = libs["parent_ee"].expr_eval_launch
        row["parent (float32, 256 threads)"] = CS.device_ms(
            lambda: (flush.zero_(), build.check(f(
                ctypes.addressof(s), ic.data_ptr(), f32.data_ptr(), n, val.data_ptr(),
                err.data_ptr(), build.stream_handle(val)), "parent expr_eval")), 200,
            kernel="expr_eval")
    res[f"q6 FILTER, n={n}, inputs out of L2"] = row
    CS.log(f"expr_eval q6 FILTER, n={n}, inputs out of L2: {json.dumps(row)}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="root of an earlier checkout whose expr_eval.cu is timed beside")
    ap.add_argument("--json", default=None, help="write the results here")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(card, flush=True)
    libs = build_libraries(args.parent)
    rng = np.random.RandomState(args.seed)
    res = {"card": card, "expr_eval.cu": compiler_report(args.parent),
           "expr_eval": sweep_expr_eval(libs, rng, dev, args.parent),
           "join_expand": sweep_join_expand(libs, rng, dev),
           "gather_emit": sweep_gather_emit(libs, rng, dev)}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
