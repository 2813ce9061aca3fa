"""Sweep the compiled shapes of join_expand, gather_emit, expr_eval,
hash_probe and frontier_dedup on the card.

The port compiles one or two instances of join_expand, gather_emit,
hash_probe and frontier_dedup and picks one from the input (join_expand:
a tile for small windows and one for large; gather_emit: a short unroll
for narrow plans and one to the caps; hash_probe: one group size;
frontier_dedup: a small tile whose windows are searched and a large one
that stages them). This script compiles the candidates from the same
sources into its own libraries under ``build/kernel_sweep/`` — a small
``.cu`` for each that includes the source and exports each instance of its
``launch`` template — checks each instance against the plain PyTorch
version, and prints its device time per launch (``torch.profiler``, as
``chip_smoke.py`` measures). expr_eval's instance and block size are
launch arguments: every instance that takes a program is swept through the
wrapper's launch (``expr_eval._launch``, which ``expr_eval`` calls at
``launch_shape``'s choice) at 32 to 256 threads on six programs, at 4,096
and 2^20 rows. hash_probe's group size G (8, 16, 32 lanes a key) is swept
at 4,096, 65,536 and 2^20 keys over the 3,891,273-row build in 1,024
partitions, in one partition, and over a build whose keys repeat 1,000
times; frontier_dedup's tile T (threads times candidates a thread, 256 to
4,096) and shared-memory chunk S (none, or 1,024 to 16,384 visited pairs)
at 4,096 to 2^20 candidates against an empty visited set, one of about
480,000 pairs half inside the candidates' range, and one of 4,000,000
pairs dense in it (so a tile's window passes S). Then frontier_dedup's
launches in ``chip_smoke.py``'s paths phase (p1-p5 on the full-size LSQB
store) are recorded and replayed one by one at each compiled shape, with
their sizes and the visited pairs inside the candidates' range. Every
instance is checked against the plain version before it is timed. The
script also prints ``nvcc -Xptxas -v`` and the local-memory (LDL / STL)
and shared-memory (LDS / STS) instruction counts of ``cuobjdump -sass``
for ``expr_eval.cu``, ``hash_probe.cu`` and ``frontier_dedup.cu``.

With ``--parent DIR`` (an earlier checkout) it also builds and times that
checkout's one-thread-per-key ``hash_probe.cu`` and one-thread-per-
candidate ``frontier_dedup.cu`` on the same inputs, and, where that
checkout's ``expr_eval`` takes its program by value (the float32 kernel),
its ``expr_eval.cu`` on the programs it takes; and it reports the same
compiler output for the parent's sources.

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
from repro_torch.kernels import frontier_dedup as FD  # noqa: E402
from repro_torch.kernels import gather_emit as GE  # noqa: E402
from repro_torch.kernels import hash_join as HJ  # noqa: E402
from repro_torch.kernels import join_expand as JE  # noqa: E402

OUT_DIR = ROOT / "build" / "kernel_sweep"
# (threads, tile) candidates for join_expand
JE_SHAPES = ((64, 64), (64, 256), (128, 128), (128, 256), (128, 512), (128, 1024),
             (256, 256), (256, 1024), (256, 2048), (256, 4096), (512, 1024), (512, 2048),
             (512, 4096))
# (rows, pairs) unrolls of gather_emit
GE_UNROLLS = ((8, 2), (16, 4))
COUNTS = (4096, 16384, 65536, 131072, 262144, 524288, 1 << 20)
HP_KEYS = (4096, 65536, 1 << 20)  # hash_probe batch sizes
HP_GROUPS = (8, 16, 32)  # hash_probe's lanes a key
FD_CANDIDATES = (1 << 20, 524288, 262144, 65536, 4096)
FD_TILES = ((64, 4), (128, 4), (256, 4), (256, 8), (256, 16))  # (threads, candidates a thread)
FD_CHUNKS = (0, 1024, 4096, 16384)  # frontier_dedup's S in visited pairs (0: searched)
REPLAY_ITERS = 20  # launches timed for each recorded paths-phase launch
# an earlier commit's kernels timed beside this tree's with --parent
PARENT_SOURCES = {"parent_ee": "expr_eval.cu", "parent_hp": "hash_probe.cu",
                  "parent_fd": "frontier_dedup.cu"}
REPORTED = ("expr_eval.cu", "hash_probe.cu", "frontier_dedup.cu")  # compiler_report's sources
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


def _probe_source() -> str:
    lines = [f'#include "{build.CSRC / "hash_probe.cu"}"']
    for g in HP_GROUPS:
        lines.append(
            f"extern \"C\" int hp_{g}(const int* ps, int np, const int* shi, const int* slo, "
            f"const int* qhi, const int* qlo, int c, int* lo, int* hi, void* st) {{ "
            f"if (c <= 0) return 0; return launch<{g}>(ps, np, shi, slo, qhi, qlo, c, lo, hi, "
            f"(cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


def _dedup_source() -> str:
    lines = [f'#include "{build.CSRC / "frontier_dedup.cu"}"']
    for t, it in FD_TILES:
        lines.append(
            f"extern \"C\" int fd_{t}_{it}(const int* hi, const int* lo, long long c, "
            f"const int* vhi, const int* vlo, int v, int smem, unsigned char* mask, void* st) {{ "
            f"if (c <= 0) return 0; return launch<{t}, {it}>(hi, lo, c, vhi, vlo, v, smem, mask, "
            f"(cudaStream_t)st); }}")
    return "\n".join(lines) + "\n"


def build_libraries(parent):
    """Compile the instance libraries (and the parent's kernel), one nvcc
    each, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {"je": _instances_source(), "ge": _emit_source(), "hp": _probe_source(),
            "fd": _dedup_source()}
    srcs = {}
    for name, text in jobs.items():
        srcs[name] = OUT_DIR / f"{name}_sweep.cu"
        srcs[name].write_text(text)
    if parent is not None:
        for name, src in PARENT_SOURCES.items():
            if name != "parent_ee" or _parent_by_value(parent):
                srcs[name] = Path(parent) / "src" / "repro_torch" / "csrc" / src
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
    for g in HP_GROUPS:
        getattr(libs["hp"], f"hp_{g}").argtypes = [P, I, P, P, P, P, I, P, P, P]
    for t, it in FD_TILES:
        getattr(libs["fd"], f"fd_{t}_{it}").argtypes = [P, P, L, P, P, I, I, P, P]
    if "parent_ee" in libs:
        libs["parent_ee"].expr_eval_launch.argtypes = [P, P, P, L, P, P, P]
    if parent is not None:
        # one thread per key / candidate, no shape arguments
        libs["parent_hp"].hash_probe_launch.argtypes = [P, I, P, P, P, P, I, P, P, P]
        libs["parent_fd"].frontier_dedup_launch.argtypes = [P, P, L, P, P, I, P, P]
    return libs


def _parent_by_value(parent) -> bool:
    """Whether the parent's expr_eval takes its program by value (the
    float32 kernel this tree's replaced); a later one is this tree's own."""
    path = Path(parent) / "src" / "repro_torch" / "kernels" / "expr_eval.py"
    return "def _prog_struct(" in path.read_text()


def compiler_report(parent):
    """``-Xptxas -v`` lines and SASS counts of local (LDL / STL) and shared
    (LDS / STS) loads and stores of REPORTED's sources, this tree's and the
    parent's."""
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    roots = {"this tree": build.CSRC}
    if parent is not None:
        roots["parent"] = Path(parent) / "src" / "repro_torch" / "csrc"
    out = {}
    for src_name in REPORTED:
        for name, root in roots.items():
            obj = OUT_DIR / f"{Path(src_name).stem}_{name.replace(' ', '_')}.o"
            cc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                 str(root / src_name), "-o", str(obj)],
                                capture_output=True, text=True, check=True)
            sass = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                                  text=True, check=True).stdout
            ops = [next((w for w in ln.split()[1:] if not w.startswith("@")), "").split(".")[0]
                   for ln in sass.splitlines() if ln.strip().startswith("/*")]
            key = f"{src_name} ({name})"
            out[key] = {"ptxas": [ln for ln in cc.stderr.splitlines() if "ptxas" in ln],
                        "sass": {op: sum(1 for o in ops if o == op)
                                 for op in ("LDL", "STL", "LDS", "STS", "LDG")}}
            CS.log(f"{key}: {json.dumps(out[key])}")
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
    pmod = _load_parent_expr_eval(parent) if "parent_ee" in libs else None
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


def _probe_build(rng, dev, label):
    """The 3,891,273-row build of chip_smoke's hash_probe check, laid out in
    1,024 partitions or in one, or a build whose keys repeat 1,000 times;
    and its key domain."""
    n = 3_891_273
    if label.startswith("keys repeated"):
        keys = np.repeat(np.arange(n // 1000 + 1, dtype=np.int32) * 3, 1000)[:n]
        return CS._layout(None, torch.from_numpy(keys).to(dev), 1024), keys, int(keys[-1]) + 1
    keys = rng.randint(0, 500_000, n).astype(np.int32)
    p = 1 if label.endswith("P=1") else 1024
    return CS._layout(None, torch.from_numpy(keys).to(dev), p), keys, 500_000


def sweep_hash_probe(libs, rng, dev):
    """Each group size G at each batch size on three builds, and the
    parent's kernel, each checked against the plain version first."""
    res = {}
    for blabel in ("3,891,273 rows, P=1024", "3,891,273 rows, P=1",
                   "keys repeated 1,000 times, P=1024"):
        (starts, _, skl), keys, dom = _probe_build(rng, dev, blabel)
        n_parts = int(starts.shape[0]) - 1
        for c in HP_KEYS:
            q = torch.from_numpy(np.concatenate([
                keys[rng.randint(0, len(keys), c // 2)],
                rng.randint(dom, 2 * dom, c - c // 2)]).astype(np.int32)).to(dev)
            want = HJ.hash_probe_plain(starts, None, skl, None, q)
            lo = torch.empty_like(q)
            hi = torch.empty_like(q)
            st = build.stream_handle(q)
            fns = {f"G={g}": (lambda f=getattr(libs["hp"], f"hp_{g}"): build.check(f(
                starts.data_ptr(), n_parts, None, skl.data_ptr(), None, q.data_ptr(), c,
                lo.data_ptr(), hi.data_ptr(), st), "hash_probe")) for g in HP_GROUPS}
            if "parent_hp" in libs:
                f = libs["parent_hp"].hash_probe_launch
                fns["parent"] = lambda f=f: build.check(f(
                    starts.data_ptr(), n_parts, None, skl.data_ptr(), None, q.data_ptr(), c,
                    lo.data_ptr(), hi.data_ptr(), st), "parent hash_probe")
            row = {}
            for name, fn in fns.items():
                lo.fill_(-7)
                hi.fill_(-7)
                fn()
                CS.require(torch.equal(lo, want[0]) and torch.equal(hi, want[1]),
                           f"hash_probe {name} disagrees with the plain version ({blabel}, {c})")
                row[name] = CS.device_ms(fn, 200, kernel="hash_probe")
            row["wrapper"] = CS.device_ms(lambda: HJ.hash_probe(starts, None, skl, None, q),
                                          200, kernel="hash_probe")
            res[f"{blabel}, {c} keys"] = row
            CS.log(f"hash_probe {blabel}, {c} keys: {json.dumps(row)}")
    return res


def sweep_frontier_dedup(libs, rng, dev):
    """Each compiled tile (threads x candidates a thread) and chunk S (or
    none, so that every window is searched) at 4,096 to 2^20 candidates
    against an empty visited set, one about half inside the candidates'
    range and one of 4,000,000 pairs dense in it (so windows pass S), and
    the parent's kernel, each checked against the plain version first."""
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    res = {}
    for c in FD_CANDIDATES:
        ch, cl = CS._sorted_pairs(rng.randint(0, 64, c), rng.randint(0, 70_000, c))
        cand = (torch.from_numpy(ch).to(dev), torch.from_numpy(cl).to(dev))
        ckey = np.unique(ch.astype(np.int64) << 32 | cl)
        others = np.unique(rng.randint(64, 128, 960_000).astype(np.int64) << 32
                           | rng.randint(0, 70_000, 960_000))
        v480 = np.sort(np.concatenate([rng.choice(ckey, min(240_000, len(ckey) // 2),
                                                  replace=False),
                                       rng.choice(others, 240_000, replace=False)]))
        vsets = {"empty visited": (none, none),
                 "visited, half in the candidates' range":
                     (torch.from_numpy((v480 >> 32).astype(np.int32)).to(dev),
                      torch.from_numpy((v480 & 0xFFFFFFFF).astype(np.int32)).to(dev)),
                 "visited dense in the candidates' range": CS.dense_visited(dev, 64, 62_500)}
        for vkind, (vh, vl) in vsets.items():
            v = int(vh.shape[0])
            vlabel = f"{vkind}, {v} pairs" if v else vkind
            want = FD.frontier_dedup_plain(*cand, vh, vl)
            mask = torch.empty(c, dtype=torch.bool, device=dev)
            st = build.stream_handle(mask)
            shapes = [(tile, 0) for tile in FD_TILES] if v == 0 else \
                [(tile, s) for tile in FD_TILES for s in FD_CHUNKS]
            fns = {}
            for (th, it), chunk in shapes:
                name = f"T={th * it} ({th}x{it})" + (f", S={chunk}" if chunk else
                                                     ", no chunk" if v else "")
                fns[name] = _dedup_fn(libs, (th, it), chunk, cand, (vh, vl), mask)
            if "parent_fd" in libs:
                f = libs["parent_fd"].frontier_dedup_launch
                fns["parent"] = lambda f=f: build.check(f(
                    cand[0].data_ptr(), cand[1].data_ptr(), c, vh.data_ptr(), vl.data_ptr(), v,
                    mask.data_ptr(), st), "parent frontier_dedup")
            row = {}
            for name, fn in fns.items():
                mask.fill_(True)
                fn()
                CS.require(torch.equal(mask, want), f"frontier_dedup {name} disagrees with the "
                                                    f"plain version ({c}, {vlabel})")
                row[name] = CS.device_ms(fn, 200, kernel="frontier_dedup")
            row["wrapper"] = CS.device_ms(lambda: FD.frontier_dedup(*cand, vh, vl), 200,
                                          kernel="frontier_dedup")
            res[f"{c} candidates, {vlabel}"] = row
            CS.log(f"frontier_dedup {c} candidates, {vlabel}: {json.dumps(row)}")
    return res


def _dedup_fn(libs, tile, chunk, cand, vis, mask):
    """One launch of the swept frontier_dedup instance ``tile`` staging
    ``chunk`` visited pairs (0: every window searched)."""
    f = getattr(libs["fd"], f"fd_{tile[0]}_{tile[1]}")
    c, v = int(cand[0].shape[0]), int(vis[0].shape[0])
    smem = FD.smem_bytes(chunk) if chunk else 0
    st = build.stream_handle(mask)
    return lambda: build.check(f(cand[0].data_ptr(), cand[1].data_ptr(), c, vis[0].data_ptr(),
                                 vis[1].data_ptr(), v, smem, mask.data_ptr(), st),
                               "frontier_dedup")


def record_paths_dedup(dev):
    """The inputs of every frontier_dedup launch of chip_smoke's paths phase
    (p1-p5 on the full-size LSQB store under EngineConfig()): per query, a
    list of (candidates, visited, the candidate columns' 16-byte phases),
    each tensor a copy."""
    import repro_torch
    from repro_torch.core.paths import engine as PE

    store = CS.load_full_store(dev, CS.FULL_SCALE, CS.SEED, {})
    engine = repro_torch.Engine(store, CS._config((None, None)), device=dev)
    calls, real = {}, PE.frontier_dedup

    def recording(ch, cl, vh, vl):
        phase = tuple((x.data_ptr() >> 2) & 3 for x in (ch, cl))
        calls[name].append(((ch.clone(), cl.clone()), (vh.clone(), vl.clone()), phase))
        return real(ch, cl, vh, vl)

    PE.frontier_dedup = recording
    try:
        for name, text in CS.PATH_QUERIES.items():
            calls[name] = []
            CS.run_query(engine, text)
    finally:
        PE.frontier_dedup = real
    del engine, store
    return calls


def _in_range(cand, vis):
    """The visited pairs between the first candidate and the last."""
    from repro_torch.core import vecops

    if int(vis[0].shape[0]) == 0:
        return 0
    kc = vecops._pair_comp(cand[0][[0, -1]], cand[1][[0, -1]])
    kv = vecops._pair_comp(*vis)
    lo = torch.searchsorted(kv, kc[:1])
    hi = torch.searchsorted(kv, kc[1:], right=True)
    return int(hi - lo)


def replay_paths_dedup(libs, dev):
    """Each recorded paths-phase launch replayed alone, its candidate
    columns at their recorded 16-byte phases: its sizes, the visited pairs
    inside the candidates' range, launch_shape's choice, and the device ms
    of this tree's wrapper, of the small tile searching every window, of
    the large tile staging CHUNK pairs (or, with no visited set, the large
    tile), and of the parent's kernel, each checked against the plain
    version first. Per query, the sums over its launches."""
    calls = record_paths_dedup(dev)
    res = {}
    for name, launches in calls.items():
        if not launches:
            continue
        rows = []
        for (ch, cl), vis, phase in launches:
            cand = (CS._at_offset(ch, phase[0]), CS._at_offset(cl, phase[1]))
            c, v = int(ch.shape[0]), int(vis[0].shape[0])
            want = FD.frontier_dedup_plain(*cand, *vis)
            mask = torch.empty(c, dtype=torch.bool, device=dev)
            fns = {"wrapper": lambda cand=cand, vis=vis: FD.frontier_dedup(*cand, *vis),
                   "small tile, searched": _dedup_fn(libs, FD.SMALL_TILE, 0, cand, vis, mask),
                   "large tile" + (f", S={FD.CHUNK}" if v else ""): _dedup_fn(
                       libs, FD.LARGE_TILE, FD.CHUNK if v else 0, cand, vis, mask)}
            if "parent_fd" in libs:
                f = libs["parent_fd"].frontier_dedup_launch
                fns["parent"] = lambda f=f, cand=cand, vis=vis, mask=mask, c=c, v=v: build.check(f(
                    cand[0].data_ptr(), cand[1].data_ptr(), c, vis[0].data_ptr(),
                    vis[1].data_ptr(), v, mask.data_ptr(), build.stream_handle(mask)),
                    "parent frontier_dedup")
            row = {"c": c, "v": v, "v_in_range": _in_range(cand, vis), "phases": list(phase),
                   "shape": list(FD.launch_shape(c, v))}
            for label, fn in fns.items():
                mask.fill_(True)
                got = fn()
                CS.require(torch.equal(got if label == "wrapper" else mask, want),
                           f"frontier_dedup {label} disagrees on {name}'s launch (c={c}, v={v})")
                row[label] = CS.device_ms(fn, REPLAY_ITERS, kernel="frontier_dedup")
            rows.append(row)
            CS.log(f"paths {name} frontier_dedup launch: {json.dumps(row)}")
        total = {k: sum(r[k] for r in rows) for k in rows[0] if k.startswith(("wrapper", "parent"))}
        res[name] = {"launches": rows, "sum_ms": total}
        CS.log(f"paths {name} frontier_dedup, {len(rows)} launches, summed ms: {json.dumps(total)}")
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
    res = {"card": card, "hash_probe": sweep_hash_probe(libs, rng, dev),
           "frontier_dedup": sweep_frontier_dedup(libs, rng, dev),
           "frontier_dedup_paths": replay_paths_dedup(libs, dev),
           "compiler": compiler_report(args.parent),
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
