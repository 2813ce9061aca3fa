"""Sweep the compiled shapes of join_expand and gather_emit on the card.

The port compiles two instances of each kernel and picks one from the
input (join_expand: a tile for small windows and one for large;
gather_emit: a short unroll for narrow plans and one to the caps). This
script compiles the candidates from the same sources into its own library
under ``build/kernel_sweep/`` — a small
``.cu`` that includes the source and exports each instance of its
``launch`` template — checks each instance against the plain PyTorch
version, and prints its device time per launch (``torch.profiler``, as
``chip_smoke.py`` measures). With ``--parent DIR`` it also builds and times
``DIR/src/repro_torch/csrc/join_expand.cu`` (an earlier commit's kernel,
whose C entry point takes no tile) on the same windows.

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
        srcs["parent"] = Path(parent) / "src" / "repro_torch" / "csrc" / "join_expand.cu"
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
    if "parent" in libs:
        libs["parent"].join_expand_launch.argtypes = [P, P, P, P, P, I, L, L, P, P, P]
    return libs


def _expand_fn(libs, which, args, base, count):
    ls, ll, rs, rl, cum = args
    li = torch.empty(count, dtype=torch.int32, device=ls.device)
    ri = torch.empty_like(li)
    st = build.stream_handle(li)
    g = int(ls.shape[0])
    if which == "parent":
        f = libs["parent"].join_expand_launch

        def run():
            build.check(f(ls.data_ptr(), ll.data_ptr(), rs.data_ptr(), rl.data_ptr(),
                          cum.data_ptr(), g, base, count, li.data_ptr(), ri.data_ptr(), st),
                        "parent join_expand")
            return li, ri
    else:
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
    variants = [("parent", "parent")] if "parent" in libs else []
    variants += [(f"{t}x{tl}", (t, tl)) for t, tl in JE_SHAPES]
    res = {}
    for label, args, base, count in windows:
        want = JE.join_expand_plain(*args, base, count)
        row = {}
        for name, which in variants:
            fn = _expand_fn(libs, which, args, base, count)
            li, ri = fn()
            CS.require(torch.equal(li, want[0]) and torch.equal(ri, want[1]),
                       f"join_expand {name} disagrees with the plain version ({label})")
            if which != "parent":
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
                build.check(f(plan.address, lcols.data_ptr(), lcols.stride(0),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="root of an earlier checkout whose join_expand.cu is timed beside")
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
    res = {"card": card, "join_expand": sweep_join_expand(libs, rng, dev),
           "gather_emit": sweep_gather_emit(libs, rng, dev)}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
