"""Multi-pod dry run (the reference's ``launch/dryrun.py``): every
(arch x shape) cell's step on the production meshes, as one rank's
memory, cost and collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single --out experiments/dryrun

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

PyTorch cannot lower a program onto placeholder ranks, so the dry run runs
the port's own per-rank program instead: it makes a ``fake`` process group
of 256 ("single") or 512 ("multi") ranks, builds the cell's bundle on the
production mesh (``launch/steps.py``: the layouts every real run uses) and
runs one step of rank 0's program on meta tensors at its shard shapes.
Nothing is allocated and no collective moves data; what the step does is
counted:

  flops_per_device  ``FlopCounterMode`` (matrix products, as XLA counts
                    them; elementwise work is not counted);
  bytes_per_device  every aten operation's tensor inputs and outputs summed
                    (views and collectives excluded): an unfused count, an
                    upper bound on what a fused program moves;
  collectives       the ``MeshAxes`` tally of ``parallel/sharding.py``:
                    output bytes and calls a kind, forward and backward;
  argument_bytes    the rank's shards of the step's arguments; output_bytes
                    of its results;
  temp_bytes        the peak of what ``MemTracker`` saw the step allocate,
                    or null with the reason.

``compile_s`` and ``code_bytes`` have no counterpart and are null. Every
layer is traced, so ``scan_body_extrapolated`` is false. LM cells'
compute term is at the bfloat16 tensor-core peak, the float32 GNN and
recsys cells' at the float32 one (``launch/roofline.py``). Per-cell
results land in <out>/<arch>__<shape>__<mesh>.json with the reference's
schema, so ``launch/report.py`` renders either package's; a failure is
recorded with its exception. ``--all`` runs each cell in a fresh
subprocess, as the reference does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, all_cells, get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import (
    HBM_BYTES_PER_S, PEAK_BF16_FLOPS_PER_S, PEAK_OPS_PER_S, link_bytes_per_s, model_flops,
    roofline_terms,
)
from repro_torch.launch.steps import build_step
from repro_torch.parallel.sharding import tree_bytes

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
METHOD = ("one rank's program on meta tensors over a fake process group; flops: "
          "FlopCounterMode (matrix products); bytes: every aten op's inputs and outputs, "
          "unfused; collectives: the sharding tally, forward and backward")


class _Bytes(TorchDispatchMode):
    """Sums the bytes of every aten operation's tensor inputs and outputs
    (views and collectives move nothing here)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace not in ("c10d", "_c10d_functional"):
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0 (collectives return at once and move nothing); destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def account(bundle) -> Dict:
    """One step of ``bundle``'s program on meta tensors at this rank's
    shard shapes: its memory, cost and collectives."""
    from torch.utils.flop_counter import FlopCounterMode

    args = bundle.local_args()
    arg_bytes = tree_bytes(args)
    bundle.axes.tally.reset()
    counter, flops = _Bytes(), FlopCounterMode(display=False)
    temp, temp_note, tracker = None, None, None
    try:
        from torch.distributed._tools.mem_tracker import MemTracker

        tracker = MemTracker()
    except ImportError as e:
        temp_note = f"MemTracker unavailable: {e}"
    with flops, counter, (tracker if tracker is not None else contextlib.nullcontext()):
        out = bundle.fn(*args)
    if tracker is not None:
        peak = tracker.get_tracker_snapshot("peak")
        temp = int(sum(v.get("Total", 0) for v in peak.values()))
        temp_note = "peak bytes MemTracker saw the step allocate (outputs included)"
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    return dict(
        memory=dict(argument_bytes=int(arg_bytes),
                    output_bytes=int(sum(t.numel() * t.element_size() for t in outs)),
                    temp_bytes=temp, temp_bytes_note=temp_note, code_bytes=None),
        flops=float(flops.get_total_flops()),
        bytes=float(counter.bytes),
        collectives=bundle.axes.tally.record(),
    )


def useful_flops(arch, shape_name: str, model=None) -> Optional[float]:
    """The reference's model FLOPs of an LM cell (None for the others)."""
    sh = arch.shapes[shape_name]
    if arch.kind != "lm":
        return None
    if sh["step"] == "train":
        d, training = sh["global_batch"] * sh["seq_len"], True
    elif sh["step"] == "prefill":
        d, training = sh["global_batch"] * sh["seq_len"], False
    else:
        d, training = sh["global_batch"], False  # one token per request
    return model_flops("lm", model or arch.model, sh, d, training)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, out_dir: str,
             skip_existing: bool = False, overrides: dict = None, tag: str = "",
             use_reduced: bool = False, mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """The record of one cell on the single (256-rank) or multi (512)
    mesh; ``mesh_shape`` (two or three dimensions) and ``use_reduced``
    size it down for tests."""
    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_name}{suffix}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            prior = json.load(f)
        if prior.get("status") == "ok":
            return prior

    arch = get_config(arch_id)
    sh0 = dict(arch.shapes[shape_name])
    sh0.update(overrides or {})
    arch = dataclasses.replace(arch, shapes={**arch.shapes, shape_name: sh0})
    shape, names = MESHES[mesh_name]
    if mesh_shape is not None:
        shape = tuple(mesh_shape)
        names = names[-len(shape):]
    n_chips = math.prod(shape)
    record = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "status": "failed"}
    t0 = time.time()
    try:
        with fake_group(n_chips):
            mesh = make_mesh(shape, names, device="cpu")
            bundle = build_step(arch, shape_name, mesh, use_reduced=use_reduced)
            t_build = time.time() - t0
            acc = account(bundle)
        model = arch.reduced_model if use_reduced else arch.model
        peak = PEAK_BF16_FLOPS_PER_S if arch.kind == "lm" else PEAK_OPS_PER_S
        link = link_bytes_per_s(n_chips)
        coll = acc["collectives"]
        terms = roofline_terms(acc["flops"], acc["bytes"], float(coll["total_bytes"]), link,
                               peak)
        record.update(
            status="ok",
            description=bundle.description,
            n_chips=n_chips,
            mesh_shape=list(shape),
            lower_s=round(t_build, 2),
            compile_s=None,
            scan_body_extrapolated=False,
            overrides=overrides or {},
            method=METHOD,
            memory=acc["memory"],
            cost=dict(flops_per_device=acc["flops"], bytes_per_device=acc["bytes"],
                      global_flops=acc["flops"] * n_chips),
            collectives=coll,
            roofline=terms,
            hw=dict(peak_flops=peak, hbm_bw=HBM_BYTES_PER_S, link_bw=link),
        )
        useful = useful_flops(arch, shape_name, model)
        if useful is not None:
            record["model_flops_global"] = useful
            gf = acc["flops"] * n_chips
            record["useful_flops_ratio"] = useful / gf if gf else None
    except Exception as e:  # noqa: BLE001 - a failed cell is recorded, not raised
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["wall_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def _parse_overrides(items):
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="shape override k=v (perf iteration knobs)")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.set)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        failures = 0
        for arch_id, shape in all_cells():
            for m in meshes:
                path = os.path.join(args.out, f"{arch_id}__{shape}__{m}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("status") == "ok":
                        print(f"[skip] {arch_id} x {shape} x {m}: ok")
                        continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_id,
                       "--shape", shape, "--mesh", m, "--out", args.out]
                r = subprocess.run(cmd, capture_output=True, text=True)
                try:
                    with open(path) as f:
                        rec = json.load(f)
                    ok = rec["status"] == "ok"
                except FileNotFoundError:
                    ok, rec = False, {"error": r.stderr[-500:]}
                failures += 0 if ok else 1
                msg = (f"build={rec.get('lower_s')}s dom={rec.get('roofline', {}).get('dominant')}"
                       if ok else rec.get("error", "?")[:200])
                print(f"[{'ok' if ok else 'FAIL'}] {arch_id} x {shape} x {m}: {msg}", flush=True)
        print(f"done; {failures} failures")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --all required")
    for m in meshes:
        rec = run_cell(args.arch, args.shape, m == "multi", args.out, args.skip_existing,
                       overrides, args.tag)
        if rec["status"] == "ok":
            rt = rec["roofline"]
            print(f"{args.arch} x {args.shape} x {m}: ok build={rec['lower_s']}s "
                  f"compute={rt['compute_s']:.3e}s memory={rt['memory_s']:.3e}s "
                  f"collective={rt['collective_s']:.3e}s dominant={rt['dominant']}")
            print("memory:", rec["memory"])
            print("collectives:", rec["collectives"])
        else:
            print(f"{args.arch} x {args.shape} x {m}: FAILED\n{rec.get('traceback', '')}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
