"""Asynchronous, crash-safe checkpointing (the reference's
``train/checkpoint.py``), with the reference's layout on disk:

    <dir>/step_000000123.tmp/     — written first
        proc00.npz                — every leaf, named by its tree path
        manifest.json             — step, leaf names, shapes, dtypes, extra
    <dir>/step_000000123/         — renamed from .tmp once both are written

Restore takes the latest complete directory; a crash mid-write leaves only
``.tmp``, which is ignored and removed by the next save's clean-up, and a
save keeps the newest ``keep`` steps. ``save`` copies every leaf to host
numpy before it starts the writer thread, so training may go on (and
overwrite its device tensors) at once. A bfloat16 leaf, which numpy cannot
hold, is written as its 16-bit patterns, with ``bfloat16`` in the
manifest. Either package's checkpoints restore in the other where their
trees match (dict keys, list indices, shapes).

A checkpoint always holds the full arrays. A state split over a mesh
passes its ``shardings`` (the ``MeshAxes`` and the tree of ``Spec``s):
``save`` all-gathers the shards (every rank calls it) and the mesh's first
rank writes; ``restore`` reads the full arrays on every rank and keeps its
shard of each (elastic restore: any mesh, or one rank, reads any
checkpoint).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel import sharding as SH
from repro_torch.train.tree import flatten_with_paths, unflatten
from repro_torch.train.tree import leaves as tree_leaves


def _flatten(tree) -> List[Tuple[str, torch.Tensor]]:
    return [("/".join(path), leaf) for path, leaf in flatten_with_paths(tree)]


def _to_host(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype name) of a leaf."""
    x = x.detach().to("cpu", copy=True)  # a copy even of a CPU tensor
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = x.numpy()
    return a, str(a.dtype)


def _like_leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` in ``like``'s dtype, on its device."""
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize == 2 and arr.dtype.kind in "uiV":  # 16-bit patterns
            t = torch.from_numpy(np.array(arr, copy=True).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=like.device, dtype=torch.bfloat16)
    want = torch.empty((), dtype=like.dtype).numpy().dtype
    return torch.from_numpy(np.array(arr, dtype=want)).to(like.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: Optional[Dict] = None, shardings=None) -> None:
        """Write ``tree`` (this rank's shards under ``shardings``, a pair
        (axes, specs), where given) as step ``step``."""
        self.wait()
        if shardings is not None:
            axes, specs = shardings
            tree = SH.gather_tree(tree, specs, axes)
            if axes.index(axes.names) != 0:
                return
        host = [(k, *_to_host(v)) for k, v in _flatten(tree)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def _write(self, step: int, host: List[Tuple[str, np.ndarray, str]], extra: Dict):
        try:
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "proc00.npz"), **{k: a for k, a, _ in host})
            manifest = {
                "step": step,
                "keys": [k for k, _, _ in host],
                "shapes": {k: list(a.shape) for k, a, _ in host},
                "dtypes": {k: d for k, _, d in host},
                "time": time.time(),
                "extra": extra,
                "n_processes": 1,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        # drop orphaned tmp dirs from crashes
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like_tree, shardings=None):
        """Restore into the structure of ``like_tree`` (shapes must match):
        each leaf in its like's dtype, on its like's device. With
        ``shardings`` (axes, specs) the likes are this rank's shards and
        each leaf is cut to its shard of the full array (re-sharding for
        the current mesh)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        flat = _flatten(like_tree)
        specs = [None] * len(flat) if shardings is None else tree_leaves(shardings[1])
        if len(specs) != len(flat):
            raise ValueError(f"restore: {len(flat)} leaves against {len(specs)} specs")
        leaves = []
        with np.load(os.path.join(path, "proc00.npz")) as data:
            for (key, like), sp in zip(flat, specs):
                arr = data[key]
                want = tuple(arr.shape) if sp is None else SH.shard_shape(
                    arr.shape, sp, shardings[0], key)
                if want != tuple(like.shape):
                    raise ValueError(
                        f"checkpoint leaf {key} shape {arr.shape} != expected "
                        f"{tuple(like.shape)}")
                if sp is not None:
                    arr = arr[SH.local_slices(arr.shape, sp, shardings[0], key)]
                leaves.append(_like_leaf(arr, like))
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return unflatten(like_tree, leaves), manifest
