"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into an
object file — one ``nvcc`` process per source, all started together — and
the objects link into one shared library with a plain C interface, loaded
with ``ctypes``. The library lives in ``build/repro_torch/`` under the
repository root and is named by a hash of the sources, the headers they
include (``csrc/*.cuh``), the flags and the compiler, so a changed source,
header or toolkit rebuilds and an unchanged one loads at once. The build
runs at the first kernel launch of a process, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core import telemetry

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# a block's dynamic shared memory on the H100, opted in: the wrappers size
# their launches by it, and each source that takes shared memory exports
# its own, checked against it when the library loads
SMEM_MAX = 232_448

# int32 words a slab of zeros holds (4 MB)
SLAB = 1 << 20

_lib: Optional[ctypes.CDLL] = None
# (device index, stream handle) -> [slab of zeros, words handed out]
_slabs: Dict[Tuple[int, int], list] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    """The headers the sources include: hashed, not compiled apart."""
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(srcs: List[Path], nvcc: str) -> str:
    """Hash of the sources and the headers, the flags and the compiler (its
    path and its ``--version``), so a new toolkit rebuilds too."""
    version = subprocess.run(
        [nvcc, "--version"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, check=True,
    ).stdout
    h = hashlib.sha256(" ".join([nvcc, version, *NVCC_FLAGS]).encode())
    for s in [*srcs, *headers()]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); returns the
    shared library's path."""
    srcs = sources()
    nvcc = _nvcc()
    lib_path = BUILD_DIR / f"libbarq_kernels_{_digest(srcs, nvcc)}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(srcs, objs)
        ]
        failures = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                failures.append(f"{s.name}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "join_expand_launch": [P, P, P, P, P, I, L, L, P, P, I, P],
        "gather_emit_launch": [P, P, L, P, L, I, P, P, L, P, L, P, I, P],
        "gather_emit_limits": [P, P, P],
        "expr_eval_launch": [P, P, I, I, I, I, I, I, P, P, L, P, P, I, I, L, P, P, P],
        "expr_eval_limits": [P, P, P, P],
        "segment_scan_launch": [P, P, P, L, I, P, P],
        "radix_partition_launch": [P, L, I, I, I, P, P, P],
        "radix_partition_limits": [P, P, P, P, P, P],
        "hash_probe_launch": [P, I, P, P, P, P, I, P, P, P],
        "bloom_build_launch": [P, L, I, P, P, I, P],
        "bloom_build_limits": [P, P, P],
        "bloom_probe_launch": [P, I, P, I, P, P],
        "sip_mask_launch": [P, P, P, I, I, P],
        "sip_mask_limits": [P, P],
        "sorted_search_launch": [P, I, P, I, I, P, P, P, P],
        "frontier_dedup_launch": [P, P, L, P, P, I, P, I, I, I, P],
        "frontier_dedup_limits": [P, P, P, P, P, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def check(status: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream_handle(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device
    (``torch._C._cuda_getCurrentRawStream`` makes no ``torch.cuda.Stream``
    object per call, as ``torch.cuda.current_stream`` does)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def zeroed(device, n: int, stream: int):
    """``n`` int32 zeros on ``device``, cut from a slab that is zeroed once
    on ``stream`` for many calls (a kernel that adds into zeros, such as
    radix_partition's histogram or bloom_build's range and tickets, needs
    no fill launch of its own). Each piece is handed out once."""
    import torch

    key = (device.index, stream)
    slab = _slabs.get(key)
    if slab is None or slab[1] + n > SLAB:
        slab = _slabs[key] = [torch.zeros(SLAB, dtype=torch.int32, device=device), 0]
    piece = slab[0][slab[1]: slab[1] + n]
    slab[1] += n
    return piece


def ledger(name: str, backend: str, t0: float) -> float:
    """Record one dispatch of kernel ``name`` that began at host time ``t0``
    (``time.perf_counter``) in the telemetry ledgers: backend ``"cuda"``
    for a launch, ``"plain"`` for a call of the plain version. Returns the
    time it ended, the start of a next launch in the same call. Reads no
    device value."""
    t1 = time.perf_counter()
    telemetry.record_dispatch(name, backend, t0, t1 - t0)
    return t1
