"""Run one cell of the benchmark and print its result line.

    python3 barqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It imports the program from ``src/``, keeps
PyTorch's extension and Triton caches under ``build/`` in the checkout,
and exits with a non-zero code and no result line where there is no CUDA
card or the program loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the script's own directory would shadow the standard library's names
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "barqbench" / sub)
# one process that steers the card from one thread: few host threads, on a
# fixed set of the cores the process may use, keep the measurement steady
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "4"
if hasattr(os, "sched_setaffinity"):
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:4])

if __name__ == "__main__":
    from barqbench.harness import main

    sys.exit(main(t_start=T_START))
