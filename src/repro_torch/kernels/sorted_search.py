"""sorted_search: vectorized binary search over sorted int32 keys.

``sorted_search(keys, queries, side)`` gives, for each query, the int32
number of keys below it (``side="left"``) or at or below it
(``side="right"``), over int32 keys sorted ascending: ``np.searchsorted``
of the reference's numpy oracle. ``sorted_search_range(keys, queries)``
gives both sides from one launch; the property-path engine finds each
frontier node's successor range with it.

The Pallas kernel pads the keys with INT32_MAX, so for a query equal to
INT32_MAX with ``side="right"`` it counts the padding as well; these
functions count real keys only, as numpy does. Dictionary codes never
reach INT32_MAX, so the two agree on every input the engine makes.

CUDA kernel: ``csrc/sorted_search.cu``. ``sorted_search_plain`` is the same
function in PyTorch, laid out like the kernel: the bucket step over every
``ceil(n / SAMPLES)``-th key, then a binary search inside the bucket it
picks. ``sorted_search_range_plain`` is two ``torch.searchsorted`` calls.
The wrappers take the plain versions for CPU tensors only. Both entry
points count under one launch counter.
"""

from __future__ import annotations

import time
from typing import Tuple

import torch

from repro_torch.kernels import build

SAMPLES = 8192  # csrc/sorted_search.cu: the samples a block keeps in shared memory
_MODES = {"left": 0, "right": 1}
launches = 0


def sorted_search_plain(keys: torch.Tensor, queries: torch.Tensor, side: str = "left",
                        samples: int = SAMPLES) -> torch.Tensor:
    """The kernel's search in PyTorch: count the samples (every B-th key,
    B = ceil(n / samples)) that satisfy the predicate, c; the answer lies
    in [(c-1)B + 1, min(cB, n)] (0 when c = 0); a binary search over that
    interval of the keys finishes it."""
    n, m = int(keys.shape[0]), int(queries.shape[0])
    if n == 0:
        return torch.zeros(m, dtype=torch.int32, device=keys.device)
    right = side == "right"
    q = queries.to(torch.int64)

    def pred(k: torch.Tensor) -> torch.Tensor:
        return k <= q if right else k < q

    bucket = -(-n // samples)
    sample = keys[::bucket].to(torch.int64)
    ns = int(sample.shape[0])
    # the bucket step: a branchless count over the samples
    base = torch.zeros(m, dtype=torch.int64, device=keys.device)
    length = ns
    while length > 1:
        half = length >> 1
        base = torch.where(pred(sample[base + half]), base + half, base)
        length -= half
    c = base + pred(sample[base]).to(torch.int64)
    lo = torch.where(c == 0, 0, (c - 1) * bucket + 1)
    hi = torch.where(c == 0, 0, torch.where(c < ns, c * bucket, n))
    # the inner search: the answer lies in [lo, hi]
    keys64 = keys.to(torch.int64)
    for _ in range((bucket - 1).bit_length()):
        active = lo < hi
        mid = lo + ((hi - lo) >> 1)
        p = pred(keys64[mid.clamp(max=n - 1)])
        lo = torch.where(active & p, mid + 1, lo)
        hi = torch.where(active & ~p, mid, hi)
    return lo.to(torch.int32)


def sorted_search_range_plain(keys: torch.Tensor,
                              queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.searchsorted(keys, queries, out_int32=True),
            torch.searchsorted(keys, queries, right=True, out_int32=True))


def _check(keys: torch.Tensor, queries: torch.Tensor, fn: str) -> None:
    for name, x in (("keys", keys), ("queries", queries)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 1-D int32 tensor")
    if queries.device != keys.device:
        raise ValueError(f"{fn}: queries are on {queries.device}, not {keys.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {keys.device}")


def _launch(keys: torch.Tensor, queries: torch.Tensor, mode: int, out0: torch.Tensor,
            out1: torch.Tensor, fn: str, t0: float) -> None:
    global launches
    m, n = int(queries.shape[0]), int(keys.shape[0])
    if m == 0:
        return
    scratch = torch.empty(SAMPLES if n > SAMPLES else 0, dtype=torch.int32, device=keys.device)
    lib = build.library()
    build.check(lib.sorted_search_launch(
        keys.data_ptr(), n, queries.data_ptr(), m, mode, scratch.data_ptr(),
        out0.data_ptr(), out1.data_ptr(), build.stream_handle(out0),
    ), fn)
    launches += 1
    build.ledger("sorted_search", "cuda", t0)


def sorted_search(keys: torch.Tensor, queries: torch.Tensor,
                  side: str = "left") -> torch.Tensor:
    """(m,) int32 positions of ``queries`` in ``keys`` (see module docstring)."""
    t0 = time.perf_counter()
    if side not in _MODES:
        raise ValueError(f"sorted_search: side must be 'left' or 'right', not {side!r}")
    _check(keys, queries, "sorted_search")
    if keys.device.type == "cpu":
        out = sorted_search_plain(keys, queries, side)
        build.ledger("sorted_search", "plain", t0)
        return out
    out = torch.empty(int(queries.shape[0]), dtype=torch.int32, device=keys.device)
    _launch(keys, queries, _MODES[side], out, out, "sorted_search", t0)
    return out


def sorted_search_range(keys: torch.Tensor,
                        queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi): both sides of ``sorted_search`` from one launch."""
    t0 = time.perf_counter()
    _check(keys, queries, "sorted_search_range")
    if keys.device.type == "cpu":
        out = sorted_search_range_plain(keys, queries)
        build.ledger("sorted_search", "plain", t0)
        return out
    lo = torch.empty(int(queries.shape[0]), dtype=torch.int32, device=keys.device)
    hi = torch.empty_like(lo)
    _launch(keys, queries, 2, lo, hi, "sorted_search_range", t0)
    return lo, hi
