"""sorted_search: vectorized binary search over sorted int32 keys.

``sorted_search(keys, queries, side)`` gives, for each query, the int32
number of keys below it (``side="left"``) or at or below it
(``side="right"``), over int32 keys sorted ascending: ``np.searchsorted``
of the reference's numpy oracle. The property-path engine finds each
frontier node's successor range with one call of each side.

The Pallas kernel pads the keys with INT32_MAX, so for a query equal to
INT32_MAX with ``side="right"`` it counts the padding as well; this
function counts real keys only, as numpy does. Dictionary codes never
reach INT32_MAX, so the two agree on every input the engine makes.

CUDA kernel: ``csrc/sorted_search.cu``. ``sorted_search_plain`` is the same
function in PyTorch; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0


def sorted_search_plain(keys: torch.Tensor, queries: torch.Tensor,
                        side: str = "left") -> torch.Tensor:
    return torch.searchsorted(keys, queries, right=(side == "right")).to(torch.int32)


def sorted_search(keys: torch.Tensor, queries: torch.Tensor,
                  side: str = "left") -> torch.Tensor:
    """(m,) int32 positions of ``queries`` in ``keys`` (see module docstring)."""
    global launches
    if side not in ("left", "right"):
        raise ValueError(f"sorted_search: side must be 'left' or 'right', not {side!r}")
    for name, x in (("keys", keys), ("queries", queries)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"sorted_search: {name} must be a contiguous 1-D int32 tensor")
    if queries.device != keys.device:
        raise ValueError(f"sorted_search: queries are on {queries.device}, not {keys.device}")
    if keys.device.type == "cpu":
        return sorted_search_plain(keys, queries, side)
    if keys.device.type != "cuda":
        raise ValueError(f"sorted_search: unsupported device {keys.device}")
    m = int(queries.shape[0])
    out = torch.empty(m, dtype=torch.int32, device=keys.device)
    if m == 0:
        return out
    lib = build.library()
    build.check(lib.sorted_search_launch(
        keys.data_ptr(), int(keys.shape[0]), queries.data_ptr(), m,
        int(side == "left"), out.data_ptr(), build.stream_handle(out),
    ), "sorted_search")
    launches += 1
    return out
