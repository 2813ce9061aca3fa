"""segment_scan: segmented inclusive scan over sorted keys.

``out[i]`` combines (sum / count / min / max) the float32 values of the
maximal run of equal int32 keys ending at ``i``; count is a sum of ones.
Keys must be sorted (equal keys contiguous), as on the grouping path.

CUDA kernel: ``csrc/segment_scan.cu``. ``segment_scan_plain`` is the same
function in PyTorch, laid out like the reference's Pallas kernel (a
doubling scan inside 1024-element blocks and a carry across them); the
wrapper takes it for CPU tensors only. Float sums from the kernel and the
plain version may differ in rounding (another summation order).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK = 1024
_OPS = {"sum": 0, "count": 0, "min": 1, "max": 2}
_IDENT = {"sum": 0.0, "count": 0.0, "min": float("inf"), "max": float("-inf")}
_SENTINEL = -(2 ** 31)
launches = 0


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op in ("sum", "count"):
        return a + b
    return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)


def segment_scan_plain(keys: torch.Tensor, values: torch.Tensor, op: str) -> torch.Tensor:
    n = int(keys.shape[0])
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=keys.device)
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    k = torch.cat([keys, keys.new_full((pad,), _SENTINEL + 1)]).view(nb, BLOCK)
    out = torch.cat(
        [values.to(torch.float32), values.new_full((pad,), _IDENT[op], dtype=torch.float32)]
    ).view(nb, BLOCK)
    ident = torch.full((nb, 1), _IDENT[op], dtype=torch.float32, device=keys.device)
    sentinel = torch.full((nb, 1), _SENTINEL, dtype=torch.int32, device=keys.device)
    d = 1
    while d < BLOCK:
        prev = torch.cat([ident.expand(nb, d), out[:, :-d]], dim=1)
        prev_key = torch.cat([sentinel.expand(nb, d), k[:, :-d]], dim=1)
        out = torch.where(k == prev_key, _combine(op, out, prev), out)
        d *= 2
    rows = [out[0]]
    for b in range(1, nb):
        ck, cv = k[b - 1, BLOCK - 1], rows[-1][BLOCK - 1]
        rows.append(torch.where(k[b] == ck, _combine(op, out[b], cv), out[b]))
    return torch.cat(rows)[:n]


def segment_scan(keys: torch.Tensor, values: torch.Tensor, op: str) -> torch.Tensor:
    """float32 (n,) segmented inclusive scan (see module docstring)."""
    global launches
    if op not in _OPS:
        raise ValueError(f"segment_scan: unknown op {op!r}")
    n = int(keys.shape[0])
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("segment_scan: keys must be a contiguous 1-D int32 tensor")
    if values.dtype != torch.float32 or values.shape != (n,) or not values.is_contiguous():
        raise ValueError("segment_scan: values must be a contiguous float32 tensor like keys")
    if values.device != keys.device:
        raise ValueError("segment_scan: keys and values lie on different devices")
    if keys.device.type == "cpu":
        return segment_scan_plain(keys, values, op)
    if keys.device.type != "cuda":
        raise ValueError(f"segment_scan: unsupported device {keys.device}")
    out = torch.empty(n, dtype=torch.float32, device=keys.device)
    lib = build.library()
    build.check(lib.segment_scan_launch(
        keys.data_ptr(), values.data_ptr(), out.data_ptr(), n, _OPS[op],
        build.stream_handle(out),
    ), "segment_scan")
    launches += 1
    return out
