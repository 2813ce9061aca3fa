"""join_expand: merge-join Build-phase expansion (paper §3.2).

For output slots ``[base, base+count)`` of a grouped cross product, the
``(li, ri)`` int32 gather indices: slot t lies in group g (the last with
``cum[g] <= t``), ``w = t - cum[g]``, ``li = lstarts[g] + w // rlens[g]``,
``ri = rstarts[g] + w % rlens[g]``; slots at or past ``cum[G]`` get -1.
``cum`` is int64, so totals beyond 2^31 are fine.

CUDA kernel: ``csrc/join_expand.cu``. ``join_expand_plain`` is the same
function in PyTorch; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0


def join_expand_plain(lstarts, llens, rstarts, rlens, cum, base: int,
                      count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = lstarts.device
    g_total = int(lstarts.shape[0])
    if g_total == 0:
        neg = torch.full((count,), -1, dtype=torch.int32, device=dev)
        return neg, neg.clone()
    t = torch.arange(base, base + count, dtype=torch.int64, device=dev)
    valid = (t >= 0) & (t < cum[g_total])
    g = (torch.searchsorted(cum, t, right=True) - 1).clamp_(0, g_total - 1)
    w = t - cum[g]
    ll = llens[g].to(torch.int64)
    rl = rlens[g].to(torch.int64)
    rl_safe = rl.clamp(min=1)
    a = torch.where(ll == 1, torch.zeros_like(w), torch.where(rl == 1, w, w // rl_safe))
    b = torch.where(ll == 1, w, torch.where(rl == 1, torch.zeros_like(w), w % rl_safe))
    li = torch.where(valid, lstarts[g].to(torch.int64) + a, -1).to(torch.int32)
    ri = torch.where(valid, rstarts[g].to(torch.int64) + b, -1).to(torch.int32)
    return li, ri


def join_expand(lstarts, llens, rstarts, rlens, cum, base: int,
                count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(li, ri) int32 tensors of length ``count`` (see module docstring)."""
    global launches
    g = int(lstarts.shape[0])
    for name, x in (("lstarts", lstarts), ("llens", llens),
                    ("rstarts", rstarts), ("rlens", rlens)):
        if x.dtype != torch.int32 or x.shape != (g,) or not x.is_contiguous():
            raise ValueError(f"join_expand: {name} must be contiguous int32 ({g},)")
        if x.device != lstarts.device:
            raise ValueError(f"join_expand: {name} is on {x.device}, not {lstarts.device}")
    if cum.dtype != torch.int64 or cum.shape != (g + 1,) or not cum.is_contiguous():
        raise ValueError(f"join_expand: cum must be contiguous int64 ({g + 1},)")
    if cum.device != lstarts.device:
        raise ValueError("join_expand: cum is on another device")
    if count < 0:
        raise ValueError("join_expand: negative count")
    if lstarts.device.type == "cpu":
        return join_expand_plain(lstarts, llens, rstarts, rlens, cum, base, count)
    if lstarts.device.type != "cuda":
        raise ValueError(f"join_expand: unsupported device {lstarts.device}")
    li = torch.empty(count, dtype=torch.int32, device=lstarts.device)
    ri = torch.empty(count, dtype=torch.int32, device=lstarts.device)
    lib = build.library()
    build.check(lib.join_expand_launch(
        lstarts.data_ptr(), llens.data_ptr(), rstarts.data_ptr(), rlens.data_ptr(),
        cum.data_ptr(), g, int(base), int(count), li.data_ptr(), ri.data_ptr(),
        build.stream_handle(li),
    ), "join_expand")
    launches += 1
    return li, ri
