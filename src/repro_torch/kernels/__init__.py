"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain version and a plain
integer launch counter (``launches``) that the wrapper bumps once per
kernel launch. A wrapper handed CPU tensors runs the plain version; handed
CUDA tensors it launches the kernel or raises. The kernels build from
``repro_torch/csrc/*.cu`` at the first launch (see ``build``).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import expr_eval, gather_emit, join_expand, segment_scan

KERNEL_MODULES = {
    "join_expand": join_expand,
    "gather_emit": gather_emit,
    "expr_eval": expr_eval,
    "segment_scan": segment_scan,
}


def launch_counts() -> Dict[str, int]:
    return {name: m.launches for name, m in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for m in KERNEL_MODULES.values():
        m.launches = 0
