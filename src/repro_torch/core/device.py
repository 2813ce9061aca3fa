"""Device resolution for the package's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card and raises where there is none; a bare
    ``"cuda"`` gains the current device index so devices compare equal."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the kernels' plain versions"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
