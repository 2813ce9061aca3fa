"""The H100's peaks, in one place, and the roofline terms of a step.

  compute term    = operations / peak operations a second
  memory term     = bytes read and written / HBM bandwidth
  collective term = collective bytes / link bandwidth

all per device. The peaks are NVIDIA's data sheet figures for one H100 SXM
at its full power limit, the card the port runs on ("NVIDIA H100 80GB
HBM3, 700.00 W" as ``nvidia-smi`` names it); a card set below 700 W runs
slower under load. The engine's work is integer and comparison work, so its
operations count at the float32 rate outside the tensor cores, as do the
float32 GNN and recsys steps (they run without TF32); the LM steps compute
in bfloat16 and count at the dense bfloat16 tensor-core rate,
989.4 TFLOP/s on the same data sheet (1,979 with 2:4 sparsity, which the
port does not use).

Links: the eight GPUs of one node (the DGX H100 layout) reach each other
over NVLink at 450 GB/s a direction; between nodes each GPU has one
400 Gb/s NDR adapter, 50 GB/s, which bounds an all-to-all over more than
eight ranks.
"""

from __future__ import annotations

from typing import Dict

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores, used for every elementwise or integer
# operation, and float64 outside the tensor cores
PEAK_OPS_PER_S = 67e12
PEAK_FP64_OPS_PER_S = 34e12
# bfloat16 on the tensor cores, dense
PEAK_BF16_FLOPS_PER_S = 989e12
NVLINK_BYTES_PER_S = 450e9  # a direction, one GPU
INTER_NODE_BYTES_PER_S = 50e9  # one 400 Gb/s NDR adapter a GPU
GPUS_PER_NODE = 8


def link_bytes_per_s(n_ranks: int) -> float:
    """The bandwidth an all-to-all over ``n_ranks`` GPUs is bound by."""
    return NVLINK_BYTES_PER_S if n_ranks <= GPUS_PER_NODE else INTER_NODE_BYTES_PER_S


def roofline_terms(flops_per_dev: float, bytes_per_dev: float, coll_bytes_per_dev: float,
                   link_bw: float = NVLINK_BYTES_PER_S,
                   peak_ops: float = PEAK_OPS_PER_S) -> Dict[str, float]:
    """The three terms in seconds, the dominant one, the step's lower bound
    (the largest term) and the share of it the compute and memory roofline
    takes; ``peak_ops`` is the rate of the step's operations."""
    compute_s = flops_per_dev / peak_ops
    memory_s = bytes_per_dev / HBM_BYTES_PER_S
    collective_s = coll_bytes_per_dev / link_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom.replace("_s", "")
    terms["step_time_lower_bound_s"] = bound
    terms["roofline_fraction"] = (
        max(compute_s, memory_s) / bound if bound > 0 else 0.0
    )
    return terms


def model_flops(arch_kind: str, model, shape: Dict, n_tokens_or_items: int,
                training: bool) -> float:
    """'Useful' model FLOPs: 6·N·D dense / 6·N_active·D MoE for training,
    2·N·D inference (N = params, D = tokens/items processed); the
    reference's function, returning what it returns."""
    mult = 6.0 if training else 2.0
    if arch_kind == "lm":
        n = model.active_param_count() if model.moe else model.param_count()
        return mult * n * n_tokens_or_items
    # gnn / recsys: use dense-parameter work as the useful-FLOPs proxy
    return mult * n_tokens_or_items
