"""BARQ on PyTorch: the vectorized SPARQL engine's main path on an NVIDIA
GPU, with hand-written CUDA kernels (``kernels``, ``csrc``).

Public API:
    QuadStore     — sorted quad indexes on a device + host dictionary
    Engine        — parse / plan / translate / execute; device=None is the
                    CUDA card, device="cpu" runs the kernels' plain versions
    EngineConfig  — the reference's settings, restricted to this package
"""

from repro_torch.core.dictionary import Dictionary  # noqa: F401
from repro_torch.core.executor import Engine, EngineConfig, QueryResult  # noqa: F401
from repro_torch.core.storage import QuadStore  # noqa: F401
from repro_torch.data.lsqb import LSQB_QUERIES, generate_social_graph  # noqa: F401
