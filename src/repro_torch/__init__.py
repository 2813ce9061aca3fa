"""BARQ on PyTorch: the vectorized SPARQL engine's main path on an NVIDIA
GPU, with hand-written CUDA kernels (``kernels``, ``csrc``).

Public API:
    QuadStore     — sorted quad indexes on a device + host dictionary
    Engine        — parse / plan / translate / execute; device=None is the
                    CUDA card, device="cpu" runs the kernels' plain versions
    EngineConfig  — the reference's settings, restricted to this package
    telemetry     — the kernel ledger and the per-query ``QueryTrace``
                    (``QueryResult.trace``), ``query_fingerprint`` and
                    ``CardinalityFeedback``
    profile_tree, collect_stats — the operator-tree report (EXPLAIN
                    ANALYZE with ``analyze=True``) and its aggregate
"""

from repro_torch.core import telemetry  # noqa: F401
from repro_torch.core.dictionary import Dictionary  # noqa: F401
from repro_torch.core.executor import Engine, EngineConfig, QueryResult  # noqa: F401
from repro_torch.core.profiler import collect_stats, profile_tree  # noqa: F401
from repro_torch.core.storage import QuadStore  # noqa: F401
from repro_torch.core.telemetry import CardinalityFeedback, query_fingerprint  # noqa: F401
from repro_torch.data.lsqb import LSQB_QUERIES, generate_social_graph  # noqa: F401
