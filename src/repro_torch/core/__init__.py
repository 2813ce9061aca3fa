"""Vectorized SPARQL execution on PyTorch tensors: host front end (parser,
planner, dictionary, statistics) and the device data plane (storage,
batches, operators, executor).

The names exported here import nothing of the data plane: query telemetry
(``telemetry``: the kernel ledger, ``QueryTrace``, ``query_fingerprint``,
``CardinalityFeedback``) and the operator-tree reports (``profile_tree``,
``collect_stats``)."""

from repro_torch.core import telemetry  # noqa: F401
from repro_torch.core.profiler import collect_stats, profile_tree  # noqa: F401
from repro_torch.core.telemetry import CardinalityFeedback, query_fingerprint  # noqa: F401
