"""The paper's own artifact as a config: the BARQ engine's defaults and the
distributed join's dry-run shapes (``launch/engine_dryrun.py`` reads
these), kept in one place so every tunable is discoverable.
"""

from repro_torch.core.executor import EngineConfig

# engine defaults mirroring the paper's production settings (§5.2: max
# batch 512 in Stardog; the engine defaults to 4096)
BARQ_DEFAULT = EngineConfig(
    engine="barq",
    adaptive_batching=True,
    initial_batch=64,
    max_batch=4096,
    allow_child_skip=True,
)

LEGACY_BASELINE = EngineConfig(engine="legacy")
MIXED_MIGRATION = EngineConfig(engine="mixed")

# distributed-join dry-run shapes (log2 relation sizes x capacity factors)
DIST_JOIN_SHAPES = {
    "edges_2e30_cf2.0": dict(log2_edges=30, cap_factor=2.0),
    "edges_2e30_cf1.25": dict(log2_edges=30, cap_factor=1.25),
    "edges_2e30_cf4.0": dict(log2_edges=30, cap_factor=4.0),
}
