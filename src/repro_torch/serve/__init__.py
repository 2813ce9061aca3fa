"""Query serving: the ``QueryServer`` with its metrics registry, workload
repository and flight recorder, as in the reference package's ``serve``."""
