"""Engine configurations: ``barq_engine`` (the engine's defaults and the
distributed join's dry-run shapes)."""
