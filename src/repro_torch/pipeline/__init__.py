"""Deterministic, resumable data pipelines (numpy)."""
