"""Batch operators of the vectorized engine."""
