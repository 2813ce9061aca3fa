"""Operators: host syncs a query, from PyTorch's CUDA sync-debug mode over
the mix's sync-counted rounds."""


def read(facts):
    s = facts["syncs"]
    return s["count"] / s["queries"] if s and s["queries"] else None
