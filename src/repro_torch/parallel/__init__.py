"""Logical mesh axes over a process group."""
