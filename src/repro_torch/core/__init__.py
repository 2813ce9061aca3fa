"""Vectorized SPARQL execution on PyTorch tensors: host front end (parser,
planner, dictionary, statistics) and the device data plane (storage,
batches, operators, executor)."""
