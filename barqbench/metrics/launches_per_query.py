"""Operators to kernels: ``cudaLaunchKernel`` calls a query in the profiled
rounds (``torch.profiler``'s CUDA runtime events)."""


def read(facts):
    t = facts["timeline"]
    return t.launches / t.queries if t and t.queries and t.launches else None
