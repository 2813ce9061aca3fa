"""Serving, whole requests: the requests completed in the window over its
wall time, on the host's clock (not over summed latencies). The host paces
it, and its runs spread too widely on a shared host to be held to a bound,
so it is read here."""

from barqbench import window


def read(facts):
    reqs = facts["requests"]
    return window.qps(len(reqs), facts["window_s"]) if reqs and facts["window_s"] > 0 else None
