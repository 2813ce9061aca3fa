"""Kernels: the ten ported kernels' device time, by their names
(``tracing.PORTED_KERNELS``), over all device-busy time in the profiled
rounds (a fraction)."""


def read(facts):
    t = facts["timeline"]
    if not t or t.busy_s <= 0:
        return None
    return t.ported_s / t.busy_s
