"""Device: 1 minus the union of the device's intervals over the profiled
rounds' host window (a fraction)."""


def read(facts):
    t = facts["timeline"]
    if not t or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
