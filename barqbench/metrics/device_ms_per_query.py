"""Device: the card's busy time a query, in ms: the union of the device's
intervals over the probe's profiled rounds (the same requests in every run,
served after the window), over the requests in them."""


def read(facts):
    t = facts["timeline"]
    if not t or t.queries <= 0 or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / t.queries
