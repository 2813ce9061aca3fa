"""Serving, whole requests: the 95th percentile of the window's request
latencies (host clock around ``QueryServer.execute``), in ms. A window of
a few rounds holds too few requests for a steady tail, so it is read here
and not held to a bound."""

from barqbench import window


def read(facts):
    lat = [r["latency_s"] for r in facts["requests"]]
    return window.p95_ms(lat) if lat else None
