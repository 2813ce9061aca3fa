"""Serving and front end: a request's latency minus its ``execute`` span
(``QueryTrace``), as a mean over the window's requests, in ms. What is left
is the server's plan cache, parsing, planning, translation and
bookkeeping."""


def read(facts):
    gaps = [r["latency_s"] - r["execute_s"] for r in facts["requests"]
            if r["execute_s"] is not None]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
