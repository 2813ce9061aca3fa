"""The plain reference: the BSBM generator (``data``) and an evaluator of
every query the mixes send (``bsbm``), found by the name a mix gives as
``"reference"``. It imports nothing of the program."""

import time
from typing import Dict, List, Optional

from barqbench.reference import bsbm

REFERENCE = {f"bsbm.{name}": getattr(bsbm, name)
             for name in ("q1", "q2", "q3", "q4", "q5", "q7", "q8", "q10", "q11")}


def answers(graph, requests, mix: dict, seconds: Optional[Dict[str, float]] = None) -> List[list]:
    """The reference's rows for each request (anything with ``name`` and
    ``consts``), each (query, constants) computed once; ``seconds``, where
    given, gathers the time spent on each query."""
    memo: Dict[tuple, list] = {}
    out = []
    for r in requests:
        key = (r.name, tuple(sorted(r.consts.items())))
        if key not in memo:
            fn = REFERENCE[mix["queries"][r.name]["reference"]]
            t0 = time.perf_counter()
            memo[key] = fn(graph, r.consts)
            if seconds is not None:
                seconds[r.name] = seconds.get(r.name, 0.0) + time.perf_counter() - t0
        out.append(memo[key])
    return out
