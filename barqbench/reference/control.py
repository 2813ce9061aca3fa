"""The control: the reference put in the program's place with one of the
configuration's guarantees broken, and judged as the program's answers are.

The explore mix states no precision that its answers could lose (they are
terms, not sums), so its control breaks the guarantee that each answer is
exact for its own request: every request is answered with the answer to
the first request of its template, as a result cache keyed by the
template without its constants would.

Run at a cell's size (NumPy only; no card is needed)::

    python3 -m barqbench.reference.control --workload <cell> --seeds 1 2 3 [--rounds N]

prints the compared numbers for each seed, for the requests of the first N
rounds a run would send.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List

from barqbench import judge as J
from barqbench import traffic
from barqbench.reference import answers, data


def control_answers(graph, requests, mix: dict) -> List[list]:
    exact = answers(graph, requests, mix)
    first = {}
    return [first.setdefault(r.name, a) for r, a in zip(requests, exact)]


def readings(graph, mix: dict, seed_mix: int, rounds: int, seconds=None) -> dict:
    """The checks of the control's answers against the reference's over the
    first ``rounds`` rounds of a run's stream (warm-up rounds skipped)."""
    stream = traffic.rounds(mix, graph.meta, seed_mix)
    for _ in range(mix["warmup_rounds"]):
        next(stream)
    reqs = [r for _ in range(rounds) for r in next(stream)]
    exact = answers(graph, reqs, mix, seconds=seconds)
    ctl = control_answers(graph, reqs, mix)
    return J.judge(list(zip([r.name for r in reqs], ctl)), exact, mix["queries"],
                   J.ranker(graph))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control's readings at a cell's size")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (w,) = [c for c in bench["workloads"] if c["name"] == args.workload]
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "barqbench" / "mixes" / f"{w['traffic']}.json").read_text())
    for seed in args.seeds:
        t0 = time.perf_counter()
        data_seed, mix_seed = traffic.seeds(seed, 2)
        graph = data.graph_for(config, data_seed)
        t_gen = time.perf_counter() - t0
        ref_s = {}
        checks = readings(graph, mix, mix_seed, args.rounds, ref_s)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": checks,
                          "requests": args.rounds * sum(q.get("count", 1)
                                                        for q in mix["queries"].values()),
                          "limits": mix["limits"], "seconds": time.perf_counter() - t0,
                          "generate_s": t_gen, "reference_s": ref_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
