"""Serve a SPARQL request stream through the engine:

    python -m repro_torch.launch.serve --requests N --scale S \\
        [--engine barq|legacy|mixed] [--device cpu]

Generates the BSBM e-commerce store and the LSQB social graph at scale S on
the device (the CUDA card unless ``--device cpu``), builds a stream of N
requests with ``build_requests`` from seed 0 (80% BSBM explore point
lookups, mixed with LSQB counts) and serves it through one ``QueryServer``
per store. The first tenth of the stream (at most 10 requests) warms the
plan caches and the buffer arenas and is left out of the summary, which
carries the reference's ``run_workload`` keys. ``kernel_wall_ms`` is host
time inside the kernel wrappers, on the card the time to enqueue the
launches.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.executor import EngineConfig
from repro_torch.data import (
    BSBM_EXPLORE_TEMPLATES,
    LSQB_QUERIES,
    generate_ecommerce_graph,
    generate_social_graph,
    instantiate_explore,
)
from repro_torch.serve.query_server import QueryServer, workload_stats

# the LSQB queries a stream cycles through: subgraph counts over joins with
# SIP (q4, q5) and the plain star (q1)
LSQB_CYCLE = ("q1", "q4", "q5")


def build_requests(meta, n: int, seed: int, lsqb_share: float = 0.2,
                   lsqb: Tuple[str, ...] = LSQB_CYCLE,
                   queries: Optional[Dict[str, str]] = None) -> List[Tuple[str, str, str]]:
    """``n`` requests ``(key, text, store)``: ``round(n * lsqb_share)`` of
    them queries on the social graph cycling through ``lsqb`` (store
    ``"lsqb"``; their texts from ``queries``, by default ``LSQB_QUERIES``)
    at positions drawn from ``seed``, the rest BSBM explore instances
    (templates and constants drawn from ``seed``, store ``"bsbm"``) on the
    e-commerce store described by ``meta``."""
    queries = LSQB_QUERIES if queries is None else queries
    rng = np.random.RandomState(seed)
    n_lsqb = int(round(n * lsqb_share))
    lsqb_at = set(rng.permutation(n)[:n_lsqb].tolist())
    templates = sorted(BSBM_EXPLORE_TEMPLATES.items())
    out, k = [], 0
    for i in range(n):
        if i in lsqb_at:
            q = lsqb[k % len(lsqb)]
            k += 1
            out.append((f"lsqb_{q}", queries[q], "lsqb"))
        else:
            name, tpl = templates[rng.randint(len(templates))]
            out.append((f"explore_{name}", instantiate_explore(tpl, meta, rng), "bsbm"))
    return out


def serve_stream(servers: Dict[str, QueryServer], requests, warmup: int = 0):
    """Serve ``requests`` (``build_requests``' triples) in order, each on
    the server of its store. Returns ``(stats, results)``: the reference's
    ``run_workload`` summary over the requests after the first ``warmup``,
    and every request's ``RequestResult``, warm-up included."""
    results = [servers[store].execute(key, text) for key, text, store in requests]
    return workload_stats(results[warmup:]), results


def serve_queries(requests: int, scale: float, engine: str = "barq", device=None) -> dict:
    shop, meta = generate_ecommerce_graph(scale=scale, device=device)
    social, _ = generate_social_graph(scale=scale, device=device)
    servers = {
        "bsbm": QueryServer(shop, EngineConfig(engine=engine), device=device),
        "lsqb": QueryServer(social, EngineConfig(engine=engine), device=device),
    }
    stream = build_requests(meta, requests, 0)
    stats, _ = serve_stream(servers, stream, warmup=min(10, requests // 10))
    print(f"device: {servers['bsbm'].engine.device}")
    print("query serving:", stats)
    return stats


def main() -> None:
    ap = argparse.ArgumentParser(description="serve a SPARQL request stream")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--engine", choices=("barq", "legacy", "mixed"), default="barq")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args()
    serve_queries(args.requests, args.scale, args.engine, args.device)


if __name__ == "__main__":
    main()
