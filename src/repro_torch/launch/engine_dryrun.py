"""Dry run of the engine's scale-out path: the distributed hash-exchange join
count (``core/distributed.py``'s ``make_join_count``) on the production
group sizes, as roofline terms for one rank.

    python -m repro_torch.launch.engine_dryrun [--edges 30] \\
        [--cap-factor 2.0] [--mesh single|multi|both] [--out DIR] [--tag T]

PyTorch cannot lower a program onto 256 or 512 placeholder ranks, so
nothing runs: the record accounts for one rank from the static shapes the
module sets (``shard_relation``'s block of ceil(n / P) columns,
``bucket_cap``'s ``ceil(n_local * cap_factor / P)`` rows a peer) over both
relations of (2, 2^edges) int32 rows:

  arguments    the two shards, 2 · C · n_local · 4 bytes;
  memory       the bytes each step reads and writes, every input read once
               and every output written once (``join_count_steps``);
  operations   hashing, the stable sorts (n · ceil(log2 n) comparisons
               each), the binary searches (two a query, ceil(log2(n + 1))
               steps each), the sums;
  collectives  the all-to-all buffers, (C + 1) · P · cap · 4 bytes a
               relation, and one all-reduce of two int64 counters;
  temporary    the send and receive buffers of both relations and the
               sorted keys and search results of the local join.

"single" is 256 ranks and "multi" 512, the reference's meshes; over more
than eight ranks the all-to-all is bound by the inter-node link
(``launch/roofline.py``). The record has the reference's schema, so
``launch/report.py`` renders both; ``compile_s`` has no counterpart and is
null.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, List, Tuple

from repro_torch.core.distributed import bucket_cap
from repro_torch.launch.roofline import link_bytes_per_s, roofline_terms

RANKS = {"single": 256, "multi": 512}
C = 2  # rows of each relation: the key and one payload column
I32, I64 = 4, 8


def _log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def exchange_steps(n: int, c: int, n_parts: int, cap: int) -> List[Tuple[str, int, int, int]]:
    """``(step, bytes read, bytes written, operations)`` of one relation's
    exchange on one rank: ``_bucket``, then the all-to-alls' copies."""
    slots = n_parts * cap
    return [
        ("radix_partition", I32 * n, I32 * n + I32 * n_parts, 4 * n),
        ("bucket starts", I32 * n_parts, I64 * n_parts, n_parts),
        ("stable sort of the pids", I32 * n, I64 * n, n * _log2(n)),
        ("position in the bucket", I64 * n + I32 * n + I64 * n_parts, I64 * n, 4 * n),
        ("scatter into the buffers", I64 * 2 * n + I32 * (c + 1) * n,
         I32 * (c + 1) * (slots + 1), 2 * n),
        ("transposes around the all-to-all", 2 * I32 * c * slots, 2 * I32 * c * slots, 0),
    ]


def join_count_steps(n_left: int, n_right: int, n_parts: int, cap_factor: float,
                     c: int = C) -> List[Tuple[str, int, int, int]]:
    """The steps of ``make_join_count``'s function on one rank whose shards
    hold ``n_left`` and ``n_right`` columns."""
    lcap = bucket_cap(n_left, cap_factor, n_parts)
    rcap = bucket_cap(n_right, cap_factor, n_parts)
    ls, rs = n_parts * lcap, n_parts * rcap
    steps = [(f"left {s}", *rest) for s, *rest in exchange_steps(n_left, c, n_parts, lcap)]
    steps += [(f"right {s}", *rest) for s, *rest in exchange_steps(n_right, c, n_parts, rcap)]
    steps += [
        ("sort the received keys", I32 * (ls + rs), (I32 + I64) * (ls + rs),
         ls * _log2(ls) + rs * _log2(rs)),
        ("sorted_search_range", I32 * (ls + rs), 2 * I32 * ls, 2 * ls * _log2(rs + 1)),
        ("masked sum", 3 * I32 * ls, I64, 3 * ls),
    ]
    return steps


def account(n_left: int, n_right: int, n_parts: int, cap_factor: float, c: int = C) -> Dict:
    """The cost, memory, collectives and roofline of one rank's join count
    (shards of ``n_left`` and ``n_right`` columns)."""
    lcap = bucket_cap(n_left, cap_factor, n_parts)
    rcap = bucket_cap(n_right, cap_factor, n_parts)
    ls, rs = n_parts * lcap, n_parts * rcap
    steps = join_count_steps(n_left, n_right, n_parts, cap_factor, c)
    flops = float(sum(s[3] for s in steps))
    moved = float(sum(s[1] + s[2] for s in steps))
    a2a = I32 * (c + 1) * (ls + rs)
    coll = {
        "per_kind_bytes": {"all-to-all": a2a, "all-reduce": 2 * I64},
        "per_kind_counts": {"all-to-all": 4, "all-reduce": 1},
        "total_bytes": a2a + 2 * I64,
    }
    return dict(
        cost=dict(flops_per_device=flops, bytes_per_device=moved),
        memory=dict(
            argument_bytes=I32 * c * (n_left + n_right),
            temp_bytes=2 * a2a + (I32 + I64) * (ls + rs) + 2 * I32 * ls,
        ),
        collectives=coll,
        roofline=roofline_terms(flops, moved, float(coll["total_bytes"]),
                                link_bytes_per_s(n_parts)),
        steps=[dict(step=s, read=r, written=w, ops=o) for s, r, w, o in steps],
    )


def run(log2_edges: int, cap_factor: float, multi_pod: bool, out_dir: str,
        tag: str = "") -> dict:
    mesh_name = "multi" if multi_pod else "single"
    n_ranks = RANKS[mesh_name]
    n_local = -(-(1 << log2_edges) // n_ranks)
    rec = dict(
        arch="barq-dist-join",
        shape=f"edges_2e{log2_edges}_cf{cap_factor}",
        mesh=mesh_name,
        status="ok",
        n_chips=n_ranks,
        compile_s=None,
        method="one rank, from repro_torch.core.distributed's static shapes; nothing ran",
        **account(n_local, n_local, n_ranks, cap_factor),
    )
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    with open(os.path.join(
            out_dir, f"barq-dist-join__{rec['shape']}__{mesh_name}{suffix}.json"),
            "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="roofline terms of the distributed join count")
    ap.add_argument("--edges", type=int, default=30, help="log2 edge count")
    ap.add_argument("--cap-factor", type=float, default=2.0)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for m in meshes:
        rec = run(args.edges, args.cap_factor, m == "multi", args.out, args.tag)
        rt = rec["roofline"]
        print(
            f"barq-dist-join 2^{args.edges} edges x {m} ({rec['n_chips']} ranks): "
            f"compute={rt['compute_s']:.3e}s memory={rt['memory_s']:.3e}s "
            f"collective={rt['collective_s']:.3e}s dominant={rt['dominant']}"
        )


if __name__ == "__main__":
    main()
