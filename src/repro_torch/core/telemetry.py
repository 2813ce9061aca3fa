"""Query-scoped telemetry, as in the reference package's ``core/telemetry.py``.

The paper chose vectorization over code generation because the operator
tree stays observable (§3.1). This module makes that observability
*query-scoped* instead of process-global, so a caller interleaving many
queries through one Engine can attribute every kernel dispatch, span and
buffer to exactly one query:

  KernelLedger   — dispatch counts and host seconds keyed by kernel name
                   and by (kernel, backend). One process-global instance
                   (``global_ledger()``); one per-query instance lives on
                   each QueryTrace.
  QueryTrace     — span recorder for the query lifecycle (parse → plan →
                   translate → execute), a per-query KernelLedger, and a
                   per-dispatch kernel event log. Exports Chrome-trace
                   JSON (``traceEvents``), which Perfetto opens.
  trace_query()  — contextvar scope installing a QueryTrace as the active
                   attribution target. Kernel dispatches recorded while a
                   trace is active land in BOTH the trace's ledger and
                   the process-global one.

The kernel wrappers (``repro_torch.kernels``) call ``record_dispatch``:
backend ``"cuda"`` once for every kernel launch (so a trace's ``"cuda"``
counts equal the launch counters' deltas over the query), backend
``"plain"`` once for every call that ran the plain version on CPU tensors.
The seconds are host time around the wrapper call (``perf_counter``); no
wrapper waits for the device to time itself, so a launch's seconds are the
cost of issuing it, not of running it.

The workload-history primitives:

  query_fingerprint()    — canonical sha256 template key over the parsed
                           algebra: literals and instantiated entity
                           constants normalize to typed placeholders,
                           variables to first-appearance indices, so the
                           template instances of BSBM-style traffic share
                           one key regardless of spelling.
  CardinalityFeedback    — per-plan-node observed cardinalities keyed by
                           the planner's stable node fingerprint. The
                           executor records actual row counts after each
                           drain; the planner (EngineConfig.
                           cardinality_feedback="apply") overrides its
                           estimates with the observed history.

Only the standard library is imported here at module scope: the kernel
modules import this one. The fingerprint walkers import
``repro_torch.core.algebra`` inside their bodies for the same reason.
"""

from __future__ import annotations

import collections
import hashlib
import json
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, List, Optional, Tuple


class KernelLedger:
    """Dispatch counts + host seconds for one attribution scope.

    ``wall_s`` is host time per kernel wrapper call (see the module
    docstring): what issuing the dispatches cost the host, not the time the
    device spent on them."""

    __slots__ = ("counts", "wall_s", "backend_counts", "backend_wall_s")

    def __init__(self, counts: Optional[collections.Counter] = None) -> None:
        # ``counts`` may be an externally owned Counter
        self.counts: collections.Counter = (
            collections.Counter() if counts is None else counts
        )
        self.wall_s: Dict[str, float] = collections.defaultdict(float)
        self.backend_counts: collections.Counter = collections.Counter()
        self.backend_wall_s: Dict[Tuple[str, str], float] = collections.defaultdict(
            float
        )

    def record(self, name: str, backend: str, dt: float) -> None:
        self.counts[name] += 1
        self.wall_s[name] += dt
        self.backend_counts[(name, backend)] += 1
        self.backend_wall_s[(name, backend)] += dt

    def merge(self, other: "KernelLedger") -> None:
        """Accumulate another ledger (many queries' ledgers into one)."""
        self.counts.update(other.counts)
        for k, v in other.wall_s.items():
            self.wall_s[k] += v
        self.backend_counts.update(other.backend_counts)
        for k, v in other.backend_wall_s.items():
            self.backend_wall_s[k] += v

    def total(self) -> int:
        return sum(self.counts.values())

    def total_wall_s(self) -> float:
        return sum(self.wall_s.values())

    def clear(self) -> None:
        self.counts.clear()
        self.wall_s.clear()
        self.backend_counts.clear()
        self.backend_wall_s.clear()

    def snapshot(self) -> dict:
        """JSON-able view: per-kernel counts and host milliseconds plus the
        per-backend breakdown keyed ``kernel/backend``."""
        return {
            "dispatches": dict(self.counts),
            "host_ms": {k: round(v * 1e3, 4) for k, v in self.wall_s.items()},
            "by_backend": {
                f"{n}/{b}": c for (n, b), c in sorted(self.backend_counts.items())
            },
            "by_backend_host_ms": {
                f"{n}/{b}": round(v * 1e3, 4)
                for (n, b), v in sorted(self.backend_wall_s.items())
            },
        }


# the process-global ledger: every dispatch lands here, traced or not
_GLOBAL_LEDGER = KernelLedger()

_ACTIVE_TRACE: "ContextVar[Optional[QueryTrace]]" = ContextVar(
    "repro_active_trace", default=None
)


def global_ledger() -> KernelLedger:
    return _GLOBAL_LEDGER


def current_trace() -> Optional["QueryTrace"]:
    """The QueryTrace installed for the current context, if any."""
    return _ACTIVE_TRACE.get()


def record_dispatch(name: str, backend: str, t0: float, dt: float) -> None:
    """Attribute one kernel dispatch: to the active query trace when one
    is installed, and always to the process-global ledger."""
    tr = _ACTIVE_TRACE.get()
    if tr is not None:
        tr.ledger.record(name, backend, dt)
        if tr.kernel_events:
            tr._kernels.append((name, backend, t0, dt))
    _GLOBAL_LEDGER.record(name, backend, dt)


@contextmanager
def trace_query(label: str = "query", trace: Optional["QueryTrace"] = None):
    """Install ``trace`` (or a fresh QueryTrace named ``label``) as the
    active attribution scope for the body of the ``with`` block; the
    previous scope comes back on exit, also on an exception."""
    tr = trace if trace is not None else QueryTrace(label)
    token = _ACTIVE_TRACE.set(tr)
    try:
        yield tr
    finally:
        _ACTIVE_TRACE.reset(token)


# Perfetto renders one horizontal lane per (pid, tid); we use three fixed
# lanes: query-lifecycle spans, kernel dispatches, operator tree.
_TID_QUERY, _TID_KERNELS, _TID_OPERATORS = 1, 2, 3


class QueryTrace:
    """Span + kernel-event recorder for one query execution."""

    def __init__(self, label: str = "query", kernel_events: bool = True) -> None:
        self.label = label
        self.kernel_events = kernel_events
        self.ledger = KernelLedger()
        self.t0 = time.perf_counter()
        # (name, category, start_s, dur_s, args) — start in perf_counter time
        self.spans: List[Tuple[str, str, float, float, dict]] = []
        # (kernel, backend, start_s, dur_s)
        self._kernels: List[Tuple[str, str, float, float]] = []
        # (label, depth, start_s, dur_s, args) — synthesized operator lane
        self._operators: List[Tuple[str, float, float, dict]] = []

    # -- recording ----------------------------------------------------------

    @contextmanager
    def span(self, name: str, cat: str = "query", **args):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.spans.append((name, cat, t0, time.perf_counter() - t0, args))

    def add_span(self, name: str, cat: str, t0: float, dur: float, **args) -> None:
        """Record an externally timed span (perf_counter timebase)."""
        self.spans.append((name, cat, t0, dur, args))

    def span_bounds(self, name: str) -> Optional[Tuple[float, float]]:
        for n, _cat, t0, dur, _a in self.spans:
            if n == name:
                return t0, dur
        return None

    def add_operator_tree(self, root, start: Optional[float] = None) -> None:
        """Synthesize the operator lane from the tree's post-hoc OpStats:
        each operator becomes one complete event whose duration is its
        inclusive wall_time, children laid out sequentially inside the
        parent's window (wall_time is self+children, so they nest)."""
        if start is None:
            bounds = self.span_bounds("execute")
            start = bounds[0] if bounds else self.t0

        def walk(op, t: float) -> None:
            s = op.stats
            args = {"results": s.results, "next_calls": s.next_calls}
            if getattr(s, "est_rows", None) is not None:
                args["est_rows"] = round(float(s.est_rows), 1)
            self._operators.append((f"{s.name}{s.detail}", t, s.wall_time, args))
            tc = t
            for c in op.children():
                walk(c, tc)
                tc += c.stats.wall_time

        walk(root, start)

    # -- export -------------------------------------------------------------

    def _us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def chrome_events(self) -> List[dict]:
        ev: List[dict] = []
        for tid, name in (
            (_TID_QUERY, "query"),
            (_TID_KERNELS, "kernels"),
            (_TID_OPERATORS, "operators"),
        ):
            ev.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
        for name, cat, t0, dur, args in self.spans:
            ev.append(
                {
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": self._us(t0),
                    "dur": dur * 1e6,
                    "pid": 1,
                    "tid": _TID_QUERY,
                    "args": dict(args),
                }
            )
        for kname, backend, t0, dur in self._kernels:
            ev.append(
                {
                    "name": kname,
                    "cat": "kernel",
                    "ph": "X",
                    "ts": self._us(t0),
                    "dur": dur * 1e6,
                    "pid": 1,
                    "tid": _TID_KERNELS,
                    "args": {"backend": backend},
                }
            )
        for label, t0, dur, args in self._operators:
            ev.append(
                {
                    "name": label,
                    "cat": "operator",
                    "ph": "X",
                    "ts": self._us(t0),
                    "dur": dur * 1e6,
                    "pid": 1,
                    "tid": _TID_OPERATORS,
                    "args": dict(args),
                }
            )
        return ev

    def to_chrome_trace(self) -> dict:
        """The chrome://tracing / Perfetto ``traceEvents`` document."""
        return {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": {"query": self.label},
        }

    def chrome_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_chrome_trace(), indent=indent)

    def save_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.chrome_json())

    def summary(self) -> dict:
        """Compact JSON-able digest: span durations + the kernel ledger."""
        return {
            "query": self.label,
            "spans_ms": {
                name: round(dur * 1e3, 4) for name, _c, _t, dur, _a in self.spans
            },
            "kernels": self.ledger.snapshot(),
        }


# ---------------------------------------------------------------------------
# query fingerprinting 
# ---------------------------------------------------------------------------

# Term classification for placeholder normalization. Terms are
# str | int | float (repro_torch.core.dictionary.Term): quoted strings are RDF
# literals, everything else stringy is an IRI/prefixed name.


def _term_class(term) -> str:
    if isinstance(term, bool) or isinstance(term, (int, float)):
        return "<num>"
    if isinstance(term, str) and term.startswith('"'):
        return "<str>"
    return "<iri>"


def canonical_var_map(node) -> Dict[int, int]:
    """Variable id -> canonical index by first appearance in a pre-order
    walk of the logical algebra. Two spellings of the same template get
    identical maps, so fingerprints (template and node) are independent
    of parser-assigned variable ids."""
    order: Dict[int, int] = {}

    def visit(vid: int) -> None:
        if vid not in order:
            order[vid] = len(order)

    for tok in _algebra_tokens(node, canon=None, on_var=visit):
        pass
    return order


def _algebra_tokens(node, canon: Optional[Dict[int, int]], on_var=None):
    """Token stream over the logical algebra: structure tags, canonical
    variables, kept IRI constants in predicate position, and typed
    placeholders for instantiated constants. ``canon=None`` emits raw var
    ids (used while *building* the canonical map); ``on_var`` observes
    every variable in pre-order."""
    from repro_torch.core import algebra as A

    def var_tok(vid: int) -> str:
        if on_var is not None:
            on_var(vid)
        return f"?{vid if canon is None else canon.get(vid, vid)}"

    def slot_tok(sl, keep: bool) -> str:
        if isinstance(sl, A.V):
            return var_tok(sl.id)
        return f"K:{sl.term}" if keep else _term_class(sl.term)

    def expr_toks(e):
        if e is None:
            return
        if isinstance(e, A.VarRef):
            yield var_tok(e.var)
        elif isinstance(e, A.Lit):
            yield _term_class(e.value)
        elif isinstance(e, A.Cmp):
            yield f"cmp:{e.op}("
            yield from expr_toks(e.lhs)
            yield from expr_toks(e.rhs)
            yield ")"
        elif isinstance(e, A.Arith):
            yield f"arith:{e.op}("
            yield from expr_toks(e.lhs)
            yield from expr_toks(e.rhs)
            yield ")"
        elif isinstance(e, (A.And, A.Or)):
            yield ("and(" if isinstance(e, A.And) else "or(")
            for t in e.terms:
                yield from expr_toks(t)
            yield ")"
        elif isinstance(e, A.Not):
            yield "not("
            yield from expr_toks(e.term)
            yield ")"
        elif isinstance(e, A.Bound):
            yield f"bound({var_tok(e.var)})"
        elif isinstance(e, A.Func):
            yield f"func:{e.name}("
            for a in e.args:
                yield from expr_toks(a)
            yield ")"
        else:
            yield f"expr:{type(e).__name__}"

    def pattern_toks(p):
        if isinstance(p, A.PathPattern):
            from repro_torch.core.paths.expr import path_repr

            yield "PATH("
            yield slot_tok(p.s, keep=False)
            yield path_repr(p.expr)
            yield slot_tok(p.o, keep=False)
            yield ")"
            return
        yield "TP("
        yield slot_tok(p.s, keep=False)
        # the predicate defines the template's structure; subjects and
        # objects are the instantiated entities that vary per instance
        yield slot_tok(p.p, keep=True)
        yield slot_tok(p.o, keep=False)
        if p.g is not None:
            yield slot_tok(p.g, keep=True)
        if p.path:
            yield f"path:{p.path}"
        yield ")"

    def walk(n):
        if isinstance(n, A.BGP):
            yield "BGP("
            for p in n.patterns:
                yield from pattern_toks(p)
            yield ")"
        elif isinstance(n, A.Filter):
            yield "FILTER("
            yield from expr_toks(n.expr)
            yield from walk(n.child)
            yield ")"
        elif isinstance(n, (A.Join, A.Minus, A.NotExists, A.Union)):
            yield f"{type(n).__name__.upper()}("
            yield from walk(n.left)
            yield from walk(n.right)
            yield ")"
        elif isinstance(n, A.LeftJoin):
            yield "LEFTJOIN("
            yield from walk(n.left)
            yield from walk(n.right)
            yield from expr_toks(n.expr)
            yield ")"
        elif isinstance(n, A.Extend):
            yield f"BIND({var_tok(n.var)}"
            yield from expr_toks(n.expr)
            yield from walk(n.child)
            yield ")"
        elif isinstance(n, A.Project):
            yield "PROJECT("
            for v in n.vars:
                yield var_tok(v)
            yield from walk(n.child)
            yield ")"
        elif isinstance(n, A.Distinct):
            yield "DISTINCT("
            yield from walk(n.child)
            yield ")"
        elif isinstance(n, A.GroupAgg):
            yield "GROUP("
            for v in n.group_vars:
                yield var_tok(v)
            for a in n.aggs:
                mod = "distinct " if a.distinct else ""
                av = var_tok(a.var) if a.var is not None else "*"
                yield f"agg:{mod}{a.func}({av})->{var_tok(a.out)}"
            yield from walk(n.child)
            yield from expr_toks(n.having)
            yield ")"
        elif isinstance(n, A.OrderBy):
            yield "ORDERBY("
            for k in n.keys:
                yield f"{var_tok(k.var)}:{'asc' if k.ascending else 'desc'}"
            yield from walk(n.child)
            yield ")"
        elif isinstance(n, A.Slice):
            yield f"SLICE({n.limit}:{n.offset}"
            yield from walk(n.child)
            yield ")"
        else:
            yield f"NODE:{type(n).__name__}"

    yield from walk(node)


def query_fingerprint(node) -> str:
    """Canonical sha256 template key over a parsed logical plan: literals
    and instantiated subject/object constants become typed placeholders,
    variables become first-appearance indices, whitespace never enters.
    Instances of one query template share a fingerprint."""
    canon = canonical_var_map(node)
    toks = list(_algebra_tokens(node, canon=canon))
    return hashlib.sha256("\x1f".join(toks).encode()).hexdigest()


# ---------------------------------------------------------------------------
# cardinality feedback store 
# ---------------------------------------------------------------------------


class CardinalityFeedback:
    """Observed per-plan-node cardinalities keyed by the planner's stable
    node fingerprint (planner.annotate_fingerprints).

    The executor records each operator's actual output rows after a full
    drain; estimates decay toward recent observations through an EWMA so
    data drift is tracked without unbounded history. ``version`` bumps on
    every record — plan caches fold it into their key under
    ``cardinality_feedback="apply"`` so a repeated query re-plans against
    fresh history instead of serving the stale shape.

    Lives in core (stdlib-only) because the Planner consults it."""

    __slots__ = ("alpha", "max_entries", "version", "_obs")

    def __init__(self, alpha: float = 0.5, max_entries: int = 4096) -> None:
        self.alpha = alpha
        self.max_entries = max_entries
        self.version = 0
        # node_fp -> [ewma_rows, n_observations]
        self._obs: Dict[str, List[float]] = {}

    def __len__(self) -> int:
        return len(self._obs)

    def record(self, node_fp: str, actual_rows: float) -> None:
        if not node_fp:
            return
        e = self._obs.get(node_fp)
        if e is None:
            if len(self._obs) >= self.max_entries:
                # bounded store: evict the least-observed fingerprint
                drop = min(self._obs, key=lambda k: self._obs[k][1])
                del self._obs[drop]
            self._obs[node_fp] = [float(actual_rows), 1]
        else:
            e[0] += self.alpha * (float(actual_rows) - e[0])
            e[1] += 1
        self.version += 1

    def lookup(self, node_fp: str) -> Optional[float]:
        e = self._obs.get(node_fp)
        return e[0] if e is not None else None

    def observations(self, node_fp: str) -> int:
        e = self._obs.get(node_fp)
        return int(e[1]) if e is not None else 0

    def snapshot(self) -> dict:
        """JSON-able state: {node_fp: [ewma_rows, n]}."""
        return {k: [round(v[0], 3), int(v[1])] for k, v in self._obs.items()}

    def merge(self, state: Dict[str, List[float]]) -> None:
        """Merge a persisted snapshot: existing entries combine by
        observation-count-weighted average (load order must not matter
        more than sample counts do)."""
        for fp, (rows, n) in state.items():
            n = max(int(n), 1)
            e = self._obs.get(fp)
            if e is None:
                if len(self._obs) >= self.max_entries:
                    drop = min(self._obs, key=lambda k: self._obs[k][1])
                    del self._obs[drop]
                self._obs[fp] = [float(rows), n]
            else:
                tot = e[1] + n
                e[0] = (e[0] * e[1] + float(rows) * n) / tot
                e[1] = tot
            self.version += 1
