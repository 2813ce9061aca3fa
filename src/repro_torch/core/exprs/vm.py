"""Expression VM executor on the device.

``prepare_inputs`` builds a program's input block from a batch: int32 code
columns, trinary predicate columns (each predicate evaluated once per
dictionary entry into a cached table, then broadcast to rows with one
gather) and float64 numeric decodes through the dictionary's numeric
side-array. The program itself runs in the ``expr_eval`` kernel. The value
plane is float64, as on the reference's default numpy backend.

The numeric side-array and the predicate tables live on the device, cached
on the dictionary and extended as the dictionary grows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batch import ColumnBatch
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.exprs import bytecode as B
from repro_torch.core.exprs import terms as T
from repro_torch.kernels.expr_eval import expr_eval


def predicate_table(d: Dictionary, spec: B.TableSpec) -> np.ndarray:
    """Host trinary int32 table of ``spec`` over every dictionary entry."""
    cache: Dict[B.TableSpec, np.ndarray] = d.__dict__.setdefault("_pred_tables", {})
    table = cache.get(spec)
    n = len(d)
    if table is None or len(table) < n:
        fn = T.term_predicate(spec.func, spec.args)
        lo = 0 if table is None else len(table)
        ext = np.fromiter(
            (fn(d.decode(i)) for i in range(lo, n)), dtype=np.int32, count=n - lo
        )
        table = ext if table is None else np.concatenate([table, ext])
        cache[spec] = table
    return table


def _device_cached(d: Dictionary, key, device: torch.device, host_fn) -> torch.Tensor:
    """A device copy of a per-dictionary-entry array, rebuilt when the
    dictionary has grown since it was made."""
    cache: Dict = d.__dict__.setdefault("_device_tables", {})
    ent = cache.get((key, device))
    if ent is None or ent[0] != len(d):
        ent = (len(d), torch.from_numpy(host_fn()).to(device))
        cache[(key, device)] = ent
    return ent[1]


def numeric_table(d: Dictionary, device: torch.device) -> torch.Tensor:
    """float64 (n_terms,) numeric side-array on ``device`` (NaN = non-numeric)."""
    return _device_cached(d, "numeric", device, d.numeric_array)


def numeric_of(d: Dictionary, codes: torch.Tensor) -> torch.Tensor:
    """float64 numeric values of ``codes`` (NaN for NULL / non-numeric)."""
    table = numeric_table(d, codes.device)
    if table.shape[0] == 0:
        return torch.full(codes.shape, float("nan"), dtype=torch.float64, device=codes.device)
    vals = table[codes.clamp(min=0).long()]
    return torch.where(codes >= 0, vals, float("nan"))


def prepare_inputs(
    prog: B.ExprProgram, batch: ColumnBatch, d: Optional[Dictionary]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(icols int32 (KI, n), fcols float64 (KF, n)) for a batch's filled
    prefix; inactive rows produce values the caller's mask discards."""
    n = batch.n_rows
    dev = batch.device
    ki = max(prog.n_icols, 1)
    kf = max(prog.n_fcols, 1)
    icols = torch.zeros((ki, n), dtype=torch.int32, device=dev)
    for i, var in enumerate(prog.code_vars):
        icols[i] = batch.column(var)
    for j, spec in enumerate(prog.tables):
        if d is None:
            raise ValueError("dictionary required for term predicates")
        table = _device_cached(d, spec, dev, lambda: predicate_table(d, spec))
        codes = batch.column(spec.var)
        if table.shape[0]:
            icols[len(prog.code_vars) + j] = table[codes.clamp(min=0).long()]
    fcols = torch.full((kf, n), float("nan"), dtype=torch.float64, device=dev)
    for i, var in enumerate(prog.num_vars):
        if d is None:
            raise ValueError("dictionary required for value expressions")
        fcols[i] = numeric_of(d, batch.column(var))
    return icols, fcols


def eval_program_mask(
    prog: B.ExprProgram, batch: ColumnBatch, d: Optional[Dictionary] = None
) -> torch.Tensor:
    """FILTER semantics: capacity-sized bool mask, True where the program
    evaluates to (three-valued) true; error rows are excluded."""
    icols, fcols = prepare_inputs(prog, batch, d)
    val, err = expr_eval(prog, icols, fcols)
    m = torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
    m[: batch.n_rows] = (val != 0) & ~err
    return m


def eval_program_values(
    prog: B.ExprProgram, batch: ColumnBatch, d: Dictionary
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BIND semantics: (float64 values, valid) over the filled prefix."""
    icols, fcols = prepare_inputs(prog, batch, d)
    val, err = expr_eval(prog, icols, fcols)
    return val, ~err
