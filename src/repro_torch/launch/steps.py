"""Step builders (the reference's ``launch/steps.py``): (arch, shape, group)
-> the step function of that cell, shared by the trainer, the launcher and
the tests.

A ``StepBundle`` holds the function and a description. The reference also
carries abstract inputs and shardings for its dry run and ``jit``; on one
rank the port places nothing, and layouts across ranks (the LM shapes'
``zero_params`` / ``zero_opt``, DimeNet's ``gnn_impl="partitioned"``)
raise, naming slice 5e. Train steps are ``fn(params, opt, *inputs) ->
(params, opt, metrics)`` with the metrics as device scalars (``loss``,
``grad_norm``, ``lr``); gradients come from autograd, as the reference's
from ``jax.value_and_grad``. An LM trains on its parameters with the layers
stacked (``transformer.stack_layers``), the reference's tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF
from repro_torch.models.gnn import models as GNN
from repro_torch.models.recsys import dcn as DCN
from repro_torch.parallel.sharding import MeshAxes
from repro_torch.train.optimizer import OptimizerConfig, adamw_update
from repro_torch.train.tree import value_and_grad

# DimeNet static triplet budgets per shape
DIMENET_TRIPLET_CAP = {
    "full_graph_sm": 131072,
    "minibatch_lg": 1048576,
    "ogb_products": 4194304,
    "molecule": 32768,
}


@dataclasses.dataclass
class StepBundle:
    """The step of one (arch, shape) cell."""

    fn: Callable  # positional (state..., inputs...)
    description: str = ""


def _slice_5e(what: str):
    raise NotImplementedError(f"{what}: placing state across ranks comes with slice 5e of the "
                              "port")


def _train_step(loss_fn, opt_cfg: OptimizerConfig) -> Callable:
    vg = value_and_grad(loss_fn)

    def train_step(params, opt, *inputs):
        loss, grads = vg(params, *inputs)
        params, opt, metrics = adamw_update(opt_cfg, params, grads, opt)
        return params, opt, {"loss": loss, **metrics}

    return train_step


# ---------------------------------------------------------------------------
# LM steps
# ---------------------------------------------------------------------------


def _lm_bundle(arch: ArchConfig, shape_name: str, axes: MeshAxes,
               opt_cfg: Optional[OptimizerConfig] = None,
               model_override=None) -> StepBundle:
    sh = arch.shapes[shape_name]
    cfg: TF.TransformerConfig = model_override or arch.model
    if sh.get("window"):
        cfg = dataclasses.replace(cfg, window=sh["window"])
    for knob in ("unroll_layers", "seq_parallel", "microbatches", "remat"):
        if knob in sh:
            cfg = dataclasses.replace(cfg, **{knob: sh[knob]})
    if "moe_impl" in sh and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=sh["moe_impl"]))
    b, s = sh["global_batch"], sh["seq_len"]

    if sh["step"] == "train":
        if sh.get("zero_params") or sh.get("zero_opt"):
            _slice_5e(f"{arch.name} {shape_name}: ZeRO sharding of parameters or moments")
        opt_cfg = opt_cfg or OptimizerConfig()

        def train_step(params, opt, tokens, labels):
            loss, grads = TF.grads_fn(params, cfg, axes, tokens, labels)
            params, opt, metrics = adamw_update(opt_cfg, params, grads, opt)
            return params, opt, {"loss": loss, **metrics}

        return StepBundle(fn=train_step, description=f"train_step {cfg.name} B={b} S={s}")

    if sh["step"] == "prefill":
        def prefill_step(params, tokens):
            return TF.prefill(params, cfg, axes, tokens)

        return StepBundle(fn=prefill_step, description=f"serve_prefill {cfg.name} B={b} S={s}")

    # decode: one new token against a KV cache of seq_len (or the window)
    cache_len = min(s, sh.get("window") or s)

    def decode(params, cache, token, pos):
        return TF.decode_step(params, cfg, axes, cache, token, pos)

    return StepBundle(fn=decode, description=f"serve_decode {cfg.name} B={b} cache={cache_len}")


# ---------------------------------------------------------------------------
# GNN steps
# ---------------------------------------------------------------------------


def _pad512(n: int) -> int:
    """Round node/edge counts up to a multiple of 512 (padding rows are -1
    / masked), as the reference does for its meshes."""
    return int(-(-n // 512) * 512)


def _gnn_graph_shape(arch: ArchConfig, shape_name: str, model_cfg) -> GNN.GraphShape:
    sh = arch.shapes[shape_name]
    trip = DIMENET_TRIPLET_CAP.get(shape_name, 0) if model_cfg.kind == "dimenet" else 0
    if sh["step"] == "gnn_minibatch":
        b, (f1, f2) = sh["batch_nodes"], sh["fanouts"]
        n_nodes = b + b * f1 + b * f1 * f2
        n_edges = b * f1 + b * f1 * f2
        return GNN.GraphShape(_pad512(n_nodes), _pad512(n_edges), sh["d_feat"],
                              sh["n_classes"], trip)
    if sh["step"] == "gnn_molecule":
        nb = sh["batch"]
        return GNN.GraphShape(
            _pad512(sh["n_nodes"] * nb), _pad512(sh["n_edges"] * nb),
            sh["d_feat"], sh["n_classes"], trip, n_graphs=nb,
        )
    return GNN.GraphShape(_pad512(sh["n_nodes"]), _pad512(sh["n_edges"]),
                          sh["d_feat"], sh["n_classes"], trip)


def _gnn_bundle(arch: ArchConfig, shape_name: str, axes: MeshAxes,
                opt_cfg: Optional[OptimizerConfig] = None,
                model_override=None) -> StepBundle:
    cfg: GNN.GNNConfig = model_override or arch.model
    gshape = _gnn_graph_shape(arch, shape_name, cfg)
    if arch.shapes[shape_name].get("gnn_impl") == "partitioned" and cfg.kind == "dimenet":
        _slice_5e(f"{arch.name} {shape_name}: the edge-partitioned DimeNet loss")

    def loss_fn(params, graph):
        return GNN.loss(params, cfg, graph)

    return StepBundle(
        fn=_train_step(loss_fn, opt_cfg or OptimizerConfig()),
        description=f"gnn train_step {cfg.name} N={gshape.n_nodes} E={gshape.n_edges}",
    )


# ---------------------------------------------------------------------------
# RecSys steps
# ---------------------------------------------------------------------------


def _recsys_bundle(arch: ArchConfig, shape_name: str, axes: MeshAxes,
                   opt_cfg: Optional[OptimizerConfig] = None,
                   model_override=None) -> StepBundle:
    sh = arch.shapes[shape_name]
    cfg: DCN.DCNConfig = model_override or arch.model
    for knob in ("table_dtype", "qr_threshold"):
        if knob in sh:
            cfg = dataclasses.replace(cfg, **{knob: sh[knob]})
    b = sh["batch"]

    if sh["step"] == "recsys_train":
        def loss_fn(params, dense, sparse, labels):
            return DCN.loss_fn(params, cfg, axes, dense, sparse, labels)

        return StepBundle(fn=_train_step(loss_fn, opt_cfg or OptimizerConfig()),
                          description=f"dcn train_step B={b}")

    if sh["step"] == "recsys_serve":
        def serve(params, dense, sparse):
            with torch.no_grad():
                return torch.sigmoid(DCN.logits(params, cfg, axes, dense, sparse))

        return StepBundle(fn=serve, description=f"dcn serve B={b}")

    # retrieval: 1 query vs n_candidates
    nc = _pad512(sh["n_candidates"])

    def retrieve(params, dense, sparse, candidates):
        with torch.no_grad():
            return DCN.retrieval_scores(params, cfg, axes, dense, sparse, candidates)

    return StepBundle(fn=retrieve, description=f"dcn retrieval 1x{nc}")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def build_step(arch: ArchConfig, shape_name: str, mesh=None,
               opt_cfg: Optional[OptimizerConfig] = None,
               use_reduced: bool = False) -> StepBundle:
    """The step of ``arch`` at ``shape_name`` over ``mesh``, a process
    group (None: one rank); the reduced model with ``use_reduced``."""
    axes = MeshAxes.for_mesh(mesh)
    override = arch.reduced_model if use_reduced else None
    if arch.kind == "lm":
        return _lm_bundle(arch, shape_name, axes, opt_cfg, override)
    if arch.kind == "gnn":
        return _gnn_bundle(arch, shape_name, axes, opt_cfg, override)
    if arch.kind == "recsys":
        return _recsys_bundle(arch, shape_name, axes, opt_cfg, override)
    raise ValueError(arch.kind)
