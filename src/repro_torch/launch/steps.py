"""Step builders (the reference's ``launch/steps.py``): (arch, shape, mesh)
-> one rank's step function of that cell, its abstract inputs and their
layouts, shared by the dry run, the trainer, the launcher and the tests.

A ``StepBundle`` holds the function, ``abstract_args`` (meta tensors at the
global shapes), ``in_shardings`` / ``out_shardings`` (trees of ``Spec``s
over the mesh: the reference's layouts, ``_zero_shard`` and
``_dp_batch_spec`` among them), ``donate_argnums`` and the ``MeshAxes``
whose tally counts the step's collectives. ``fn`` takes and returns this
rank's shards; on one rank (``mesh=None``) those are the whole tensors.
Train steps are ``fn(params, opt, *inputs) -> (params, opt, metrics)`` with
the metrics as device scalars (``loss``, ``grad_norm``, ``lr``); gradients
come from autograd, each leaf's summed over the ranks that hold the same
shard (``sharding.sync_grads``), as the reference's from
``jax.value_and_grad`` under its shardings. An LM trains on its parameters
with the layers stacked (``transformer.stack_layers``), the reference's
tree.

ZeRO (the LM shapes' knobs): ``zero_params`` (ZeRO-3) further splits the
parameters over dp on the first unsplit dimension that divides, and the
step all-gathers them at use (their gradients come back reduce-scattered);
``zero_opt`` (ZeRO-1) splits the moments so, and each rank updates its
slice of the parameters and all-gathers the result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF
from repro_torch.models.gnn import common as GC
from repro_torch.models.gnn import models as GNN
from repro_torch.models.recsys import dcn as DCN
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import MeshAxes, Spec, names_of
from repro_torch.train.optimizer import OptimizerConfig, adamw_update, global_norm, init_opt_state
from repro_torch.train.tree import leaves, tree_map, unflatten, value_and_grad

# DimeNet static triplet budgets per shape
DIMENET_TRIPLET_CAP = {
    "full_graph_sm": 131072,
    "minibatch_lg": 1048576,
    "ogb_products": 4194304,
    "molecule": 32768,
}


@dataclasses.dataclass
class StepBundle:
    """Everything the dry run and the trainer need for one (arch, shape)
    cell."""

    fn: Callable  # positional (state..., inputs...), this rank's shards
    abstract_args: Tuple[Any, ...] = ()  # meta tensors at the global shapes
    in_shardings: Tuple[Any, ...] = ()  # spec trees matching abstract_args
    out_shardings: Any = None
    donate_argnums: Tuple[int, ...] = ()
    description: str = ""
    axes: MeshAxes = dataclasses.field(default_factory=MeshAxes)

    def local_args(self) -> Tuple[Any, ...]:
        """Meta tensors at this rank's shard shapes of ``abstract_args``;
        raises, naming the leaf, where a layout does not divide."""
        return tuple(_local_meta(a, s, self.axes)
                     for a, s in zip(self.abstract_args, self.in_shardings))


def _local_meta(tree, specs, axes: MeshAxes):
    out = [torch.empty(SH.shard_shape(x.shape, s, axes, n), dtype=x.dtype, device="meta")
           for n, x, s in SH.spec_leaves(specs, tree)]
    return unflatten(tree, out)


def _replicated(tree):
    return tree_map(lambda x: Spec(*([None] * x.dim())), tree)


def _checked(fn: Callable, abstract_args, in_shardings, axes: MeshAxes) -> Callable:
    """``fn`` refusing arguments that are not this rank's shards (over more
    than one rank; one rank takes any shape, as the reference's smoke
    mesh does)."""
    if axes.world == 1:
        return fn
    want = [leaves(_local_meta(a, s, axes)) for a, s in zip(abstract_args, in_shardings)]

    def run(*args):
        for i, (arg, w) in enumerate(zip(args, want)):
            for j, (x, m) in enumerate(zip(leaves(arg), w)):
                if tuple(x.shape) != tuple(m.shape):
                    raise ValueError(f"argument {i} leaf {j}: a local {tuple(x.shape)} is not "
                                     f"this rank's shard {tuple(m.shape)}")
        return fn(*args)

    return run


def _zero_shard(spec_tree, abs_tree, axes: MeshAxes):
    """ZeRO: additionally split each leaf over the dp axes on the first
    unsplit dimension whose size divides the dp degree (a leaf already split
    over dp stays as it is)."""
    dp_entry = axes.resolve("dp")
    dp_size = axes.size(dp_entry)
    dp_names = set(axes.dp)

    def one(s: Spec, a) -> Spec:
        entries = list(s) + [None] * (a.dim() - len(s))
        for e in entries:
            if any(n in dp_names for n in names_of(e)):
                return s
        for i, (e, dim) in enumerate(zip(entries, a.shape)):
            if e is None and dim % dp_size == 0 and dim > 0:
                entries[i] = dp_entry
                return Spec(*entries)
        return s

    return unflatten(spec_tree, [one(s, a) for s, a in zip(leaves(spec_tree), leaves(abs_tree))])


def _dp_batch_spec(axes: MeshAxes, batch: int, *rest) -> Spec:
    """Split the batch over dp only when it divides; replicate it otherwise
    (batch-1 long-context decode)."""
    dp = axes.resolve("dp")
    return Spec(dp if batch % axes.size(dp) == 0 else None, *rest)


def _changed_dims(fine: Spec, coarse: Spec, ndim: int):
    """(dimension, entry) where ``fine`` splits a dimension ``coarse``
    leaves whole."""
    out = []
    for d, (f, c) in enumerate(zip(fine.padded(ndim), coarse.padded(ndim))):
        if f != c:
            if c is not None:
                raise ValueError(f"{fine!r} does not refine {coarse!r}")
            out.append((d, f))
    return out


def _gather_to(tree, fine, coarse, axes: MeshAxes):
    """Leaves laid out by ``fine`` all-gathered to ``coarse`` (with
    gradients reduce-scattered back)."""
    out = []
    for x, f, c in zip(leaves(tree), leaves(fine), leaves(coarse)):
        for d, e in _changed_dims(f, c, x.dim()):
            x = SH.all_gather(x, axes, e, d)
        out.append(x)
    return unflatten(tree, out)


def _narrow_to(tree, fine, coarse, axes: MeshAxes):
    """This rank's block under ``fine`` of leaves laid out by ``coarse``."""
    out = []
    for x, f, c in zip(leaves(tree), leaves(fine), leaves(coarse)):
        for d, e in _changed_dims(f, c, x.dim()):
            n = x.shape[d] // axes.size(e)
            x = x.narrow(d, axes.index(e) * n, n)
        out.append(x)
    return unflatten(tree, out)


def _apply_update(opt_cfg: OptimizerConfig, params, grads, opt, pspecs, mspecs,
                  axes: MeshAxes):
    """AdamW on this rank's shards: the global norm over the mesh, then
    the update on the moments' blocks (ZeRO-1: a slice of the parameters,
    all-gathered after)."""
    gnorm = global_norm(grads, axes, pspecs)
    if mspecs is pspecs:
        return adamw_update(opt_cfg, params, grads, opt, gnorm=gnorm)
    p_sl = _narrow_to(params, mspecs, pspecs, axes)
    g_sl = _narrow_to(grads, mspecs, pspecs, axes)
    new_sl, opt, metrics = adamw_update(opt_cfg, p_sl, g_sl, opt, gnorm=gnorm)
    return _gather_to(new_sl, mspecs, pspecs, axes), opt, metrics


def _optimizer_step(grads_of: Callable, opt_cfg: OptimizerConfig, pspecs, mspecs,
                    axes: MeshAxes, loss_entry) -> Callable:
    """A train step: ``grads_of(params, *inputs) -> (loss share, grads)``,
    the gradients summed over the ranks that hold each shard, AdamW, and the
    loss shares summed over ``loss_entry``."""
    def train_step(params, opt, *inputs):
        loss, grads = grads_of(params, *inputs)
        grads = SH.sync_grads(grads, pspecs, axes)
        params, opt, metrics = _apply_update(opt_cfg, params, grads, opt, pspecs, mspecs, axes)
        return params, opt, {"loss": SH.all_reduce(loss, axes, loss_entry), **metrics}

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
    base = TF.param_specs(cfg, axes)
    params_abs = TF.param_shapes(cfg)
    zero3 = bool(sh.get("zero_params")) and sh["step"] == "train"
    pspecs = _zero_shard(base, params_abs, axes) if zero3 else base
    tok = _dp_batch_spec(axes, b, None)
    # the program's axes: whether its batch is split over dp
    paxes = dataclasses.replace(axes, batch_split=tok[0] is not None)
    i32 = torch.int32

    def meta(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if sh["step"] == "train":
        opt_cfg = opt_cfg or OptimizerConfig()
        mspecs = _zero_shard(pspecs, params_abs, axes) if sh.get("zero_opt") else pspecs
        opt_specs = {"mu": mspecs, "nu": mspecs, "step": Spec()}
        prepare = (lambda p: _gather_to(p, pspecs, base, axes)) if zero3 else None

        def grads_of(params, tokens, labels):
            return TF.grads_fn(params, cfg, paxes, tokens, labels, prepare)

        step = _optimizer_step(grads_of, opt_cfg, pspecs, mspecs, axes, axes.resolve("dp"))
        args = (params_abs, init_opt_state(params_abs), meta(b, s), meta(b, s))
        ins = (pspecs, opt_specs, tok, tok)
        return StepBundle(
            fn=_checked(step, args, ins, axes), abstract_args=args, in_shardings=ins,
            out_shardings=(pspecs, opt_specs, None), donate_argnums=(0, 1),
            description=f"train_step {cfg.name} B={b} S={s}", axes=axes,
        )

    logits_spec = Spec(tok[0], None, axes.mp)
    if sh["step"] == "prefill":
        def prefill_step(params, tokens):
            with torch.no_grad():
                return TF.prefill(params, cfg, paxes, tokens)

        args, ins = (params_abs, meta(b, s)), (pspecs, tok)
        return StepBundle(
            fn=_checked(prefill_step, args, ins, axes), abstract_args=args, in_shardings=ins,
            out_shardings=(logits_spec, TF.cache_specs(axes)),
            description=f"serve_prefill {cfg.name} B={b} S={s}", axes=axes,
        )

    # decode: one new token against a KV cache of seq_len (or the window)
    cache_len = min(s, sh.get("window") or s)
    cache_specs = TF.cache_specs(axes)
    if b == 1:  # batch-1 long-context: no dp split of the batch
        cache_specs = {"k": Spec(None, None, axes.mp, None, None),
                       "v": Spec(None, None, axes.mp, None, None),
                       "pos": Spec(None, None, axes.mp)}

    def decode(params, cache, token, pos):
        with torch.no_grad():
            return TF.decode_step(params, cfg, paxes, cache, token, pos)

    args = (params_abs, TF.cache_shapes(cfg, b, cache_len), meta(b, 1), meta(b, 1))
    ins = (pspecs, cache_specs, tok, tok)
    return StepBundle(
        fn=_checked(decode, args, ins, axes), abstract_args=args, in_shardings=ins,
        out_shardings=(logits_spec, cache_specs), donate_argnums=(1,),
        description=f"serve_decode {cfg.name} B={b} cache={cache_len}", axes=axes,
    )


# ---------------------------------------------------------------------------
# GNN steps
# ---------------------------------------------------------------------------


def _pad512(n: int) -> int:
    """Round node/edge counts up to a multiple of 512 so every split
    dimension divides both production meshes (padding rows are -1 /
    masked)."""
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
    params_abs = GNN.param_shapes(cfg, gshape)
    pspecs = _replicated(params_abs)
    opt_specs = {"mu": pspecs, "nu": pspecs, "step": Spec()}
    gabs = GNN.graph_input_shapes(gshape)
    every = axes.resolve("dp+mp")  # node/edge rows over every mesh axis
    partitioned = (arch.shapes[shape_name].get("gnn_impl") == "partitioned"
                   and cfg.kind == "dimenet")

    def graph_spec(k, v):
        if partitioned and k not in GNN.EDGE_KEYS:
            return Spec(*([None] * v.dim()))  # replicated
        return Spec(every, *([None] * (v.dim() - 1)))

    gspecs = {k: graph_spec(k, v) for k, v in gabs.items()}
    if partitioned:
        def loss_fn(params, graph):
            return GNN.dimenet_loss_partitioned(params, cfg, graph, axes, every)
    else:
        shards = GC.Shards(axes, every)

        def loss_fn(params, graph):
            return GNN.loss(params, cfg, graph, shards)

    step = _optimizer_step(value_and_grad(loss_fn), opt_cfg or OptimizerConfig(), pspecs,
                           pspecs, axes, axes.names)
    args, ins = (params_abs, init_opt_state(params_abs), gabs), (pspecs, opt_specs, gspecs)
    return StepBundle(
        fn=_checked(step, args, ins, axes), abstract_args=args, in_shardings=ins,
        out_shardings=(pspecs, opt_specs, None), donate_argnums=(0, 1),
        description=f"gnn train_step {cfg.name} N={gshape.n_nodes} E={gshape.n_edges}",
        axes=axes,
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
    params_abs = DCN.param_shapes(cfg)
    pspecs = DCN.param_specs(cfg, axes)
    dense_abs = torch.empty((b, cfg.n_dense), dtype=torch.float32, device="meta")
    sparse_abs = torch.empty((b, cfg.n_sparse), dtype=torch.int32, device="meta")
    bspec = _dp_batch_spec(axes, b, None)

    if sh["step"] == "recsys_train":
        opt_specs = {"mu": pspecs, "nu": pspecs, "step": Spec()}

        def loss_fn(params, dense, sparse, labels):
            return DCN.loss_fn(params, cfg, axes, dense, sparse, labels)

        step = _optimizer_step(value_and_grad(loss_fn), opt_cfg or OptimizerConfig(), pspecs,
                               pspecs, axes, axes.names)
        args = (params_abs, init_opt_state(params_abs), dense_abs, sparse_abs,
                torch.empty((b,), dtype=torch.int32, device="meta"))
        ins = (pspecs, opt_specs, bspec, bspec, _dp_batch_spec(axes, b))
        return StepBundle(
            fn=_checked(step, args, ins, axes), abstract_args=args, in_shardings=ins,
            out_shardings=(pspecs, opt_specs, None), donate_argnums=(0, 1),
            description=f"dcn train_step B={b}", axes=axes,
        )

    if sh["step"] == "recsys_serve":
        def serve(params, dense, sparse):
            with torch.no_grad():
                return torch.sigmoid(DCN.logits(params, cfg, axes, dense, sparse))

        args, ins = (params_abs, dense_abs, sparse_abs), (pspecs, bspec, bspec)
        return StepBundle(fn=_checked(serve, args, ins, axes), abstract_args=args,
                          in_shardings=ins, out_shardings=Spec(bspec[0]),
                          description=f"dcn serve B={b}", axes=axes)

    # retrieval: 1 query vs n_candidates
    nc = _pad512(sh["n_candidates"])
    cand_abs = torch.empty((nc, cfg.mlp_dims[-1]), dtype=torch.float32, device="meta")

    def retrieve(params, dense, sparse, candidates):
        with torch.no_grad():
            return DCN.retrieval_scores(params, cfg, axes, dense, sparse, candidates)

    args = (params_abs, dense_abs, sparse_abs, cand_abs)
    ins = (pspecs, Spec(None, None), Spec(None, None), Spec(axes.resolve("dp+mp"), None))
    return StepBundle(fn=_checked(retrieve, args, ins, axes), abstract_args=args,
                      in_shardings=ins, out_shardings=None,
                      description=f"dcn retrieval 1x{nc}", axes=axes)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def build_step(arch: ArchConfig, shape_name: str, mesh=None,
               opt_cfg: Optional[OptimizerConfig] = None,
               use_reduced: bool = False) -> StepBundle:
    """The step of ``arch`` at ``shape_name`` over ``mesh`` (a
    ``DeviceMesh`` with the production dimension names, or None for one
    rank); the reduced model with ``use_reduced``."""
    axes = MeshAxes.for_mesh(mesh)
    override = arch.reduced_model if use_reduced else None
    if arch.kind == "lm":
        return _lm_bundle(arch, shape_name, axes, opt_cfg, override)
    if arch.kind == "gnn":
        return _gnn_bundle(arch, shape_name, axes, opt_cfg, override)
    if arch.kind == "recsys":
        return _recsys_bundle(arch, shape_name, axes, opt_cfg, override)
    raise ValueError(arch.kind)
