"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains an architecture's REDUCED config end to end on the card (or the
CPU with ``--device cpu``) with the full substrate: the step of
``launch/steps.py``, AdamW, asynchronous checkpointing, restart and
resume, the straggler watchdog. One rank stands for the reference's
smoke mesh. ``main`` trains at a cut shape (an LM at batch 8 x 128
tokens, DCN at batch 256, GNN graphs of a few hundred nodes) so that a
run takes seconds; ``run`` takes any ``override_shape``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.device import resolve_device
from repro_torch.launch.steps import _gnn_graph_shape, build_step
from repro_torch.models import transformer as TF
from repro_torch.models.gnn import models as GNN
from repro_torch.models.recsys import dcn as DCN
from repro_torch.pipeline.data import recsys_batch, token_batch
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainer import Trainer, TrainerConfig

TRAIN_STEPS = ("train", "gnn_full", "gnn_minibatch", "gnn_molecule", "recsys_train")


def _make_batch_fn(arch, shape_name, seed, reduced_model, dev):
    sh = arch.shapes[shape_name]

    def on(a):
        return torch.from_numpy(a).to(dev)

    if arch.kind == "lm":
        b, s = sh["global_batch"], sh["seq_len"]

        def fn(step):
            d = token_batch(seed, step, b, s, reduced_model.vocab)
            return (on(d["tokens"]), on(d["labels"]))

        return fn
    if arch.kind == "gnn":
        gshape = _gnn_graph_shape(arch, shape_name, reduced_model)

        def fn(step):
            return (GNN.make_graph_inputs(gshape, rng_seed=seed + step, device=dev),)

        return fn
    b, cfg = sh["batch"], reduced_model

    def fn(step):
        d = recsys_batch(seed, step, b, cfg.n_dense, cfg.n_sparse,
                         [cfg.table_rows(i) for i in range(cfg.n_sparse)])
        return (on(d["dense"]), on(d["sparse"]), on(d["labels"]))

    return fn


def init_state(arch, shape_name, seed, dev):
    """(params, AdamW state) of the reduced model, drawn from ``seed``."""
    reduced = arch.reduced_model
    if arch.kind == "lm":
        params = TF.stack_layers(TF.init_params(reduced, seed, device=dev))
    elif arch.kind == "gnn":
        params = GNN.init(seed, reduced, _gnn_graph_shape(arch, shape_name, reduced), dev)
    else:
        params = DCN.init_params(reduced, seed, device=dev)
    return (params, init_opt_state(params))


def run(arch_id: str, shape_name: str, steps: int, ckpt_dir: str,
        seed: int = 0, lr: float = 3e-4, log_every: int = 10,
        override_shape: dict = None, device=None):
    """Train ``arch_id``'s reduced model for ``steps`` steps at
    ``shape_name`` (its fields updated by ``override_shape``) on
    ``device`` (None is the CUDA card), checkpointing into ``ckpt_dir``
    and resuming from its latest checkpoint. Returns (result, trainer)."""
    dev = resolve_device(device)
    arch = get_config(arch_id)
    if override_shape:
        shapes = dict(arch.shapes)
        shapes[shape_name] = {**shapes[shape_name], **override_shape}
        arch = dataclasses.replace(arch, shapes=shapes)
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    bundle = build_step(arch, shape_name, None, opt_cfg, use_reduced=True)
    batch_fn = _make_batch_fn(arch, shape_name, seed, arch.reduced_model, dev)

    def train_step(state, batch):
        params, opt, metrics = bundle.fn(*state, *batch)
        return (params, opt), metrics

    trainer = Trainer(
        TrainerConfig(total_steps=steps, ckpt_every=max(steps // 4, 10),
                      ckpt_dir=ckpt_dir, log_every=log_every),
        train_step,
        lambda: init_state(arch, shape_name, seed, dev),
        batch_fn,
    )
    return trainer.run(), trainer


def smoke_override(arch, shape: str):
    """The shape cut that keeps a launcher run to seconds."""
    step = arch.shapes[shape]["step"]
    if arch.kind == "lm":
        return {"global_batch": 8, "seq_len": 128}
    if arch.kind == "recsys":
        return {"batch": 256}
    if step == "gnn_full":
        return {"n_nodes": 512, "n_edges": 2048, "d_feat": 32, "n_classes": 8}
    if step == "gnn_minibatch":
        return {"batch_nodes": 32, "fanouts": (5, 3), "d_feat": 32, "n_classes": 8}
    return {"batch": 8}  # gnn_molecule


def main():
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args()
    arch = get_config(args.arch)
    shape = args.shape or next(s for s, v in arch.shapes.items() if v["step"] in TRAIN_STEPS)
    result, trainer = run(args.arch, shape, args.steps, args.ckpt_dir, args.seed, args.lr,
                          override_shape=smoke_override(arch, shape), device=args.device)
    print("final:", result)
    losses = [m["loss"] for m in trainer.metrics_history]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")


if __name__ == "__main__":
    main()
