"""Fault-tolerant training loop (the reference's ``train/trainer.py``).

  * checkpoint/restart — CheckpointManager saves every ``ckpt_every``
    steps (async); on (re)start the trainer restores the latest complete
    checkpoint and the data pipeline fast-forwards (step-keyed seeds,
    nothing to replay);
  * preemption — SIGTERM/SIGINT trigger a final synchronous save before
    exit (handlers are installed from the main thread only);
  * straggler/hang watchdog — a step exceeding ``watchdog_factor`` × the
    trailing median is logged with its factor;
  * crash-retry — transient step failures retry from the last checkpoint
    up to ``max_restarts`` times (``fault_hook`` injects them in tests).

A step's metrics (device scalars) come to the host in one copy, the
step's one host read. A state split over a mesh passes its
``state_shardings`` (the ``MeshAxes`` and the state's tree of ``Spec``s):
checkpoints then hold the full arrays and restore re-shards them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.train.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_ckpts: int = 3
    log_every: int = 10
    watchdog_factor: float = 3.0
    max_restarts: int = 2


def host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The metrics as Python floats, read from the device in one copy."""
    names = list(metrics)
    vals = [torch.as_tensor(metrics[k]).detach().to(torch.float32).reshape(()) for k in names]
    if not vals:
        return {}
    dev = vals[0].device
    return dict(zip(names, torch.stack([v.to(dev) for v in vals]).tolist()))


class Trainer:
    """Drives train_step(state, batch) -> (state, metrics)."""

    def __init__(
        self,
        cfg: TrainerConfig,
        train_step: Callable,
        init_state: Callable[[], Any],
        batches: Callable[[int], Any],  # step -> batch (deterministic, resumable)
        state_shardings=None,
        fault_hook: Optional[Callable[[int], None]] = None,
    ):
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.train_step = train_step
        self.init_state = init_state
        self.batches = batches
        self.fault_hook = fault_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        self._preempted = False
        self.step_times: list = []
        self.metrics_history: list = []
        self.state: Any = None  # the state after the last step taken

    # -- preemption ------------------------------------------------------------

    def _install_signal_handlers(self):
        def handler(signum, frame):
            log.warning("preemption signal %s received; checkpointing", signum)
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not the main thread (tests)

    # -- main loop ------------------------------------------------------------

    def _restore_or_init(self):
        latest = self.ckpt.latest_step()
        state = self.init_state()
        if latest is not None:
            state, manifest = self.ckpt.restore(latest, state, self.state_shardings)
            log.info("restored checkpoint at step %d", latest)
            return state, int(manifest["step"])
        return state, 0

    def run(self) -> Dict[str, Any]:
        self._install_signal_handlers()
        restarts = 0
        while True:
            try:
                return self._run_once()
            except KeyboardInterrupt:
                raise
            except Exception as e:  # transient failure -> restart from ckpt
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                log.warning("step failed (%s); restart %d/%d from checkpoint",
                            e, restarts, self.cfg.max_restarts)

    def _run_once(self) -> Dict[str, Any]:
        state, start_step = self._restore_or_init()
        last_metrics: Dict[str, Any] = {}
        for step in range(start_step, self.cfg.total_steps):
            if self.fault_hook is not None:
                self.fault_hook(step)  # test-injected failures
            t0 = time.perf_counter()
            batch = self.batches(step)
            state, metrics = self.train_step(state, batch)
            self.state = state
            last_metrics = host_metrics(metrics)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            self._watchdog(step, dt)
            self.metrics_history.append({"step": step + 1, **last_metrics})
            if (step + 1) % self.cfg.log_every == 0:
                log.info("step %d: %s (%.3fs)", step + 1, last_metrics, dt)
            if (step + 1) % self.cfg.ckpt_every == 0 or self._preempted:
                self.ckpt.save(step + 1, state, shardings=self.state_shardings)
                if self._preempted:
                    self.ckpt.wait()
                    log.warning("exiting after preemption checkpoint at %d", step + 1)
                    return {"step": step + 1, "preempted": True, **last_metrics}
        self.ckpt.save(self.cfg.total_steps, state, shardings=self.state_shardings)
        self.ckpt.wait()
        return {"step": self.cfg.total_steps, "preempted": False, **last_metrics}

    def _watchdog(self, step: int, dt: float) -> None:
        hist = self.step_times[-50:-1]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.cfg.watchdog_factor * med:
                log.warning(
                    "straggler watchdog: step %d took %.3fs (%.1fx median %.3fs)",
                    step, dt, dt / med, med,
                )
