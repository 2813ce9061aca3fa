"""Continuous-batching LM decode service (the reference's
``serve/lm_server.py``): the engine's adaptive batch sizer reused for
serving admission.

A fixed pool of batch slots runs the decode step on the device; finished
requests free their slots; queued requests are admitted between steps.
The admission quantum is an ``AdaptiveBatchSizer`` watching the service's
occupancy the way a BARQ scan watches its consumer: bursts of arrivals
grow it, droughts shrink it (keeping admission work — prefill — small when
the pool is latency-bound).

The server casts every matmul weight to bfloat16 once, when it is built
(``transformer.for_serving``): the value the reference's cast at each use
gives, so the tokens do not change. Each step reads its next tokens back
from the device with one copy, its one host sync; admission reads one
token a request. Tokens and positions go up from pinned memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptiveBatchSizer
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.parallel.sharding import MeshAxes


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class LMServer:
    def __init__(self, cfg: TF.TransformerConfig, params, n_slots: int = 8,
                 cache_len: int = 256, seed: int = 0, device=None):
        """``params`` on ``device`` (None is the CUDA card)."""
        self.device = resolve_device(device)
        if params["embed"]["table"].device != self.device:
            raise ValueError(f"LMServer: the parameters are on "
                             f"{params['embed']['table'].device}, not {self.device}")
        self.cfg = dataclasses.replace(cfg, remat="none")
        self.params = TF.for_serving(params)
        self.axes = MeshAxes()
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.cache = TF.init_cache(self.cfg, n_slots, cache_len, self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int32)
        self.queue: List[Request] = []
        self.sizer = AdaptiveBatchSizer(initial=2, min_size=1,
                                        max_size=n_slots)
        self.steps = 0

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the device; on the card from pinned memory
        without waiting (a pageable copy would be a host sync)."""
        t = torch.from_numpy(x)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _decode(self, toks: np.ndarray, poss: np.ndarray) -> torch.Tensor:
        t, p = self._upload(toks), self._upload(poss)
        with torch.inference_mode():
            logits, self.cache = TF.decode_step(self.params, self.cfg, self.axes,
                                                self.cache, t, p)
        return logits

    # -- client API -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run_until_drained(self, max_steps: int = 10000) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        while (self.queue or any(r is not None for r in self.slot_req)):
            self.step(out)
            if self.steps > max_steps:
                raise RuntimeError("serving did not drain")
        return out

    # -- engine ------------------------------------------------------------------

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free or not self.queue:
            if not self.queue:
                self.sizer.on_skip()  # drought: shrink the admission quantum
            return
        quantum = self.sizer.on_next()
        for slot in free[:quantum]:
            if not self.queue:
                break
            req = self.queue.pop(0)
            self.slot_req[slot] = req
            # per-slot prefill through the shared decode step; the final
            # feed's logits produce the first generated token
            logits = None
            for t, tok in enumerate(req.prompt.tolist()):
                logits = self._step_one_slot(slot, tok, t)
            self.slot_pos[slot] = len(req.prompt)
            req.generated.append(int(torch.argmax(logits[slot, 0])))

    def _step_one_slot(self, slot: int, token: int, pos: int) -> torch.Tensor:
        toks = np.zeros((self.n_slots, 1), np.int32)
        # non-target rows write to the reserved dump slot: pos = -1 maps to
        # cache index cache_len-1 (never used by live positions, see
        # _retire's cache_len-1 bound) and stores pos=-1 = invalid
        poss = np.full((self.n_slots, 1), -1, np.int32)
        toks[slot, 0] = token
        poss[slot, 0] = pos
        return self._decode(toks, poss)

    def step(self, out: Dict[int, List[int]]) -> None:
        self._admit()
        self._retire(out)  # admission may already satisfy max_new == 1
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        toks = np.zeros((self.n_slots, 1), np.int32)
        poss = np.full((self.n_slots, 1), -1, np.int32)  # inactive -> dump slot
        for i in active:
            req = self.slot_req[i]
            toks[i, 0] = req.generated[-1]
            poss[i, 0] = self.slot_pos[i]
        logits = self._decode(toks, poss)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32).cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            req.generated.append(int(nxt[i]))
            self.slot_pos[i] += 1
        self._retire(out)
        self.steps += 1

    def _retire(self, out: Dict[int, List[int]]) -> None:
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if len(req.generated) >= req.max_new or self.slot_pos[i] >= self.cache_len - 1:
                req.done = True
                out[req.rid] = req.generated[: req.max_new]
                self.slot_req[i] = None
                self.slot_pos[i] = 0
                # invalidate the slot's cache so the next tenant cannot
                # attend to stale keys
                self.cache["pos"][:, i, :] = -1
