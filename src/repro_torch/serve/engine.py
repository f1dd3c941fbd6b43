"""Batched decode engine with continuous batching over a fixed slot pool.

Port of ``repro/serve/engine.py``.  ``B`` decode slots share one
stacked float32 cache; finished requests free their slot, queued
requests claim it (their prompt is prefilled token by token into the
slot's cache lane — chunked prefill).  Each tick is one ``decode_step``
across all slots, on ``device`` (the card unless the caller asks for the
CPU), and one device-to-host read: the (B,) next tokens.  A MoE model
adds its router's group-size reads (``models/moe.py``).

Greedy decoding takes the first maximum, as the reference's ``argmax``.
With ``temperature > 0`` the next token is drawn by the Gumbel-max rule
(the reference's ``jax.random.categorical``) from the engine's own
``torch.Generator`` seeded with ``seed``: the same distribution, not the
reference's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model import decode_step, init_decode_cache

__all__ = ["ServeRequest", "DecodeEngine"]


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    def __init__(self, cfg, params, *, slots: int = 8, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.B = slots
        self.max_len = max_len
        self.temperature = temperature
        self.device = torch.device(device)
        self.cache = init_decode_cache(cfg, slots, max_len,
                                       dtype=torch.float32,
                                       device=self.device)
        self.pos = np.zeros(slots, np.int64)
        self.slot_req: List[Optional[ServeRequest]] = [None] * slots
        self.pending: List[ServeRequest] = []
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def submit(self, req: ServeRequest):
        self.pending.append(req)

    # -- internals -----------------------------------------------------------
    def _admit(self):
        for s in range(self.B):
            if self.slot_req[s] is None and self.pending:
                req = self.pending.pop(0)
                self.slot_req[s] = req
                self.pos[s] = 0
                req._prefill_left = list(req.prompt)          # type: ignore

    def _sample(self, logits):
        if self.temperature > 0:
            u = torch.rand(logits.shape, generator=self.gen,
                           device=logits.device)
            gumbel = -torch.log(-torch.log(u))
            return torch.argmax(logits / self.temperature + gumbel, -1)
        return torch.argmax(logits, -1)

    def step(self) -> List[ServeRequest]:
        """One engine tick: admit, one fused decode step, collect."""
        self._admit()
        tokens = np.zeros(self.B, np.int64)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if req._prefill_left:                             # type: ignore
                tokens[s] = req._prefill_left.pop(0)          # type: ignore
            else:
                tokens[s] = req.output[-1] if req.output else \
                    (req.prompt[-1] if req.prompt else 0)
        logits, self.cache = decode_step(
            self.params, self.cfg, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.pos.copy()).to(self.device), self.cache)
        nxt = self._sample(logits).cpu().numpy()              # the host read

        finished = []
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.pos[s] += 1
            if req._prefill_left:                             # type: ignore
                continue                                       # still prefilling
            req.output.append(int(nxt[s]))
            if (len(req.output) >= req.max_new_tokens
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.slot_req[s] = None
        return finished

    def run(self, max_ticks: int = 10_000) -> List[ServeRequest]:
        done: List[ServeRequest] = []
        ticks = 0
        while (self.pending or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            done += self.step()
            ticks += 1
        return done
