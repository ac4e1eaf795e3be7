"""Batched serving runtime: prefill + decode with slot-based batching.

The counterpart of ``repro/runtime/server.py``.  A fixed pool of ``slots``
sequences decodes in lock-step (one `transformer.decode_step` per tick);
finished sequences free their slot and queued requests are prefilled into
it (continuous batching at slot granularity).  Sampling: greedy, or
temperature with an explicit ``torch.Generator`` (its draws differ from
``jax.random``'s, so only greedy runs can match the reference token for
token).  It serves every decoder-only configuration, MoE and phi-3-vision
(on its tokens alone, with no patch embeddings) included, as the
reference's does; it refuses an encoder-decoder configuration, which the
reference's cannot serve either (its prefill passes no frame embeddings).
A MoE model's decode tick routes all slots as one group, so a slot's tokens
can depend on the others' (the capacity is shared, as in the reference).

`Server.run` also returns the host time of each admission (prefill and
first sample) and of each tick (decode step and sample); both end in a
readback of the sampled tokens, so they time the device work too.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import transformer as TF


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class Server:
    def __init__(self, model, *, slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0):
        if model.cfg.enc_layers:
            raise ValueError(
                f"{model.cfg.name} is an encoder-decoder model: the slot "
                f"server prefills tokens alone, and the reference's Server "
                f"cannot serve it either (its prefill passes no "
                f"frontend_embeds); call transformer.prefill(..., "
                f"frontend_embeds=) and decode_step directly")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = TF.init_cache(self.cfg, slots, max_len,
                                   device=self.device)
        self.slot_req: list[Request | None] = [None] * slots
        self.positions = np.zeros((slots, 1), np.int32)
        self.tokens = np.zeros((slots, 1), np.int32)
        self.budget = np.zeros(slots, np.int32)

    # ------------------------------------------------------------------
    def _admit(self, queue: list[Request]):
        for s in range(self.slots):
            if self.slot_req[s] is None and queue:
                req = queue.pop(0)
                t0 = time.perf_counter()
                logits, cache1 = TF.prefill(
                    self.model, torch.as_tensor(
                        np.asarray(req.prompt)[None], device=self.device),
                    self.max_len)
                # splice the single-sequence cache into slot s (every leaf
                # is batch-major)
                for full, one in zip(self.cache, cache1):
                    for name, leaves in one.items():
                        for leaf, x in leaves.items():
                            dst = full[name][leaf]
                            dst[s:s + 1] = x.to(dst.dtype)
                nxt = int(self._sample(logits[:, 0])[0])
                self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
                self.slot_req[s] = req
                self.tokens[s, 0] = nxt
                self.positions[s, 0] = len(req.prompt)
                self.budget[s] = req.max_new - 1
                req.out.append(nxt)

    def _sample(self, logits):
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    # ------------------------------------------------------------------
    def run(self, requests: list[Request], max_ticks: int = 10_000) -> dict:
        queue = list(requests)
        self.prefill_ms: list[float] = []
        self.decode_ms: list[float] = []
        ticks = 0
        generated = 0
        while (queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self._admit(queue)
            if all(r is None for r in self.slot_req):
                break
            t0 = time.perf_counter()
            logits, self.cache = TF.decode_step(
                self.model, self.cache,
                torch.as_tensor(self.tokens, device=self.device),
                torch.as_tensor(self.positions, device=self.device))
            nxt = self._sample(logits[:, 0]).cpu().numpy()
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                generated += 1
                req.out.append(int(nxt[s]))
                self.tokens[s, 0] = int(nxt[s])
                self.positions[s, 0] += 1
                self.budget[s] -= 1
                if self.budget[s] <= 0 or \
                        self.positions[s, 0] >= self.max_len - 1:
                    req.done = True
                    self.slot_req[s] = None
            ticks += 1
        return {"ticks": ticks, "generated": generated,
                "prefill_ms": list(self.prefill_ms),
                "decode_ms": list(self.decode_ms)}
