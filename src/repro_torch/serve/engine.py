"""Continuous-batching serving engine.

Fixed pool of B decode slots over a shared stacked KV cache; requests
are admitted by prefilling (B=1) and splicing the resulting cache into a
free slot; every engine step decodes all live slots with per-slot
positions; finished sequences (EOS / max_new_tokens / a full cache)
retire and free their slot.  Supports the uniform-cache families (dense
/ moe / ssm; of these only dense is ported so far, and ``build_model``
refuses the others) — hybrid/encdec/vlm cache splicing differs per layout
and is served via the batch path instead.

Sampling: greedy, or temperature top-k from one ``torch.Generator``
seeded by ``seed`` (on the host, where the step's logits are read).
Everything runs under ``torch.inference_mode()`` on the device the
parameters live on (the CUDA device unless ``device`` says otherwise).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ServeEngine", "Request"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 40
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, params, *, slots: int = 4, cache_len: int = 256,
                 eos_id: int = -1, retrieval=None, seed: int = 0, device=None):
        assert model.cfg.family in ("dense", "moe", "ssm"), (
            "engine supports uniform-cache families; use the batch path "
            "for hybrid/encdec/vlm"
        )
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.retrieval = retrieval
        with torch.inference_mode():
            self.caches = model.init_cache(slots, cache_len, device=self.device)
        self.pos = np.zeros((slots,), np.int32)
        self.live: list[Request | None] = [None] * slots
        self.tokens = np.zeros((slots,), np.int32)
        self.rng = torch.Generator().manual_seed(seed)
        self.queue: list[Request] = []
        self._step = retrieval.decode if retrieval is not None else model.decode

    # ------------------------------------------------------------------ admin
    def submit(self, req: Request):
        self.queue.append(req)

    def _free_slot(self):
        for i, r in enumerate(self.live):
            if r is None:
                return i
        return None

    def _admit(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.queue.pop(0)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                     device=self.device)
            logits, _, cache1 = self.model.prefill(self.params, {"tokens": prompt},
                                                   cache_len=self.cache_len)
            tok = self._sample(logits[0].float().cpu().numpy(), req)
            # splice the (*, 1, S, ...) cache into slot `slot` (batch axis 1)
            for name, full in self.caches.items():
                full[:, slot:slot + 1] = cache1[name].to(full.dtype)
            self.pos[slot] = len(req.prompt)
            self.tokens[slot] = tok
            req.output.append(tok)
            self.live[slot] = req

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        vals, idx = torch.topk(torch.from_numpy(logits) / req.temperature, req.top_k)
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=self.rng)
        return int(idx[choice])

    # ------------------------------------------------------------------- step
    def step(self):
        """One engine iteration: admit -> decode all live slots -> retire."""
        with torch.inference_mode():
            self._admit()
            if not any(r is not None for r in self.live):
                return False
            tok = torch.as_tensor(self.tokens, device=self.device)
            pos = torch.as_tensor(self.pos, device=self.device)
            logits, _, self.caches = self._step(self.params, tok, self.caches, pos)
            logits = logits.float().cpu().numpy()
        for i, req in enumerate(self.live):
            if req is None:
                continue
            self.pos[i] += 1
            nxt = self._sample(logits[i], req)
            req.output.append(nxt)
            self.tokens[i] = nxt
            if (
                nxt == self.eos_id
                or len(req.output) >= req.max_new_tokens
                or self.pos[i] >= self.cache_len - 1
            ):
                req.done = True
                self.live[i] = None
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(r is not None for r in self.live)) and steps < max_steps:
            self.step()
            steps += 1
        return steps
