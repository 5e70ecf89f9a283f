"""Batched serving engine of the LM face: prefill waves + greedy decode.

Ports ``src/repro/serve/engine.py`` with the same wave semantics: up to
``slots`` requests are admitted at once, left-aligned and padded to the
longest; the first token comes from the logits of the last padded
position; the slots then decode greedily in lockstep, each stopping at
``eos_id``; the loop reads the tokens to the host once per step and syncs
nowhere else.

The KV cache is allocated (zeroed) once and **updated in place** by every
wave: prefill overwrites rows ``[0, S)``, each decode step row ``pos``,
and the rows past a slot's position that an earlier wave left are masked
to ``exp(-1e30 - m) = 0``, so a second :meth:`BatchServer.serve` of the
same wave gives the same tokens.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.model import Model

__all__ = ["BatchServer", "ServeStats"]


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchServer:
    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 eos_id: int = 0, extra_inputs: dict | None = None,
                 device="cuda"):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.extra = extra_inputs or {}
        self.device = resolve_device(device)
        self._cache = model.init_cache(
            slots, max_len, dtype=getattr(torch, model.cfg.dtype),
            device=self.device)

    def _pad_batch(self, requests: Sequence[Sequence[int]]):
        assert len(requests) <= self.slots
        lens = [len(r) for r in requests]
        s = max(lens)
        toks = np.zeros((self.slots, s), np.int64)
        for i, r in enumerate(requests):
            toks[i, :len(r)] = r  # left-aligned; tail padding
        return torch.from_numpy(toks).to(self.device)

    @torch.no_grad()
    def serve(self, requests: Sequence[Sequence[int]], *,
              max_new_tokens: int = 32) -> tuple[list[list[int]], ServeStats]:
        """Greedy-decode a wave of requests; returns per-request outputs."""
        stats = ServeStats()
        tokens = self._pad_batch(requests)
        batch = {"tokens": tokens, **self.extra}
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, batch, self._cache)
        _sync(self.device)
        stats.prefill_s = time.perf_counter() - t0

        # wave semantics: all requests share the padded prefix length
        prefix = tokens.shape[1]
        n_prefix_embeds = getattr(self.model.cfg, "n_prefix_embeds", 0) \
            if "patches" in self.extra else 0
        pos = torch.full((self.slots,), prefix + n_prefix_embeds,
                         dtype=torch.int64, device=self.device)
        tok = torch.argmax(logits[:, -1] if logits.dim() == 3 else logits,
                           dim=-1).reshape(self.slots)

        outs: list[list[int]] = [[] for _ in range(self.slots)]
        done = np.zeros(self.slots, bool)
        t0 = time.perf_counter()
        for _ in range(max_new_tokens):
            tok_np = tok.cpu().numpy()   # the loop's one host read
            for i in range(len(requests)):
                if not done[i]:
                    outs[i].append(int(tok_np[i]))
                    if tok_np[i] == self.eos_id:
                        done[i] = True
                    else:
                        stats.tokens_out += 1
            if done[:len(requests)].all():
                break
            logits, cache = self.model.decode(self.params, cache, tok, pos)
            tok = torch.argmax(logits, dim=-1)
            pos = pos + 1
        _sync(self.device)
        stats.decode_s = time.perf_counter() - t0
        return [outs[i] for i in range(len(requests))], stats
