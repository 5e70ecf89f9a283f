"""Model facade of the LM face: one API over every family.

    m = build_model(cfg)
    params = m.init(seed, device="cuda")     # a DecoderLM or EncDecLM
    cache = m.init_cache(batch, max_len, device="cuda")
    logits, cache = m.prefill(params, batch, cache)  # serving
    logits, cache = m.decode(params, cache, token, pos)

Ports ``src/repro/models/model.py`` for the serving half: ``batch`` is a
dict with ``tokens`` and, for the VLM stub, ``patches`` or, for the audio
stub, ``frames``.  ``loss`` and ``cross_entropy`` come with training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "audio":
        return _build_encdec(cfg)
    return _build_decoder_only(cfg)


def _build_decoder_only(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, *, device="cuda"):
        return transformer.init_params(cfg, seed, device=device)

    def init_cache(batch, max_len, dtype=torch.bfloat16, *, device="cuda"):
        return transformer.init_cache(cfg, batch, max_len, dtype,
                                      device=device)

    def prefill(params, batch, cache):
        return transformer.prefill(params, cfg, batch["tokens"], cache,
                                   prefix_embeds=batch.get("patches"))

    def decode(params, cache, token, pos):
        return transformer.decode_step(params, cfg, token, pos, cache)

    return Model(cfg, init, init_cache, prefill, decode)


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(seed: int = 0, *, device="cuda"):
        return encdec.init_params(cfg, seed, device=device)

    def init_cache(batch, max_len, dtype=torch.bfloat16, *, device="cuda"):
        return encdec.init_cache(cfg, batch, max_len, dtype, device=device)

    def prefill(params, batch, cache):
        return encdec.prefill(params, cfg, batch["tokens"], batch["frames"],
                              cache)

    def decode(params, cache, token, pos):
        return encdec.decode_step(params, cfg, token, pos, cache)

    return Model(cfg, init, init_cache, prefill, decode)
