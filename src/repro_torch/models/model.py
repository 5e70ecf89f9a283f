"""Model facade of the LM face: one API over the decoder-only families.

    m = build_model(cfg)
    params = m.init(seed, device="cuda")             # a DecoderLM module
    cache = m.init_cache(batch, max_len, device="cuda")
    logits, cache = m.prefill(params, batch, cache)  # serving
    logits, cache = m.decode(params, cache, token, pos)

Ports ``src/repro/models/model.py`` for the serving half: ``batch`` is a
dict with ``tokens`` and, for the VLM stub, ``patches``.  ``loss`` and
``cross_entropy`` come with training, the encoder-decoder family later;
both raise ``NotImplementedError`` at :func:`build_model`, as does any
arch whose layers are not all dense attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

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
    transformer.check_supported(cfg)

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
    raise NotImplementedError(
        f"{cfg.name}: the encoder-decoder family is not ported yet (ROADMAP "
        "Queue 1, item 11: the rest of the LM face)")
