"""Model facade of the LM face: one API over every family.

    m = build_model(cfg)
    params = m.init(seed, device="cuda")     # a DecoderLM or EncDecLM
    loss, metrics = m.loss(params, batch)    # train
    cache = m.init_cache(batch, max_len, device="cuda")
    logits, cache = m.prefill(params, batch, cache)  # serving
    logits, cache = m.decode(params, cache, token, pos)

Ports ``src/repro/models/model.py``: ``batch`` is a dict with ``tokens``
and, for the VLM stub, ``patches`` or, for the audio stub, ``frames``.
``loss`` runs on the parameters' device (a numpy batch is moved there)
and carries gradients to every parameter that requires grad
(``train.loop`` differentiates it); ``init(..., dtype=torch.float32)``
stores fp32 parameters for training, as the reference's
``TrainConfig.param_dtype`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.sharding import collectives as coll

__all__ = ["Model", "build_model", "cross_entropy", "MOE_AUX_COEF"]

MOE_AUX_COEF = 0.01


def cross_entropy(logits, targets, *, ignore: int = -1, mesh=None):
    """logits (B,S,V) fp32; targets (B,S) int; mean over non-ignored.

    With ``mesh`` (a process mesh) ``logits`` is this process's block of
    the vocab over ``model`` (vocab-parallel): the log-sum-exp shifts by
    the max over ``model`` (no gradient), sums the exponentials over
    ``model``, and the gold logit comes from the process whose range
    holds the target (zero elsewhere), summed over ``model``; every
    process along ``model`` gets the same loss, and its cotangent is its
    block's."""
    logits = logits.float()
    tgt = torch.clamp_min(targets.long(), 0)
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    else:
        axes = ("model",)
        n = logits.shape[-1]
        m = coll.pmax(logits.amax(-1), mesh, axes)
        lse = m + torch.log(coll.psum(torch.sum(
            torch.exp(logits - m[..., None]), dim=-1), mesh, axes))
        local = tgt - mesh.axis_index(axes) * n
        own = (local >= 0) & (local < n)
        gold = torch.gather(logits, -1,
                            local.clamp(0, n - 1)[..., None])[..., 0]
        gold = coll.psum(torch.where(own, gold, 0.0), mesh, axes)
    nll = lse - gold
    mask = (targets != ignore).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "audio":
        return _build_encdec(cfg)
    return _build_decoder_only(cfg)


def _init_device(seed, device):
    """A generator draws on its own device; a seed on ``device``, the
    card unless given."""
    if device is None:
        return seed.device if isinstance(seed, torch.Generator) else "cuda"
    return device


def _on(params, batch) -> dict:
    """``batch``'s arrays as tensors on the parameters' device."""
    dev = next(params.parameters()).device
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _build_decoder_only(cfg: ModelConfig) -> Model:
    def init(seed=0, *, device=None, dtype=None, mesh=None):
        return transformer.init_params(cfg, seed,
                                       device=_init_device(seed, device),
                                       dtype=dtype, mesh=mesh)

    def loss(params, batch):
        batch = _on(params, batch)
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        prefix_embeds = batch.get("patches")
        logits, aux = transformer.train_forward(params, cfg, inputs,
                                                prefix_embeds=prefix_embeds)
        if prefix_embeds is not None:
            logits = logits[:, prefix_embeds.shape[1]:]
        ce = cross_entropy(logits, targets,
                           mesh=transformer.vocab_mesh(params))
        total = ce + MOE_AUX_COEF * aux["load_balance_loss"]
        return total, {"ce": ce, **aux}

    def init_cache(batch, max_len, dtype=torch.bfloat16, *, device="cuda"):
        return transformer.init_cache(cfg, batch, max_len, dtype,
                                      device=device)

    def prefill(params, batch, cache):
        return transformer.prefill(params, cfg, batch["tokens"], cache,
                                   prefix_embeds=batch.get("patches"))

    def decode(params, cache, token, pos):
        return transformer.decode_step(params, cfg, token, pos, cache)

    return Model(cfg, init, loss, init_cache, prefill, decode)


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(seed=0, *, device=None, dtype=None, mesh=None):
        return encdec.init_params(cfg, seed,
                                  device=_init_device(seed, device),
                                  dtype=dtype, mesh=mesh)

    def loss(params, batch):
        batch = _on(params, batch)
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits, aux = encdec.train_forward(params, cfg, inputs,
                                           batch["frames"])
        ce = cross_entropy(logits, targets, mesh=encdec.vocab_mesh(params))
        return ce, {"ce": ce, **aux}

    def init_cache(batch, max_len, dtype=torch.bfloat16, *, device="cuda"):
        return encdec.init_cache(cfg, batch, max_len, dtype, device=device)

    def prefill(params, batch, cache):
        return encdec.prefill(params, cfg, batch["tokens"], batch["frames"],
                              cache)

    def decode(params, cache, token, pos):
        return encdec.decode_step(params, cfg, token, pos, cache)

    return Model(cfg, init, loss, init_cache, prefill, decode)
