"""Decoder-only LM assembly: the dense-attention half of the reference.

Ports ``src/repro/models/transformer.py`` for the archs whose layers are
all ``("attn", "dense")`` in :func:`period_structure` (qwen2.5-3b,
internlm2-1.8b, phi3-medium-14b, command-r-plus-104b, internvl2-1b).  The
reference stacks each period slot's parameters ``(n_periods, ...)`` and
scans over depth; the port keeps one :class:`DecoderLayer` per layer in a
``ModuleList`` and loops.  Its ``shard_act`` constraints have no
counterpart (without a mesh they are no-ops, and the port has none).
``parallel_block``, ``layernorm``, ``gelu``, ``qk_norm``, ``qkv_bias``,
``tie_embeddings`` and ``prefix_embeds`` are kept.

Inference only: :func:`forward` (no remat), :func:`prefill` and
:func:`decode_step`.  The caches are written in place
(``models.attention``).  The mixers ``mla``, ``mamba`` and ``rwkv`` and
the ffn kinds ``moe`` and ``rwkv_cm`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Linear, Norm, _param, embed_init,
                                       init_linear, init_norm, matmul_f32,
                                       mlp_apply, mlp_init, norm_apply)

__all__ = ["period_structure", "check_supported", "DecoderLayer",
           "DecoderLM", "init_params", "forward", "hidden_states",
           "init_cache", "prefill", "decode_step"]

_QUEUE = "ROADMAP Queue 1, item 11: the rest of the LM face"


# --------------------------------------------------------------------------
# structure
# --------------------------------------------------------------------------

def period_structure(cfg: ModelConfig):
    """(prefix_kinds, period_kinds, n_periods): each kind is (mixer, ffn).

    mixer in {"attn", "mla", "mamba", "rwkv"}; ffn in {"dense", "moe",
    "rwkv_cm"}.
    """
    def kind(i):
        if cfg.rwkv is not None:
            return ("rwkv", "rwkv_cm")
        if cfg.mamba is not None and not cfg.is_attn_layer(i):
            mixer = "mamba"
        elif cfg.mla is not None:
            mixer = "mla"
        else:
            mixer = "attn"
        return (mixer, "moe" if cfg.is_moe_layer(i) else "dense")

    n_prefix = cfg.moe.dense_first_n if cfg.moe else 0
    prefix = [kind(i) for i in range(n_prefix)]
    period_len = max(cfg.attn_every, 1)
    if cfg.moe is not None:
        period_len = int(np.lcm(period_len, cfg.moe.every))
    body = cfg.n_layers - n_prefix
    if body % period_len != 0:
        raise ValueError(
            f"{cfg.name}: {body} body layers not divisible by period "
            f"{period_len}")
    period = [kind(n_prefix + i) for i in range(period_len)]
    return prefix, period, body // period_len


def layer_kinds(cfg: ModelConfig):
    """The (mixer, ffn) kind of every layer, in depth order."""
    prefix, period, n_periods = period_structure(cfg)
    return list(prefix) + list(period) * n_periods


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer is dense
    attention (and the model is decoder-only)."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            f"({_QUEUE})")
    other = sorted({k for k in layer_kinds(cfg) if k != ("attn", "dense")})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {other} are not ported yet ({_QUEUE}); "
            "the port serves ('attn', 'dense') stacks")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """``norm1``, ``attn`` (GQA), ``norm2`` (unless ``parallel_block``),
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, kind, *, dtype, device):
        super().__init__()
        if tuple(kind) != ("attn", "dense"):
            raise NotImplementedError(
                f"layer kind {kind} is not ported yet ({_QUEUE})")
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        if not cfg.parallel_block:
            self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = attn.GQA(cfg, dtype=dtype, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, dtype=dtype,
                       device=device)


class Embedding(nn.Module):
    """The token table ``(vocab, d)`` in the compute dtype."""

    def __init__(self, vocab: int, d: int, *, dtype, device):
        super().__init__()
        self.table = _param(vocab, d, dtype=dtype, device=device)


class DecoderLM(nn.Module):
    """``embed``, ``layers``, ``final_norm`` and, unless the embeddings
    are tied, ``unembed``; allocated uninitialised (:func:`init_params`
    draws the weights, ``load_state_dict`` takes converted ones)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype,
                               device=device)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)
        if not cfg.tie_embeddings:
            self.unembed = Linear(cfg.d_model, cfg.vocab_size, dtype=dtype,
                                  device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, k, dtype=dtype, device=device)
            for k in layer_kinds(cfg))


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> DecoderLM:
    """A :class:`DecoderLM` with the reference's initial distributions,
    drawn on ``device`` in the stored dtypes from ``torch.Generator``
    ``seed``."""
    m = DecoderLM(cfg, device=device)
    gen = torch.Generator(device=m.embed.table.device)
    gen.manual_seed(seed)
    embed_init(m.embed.table, gen)
    init_norm(m.final_norm)
    if not cfg.tie_embeddings:
        init_linear(m.unembed, gen, scale=1.0 / np.sqrt(cfg.d_model))
    for layer in m.layers:
        init_norm(layer.norm1)
        if not cfg.parallel_block:
            init_norm(layer.norm2)
        attn.gqa_init(layer.attn, gen)
        mlp_init(layer.mlp, gen)
    return m


# --------------------------------------------------------------------------
# forward (no cache)
# --------------------------------------------------------------------------

def _block_out(p: DecoderLayer, cfg, x, h, mix, compute_dtype):
    """The residual around the mixer's output ``mix`` (``h`` = norm1(x))
    and the MLP."""
    if cfg.parallel_block:
        # cohere-style: y = x + attn(n(x)) + ffn(n(x))
        return x + mix + mlp_apply(p.mlp, h, cfg.mlp, compute_dtype)
    x = x + mix
    h2 = norm_apply(p.norm2, x, cfg.norm)
    return x + mlp_apply(p.mlp, h2, cfg.mlp, compute_dtype)


def _apply_layer(p: DecoderLayer, cfg, x, positions, compute_dtype):
    h = norm_apply(p.norm1, x, cfg.norm)
    mix = attn.gqa_train(p.attn, cfg, h, positions, compute_dtype)
    return _block_out(p, cfg, x, h, mix, compute_dtype)


def _embed(params: DecoderLM, cfg, tokens, prefix_embeds, compute_dtype):
    x = params.embed.table[tokens.long()].to(compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(compute_dtype), x], dim=1)
    return x


def _positions(x):
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


@torch.no_grad()
def hidden_states(params: DecoderLM, cfg: ModelConfig, tokens, *,
                  prefix_embeds=None):
    """The final-normed hidden states (B, P+S, d) of :func:`forward`, whose
    logits at chosen positions are ``_unembed(params, cfg, h[:, idx])``."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    positions = _positions(x)
    for layer in params.layers:
        x = _apply_layer(layer, cfg, x, positions, compute_dtype)
    return norm_apply(params.final_norm, x, cfg.norm)


def forward(params: DecoderLM, cfg: ModelConfig, tokens, *,
            prefix_embeds=None):
    """tokens: (B, S) -> logits (B, P+S, vocab) fp32 and the reference's
    aux dict (a dense stack has no load-balance loss: 0).

    ``prefix_embeds`` (B, P, d) are prepended (VLM patch stub)."""
    x = hidden_states(params, cfg, tokens, prefix_embeds=prefix_embeds)
    logits = _unembed(params, cfg, x)
    return logits, {"load_balance_loss": torch.zeros((), device=x.device)}


# --------------------------------------------------------------------------
# caches / prefill / decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device="cuda"):
    """``{"layers": [{"k", "v"} per layer]}``, zeroed."""
    check_supported(cfg)
    device = resolve_device(device)
    return {"layers": [attn.init_gqa_cache(cfg, batch, max_len, dtype,
                                           device=device)
                       for _ in layer_kinds(cfg)]}


def _apply_layer_step(p: DecoderLayer, cfg, x, pos, cache, compute_dtype):
    """One-token decode through a single layer; returns (x, cache)."""
    h = norm_apply(p.norm1, x, cfg.norm)
    mix, cache = attn.gqa_decode(p.attn, cfg, h, pos, cache, compute_dtype)
    return _block_out(p, cfg, x, h, mix, compute_dtype), cache


def _apply_layer_prefill(p: DecoderLayer, cfg, x, positions, cache,
                         compute_dtype):
    h = norm_apply(p.norm1, x, cfg.norm)
    mix, cache = attn.gqa_prefill(p.attn, cfg, h, positions, cache,
                                  compute_dtype)
    return _block_out(p, cfg, x, h, mix, compute_dtype), cache


@torch.no_grad()
def prefill(params: DecoderLM, cfg: ModelConfig, tokens, cache, *,
            prefix_embeds=None):
    """Full-sequence pass filling every cache; returns (last_logits (B, 1,
    vocab) fp32, cache)."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    positions = _positions(x)
    for i, layer in enumerate(params.layers):
        x, cache["layers"][i] = _apply_layer_prefill(
            layer, cfg, x, positions, cache["layers"][i], compute_dtype)
    x = norm_apply(params.final_norm, x[:, -1:, :], cfg.norm)
    return _unembed(params, cfg, x), cache


def _unembed(params: DecoderLM, cfg, x):
    """Logits in fp32 from x in the compute dtype."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = x.to(compute_dtype)
    if cfg.tie_embeddings:
        return matmul_f32(x, params.embed.table.to(compute_dtype).t())
    return matmul_f32(x, params.unembed.w.to(compute_dtype))


@torch.no_grad()
def decode_step(params: DecoderLM, cfg: ModelConfig, token, pos, cache):
    """token: (B,) ids; pos: (B,) positions.  Returns (logits (B, vocab)
    fp32, cache)."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = params.embed.table[token.long()[:, None]].to(compute_dtype)
    for i, layer in enumerate(params.layers):
        x, cache["layers"][i] = _apply_layer_step(
            layer, cfg, x, pos, cache["layers"][i], compute_dtype)
    x = norm_apply(params.final_norm, x, cfg.norm)
    return _unembed(params, cfg, x)[:, 0], cache
