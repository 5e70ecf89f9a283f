"""Decoder-only LM assembly: every layer kind of the reference.

Ports ``src/repro/models/transformer.py``.  A layer is a ``(mixer, ffn)``
kind from :func:`period_structure`: mixer ``attn`` (GQA), ``mla``,
``mamba`` or ``rwkv``; ffn ``dense``, ``moe`` or ``rwkv_cm``.  An arch is
an optional dense prefix stack (DeepSeek-V3's first three layers) and a
repeating period (Jamba: one attention layer in eight, MoE every other
layer).  The reference stacks each period slot's parameters ``(n_periods,
...)`` and scans over depth; the port keeps one :class:`DecoderLayer` per
layer, prefix first, in a ``ModuleList`` and loops.  Its ``shard_act``
constraints have no counterpart (without a mesh they are no-ops, and the
port has none).  ``parallel_block``, ``layernorm``, ``gelu``, ``qk_norm``,
``qkv_bias``, ``tie_embeddings`` and ``prefix_embeds`` are kept.

Inference only: :func:`forward` (no remat; its aux holds the summed MoE
``load_balance_loss``), :func:`prefill` and :func:`decode_step`.  The
caches are written in place; a prefill starts every row at position 0,
so a recurrent layer's state starts from zero whatever the cache held.
The encoder-decoder family is :mod:`repro_torch.models.encdec`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (MLP, Linear, Norm, _param, embed_init,
                                       init_linear, init_norm, matmul_f32,
                                       mlp_apply, mlp_init, norm_apply)

__all__ = ["period_structure", "layer_kinds", "DecoderLayer", "DecoderLM",
           "Embedding", "init_params", "forward", "hidden_states",
           "init_cache", "prefill", "decode_step"]


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


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """``norm1``, ``norm2`` (unless ``parallel_block``), the mixer
    (``attn``: GQA or MLA, ``mamba`` or ``rwkv``, whose parameters also
    hold the channel mix) and the ffn (``mlp`` or ``moe``)."""

    def __init__(self, cfg: ModelConfig, kind, *, dtype, device):
        super().__init__()
        mixer, ffn = self.kind = tuple(kind)
        kw = dict(dtype=dtype, device=device)
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        if not cfg.parallel_block:
            self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
        if mixer == "attn":
            self.attn = attn.GQA(cfg, **kw)
        elif mixer == "mla":
            self.attn = attn.MLA(cfg, **kw)
        elif mixer == "mamba":
            self.mamba = mam.Mamba(cfg, **kw)
        else:
            self.rwkv = rwkv_mod.RWKV(cfg, **kw)
        if ffn == "dense":
            ff = (cfg.moe.dense_ff if (cfg.moe and cfg.moe.dense_ff)
                  else cfg.d_ff)
            self.mlp = MLP(cfg.d_model, ff, cfg.mlp, **kw)
        elif ffn == "moe":
            self.moe = moe_mod.MoE(cfg.d_model, cfg.mlp, cfg.moe, **kw)


class Embedding(nn.Module):
    """The token table ``(vocab, d)``, in the compute dtype unless
    ``dtype`` says otherwise."""

    def __init__(self, vocab: int, d: int, *, dtype, device):
        super().__init__()
        self.table = _param(vocab, d, dtype=dtype, device=device)


class DecoderLM(nn.Module):
    """``embed``, ``layers`` (the prefix stack, then the periods),
    ``final_norm`` and, unless the embeddings are tied, ``unembed``;
    allocated uninitialised (:func:`init_params` draws the weights,
    ``load_state_dict`` takes converted ones)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        if cfg.family == "audio":
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             "with models.encdec")
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


def _layer_init(layer: DecoderLayer, cfg: ModelConfig,
               gen: torch.Generator) -> DecoderLayer:
    """One layer's parameters in the reference's distributions."""
    init_norm(layer.norm1)
    if not cfg.parallel_block:
        init_norm(layer.norm2)
    mixer, ffn = layer.kind
    if mixer == "attn":
        attn.gqa_init(layer.attn, gen)
    elif mixer == "mla":
        attn.mla_init(layer.attn, gen)
    elif mixer == "mamba":
        mam.mamba_init(layer.mamba, gen)
    else:
        rwkv_mod.rwkv_init(layer.rwkv, gen)
    if ffn == "dense":
        mlp_init(layer.mlp, gen)
    elif ffn == "moe":
        moe_mod.moe_init(layer.moe, gen)
    return layer


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
        _layer_init(layer, cfg, gen)
    return m


# --------------------------------------------------------------------------
# forward (no cache)
# --------------------------------------------------------------------------

def _ffn(p: DecoderLayer, cfg, h, compute_dtype):
    """The dense or MoE ffn on ``h`` -> (out, aux)."""
    if p.kind[1] == "dense":
        return mlp_apply(p.mlp, h, cfg.mlp, compute_dtype), {}
    return moe_mod.moe_apply(p.moe, cfg.moe, cfg.mlp, h, compute_dtype)


def _block_out(p: DecoderLayer, cfg, x, h, mix, compute_dtype, cm=None):
    """The residuals around the mixer's output ``mix`` (``h`` = norm1(x))
    and the ffn -> (x, aux).  ``cm(h2)`` is the channel mix of an
    ``rwkv_cm`` layer."""
    if cfg.parallel_block:
        # cohere-style: y = x + attn(n(x)) + ffn(n(x))
        if p.kind[1] == "rwkv_cm":
            return x + mix, {}
        f, aux = _ffn(p, cfg, h, compute_dtype)
        return x + mix + f, aux
    x = x + mix
    h2 = norm_apply(p.norm2, x, cfg.norm)
    if p.kind[1] == "rwkv_cm":
        return x + cm(h2), {}
    f, aux = _ffn(p, cfg, h2, compute_dtype)
    return x + f, aux


def _apply_layer(p: DecoderLayer, cfg, x, positions, compute_dtype):
    mixer = p.kind[0]
    h = norm_apply(p.norm1, x, cfg.norm)
    if mixer == "attn":
        mix = attn.gqa_train(p.attn, cfg, h, positions, compute_dtype)
    elif mixer == "mla":
        mix = attn.mla_train(p.attn, cfg, h, positions, compute_dtype)
    elif mixer == "mamba":
        mix = mam.mamba_train(p.mamba, cfg, h, compute_dtype)
    else:
        mix = rwkv_mod.rwkv_time_mix_train(p.rwkv, cfg, h, compute_dtype)
    cm = (lambda h2: rwkv_mod.rwkv_channel_mix_train(p.rwkv, cfg, h2,
                                                      compute_dtype))
    return _block_out(p, cfg, x, h, mix, compute_dtype, cm)


def _embed(params: DecoderLM, cfg, tokens, prefix_embeds, compute_dtype):
    x = params.embed.table[tokens.long()].to(compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(compute_dtype), x], dim=1)
    return x


def _positions(x):
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


def _forward_hidden(params: DecoderLM, cfg, tokens, prefix_embeds):
    """(final-normed hidden states, summed load-balance loss)."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    positions = _positions(x)
    aux_sum = torch.zeros((), device=x.device)
    for layer in params.layers:
        x, aux = _apply_layer(layer, cfg, x, positions, compute_dtype)
        aux_sum = aux_sum + aux.get("load_balance_loss", 0.0)
    return norm_apply(params.final_norm, x, cfg.norm), aux_sum


@torch.no_grad()
def hidden_states(params: DecoderLM, cfg: ModelConfig, tokens, *,
                  prefix_embeds=None):
    """The final-normed hidden states (B, P+S, d) of :func:`forward`, whose
    logits at chosen positions are ``_unembed(params, cfg, h[:, idx])``."""
    return _forward_hidden(params, cfg, tokens, prefix_embeds)[0]


@torch.no_grad()
def forward(params: DecoderLM, cfg: ModelConfig, tokens, *,
            prefix_embeds=None):
    """tokens: (B, S) -> logits (B, P+S, vocab) fp32 and the reference's
    aux dict: the MoE layers' summed ``load_balance_loss`` (0 without).

    ``prefix_embeds`` (B, P, d) are prepended (VLM patch stub)."""
    x, aux_sum = _forward_hidden(params, cfg, tokens, prefix_embeds)
    return _unembed(params, cfg, x), {"load_balance_loss": aux_sum}


# --------------------------------------------------------------------------
# caches / prefill / decode
# --------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, kind, batch, max_len, dtype, device):
    mixer = kind[0]
    if mixer == "attn":
        return attn.init_gqa_cache(cfg, batch, max_len, dtype, device=device)
    if mixer == "mla":
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device=device)
    if mixer == "mamba":
        return mam.init_mamba_cache(cfg, batch, dtype, device=device)
    return rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device="cuda"):
    """``{"layers": [one cache per layer]}``, zeroed: ``k``/``v`` (GQA),
    ``c_kv``/``k_rope`` (MLA), ``conv``/``h`` (Mamba) or ``s``/``x_tm``/
    ``x_cm`` (RWKV)."""
    device = resolve_device(device)
    return {"layers": [_layer_cache(cfg, k, batch, max_len, dtype, device)
                       for k in layer_kinds(cfg)]}


def _apply_layer_step(p: DecoderLayer, cfg, x, pos, cache, compute_dtype):
    """One-token decode through a single layer; returns (x, cache)."""
    mixer = p.kind[0]
    h = norm_apply(p.norm1, x, cfg.norm)
    if mixer == "attn":
        mix, cache = attn.gqa_decode(p.attn, cfg, h, pos, cache,
                                     compute_dtype)
    elif mixer == "mla":
        mix, cache = attn.mla_decode(p.attn, cfg, h, pos, cache,
                                     compute_dtype)
    elif mixer == "mamba":
        mix, cache = mam.mamba_decode(p.mamba, cfg, h, cache, compute_dtype)
    else:
        mix, cache = rwkv_mod.rwkv_time_mix_decode(p.rwkv, cfg, h, cache,
                                                   compute_dtype)
    cm = (lambda h2: rwkv_mod.rwkv_channel_mix_decode(
        p.rwkv, cfg, h2, cache, compute_dtype)[0])
    return _block_out(p, cfg, x, h, mix, compute_dtype, cm)[0], cache


def _apply_layer_prefill(p: DecoderLayer, cfg, x, positions, cache,
                         compute_dtype):
    mixer = p.kind[0]
    h = norm_apply(p.norm1, x, cfg.norm)
    if mixer == "attn":
        mix, cache = attn.gqa_prefill(p.attn, cfg, h, positions, cache,
                                      compute_dtype)
    elif mixer == "mla":
        mix, cache = attn.mla_prefill(p.attn, cfg, h, positions, cache,
                                      compute_dtype)
    elif mixer == "mamba":
        mix, cache = mam.mamba_prefill(p.mamba, cfg, h, cache,
                                       compute_dtype)
    else:
        mix, cache = rwkv_mod.rwkv_time_mix_prefill(p.rwkv, cfg, h, cache,
                                                    compute_dtype)

    def cm(h2):
        cache["x_cm"].copy_(h2[:, -1:])
        return rwkv_mod.rwkv_channel_mix_train(p.rwkv, cfg, h2,
                                               compute_dtype)
    return _block_out(p, cfg, x, h, mix, compute_dtype, cm)[0], cache


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
