"""Encoder-decoder backbone (Whisper-style) with a stub audio frontend.

Ports the serving half of ``src/repro/models/encdec.py``: the conv/mel
frontend is a stub, so the caller supplies precomputed frame embeddings
``frames (B, encoder_seq, d_model)``.  The encoder is a bidirectional
transformer over the frames; the decoder is a causal LM with
cross-attention whose keys and values are computed once at prefill and
cached.  LayerNorm, GELU MLP, learned decoder positions; the self-attention
layers rotate q and k as the reference's ``gqa_train`` does.

K8 runs every unmasked attention: the encoder's (non-causal, S = T =
``encoder_seq``), the decoder's causal self-attention at prefill and the
cross-attention (non-causal, S decoder rows against T frames; at decode
one row, since the reference's cached cross-attention passes no mask).
Decode's self-attention against its cache stays in torch ops.

The token table and the position table are kept in fp32: the reference
adds the two in fp32 and rounds once (the tied unembedding casts the
token table to the compute dtype, as the reference does).  The caches are
written in place (``cross_kv`` at prefill, ``self`` at every step).
``loss`` comes with training.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Norm, embed_init, init_norm,
                                       linear, matmul_f32, mlp_apply,
                                       mlp_init, norm_apply)
from repro_torch.models.transformer import Embedding

__all__ = ["EncDecLM", "init_params", "encode", "forward", "init_cache",
           "prefill", "decode_step"]


class EncoderLayer(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = attn.GQA(cfg, **kw)
        self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, **kw)


class DecoderLayer(nn.Module):
    """``norm1``, ``self_attn``, ``norm_x``, ``cross``, ``norm2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = Norm(cfg.d_model, cfg.norm, device=device)
        self.self_attn = attn.GQA(cfg, **kw)
        self.norm_x = Norm(cfg.d_model, cfg.norm, device=device)
        self.cross = attn.GQA(cfg, **kw)
        self.norm2 = Norm(cfg.d_model, cfg.norm, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, **kw)


class EncDecLM(nn.Module):
    """``embed`` and ``pos_dec`` (fp32 tables), ``encoder``, ``enc_norm``,
    ``decoder``, ``final_norm``; allocated uninitialised."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype = getattr(torch, cfg.dtype)
        f32 = dict(dtype=torch.float32, device=device)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, **f32)
        self.pos_dec = Embedding(cfg.max_seq, cfg.d_model, **f32)
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, dtype=dtype, device=device)
            for _ in range(cfg.encoder_layers))
        self.enc_norm = Norm(cfg.d_model, cfg.norm, device=device)
        self.decoder = nn.ModuleList(
            DecoderLayer(cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> EncDecLM:
    """An :class:`EncDecLM` with the reference's initial distributions
    (positions ``N(0, 0.01)``), drawn on ``device`` from
    ``torch.Generator`` ``seed``."""
    m = EncDecLM(cfg, device=device)
    gen = torch.Generator(device=m.embed.table.device)
    gen.manual_seed(seed)
    embed_init(m.embed.table, gen)
    m.pos_dec.table.normal_(0.0, 0.01, generator=gen)
    for layer in m.encoder:
        attn.gqa_init(layer.attn, gen)
    for layer in m.decoder:
        attn.gqa_init(layer.self_attn, gen)
        attn.gqa_init(layer.cross, gen)
    for layer in (*m.encoder, *m.decoder):
        mlp_init(layer.mlp, gen)
    for mod in m.modules():
        if isinstance(mod, Norm):
            init_norm(mod)
    return m


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


@torch.no_grad()
def encode(params: EncDecLM, cfg: ModelConfig, frames):
    """frames: (B, S_enc, d) stub embeddings -> encoder memory."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = frames.to(compute_dtype)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for p in params.encoder:
        h = norm_apply(p.norm1, x, cfg.norm)
        x = x + attn.gqa_train(p.attn, cfg, h, positions, compute_dtype,
                               causal=False)
        h2 = norm_apply(p.norm2, x, cfg.norm)
        x = x + mlp_apply(p.mlp, h2, cfg.mlp, compute_dtype)
    return norm_apply(params.enc_norm, x, cfg.norm)


def _cross_kv(p: attn.GQA, cfg, memory, compute_dtype):
    b, t, _ = memory.shape
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    k = linear(p.wk, memory, compute_dtype).reshape(b, t, hk, dh)
    v = linear(p.wv, memory, compute_dtype).reshape(b, t, hk, dh)
    return k, v


def _cross_attend_cached(p: attn.GQA, cfg, x, kv, compute_dtype):
    """Cross-attention of x's rows against cached keys and values: no
    mask, no rope (K8, non-causal)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = linear(p.wq, x, compute_dtype).reshape(b, s, h, dh)
    out = attn._sdpa(q, kv["k"].to(q.dtype), kv["v"].to(q.dtype), None,
                     scale=1.0 / np.sqrt(dh))
    return linear(p.wo, out, compute_dtype)


def _cross_attend(p: attn.GQA, cfg, x, memory, compute_dtype):
    """Cross-attention: q from x, k/v from the encoder memory."""
    k, v = _cross_kv(p, cfg, memory, compute_dtype)
    return _cross_attend_cached(p, cfg, x, {"k": k, "v": v}, compute_dtype)


def _embed(params: EncDecLM, cfg, tokens, positions, compute_dtype):
    """Token and position embeddings added in fp32, rounded once."""
    return (params.embed.table[tokens.long()]
            + params.pos_dec.table[positions.long()]).to(compute_dtype)


def _unembed(params: EncDecLM, cfg, x):
    compute_dtype = getattr(torch, cfg.dtype)
    return matmul_f32(x.to(compute_dtype),
                      params.embed.table.to(compute_dtype).t())


def _mlp_block(p, cfg, x, compute_dtype):
    h2 = norm_apply(p.norm2, x, cfg.norm)
    return x + mlp_apply(p.mlp, h2, cfg.mlp, compute_dtype)


@torch.no_grad()
def forward(params: EncDecLM, cfg: ModelConfig, tokens, frames):
    """Teacher-forced pass -> logits (B, S_dec, vocab) fp32 and the
    reference's aux dict (no load-balance loss: 0)."""
    compute_dtype = getattr(torch, cfg.dtype)
    memory = encode(params, cfg, frames)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(params, cfg, tokens, positions, compute_dtype)
    for p in params.decoder:
        h = norm_apply(p.norm1, x, cfg.norm)
        x = x + attn.gqa_train(p.self_attn, cfg, h, positions,
                               compute_dtype)
        hx = norm_apply(p.norm_x, x, cfg.norm)
        x = x + _cross_attend(p.cross, cfg, hx, memory, compute_dtype)
        x = _mlp_block(p, cfg, x, compute_dtype)
    x = norm_apply(params.final_norm, x, cfg.norm)
    return _unembed(params, cfg, x), {
        "load_balance_loss": torch.zeros((), device=x.device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device="cuda"):
    """``{"self": [{"k", "v"}], "cross_kv": [{"k", "v"}]}``, one entry per
    decoder layer, zeroed; the cross keys and values span
    ``encoder_seq`` frames."""
    device = resolve_device(device)
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (batch, cfg.encoder_seq, hk, dh)
    return {
        "self": [attn.init_gqa_cache(cfg, batch, max_len, dtype,
                                     device=device)
                 for _ in range(cfg.n_layers)],
        "cross_kv": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
                     for _ in range(cfg.n_layers)],
    }


@torch.no_grad()
def prefill(params: EncDecLM, cfg: ModelConfig, tokens, frames, cache):
    """Encode, then the teacher-forced pass that fills the self and cross
    caches (in place); returns (last_logits (B, 1, vocab) fp32, cache)."""
    compute_dtype = getattr(torch, cfg.dtype)
    memory = encode(params, cfg, frames)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(params, cfg, tokens, positions, compute_dtype)
    for i, p in enumerate(params.decoder):
        h = norm_apply(p.norm1, x, cfg.norm)
        mix, cache["self"][i] = attn.gqa_prefill(
            p.self_attn, cfg, h, positions, cache["self"][i], compute_dtype)
        x = x + mix
        hx = norm_apply(p.norm_x, x, cfg.norm)
        kv = cache["cross_kv"][i]
        k, v = _cross_kv(p.cross, cfg, memory, compute_dtype)
        kv["k"].copy_(k)
        kv["v"].copy_(v)
        x = x + _cross_attend_cached(p.cross, cfg, hx, kv, compute_dtype)
        x = _mlp_block(p, cfg, x, compute_dtype)
    x = norm_apply(params.final_norm, x[:, -1:, :], cfg.norm)
    return _unembed(params, cfg, x), cache


@torch.no_grad()
def decode_step(params: EncDecLM, cfg: ModelConfig, token, pos, cache):
    """token: (B,) ids; pos: (B,) positions.  Returns (logits (B, vocab)
    fp32, cache)."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, token[:, None], pos[:, None], compute_dtype)
    for i, p in enumerate(params.decoder):
        h = norm_apply(p.norm1, x, cfg.norm)
        mix, cache["self"][i] = attn.gqa_decode(
            p.self_attn, cfg, h, pos, cache["self"][i], compute_dtype)
        x = x + mix
        hx = norm_apply(p.norm_x, x, cfg.norm)
        x = x + _cross_attend_cached(p.cross, cfg, hx, cache["cross_kv"][i],
                                     compute_dtype)
        x = _mlp_block(p, cfg, x, compute_dtype)
    x = norm_apply(params.final_norm, x, cfg.norm)
    return _unembed(params, cfg, x)[:, 0], cache
