"""Attention of the LM face: GQA (RoPE, optional bias and qk-norm) and
DeepSeek's multi-head latent attention (MLA).

Ports ``src/repro/models/attention.py``:

* :func:`gqa_train` / :func:`mla_train` - full-sequence attention
  (forward only); also the body of :func:`gqa_prefill` /
  :func:`mla_prefill`, which additionally fill the cache;
* :func:`gqa_decode` / :func:`mla_decode` - one token per row against a
  static-length cache.

GQA's cache is ``k / v: (B, S_max, H_kv, dh)``; MLA's is the compressed
``c_kv: (B, S_max, r_kv)`` and the shared rope key ``k_rope: (B, S_max,
r_rope)``, both position-indexed.  MLA's prefill attends with the
per-head keys and values expanded from ``c_kv`` (``q`` and ``k`` of
``qk_nope + qk_rope`` = 192 columns at DeepSeek-V3's width, ``v`` of 128)
through K8; its decode is the absorbed form, attention in the compressed
space in torch ops, as the reference computes it in jnp.

Unlike the reference's functional updates, the prefill and decode
functions write the cache **in place** and return the same dict:
rows past a sequence's position may hold an earlier wave's keys, which the
decode mask turns into ``exp(-1e30 - m) = 0`` exactly, so a reused cache
gives the same tokens as a fresh one.

:func:`_sdpa` sends the unmasked full-sequence case (causal or not) to
kernel K8, ``kernels.flash_attention``, which computes the reference
Pallas kernel's function; a masked case (decode's single query row
against ``arange(T) <= pos``) runs in torch ops, as the reference runs it
in jnp.  The reference's ``_sdpa_chunked`` (its XLA online softmax for
long sequences) needs no port: K8 is that loop.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (Linear, Norm, apply_rope, init_linear,
                                       init_norm, linear, rms_norm)

__all__ = ["GQA", "MLA", "gqa_init", "gqa_train", "gqa_prefill",
           "gqa_decode", "init_gqa_cache", "mla_init", "mla_train",
           "mla_prefill", "mla_decode", "init_mla_cache", "NEG_INF"]

NEG_INF = -1e30


class GQA(nn.Module):
    """``wq``, ``wk``, ``wv`` (bias if ``cfg.qkv_bias``), ``wo``, and the
    per-head ``q_norm`` / ``k_norm`` if ``cfg.qk_norm``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = Linear(d, h * dh, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d, hk * dh, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, hk * dh, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(h * dh, d, **kw)
        if cfg.qk_norm:
            self.q_norm = Norm(dh, device=device)
            self.k_norm = Norm(dh, device=device)


def gqa_init(p: GQA, gen: torch.Generator) -> GQA:
    for name in ("wq", "wk", "wv", "wo"):
        init_linear(getattr(p, name), gen)
    if hasattr(p, "q_norm"):
        init_norm(p.q_norm)
        init_norm(p.k_norm)
    return p


def _qkv(p: GQA, cfg, x, positions, compute_dtype):
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(p.wq, x, compute_dtype).reshape(b, s, h, dh)
    k = linear(p.wk, x, compute_dtype).reshape(b, s, hk, dh)
    v = linear(p.wv, x, compute_dtype).reshape(b, s, hk, dh)
    if cfg.qk_norm:
        q = rms_norm(p.q_norm, q)
        k = rms_norm(p.k_norm, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, *, scale, causal=False):
    """q: (B,S,H,dh), k/v: (B,T,Hk,dh|dv) grouped; mask: (B,1,S,T) or None.

    Without a mask the positions run from 0 on both sides and ``causal``
    says whether ``q_pos >= kv_pos`` is required: that is K8's function
    (which takes its scale as ``1 / sqrt(dh)``).  With a mask: scores in
    fp32, the mask as ``NEG_INF``, softmax in fp32, the weights rounded to
    q's dtype before the product with v, fp32 accumulation."""
    b, s, h, dh = q.shape
    if mask is None:
        if scale != 1.0 / np.sqrt(dh):
            raise ValueError(f"the flash path scales by 1/sqrt(dh) = "
                             f"{1.0 / np.sqrt(dh)}, got {scale}")
        return flash_attention(q, k, v, causal=causal)
    hk, dv = k.shape[2], v.shape[-1]
    group = h // hk
    qg = q.reshape(b, s, hk, group, dh)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * scale
    logits = torch.where(mask[:, :, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(q.dtype).float(),
                       v.float())
    return out.reshape(b, s, h * dv).to(q.dtype)


def _causal_mask(b, s):
    m = torch.tril(torch.ones((s, s), dtype=torch.bool))
    return m.expand(b, 1, s, s)


def gqa_train(p: GQA, cfg, x, positions, compute_dtype=torch.bfloat16, *,
              causal=True):
    """Full-sequence attention from position 0 (forward only)."""
    q, k, v = _qkv(p, cfg, x, positions, compute_dtype)
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    out = _sdpa(q, k, v, None, scale=scale, causal=causal)
    return linear(p.wo, out, compute_dtype)


def init_gqa_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device):
    """Zeroed (finite) key and value buffers."""
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                         device=device),
    }


def gqa_prefill(p: GQA, cfg, x, positions, cache,
                compute_dtype=torch.bfloat16):
    """Full causal pass that also writes cache[:, :S] (in place)."""
    q, k, v = _qkv(p, cfg, x, positions, compute_dtype)
    s = x.shape[1]
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    out = _sdpa(q, k, v, None, scale=1.0 / np.sqrt(cfg.resolved_head_dim),
                causal=True)
    return linear(p.wo, out, compute_dtype), cache


def gqa_decode(p: GQA, cfg, x, pos, cache, compute_dtype=torch.bfloat16):
    """x: (B, 1, d); pos: (B,) current positions; writes row ``pos`` of the
    cache (in place) and attends to cache[:pos + 1]."""
    q, k, v = _qkv(p, cfg, x, pos[:, None], compute_dtype)
    _write_at(cache["k"], k, pos)
    _write_at(cache["v"], v, pos)
    t = cache["k"].shape[1]
    valid = torch.arange(t, device=pos.device)[None, :] <= pos[:, None]
    mask = valid[:, None, None, :]
    out = _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask,
                scale=1.0 / np.sqrt(cfg.resolved_head_dim))
    return linear(p.wo, out, compute_dtype), cache


def _write_at(buf, val, pos):
    """buf: (B, T, ...); val: (B, 1, ...): row ``pos[b]`` of each batch row
    written in place.  A position past the end writes the last row, as the
    reference's ``dynamic_update_slice`` clamps its start index."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    idx = pos.long().clamp(0, buf.shape[1] - 1)
    buf[rows, idx] = val[:, 0].to(buf.dtype)
    return buf


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3 multi-head latent attention)
# --------------------------------------------------------------------------

class MLA(nn.Module):
    """``wq_a``, ``q_a_norm``, ``wq_b``, ``wkv_a``, ``kv_a_norm``,
    ``wkv_b``, ``wo`` (RMSNorms, no biases)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        kw = dict(dtype=dtype, device=device)
        self.wq_a = Linear(d, m.q_lora_rank, **kw)
        self.q_a_norm = Norm(m.q_lora_rank, device=device)
        self.wq_b = Linear(m.q_lora_rank,
                           h * (m.qk_nope_dim + m.qk_rope_dim), **kw)
        self.wkv_a = Linear(d, m.kv_lora_rank + m.qk_rope_dim, **kw)
        self.kv_a_norm = Norm(m.kv_lora_rank, device=device)
        self.wkv_b = Linear(m.kv_lora_rank,
                            h * (m.qk_nope_dim + m.v_head_dim), **kw)
        self.wo = Linear(h * m.v_head_dim, d, **kw)


def mla_init(p: MLA, gen: torch.Generator) -> MLA:
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        init_linear(getattr(p, name), gen)
    init_norm(p.q_a_norm)
    init_norm(p.kv_a_norm)
    return p


def _mla_q(p: MLA, cfg, x, positions, compute_dtype):
    m = cfg.mla
    b, s, _ = x.shape
    q = linear(p.wq_b, rms_norm(p.q_a_norm, linear(p.wq_a, x, compute_dtype)),
               compute_dtype).reshape(b, s, cfg.n_heads,
                                      m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p: MLA, cfg, x, positions, compute_dtype):
    """The compressed ``c_kv`` (B, S, r_kv) and the shared (single-head)
    rope key (B, S, r_rope)."""
    m = cfg.mla
    ckv = linear(p.wkv_a, x, compute_dtype)
    c_kv, k_rope = torch.split(ckv, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = rms_norm(p.kv_a_norm, c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_attend(p: MLA, cfg, x, positions, c_kv, k_rope, compute_dtype):
    """Causal attention from position 0 with the per-head keys and values
    expanded from ``c_kv``; the rope key is shared by every head."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, cfg, x, positions, compute_dtype)
    kv = linear(p.wkv_b, c_kv, compute_dtype).reshape(
        b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_dim, m.v_head_dim], dim=-1)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_dim)], dim=-1)
    scale = 1.0 / np.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    out = _sdpa(q_cat, k_cat, v, None, scale=scale, causal=True)
    return linear(p.wo, out, compute_dtype)


def mla_train(p: MLA, cfg, x, positions, compute_dtype=torch.bfloat16):
    """Full-sequence causal attention from position 0 (forward only)."""
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions, compute_dtype)
    return _mla_attend(p, cfg, x, positions, c_kv, k_rope, compute_dtype)


def init_mla_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device):
    """Zeroed compressed-key and rope-key buffers."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def mla_prefill(p: MLA, cfg, x, positions, cache,
                compute_dtype=torch.bfloat16):
    """:func:`mla_train` that also writes cache[:, :S] (in place)."""
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions, compute_dtype)
    s = x.shape[1]
    cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :s] = k_rope.to(cache["k_rope"].dtype)
    return _mla_attend(p, cfg, x, positions, c_kv, k_rope,
                       compute_dtype), cache


def _f32_einsum(eq, a, b):
    """The reference's ``einsum(..., preferred_element_type=float32)``:
    a product of two compute-dtype values is exact in fp32."""
    return torch.einsum(eq, a.float(), b.float())


def mla_decode(p: MLA, cfg, x, pos, cache, compute_dtype=torch.bfloat16):
    """Absorbed decode: ``q_nope`` goes through ``w_uk`` (the first
    ``qk_nope`` columns of ``wkv_b`` per head), so the logits are
    ``q_abs . c_kv + q_rope . k_rope`` and the readout ``(w @ c_kv) @
    w_uv``: attention in the compressed space, never materialising
    per-head keys.  Each fp32 product is rounded to x's dtype where the
    reference rounds it; writes row ``pos`` of the cache (in place)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None], compute_dtype)
    c_kv_new, k_rope_new = _mla_ckv(p, cfg, x, pos[:, None], compute_dtype)
    _write_at(cache["c_kv"], c_kv_new, pos)
    _write_at(cache["k_rope"], k_rope_new, pos)
    wkv_b = p.wkv_b.w.to(compute_dtype).reshape(
        m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim)
    w_uk = wkv_b[:, :, :m.qk_nope_dim]                     # (r, h, dn)
    w_uv = wkv_b[:, :, m.qk_nope_dim:]                     # (r, h, dv)
    q_abs = _f32_einsum("bshd,rhd->bshr", q_nope, w_uk).to(x.dtype)
    ckv = cache["c_kv"].to(x.dtype)                        # (b, T, r)
    krope = cache["k_rope"].to(x.dtype)                    # (b, T, rr)
    t = ckv.shape[1]
    scale = 1.0 / np.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    logits = (_f32_einsum("bshr,btr->bhst", q_abs, ckv)
              + _f32_einsum("bshd,btd->bhst", q_rope, krope)) * scale
    valid = torch.arange(t, device=pos.device)[None, :] <= pos[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = _f32_einsum("bhst,btr->bshr", w, ckv).to(x.dtype)
    out = _f32_einsum("bshr,rhd->bshd", ctx, w_uv)
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    return linear(p.wo, out, compute_dtype), cache
