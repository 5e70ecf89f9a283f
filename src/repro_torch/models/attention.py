"""Attention of the LM face: GQA with RoPE, optional bias and qk-norm.

Ports the GQA half of ``src/repro/models/attention.py``:

* :func:`gqa_train` - full-sequence attention (forward only); also the
  body of :func:`gqa_prefill`, which additionally fills the cache;
* :func:`gqa_decode` - one token per row against a static-length cache.

Cache layout ``k / v: (B, S_max, H_kv, dh)``, position-indexed.  Unlike
the reference's functional updates, :func:`gqa_prefill` and
:func:`gqa_decode` write the cache **in place** and return the same dict:
rows past a sequence's position may hold an earlier wave's keys, which the
decode mask turns into ``exp(-1e30 - m) = 0`` exactly, so a reused cache
gives the same tokens as a fresh one.

:func:`_sdpa` sends the unmasked full-sequence case (causal or not) to
kernel K8, ``kernels.flash_attention``, which computes the reference
Pallas kernel's function; a masked case (decode's single query row
against ``arange(T) <= pos``) runs in torch ops, as the reference runs it
in jnp.  The reference's ``_sdpa_chunked`` (its XLA online softmax for
long sequences) needs no port: K8 is that loop.

The MLA half (``mla_*``) waits for a later slice and raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (Linear, Norm, apply_rope, init_linear,
                                       init_norm, linear, rms_norm)

__all__ = ["GQA", "gqa_init", "gqa_train", "gqa_prefill", "gqa_decode",
           "init_gqa_cache", "mla_init", "mla_train", "mla_prefill",
           "mla_decode", "init_mla_cache", "NEG_INF"]

NEG_INF = -1e30
_MLA = ("MLA attention is not ported yet (ROADMAP Queue 1, item 11: the "
        "rest of the LM face)")


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
# MLA: not ported yet
# --------------------------------------------------------------------------

def mla_init(*args, **kwargs):
    raise NotImplementedError(_MLA)


def mla_train(*args, **kwargs):
    raise NotImplementedError(_MLA)


def init_mla_cache(*args, **kwargs):
    raise NotImplementedError(_MLA)


def mla_prefill(*args, **kwargs):
    raise NotImplementedError(_MLA)


def mla_decode(*args, **kwargs):
    raise NotImplementedError(_MLA)
