"""RWKV-6 "Finch" attention-free mixer (data-dependent decay).

Ports ``src/repro/models/rwkv.py``.  Time-mixing recurrence per head
(state S in R^{dh x dh})::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the per-channel decay ``w_t = exp(-exp(wx_t))`` from a LoRA on the
token-shifted input, data-dependent token-shift interpolation (ddlerp) for
the r/k/v/g/w streams, the bonus ``u``, per-head GroupNorm on the readout
and an output gate g.  Channel mixing is the squared-ReLU MLP with token
shift.

The reference scans in checkpointed chunks, which bounds training memory
and leaves the forward's values as they are; the port serves (forward
only) and steps one plain loop over time in torch ops.  The decode cache
(``s``, ``x_tm``, ``x_cm``) is updated in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, _param, init_linear, linear

__all__ = ["RWKV", "rwkv_init", "rwkv_time_mix_train",
           "rwkv_time_mix_prefill", "rwkv_time_mix_decode",
           "rwkv_channel_mix_train", "rwkv_channel_mix_decode",
           "init_rwkv_cache"]


def _heads(cfg):
    dh = cfg.rwkv.head_dim
    assert cfg.d_model % dh == 0
    return cfg.d_model // dh, dh


class LoRA(nn.Module):
    """``a`` (d, r) then ``b`` (r, out)."""

    def __init__(self, d: int, r: int, out: int, *, dtype, device):
        super().__init__()
        self.a = Linear(d, r, dtype=dtype, device=device)
        self.b = Linear(r, out, dtype=dtype, device=device)


class RWKV(nn.Module):
    """A layer's time-mix and channel-mix parameters.  The mixes and
    matrices are in the config's dtype; ``decay_base``, ``bonus_u``,
    ``gn_scale`` and ``gn_bias`` in fp32, as the reference keeps or widens
    them before use."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        r = cfg.rwkv.lora_rank
        h, dh = _heads(cfg)
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.mix_base = _param(5, d, **kw)
        self.mix_lora = LoRA(d, r, 5 * d, **kw)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, Linear(d, d, **kw))
        self.decay_base = _param(d, **f32)
        self.decay_lora = LoRA(d, r, d, **kw)
        self.bonus_u = _param(h, dh, **f32)
        self.gn_scale = _param(h, dh, **f32)
        self.gn_bias = _param(h, dh, **f32)
        self.cm_mix = _param(2, d, **kw)
        self.cm_k = Linear(d, cfg.d_ff, **kw)
        self.cm_v = Linear(cfg.d_ff, d, **kw)


def rwkv_init(p: RWKV, gen: torch.Generator) -> RWKV:
    for lin in (p.mix_lora.a, p.mix_lora.b, p.wr, p.wk, p.wv, p.wg, p.wo,
                p.decay_lora.a, p.decay_lora.b, p.cm_k, p.cm_v):
        init_linear(lin, gen)
    p.mix_base.fill_(0.5)
    p.cm_mix.fill_(0.5)
    d = p.decay_base.shape[0]
    p.decay_base.copy_(torch.from_numpy(
        np.linspace(-6.0, -0.5, d).astype(np.float32)))
    p.bonus_u.normal_(0.0, 0.1, generator=gen)
    p.gn_scale.fill_(1.0)
    p.gn_bias.zero_()
    return p


def _token_shift(x, last):
    """shifted[t] = x[t-1]; last: (B, 1, d) carry from the previous
    segment."""
    return torch.cat([last, x[:, :-1, :]], dim=1)


def _ddlerp(p: RWKV, x, xs, compute_dtype):
    """Data-dependent interpolation between x and its shift -> the r, k,
    v, g, w streams."""
    d = x.shape[-1]
    base = p.mix_base.to(compute_dtype)                   # (5, d)
    z = torch.tanh(linear(p.mix_lora.a, x + 0.5 * (xs - x), compute_dtype))
    off = linear(p.mix_lora.b, z, compute_dtype)          # (B, T, 5d)
    mix = base + off.reshape(*x.shape[:-1], 5, d)         # (B, T, 5, d)
    streams = x[..., None, :] + (xs - x)[..., None, :] * mix
    return streams.unbind(-2)


def _group_norm(p: RWKV, y, eps=64e-5):
    """Per-head layer norm on (B, T, H, dh), fp32."""
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = torch.square(yf - mu).mean(-1, keepdim=True)
    return (yf - mu) * torch.rsqrt(var + eps) * p.gn_scale + p.gn_bias


def _time_mix_core(p: RWKV, cfg, x, xs, s0, compute_dtype):
    """The recurrence from state s0 (B, H, dh, dh). x: (B, T, d) -> (y,
    final state)."""
    h, dh = _heads(cfg)
    b, t, d = x.shape
    xr, xk, xv, xg, xw = _ddlerp(p, x, xs, compute_dtype)
    r = linear(p.wr, xr, compute_dtype).reshape(b, t, h, dh).float()
    k = linear(p.wk, xk, compute_dtype).reshape(b, t, h, dh).float()
    v = linear(p.wv, xv, compute_dtype).reshape(b, t, h, dh).float()
    g = F.silu(linear(p.wg, xg, compute_dtype))
    wx = p.decay_base.float() + linear(
        p.decay_lora.b, torch.tanh(linear(p.decay_lora.a, xw,
                                          compute_dtype)),
        compute_dtype).float()
    w = torch.exp(-torch.exp(wx)).reshape(b, t, h, dh)   # in (0, 1)
    u = p.bonus_u.float()[..., None]
    s, ys = s0, []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]     # (B, H, dh, dh)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, i], s + u * kv))
        s = w[:, i, :, :, None] * s + kv
    y = torch.stack(ys, dim=1)                            # (B, T, H, dh)
    y = _group_norm(p, y).reshape(b, t, d).to(compute_dtype)
    return linear(p.wo, y * g, compute_dtype), s


def _zero_state(cfg, x):
    h, dh = _heads(cfg)
    return torch.zeros((x.shape[0], h, dh, dh), dtype=torch.float32,
                       device=x.device)


def rwkv_time_mix_train(p: RWKV, cfg, x, compute_dtype=torch.bfloat16):
    """x: (B, T, d) from position 0: the recurrence from the zero state."""
    xs = _token_shift(x, torch.zeros_like(x[:, :1]))
    return _time_mix_core(p, cfg, x, xs, _zero_state(cfg, x),
                          compute_dtype)[0]


def rwkv_time_mix_prefill(p: RWKV, cfg, x, cache,
                          compute_dtype=torch.bfloat16):
    """:func:`rwkv_time_mix_train` that also fills the time-mix cache (in
    place): the final state and the last input (the reference's
    ``transformer._rwkv_prefill``).  A prefill starts every row at
    position 0, from the zero state and a zero shift, whatever the cache
    held (the reference is only ever given a zeroed cache)."""
    xs = _token_shift(x, torch.zeros_like(x[:, :1]))
    y, s = _time_mix_core(p, cfg, x, xs, _zero_state(cfg, x), compute_dtype)
    cache["s"].copy_(s)
    cache["x_tm"].copy_(x[:, -1:])
    return y, cache


def init_rwkv_cache(cfg, batch: int, dtype=torch.bfloat16, *, device):
    h, dh = _heads(cfg)
    return {
        "s": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                            device=device),               # time-mix shift
        "x_cm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                            device=device),               # channel-mix shift
    }


def rwkv_time_mix_decode(p: RWKV, cfg, x, cache,
                         compute_dtype=torch.bfloat16):
    """x: (B, 1, d) one token; O(1) state update, in place."""
    y, s = _time_mix_core(p, cfg, x, cache["x_tm"].to(x.dtype), cache["s"],
                          compute_dtype)
    cache["s"].copy_(s)
    cache["x_tm"].copy_(x)
    return y, cache


def _channel_mix(p: RWKV, x, xs, compute_dtype):
    mix = p.cm_mix.to(compute_dtype)
    xk = x + (xs - x) * mix[0]
    k = torch.square(F.relu(linear(p.cm_k, xk, compute_dtype)))
    return linear(p.cm_v, k, compute_dtype)


def rwkv_channel_mix_train(p: RWKV, cfg, x, compute_dtype=torch.bfloat16):
    return _channel_mix(p, x, _token_shift(x, torch.zeros_like(x[:, :1])),
                        compute_dtype)


def rwkv_channel_mix_decode(p: RWKV, cfg, x, cache,
                            compute_dtype=torch.bfloat16):
    y = _channel_mix(p, x, cache["x_cm"].to(x.dtype), compute_dtype)
    cache["x_cm"].copy_(x)
    return y, cache
