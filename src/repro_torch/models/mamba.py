"""Mamba (S6) selective-state-space mixer, the Jamba hybrid's workhorse.

Ports ``src/repro/models/mamba.py``.  The recurrence per channel ``c`` and
state ``n``::

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t        y_t = h_t . C_t

with ``a = -exp(a_log)`` and the selective ``dt, B, C`` projected from the
causally convolved input.  The reference scans in chunks with a
``jax.checkpoint`` around each chunk, which bounds training memory and
leaves the forward's values as they are; the port steps one plain loop
over time in torch ops, the same function.  Under autograd (training)
each time step saves its state: nothing in the loop writes in place, and
the layer's remat (``transformer._remat_layer``) bounds what the backward
holds.  Decode carries ``(conv window, state)`` per layer, updated in
place, without grad.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, _param, init_linear, linear

__all__ = ["Mamba", "mamba_init", "mamba_train", "mamba_prefill",
           "mamba_decode", "init_mamba_cache"]


def _dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


class Mamba(nn.Module):
    """``in_proj``, ``conv_w`` / ``conv_b``, ``x_proj``, ``dt_proj`` (with
    its fp32 bias), ``out_proj`` and the compute-dtype conv in the config's
    dtype; ``dt_bias_init``, ``a_log`` and ``d_skip`` in fp32, as the
    reference widens them before every use."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        m = cfg.mamba
        d = cfg.d_model
        di = m.expand * d
        dtr = _dt_rank(cfg)
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = Linear(d, 2 * di, **kw)
        self.conv_w = _param(m.d_conv, di, **kw)
        self.conv_b = _param(di, **kw)
        self.x_proj = Linear(di, dtr + 2 * m.d_state, **kw)
        self.dt_proj = Linear(dtr, di, bias=True, **kw)
        self.dt_bias_init = _param(di, **f32)
        self.a_log = _param(di, m.d_state, **f32)
        self.d_skip = _param(di, **f32)
        self.out_proj = Linear(di, d, **kw)


def mamba_init(p: Mamba, gen: torch.Generator) -> Mamba:
    """The reference's initialisation: S4D-real ``a``, ``dt`` log-uniform
    in [1e-3, 1e-1] through the inverse softplus (numpy's generator 0, as
    the reference draws it), unit skip, zero conv bias."""
    di, n = p.a_log.shape
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        init_linear(getattr(p, name), gen)
    p.conv_w.normal_(0.0, float(1.0 / np.sqrt(p.conv_w.shape[0])),
                     generator=gen)
    p.conv_b.zero_()
    a = np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    dt = np.exp(np.random.default_rng(0).uniform(
        np.log(1e-3), np.log(1e-1), size=(di,))).astype(np.float32)
    p.dt_bias_init.copy_(torch.from_numpy(dt + np.log1p(-np.exp(-dt))))
    p.a_log.copy_(torch.from_numpy(np.log(a)))
    p.d_skip.fill_(1.0)
    return p


def _ssm_params(p: Mamba, cfg, xc, compute_dtype):
    """xc: (..., di) post-conv activations -> (dt, B, C), fp32."""
    m = cfg.mamba
    dtr = _dt_rank(cfg)
    proj = linear(p.x_proj, xc, compute_dtype)
    dt_r, b, c = torch.split(proj, [dtr, m.d_state, m.d_state], dim=-1)
    dt = F.softplus(linear(p.dt_proj, dt_r, compute_dtype).float()
                    + p.dt_bias_init.float())
    return dt, b.float(), c.float()


def _scan_chunk(p: Mamba, cfg, h0, xc_chunk, z_chunk, compute_dtype):
    """The selective scan over xc: (B, L, di) from the state h0 (B, di,
    N), step by step -> (final state, y (B, L, di) in compute_dtype)."""
    a = -torch.exp(p.a_log.float())                       # (di, N)
    dt, bmat, cmat = _ssm_params(p, cfg, xc_chunk, compute_dtype)
    xf = xc_chunk.float()
    h, ys = h0, []
    for i in range(xc_chunk.shape[1]):
        da = torch.exp(dt[:, i, :, None] * a)             # (B, di, N)
        dbx = (dt[:, i] * xf[:, i])[..., None] * bmat[:, i, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, i]))
    y = torch.stack(ys, dim=1)                            # (B, L, di)
    y = y + xf * p.d_skip.float()
    y = y * F.silu(z_chunk.float())
    return h, y.to(compute_dtype)


def _causal_conv(p: Mamba, cfg, x, compute_dtype):
    """Depthwise causal conv over time. x: (B, T, di).  The taps are
    summed in fp32 and rounded once, as :func:`mamba_decode`'s dot over
    its window: in bf16 a sum rounded after every tap would part the
    prefill from the decode by more than the rest of the layer does."""
    k = cfg.mamba.d_conv
    w = p.conv_w.to(compute_dtype).float()                # (K, di)
    pad = F.pad(x.float(), (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out.to(compute_dtype) + p.conv_b.to(compute_dtype))


def _mix(p: Mamba, cfg, x, compute_dtype):
    """(in-projected input, y, final state) of the scan from zero."""
    m = cfg.mamba
    b = x.shape[0]
    xz = linear(p.in_proj, x, compute_dtype)
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc = _causal_conv(p, cfg, xin, compute_dtype)
    h0 = torch.zeros((b, xin.shape[-1], m.d_state), dtype=torch.float32,
                     device=x.device)
    h, y = _scan_chunk(p, cfg, h0, xc, z, compute_dtype)
    return xin, linear(p.out_proj, y, compute_dtype), h


def mamba_train(p: Mamba, cfg, x, compute_dtype=torch.bfloat16):
    """x: (B, T, d) -> (B, T, d), the scan from the zero state."""
    return _mix(p, cfg, x, compute_dtype)[1]


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16, *, device):
    m = cfg.mamba
    di = m.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                         device=device),
    }


def mamba_prefill(p: Mamba, cfg, x, cache, compute_dtype=torch.bfloat16):
    """:func:`mamba_train` that also fills the decode cache (in place):
    the last ``d_conv - 1`` inputs of the conv (zero-padded on the left
    for a shorter prompt) and the scan's final state.  One scan gives
    both: the reference runs the train scan, then replays the same steps
    from the cache's state for the cache (``transformer.
    _mamba_prefill_cache``).  A prefill starts every row at position 0,
    so the scan starts from the zero state whatever the cache held (the
    reference is only ever given a zeroed cache)."""
    kw = cfg.mamba.d_conv - 1
    xin, out, h = _mix(p, cfg, x, compute_dtype)
    t = x.shape[1]
    window = xin[:, -kw:] if t >= kw else F.pad(xin, (0, 0, kw - t, 0))
    cache["conv"].copy_(window)
    cache["h"].copy_(h)
    return out, cache


def mamba_decode(p: Mamba, cfg, x, cache, compute_dtype=torch.bfloat16):
    """One-token step. x: (B, 1, d); the cache is updated in place."""
    xz = linear(p.in_proj, x, compute_dtype)
    xin, z = torch.chunk(xz, 2, dim=-1)                   # (B, 1, di)
    window = torch.cat([cache["conv"].to(compute_dtype), xin],
                       dim=1)                             # (B, K, di)
    w = p.conv_w.to(compute_dtype)
    conv = torch.einsum("bkd,kd->bd", window.float(), w.float())
    xc = F.silu(conv.to(compute_dtype) + p.conv_b.to(compute_dtype))
    dt, bmat, cmat = _ssm_params(p, cfg, xc, compute_dtype)
    a = -torch.exp(p.a_log.float())
    da = torch.exp(dt[..., None] * a)
    h = da * cache["h"] + (dt * xc.float())[..., None] * bmat[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cmat)
    y = y + xc.float() * p.d_skip.float()
    y = y * F.silu(z[:, 0].float())
    out = linear(p.out_proj, y[:, None, :].to(compute_dtype), compute_dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return out, cache
