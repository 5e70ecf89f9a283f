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

On a process mesh whose ``model`` axis cuts ``d_inner`` (``sharding.
rules``: ``in_proj`` columns, ``conv_w`` / ``conv_b`` / ``dt_proj`` /
``dt_bias_init`` / ``a_log`` / ``d_skip`` channels, ``x_proj`` and
``out_proj`` rows) a layer is one tensor-parallel region: each process
runs the conv and the scan on its ``d_inner / model`` channels, and its
cache holds those channels' window and state.  ``in_proj``'s block is
contiguous in the reference's ``(x_in, z)`` columns, so its output is
regrouped by an all-to-all over ``model`` (:func:`_own_channels`) into
this process's channels of ``x_in`` and of ``z``.  ``x_proj`` is
row-parallel: its fp32 partials are summed over ``model``, and the
replicated ``(dt, B, C)`` it gives, read by every process for its own
channels, has its cotangent summed over ``model`` once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, _param, init_linear, linear
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules

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


def _own_channels(xz, mesh):
    """``(x_in, z)`` of this process's channels from its block of
    ``in_proj``'s output (B, T, 2 di / M): that block is chunks ``2r``
    and ``2r + 1`` of the ``2M`` chunks of ``di / M`` columns, chunk
    ``c`` being channels ``c mod M`` of ``x_in`` (``c < M``) or of ``z``;
    each chunk goes to process ``c mod M`` (an all-to-all of unequal
    blocks over ``model``, whose backward sends the cotangents back)."""
    n_m, r = mesh.shape["model"], mesh.axis_index(("model",))
    b, t, w = xz.shape
    dc, rows = w // 2, b * t
    dest = [(2 * r + j) % n_m for j in range(2)]
    send, recv = [0] * n_m, [0] * n_m
    for q in dest:
        send[q] += rows
    for c in (r, n_m + r):        # x_in's chunk, then z's (source order)
        recv[c // 2] += rows
    x = xz.reshape(rows, 2, dc).transpose(0, 1)
    if dest[1] < dest[0]:         # the rows grouped by destination
        x = x.flip(0)
    out = coll.all_to_all_v(x.reshape(2 * rows, dc), mesh, ("model",),
                            send, recv)
    return out[:rows].reshape(b, t, dc), out[rows:].reshape(b, t, dc)


def _in_proj(p: Mamba, x, compute_dtype, mesh):
    """``(x_in, z)`` (B, T, di) off a mesh, or this process's channels of
    them: ``in_proj`` column-parallel on the whole input (its cotangent
    summed over ``model``), then regrouped."""
    if mesh is None:
        return torch.chunk(linear(p.in_proj, x, compute_dtype), 2, dim=-1)
    x = coll.sum_grad(x.to(compute_dtype), mesh, ("model",))
    return _own_channels(linear(p.in_proj, x, compute_dtype), mesh)


def _ssm_params(p: Mamba, cfg, xc, compute_dtype, mesh=None):
    """xc: (..., di) post-conv activations (this process's channels on a
    mesh) -> (dt, B, C), fp32.  On a mesh ``x_proj``'s partials are summed
    over ``model`` and the sum's cotangent too, once: ``dt_r`` enters the
    column-parallel ``dt_proj`` through that one sum."""
    m = cfg.mamba
    dtr = _dt_rank(cfg)
    proj = linear(p.x_proj, xc, compute_dtype)
    if mesh is not None:
        proj = coll.sum_grad(proj, mesh, ("model",))
    dt_r, b, c = torch.split(proj, [dtr, m.d_state, m.d_state], dim=-1)
    dt = F.softplus(linear(p.dt_proj, dt_r, compute_dtype).float()
                    + p.dt_bias_init.float())
    return dt, b.float(), c.float()


def _scan_chunk(p: Mamba, cfg, h0, xc_chunk, z_chunk, compute_dtype,
                mesh=None):
    """The selective scan over xc: (B, L, di) from the state h0 (B, di,
    N), step by step -> (final state, y (B, L, di) in compute_dtype)."""
    a = -torch.exp(p.a_log.float())                       # (di, N)
    dt, bmat, cmat = _ssm_params(p, cfg, xc_chunk, compute_dtype, mesh)
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
    mesh = rules.tp_mesh(p.in_proj.w, cfg, "mamba")
    xin, z = _in_proj(p, x, compute_dtype, mesh)
    xc = _causal_conv(p, cfg, xin, compute_dtype)
    h0 = torch.zeros((b, xin.shape[-1], m.d_state), dtype=torch.float32,
                     device=x.device)
    h, y = _scan_chunk(p, cfg, h0, xc, z, compute_dtype, mesh)
    return xin, linear(p.out_proj, y, compute_dtype), h


def mamba_train(p: Mamba, cfg, x, compute_dtype=torch.bfloat16):
    """x: (B, T, d) -> (B, T, d), the scan from the zero state."""
    return _mix(p, cfg, x, compute_dtype)[1]


def init_mamba_cache(cfg, batch: int, dtype=torch.bfloat16, *, device):
    """The zeroed conv window and state of the channels a process runs:
    its ``d_inner / model`` inside ``rules.use_mesh`` of a process mesh
    that cuts them (``rules.model_blocks``), else all."""
    m = cfg.mamba
    di = m.expand * cfg.d_model // rules.model_blocks(cfg, "mamba")
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
    mesh = rules.tp_mesh(p.in_proj.w, cfg, "mamba")
    xin, z = _in_proj(p, x, compute_dtype, mesh)          # (B, 1, di)
    if cache["h"].shape[1] != xin.shape[-1]:
        raise ValueError(
            f"the cache holds {cache['h'].shape[1]} channels, this process "
            f"scans {xin.shape[-1]}: build it with init_cache inside "
            "rules.use_mesh of the model's process mesh")
    window = torch.cat([cache["conv"].to(compute_dtype), xin],
                       dim=1)                             # (B, K, di)
    w = p.conv_w.to(compute_dtype)
    conv = torch.einsum("bkd,kd->bd", window.float(), w.float())
    xc = F.silu(conv.to(compute_dtype) + p.conv_b.to(compute_dtype))
    dt, bmat, cmat = _ssm_params(p, cfg, xc, compute_dtype, mesh)
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
