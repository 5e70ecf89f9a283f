"""Attention of the LM face: GQA (RoPE, optional bias and qk-norm) and
DeepSeek's multi-head latent attention (MLA).

Ports ``src/repro/models/attention.py``:

* :func:`gqa_train` / :func:`mla_train` - full-sequence attention
  (differentiable, on the train route of :func:`_sdpa`); also the body
  of :func:`gqa_prefill` / :func:`mla_prefill`, which additionally fill
  the cache;
* :func:`gqa_decode` / :func:`mla_decode` - one token per row against a
  static-length cache;
* :func:`cross_attend` (:func:`cross_kv`, :func:`cross_attend_cached`) -
  the encoder-decoder's cross-attention, rope-free and mask-free.

GQA's cache is ``k / v: (B, S_max, H_kv, dh)``; MLA's is the compressed
``c_kv: (B, S_max, r_kv)`` and the shared rope key ``k_rope: (B, S_max,
r_rope)``, both position-indexed.  MLA's prefill attends with the
per-head keys and values expanded from ``c_kv`` (``q`` and ``k`` of
``qk_nope + qk_rope`` = 192 columns at DeepSeek-V3's width, ``v`` of 128)
through K8; its decode is the absorbed form, attention in the compressed
space in torch ops, as the reference computes it in jnp.

On a process mesh whose ``model`` axis cuts GQA's projections
(``sharding.rules``: ``wq|wk|wv`` columns, ``wo`` rows, the biases) a
layer is one tensor-parallel region: each process attends with its
``n_heads / model`` query heads and the kv heads they read
(:func:`head_split`), K8 and the cache on those heads alone, and ``wo``
sums the heads' partial products over ``model``.  Where the spec cuts
inside a head (``n_kv_heads``, or ``n_heads``, not a multiple of
``model``: qwen2.5-3b's 2 kv heads on a 4-wide ``model``) the
reference's storage is kept and the projection is gathered over
``model`` at use, each process taking the heads it reads; where
``n_heads`` does not split, every process attends with every head and
``wo`` takes its rows' share.  The encoder-decoder's cross-attention is
the same region: q of ``x`` and k, v of the encoder's memory on the
local heads, each input entering through one ``sum_grad``.

MLA on such a mesh (``wq_b`` and ``wkv_b`` columns, ``wo`` rows cut over
``model``; ``wq_a`` and ``wkv_a`` over ``data`` only) attends with its
``n_heads / model`` heads: the down-projections and their norms run
whole, and the normed q latent, the normed ``c_kv`` and the shared rope
key enter the local heads through ``sum_grad`` (each read by every
process for its own heads).  K8 runs the prefill on the local heads; the
absorbed decode reads the local heads' columns of ``wkv_b``.  The cache
``c_kv`` / ``k_rope`` stays whole on every process (the reference cuts
its sequence over ``model``: ROADMAP Queue 1).

Unlike the reference's functional updates, the prefill and decode
functions write the cache **in place** and return the same dict:
rows past a sequence's position may hold an earlier wave's keys, which the
decode mask turns into ``exp(-1e30 - m) = 0`` exactly, so a reused cache
gives the same tokens as a fresh one.

:func:`_sdpa` sends the unmasked full-sequence case (causal or not) to
kernel K8, ``kernels.flash_attention``, which computes the reference
Pallas kernel's function; a masked case (decode's single query row
against ``arange(T) <= pos``) runs in torch ops, as the reference runs it
in jnp.  K8 has no backward, so a full-sequence call whose q requires grad
(grad mode on) takes the train route instead: the reference's own
``_sdpa`` in torch ops, and above ``CHUNK_THRESHOLD`` score elements its
``_sdpa_chunked`` (the online softmax over 1024 x 1024 blocks), ported
here as :func:`_sdpa_chunked`.  Serving never takes that route.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (Linear, Norm, _affine, apply_rope,
                                       init_linear, init_norm, linear,
                                       rms_norm, row_parallel)
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules

__all__ = ["GQA", "MLA", "HeadSplit", "head_split", "gqa_init",
           "gqa_train", "gqa_prefill",
           "gqa_decode", "cross_kv", "cross_attend_cached", "cross_attend",
           "init_gqa_cache", "mla_init", "mla_train",
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


class HeadSplit(NamedTuple):
    """The heads one process attends in a tensor-parallel GQA layer:
    query heads ``q0`` on (``nq`` of them), kv heads ``k0`` on (``nk``);
    ``kv_index`` maps each local query head to its local kv head where
    the regular grouping (``nq / nk`` query heads a kv head) does not."""
    mesh: Any
    q0: int
    nq: int
    k0: int
    nk: int
    kv_index: Any


def head_split(cfg, mesh) -> HeadSplit:
    """The query heads of this process along ``model`` (``n_heads /
    model`` of them; all of them where that does not divide) and the kv
    heads they read."""
    h, hk = cfg.n_heads, cfg.n_kv_heads
    m, n_m = mesh.axis_index(("model",)), mesh.shape["model"]
    nq = h // n_m if h % n_m == 0 else h
    q0 = m * nq if nq < h else 0
    g = h // hk
    k0 = q0 // g
    nk = (q0 + nq - 1) // g + 1 - k0
    idx = [(q0 + j) // g - k0 for j in range(nq)]
    regular = nq % nk == 0 and idx == [j // (nq // nk) for j in range(nq)]
    return HeadSplit(mesh, q0, nq, k0, nk, None if regular else idx)


def _split(p: GQA, cfg) -> HeadSplit | None:
    """The layer's :class:`HeadSplit`, None unless ``wo`` is cut over
    ``model``."""
    if not row_parallel(p.wo):
        return None
    return head_split(cfg, rules.process_mesh())


def _whole_over_model(t, spec, dim: int, mesh):
    """``t`` (laid out by ``spec``) whole over ``model`` on ``dim``:
    gathered where ``spec`` cuts it there (the backward sums the
    cotangents into the blocks), else its cotangent summed over ``model``
    (each process reads a part of it)."""
    if dim < len(spec) and spec[dim] == "model":
        return coll.gather_blocks(t, mesh, ("model",), dim)
    return coll.sum_grad(t, mesh, ("model",))


def _heads(p: Linear, x, h0: int, n: int, dh: int, mesh, compute_dtype):
    """The projection ``p`` of ``x`` onto heads ``h0 .. h0 + n`` (a
    column-parallel product): this process's block where it is those
    heads, else their columns of the matrix gathered over ``model``."""
    w, spec = rules.gather_fsdp(p.w, compute_dtype)
    m = mesh.axis_index(("model",))
    if len(spec) > 1 and spec[1] == "model" and w.shape[1] == n * dh \
            and m * w.shape[1] == h0 * dh:
        return _affine(x, w, p.b, compute_dtype)
    cols = slice(h0 * dh, (h0 + n) * dh)
    w = _whole_over_model(w, spec, 1, mesh)[:, cols]
    b = None if p.b is None else _whole_over_model(
        p.b, rules.spec_of(p.b), 0, mesh)[cols]
    return _affine(x, w, b, compute_dtype)


def _qkv(p: GQA, cfg, x, positions, compute_dtype):
    """q (B, S, nq, dh), k and v (B, S, nk, dh) of the heads this process
    attends (every head off a tensor-parallel mesh), normed and rotated;
    and the layer's :class:`HeadSplit` (or None)."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    sp = _split(p, cfg)
    q_norm = getattr(p, "q_norm", None)
    k_norm = getattr(p, "k_norm", None)
    if sp is None:
        h, hk = cfg.n_heads, cfg.n_kv_heads
        q = linear(p.wq, x, compute_dtype).reshape(b, s, h, dh)
        k = linear(p.wk, x, compute_dtype).reshape(b, s, hk, dh)
        v = linear(p.wv, x, compute_dtype).reshape(b, s, hk, dh)
    else:
        mesh = sp.mesh
        x = coll.sum_grad(x.to(compute_dtype), mesh, ("model",))
        q = _heads(p.wq, x, sp.q0, sp.nq, dh, mesh,
                   compute_dtype).reshape(b, s, sp.nq, dh)
        k = _heads(p.wk, x, sp.k0, sp.nk, dh, mesh,
                   compute_dtype).reshape(b, s, sp.nk, dh)
        v = _heads(p.wv, x, sp.k0, sp.nk, dh, mesh,
                   compute_dtype).reshape(b, s, sp.nk, dh)
        if cfg.qk_norm:       # replicated, read on this process's heads
            q_norm = SimpleNamespace(scale=coll.sum_grad(
                q_norm.scale, mesh, ("model",)))
            k_norm = SimpleNamespace(scale=coll.sum_grad(
                k_norm.scale, mesh, ("model",)))
    if cfg.qk_norm:
        q = rms_norm(q_norm, q)
        k = rms_norm(k_norm, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, sp


def _kv_heads(t, sp: HeadSplit | None):
    """k or v (B, T, nk, dh) with a kv head for each local query head
    where the grouping is not regular, else as it is."""
    if sp is None or sp.kv_index is None:
        return t
    return t.index_select(2, torch.as_tensor(sp.kv_index, device=t.device))


def _out(p: GQA, cfg, out, sp: HeadSplit | None, compute_dtype):
    """``wo`` on the attention output of this process's heads (a
    row-parallel product on a tensor-parallel mesh; where every process
    attends with every head, its rows' share of them)."""
    if sp is not None and sp.nq == cfg.n_heads:
        rows = out.shape[-1] // sp.mesh.shape["model"]
        m = sp.mesh.axis_index(("model",))
        out = out[..., m * rows:(m + 1) * rows]
    return linear(p.wo, out, compute_dtype)


#: above this many score elements (S * T) the train route runs the
#: online-softmax loop over (Q_CHUNK, KV_CHUNK) blocks, as the reference's
#: ``_sdpa`` switches to ``_sdpa_chunked``
CHUNK_THRESHOLD = 4096 * 4096 + 1
Q_CHUNK = 1024
KV_CHUNK = 1024


def _train_route(q) -> bool:
    """Whether attention on ``q`` must carry a gradient: K8 has none."""
    return torch.is_grad_enabled() and q.requires_grad


def _sdpa(q, k, v, mask, *, scale, causal=False):
    """q: (B,S,H,dh), k/v: (B,T,Hk,dh|dv) grouped; mask: (B,1,S,T) or None.

    Without a mask the positions run from 0 on both sides and ``causal``
    says whether ``q_pos >= kv_pos`` is required.  That case goes to K8
    (which takes its scale as ``1 / sqrt(dh)``), unless grad mode is on
    and q requires grad: then it takes the train route, the reference's
    own ``_sdpa`` in torch ops (the causal mask built here, or none), and
    above ``CHUNK_THRESHOLD`` score elements its ``_sdpa_chunked``.  With a
    mask (decode): scores in fp32, the mask as ``NEG_INF``, softmax in
    fp32, the weights rounded to q's dtype before the product with v,
    fp32 accumulation."""
    b, s, h, dh = q.shape
    if mask is None and _train_route(q):
        t = k.shape[1]
        if s > 1 and s * t > CHUNK_THRESHOLD:
            return _sdpa_chunked(q, k, v, scale=scale, causal=causal)
        if causal:
            mask = _causal_mask(b, s, q.device)
        return _sdpa_masked(q, k, v, mask, scale=scale)
    if mask is None:
        if scale != 1.0 / np.sqrt(dh):
            raise ValueError(f"the flash path scales by 1/sqrt(dh) = "
                             f"{1.0 / np.sqrt(dh)}, got {scale}")
        return flash_attention(q, k, v, causal=causal)
    return _sdpa_masked(q, k, v, mask, scale=scale)


def _sdpa_masked(q, k, v, mask, *, scale):
    """The reference's ``_sdpa`` body; ``mask`` (B,1,S,T) or None."""
    b, s, h, dh = q.shape
    hk, dv = k.shape[2], v.shape[-1]
    group = h // hk
    qg = q.reshape(b, s, hk, group, dh)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * scale
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(q.dtype).float(),
                       v.float())
    return out.reshape(b, s, h * dv).to(q.dtype)


def _sdpa_chunked(q, k, v, *, scale, causal=True, q_chunk=Q_CHUNK,
                  kv_chunk=KV_CHUNK):
    """The reference's ``_sdpa_chunked``: online-softmax attention over
    (q_chunk, kv_chunk) blocks, so that no S x T score matrix is
    materialised; positions from 0 on both sides, the padded tail keys
    masked.  q: (B,S,H,dh), k/v: (B,T,Hk,dh|dv)."""
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // hk
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    nq, nk = -(-s // qc), -(-t // kc)
    pad_q, pad_k = nq * qc - s, nk * kc - t
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    # (nq, B, Hk, G, qc, dh) and (nk, B, Hk, kc, dh | dv)
    qg = qp.reshape(b, nq, qc, hk, group, dh).permute(1, 0, 3, 4, 2, 5)
    kg = kp.reshape(b, nk, kc, hk, dh).permute(1, 0, 3, 2, 4)
    vg = vp.reshape(b, nk, kc, hk, dv).permute(1, 0, 3, 2, 4)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qg[qi]
        q_pos = qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, hk, group, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hk, group, qc), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, hk, group, qc, dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qb.float(),
                              kg[ki].float()) * scale
            kv_pos = ki * kc + torch.arange(kc, device=dev)
            valid = kv_pos[None, :] < t
            if causal:
                valid = valid & (q_pos[:, None] >= kv_pos[None, :])
            sc = torch.where(valid, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(qb.dtype).float(),
                vg[ki].float())
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    # (nq, B, Hk, G, qc, dv) -> (B, S, H * dv)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        b, nq * qc, h * dv)
    return out[:, :s].to(q.dtype)


def _causal_mask(b, s, device=None):
    m = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))
    return m.expand(b, 1, s, s)


def gqa_train(p: GQA, cfg, x, positions, compute_dtype=torch.bfloat16, *,
              causal=True):
    """Full-sequence attention from position 0; differentiable (the
    train route of :func:`_sdpa`)."""
    q, k, v, sp = _qkv(p, cfg, x, positions, compute_dtype)
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    out = _sdpa(q, _kv_heads(k, sp), _kv_heads(v, sp), None, scale=scale,
                causal=causal)
    return _out(p, cfg, out, sp, compute_dtype)


def cross_kv(p: GQA, cfg, memory, compute_dtype=torch.bfloat16):
    """The cross-attention's keys and values (B, T, nk, dh) of the
    encoder ``memory``, on the kv heads this process reads (every head
    off a tensor-parallel mesh; there ``memory`` enters through one
    ``sum_grad``); no rope."""
    b, t, _ = memory.shape
    dh = cfg.resolved_head_dim
    sp = _split(p, cfg)
    if sp is None:
        hk = cfg.n_kv_heads
        return (linear(p.wk, memory, compute_dtype).reshape(b, t, hk, dh),
                linear(p.wv, memory, compute_dtype).reshape(b, t, hk, dh))
    memory = coll.sum_grad(memory.to(compute_dtype), sp.mesh, ("model",))
    return tuple(_heads(w, memory, sp.k0, sp.nk, dh, sp.mesh,
                        compute_dtype).reshape(b, t, sp.nk, dh)
                 for w in (p.wk, p.wv))


def cross_attend_cached(p: GQA, cfg, x, kv, compute_dtype=torch.bfloat16):
    """Cross-attention of ``x``'s rows against the keys and values ``kv``
    (:func:`cross_kv`, or a cache of them): no mask, no rope (K8,
    non-causal); on a tensor-parallel mesh ``x`` enters through one
    ``sum_grad``, q is this process's heads, and ``wo`` is row-parallel
    (:func:`_out`)."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    sp = _split(p, cfg)
    if sp is None:
        q = linear(p.wq, x, compute_dtype).reshape(b, s, cfg.n_heads, dh)
    else:
        x = coll.sum_grad(x.to(compute_dtype), sp.mesh, ("model",))
        q = _heads(p.wq, x, sp.q0, sp.nq, dh, sp.mesh,
                   compute_dtype).reshape(b, s, sp.nq, dh)
    out = _sdpa(q, _kv_heads(kv["k"].to(q.dtype), sp),
                _kv_heads(kv["v"].to(q.dtype), sp), None,
                scale=1.0 / np.sqrt(dh))
    return _out(p, cfg, out, sp, compute_dtype)


def cross_attend(p: GQA, cfg, x, memory, compute_dtype=torch.bfloat16):
    """Cross-attention: q from ``x``, k and v from the encoder
    ``memory``."""
    k, v = cross_kv(p, cfg, memory, compute_dtype)
    return cross_attend_cached(p, cfg, x, {"k": k, "v": v}, compute_dtype)


def init_gqa_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device, kv_heads: int | None = None):
    """Zeroed (finite) key and value buffers of ``kv_heads`` heads (a
    tensor-parallel process's, :func:`head_split`; default all)."""
    hk, dh = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                         device=device),
    }


def gqa_prefill(p: GQA, cfg, x, positions, cache,
                compute_dtype=torch.bfloat16):
    """Full causal pass that also writes cache[:, :S] (in place)."""
    q, k, v, sp = _qkv(p, cfg, x, positions, compute_dtype)
    _check_cache(cache, k)
    s = x.shape[1]
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    out = _sdpa(q, _kv_heads(k, sp), _kv_heads(v, sp), None,
                scale=1.0 / np.sqrt(cfg.resolved_head_dim), causal=True)
    return _out(p, cfg, out, sp, compute_dtype), cache


def gqa_decode(p: GQA, cfg, x, pos, cache, compute_dtype=torch.bfloat16):
    """x: (B, 1, d); pos: (B,) current positions; writes row ``pos`` of the
    cache (in place) and attends to cache[:pos + 1]."""
    q, k, v, sp = _qkv(p, cfg, x, pos[:, None], compute_dtype)
    _check_cache(cache, k)
    _write_at(cache["k"], k, pos)
    _write_at(cache["v"], v, pos)
    t = cache["k"].shape[1]
    valid = torch.arange(t, device=pos.device)[None, :] <= pos[:, None]
    mask = valid[:, None, None, :]
    out = _sdpa(q, _kv_heads(cache["k"].to(q.dtype), sp),
                _kv_heads(cache["v"].to(q.dtype), sp), mask,
                scale=1.0 / np.sqrt(cfg.resolved_head_dim))
    return _out(p, cfg, out, sp, compute_dtype), cache


def _check_cache(cache, k):
    if cache["k"].shape[2] != k.shape[2]:
        raise ValueError(
            f"the cache holds {cache['k'].shape[2]} kv heads, this process "
            f"attends with {k.shape[2]}: build it with init_cache inside "
            "rules.use_mesh of the model's process mesh")


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


def _mla_heads(cfg, mesh) -> int:
    return cfg.n_heads if mesh is None else \
        cfg.n_heads // mesh.shape["model"]


def _enter_heads(t, mesh):
    """A replicated tensor read by each process for its own heads: its
    cotangent summed over ``model`` (``t`` itself off a mesh)."""
    return t if mesh is None else coll.sum_grad(t, mesh, ("model",))


def _mla_q(p: MLA, cfg, x, positions, compute_dtype, mesh=None):
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_norm(p.q_a_norm, linear(p.wq_a, x, compute_dtype))
    q = linear(p.wq_b, _enter_heads(cq, mesh), compute_dtype).reshape(
        b, s, _mla_heads(cfg, mesh), m.qk_nope_dim + m.qk_rope_dim)
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
    expanded from ``c_kv``; the rope key is shared by every head.  On a
    tensor-parallel mesh the heads are this process's, ``wo``
    row-parallel."""
    m = cfg.mla
    b, s, _ = x.shape
    mesh = rules.tp_mesh(p.wo.w, cfg, "mla")
    h = _mla_heads(cfg, mesh)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, compute_dtype, mesh)
    c_kv, k_rope = _enter_heads(c_kv, mesh), _enter_heads(k_rope, mesh)
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
    """Full-sequence causal attention from position 0; differentiable
    (the train route of :func:`_sdpa`)."""
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
    mesh = rules.tp_mesh(p.wo.w, cfg, "mla")
    h = _mla_heads(cfg, mesh)
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None], compute_dtype, mesh)
    c_kv_new, k_rope_new = _mla_ckv(p, cfg, x, pos[:, None], compute_dtype)
    _write_at(cache["c_kv"], c_kv_new, pos)
    _write_at(cache["k_rope"], k_rope_new, pos)
    wkv_b = rules.gather_fsdp(p.wkv_b.w, compute_dtype)[0].reshape(
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
