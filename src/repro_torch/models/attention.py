"""Attention of the LM face: GQA (RoPE, optional bias and qk-norm) and
DeepSeek's multi-head latent attention (MLA).

Ports ``src/repro/models/attention.py``:

* :func:`gqa_train` / :func:`mla_train` - full-sequence attention
  (differentiable, on the train route of :func:`_sdpa`); also the body
  of :func:`gqa_prefill` / :func:`mla_prefill`, which additionally fill
  the cache;
* :func:`gqa_decode` / :func:`mla_decode` - one token per row against a
  static-length cache;
* :func:`cross_attend` (:func:`cross_kv`), :func:`cross_prefill` and
  :func:`cross_attend_cached` - the encoder-decoder's cross-attention,
  rope-free and mask-free: whole, the prefill's (which writes the cache
  and attends against what it computed), and the decode's (which reads
  the cache).

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
(:func:`head_split`), K8 on those heads alone, and ``wo`` sums the
heads' partial products over ``model``.  Where the spec cuts inside a
head (``n_kv_heads``, or ``n_heads``, not a multiple of ``model``:
qwen2.5-3b's 2 kv heads on a 4-wide ``model``) the reference's storage is
kept and the projection is gathered over ``model`` at use, each process
taking the heads it reads; where ``n_heads`` does not split, every
process attends with every head and ``wo`` takes its rows' share.  The
encoder-decoder's cross-attention is the same region: q of ``x`` and k,
v of the encoder's memory on the local heads, each input entering
through one ``sum_grad``.

MLA on such a mesh (``wq_b`` and ``wkv_b`` columns, ``wo`` rows cut over
``model``; ``wq_a`` and ``wkv_a`` over ``data`` only) attends with its
``n_heads / model`` heads: the down-projections and their norms run
whole, and the normed q latent, the normed ``c_kv`` and the shared rope
key enter the local heads through ``sum_grad`` (each read by every
process for its own heads).  K8 runs the prefill on the local heads; the
absorbed decode reads the local heads' columns of ``wkv_b``.

A decoder-only model's serving cache on a process mesh is the
reference's ``cache_specs`` layout (``transformer.init_cache``: each leaf
a block carrying its spec).  GQA's ``k`` / ``v`` hold the kv heads over
``model`` where they divide it (the heads :func:`head_split` reads),
else every kv head and a block of the sequence over ``model``; MLA's
``c_kv`` / ``k_rope`` always a block of the sequence over ``model``; at
global batch 1 the sequence is also cut over ``data``.  A prefill writes
the prompt's rows that fall in the block (GQA: for every kv head the
block holds, the heads this process does not compute gathered over
``model``); a decode step's row is written by its owner, and attention
over a cut sequence is a distributed softmax (:func:`_sdpa_blocks`,
:func:`_block_softmax`): each block's fp32 scores, ``pmax`` for the
global max, ``psum`` of the exp-sums, the weights rounded where the
reference rounds them, and ``psum`` of the blocks' ``w . v`` in block
order.  The encoder-decoder's ``self`` and ``cross_kv`` caches are laid
out by the same rule (``encdec.init_cache``): the decode's
cross-attention over a cut cache is the same distributed softmax, every
frame valid.

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
           "gqa_decode", "cross_kv", "cross_prefill", "cross_attend_cached",
           "cross_attend",
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


def _head_range(cfg, m: int, n_m: int) -> tuple[int, int, int, int]:
    """``(q0, nq, k0, nk)`` of the process at index ``m`` of an
    ``n_m``-wide ``model`` axis (:func:`head_split`)."""
    h, hk = cfg.n_heads, cfg.n_kv_heads
    nq = h // n_m if h % n_m == 0 else h
    q0 = m * nq if nq < h else 0
    g = h // hk
    k0 = q0 // g
    return q0, nq, k0, (q0 + nq - 1) // g + 1 - k0


def head_split(cfg, mesh) -> HeadSplit:
    """The query heads of this process along ``model`` (``n_heads /
    model`` of them; all of them where that does not divide) and the kv
    heads they read."""
    q0, nq, k0, nk = _head_range(cfg, mesh.axis_index(("model",)),
                                 mesh.shape["model"])
    g = cfg.n_heads // cfg.n_kv_heads
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


def _cross_q(p: GQA, cfg, x, compute_dtype):
    """The cross-attention's q (B, S, nq, dh) of ``x`` on this process's
    query heads (every head off a tensor-parallel mesh; there ``x``
    enters through one ``sum_grad``), and the layer's
    :class:`HeadSplit` (or None)."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    sp = _split(p, cfg)
    if sp is None:
        return linear(p.wq, x, compute_dtype).reshape(
            b, s, cfg.n_heads, dh), None
    x = coll.sum_grad(x.to(compute_dtype), sp.mesh, ("model",))
    return _heads(p.wq, x, sp.q0, sp.nq, dh, sp.mesh,
                  compute_dtype).reshape(b, s, sp.nq, dh), sp


def _cross_attend_kv(p: GQA, cfg, x, k, v, compute_dtype):
    """Cross-attention of ``x``'s rows against the whole keys and values
    ``k``, ``v`` (B, T, nk, dh) of this process's kv heads: no mask, no
    rope (K8, non-causal); ``wo`` row-parallel on a tensor-parallel mesh
    (:func:`_out`)."""
    q, sp = _cross_q(p, cfg, x, compute_dtype)
    out = _sdpa(q, _kv_heads(k.to(q.dtype), sp), _kv_heads(v.to(q.dtype), sp),
                None, scale=1.0 / np.sqrt(cfg.resolved_head_dim))
    return _out(p, cfg, out, sp, compute_dtype)


def cross_prefill(p: GQA, cfg, x, memory, kv, compute_dtype=torch.bfloat16):
    """The prefill's cross-attention: the keys and values of the encoder
    ``memory`` (:func:`cross_kv`) rounded to the cache's dtype, as the
    reference attends with what it caches; this process's block of them
    written into the cache ``kv`` (in place: the frames of its block of
    the sequence, for every kv head the block holds, those its query
    heads do not read gathered over ``model``); and ``x``'s attention
    against the whole of them, which never reads the cache."""
    k, v = cross_kv(p, cfg, memory, compute_dtype)
    k, v = k.to(kv["k"].dtype), v.to(kv["v"].dtype)
    _check_cache(kv, k)
    sp = _split(p, cfg)
    _write_rows(kv["k"], _block_heads(k, kv["k"], cfg, sp))
    _write_rows(kv["v"], _block_heads(v, kv["v"], cfg, sp))
    return _cross_attend_kv(p, cfg, x, k, v, compute_dtype)


def cross_attend_cached(p: GQA, cfg, x, kv, compute_dtype=torch.bfloat16):
    """Cross-attention of ``x``'s rows (a decode step's) against the
    cache ``kv``: no mask, no rope.  A whole cache goes to K8
    (non-causal) on this process's heads.  Where the cache is a block of
    the frames cut over processes (``rules.seq_cut``) attention is
    :func:`_sdpa_blocks`' distributed softmax with every row valid, by
    :func:`gqa_decode`'s rule (:func:`_cut_attention`)."""
    q, sp = _cross_q(p, cfg, x, compute_dtype)
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    k, v = kv["k"], kv["v"]
    axes = rules.seq_cut(k)
    if not axes:
        out = _sdpa(q, _read_heads(k.to(q.dtype), sp),
                    _read_heads(v.to(q.dtype), sp), None, scale=scale)
        return _out(p, cfg, out, sp, compute_dtype)
    valid = torch.ones((q.shape[0], k.shape[1]), dtype=torch.bool,
                       device=q.device)
    out = _cut_attention(q, k, v, valid, cfg, sp, axes, scale)
    return _out(p, cfg, out, sp, compute_dtype)


def cross_attend(p: GQA, cfg, x, memory, compute_dtype=torch.bfloat16):
    """Cross-attention: q from ``x``, k and v from the encoder
    ``memory``."""
    k, v = cross_kv(p, cfg, memory, compute_dtype)
    return _cross_attend_kv(p, cfg, x, k, v, compute_dtype)


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
    """Full causal pass (K8 on this process's heads against the prompt's
    own k and v) that also writes the prompt's rows of the cache (in
    place): on a process mesh the rows of this process's block, for
    every kv head the block holds (those its query heads do not read
    come from the processes along ``model`` that compute them)."""
    q, k, v, sp = _qkv(p, cfg, x, positions, compute_dtype)
    _check_cache(cache, k)
    _write_rows(cache["k"], _block_heads(k, cache["k"], cfg, sp))
    _write_rows(cache["v"], _block_heads(v, cache["v"], cfg, sp))
    out = _sdpa(q, _kv_heads(k, sp), _kv_heads(v, sp), None,
                scale=1.0 / np.sqrt(cfg.resolved_head_dim), causal=True)
    return _out(p, cfg, out, sp, compute_dtype), cache


def gqa_decode(p: GQA, cfg, x, pos, cache, compute_dtype=torch.bfloat16):
    """x: (B, 1, d); pos: (B,) current positions; writes row ``pos`` of the
    cache (in place) and attends to cache[:pos + 1].  Where the cache is a
    block of a sequence cut over processes (``rules.seq_cut``) the row's
    owner writes it and attention is :func:`_sdpa_blocks`' distributed
    softmax; where ``model`` cuts the sequence every process of the group
    scores every query head (the heads it does not own come over
    ``model``), and keeps its own heads' outputs for ``wo``."""
    q, k, v, sp = _qkv(p, cfg, x, pos[:, None], compute_dtype)
    _check_cache(cache, k)
    _write_at(cache["k"], _block_heads(k, cache["k"], cfg, sp), pos)
    _write_at(cache["v"], _block_heads(v, cache["v"], cfg, sp), pos)
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    axes = rules.seq_cut(cache["k"])
    if not axes:
        t = cache["k"].shape[1]
        valid = torch.arange(t, device=pos.device)[None, :] <= pos[:, None]
        out = _sdpa(q, _read_heads(cache["k"].to(q.dtype), sp),
                    _read_heads(cache["v"].to(q.dtype), sp),
                    valid[:, None, None, :], scale=scale)
        return _out(p, cfg, out, sp, compute_dtype), cache
    out = _cut_attention(q, cache["k"], cache["v"],
                         _valid_rows(cache["k"], pos), cfg, sp, axes, scale)
    return _out(p, cfg, out, sp, compute_dtype), cache


def _cut_attention(q, k, v, valid, cfg, sp: HeadSplit | None, axes,
                   scale):
    """Decode attention (q: (B, 1, nq, dh)) against this process's cache
    blocks ``k``, ``v`` of a sequence cut over ``axes``
    (:func:`_sdpa_blocks`; ``valid`` (B, T_block) its rows to attend):
    where ``model`` cuts the sequence and this process owns fewer than
    all the query heads, every query head is scored (the heads it does
    not own come over ``model``) and its own heads' output kept."""
    mesh = rules.process_mesh()
    if "model" in axes and sp is not None and sp.nq < cfg.n_heads:
        dh = cfg.resolved_head_dim
        q = coll.gather_blocks(q, sp.mesh, ("model",), 2)
        return _sdpa_blocks(q, k, v, valid, mesh, axes, scale=scale)[
            ..., sp.q0 * dh:(sp.q0 + sp.nq) * dh]
    return _sdpa_blocks(q, _read_heads(k, sp), _read_heads(v, sp), valid,
                        mesh, axes, scale=scale)


def _check_cache(cache, k):
    """The cache a layer is handed must be laid out as this process
    reads it: a block (carrying its spec: ``transformer.init_cache`` on a
    process mesh) of the shape its spec gives, holding the kv heads of
    ``k`` or every kv head; else (no spec) the kv heads of ``k``."""
    leaf = cache["k"]
    if hasattr(leaf, "spec"):
        rules.check_block(leaf, "the GQA cache")
        if leaf.shape[2] not in (k.shape[2], rules.global_shape(leaf)[2]):
            raise ValueError(f"the cache block holds {leaf.shape[2]} kv heads,"
                             f" this process attends with {k.shape[2]}")
        return
    if leaf.shape[2] != k.shape[2]:
        raise ValueError(
            f"the cache holds {leaf.shape[2]} kv heads, this process "
            f"attends with {k.shape[2]}: build it with init_cache inside "
            "rules.use_mesh of the model's process mesh")


def _all_kv_heads(t, cfg, sp: HeadSplit | None):
    """k or v (B, S, nk, dh) of this process's kv heads -> (B, S, H_kv,
    dh) of every kv head: each head from the first process along
    ``model`` that computes it (one gather over ``model``, each
    process's heads padded to the most any holds)."""
    if sp is None or sp.nk == cfg.n_kv_heads:
        return t
    n_m = sp.mesh.shape["model"]
    ranges = [_head_range(cfg, m, n_m)[2:] for m in range(n_m)]
    most = max(nk for _, nk in ranges)
    parts = coll.gather_rows(F.pad(t, (0, 0, 0, most - t.shape[2])),
                             sp.mesh, ("model",))
    heads = []
    for j in range(cfg.n_kv_heads):
        m, (k0, _) = next((m, r) for m, r in enumerate(ranges)
                          if r[0] <= j < r[0] + r[1])
        heads.append(parts[m][:, :, j - k0])
    return torch.stack(heads, dim=2)


def _block_heads(t, leaf, cfg, sp: HeadSplit | None):
    """k or v of this process's kv heads -> of the kv heads the cache
    ``leaf`` holds: ``t`` itself, or every kv head (:func:`_all_kv_heads`)
    where the block holds them all (``cache_specs`` cuts its sequence,
    or nothing, rather than the heads)."""
    if leaf.shape[2] == t.shape[2]:
        return t
    return _all_kv_heads(t, cfg, sp)


def _read_heads(t, sp: HeadSplit | None):
    """A cache leaf (B, T, ., dh) -> the kv heads this process's query
    heads read, one for each where the grouping is not regular."""
    if sp is not None and t.shape[2] > sp.nk:
        t = t[:, :, sp.k0:sp.k0 + sp.nk]
    return _kv_heads(t, sp)


def _write_rows(buf, val):
    """buf: (B, T_block, ...) a cache leaf; val: (B, S, ...): the rows of
    positions ``0 .. S`` written in place where they fall in this
    process's block of the sequence (all of them in a whole cache)."""
    s, t = val.shape[1], rules.global_shape(buf)[1]
    if s > t:
        raise ValueError(f"a prompt of {s} positions into a cache of {t}")
    t0 = rules.block_start(buf, 1)
    a, b = t0, min(t0 + buf.shape[1], s)
    if a < b:
        buf[:, :b - a] = val[:, a:b].to(buf.dtype)
    return buf


def _write_at(buf, val, pos):
    """buf: (B, T, ...); val: (B, 1, ...): row ``pos[b]`` of each batch row
    written in place.  A position past the end writes the last row, as the
    reference's ``dynamic_update_slice`` clamps its start index.  In a
    block of a sequence cut over processes (``rules.seq_cut``) the row is
    written by the process whose block holds it; the others keep theirs."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    t, tb = rules.global_shape(buf)[1], buf.shape[1]
    idx = pos.long().clamp(0, t - 1)
    if tb == t:
        buf[rows, idx] = val[:, 0].to(buf.dtype)
        return buf
    idx = idx - rules.block_start(buf, 1)
    own = ((idx >= 0) & (idx < tb)).view((-1,) + (1,) * (val.dim() - 2))
    idx = idx.clamp(0, tb - 1)
    buf[rows, idx] = torch.where(own, val[:, 0].to(buf.dtype), buf[rows, idx])
    return buf


#: the most elements of a cache block's rows widened to fp32 at a time by
#: the decode softmax over a cut sequence (:func:`_sdpa_blocks`)
SEQ_CHUNK = 1 << 21


def _block_softmax(logits, valid, mesh, axes, dtype):
    """The softmax over the last dim of ``logits`` (fp32) whose entries
    are this process's rows of a sequence cut over ``axes``: the rows not
    ``valid`` as ``NEG_INF``, the global max by ``pmax``, the global
    denominator by ``psum`` of the blocks' exp-sums, then the weights,
    rounded to ``dtype``.  A block wholly past the position has local
    max ``NEG_INF`` and weights ``exp(NEG_INF - M) = 0`` exactly: row 0 is
    always valid, so ``M`` is a real logit and no sum is 0."""
    logits = torch.where(valid, logits, NEG_INF)
    m = coll.pmax(logits.amax(-1, keepdim=True), mesh, axes)
    e = torch.exp(logits - m)
    return (e / coll.psum(e.sum(-1, keepdim=True), mesh, axes)).to(dtype)


def _sdpa_blocks(q, k, v, valid, mesh, axes, *, scale):
    """Decode attention (q: (B, 1, H, dh)) against this process's block
    k, v (B, T_block, Hk, dh | dv) of a sequence cut over ``axes``: the
    scores in fp32, :func:`_block_softmax`, the weights rounded to q's
    dtype as ``_sdpa_masked`` rounds them, this block's ``w . v`` in fp32
    and the blocks' sums added by ``psum`` in block order, so every
    process of the group holds the same bits.  The block's rows are
    widened to fp32 SEQ_CHUNK elements at a time."""
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.reshape(b, s, hk, h // hk, dh).float()
    step = max(1, SEQ_CHUNK // (b * hk * max(dh, dv)))
    logits = torch.cat([torch.einsum(
        "bshgd,bthd->bhgst", qg, k[:, i:i + step].to(q.dtype).float())
        for i in range(0, t, step)], dim=-1) * scale
    w = _block_softmax(logits, valid[:, None, None, None, :], mesh, axes,
                       q.dtype)
    out = None
    for i in range(0, t, step):
        part = torch.einsum("bhgst,bthd->bshgd", w[..., i:i + step].float(),
                            v[:, i:i + step].to(q.dtype).float())
        out = part if out is None else out + part
    return coll.psum(out, mesh, axes).reshape(b, s, h * dv).to(q.dtype)


def _valid_rows(leaf, pos):
    """(B, T_block): which rows of this process's block of the cache leaf
    lie at or before each row's position."""
    t0 = rules.block_start(leaf, 1)
    rows = t0 + torch.arange(leaf.shape[1], device=pos.device)
    return rows[None, :] <= pos[:, None]


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


def _check_mla_cache(cache):
    """An MLA cache block (carrying its spec) must be the shape its spec
    gives."""
    for name in ("c_kv", "k_rope"):
        if hasattr(cache[name], "spec"):
            rules.check_block(cache[name], f"the MLA cache's {name}")


def mla_prefill(p: MLA, cfg, x, positions, cache,
                compute_dtype=torch.bfloat16):
    """:func:`mla_train` that also writes the prompt's rows of the cache
    (in place): on a process mesh those of this process's block of the
    sequence, from the whole ``c_kv`` and rope key every process
    computes."""
    _check_mla_cache(cache)
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions, compute_dtype)
    _write_rows(cache["c_kv"], c_kv)
    _write_rows(cache["k_rope"], k_rope)
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
    reference rounds it; writes row ``pos`` of the cache (in place).

    Where the cache is a block of a sequence cut over processes
    (``rules.seq_cut``: over ``model``, and ``data`` at global batch 1)
    the row's owner writes it, the logits and the ``ctx`` readout run
    over the block's rows with :func:`_block_softmax`'s two rounds, and
    the blocks' fp32 ``w . c_kv`` are added by ``psum``; where ``model``
    cuts the sequence each process scores every head (``q_abs`` and the
    rope query of the heads it does not own come over ``model``) and
    keeps its own heads' ``ctx`` for ``w_uv`` and ``wo``.  No process
    holds more of the cache than its block."""
    m = cfg.mla
    b = x.shape[0]
    mesh = rules.tp_mesh(p.wo.w, cfg, "mla")
    h = _mla_heads(cfg, mesh)
    _check_mla_cache(cache)
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
    axes = rules.seq_cut(cache["c_kv"])
    every = mesh is not None and "model" in axes
    if every:                 # every head scored against this block's rows
        q_abs = coll.gather_blocks(q_abs, mesh, ("model",), 2)
        q_rope = coll.gather_blocks(q_rope, mesh, ("model",), 2)
    scale = 1.0 / np.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    logits = (_f32_einsum("bshr,btr->bhst", q_abs, ckv)
              + _f32_einsum("bshd,btd->bhst", q_rope, krope)) * scale
    if axes:
        seq_mesh = rules.process_mesh()
        w = _block_softmax(logits, _valid_rows(cache["c_kv"], pos)[
            :, None, None, :], seq_mesh, axes, x.dtype)
        ctx = coll.psum(_f32_einsum("bhst,btr->bshr", w, ckv), seq_mesh,
                        axes).to(x.dtype)
        if every:
            h0 = mesh.axis_index(("model",)) * h
            ctx = ctx[:, :, h0:h0 + h]
    else:
        t = ckv.shape[1]
        valid = torch.arange(t, device=pos.device)[None, :] <= pos[:, None]
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = _f32_einsum("bhst,btr->bshr", w, ckv).to(x.dtype)
    out = _f32_einsum("bshr,rhd->bshd", ctx, w_uv)
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    return linear(p.wo, out, compute_dtype), cache
