"""Encoder-decoder backbone (Whisper-style) with a stub audio frontend.

Ports ``src/repro/models/encdec.py``: the conv/mel frontend is a stub,
so the caller supplies precomputed frame embeddings ``frames (B,
encoder_seq, d_model)``.  The encoder is a bidirectional
transformer over the frames; the decoder is a causal LM with
cross-attention whose keys and values are computed once at prefill and
cached.  LayerNorm, GELU MLP, learned decoder positions; the self-attention
layers rotate q and k as the reference's ``gqa_train`` does.

K8 runs every unmasked attention: the encoder's (non-causal, S = T =
``encoder_seq``), the decoder's causal self-attention at prefill and the
cross-attention (non-causal, S decoder rows against T frames; at decode
one row against a whole cache, since the reference's cached
cross-attention passes no mask).  Decode's self-attention against its
cache, and its cross-attention against a cache whose frames are cut over
processes, stay in torch ops.

The token table and the position table are kept in fp32: the reference
adds the two in fp32 and rounds once (the tied unembedding casts the
token table to the compute dtype, as the reference does).  The caches are
written in place (``cross_kv`` at prefill, ``self`` at every step).

On a process mesh (``EncDecLM(..., mesh=)``, ``sharding.rules``) every
leaf is this process's ``param_specs`` block: FSDP over ``data`` and
tensor parallelism over ``model``.  The encoder's attention, the
decoder's self-attention and its cross-attention each run on this
process's heads (``attention``'s tensor-parallel regions), the MLPs are
column- and row-parallel.  The ``self`` and ``cross_kv`` caches are
the reference's ``cache_specs`` blocks (:func:`init_cache`): the kv
heads over ``model`` where they divide it, else a block of the rows and
frames over ``model`` (whisper-tiny's 6 heads on a 4-wide ``model``),
and at global batch 1 the sequence also over ``data``; the prefill
writes each block's rows and frames and attends against what it
computed, the decode reads the blocks (a distributed softmax over a cut
sequence, ``attention.cross_attend_cached``), and both refuse a cache
laid out otherwise (``rules.check_cache_blocks``).  The token table is
vocab-parallel where ``model`` cuts its vocab (the lookup and the tied
unembedding, ``transformer._lookup`` and ``transformer.unembed_tied``):
:func:`train_forward`'s logits are then this process's vocab block
(:func:`vocab_mesh`), and :func:`prefill` and :func:`decode_step` gather
them whole.  The position table matches no
rule and stays whole.
:func:`train_forward` is the loss's forward (it carries gradients; K8
then gives way to attention's train route); :func:`encode`,
:func:`forward`, :func:`prefill` and :func:`decode_step` run without
grad.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.layers import (MLP, Norm, embed_init, init_norm,
                                       mlp_apply, mlp_init, norm_apply)
from repro_torch.models.transformer import (Embedding, _generator,
                                            _keep_blocks, _lookup)
from repro_torch.sharding import rules

__all__ = ["EncDecLM", "init_params", "encode", "forward", "train_forward",
           "init_cache", "prefill", "decode_step", "vocab_mesh"]


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
    ``decoder``, ``final_norm``; allocated uninitialised, the matrices in
    ``dtype`` (default ``cfg.dtype``, fp32 for training).  On a process
    ``mesh`` (``launch.mesh.ProcessMesh``) each leaf is allocated as this
    process's block under ``sharding.rules.local_specs`` (the reference's
    ``param_specs``), carrying its spec."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=None,
                 mesh=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        at = torch.device("meta") if mesh is not None else device
        f32 = dict(dtype=torch.float32, device=at)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, **f32)
        self.pos_dec = Embedding(cfg.max_seq, cfg.d_model, **f32)
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, dtype=dtype, device=at)
            for _ in range(cfg.encoder_layers))
        self.enc_norm = Norm(cfg.d_model, cfg.norm, device=at)
        self.decoder = nn.ModuleList(
            DecoderLayer(cfg, dtype=dtype, device=at)
            for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=at)
        if mesh is not None:
            rules.allocate_blocks(self, mesh, device, 0)

    def period_slots(self) -> dict[str, list[str]]:
        """The reference's stacked leaves: ``{"encoder.<leaf>": [the
        leaf's name in encoder layer 0, 1, ...], "decoder.<leaf>": ...}``
        (:func:`repro_torch.convert.encdec_params_from_numpy`'s
        mapping)."""
        out = {}
        for stack in ("encoder", "decoder"):
            layers = getattr(self, stack)
            for leaf, _ in layers[0].named_parameters():
                out[f"{stack}.{leaf}"] = [f"{stack}.{i}.{leaf}"
                                          for i in range(len(layers))]
        return out


@torch.no_grad()
def init_params(cfg: ModelConfig, seed=0, *, device="cuda",
                dtype=None, mesh=None) -> EncDecLM:
    """An :class:`EncDecLM` with the reference's initial distributions
    (positions ``N(0, 0.01)``), drawn on ``device`` from
    ``torch.Generator`` ``seed`` (an int, or the generator itself).  On a
    process ``mesh`` every draw is the single-device model's: each piece
    (a table, an attention, an MLP) is drawn whole, in the single-device
    order, and this process keeps its blocks of it."""
    m = EncDecLM(cfg, device=device, dtype=dtype, mesh=mesh)
    dev = m.enc_norm.scale.device
    gen = _generator(seed, dev)
    kw = dict(dtype=m.encoder[0].attn.wq.w.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def draw(part, whole, init):
        # ``init`` on ``part``, or on the ``whole()`` piece of which this
        # process keeps its blocks
        if mesh is None:
            init(part)
        else:
            piece = whole()
            init(piece)
            _keep_blocks(part, piece, mesh)

    draw(m.embed, lambda: Embedding(cfg.vocab_size, cfg.d_model, **f32),
         lambda e: embed_init(e.table, gen))
    draw(m.pos_dec, lambda: Embedding(cfg.max_seq, cfg.d_model, **f32),
         lambda e: e.table.normal_(0.0, 0.01, generator=gen))
    gqa = lambda: attn.GQA(cfg, **kw)
    for layer in m.encoder:
        draw(layer.attn, gqa, lambda a: attn.gqa_init(a, gen))
    for layer in m.decoder:
        draw(layer.self_attn, gqa, lambda a: attn.gqa_init(a, gen))
        draw(layer.cross, gqa, lambda a: attn.gqa_init(a, gen))
    for layer in (*m.encoder, *m.decoder):
        draw(layer.mlp, lambda: MLP(cfg.d_model, cfg.d_ff, cfg.mlp, **kw),
             lambda p: mlp_init(p, gen))
    for mod in m.modules():
        if isinstance(mod, Norm):
            init_norm(mod)
    return m


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def _encode(params: EncDecLM, cfg: ModelConfig, frames):
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


def _embed(params: EncDecLM, cfg, tokens, positions, compute_dtype):
    """Token and position embeddings added in the tables' dtype (fp32),
    rounded once: each row looked up uncast (``transformer._lookup``: on
    a process mesh the tables' ``data`` cuts gathered, a vocab cut over
    ``model`` looked up in its range and summed over ``model``)."""
    table = params.embed.table
    return (_lookup(table, tokens, table.dtype)
            + _lookup(params.pos_dec.table, positions, table.dtype)
            ).to(compute_dtype)


def _unembed(params: EncDecLM, cfg, x, *, whole: bool = False):
    """The tied unembedding (the token table, whatever
    ``cfg.tie_embeddings`` says: the encoder-decoder has no other):
    fp32 logits, on a mesh whose ``model`` cuts the vocab this
    process's block of them, or with ``whole`` every block gathered."""
    return transformer.unembed_tied(params.embed.table, x,
                                    getattr(torch, cfg.dtype), whole=whole)


def vocab_mesh(params: EncDecLM):
    """The process mesh whose ``model`` cuts the logits of
    :func:`train_forward` into vocab blocks (the token table's vocab),
    else None."""
    return transformer.vocab_cut_mesh(params.embed.table, 0)


def _mlp_block(p, cfg, x, compute_dtype):
    h2 = norm_apply(p.norm2, x, cfg.norm)
    return x + mlp_apply(p.mlp, h2, cfg.mlp, compute_dtype)


@torch.no_grad()
def encode(params: EncDecLM, cfg: ModelConfig, frames):
    """frames: (B, S_enc, d) stub embeddings -> encoder memory."""
    return _encode(params, cfg, frames)


def _decoder_layer(p: DecoderLayer, cfg, x, positions, memory,
                   compute_dtype):
    h = norm_apply(p.norm1, x, cfg.norm)
    x = x + attn.gqa_train(p.self_attn, cfg, h, positions, compute_dtype)
    hx = norm_apply(p.norm_x, x, cfg.norm)
    x = x + attn.cross_attend(p.cross, cfg, hx, memory, compute_dtype)
    return _mlp_block(p, cfg, x, compute_dtype)


def train_forward(params: EncDecLM, cfg: ModelConfig, tokens, frames, *,
                  remat: bool = True):
    """:func:`forward` that carries gradients (the loss's forward);
    attention takes its train route wherever q requires grad, and with
    ``remat`` each decoder layer is recomputed in the backward, as the
    reference checkpoints its decoder's scan body."""
    compute_dtype = getattr(torch, cfg.dtype)
    memory = _encode(params, cfg, frames)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed(params, cfg, tokens, positions, compute_dtype)
    for p in params.decoder:
        if remat:
            x = checkpoint(_decoder_layer, p, cfg, x, positions, memory,
                           compute_dtype, use_reentrant=False)
        else:
            x = _decoder_layer(p, cfg, x, positions, memory, compute_dtype)
    x = norm_apply(params.final_norm, x, cfg.norm)
    return _unembed(params, cfg, x), {
        "load_balance_loss": torch.zeros((), device=x.device)}


@torch.no_grad()
def forward(params: EncDecLM, cfg: ModelConfig, tokens, frames):
    """Teacher-forced pass -> logits (B, S_dec, vocab) fp32 and the
    reference's aux dict (no load-balance loss: 0)."""
    return train_forward(params, cfg, tokens, frames, remat=False)


def _whole_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                 device) -> dict:
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device="cuda"):
    """``{"self": [{"k", "v"}], "cross_kv": [{"k", "v"}]}``, one entry per
    decoder layer, zeroed: ``self`` of ``max_len`` positions, ``cross_kv``
    of ``encoder_seq`` frames, every kv head.  Inside ``rules.use_mesh``
    of a process mesh every leaf is this process's block of the global
    cache (``self`` (B, max_len, Hk, dh), ``cross_kv`` (B, encoder_seq,
    Hk, dh)) under the reference's ``cache_specs``, as
    ``transformer.init_cache`` lays out a GQA cache (``rules.
    cache_blocks``, ``seq_shard`` at global batch 1), carrying its
    ``spec`` and ``global_shape``: the kv heads over ``model`` where they
    divide it (the heads ``attention.head_split`` reads), else every kv
    head on a block of the sequence over ``model``; at global batch 1 the
    sequence also over ``data``.  A spec that maps an axis twice raises."""
    device = resolve_device(device)
    ctx = rules.current_mesh()
    if ctx is None or not hasattr(ctx.mesh, "members"):
        return _whole_cache(cfg, batch, max_len, dtype, device)
    gb = rules.cache_global_batch(batch)
    whole = _whole_cache(cfg, gb, max_len, dtype, torch.device("meta"))
    blocks = rules.cache_blocks(ctx.mesh, whole, seq_shard=gb == 1)
    return {part: [transformer._block_layer_cache(
        cfg, ("attn",), batch, max_len, dtype, device, w, b, ctx.mesh)
        for w, b in zip(whole[part], blocks[part])]
        for part in ("self", "cross_kv")}


@torch.no_grad()
def prefill(params: EncDecLM, cfg: ModelConfig, tokens, frames, cache):
    """Encode, then the teacher-forced pass that fills the self and cross
    caches (in place: on a process mesh the rows and frames of each
    leaf's block); returns (last_logits (B, 1, vocab) fp32, cache)."""
    rules.check_cache_blocks(cache, tokens.shape[0])
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
        x = x + attn.cross_prefill(p.cross, cfg, hx, memory,
                                   cache["cross_kv"][i], compute_dtype)
        x = _mlp_block(p, cfg, x, compute_dtype)
    x = norm_apply(params.final_norm, x[:, -1:, :], cfg.norm)
    return _unembed(params, cfg, x, whole=True), cache


@torch.no_grad()
def decode_step(params: EncDecLM, cfg: ModelConfig, token, pos, cache):
    """token: (B,) ids; pos: (B,) positions.  Returns (logits (B, vocab)
    fp32, cache)."""
    rules.check_cache_blocks(cache, token.shape[0])
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, token[:, None], pos[:, None], compute_dtype)
    for i, p in enumerate(params.decoder):
        h = norm_apply(p.norm1, x, cfg.norm)
        mix, cache["self"][i] = attn.gqa_decode(
            p.self_attn, cfg, h, pos, cache["self"][i], compute_dtype)
        x = x + mix
        hx = norm_apply(p.norm_x, x, cfg.norm)
        x = x + attn.cross_attend_cached(p.cross, cfg, hx,
                                         cache["cross_kv"][i], compute_dtype)
        x = _mlp_block(p, cfg, x, compute_dtype)
    x = norm_apply(params.final_norm, x, cfg.norm)
    return _unembed(params, cfg, x, whole=True)[:, 0], cache
