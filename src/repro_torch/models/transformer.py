"""Decoder-only LM assembly: every layer kind of the reference.

Ports ``src/repro/models/transformer.py``.  A layer is a ``(mixer, ffn)``
kind from :func:`period_structure`: mixer ``attn`` (GQA), ``mla``,
``mamba`` or ``rwkv``; ffn ``dense``, ``moe`` or ``rwkv_cm``.  An arch is
an optional dense prefix stack (DeepSeek-V3's first three layers) and a
repeating period (Jamba: one attention layer in eight, MoE every other
layer).  The reference stacks each period slot's parameters ``(n_periods,
...)`` and scans over depth; the port keeps one :class:`DecoderLayer` per
layer, prefix first, in a ``ModuleList`` and loops.  Its ``shard_act``
constraints have no counterpart: under a process mesh
(``sharding.rules.use_mesh``) each process already holds its own batch
rows and its blocks of the parameters (``sharding.rules.local_specs``),
the MoE layers take ``models.moe_manual``'s dispatch, and the layers
whose projections ``model`` cuts are tensor-parallel regions
(``layers.linear``; GQA and MLA heads in ``attention``, Mamba's
channels, RWKV-6's heads).  The embedding is then
vocab-parallel, and the logits of :func:`train_forward` are this
process's block of the vocab (``models.model.cross_entropy`` takes them
so); :func:`prefill` and :func:`decode_step` gather them whole.
``parallel_block``, ``layernorm``, ``gelu``, ``qk_norm``, ``qkv_bias``,
``tie_embeddings`` and ``prefix_embeds`` are kept.

:func:`train_forward` is the loss's forward: it carries gradients
(attention takes its train route) and runs each period layer under
``cfg.remat`` (``torch.utils.checkpoint``), as the reference's
``forward(..., remat=True)`` does; its aux holds the summed MoE
``load_balance_loss``.  :func:`forward` is the same function under
``torch.no_grad()`` without remat; :func:`prefill` and
:func:`decode_step` serve, also without grad.  The caches are written in
place; a prefill starts every row at position 0, so a recurrent layer's
state starts from zero whatever the cache held.  On a process mesh the
cache is the reference's ``cache_specs`` layout (:func:`init_cache`),
and :func:`prefill` and :func:`decode_step` refuse, with the reason, a
cache laid out by any other rule (``rules.check_cache_blocks``).
The encoder-decoder family is :mod:`repro_torch.models.encdec`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (MLP, Linear, Norm, _param, embed_init,
                                       init_linear, init_norm, matmul_f32,
                                       mlp_apply, mlp_init, norm_apply)
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules

__all__ = ["period_structure", "layer_kinds", "DecoderLayer", "DecoderLM",
           "Embedding", "init_params", "forward", "train_forward",
           "hidden_states", "init_cache", "prefill", "decode_step",
           "vocab_mesh", "unembed_tied", "vocab_cut_mesh"]


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
    ``load_state_dict`` takes converted ones).  The matrices, mixes and
    the embedding are stored in ``dtype`` (default ``cfg.dtype``; fp32
    for training, whose every use casts to ``cfg.dtype`` first as the
    reference's does), the other leaves in fp32.  On a process ``mesh``
    (``launch.mesh.ProcessMesh``) each leaf is allocated as this
    process's block under ``sharding.rules.local_specs`` (the reference's
    ``param_specs``, whatever the layers' mixers: GQA, MLA, Mamba or
    RWKV-6), carrying its spec."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=None,
                 mesh=None):
        super().__init__()
        if cfg.family == "audio":
            raise ValueError(f"{cfg.name} is an encoder-decoder: build it "
                             "with models.encdec")
        device = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        at = torch.device("meta") if mesh is not None else device
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype,
                               device=at)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=at)
        if not cfg.tie_embeddings:
            self.unembed = Linear(cfg.d_model, cfg.vocab_size, dtype=dtype,
                                  device=at)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, k, dtype=dtype, device=at)
            for k in layer_kinds(cfg))
        if mesh is not None:
            rules.allocate_blocks(self, mesh, device,
                                  cfg.moe.n_experts if cfg.moe else 0)
        self.cfg = cfg
        self.mesh = mesh

    def period_slots(self) -> dict[str, list[str]]:
        """The reference's stacked leaves: ``{"period.{j}.<leaf>": [the
        leaf's name in period 0's layer, period 1's, ...]}`` for slot
        ``j``'s layers ``n_prefix + p * len(period) + j``
        (:func:`repro_torch.convert.lm_params_from_numpy`'s mapping)."""
        prefix, period, n_periods = period_structure(self.cfg)
        out = {}
        for j in range(len(period)):
            first = self.layers[len(prefix) + j]
            for leaf, _ in first.named_parameters():
                out[f"period.{j}.{leaf}"] = [
                    f"layers.{len(prefix) + p * len(period) + j}.{leaf}"
                    for p in range(n_periods)]
        return out


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


def _keep_blocks(part: nn.Module, whole: nn.Module, mesh) -> None:
    """``part``'s parameters (blocks carrying their specs) set to their
    blocks of ``whole``'s, parameter by parameter."""
    for (name, p), (_, w) in zip(part.named_parameters(),
                                 whole.named_parameters()):
        p.copy_(rules.NamedSharding(mesh, rules.spec_of(p)).shard(w))


def _generator(seed, device) -> torch.Generator:
    """``seed`` itself if it is a ``torch.Generator`` (on ``device``),
    else a generator on ``device`` seeded with it."""
    if isinstance(seed, torch.Generator):
        if seed.device.type != device.type:
            raise ValueError(f"a generator on {seed.device} cannot draw "
                             f"parameters on {device}")
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


@torch.no_grad()
def init_params(cfg: ModelConfig, seed=0, *, device="cuda",
                dtype=None, mesh=None) -> DecoderLM:
    """A :class:`DecoderLM` with the reference's initial distributions,
    drawn on ``device`` in the stored dtypes (``dtype``, see
    :class:`DecoderLM`) from ``torch.Generator`` ``seed`` (an int, or the
    generator itself).  On a process ``mesh`` every draw is the
    single-device model's: each piece (the embedding, the unembedding,
    a layer) is drawn whole, in the single-device order, and this
    process keeps its blocks of it."""
    m = DecoderLM(cfg, device=device, dtype=dtype, mesh=mesh)
    dev = m.final_norm.scale.device
    gen = _generator(seed, dev)
    init_norm(m.final_norm)
    if mesh is None:
        embed_init(m.embed.table, gen)
        if not cfg.tie_embeddings:
            init_linear(m.unembed, gen, scale=1.0 / np.sqrt(cfg.d_model))
        for layer in m.layers:
            _layer_init(layer, cfg, gen)
        return m
    dtype = m.embed.table.dtype
    whole = Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype, device=dev)
    embed_init(whole.table, gen)
    _keep_blocks(m.embed, whole, mesh)
    if not cfg.tie_embeddings:
        whole = Linear(cfg.d_model, cfg.vocab_size, dtype=dtype, device=dev)
        init_linear(whole, gen, scale=1.0 / np.sqrt(cfg.d_model))
        _keep_blocks(m.unembed, whole, mesh)
    for layer in m.layers:
        whole = _layer_init(DecoderLayer(cfg, layer.kind, dtype=dtype,
                                         device=dev), cfg, gen)
        _keep_blocks(layer, whole, mesh)
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


def _lookup(table, ids, compute_dtype):
    """The rows ``ids`` of the embedding ``table`` in ``compute_dtype``.
    On a process mesh the table's ``d`` halves are gathered over
    ``data``, and where ``model`` cuts its vocab (vocab-parallel) each
    process looks up the ids in its range, zero rows for the rest, and
    the rows are summed over ``model``."""
    t, spec = rules.gather_fsdp(table, compute_dtype)
    ids = ids.long()
    if not (len(spec) and spec[0] == "model"):
        return t[ids]
    mesh = rules.process_mesh()
    n = t.shape[0]
    local = ids - mesh.axis_index(("model",)) * n
    own = (local >= 0) & (local < n)
    rows = torch.where(own[..., None], t[local.clamp(0, n - 1)],
                       torch.zeros((), dtype=t.dtype, device=t.device))
    return coll.psum(rows, mesh, ("model",))


def _embed(params: DecoderLM, cfg, tokens, prefix_embeds, compute_dtype):
    x = _lookup(params.embed.table, tokens, compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(compute_dtype), x], dim=1)
    return x


def _positions(x):
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


def _layer_out(p: DecoderLayer, cfg, x, positions, compute_dtype):
    """One layer -> (x, its load-balance loss, 0 without MoE)."""
    x, aux = _apply_layer(p, cfg, x, positions, compute_dtype)
    return x, aux.get("load_balance_loss", torch.zeros((), device=x.device))


#: the matrix products a ``"dots"`` remat keeps: the reference's
#: ``dots_with_no_batch_dims_saveable`` keeps the outputs of products
#: without batch dims, which here are the 2-d GEMMs (a linear's folded
#: product and the fp32-output one); the batched ones (attention's
#: einsums, the expert GEMMs) are recomputed with everything else
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(cfg, fn, *args):
    """``fn(*args)`` under ``cfg.remat``: ``"full"`` keeps only the
    layer's inputs and recomputes the rest in the backward, ``"dots"``
    also keeps the 2-d GEMMs' outputs, ``"none"`` keeps everything."""
    if cfg.remat == "none":
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _forward_hidden(params: DecoderLM, cfg, tokens, prefix_embeds,
                    remat: bool = False):
    """(final-normed hidden states, summed load-balance loss).  With
    ``remat`` each layer of the periods (not the prefix stack) runs under
    ``cfg.remat``, as the reference's scan body over the periods does."""
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    positions = _positions(x)
    n_prefix = len(period_structure(cfg)[0])
    aux_sum = torch.zeros((), device=x.device)
    for i, layer in enumerate(params.layers):
        if remat and i >= n_prefix:
            x, lb = _remat_layer(cfg, _layer_out, layer, cfg, x, positions,
                                 compute_dtype)
        else:
            x, lb = _layer_out(layer, cfg, x, positions, compute_dtype)
        aux_sum = aux_sum + lb
    return norm_apply(params.final_norm, x, cfg.norm), aux_sum


@torch.no_grad()
def hidden_states(params: DecoderLM, cfg: ModelConfig, tokens, *,
                  prefix_embeds=None):
    """The final-normed hidden states (B, P+S, d) of :func:`forward`, whose
    logits at chosen positions are ``_unembed(params, cfg, h[:, idx])``."""
    return _forward_hidden(params, cfg, tokens, prefix_embeds)[0]


def train_forward(params: DecoderLM, cfg: ModelConfig, tokens, *,
                  prefix_embeds=None, remat: bool = True):
    """:func:`forward` that carries gradients (the loss's forward): the
    same logits and aux, attention on its train route wherever q requires
    grad, and with ``remat`` each period layer under ``cfg.remat``."""
    x, aux_sum = _forward_hidden(params, cfg, tokens, prefix_embeds, remat)
    return _unembed(params, cfg, x), {"load_balance_loss": aux_sum}


@torch.no_grad()
def forward(params: DecoderLM, cfg: ModelConfig, tokens, *,
            prefix_embeds=None):
    """tokens: (B, S) -> logits (B, P+S, vocab) fp32 and the reference's
    aux dict: the MoE layers' summed ``load_balance_loss`` (0 without).

    ``prefix_embeds`` (B, P, d) are prepended (VLM patch stub)."""
    return train_forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                         remat=False)


# --------------------------------------------------------------------------
# caches / prefill / decode
# --------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, kind, batch, max_len, dtype, device):
    """One layer's cache: GQA's and MLA's whole, Mamba's and RWKV-6's of
    the channels or heads this process runs (``rules.model_blocks``: all
    of them off a process mesh)."""
    mixer = kind[0]
    if mixer == "attn":
        return attn.init_gqa_cache(cfg, batch, max_len, dtype, device=device)
    if mixer == "mla":
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device=device)
    if mixer == "mamba":
        return mam.init_mamba_cache(cfg, batch, dtype, device=device)
    return rwkv_mod.init_rwkv_cache(cfg, batch, dtype, device=device)


#: one device: the mesh under which a layer's cache is whole
_ONE_DEVICE = MeshShape(("data", "model"), (1, 1))


def _block_layer_cache(cfg: ModelConfig, kind, batch, max_len, dtype,
                       device, whole: dict, blocks: dict, mesh) -> dict:
    """One layer's cache on a process mesh: each leaf its ``blocks``
    block of the global ``whole`` (``rules.cache_blocks``), carrying its
    ``spec`` and ``global_shape``.  GQA's and MLA's are allocated as the
    blocks; Mamba's and RWKV-6's as today's local channels and heads,
    which must be their blocks; a GQA block cut over ``model`` on the kv
    heads must be the heads ``attention.head_split`` reads."""
    mixer = kind[0]
    for name, blk in blocks.items():
        if blk.shape[0] != batch:
            raise ValueError(
                f"cache leaf {name}: cache_specs gives a block of "
                f"{blk.shape[0]} of the {whole[name].shape[0]} global rows "
                f"({blk.spec!r}), the process serves {batch}; serve the "
                "whole batch on every process with "
                "rules.use_mesh(replicated_batch=True) only where the "
                "batch does not split over the batch axes")
    if mixer in ("attn", "mla"):
        out = {name: torch.zeros(blk.shape, dtype=whole[name].dtype,
                                 device=device)
               for name, blk in blocks.items()}
        spec = blocks.get("k", blocks.get("c_kv")).spec
        if mixer == "attn" and len(spec) > 2 and spec[2] == "model":
            sp = attn.head_split(cfg, mesh)
            if (blocks["k"].shape[2], blocks["k"].start[2]) != (sp.nk,
                                                                sp.k0):
                raise RuntimeError(
                    f"the kv-head block {blocks['k']} is not the heads "
                    f"{sp.k0}..{sp.k0 + sp.nk} this process's query heads "
                    "read")
    else:
        out = _layer_cache(cfg, kind, batch, max_len, dtype, device)
        for name, t in out.items():
            if tuple(t.shape) != blocks[name].shape:
                raise RuntimeError(f"{mixer} cache leaf {name} {tuple(t.shape)}"
                                   f" is not its block {blocks[name]}")
    for name, t in out.items():
        t.spec, t.global_shape = blocks[name].spec, tuple(whole[name].shape)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device="cuda"):
    """``{"layers": [one cache per layer]}``, zeroed: ``k``/``v`` (GQA),
    ``c_kv``/``k_rope`` (MLA), ``conv``/``h`` (Mamba) or ``s``/``x_tm``/
    ``x_cm`` (RWKV) of ``batch`` rows and ``max_len`` positions.  Inside
    ``rules.use_mesh`` of a process mesh every leaf is this process's
    block of the global cache under the reference's ``cache_specs``
    (``rules.cache_blocks``, ``seq_shard`` at global batch 1:
    ``rules.cache_global_batch``), carrying its ``spec`` and
    ``global_shape``: a GQA cache holds its block of the kv heads where
    they divide ``model``, else every kv head and its block of the
    sequence over ``model`` (at global batch 1 the sequence also over
    ``data``); an MLA cache its block of the sequence over ``model`` (and
    ``data`` at global batch 1); a Mamba cache its ``d_inner / model``
    channels' window and state, an RWKV-6 cache its ``H / model`` heads'
    states (the shifts whole).  A spec that maps an axis twice (the
    reference's at batch 1 on a mesh whose ``data`` is 1 wide) raises."""
    device = resolve_device(device)
    kinds = layer_kinds(cfg)
    ctx = rules.current_mesh()
    if ctx is None or not hasattr(ctx.mesh, "members"):
        return {"layers": [_layer_cache(cfg, k, batch, max_len, dtype, device)
                           for k in kinds]}
    gb = rules.cache_global_batch(batch)
    with rules.use_mesh(_ONE_DEVICE):
        whole = {"layers": [_layer_cache(cfg, k, gb, max_len, dtype,
                                         torch.device("meta"))
                            for k in kinds]}
    blocks = rules.cache_blocks(ctx.mesh, whole, seq_shard=gb == 1)
    return {"layers": [
        _block_layer_cache(cfg, k, batch, max_len, dtype, device, w, b,
                           ctx.mesh)
        for k, w, b in zip(kinds, whole["layers"], blocks["layers"])]}


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
    rules.check_cache_blocks(cache, tokens.shape[0])
    compute_dtype = getattr(torch, cfg.dtype)
    x = _embed(params, cfg, tokens, prefix_embeds, compute_dtype)
    positions = _positions(x)
    for i, layer in enumerate(params.layers):
        x, cache["layers"][i] = _apply_layer_prefill(
            layer, cfg, x, positions, cache["layers"][i], compute_dtype)
    x = norm_apply(params.final_norm, x[:, -1:, :], cfg.norm)
    return _unembed(params, cfg, x, whole=True), cache


def _unembed(params: DecoderLM, cfg, x, *, whole: bool = False):
    """Logits in fp32 from x in the compute dtype; on a process mesh whose
    ``model`` cuts the vocab, this process's block of it (a
    column-parallel product), or, with ``whole``, every block gathered."""
    compute_dtype = getattr(torch, cfg.dtype)
    if cfg.tie_embeddings:
        return unembed_tied(params.embed.table, x, compute_dtype,
                            whole=whole)
    w, spec = rules.gather_fsdp(params.unembed.w, compute_dtype)
    return _vocab_product(x.to(compute_dtype), w,
                          len(spec) > 1 and spec[1] == "model", whole)


def unembed_tied(table, x, compute_dtype, *, whole: bool = False):
    """Logits in fp32 of ``x`` against the embedding ``table`` (tied),
    both in ``compute_dtype``: the table's ``d`` gathered over ``data``,
    and where ``model`` cuts its vocab this process's block of the logits
    (or, with ``whole``, every block gathered)."""
    w, spec = rules.gather_fsdp(table, compute_dtype)
    return _vocab_product(x.to(compute_dtype), w.t(),
                          len(spec) > 0 and spec[0] == "model", whole)


def _vocab_product(x, w, cut: bool, whole: bool):
    """``x @ w`` in fp32 where ``w`` (d, vocab) is whole, else a
    column-parallel product over ``model`` (``x`` entering through
    ``sum_grad``), gathered over ``model`` with ``whole``."""
    if not cut:
        return matmul_f32(x, w)
    mesh = rules.process_mesh()
    logits = matmul_f32(coll.sum_grad(x, mesh, ("model",)), w)
    if whole:
        return coll.gather_blocks(logits, mesh, ("model",), -1)
    return logits


def vocab_mesh(params: DecoderLM):
    """The process mesh whose ``model`` cuts the logits of
    :func:`train_forward` into vocab blocks, else None."""
    if params.cfg.tie_embeddings:
        return vocab_cut_mesh(params.embed.table, 0)
    return vocab_cut_mesh(params.unembed.w, 1)


def vocab_cut_mesh(w, dim: int):
    """The process mesh whose ``model`` cuts dim ``dim`` (the vocab) of
    the output matrix ``w``, else None."""
    spec = rules.spec_of(w)
    if dim < len(spec) and spec[dim] == "model":
        return rules.process_mesh()
    return None


@torch.no_grad()
def decode_step(params: DecoderLM, cfg: ModelConfig, token, pos, cache):
    """token: (B,) ids; pos: (B,) positions.  Returns (logits (B, vocab)
    fp32, cache)."""
    rules.check_cache_blocks(cache, token.shape[0])
    compute_dtype = getattr(torch, cfg.dtype)
    x = _lookup(params.embed.table, token[:, None], compute_dtype)
    for i, layer in enumerate(params.layers):
        x, cache["layers"][i] = _apply_layer_step(
            layer, cfg, x, pos, cache["layers"][i], compute_dtype)
    x = norm_apply(params.final_norm, x, cfg.norm)
    return _unembed(params, cfg, x, whole=True)[:, 0], cache
