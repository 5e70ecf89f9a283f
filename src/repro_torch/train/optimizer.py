"""Optimizers: AdamW, Adafactor (factored second moment), SGD - functions of
nested dicts of tensors.

The port of the reference package's ``train/optimizer.py``, op for op.
Parameters, gradients and optimizer state are trees: nested dicts (or
lists and tuples) with tensor leaves, walked by :func:`tree_map`.

* AdamW keeps fp32 ``m``/``v`` (and an fp32 master copy when the params
  are stored in another dtype, ``TrainConfig.param_dtype``).
* Adafactor factors the second moment over the last two dims (row and
  column fp32 vectors) and updates params in their storage dtype.
* SGD keeps an fp32 momentum.

The reference stacks each period slot's layers of a decoder ``(n_periods,
...)`` and Adafactor updates the stacked leaf: it factors over the
stacked shape's last two dims (a norm scale ``(n_periods, d)`` gets
``v_row (n_periods,)`` and ``v_col (d,)``) and takes the update's RMS
clip over the whole stacked leaf.  A module that keeps one leaf per layer
says which layers one slot stacks (``DecoderLM.period_slots``; an
``EncDecLM`` stacks each of its two stacks, as the reference does);
:func:`init_opt_state` on such a module keeps Adafactor's state in the
stacked shapes, named ``period.{j}.<leaf>``, and :func:`update_module`
updates each slot as the reference's stacked leaf without stacking it:
a first pass updates the moments and sums the update's squares, a second
recomputes the update and writes it.  A slot of 1-d leaves is small and
is stacked (``n_periods * d`` fp32 values), since its column moment is a
mean across the layers.  Prefix layers, the embeddings, the unembedding,
AdamW and SGD are elementwise or unstacked, and are updated leaf by leaf.

On a process mesh a leaf may be a block of the global leaf (FSDP over
``data``, tensor parallelism over ``model``, experts over the expert
axes; ``sharding.rules``).  AdamW and SGD are elementwise, so a block's
state is its block of the global state.  Adafactor's factored moments
(``v_row``, ``v_col``) are held whole over the factored dims (the last
two; the leading ones, such as the experts, stay cut): they are means
over the global leaf, which the train step's ``factored`` hook takes
across the processes (``train.loop``), and they are small; each process
then reads its rows and columns of them.  The RMS clip of an update
runs over the whole global leaf through the ``reduce_sq`` hook.

Every function runs under ``torch.no_grad()``: it updates leaves that a
train step differentiated, it is not itself differentiated.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.sharding.rules import global_shape

__all__ = ["init_opt_state", "apply_updates", "update_module", "global_norm",
           "clip_by_norm", "clip_by_norm_", "stacked_slots", "tree_map", "tree_leaves",
           "tree_unflatten", "torch_dtype"]


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the leaves at the same paths
    of ``rest``); dicts (in sorted key order, as JAX walks them), lists and
    tuples are walked, anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` (in
    :func:`tree_leaves`' order) as its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / ... (or a dtype) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# --------------------------------------------------------------------------

@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_norm(tree, max_norm: float):
    """``(tree scaled to global norm <= max_norm, the global norm before)``."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda leaf: (leaf.to(torch.float32) * scale
                                  ).to(leaf.dtype), tree), g


@torch.no_grad()
def clip_by_norm_(tree, max_norm: float, *, norm=None):
    """:func:`clip_by_norm` in place (the same values): a module's step
    holds no second copy of its gradients.  ``norm`` is the global norm
    when the caller has it (a mesh counts each sharded leaf once,
    :func:`repro_torch.train.loop.make_train_step`)."""
    g = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    for leaf in tree_leaves(tree):
        leaf.copy_(leaf.to(torch.float32) * scale)
    return tree, g


def _zeros32(p, shape=None):
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def stacked_slots(params) -> dict[str, list[str]]:
    """``{stacked name: [per-layer parameter names, in period order]}`` of
    a module that stacks its period layers as the reference does
    (``period_slots``), else ``{}``."""
    slots = getattr(params, "period_slots", None)
    return slots() if callable(slots) else {}


def _factored_zeros(p, lead=()):
    """Adafactor's ``(v_row, v_col)`` of leaf ``p`` stacked under ``lead``
    dims, on ``p``'s device: factored over the last two dims from 2 dims
    up, whose global sizes it takes (a block's factored moments are held
    whole)."""
    shape = tuple(lead) + tuple(p.shape)
    if len(shape) >= 2:
        shape = shape[:-2] + (tuple(lead) + global_shape(p))[-2:]
        return (_zeros32(p, shape[:-1]),
                _zeros32(p, shape[:-2] + shape[-1:]))
    return _zeros32(p, shape), _zeros32(p, (1,))


@torch.no_grad()
def init_opt_state(cfg: TrainConfig, params) -> dict[str, Any]:
    """The optimizer state of ``params``: a tree, or a module (keyed by its
    parameters' names).  Adafactor's state of a module that stacks
    (:func:`stacked_slots`) holds each slot's moments in the reference's
    stacked shapes."""
    slots = stacked_slots(params) if cfg.optimizer == "adafactor" else {}
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    if slots:
        in_slot = {n for names in slots.values() for n in names}
        state = {"v_row": {}, "v_col": {}}
        for name, p in params.items():
            if name not in in_slot:
                state["v_row"][name], state["v_col"][name] = \
                    _factored_zeros(p)
        for slot, names in slots.items():
            state["v_row"][slot], state["v_col"][slot] = _factored_zeros(
                params[names[0]], (len(names),))
        return state
    if cfg.optimizer == "adamw":
        state = {"m": tree_map(_zeros32, params),
                 "v": tree_map(_zeros32, params)}
        if torch_dtype(cfg.param_dtype) != torch.float32:
            state["master"] = tree_map(lambda p: p.to(torch.float32),
                                       params)
        return state
    if cfg.optimizer == "adafactor":
        def vr(p):
            return _zeros32(p, p.shape[:-1] if p.dim() >= 2 else p.shape)

        def vc(p):
            return _zeros32(p, p.shape[:-2] + p.shape[-1:]
                            if p.dim() >= 2 else (1,))

        return {"v_row": tree_map(vr, params), "v_col": tree_map(vc, params)}
    if cfg.optimizer == "sgd":
        return {"m": tree_map(_zeros32, params)}
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@torch.no_grad()
def apply_updates(cfg: TrainConfig, params, grads, state, step):
    """Returns ``(new_params, new_state)``.  ``step`` is 0-based: an int or
    a 0-d tensor."""
    dev = tree_leaves(params)[0].device
    t = torch.as_tensor(step, device=dev).to(torch.float32) + 1
    if cfg.optimizer == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.to(torch.float32)), state["v"], grads)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        master = state.get("master", params)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
            p32 = p.to(torch.float32)
            return p32 - cfg.lr * (u + cfg.weight_decay * p32)

        new_master = tree_map(upd, master, m, v)
        new_state = {"m": m, "v": v}
        if "master" in state:
            new_state["master"] = new_master
        new_params = tree_map(lambda nm, p: nm.to(p.dtype), new_master,
                              params)
        return new_params, new_state

    if cfg.optimizer == "adafactor":
        decay = _adafactor_decay(t)

        def upd(p, g, vr, vc):
            g32 = g.to(torch.float32)
            vr_n, vc_n = _adafactor_moments(g32, vr, vc, decay,
                                            p.dim() >= 2)
            u = _adafactor_u(g32, vr_n, vc_n, p.dim() >= 2)
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(torch.square(u)) + _AF_EPS)
            return _adafactor_write(cfg, p, u, rms), vr_n, vc_n

        out = [upd(p, g, vr, vc) for p, g, vr, vc in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state["v_row"]), tree_leaves(state["v_col"]))]
        new_params = tree_unflatten(params, [o[0] for o in out])
        new_state = {"v_row": tree_unflatten(params, [o[1] for o in out]),
                     "v_col": tree_unflatten(params, [o[2] for o in out])}
        return new_params, new_state

    if cfg.optimizer == "sgd":
        m = tree_map(lambda m_, g: cfg.beta1 * m_ + g.to(torch.float32),
                     state["m"], grads)
        new_params = tree_map(lambda p, m_: (p.to(torch.float32)
                                             - cfg.lr * m_).to(p.dtype),
                              params, m)
        return new_params, {"m": m}

    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


# --------------------------------------------------------------------------
# Adafactor's pieces, and the update of a module that stacks
# --------------------------------------------------------------------------

_AF_EPS = 1e-30


def _adafactor_decay(t):
    return 1.0 - t ** -0.8   # Shazeer-Stern schedule


def _adafactor_moments(g32, vr, vc, decay, factored: bool, cut=None):
    """The new ``(v_row, v_col)`` of a leaf's gradient ``g32``; ``cut``
    (a block of a leaf whose factored dims are cut) takes the row and
    column means over the global leaf."""
    g2 = torch.square(g32) + _AF_EPS
    if factored:
        rm, cm = ((torch.mean(g2, dim=-1), torch.mean(g2, dim=-2))
                  if cut is None else cut.means(g2))
        return decay * vr + (1 - decay) * rm, decay * vc + (1 - decay) * cm
    return decay * vr + (1 - decay) * g2, vc


def _adafactor_u(g32, vr_n, vc_n, factored: bool, cut=None):
    """The unclipped update of a leaf (or of ``cut``'s block of it) from
    its new moments."""
    if factored:
        # factored approximation: V ~ (vr / mean(vr)) outer vc
        r = vr_n / torch.clamp(torch.mean(vr_n, dim=-1, keepdim=True),
                               min=_AF_EPS)
        if cut is not None:
            r, vc_n = cut.block(r, vc_n)
        denom = torch.sqrt(r[..., None] * vc_n[..., None, :])
        return g32 / torch.clamp(denom, min=_AF_EPS)
    return g32 / torch.clamp(torch.sqrt(vr_n), min=_AF_EPS)


def _adafactor_write(cfg: TrainConfig, p, u, rms):
    """``p`` moved by the update ``u`` clipped to RMS 1 (``rms`` is its
    RMS), in ``p``'s dtype."""
    u = u / torch.clamp(rms, min=1.0)
    p32 = p.to(torch.float32)
    return (p32 - cfg.lr * u - cfg.lr * cfg.weight_decay * p32).to(p.dtype)


def _no_reduce(name, sq_sum, count):
    return sq_sum, count


def _no_cut(name):
    return None


@torch.no_grad()
def update_module(cfg: TrainConfig, module: nn.Module, grads: dict,
                  state: dict, step, *,
                  reduce_sq: Callable | None = None,
                  factored: Callable | None = None):
    """:func:`apply_updates` on a module, written into its parameters and
    into ``state`` in place, holding one leaf's new values at a time
    (``grads`` is emptied as it goes).  Adafactor updates a stacked slot
    as the reference's stacked leaf (module docstring).
    ``reduce_sq(name, sum of squares, element count)`` gives a leaf's sum
    of squared updates and element count over the whole leaf where a rank
    holds a block of it (a mesh's cut leaves); ``factored(name)`` gives
    the cut (``means``, ``block``) of a leaf or slot whose factored dims
    a mesh cuts, else None; by default the block is the leaf."""
    reduce_sq = reduce_sq or _no_reduce
    factored = factored or _no_cut
    named = dict(module.named_parameters())
    slots = stacked_slots(module) if cfg.optimizer == "adafactor" else {}
    if slots and not set(slots) <= set(state["v_row"]):
        raise ValueError(
            "Adafactor on a module that stacks its period layers needs "
            "the stacked state: init_opt_state(tcfg, module)")
    in_slot = {n for names in slots.values() for n in names}
    dev = next(iter(named.values())).device
    t = torch.as_tensor(step, device=dev).to(torch.float32) + 1
    for name, p in named.items():
        if name in in_slot:
            continue
        g = grads.pop(name)
        if cfg.optimizer == "adafactor":
            g32 = g.to(torch.float32)
            vr, vc = state["v_row"][name], state["v_col"][name]
            fac, cut = p.dim() >= 2, factored(name)
            vr_n, vc_n = _adafactor_moments(g32, vr, vc,
                                            _adafactor_decay(t), fac, cut)
            u = _adafactor_u(g32, vr_n, vc_n, fac, cut)
            sq, n = reduce_sq(name, torch.sum(torch.square(u)), u.numel())
            p.copy_(_adafactor_write(cfg, p, u,
                                     torch.sqrt(sq / n + _AF_EPS)))
            state["v_row"][name], state["v_col"][name] = vr_n, vc_n
            continue
        leaf = {part: {name: tree[name]} for part, tree in state.items()}
        new_p, new_s = apply_updates(cfg, {name: p}, {name: g}, leaf, step)
        p.copy_(new_p[name])
        for part in state:
            state[part][name] = new_s[part][name]
    for slot, names in slots.items():
        _update_slot(cfg, slot, [named[n] for n in names],
                     [grads.pop(n) for n in names], state, t, reduce_sq,
                     factored(slot))
    return module, state


def _update_slot(cfg: TrainConfig, slot: str, ps: list, gs: list,
                 state: dict, t, reduce_sq, cut) -> None:
    """Adafactor on the stacked leaf ``(len(ps), *p.shape)`` of one slot,
    its moments ``state[...][slot]`` updated in place (``cut``: the
    slot's factored cut, of the stacked leaf for 1-d leaves and of each
    layer's leaf otherwise)."""
    decay = _adafactor_decay(t)
    vr, vc = state["v_row"][slot], state["v_col"][slot]
    if ps[0].dim() == 1:
        # the column moment is a mean across the layers: stack the slot
        g32 = torch.stack([g.to(torch.float32) for g in gs])
        vr_n, vc_n = _adafactor_moments(g32, vr, vc, decay, True, cut)
        u = _adafactor_u(g32, vr_n, vc_n, True, cut)
        sq, n = reduce_sq(slot, torch.sum(torch.square(u)), u.numel())
        rms = torch.sqrt(sq / n + _AF_EPS)
        for p, u_p in zip(ps, u):
            p.copy_(_adafactor_write(cfg, p, u_p, rms))
        vr.copy_(vr_n)
        vc.copy_(vc_n)
        return
    # layer p's moments are the stacked ones' slice p: first pass the
    # moments and the squares' sum, second the update, recomputed
    sq = torch.zeros((), dtype=torch.float32, device=vr.device)
    for i, g in enumerate(gs):
        g32 = g.to(torch.float32)
        vr_n, vc_n = _adafactor_moments(g32, vr[i], vc[i], decay, True, cut)
        vr[i].copy_(vr_n)
        vc[i].copy_(vc_n)
        sq = sq + torch.sum(torch.square(_adafactor_u(g32, vr_n, vc_n,
                                                      True, cut)))
    sq, n = reduce_sq(slot, sq, len(ps) * ps[0].numel())
    rms = torch.sqrt(sq / n + _AF_EPS)
    for i, (p, g) in enumerate(zip(ps, gs)):
        u = _adafactor_u(g.to(torch.float32), vr[i], vc[i], True, cut)
        p.copy_(_adafactor_write(cfg, p, u, rms))
