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

Every function runs under ``torch.no_grad()``: it updates leaves that a
train step differentiated, it is not itself differentiated.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import TrainConfig

__all__ = ["init_opt_state", "apply_updates", "global_norm", "clip_by_norm",
           "tree_map", "tree_leaves", "tree_unflatten", "torch_dtype"]


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


def _zeros32(p, shape=None):
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


@torch.no_grad()
def init_opt_state(cfg: TrainConfig, params) -> dict[str, Any]:
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
        eps = 1e-30
        decay = 1.0 - t ** -0.8   # Shazeer-Stern schedule

        def upd(p, g, vr, vc):
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + eps
            if p.dim() >= 2:
                vr_n = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
                vc_n = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
                # factored approximation: V ~ (vr / mean(vr)) outer vc
                r = vr_n / torch.clamp(
                    torch.mean(vr_n, dim=-1, keepdim=True), min=eps)
                denom = torch.sqrt(r[..., None] * vc_n[..., None, :])
                u = g32 / torch.clamp(denom, min=eps)
            else:
                vr_n = decay * vr + (1 - decay) * g2
                vc_n = vc
                u = g32 / torch.clamp(torch.sqrt(vr_n), min=eps)
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms, min=1.0)
            p32 = p.to(torch.float32)
            newp = p32 - cfg.lr * u - cfg.lr * cfg.weight_decay * p32
            return newp.to(p.dtype), vr_n, vc_n

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
