"""Train-step builder: gradient accumulation, clipping, optimizer, metrics.

The port of the reference package's ``train/loop.py`` for a model with the
substrate interface: ``model.init(generator, dtype=)`` returns the
parameters and ``model.loss(params, batch)`` returns ``(loss, metrics)``,
0-d tensors.  ``make_train_step`` returns ``train_step(params, opt_state,
batch, step) -> (params, opt_state, metrics)``; nothing is compiled, and
each call takes one optimizer step.

The parameters are a tree of tensors (nested dicts, lists, tuples), or an
``nn.Module`` (the LM face's ``DecoderLM`` / ``EncDecLM``).  A module's
tree is ``dict(module.named_parameters())`` (:func:`param_tree`): the
step differentiates with respect to those tensors, its optimizer state
is keyed by their names, and the update is written back into the module
in place, leaf by leaf, so that no second copy of the parameters or the
state is ever held (at 3 B parameters in fp32 that copy alone is
37 GB).  A tree of tensors is updated functionally, as the reference
does.

* ``microbatches == 1``: one ``torch.autograd.grad`` of the loss over the
  whole batch;
* ``microbatches > 1``: the batch's leading axis is split into equal
  microbatches, and their gradients summed in ``TrainConfig.acc_dtype``
  and averaged; the loss and each metric are averaged over them.

``TrainConfig.gather_once`` with microbatches differentiates through one
parameter gather of the reference's sharding rules, which the port does
not have yet: it raises.  ``grad_transform`` (optional) is applied to the
accumulated gradients before clipping.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.train import optimizer as opt_mod

__all__ = ["make_train_step", "init_train_state", "param_tree"]


def param_tree(params):
    """The tree the optimizer walks: a module's named parameters, or the
    tree itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def init_train_state(model, tcfg: TrainConfig, generator):
    """``(params, opt_state)`` from ``model.init(generator, dtype=)`` in
    ``tcfg.param_dtype``."""
    params = model.init(generator, dtype=opt_mod.torch_dtype(
        tcfg.param_dtype))
    return params, opt_mod.init_opt_state(tcfg, param_tree(params))


def _value_and_grad(model, params, batch):
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``; a
    module's grads are keyed by its parameters' names."""
    detach = lambda x: x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(params, nn.Module):
        named = param_tree(params)
        for p in named.values():
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
        finally:
            for p in named.values():
                p.requires_grad_(False)
        return (loss.detach(), opt_mod.tree_map(detach, metrics),
                dict(zip(named, grads)))
    leaves = [p.detach().requires_grad_(True)
              for p in opt_mod.tree_leaves(params)]
    loss, metrics = model.loss(opt_mod.tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), opt_mod.tree_map(detach, metrics),
            opt_mod.tree_unflatten(params, grads))


def _update_module(tcfg: TrainConfig, module, grads: dict, opt_state: dict,
                   step):
    """``apply_updates`` one parameter at a time, written into ``module``
    and ``opt_state`` in place: the same elementwise update as on the
    whole tree, holding one leaf's new values at a time."""
    for name, p in module.named_parameters():
        leaf = {part: {name: tree[name]} for part, tree in opt_state.items()}
        new_p, new_s = opt_mod.apply_updates(tcfg, {name: p},
                                             {name: grads.pop(name)}, leaf,
                                             step)
        with torch.no_grad():
            p.copy_(new_p[name])
        for part in opt_state:
            opt_state[part][name] = new_s[part][name]
    return module, opt_state


def make_train_step(model, tcfg: TrainConfig, *, microbatches: int = 1,
                    grad_transform: Callable[[Any], Any] | None = None):
    """Build the step; see the module docstring."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def train_step(params, opt_state, batch, step):
        tree = param_tree(params)
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(model, params, batch)
        elif tcfg.gather_once:
            raise NotImplementedError(
                "TrainConfig.gather_once with microbatches > 1 needs the "
                "reference's sharding/rules.gather_params_once, not ported "
                "yet (ROADMAP Queue 1 item 3)")
        else:
            def slice_mb(a):
                b = a.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch of {b} does not split into "
                                     f"{microbatches} microbatches")
                return a.reshape(microbatches, b // microbatches,
                                 *a.shape[1:])
            mbs = opt_mod.tree_map(slice_mb, batch)
            acc_dt = opt_mod.torch_dtype(tcfg.acc_dtype)
            grads = opt_mod.tree_map(
                lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                      device=p.device), tree)
            loss = torch.zeros((), dtype=torch.float32,
                               device=opt_mod.tree_leaves(tree)[0].device)
            mets = []
            for i in range(microbatches):
                mb = opt_mod.tree_map(lambda a: a[i], mbs)
                l, met, g = _value_and_grad(model, params, mb)
                grads = opt_mod.tree_map(lambda a, b: a + b.to(acc_dt),
                                         grads, g)
                loss = loss + l
                mets.append(met)
            grads = opt_mod.tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = opt_mod.tree_map(
                lambda *m: torch.mean(torch.stack(m)), *mets)

        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = opt_mod.clip_by_norm(grads, tcfg.grad_clip)
        if isinstance(params, nn.Module):
            new_params, new_opt = _update_module(tcfg, params, grads,
                                                 opt_state, step)
        else:
            new_params, new_opt = opt_mod.apply_updates(
                tcfg, params, grads, opt_state, step)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return train_step
