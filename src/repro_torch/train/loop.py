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
bf16 copy of the parameters (``sharding.rules.gather_params_once``)
shared by every microbatch, each microbatch's forward recomputed in the
backward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` scan does: one backward for the step.
``grad_transform`` (optional) is applied to the accumulated gradients
before clipping.

**On a process mesh** (``sharding.rules.use_mesh`` with a
``ProcessMesh``), each process runs the step on its own batch block and
its own block of the expert stacks, in the local view of
:mod:`repro_torch.sharding.collectives`:

* a dense (replicated) parameter's gradient is the full gradient of the
  process's block loss; it is averaged over the batch axes (``pod``,
  ``data``), so the processes along ``model``, which hold the same block,
  hold the same bits;
* an expert stack's gradient stays with its owner: summed over the axes
  that do not own the experts (where those hold copies) and divided by
  the batch blocks, the global loss's gradient;
* the global norm of ``clip_by_norm`` counts each expert once (their
  squares summed over the expert axes), and Adafactor's RMS clip of an
  expert leaf runs over the whole global leaf;
* the loss and the metrics are averaged over the batch axes.

The reference shards the dense parameters FSDP over ``data`` and TP over
``model``; the port keeps them whole on every process (the same numbers,
more memory: ROADMAP Queue 1).
"""

from __future__ import annotations

import copy
import re
from typing import Any, Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TrainConfig
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules
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
    return params, opt_mod.init_opt_state(tcfg, params)


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


def _microbatches(batch, n: int):
    def slice_mb(a):
        b = a.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not split into {n} "
                             "microbatches")
        return a.reshape(n, b // n, *a.shape[1:])
    return opt_mod.tree_map(slice_mb, batch)


def _with_params(module: nn.Module, tensors: dict, prefix: str = ""):
    """A shallow copy of ``module`` whose parameters are ``tensors`` (by
    dotted name), the original untouched."""
    new = copy.copy(module)
    new._parameters = {k: None if v is None else tensors[prefix + k]
                       for k, v in module._parameters.items()}
    new._modules = {k: None if m is None else
                    _with_params(m, tensors, f"{prefix}{k}.")
                    for k, m in module._modules.items()}
    return new


def _gathered_value_and_grad(model, params, mbs, n: int):
    """``gather_once``: the mean of the ``n`` microbatches' losses of ONE
    bf16 copy of the parameters, differentiated once (each microbatch's
    forward recomputed in the backward)."""
    named = param_tree(params)
    leaves = opt_mod.tree_leaves(named)
    detach = lambda x: x.detach() if isinstance(x, torch.Tensor) else x
    for p in leaves:
        p.requires_grad_(True)
    try:
        cp = rules.gather_params_once(named)
        cparams = (_with_params(params, cp) if isinstance(params, nn.Module)
                   else cp)

        def micro(mb):
            return model.loss(cparams, mb)

        lsum, mets = 0.0, []
        for i in range(n):
            mb = opt_mod.tree_map(lambda a: a[i], mbs)
            l, met = checkpoint(micro, mb, use_reentrant=False)
            lsum = lsum + l
            mets.append(opt_mod.tree_map(detach, met))
        loss = lsum / n
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    metrics = opt_mod.tree_map(lambda *m: torch.mean(torch.stack(m)), *mets)
    return loss.detach(), metrics, opt_mod.tree_unflatten(named, grads)


def _process_mesh():
    """The current ``ProcessMesh`` of more than one process, or None."""
    ctx = rules.current_mesh()
    if ctx is None or not hasattr(ctx.mesh, "members") or ctx.mesh.size == 1:
        return None
    return ctx.mesh


_EXPERT_NAME = re.compile(r"(^|\.)moe\.(wi_gate|wi_up|wo)$")


def _expert_axes(model, mesh) -> tuple[str, ...]:
    cfg = model.cfg
    if getattr(cfg, "moe", None) is None:
        return ()
    return rules.expert_axes_for(mesh, cfg.moe.n_experts)


def _is_expert(name: str, exp_ax) -> bool:
    """An expert stack's leaf, or a stacked slot's (``period.{j}.``)."""
    return bool(exp_ax) and bool(_EXPERT_NAME.search(name))


def _reduce_over_mesh(mesh, exp_ax, loss, metrics, grads: dict):
    """The local gradients (by parameter name) as the global loss's:
    dense ones averaged over the batch axes, expert stacks summed over
    the axes that do not own them and divided by the batch blocks; the
    loss and metrics averaged over the batch axes."""
    batch_ax = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_b = mesh.axis_size(batch_ax)
    other = tuple(a for a in mesh.axis_names if a not in exp_ax)
    out = {}
    for name in list(grads):
        axes = other if _is_expert(name, exp_ax) else batch_ax
        out[name] = coll.all_reduce_sum(grads.pop(name), mesh, axes) / n_b
    mean = lambda t: coll.all_reduce_sum(t, mesh, batch_ax) / n_b
    return mean(loss), opt_mod.tree_map(mean, metrics), out


def _expert_sq(mesh, exp_ax):
    """``update_module``'s ``reduce_sq``: an expert leaf's (or slot's)
    sum of squares and element count over the whole global leaf."""
    def reduce_sq(name, sq_sum, count):
        if not _is_expert(name, exp_ax):
            return sq_sum, count
        return (coll.all_reduce_sum(sq_sum, mesh, exp_ax),
                count * mesh.axis_size(exp_ax))
    return reduce_sq


@torch.no_grad()
def _mesh_norm(mesh, grads: dict, exp_ax):
    """The global gradient norm, each expert counted once."""
    dev = next(iter(grads.values())).device
    dense, experts = (torch.zeros((), dtype=torch.float32, device=dev)
                      for _ in range(2))
    for name, g in grads.items():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        if _is_expert(name, exp_ax):
            experts = experts + sq
        else:
            dense = dense + sq
    if exp_ax:
        dense = dense + coll.all_reduce_sum(experts, mesh, exp_ax)
    return torch.sqrt(dense)


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
            loss, metrics, grads = _gathered_value_and_grad(
                model, params, _microbatches(batch, microbatches),
                microbatches)
        else:
            mbs = _microbatches(batch, microbatches)
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

        mesh = _process_mesh()
        norm = reduce_sq = None
        if mesh is not None:
            if not isinstance(params, nn.Module):
                raise TypeError("a train step on a process mesh updates "
                                "a module's parameters")
            exp_ax = _expert_axes(model, mesh)
            loss, metrics, grads = _reduce_over_mesh(mesh, exp_ax, loss,
                                                     metrics, grads)
            reduce_sq = _expert_sq(mesh, exp_ax)
        if grad_transform is not None:
            grads = grad_transform(grads)
        if isinstance(params, nn.Module):
            if mesh is not None:
                norm = _mesh_norm(mesh, grads, exp_ax)
            grads, gnorm = opt_mod.clip_by_norm_(grads, tcfg.grad_clip,
                                                 norm=norm)
            new_params, new_opt = opt_mod.update_module(
                tcfg, params, grads, opt_state, step, reduce_sq=reduce_sq)
        else:
            grads, gnorm = opt_mod.clip_by_norm(grads, tcfg.grad_clip)
            new_params, new_opt = opt_mod.apply_updates(
                tcfg, params, grads, opt_state, step)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return train_step
