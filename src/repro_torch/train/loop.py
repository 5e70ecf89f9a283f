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
its own blocks of the parameters (``sharding.rules.local_specs``: for
every model, decoder-only whatever its mixers or the encoder-decoder,
the reference's ``param_specs``, FSDP over ``data`` and tensor
parallelism over ``model``), in the local view of
:mod:`repro_torch.sharding.collectives`.  A leaf is reduced, normed and
updated by its spec alone, whatever its kind (a 1-d leaf or a
``conv_w`` cut over ``model``, an ``a_log`` whose rows are):

* a leaf cut over ``data`` is gathered where it is used, and the
  gather's backward already summed its gradient over ``data``; it is
  summed over ``pod`` only and divided by the batch blocks;
* a replicated or ``model``-only leaf's gradient is the full gradient
  of the process's block loss; it is averaged over the batch axes
  (``pod``, ``data``), so the processes along ``model``, which hold the
  same block, hold the same bits;
* an expert stack's gradient stays with its owner: summed over the axes
  that do not own the experts (where those hold copies) and divided by
  the batch blocks, the global loss's gradient;
* the global norm of ``clip_by_norm`` counts every leaf once (a block's
  squares summed over the axes that cut it), Adafactor's RMS clip runs
  over each whole global leaf, and its factored moments are the means
  over the global leaf (:class:`FactoredCut`);
* the loss and the metrics are averaged over the batch axes.

A tree of tensors (a substrate model's parameters, such as the SNN
classifier's) carries no specs: on a process mesh every leaf is
replicated, as the reference's SPMD holds a pytree with no shardings.
Each leaf's gradient is then the replicated leaf's above, summed over
the batch axes and divided by the batch blocks, the same bits on every
process; the clip reads the same global norm everywhere, and
``optimizer.apply_updates`` updates every process's copy alike.
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
    """The axes that own the experts; ``()`` for a model with no MoE, or
    with no ``cfg`` at all (a substrate model)."""
    cfg = getattr(model, "cfg", None)
    if getattr(cfg, "moe", None) is None:
        return ()
    return rules.expert_axes_for(mesh, cfg.moe.n_experts)


def _is_expert(name: str, exp_ax) -> bool:
    """An expert stack's leaf, or a stacked slot's (``period.{j}.``)."""
    return bool(exp_ax) and bool(_EXPERT_NAME.search(name))


def _cut_axes(spec, dims=None) -> tuple[str, ...]:
    """The mesh axes that cut a spec's entries (those of ``dims``)."""
    out = []
    for i, e in enumerate(spec):
        if dims is None or i in dims:
            out += rules._axes(e)
    return tuple(out)


def _reduce_over_mesh(mesh, exp_ax, specs, loss, metrics, grads: dict):
    """The local gradients (by parameter name) as the global loss's:
    a leaf cut over ``data`` summed over ``pod``, a replicated or
    ``model``-only leaf over ``pod`` and ``data``, an expert stack over
    the axes that do not own it; each then divided by the batch blocks.
    The loss and metrics averaged over the batch axes."""
    batch_ax = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_b = mesh.axis_size(batch_ax)
    other = tuple(a for a in mesh.axis_names if a not in exp_ax)
    out = {}
    for name in list(grads):
        if _is_expert(name, exp_ax):
            axes = other
        else:
            cut = _cut_axes(specs[name])
            axes = tuple(a for a in batch_ax if a not in cut)
        out[name] = coll.all_reduce_sum(grads.pop(name), mesh, axes) / n_b
    mean = lambda t: coll.all_reduce_sum(t, mesh, batch_ax) / n_b
    return mean(loss), opt_mod.tree_map(mean, metrics), out


class FactoredCut:
    """Adafactor's factored moments of a block whose last two dims are
    cut over ``row_axes`` and ``col_axes`` (of a leaf with ``rows`` x
    ``cols`` global): :meth:`means` gives the row and column means of the
    squared gradient over the global leaf, whole on every process, and
    :meth:`block` this process's rows and columns of them."""

    def __init__(self, mesh, row_axes, col_axes, rows: int, cols: int):
        self.mesh, self.rows, self.cols = mesh, rows, cols
        self.row_axes, self.col_axes = row_axes, col_axes

    def means(self, g2):
        mesh = self.mesh
        r = coll.all_reduce_sum(g2.sum(-1), mesh, self.col_axes) / self.cols
        c = coll.all_reduce_sum(g2.sum(-2), mesh, self.row_axes) / self.rows
        return (coll.gather_blocks(r, mesh, self.row_axes, -1),
                coll.gather_blocks(c, mesh, self.col_axes, -1))

    def block(self, r, c):
        return (_own(r, self.mesh, self.row_axes),
                _own(c, self.mesh, self.col_axes))


def _own(t, mesh, axes):
    """This process's block of ``t``'s last dim over ``axes``."""
    n = t.shape[-1] // mesh.axis_size(axes)
    i = mesh.axis_index(axes)
    return t[..., i * n:(i + 1) * n]


def _mesh_hooks(mesh, module, specs):
    """``update_module``'s ``reduce_sq`` and ``factored`` hooks for the
    blocks of ``module``'s leaves (a stacked slot by its layers' spec)."""
    named = dict(module.named_parameters())
    slots = opt_mod.stacked_slots(module)
    first = {slot: names[0] for slot, names in slots.items()}

    def reduce_sq(name, sq_sum, count):
        axes = _cut_axes(specs[first.get(name, name)])
        return (coll.all_reduce_sum(sq_sum, mesh, axes),
                count * mesh.axis_size(axes))

    def factored(name):
        p = named[first.get(name, name)]
        spec, shape = specs[first.get(name, name)], rules.global_shape(p)
        if name in first and p.dim() == 1:      # the stacked (n, d) leaf
            rows, cols = (), _cut_axes(spec, (0,))
            sizes = (len(slots[name]), shape[0])
        elif p.dim() >= 2:
            rows = _cut_axes(spec, (p.dim() - 2,))
            cols = _cut_axes(spec, (p.dim() - 1,))
            sizes = shape[-2:]
        else:
            return None
        if not rows and not cols:
            return None
        return FactoredCut(mesh, rows, cols, *sizes)

    return reduce_sq, factored


@torch.no_grad()
def _mesh_norm(mesh, grads: dict, specs):
    """The global gradient norm, each leaf counted once: the squares of
    the leaves cut by the same axes summed over them."""
    dev = next(iter(grads.values())).device
    by_axes = {}
    for name, g in grads.items():
        axes = _cut_axes(specs[name])
        by_axes[axes] = by_axes.get(axes, torch.zeros(
            (), dtype=torch.float32, device=dev)) + torch.sum(
                torch.square(g.to(torch.float32)))
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for axes in sorted(by_axes):
        total = total + coll.all_reduce_sum(by_axes[axes], mesh, axes)
    return torch.sqrt(total)


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
        norm = reduce_sq = factored = None
        if mesh is not None and isinstance(params, nn.Module):
            specs = {n: rules.spec_of(p) for n, p in tree.items()}
            loss, metrics, grads = _reduce_over_mesh(
                mesh, _expert_axes(model, mesh), specs, loss, metrics, grads)
            reduce_sq, factored = _mesh_hooks(mesh, params, specs)
        elif mesh is not None:
            # a tree of tensors: every leaf replicated (module docstring)
            flat = dict(enumerate(opt_mod.tree_leaves(grads)))
            loss, metrics, flat = _reduce_over_mesh(
                mesh, _expert_axes(model, mesh),
                dict.fromkeys(flat, rules.PartitionSpec()), loss, metrics,
                flat)
            grads = opt_mod.tree_unflatten(grads, list(flat.values()))
        if grad_transform is not None:
            grads = grad_transform(grads)
        if isinstance(params, nn.Module):
            if mesh is not None:
                norm = _mesh_norm(mesh, grads, specs)
            grads, gnorm = opt_mod.clip_by_norm_(grads, tcfg.grad_clip,
                                                 norm=norm)
            new_params, new_opt = opt_mod.update_module(
                tcfg, params, grads, opt_state, step, reduce_sq=reduce_sq,
                factored=factored)
        else:
            grads, gnorm = opt_mod.clip_by_norm(grads, tcfg.grad_clip)
            new_params, new_opt = opt_mod.apply_updates(
                tcfg, params, grads, opt_state, step)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return train_step
