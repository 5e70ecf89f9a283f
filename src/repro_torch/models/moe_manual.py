"""Manual expert-parallel MoE dispatch on a process mesh.

Ports ``src/repro/models/moe_manual.py``.  The reference's single-device
dispatch (:mod:`repro_torch.models.moe`) under XLA's partitioner would
replicate the token buffers over the mesh; this dispatch moves only the
routed tokens, as expert-parallel systems do:

* the expert stacks are expert-resident: the expert dim is cut over as
  many mesh axes as divide E (:func:`expert_axes_for`, model-major; the
  same tuple keys the parameter spec and the all-to-all), so no weight
  ever moves;
* each process routes a disjoint slice of its batch block's tokens (its
  index along the axes the block is replicated over: ``model``, and
  ``data`` too when the batch does not split, as at B = 1 decode), packs
  per-destination capacity buffers, and an ``all_to_all`` sends them to
  the experts' owners;
* the experts run locally, an inverse ``all_to_all`` returns their
  outputs, the gates combine them locally, and an ``all_gather`` along
  the slicing axes rebuilds the block.

The reference writes this as a ``shard_map`` body; here each process runs
the body itself (the local view, :mod:`repro_torch.sharding.collectives`),
its own expert block the ``MoE``'s ``wi_gate`` / ``wi_up`` / ``wo``
(``n_local`` experts).  The gradient flows as the collectives' contract
says: a slice's cotangent is its own part once, the router's gradient is
summed over the slicing axes, and the token gradients are gathered back
to every process of the block.

As in :mod:`repro_torch.models.moe`, nothing is summed by atomics: a kept
assignment is written by indexing into a buffer with a spare row (where
every dropped one goes, sliced off), and the combine puts the gated
outputs back in (token, choice) order through the owner sort's
permutation and sums each token's ``k`` in order.  So a rerun repeats
bit for bit.  Capacity is counted per slice, ``max(4, ceil(T_slice * k /
E * cf))`` (the reference's), where the single-device path counts it per
chunk: the two agree where nothing drops.  Pad tokens (a block that does
not split evenly) are routed as the reference routes them (zeros) and
their rows are cut from the result.
"""

from __future__ import annotations

import math

import numpy as np
import torch.nn.functional as F

from repro_torch.models.layers import mlp_apply
from repro_torch.models.moe import (MoE, balance_loss, combine, expert_ffn,
                                    pack)
from repro_torch.models.moe import route as _route
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.rules import expert_axes_for, expert_param_spec

__all__ = ["expert_axes_for", "moe_apply_manual", "expert_param_spec",
           "local_experts", "expert_block"]


def moe_apply_manual(p: MoE, cfg_moe, mlp_kind: str, x, compute_dtype,
                     mesh, *, batch_sharded: bool = True):
    """x: this process's block (B, S, d) -> (y, aux), dispatched by an
    all-to-all over the expert axes of ``mesh`` (a ``ProcessMesh``).
    ``batch_sharded``: the block is this process's share of the batch
    over ``(pod, data)``; else every process holds the same batch."""
    e = cfg_moe
    names = mesh.axis_names
    exp_ax = expert_axes_for(mesh, e.n_experts)
    if not exp_ax:
        raise ValueError(f"a {mesh.dims} mesh cannot own {e.n_experts} "
                         "experts")
    if not hasattr(mesh, "members"):
        raise TypeError("the manual dispatch runs on a ProcessMesh, not a "
                        f"{type(mesh).__name__}")
    n_exp_dev = mesh.axis_size(exp_ax)
    e_loc = e.n_experts // n_exp_dev
    if p.wi_gate.shape[0] != e_loc:
        raise ValueError(f"the expert stacks hold {p.wi_gate.shape[0]} "
                         f"experts; this mesh gives each process {e_loc}")
    batch_sharded = batch_sharded and any(a in names
                                          for a in ("pod", "data"))
    # token slicing covers every axis the block is replicated over, so no
    # process routes a token twice (decode B=1 replicates over data too)
    slice_axes = tuple(a for a in ("data", "model")
                       if a in names and (a == "model" or not batch_sharded))

    b, s, d = x.shape
    t_loc = b * s
    xt = x.reshape(t_loc, d)
    # ---- slice my share of the replicated tokens ---------------------------
    msize = mesh.axis_size(slice_axes)
    pad = (-t_loc) % msize
    xt_p = F.pad(xt, (0, 0, 0, pad)) if pad else xt
    t_s = xt_p.shape[0] // msize
    x_slice = coll.own_slice(xt_p, mesh, slice_axes)

    # ---- route (fp32) -------------------------------------------------------
    router = coll.sum_grad(p.router.w, mesh, slice_axes)
    probs, gate, idx = _route(router, e, x_slice)
    aux_loss = balance_loss(probs, idx, e.n_experts)
    cap = max(4, int(np.ceil(t_s * e.top_k / e.n_experts
                             * e.capacity_factor)))
    send, sort = pack(x_slice, idx, gate, e.n_experts, cap, compute_dtype)

    # ---- a2a to expert owners ----------------------------------------------
    # send (E, cap, d) = (D, E_loc, cap, d): block j to the owner of index j
    recv = coll.all_to_all(send.reshape(n_exp_dev * e_loc, cap, d), mesh,
                           exp_ax)
    # recv (D_src, E_loc, cap, d): my experts' tokens from every source
    buf = recv.reshape(n_exp_dev, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n_exp_dev * cap, d)
    out = expert_ffn(p, buf, mlp_kind, compute_dtype)
    out4 = out.reshape(e_loc, n_exp_dev, cap, d).transpose(0, 1)
    back = coll.all_to_all(out4.reshape(n_exp_dev * e_loc, cap, d), mesh,
                           exp_ax)
    # back (D * E_loc, cap, d) == my send layout, now holding outputs
    y_slice = combine(back, sort, e.top_k, compute_dtype)

    # ---- rebuild the block along the slicing axes --------------------------
    y_full = coll.all_gather(y_slice, mesh, slice_axes)
    y = y_full[:t_loc].reshape(b, s, d)
    drop = 1.0 - sort[-1].float().mean()
    # aux scalars: averaged over every process
    aux_loss = coll.pmean(aux_loss, mesh, grad_axes=slice_axes)
    drop = coll.pmean(drop.detach(), mesh)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, mlp_kind, compute_dtype)
    return y.to(x.dtype), {"load_balance_loss": aux_loss,
                           "drop_frac": drop}


def local_experts(mesh, n_experts: int) -> int:
    """The experts one process of ``mesh`` holds (E itself where the mesh
    cannot own them)."""
    ax = expert_axes_for(mesh, n_experts)
    return n_experts // math.prod(mesh.shape[a] for a in ax)


def expert_block(mesh, n_experts: int) -> int:
    """Which block of the expert stacks this process of ``mesh`` (a
    ``ProcessMesh``) holds: its index over the expert axes."""
    return mesh.axis_index(expert_axes_for(mesh, n_experts))
