"""Mixture-of-Experts with sort-based capacity dispatch.

Ports ``src/repro/models/moe.py``.  The token -> expert assignment is a
sparse bipartite graph whose expert side is written in the owner order of
the paper's indegree decomposition: assignments are sorted stably by
expert, each one's rank inside its expert's run is its buffer row, and an
expert's rows are written by one collision-free scatter.  Per-expert
capacity ``C = ceil(T * k / E * cf)`` (at least 8, a multiple of 8);
assignments ranked past it are dropped and the drop fraction is returned.

The reference scatters with ``buf.at[e, row].add`` and combines with
``segment_sum``; on the card both would be float atomics, whose order (and
so whose rounding) changes from run to run.  Here nothing is summed by
atomics:

* a kept row is written by plain indexing into an ``(E, C + 1, d)``
  buffer; a dropped row goes to the spare row ``C``, which is sliced off;
* the combine puts the ``T * k`` gated expert outputs back in token order
  through the owner sort's permutation and sums each token's ``k`` of them
  in a fixed order.

So a wave served twice gives the same tokens.  Under autograd the
indexed write and the combine carry the gradient back to the kept rows
(a dropped row's spare buffer row is sliced off, so it takes none, as
the reference's ``keep`` mask zeroes it), the gates carry theirs to the
router, and so does the load-balance loss through the mean router
probabilities.  Against the reference the
result agrees to the rounding of another summation order (fp32 sums;
the reference's bf16 segment sum rounds after each add, this one once).

The expert products run as batched fp32-output GEMMs (:func:`layers.
bmm_f32`), and SwiGLU applies ``silu`` to the fp32 product before the
rounding, as the reference's expert FFN does (the dense ``mlp_apply``
rounds first).

Under a process mesh (``sharding.rules.use_mesh``) whose axes can own
the experts, :func:`moe_apply` takes :mod:`repro_torch.models.moe_manual`'s
expert-parallel dispatch, as the reference's does; this module's path
stays the single-device formulation and the oracle.  On such a mesh a
:class:`MoE` holds only its process's block of the expert stacks
(``n_local`` experts; a ``DecoderLM`` allocates it so through
``sharding.rules.allocate_blocks``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (MLP, Linear, _param, bmm_f32,
                                       init_linear, mlp_apply, mlp_init)

__all__ = ["MoE", "capacity", "moe_init", "moe_apply", "route",
           "balance_loss", "pack", "combine", "expert_ffn"]


def capacity(n_tokens: int, cfg_moe) -> int:
    c = int(np.ceil(n_tokens * cfg_moe.top_k / cfg_moe.n_experts
                    * cfg_moe.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


class MoE(nn.Module):
    """``router.w`` (fp32, as the reference keeps it), the expert stacks
    ``wi_gate``, ``wi_up`` ``(E, d, ff)`` and ``wo`` ``(E, ff, d)`` in the
    compute dtype, and the ``shared`` expert MLP if ``n_shared > 0``."""

    def __init__(self, d_model: int, mlp_kind: str, cfg_moe, *, dtype,
                 device, n_local: int | None = None):
        super().__init__()
        e = cfg_moe
        self.router = Linear(d_model, e.n_experts, dtype=torch.float32,
                             device=device)
        kw = dict(dtype=dtype, device=device)
        n = e.n_experts if n_local is None else n_local
        self.wi_gate = _param(n, d_model, e.expert_ff, **kw)
        self.wi_up = _param(n, d_model, e.expert_ff, **kw)
        self.wo = _param(n, e.expert_ff, d_model, **kw)
        if e.n_shared > 0:
            self.shared = MLP(d_model, e.n_shared * e.expert_ff, mlp_kind,
                              **kw)
        else:
            self.shared = None


def moe_init(p: MoE, gen: torch.Generator) -> MoE:
    """The reference's draws."""
    init_linear(p.router, gen)
    d, ff = p.wi_gate.shape[1], p.wi_gate.shape[2]
    for w, fan_in in ((p.wi_gate, d), (p.wi_up, d), (p.wo, ff)):
        w.normal_(0.0, float(1.0 / np.sqrt(fan_in)), generator=gen)
    if p.shared is not None:
        mlp_init(p.shared, gen)
    return p


def route(router_w, e, xt):
    """The router ``router_w`` (d, E) on tokens ``xt``, in fp32: (probs
    (T, E), gates (T, k) renormalised to sum 1, their experts (T, k))."""
    probs = torch.softmax(xt.float() @ router_w.float(), dim=-1)
    gate, idx = torch.topk(probs, e.top_k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, idx


def _route(p: MoE, e, xt):
    return route(p.router.w, e, xt)


def balance_loss(probs, idx, n_experts: int):
    """The load-balance aux (Switch-style): E * sum_e f_e * P_e; the
    one-hot of the choices as a comparison, the same ops on every device
    (``F.one_hot`` checks the ids' range on the host on the CPU, and
    takes other ops on ``meta``)."""
    me = probs.mean(0)
    experts = torch.arange(n_experts, device=idx.device)
    ce = (idx[..., None] == experts).float().sum(1).mean(0)
    return n_experts * torch.sum(me * ce)


def _owner_sort(flat_e, n_experts: int):
    """The owner order of the assignments ``flat_e`` (T*k,): (order, the
    sorted experts, each assignment's rank inside its expert's run).
    Each expert's run starts where a search of the sorted experts puts
    it: the reference's exclusive cumsum of the counts, in integers, with
    a size that does not depend on the data (so it runs on ``meta``) and
    deterministic on the card."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(
        se, torch.arange(n_experts, device=se.device, dtype=se.dtype))
    pos = torch.arange(se.numel(), device=se.device) - starts[se]
    return order, se, pos


def pack(xt, idx, gate, n_experts: int, cap: int, compute_dtype):
    """The owner-sorted capacity buffer of tokens ``xt`` (T, d) routed to
    ``idx`` (T, k): ``(buf (E, cap, d), sort)``, ``sort`` the owner
    sort's ``(order, sorted experts, sorted gates, rank in own expert,
    keep)``.  One writer per kept (expert, row); every dropped row goes
    to a spare row, sliced off."""
    k = idx.shape[1]
    order, se, pos = _owner_sort(idx.reshape(-1), n_experts)
    st_ = torch.div(order, k, rounding_mode="floor")             # token ids
    sg = gate.reshape(-1)[order]
    keep = pos < cap
    buf = torch.zeros((n_experts, cap + 1, xt.shape[-1]),
                      dtype=compute_dtype, device=xt.device)
    buf[se, torch.where(keep, pos, cap)] = xt.to(compute_dtype)[st_]
    return buf[:, :cap], (order, se, sg, pos, keep)


def combine(out_buf, sort, k: int, compute_dtype):
    """The experts' outputs ``out_buf`` (E, cap, d) back in (token,
    choice) order through the sort's permutation, gated, each token's
    ``k`` summed in order -> (T, d)."""
    order, se, sg, pos, keep = sort
    cap, d = out_buf.shape[1], out_buf.shape[2]
    w_keep = (sg.to(compute_dtype) * keep.to(compute_dtype))[:, None]
    y_sorted = out_buf[se, torch.clamp_max(pos, cap - 1)] * w_keep
    y_flat = torch.empty_like(y_sorted)
    y_flat[order] = y_sorted
    return y_flat.reshape(-1, k, d).sum(1)


def expert_ffn(p: MoE, buf, mlp_kind: str, compute_dtype):
    """``buf`` (E, R, d) through the expert stacks (batched over the
    expert axis), fp32 products rounded once."""
    wg, wu, wo = (w.to(compute_dtype) for w in (p.wi_gate, p.wi_up, p.wo))
    if mlp_kind == "swiglu":
        h = (F.silu(bmm_f32(buf, wg)).to(compute_dtype)
             * bmm_f32(buf, wu).to(compute_dtype))
    else:
        h = F.gelu(bmm_f32(buf, wg), approximate="tanh").to(compute_dtype)
    return bmm_f32(h, wo).to(compute_dtype)


def _dispatch_block(p: MoE, e, mlp_kind: str, xt, compute_dtype):
    """Route one token block (T, d) through the experts -> (y, aux_loss,
    drop_frac)."""
    cap = capacity(xt.shape[0], e)
    probs, gate, idx = _route(p, e, xt)
    aux_loss = balance_loss(probs, idx, e.n_experts)
    buf, sort = pack(xt, idx, gate, e.n_experts, cap, compute_dtype)
    out_buf = expert_ffn(p, buf, mlp_kind, compute_dtype)
    y = combine(out_buf, sort, e.top_k, compute_dtype)
    drop = 1.0 - sort[-1].float().mean()
    return y, aux_loss, drop


def moe_apply(p: MoE, cfg_moe, mlp_kind: str, x,
              compute_dtype=torch.bfloat16):
    """x: (B, S, d) -> (y, aux).

    Long sequences are dispatched in sequence chunks of about
    ``dispatch_chunk`` tokens (the largest divisor of S at or below
    ``dispatch_chunk // B``), each chunk spanning the whole batch, each
    with its own capacity; ``aux`` holds the chunks' mean
    ``load_balance_loss`` and ``drop_frac``."""
    e = cfg_moe
    b, s, d = x.shape
    # under a mesh, the manual expert-parallel dispatch (an all-to-all of
    # the routed tokens to expert-resident weights), as the reference's
    from repro_torch.sharding.rules import current_mesh
    ctx = current_mesh()
    if ctx is not None:
        from repro_torch.models.moe_manual import (expert_axes_for,
                                                   moe_apply_manual)
        if expert_axes_for(ctx.mesh, e.n_experts):
            return moe_apply_manual(
                p, e, mlp_kind, x, compute_dtype, ctx.mesh,
                batch_sharded=not ctx.replicated_batch)
    chunk_s = max(1, min(s, e.dispatch_chunk // max(b, 1)))
    while s % chunk_s != 0:  # largest divisor of s not above the target
        chunk_s -= 1
    ys, losses, drops = [], [], []
    for c0 in range(0, s, chunk_s):
        yb, al, dr = _dispatch_block(
            p, e, mlp_kind, x[:, c0:c0 + chunk_s].reshape(b * chunk_s, d),
            compute_dtype)
        ys.append(yb.reshape(b, chunk_s, d))
        losses.append(al)
        drops.append(dr)
    y = torch.cat(ys, dim=1)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, mlp_kind, compute_dtype)
    aux = {"load_balance_loss": torch.stack(losses).mean(),
           "drop_frac": torch.stack(drops).mean()}
    return y.to(x.dtype), aux
