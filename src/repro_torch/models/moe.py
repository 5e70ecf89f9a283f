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

So a wave served twice gives the same tokens.  Against the reference the
result agrees to the rounding of another summation order (fp32 sums;
the reference's bf16 segment sum rounds after each add, this one once).

The expert products run as batched fp32-output GEMMs (:func:`layers.
bmm_f32`), and SwiGLU applies ``silu`` to the fp32 product before the
rounding, as the reference's expert FFN does (the dense ``mlp_apply``
rounds first).  The reference's mesh branch (``moe_manual``) has no
counterpart: the port runs on one card and takes the single-device path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (MLP, Linear, _param, bmm_f32,
                                       init_linear, mlp_apply, mlp_init)

__all__ = ["MoE", "capacity", "moe_init", "moe_apply"]


def capacity(n_tokens: int, cfg_moe) -> int:
    c = int(np.ceil(n_tokens * cfg_moe.top_k / cfg_moe.n_experts
                    * cfg_moe.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


class MoE(nn.Module):
    """``router.w`` (fp32, as the reference keeps it), the expert stacks
    ``wi_gate``, ``wi_up`` ``(E, d, ff)`` and ``wo`` ``(E, ff, d)`` in the
    compute dtype, and the ``shared`` expert MLP if ``n_shared > 0``."""

    def __init__(self, d_model: int, mlp_kind: str, cfg_moe, *, dtype,
                 device):
        super().__init__()
        e = cfg_moe
        self.router = Linear(d_model, e.n_experts, dtype=torch.float32,
                             device=device)
        kw = dict(dtype=dtype, device=device)
        self.wi_gate = _param(e.n_experts, d_model, e.expert_ff, **kw)
        self.wi_up = _param(e.n_experts, d_model, e.expert_ff, **kw)
        self.wo = _param(e.n_experts, e.expert_ff, d_model, **kw)
        if e.n_shared > 0:
            self.shared = MLP(d_model, e.n_shared * e.expert_ff, mlp_kind,
                              **kw)
        else:
            self.shared = None


def moe_init(p: MoE, gen: torch.Generator) -> MoE:
    init_linear(p.router, gen)
    d, ff = p.wi_gate.shape[1], p.wi_gate.shape[2]
    for w, fan_in in ((p.wi_gate, d), (p.wi_up, d), (p.wo, ff)):
        w.normal_(0.0, float(1.0 / np.sqrt(fan_in)), generator=gen)
    if p.shared is not None:
        mlp_init(p.shared, gen)
    return p


def _route(p: MoE, e, xt):
    """The router, in fp32: (probs (T, E), gates (T, k) renormalised to
    sum 1, their experts (T, k))."""
    probs = torch.softmax(xt.float() @ p.router.w, dim=-1)
    gate, idx = torch.topk(probs, e.top_k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, idx


def _owner_sort(flat_e, n_experts: int):
    """The owner order of the assignments ``flat_e`` (T*k,): (order, the
    sorted experts, each assignment's rank inside its expert's run)."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(se, minlength=n_experts)             # (E,)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(se.numel(), device=se.device) - starts[se]
    return order, se, pos


def _dispatch_block(p: MoE, e, mlp_kind: str, xt, compute_dtype):
    """Route one token block (T, d) through the experts -> (y, aux_loss,
    drop_frac)."""
    t, d = xt.shape
    k = e.top_k
    cap = capacity(t, e)
    probs, gate, idx = _route(p, e, xt)

    # load-balance aux (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(0)
    ce = F.one_hot(idx, e.n_experts).float().sum(1).mean(0)
    aux_loss = e.n_experts * torch.sum(me * ce)

    # ---- owner-sorted dispatch --------------------------------------------
    order, se, pos = _owner_sort(idx.reshape(-1), e.n_experts)
    st_ = torch.div(order, k, rounding_mode="floor")             # token ids
    sg = gate.reshape(-1)[order]
    keep = pos < cap
    buf = torch.zeros((e.n_experts, cap + 1, d), dtype=compute_dtype,
                      device=xt.device)
    # one writer per kept (expert, row); every dropped row to the spare row
    buf[se, torch.where(keep, pos, cap)] = xt.to(compute_dtype)[st_]
    buf = buf[:, :cap]

    # ---- expert FFNs (batched over the expert axis) ------------------------
    wg, wu, wo = (w.to(compute_dtype) for w in (p.wi_gate, p.wi_up, p.wo))
    if mlp_kind == "swiglu":
        h = (F.silu(bmm_f32(buf, wg)).to(compute_dtype)
             * bmm_f32(buf, wu).to(compute_dtype))
    else:
        h = F.gelu(bmm_f32(buf, wg), approximate="tanh").to(compute_dtype)
    out_buf = bmm_f32(h, wo).to(compute_dtype)

    # ---- combine: back to (token, choice) order, k summed in order ---------
    w_keep = (sg.to(compute_dtype) * keep.to(compute_dtype))[:, None]
    y_sorted = out_buf[se, torch.clamp_max(pos, cap - 1)] * w_keep
    y_flat = torch.empty_like(y_sorted)
    y_flat[order] = y_sorted
    y = y_flat.reshape(t, k, d).sum(1)
    drop = 1.0 - keep.float().mean()
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
