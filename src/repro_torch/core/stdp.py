"""STDP: multiplicative depression + power-law potentiation (paper §IV.A).

The port of the reference package's ``core/stdp.py``: NEST's
``stdp_pl_synapse_hom`` rule of the ``hpc_benchmark`` E->E synapses,

    on a PRE spike  (arriving at the synapse):  dw = -lambda * alpha * w * K_post
    on a POST spike:                            dw = +lambda * w0^(1-mu) * w^mu * K_pre

with exponentially decaying traces ``K_pre`` (over mirrors) and ``K_post``
(over owned neurons).  Every synapse is owned by the partition owning its
post neuron, so both update directions write disjoint memory.

:func:`stdp_edge_update` is the plain-torch per-edge rule of the flat
backend, in the reference's op order; the kernel path is
:mod:`repro_torch.kernels.stdp_update`.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.device import resolve_device

__all__ = ["STDPParams", "TraceState", "init_traces", "update_traces",
           "stdp_edge_update"]


@dataclasses.dataclass(frozen=True)
class STDPParams:
    lam: float = 0.1          # learning rate lambda
    alpha: float = 0.0513     # asymmetry of depression
    mu: float = 0.4           # potentiation weight exponent (power law)
    w0: float = 1.0           # reference weight [pA]
    tau_plus: float = 15.0    # pre-trace time constant [ms]
    tau_minus: float = 30.0   # post-trace time constant [ms]
    w_min: float = 0.0
    w_max: float = 1e6


@dataclasses.dataclass
class TraceState:
    """Exponential spike traces; (n_mirror,) for pre, (n_local,) for post."""

    k_pre: torch.Tensor
    k_post: torch.Tensor


def init_traces(n_pre: int, n_post: int, dtype=torch.float32,
                device="cuda") -> TraceState:
    """Zero traces on ``device`` (the card unless ``device="cpu"``; raises
    without one)."""
    device = resolve_device(device)
    return TraceState(k_pre=torch.zeros((n_pre,), dtype=dtype, device=device),
                      k_post=torch.zeros((n_post,), dtype=dtype,
                                         device=device))


@functools.lru_cache(maxsize=None)
def _decay(arg: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``exp(arg)`` as a 0-d tensor, computed on ``device`` in ``dtype``
    (as the reference's ``jnp.exp`` is) once per value: a fresh
    ``torch.tensor(..., device="cuda")`` every step would copy from
    pageable host memory and synchronise the host with the card."""
    return torch.exp(torch.tensor(arg, dtype=dtype, device=device))


def update_traces(tr: TraceState, p: STDPParams, dt: float,
                  pre_spike: torch.Tensor,
                  post_spike: torch.Tensor) -> TraceState:
    """Decay-then-increment trace update (order matches NEST archiving)."""
    decay = lambda tau, like: _decay(-dt / tau, like.dtype, like.device)
    return TraceState(
        k_pre=tr.k_pre * decay(p.tau_plus, tr.k_pre)
        + pre_spike.to(tr.k_pre.dtype),
        k_post=tr.k_post * decay(p.tau_minus, tr.k_post)
        + post_spike.to(tr.k_post.dtype),
    )


def stdp_edge_update(weights: torch.Tensor, pre_idx: torch.Tensor,
                     post_idx: torch.Tensor, edge_arrived: torch.Tensor,
                     post_spike: torch.Tensor, traces: TraceState,
                     p: STDPParams) -> torch.Tensor:
    """One step of the pl-STDP rule on every owned edge (flat layout).

    ``edge_arrived`` is per-edge because arrival time depends on the edge's
    own delay; ``post_spike`` is the (n_local,) bool spike vector.
    """
    w = weights
    dtype = w.dtype
    pre_m = edge_arrived.to(dtype)
    post_m = post_spike[post_idx].to(dtype)
    k_post = traces.k_post[post_idx]
    k_pre = traces.k_pre[pre_idx]

    # multiplicative depression on pre arrival
    w = w - pre_m * (p.lam * p.alpha) * w * k_post
    # power-law potentiation on post spike: lambda * w0^(1-mu) * w^mu * K_pre
    w_safe = torch.clamp(w, min=1e-12)  # power of non-positive guard
    w = w + post_m * p.lam * (p.w0 ** (1.0 - p.mu)) * (w_safe ** p.mu) * k_pre
    return torch.clamp(w, p.w_min, p.w_max)
