"""Neuron and synapse dynamics (paper §I.A, eqs. 1-3), in PyTorch.

The port of the reference package's ``core/snn.py``: the leaky
integrate-and-fire neuron with current-based exponential synapses (exact
integration, NEST ``iaf_psc_exp``) or conductance-based exponential synapses
(exponential Euler, NEST ``cond_exp``).

All state lives in a flat :class:`NeuronState` of ``(n,)`` tensors, and all
heterogeneous parameters are per-group rows of one ``(G, NCOL)`` table
gathered through ``group_id`` - the layout the LIF kernel
(:mod:`repro_torch.kernels.lif_step`) consumes.

:func:`lif_step` keeps the reference's op order
(``v*p_vv + (syn_ex*p_ve + syn_in*p_vi) + p_vconst``) so the flat backend
tracks the reference's flat backend; the kernel path follows the Pallas
kernel's order instead (see :mod:`repro_torch.kernels.lif_step`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["LIFParams", "NeuronState", "make_param_table", "init_state",
           "lif_step", "surrogate_spike", "SynapseModel", "COL", "NCOL"]


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Per-group LIF parameters (NEST naming, SI-ish units: mV, ms, pF, nS)."""

    tau_m: float = 10.0        # membrane time constant [ms]
    c_m: float = 250.0         # membrane capacitance [pF]
    e_l: float = -65.0         # resting / leak potential [mV]
    v_th: float = -50.0        # spike threshold [mV]
    v_reset: float = -65.0     # reset potential [mV]
    t_ref: float = 2.0         # absolute refractory period [ms]
    tau_syn_ex: float = 0.5    # excitatory synaptic time constant [ms]
    tau_syn_in: float = 0.5    # inhibitory synaptic time constant [ms]
    # conductance-mode reversal potentials (paper eq. 3's E_syn)
    e_ex: float = 0.0          # [mV]
    e_in: float = -85.0        # [mV]
    i_e: float = 0.0           # constant external current [pA]


class SynapseModel:
    CURRENT_EXP = "current_exp"
    COND_EXP = "cond_exp"


@dataclasses.dataclass
class NeuronState:
    """Flat per-neuron state; every tensor is shape (n,)."""

    v_m: torch.Tensor        # membrane potential [mV]
    syn_ex: torch.Tensor     # exc. synaptic current [pA] or conductance [nS]
    syn_in: torch.Tensor     # inh. synaptic current [pA] or conductance [nS]
    ref_count: torch.Tensor  # remaining refractory steps (int32)
    spike: torch.Tensor      # bool: spiked at the *last* step
    group_id: torch.Tensor   # int32 index into the parameter table
    #: model-specific per-neuron variables (``NeuronModel.extra_fields``):
    #: ``{}`` for LIF, ``{"u": ...}`` for izhikevich, ``{"w_ad": ...}`` for
    #: adex (DESIGN.md §12)
    extra: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


# Parameter-table row layout (columns of the (G, NCOL) table), identical to
# the reference's so both packages read one table.
_COLS = (
    "p_vv",      # exp(-dt / tau_m)
    "p_ee",      # exp(-dt / tau_syn_ex)
    "p_ii",      # exp(-dt / tau_syn_in)
    "p_ve",      # exact-integration coupling: syn_ex -> v
    "p_vi",      # exact-integration coupling: syn_in -> v
    "p_vconst",  # e_l * (1 - p_vv) + R*(1-p_vv)*i_e  (leak + DC drive)
    "v_th",
    "v_reset",
    "ref_steps",  # t_ref / dt, rounded
    "e_ex",      # conductance mode only
    "e_in",
    "inv_cm_dt",  # dt / c_m (conductance exponential-Euler)
)
COL = {name: i for i, name in enumerate(_COLS)}
NCOL = len(_COLS)


def _couple(tau_syn: float, tau_m: float, c_m: float, dt: float) -> float:
    """Exact-integration propagator entry P_{v,syn} (Rotter & Diesmann 1999),
    with the l'Hopital limit at tau_syn == tau_m."""
    if abs(tau_m - tau_syn) < 1e-9:
        return float((dt / c_m) * np.exp(-dt / tau_m))
    a = np.exp(-dt / tau_m) - np.exp(-dt / tau_syn)
    return float(tau_syn * tau_m / (c_m * (tau_m - tau_syn)) * a)


def make_param_table(groups: list[LIFParams], dt: float,
                     dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Precompute the (G, NCOL) propagator table for a list of neuron groups
    (in float64 numpy, then cast once - as the reference does)."""
    device = resolve_device(device)
    rows = []
    for g in groups:
        p_vv = np.exp(-dt / g.tau_m)
        r_m = g.tau_m / g.c_m  # membrane resistance [GOhm] in these units
        rows.append([
            p_vv,
            np.exp(-dt / g.tau_syn_ex),
            np.exp(-dt / g.tau_syn_in),
            _couple(g.tau_syn_ex, g.tau_m, g.c_m, dt),
            _couple(g.tau_syn_in, g.tau_m, g.c_m, dt),
            g.e_l * (1.0 - p_vv) + r_m * (1.0 - p_vv) * g.i_e,
            g.v_th,
            g.v_reset,
            max(1.0, round(g.t_ref / dt)),
            g.e_ex,
            g.e_in,
            dt / g.c_m,
        ])
    return torch.as_tensor(np.asarray(rows), dtype=dtype, device=device)


def init_state(n: int, group_id, groups: list[LIFParams], *,
               dtype=torch.float32, device="cuda") -> NeuronState:
    """Resting state: ``v_m = e_l`` of each neuron's group, no input; on
    ``device`` (the card unless ``device="cpu"``; raises without one)."""
    device = resolve_device(device)
    e_l = np.asarray([g.e_l for g in groups], dtype=np.float64)
    gid = np.asarray(group_id, dtype=np.int32)
    zeros = lambda dt: torch.zeros((n,), dtype=dt, device=device)
    return NeuronState(
        v_m=torch.as_tensor(e_l[gid], dtype=dtype, device=device),
        syn_ex=zeros(dtype),
        syn_in=zeros(dtype),
        ref_count=zeros(torch.int32),
        spike=zeros(torch.bool),
        group_id=torch.as_tensor(gid, device=device),
    )


def surrogate_spike(spike_fn, refractory, v_new, threshold):
    """The float spike of surrogate mode: ``spike_fn(v_new - threshold)``,
    0 where ``refractory`` (the ``where`` also stops the refractory rows'
    gradient).  Its values are the inference bool's."""
    return torch.where(refractory, torch.zeros_like(v_new),
                       spike_fn(v_new - threshold))


def lif_step(state: NeuronState, table: torch.Tensor,
             input_ex: torch.Tensor, input_in: torch.Tensor, *,
             synapse_model: str = SynapseModel.CURRENT_EXP,
             spike_fn=None) -> NeuronState:
    """One dt of neuron dynamics, elementwise in plain torch.

    ``input_ex`` / ``input_in`` are the per-neuron synaptic increments the
    sweep accumulated this step; they add AFTER the decay (NEST convention:
    a spike arriving at t affects v from t+dt on).

    ``spike_fn`` (surrogate mode, DESIGN.md §17; from
    :func:`repro_torch.diff.surrogate.get_surrogate`): the returned
    ``spike`` is the float ``spike_fn(v - v_th)``, 0 where refractory -
    the inference bool's values, with a surrogate derivative.  Reset and
    refractory bookkeeping stay keyed off the bool (a detached reset), so
    every other field is bitwise inference mode's.
    """
    t = table[state.group_id]  # (n, NCOL) gather
    col = lambda name: t[:, COL[name]]
    p_vv, p_ee, p_ii = col("p_vv"), col("p_ee"), col("p_ii")
    v_th, v_reset = col("v_th"), col("v_reset")
    ref_steps = col("ref_steps").to(torch.int32)

    syn_ex = state.syn_ex * p_ee + input_ex
    syn_in = state.syn_in * p_ii + input_in

    if synapse_model == SynapseModel.CURRENT_EXP:
        dv_syn = state.syn_ex * col("p_ve") + state.syn_in * col("p_vi")
        v_prop = state.v_m * p_vv + dv_syn + col("p_vconst")
    elif synapse_model == SynapseModel.COND_EXP:
        i_cond = (state.syn_ex * (col("e_ex") - state.v_m)
                  - state.syn_in * (state.v_m - col("e_in")))
        v_prop = (state.v_m * p_vv + col("p_vconst")
                  + i_cond * col("inv_cm_dt"))
    else:
        raise ValueError(f"unknown synapse model {synapse_model!r}")

    refractory = state.ref_count > 0
    v_new = torch.where(refractory, v_reset, v_prop)
    spike = ~refractory & (v_new >= v_th)
    spike_out = spike if spike_fn is None else surrogate_spike(
        spike_fn, refractory, v_new, v_th)
    v_new = torch.where(spike, v_reset, v_new)
    ref_count = torch.where(spike, ref_steps,
                            torch.clamp(state.ref_count - 1, min=0))
    return NeuronState(v_m=v_new, syn_ex=syn_ex, syn_in=syn_in,
                       ref_count=ref_count.to(torch.int32), spike=spike_out,
                       group_id=state.group_id, extra=state.extra)
