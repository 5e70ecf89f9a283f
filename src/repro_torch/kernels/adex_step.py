"""K5: fused AdEx (adaptive exponential IF) neuron update - CUDA kernel and
plain twin.

Ports ``src/repro/kernels/adex_step.py::adex_step_kernel`` (the Pallas TPU
kernel): Brette & Gerstner 2005 / NEST ``aeif_psc_exp`` semantics,

    C dv/dt = -g_L (v - E_L) + g_L Delta_T exp((v - V_T)/Delta_T)
              + I_syn + I_e - w
    tau_w dw/dt = a (v - E_L) - w
    spike: v >= v_peak  ->  v <- v_reset,  w <- w + b,  refractory t_ref

Euler on (v, w) over the engine's exactly decaying exponential synapses;
the adaptation current ``w`` rides ``NeuronState.extra["w_ad"]``.  The
exponential's argument is clamped to :data:`EXP_CLAMP` before ``exp`` so
that an overshot membrane never overflows float32 (the reference's policy,
DESIGN.md §12).

Both versions follow the reference's ``adex_math`` op for op.  The kernel
is ``csrc/adex_step.cu`` (one thread per neuron, ``expf`` and IEEE
division, ``--fmad=false``); for CPU tensors :func:`adex_step` runs
:func:`adex_step_plain`, for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.snn import surrogate_spike
from repro_torch.kernels import _build, _two_variable

__all__ = ["adex_step", "adex_step_plain", "COL", "NCOL", "_COLS",
           "EXP_CLAMP"]

#: float32 safety clamp on (v - V_T)/Delta_T before exp (DESIGN.md §12)
EXP_CLAMP = 10.0

# Parameter-table row layout, identical to the reference's.
_COLS = (
    "p_ee",       # exp(-dt / tau_syn_ex)
    "p_ii",       # exp(-dt / tau_syn_in)
    "dt_cm",      # dt / c_m
    "g_l",
    "e_l",
    "v_t",        # exponential threshold [mV]
    "delta_t",    # slope factor [mV]
    "v_peak",     # spike cutoff [mV]
    "v_reset",
    "dt_tw",      # dt / tau_w
    "a",          # subthreshold adaptation [nS]
    "b",          # spike-triggered adaptation increment [pA]
    "ref_steps",
    "i_e",
)
COL = {name: i for i, name in enumerate(_COLS)}
NCOL = len(_COLS)


def adex_step_plain(v, w_ad, syn_ex, syn_in, ref_count, group_id, input_ex,
                    input_in, table, *, spike_fn=None):
    """Plain-torch twin: ``(v, w_ad, syn_ex, syn_in, ref_count, spike)``.

    ``spike_fn`` (surrogate mode): the spike is the float
    ``spike_fn(v_new - v_peak)``, 0 where refractory, as in the reference's
    ``adex_math``; every other output is unchanged."""
    tb = table[group_id.long()]
    get = lambda name: tb[:, COL[name]]
    se_new = syn_ex * get("p_ee") + input_ex
    si_new = syn_in * get("p_ii") + input_in
    g_l, e_l, delta_t = get("g_l"), get("e_l"), get("delta_t")
    # float32 policy: clamp the exponent argument, never the voltage
    exp_arg = torch.clamp((v - get("v_t")) / delta_t, max=EXP_CLAMP)
    i_exp = g_l * delta_t * torch.exp(exp_arg)
    dv = (-g_l * (v - e_l) + i_exp + syn_ex + syn_in + get("i_e") - w_ad)
    v_prop = v + get("dt_cm") * dv
    w_prop = w_ad + get("dt_tw") * (get("a") * (v - e_l) - w_ad)
    refractory = ref_count > 0
    v_reset = get("v_reset")
    v_new = torch.where(refractory, v_reset, v_prop)
    spike = ~refractory & (v_new >= get("v_peak"))
    spike_out = spike if spike_fn is None else surrogate_spike(
        spike_fn, refractory, v_new, get("v_peak"))
    v_new = torch.where(spike, v_reset, v_new)
    w_new = torch.where(spike, w_prop + get("b"), w_prop)
    rc_new = torch.where(spike, get("ref_steps").to(torch.int32),
                         torch.clamp(ref_count - 1, min=0)).to(torch.int32)
    return v_new, w_new, se_new, si_new, rc_new, spike_out


def adex_step(v, w_ad, syn_ex, syn_in, ref_count, group_id, input_ex,
              input_in, table):
    """All neuron arrays (N,): f32 ``v``, ``w_ad``, synaptic state and
    inputs, int32 ``ref_count`` and ``group_id``; ``table`` (G, NCOL) f32,
    its rows contiguous but possibly further apart.  Returns the new
    ``(v, w_ad, syn_ex, syn_in, ref_count, spike)``, ``spike`` bool.  Group
    ids are not range-checked on the card."""
    _build.require_no_grad("adex_step", v, w_ad, syn_ex, syn_in, input_ex,
                           input_in, table)
    if _build.dispatch_device(v) == "cpu":
        return adex_step_plain(v, w_ad, syn_ex, syn_in, ref_count, group_id,
                               input_ex, input_in, table)
    out = _two_variable.launch(
        "adex_step", v, w_ad, syn_ex, syn_in, ref_count, group_id, input_ex,
        input_in, table, NCOL)
    adex_step.launches += 1
    return out


#: kernel launches so far (plain-version calls do not count)
adex_step.launches = 0
