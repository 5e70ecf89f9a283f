"""K4: fused Izhikevich (2003) neuron update - CUDA kernel and plain twin.

Ports ``src/repro/kernels/izhikevich_step.py::izhikevich_step_kernel`` (the
Pallas TPU kernel).  Two-variable quadratic dynamics

    dv/dt = 0.04 v^2 + 5 v + 140 - u + I
    du/dt = a (b v - u)
    spike: v >= v_peak  ->  v <- c,  u <- u + d

integrated with forward Euler over the engine's exactly decaying
exponential synapses: ``I = i_scale * (syn_ex + syn_in) + i_e`` with the
*previous* step's synaptic state (arrivals act from t+dt on).  ``u`` rides
``NeuronState.extra["u"]``.

Both versions follow the reference's ``izhikevich_math`` op for op, left to
right: the quadratic amplifies an ulp, so the kernel is built with
``--fmad=false`` and equals :func:`izhikevich_step_plain` bitwise on the
card.  The kernel is ``csrc/izhikevich_step.cu`` (one thread per neuron);
for CPU tensors :func:`izhikevich_step` runs the plain twin, for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.snn import surrogate_spike
from repro_torch.kernels import _build, _two_variable

__all__ = ["izhikevich_step", "izhikevich_step_plain", "COL", "NCOL",
           "_COLS"]

# Parameter-table row layout (columns of the (G, NCOL) table), identical to
# the reference's; dt-derived entries come from
# IzhikevichModel.make_param_table.
_COLS = (
    "p_ee",       # exp(-dt / tau_syn_ex)
    "p_ii",       # exp(-dt / tau_syn_in)
    "dt",         # Euler step [ms]
    "a",
    "b",
    "c",          # reset potential [mV]
    "d",          # recovery increment on spike
    "v_peak",     # spike cutoff [mV]
    "ref_steps",  # t_ref / dt, rounded (0 = no refractoriness)
    "i_e",        # constant drive (model units)
    "i_scale",    # synaptic-input scale (pA -> model units)
)
COL = {name: i for i, name in enumerate(_COLS)}
NCOL = len(_COLS)


def izhikevich_step_plain(v, u, syn_ex, syn_in, ref_count, group_id,
                          input_ex, input_in, table, *, spike_fn=None):
    """Plain-torch twin: ``(v, u, syn_ex, syn_in, ref_count, spike)``.

    ``spike_fn`` (surrogate mode): the spike is the float
    ``spike_fn(v_new - v_peak)``, 0 where refractory, as in the reference's
    ``izhikevich_math``; every other output is unchanged."""
    tb = table[group_id.long()]
    get = lambda name: tb[:, COL[name]]
    dt = get("dt")
    se_new = syn_ex * get("p_ee") + input_ex
    si_new = syn_in * get("p_ii") + input_in
    # previous-step synaptic state drives v (arrivals act from t+dt on)
    i_in = get("i_scale") * (syn_ex + syn_in) + get("i_e")
    v_prop = v + dt * (0.04 * v * v + 5.0 * v + 140.0 - u + i_in)
    u_prop = u + dt * get("a") * (get("b") * v - u)
    refractory = ref_count > 0
    c = get("c")
    v_new = torch.where(refractory, c, v_prop)
    spike = ~refractory & (v_new >= get("v_peak"))
    spike_out = spike if spike_fn is None else surrogate_spike(
        spike_fn, refractory, v_new, get("v_peak"))
    v_new = torch.where(spike, c, v_new)
    u_new = torch.where(spike, u_prop + get("d"), u_prop)
    rc_new = torch.where(spike, get("ref_steps").to(torch.int32),
                         torch.clamp(ref_count - 1, min=0)).to(torch.int32)
    return v_new, u_new, se_new, si_new, rc_new, spike_out


def izhikevich_step(v, u, syn_ex, syn_in, ref_count, group_id, input_ex,
                    input_in, table):
    """All neuron arrays (N,): f32 ``v``, ``u``, synaptic state and inputs,
    int32 ``ref_count`` and ``group_id``; ``table`` (G, NCOL) f32, its
    rows contiguous but possibly further apart.  Returns the new
    ``(v, u, syn_ex, syn_in, ref_count, spike)``, ``spike`` bool.  Group
    ids are not range-checked on the card (that would sync every step)."""
    _build.require_no_grad("izhikevich_step", v, u, syn_ex, syn_in,
                           input_ex, input_in, table)
    if _build.dispatch_device(v) == "cpu":
        return izhikevich_step_plain(v, u, syn_ex, syn_in, ref_count,
                                     group_id, input_ex, input_in, table)
    out = _two_variable.launch(
        "izhikevich_step", v, u, syn_ex, syn_in, ref_count, group_id,
        input_ex, input_in, table, NCOL)
    izhikevich_step.launches += 1
    return out


#: kernel launches so far (plain-version calls do not count)
izhikevich_step.launches = 0
