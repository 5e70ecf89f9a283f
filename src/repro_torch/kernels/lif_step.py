"""K2: fused LIF neuron update - CUDA kernel and plain twin.

Ports ``src/repro/kernels/lif_step.py::lif_step_kernel`` (the Pallas TPU
kernel): table gather by group, synaptic decay plus input, exact-integration
or conductance membrane update, refractory clamp, threshold, reset and
refractory countdown.  Both versions follow the Pallas kernel's op order
(``v*p_vv + syn_ex*p_ve + syn_in*p_vi + p_vconst``, left to right), which
differs from :func:`repro_torch.core.snn.lif_step`'s.

The kernel is ``csrc/lif_step.cu`` (one thread per neuron, built with
``--fmad=false``).  For CPU tensors :func:`lif_step` runs
:func:`lif_step_plain`; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.snn import COL, NCOL, surrogate_spike
from repro_torch.kernels import _build

__all__ = ["lif_step", "lif_step_plain"]


def lif_step_plain(v, syn_ex, syn_in, ref_count, group_id, input_ex,
                   input_in, table, *, cond: bool = False, spike_fn=None):
    """Plain-torch twin: ``(v, syn_ex, syn_in, ref_count, spike)``.

    ``spike_fn`` (surrogate mode): the spike is the float
    ``spike_fn(v_new - v_th)``, 0 where refractory; every other output,
    and the spike's values, are unchanged (see
    :func:`repro_torch.core.snn.lif_step`)."""
    tb = table[group_id.long()]
    get = lambda name: tb[:, COL[name]]
    p_vv, p_ee, p_ii = get("p_vv"), get("p_ee"), get("p_ii")
    v_th, v_reset = get("v_th"), get("v_reset")
    ref_steps = get("ref_steps").to(torch.int32)

    se_new = syn_ex * p_ee + input_ex
    si_new = syn_in * p_ii + input_in
    if cond:
        i_cond = syn_ex * (get("e_ex") - v) - syn_in * (v - get("e_in"))
        v_prop = v * p_vv + get("p_vconst") + i_cond * get("inv_cm_dt")
    else:
        v_prop = (v * p_vv + syn_ex * get("p_ve") + syn_in * get("p_vi")
                  + get("p_vconst"))

    refractory = ref_count > 0
    v_new = torch.where(refractory, v_reset, v_prop)
    spike = ~refractory & (v_new >= v_th)
    spike_out = spike if spike_fn is None else surrogate_spike(
        spike_fn, refractory, v_new, v_th)
    v_new = torch.where(spike, v_reset, v_new)
    rc_new = torch.where(spike, ref_steps,
                         torch.clamp(ref_count - 1, min=0)).to(torch.int32)
    return v_new, se_new, si_new, rc_new, spike_out


def _launcher():
    fn = _build.load("lif_step").lif_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return fn


def lif_step(v, syn_ex, syn_in, ref_count, group_id, input_ex, input_in,
             table, *, cond: bool = False):
    """All neuron arrays (N,): f32 state and inputs, int32 ``ref_count`` and
    ``group_id``; ``table`` (G, NCOL) f32, its rows contiguous but possibly
    further apart (a composite's ``table[:, :-1]``).  Returns the new
    ``(v, syn_ex, syn_in, ref_count, spike)``, ``spike`` bool.  Group ids
    are not range-checked on the card (that would sync every step)."""
    _build.require_no_grad("lif_step", v, syn_ex, syn_in, input_ex,
                           input_in, table)
    if _build.dispatch_device(v) == "cpu":
        return lif_step_plain(v, syn_ex, syn_in, ref_count, group_id,
                              input_ex, input_in, table, cond=cond)
    dev = v.device
    n = v.shape[0]
    if v.dim() != 1 or n < 1:
        raise ValueError(f"v must be a non-empty vector, got "
                         f"{tuple(v.shape)}")
    for name, x in (("v", v), ("syn_ex", syn_ex), ("syn_in", syn_in),
                    ("input_ex", input_ex), ("input_in", input_in)):
        _build.check_tensor(x, name, torch.float32, (n,), dev)
    for name, x in (("ref_count", ref_count), ("group_id", group_id)):
        _build.check_tensor(x, name, torch.int32, (n,), dev)
    stride = _build.check_table(table, NCOL, dev)

    f32 = lambda: torch.empty(n, dtype=torch.float32, device=dev)
    v_out, se_out, si_out = f32(), f32(), f32()
    rc_out = torch.empty(n, dtype=torch.int32, device=dev)
    spike = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(
            v.data_ptr(), syn_ex.data_ptr(), syn_in.data_ptr(),
            ref_count.data_ptr(), group_id.data_ptr(), input_ex.data_ptr(),
            input_in.data_ptr(), table.data_ptr(), stride, n,
            int(bool(cond)),
            v_out.data_ptr(), se_out.data_ptr(), si_out.data_ptr(),
            rc_out.data_ptr(), spike.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lif_step")
    lif_step.launches += 1
    return v_out, se_out, si_out, rc_out, spike


#: kernel launches so far (plain-version calls do not count)
lif_step.launches = 0
