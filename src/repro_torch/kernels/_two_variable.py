"""The launcher shared by the two-variable neuron updates (K4, K5).

``csrc/izhikevich_step.cu`` and ``csrc/adex_step.cu`` update a membrane
``v`` and one more state variable ``x`` (Izhikevich's ``u``, AdEx's
``w_ad``) and take the same C interface:

    int <name>_launch(v, x, syn_ex, syn_in, ref_count, group_id,
                      input_ex, input_in, table, int table_stride, int n,
                      v_out, x_out, se_out, si_out, rc_out, spike_out,
                      stream)
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["launch"]


def launch(name: str, v, x, syn_ex, syn_in, ref_count, group_id, input_ex,
           input_in, table, ncol: int):
    """Validate the arguments and launch ``csrc/<name>.cu``; ``table`` is
    (G, ``ncol``) with contiguous rows, which may lie further apart.
    Returns the new ``(v, x, syn_ex, syn_in, ref_count, spike)``."""
    dev = v.device
    n = v.shape[0]
    if v.dim() != 1 or n < 1:
        raise ValueError(f"v must be a non-empty vector, got "
                         f"{tuple(v.shape)}")
    for arg, t in (("v", v), ("x", x), ("syn_ex", syn_ex),
                   ("syn_in", syn_in), ("input_ex", input_ex),
                   ("input_in", input_in)):
        _build.check_tensor(t, arg, torch.float32, (n,), dev)
    for arg, t in (("ref_count", ref_count), ("group_id", group_id)):
        _build.check_tensor(t, arg, torch.int32, (n,), dev)
    stride = _build.check_table(table, ncol, dev)

    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(4)]
    outs += [torch.empty(n, dtype=torch.int32, device=dev),
             torch.empty(n, dtype=torch.bool, device=dev)]
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), x.data_ptr(), syn_ex.data_ptr(),
                 syn_in.data_ptr(), ref_count.data_ptr(), group_id.data_ptr(),
                 input_ex.data_ptr(), input_in.data_ptr(), table.data_ptr(),
                 stride, n, *(o.data_ptr() for o in outs),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    return tuple(outs)
