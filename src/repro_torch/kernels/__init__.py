"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its
plain-torch twin; see each module for the Pallas kernel it replaces.

Each wrapper counts the launches of its kernel (never its twin's calls);
:func:`launch_counts` reads them all and :func:`reset_launch_counts` sets
them to 0.
"""

from __future__ import annotations

__all__ = ["launch_counts", "reset_launch_counts"]


def _wrappers() -> dict:
    from repro_torch.kernels import (adex_step, flash_attention,
                                     izhikevich_step, lif_step, stdp_update,
                                     synaptic_gather)
    return {"synaptic_gather": synaptic_gather.synaptic_gather,
            "lif_step": lif_step.lif_step,
            "stdp_update": stdp_update.stdp_update,
            "izhikevich_step": izhikevich_step.izhikevich_step,
            "adex_step": adex_step.adex_step,
            "blocked_reduce_sweep": synaptic_gather.blocked_reduce_sweep,
            "stdp_update_worklist": stdp_update.stdp_update_worklist,
            "flash_attention": flash_attention.flash_attention}


def _fused():
    from repro_torch.kernels.synaptic_gather import synaptic_gather_update
    return synaptic_gather_update


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset, by kernel; K1 with a
    neuron epilogue counts as ``synaptic_gather_<neuron>``."""
    out = {k: fn.launches for k, fn in _wrappers().items()}
    out.update({f"synaptic_gather_{n}": c
                for n, c in _fused().launches_by_neuron.items()})
    return out


def reset_launch_counts() -> None:
    """Every kernel's launch count to 0."""
    fused = _fused()
    for fn in (*_wrappers().values(), fused):
        fn.launches = 0
    fused.launches_by_neuron.update(dict.fromkeys(fused.launches_by_neuron,
                                                  0))
