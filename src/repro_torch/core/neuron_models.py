"""NeuronModel registry: pluggable per-neuron dynamics (DESIGN.md §12).

The port of the reference package's ``core/neuron_models.py``, with the
``"lif"`` model only, so that ``EngineConfig.neuron_model`` and the state's
model marker keep their meaning.  The reference's izhikevich, adex and
poisson models (and the ``<base>+poisson`` composites) are not ported yet:
:func:`get_model` raises for them.

A model owns its per-group parameter table, its state, a plain-torch
``step`` that every backend can run and, optionally, ``kernel_step``, the
CUDA kernel twin the kernel backend runs.
"""

from __future__ import annotations

from repro_torch.core import snn
from repro_torch.kernels.lif_step import lif_step as lif_step_kernel

__all__ = ["NeuronModel", "LIFModel", "get_model", "available_models"]


class NeuronModel:
    """One neuron dynamics implementation."""

    name: str = "?"
    param_cls: type = snn.LIFParams
    #: kernel twin of ``step`` (same signature) or None
    kernel_step = None

    def check_groups(self, groups) -> None:
        for i, g in enumerate(groups):
            if not isinstance(g, self.param_cls):
                raise TypeError(
                    f"model {self.name!r} takes {self.param_cls.__name__} "
                    f"groups; group {i} is {type(g).__name__}")

    def make_param_table(self, groups, dt: float, dtype, device):
        raise NotImplementedError

    def init_state(self, n: int, group_id, groups, *, dtype,
                   device) -> snn.NeuronState:
        raise NotImplementedError

    def step(self, state: snn.NeuronState, table, input_ex, input_in, *,
             synapse_model: str = snn.SynapseModel.CURRENT_EXP):
        """One dt of dynamics in plain torch."""
        raise NotImplementedError


class LIFModel(NeuronModel):
    """The LIF neuron of :mod:`repro_torch.core.snn`; ``kernel_step`` runs
    it through K2 (:mod:`repro_torch.kernels.lif_step`)."""

    name = "lif"
    param_cls = snn.LIFParams

    def make_param_table(self, groups, dt, dtype, device):
        self.check_groups(groups)
        return snn.make_param_table(list(groups), dt, dtype=dtype,
                                    device=device)

    def init_state(self, n, group_id, groups, *, dtype, device):
        self.check_groups(groups)
        return snn.init_state(n, group_id, list(groups), dtype=dtype,
                              device=device)

    def step(self, state, table, input_ex, input_in, *,
             synapse_model=snn.SynapseModel.CURRENT_EXP):
        return snn.lif_step(state, table, input_ex, input_in,
                            synapse_model=synapse_model)

    def kernel_step(self, state, table, input_ex, input_in, *,
                    synapse_model=snn.SynapseModel.CURRENT_EXP):
        if synapse_model not in (snn.SynapseModel.CURRENT_EXP,
                                 snn.SynapseModel.COND_EXP):
            raise ValueError(f"unknown synapse model {synapse_model!r}")
        v, se, si, rc, sp = lif_step_kernel(
            state.v_m, state.syn_ex, state.syn_in, state.ref_count,
            state.group_id, input_ex, input_in, table,
            cond=synapse_model == snn.SynapseModel.COND_EXP)
        return snn.NeuronState(v_m=v, syn_ex=se, syn_in=si, ref_count=rc,
                               spike=sp, group_id=state.group_id)


_REGISTRY = {"lif": LIFModel()}
#: reference models that wait for a later slice of the port
_NOT_PORTED = ("izhikevich", "adex", "poisson")


def get_model(name) -> NeuronModel:
    if isinstance(name, NeuronModel):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if isinstance(name, str) and (name in _NOT_PORTED
                                  or name.endswith("+poisson")):
        raise NotImplementedError(
            f"neuron model {name!r} is not ported yet; the port has "
            f"{available_models()}")
    raise ValueError(f"unknown neuron model {name!r}; available: "
                     f"{available_models()}")


def available_models() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
