"""NeuronModel registry: pluggable per-neuron dynamics (DESIGN.md §12).

The port of the reference package's ``core/neuron_models.py``.  A
:class:`NeuronModel` owns the per-group parameter table, the per-neuron
state (common fields + ``extra_fields``), a plain-torch ``step`` that every
backend can run and, optionally, ``kernel_step``, its CUDA kernel twin,
which the ``"cuda"`` backend runs.  Shipped models:

* ``"lif"``        - :mod:`repro_torch.core.snn`, kernel K2;
* ``"izhikevich"`` - Izhikevich 2003, ``u`` in ``extra["u"]``, kernel K4;
* ``"adex"``       - adaptive exponential IF, ``extra["w_ad"]``, the
  exponential's argument clamped at :data:`EXP_CLAMP`, kernel K5;
* ``"poisson"``    - a stateless stochastic emitter, no kernel (a single
  Bernoulli draw per neuron, the same on every backend);
* ``"<base>+poisson"`` composites, resolved lazily: base-model groups
  integrate, :class:`PoissonParams` groups emit.

Stochastic models (``stochastic=True``) draw one uniform per neuron and
step.  The reference draws them with ``jax.random.fold_in(key, t, gid)``,
which no torch generator reproduces, so the engine takes the draws as an
optional input (``model_uniform``) and the parity tests feed it the
reference's.  Without it the draws come from :func:`gid_uniform`, a
counter-based hash of (seed, step, GLOBAL neuron id) in plain torch integer
ops: invariant to row order and to decomposition, as DESIGN.md §14 asks of
the reference's, and independent of the drive's generator, so that
deterministic models leave the external-drive stream untouched.

Surrogate-gradient mode (DESIGN.md §17): the threshold models
(``supports_surrogate``: lif, izhikevich, adex) take ``step(...,
surrogate=<spec>)`` and return the float spike of
:mod:`repro_torch.diff.surrogate` (:meth:`NeuronModel.spike_fn`), the same
values as the bool with a pseudo-derivative; ``poisson`` and the
``+poisson`` composites refuse a surrogate, as in the reference.  The
kernels have no surrogate form: the ``"cuda"`` backend runs them as in
inference and casts their spike to float.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import snn
from repro_torch.core.device import resolve_device
from repro_torch.diff import surrogate as surrogate_mod
from repro_torch.kernels import adex_step as adex_kernel_mod
from repro_torch.kernels import izhikevich_step as izh_kernel_mod
from repro_torch.kernels.adex_step import EXP_CLAMP
from repro_torch.kernels.lif_step import lif_step as lif_step_kernel

__all__ = [
    "NeuronModel", "LIFModel", "IzhikevichModel", "AdExModel",
    "PoissonModel", "PoissonDriveModel", "IzhikevichParams", "AdExParams",
    "PoissonParams", "register_model", "get_model", "available_models",
    "gid_uniform", "EXP_CLAMP",
]


# --------------------------------------------------------------------------
# per-group parameter sets (the reference's, field for field)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IzhikevichParams:
    """Izhikevich 2003 per-group parameters (RS defaults)."""

    a: float = 0.02           # recovery time scale [1/ms]
    b: float = 0.2            # recovery sensitivity
    c: float = -65.0          # reset potential [mV]
    d: float = 8.0            # recovery increment on spike
    v_peak: float = 30.0      # spike cutoff [mV]
    t_ref: float = 0.0        # absolute refractory period [ms] (0 = none)
    tau_syn_ex: float = 5.0   # exc. synaptic time constant [ms]
    tau_syn_in: float = 5.0
    i_e: float = 0.0          # constant drive (model current units)
    i_scale: float = 1.0      # synaptic input scale (pA -> model units)


@dataclasses.dataclass(frozen=True)
class AdExParams:
    """AdEx per-group parameters (Brette & Gerstner 2005 / NEST aeif
    defaults; ``aeif_psc_exp`` current-based synapses)."""

    c_m: float = 281.0        # membrane capacitance [pF]
    g_l: float = 30.0         # leak conductance [nS]
    e_l: float = -70.6        # leak reversal [mV]
    v_t: float = -50.4        # exponential threshold [mV]
    delta_t: float = 2.0      # slope factor [mV]
    v_peak: float = 0.0       # spike detection cutoff [mV]
    v_reset: float = -60.0
    tau_w: float = 144.0      # adaptation time constant [ms]
    a: float = 4.0            # subthreshold adaptation [nS]
    b: float = 80.5           # spike-triggered adaptation [pA]
    t_ref: float = 2.0
    tau_syn_ex: float = 2.0
    tau_syn_in: float = 2.0
    i_e: float = 0.0


@dataclasses.dataclass(frozen=True)
class PoissonParams:
    """A stochastic emitter group (rate in spikes/s per neuron)."""

    rate_hz: float = 10.0


# --------------------------------------------------------------------------
# counter-based per-neuron draws
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) (a Python int or an
    int64 tensor): in 16-bit halves, so that no product leaves int64's
    range (signed overflow is undefined in C++, torch's kernels' language)."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """A 32-bit integer finaliser (xor-shift-multiply, "lowbias32") on
    values in [0, 2**32); every shift acts on a non-negative value."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gid_uniform(seed: int, t, gid) -> torch.Tensor:
    """Per-neuron U[0, 1) float32 draws keyed by (``seed``, step ``t``,
    GLOBAL neuron id ``gid``): ``hash(hash(hash(seed) ^ t) ^ gid)``, top 24
    bits.  ``t`` is an int or a 0-d int tensor on the device (no host
    sync), ``gid`` (n,) int32 (-1 on padding rows, which draw harmlessly).
    A draw depends on nothing else, so a permutation of the rows permutes
    the draws and any decomposition of the network draws the same spikes."""
    t = t.to(torch.int64) if isinstance(t, torch.Tensor) else int(t)
    h_t = _hash32(_hash32(int(seed) & _M32) ^ (t & _M32))
    h = _hash32(h_t ^ (gid.to(torch.int64) & _M32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


# --------------------------------------------------------------------------
# model interface
# --------------------------------------------------------------------------

class NeuronModel:
    """One neuron dynamics implementation (DESIGN.md §12)."""

    name: str = "?"
    param_cls: type = snn.LIFParams
    #: model-specific per-neuron state variables (NeuronState.extra keys)
    extra_fields: tuple[str, ...] = ()
    #: True iff ``step`` consumes per-neuron uniform draws
    stochastic: bool = False
    #: kernel twin of ``step`` (same signature) or None
    kernel_step = None
    #: True iff ``step`` accepts ``surrogate=`` (DESIGN.md §17): a
    #: surrogate-gradient spec ("st[:width]" / "fast_sigmoid[:beta]")
    #: that turns the returned ``spike`` into the float surrogate spike
    supports_surrogate: bool = False

    # -- build-time -------------------------------------------------------
    def check_groups(self, groups) -> None:
        for i, g in enumerate(groups):
            if not isinstance(g, self.param_cls):
                raise TypeError(
                    f"model {self.name!r} takes {self.param_cls.__name__} "
                    f"groups; group {i} is {type(g).__name__} (pick the "
                    "matching EngineConfig.neuron_model)")

    def _rows(self, groups, dt: float) -> list:
        """Float64 rows of the (G, NCOL) table."""
        raise NotImplementedError

    def make_param_table(self, groups, dt: float, dtype=torch.float32,
                         device="cuda") -> torch.Tensor:
        """The (G, NCOL) per-group table for time step ``dt``, computed in
        float64 numpy and cast once, as the reference does; on ``device``
        (the card unless ``device="cpu"``)."""
        self.check_groups(groups)
        return torch.as_tensor(np.asarray(self._rows(groups, dt)),
                               dtype=dtype, device=resolve_device(device))

    def init_vars(self, group_id: np.ndarray, groups) -> dict:
        """Initial per-neuron state arrays (numpy): keys ``v_m, syn_ex,
        syn_in, ref_count`` + ``extra_fields``."""
        raise NotImplementedError

    def init_state(self, n: int, group_id, groups, *, dtype=torch.float32,
                   device="cuda") -> snn.NeuronState:
        """Initial state on ``device`` (the card unless ``device="cpu"``),
        each variable cast once from :meth:`init_vars`."""
        dev = resolve_device(device)
        gid = np.asarray(group_id, dtype=np.int32)
        v = self.init_vars(gid, groups)
        f = lambda k: torch.as_tensor(v[k], dtype=dtype, device=dev)
        return snn.NeuronState(
            v_m=f("v_m"), syn_ex=f("syn_ex"), syn_in=f("syn_in"),
            ref_count=torch.as_tensor(v["ref_count"], dtype=torch.int32,
                                      device=dev),
            spike=torch.zeros((n,), dtype=torch.bool, device=dev),
            group_id=torch.as_tensor(gid, device=dev),
            extra={k: f(k) for k in self.extra_fields})

    # -- struct contract --------------------------------------------------
    def check_state(self, state: snn.NeuronState) -> None:
        """A state built for another model raises instead of being
        misread."""
        have = tuple(sorted(state.extra))
        want = tuple(sorted(self.extra_fields))
        if have != want:
            raise ValueError(
                f"neuron state carries extra fields {have} but model "
                f"{self.name!r} expects {want} - state was built for a "
                "different neuron_model; re-init with init_state("
                f"neuron_model={self.name!r})")
        for k in self.extra_fields:
            if state.extra[k].shape != state.v_m.shape:
                raise ValueError(
                    f"extra field {k!r} has shape "
                    f"{tuple(state.extra[k].shape)}, expected "
                    f"{tuple(state.v_m.shape)}")

    # -- run-time ---------------------------------------------------------
    def step(self, state: snn.NeuronState, table, input_ex, input_in, *,
             synapse_model: str = snn.SynapseModel.CURRENT_EXP, seed=None,
             t=None, gid=None, uniform=None,
             surrogate=None) -> snn.NeuronState:
        """One dt of dynamics in plain torch.

        Stochastic models take ``uniform`` ((n,) float32 draws) or draw
        :func:`gid_uniform` from ``seed``, step ``t`` and GLOBAL ids
        ``gid``; deterministic models ignore all four.  Models with
        ``supports_surrogate`` also take ``surrogate=`` (a spec, None for
        inference): the returned ``spike`` is then the float surrogate
        spike (same values, surrogate derivative) - DESIGN.md §17.
        """
        raise NotImplementedError

    def spike_fn(self, surrogate: str | None):
        """The spike function ``step`` emits under ``surrogate`` (None =
        inference: the bool, no function); raises for models without a
        threshold to differentiate."""
        if surrogate is None:
            return None
        if not self.supports_surrogate:
            raise ValueError(
                f"model {self.name!r} does not support surrogate-gradient "
                "mode (no spike threshold to differentiate); use one of "
                "the threshold models (lif / izhikevich / adex)")
        return surrogate_mod.get_surrogate(surrogate)


def _draws(model: NeuronModel, n: int, seed, t, gid, uniform):
    """The (n,) uniforms of a stochastic step: the injected ones, or the
    counter-based hash."""
    if uniform is not None:
        if tuple(uniform.shape) != (n,):
            raise ValueError(f"uniform must be ({n},), got "
                             f"{tuple(uniform.shape)}")
        return uniform
    if seed is None or t is None or gid is None:
        raise ValueError(
            f"model {model.name!r} is stochastic: the engine must pass "
            "uniform= or seed=, t= and gid= to neuron_update")
    return gid_uniform(seed, t, gid)


def _require_current(model: NeuronModel, synapse_model: str) -> None:
    if synapse_model != snn.SynapseModel.CURRENT_EXP:
        raise ValueError(
            f"model {model.name!r} implements current-based exponential "
            f"synapses only; synapse_model={synapse_model!r} is not "
            "supported (use 'lif' for cond_exp)")


# --------------------------------------------------------------------------
# LIF: delegates to repro_torch.core.snn and K2
# --------------------------------------------------------------------------

class LIFModel(NeuronModel):
    """The LIF neuron of :mod:`repro_torch.core.snn`; ``kernel_step`` runs
    it through K2 (:mod:`repro_torch.kernels.lif_step`)."""

    name = "lif"
    param_cls = snn.LIFParams
    supports_surrogate = True

    def make_param_table(self, groups, dt, dtype=torch.float32,
                         device="cuda"):
        self.check_groups(groups)
        return snn.make_param_table(list(groups), dt, dtype=dtype,
                                    device=device)

    def init_vars(self, group_id, groups):
        e_l = np.asarray([g.e_l for g in groups], dtype=np.float64)
        z = np.zeros(group_id.shape, dtype=np.float32)
        return dict(v_m=e_l[group_id], syn_ex=z, syn_in=z,
                    ref_count=np.zeros(group_id.shape, dtype=np.int32))

    def step(self, state, table, input_ex, input_in, *,
             synapse_model=snn.SynapseModel.CURRENT_EXP, seed=None, t=None,
             gid=None, uniform=None, surrogate=None):
        return snn.lif_step(state, table, input_ex, input_in,
                            synapse_model=synapse_model,
                            spike_fn=self.spike_fn(surrogate))

    def kernel_step(self, state, table, input_ex, input_in, *,
                    synapse_model=snn.SynapseModel.CURRENT_EXP, seed=None,
                    t=None, gid=None, uniform=None):
        if synapse_model not in (snn.SynapseModel.CURRENT_EXP,
                                 snn.SynapseModel.COND_EXP):
            raise ValueError(f"unknown synapse model {synapse_model!r}")
        v, se, si, rc, sp = lif_step_kernel(
            state.v_m, state.syn_ex, state.syn_in, state.ref_count,
            state.group_id, input_ex, input_in, table,
            cond=synapse_model == snn.SynapseModel.COND_EXP)
        return snn.NeuronState(v_m=v, syn_ex=se, syn_in=si, ref_count=rc,
                               spike=sp, group_id=state.group_id,
                               extra=state.extra)


# --------------------------------------------------------------------------
# two-variable models: Izhikevich (K4) and AdEx (K5)
# --------------------------------------------------------------------------

class _TwoVariableModel(NeuronModel):
    """A model whose state is the common fields plus one extra variable,
    stepped by a plain twin and a kernel of one signature
    ``(v, x, syn_ex, syn_in, ref_count, group_id, input_ex, input_in,
    table) -> (v, x, syn_ex, syn_in, ref_count, spike)``."""

    _plain = None    # staticmethod: the plain twin
    _kernel = None   # staticmethod: the kernel wrapper
    supports_surrogate = True

    def _run(self, fn, state, table, input_ex, input_in, synapse_model,
             **kw):
        _require_current(self, synapse_model)
        (x_name,) = self.extra_fields
        v, x, se, si, rc, sp = fn(
            state.v_m, state.extra[x_name], state.syn_ex, state.syn_in,
            state.ref_count, state.group_id, input_ex, input_in, table, **kw)
        return snn.NeuronState(v_m=v, syn_ex=se, syn_in=si, ref_count=rc,
                               spike=sp, group_id=state.group_id,
                               extra={x_name: x})

    def step(self, state, table, input_ex, input_in, *,
             synapse_model=snn.SynapseModel.CURRENT_EXP, seed=None, t=None,
             gid=None, uniform=None, surrogate=None):
        return self._run(self._plain, state, table, input_ex, input_in,
                         synapse_model, spike_fn=self.spike_fn(surrogate))

    def kernel_step(self, state, table, input_ex, input_in, *,
                    synapse_model=snn.SynapseModel.CURRENT_EXP, seed=None,
                    t=None, gid=None, uniform=None):
        return self._run(self._kernel, state, table, input_ex, input_in,
                         synapse_model)


class IzhikevichModel(_TwoVariableModel):
    """Izhikevich 2003 quadratic two-variable dynamics; ``u`` in
    ``extra["u"]``.  ``step`` and K4 share the reference's op order."""

    name = "izhikevich"
    param_cls = IzhikevichParams
    extra_fields = ("u",)
    _plain = staticmethod(izh_kernel_mod.izhikevich_step_plain)
    _kernel = staticmethod(izh_kernel_mod.izhikevich_step)

    def _rows(self, groups, dt):
        return [[
            np.exp(-dt / g.tau_syn_ex),
            np.exp(-dt / g.tau_syn_in),
            dt, g.a, g.b, g.c, g.d, g.v_peak,
            max(1.0, round(g.t_ref / dt)) if g.t_ref > 0 else 0.0,
            g.i_e, g.i_scale,
        ] for g in groups]

    def init_vars(self, group_id, groups):
        c = np.asarray([g.c for g in groups], dtype=np.float64)
        b = np.asarray([g.b for g in groups], dtype=np.float64)
        v0 = c[group_id]
        z = np.zeros(group_id.shape, dtype=np.float32)
        return dict(v_m=v0, syn_ex=z, syn_in=z,
                    ref_count=np.zeros(group_id.shape, dtype=np.int32),
                    u=b[group_id] * v0)


class AdExModel(_TwoVariableModel):
    """Adaptive exponential IF; adaptation current in ``extra["w_ad"]``,
    the exponential's argument clamped at :data:`EXP_CLAMP`.  ``step`` and
    K5 share the reference's op order."""

    name = "adex"
    param_cls = AdExParams
    extra_fields = ("w_ad",)
    _plain = staticmethod(adex_kernel_mod.adex_step_plain)
    _kernel = staticmethod(adex_kernel_mod.adex_step)

    def _rows(self, groups, dt):
        return [[
            np.exp(-dt / g.tau_syn_ex),
            np.exp(-dt / g.tau_syn_in),
            dt / g.c_m, g.g_l, g.e_l, g.v_t, g.delta_t, g.v_peak,
            g.v_reset, dt / g.tau_w, g.a, g.b,
            max(1.0, round(g.t_ref / dt)) if g.t_ref > 0 else 0.0,
            g.i_e,
        ] for g in groups]

    def init_vars(self, group_id, groups):
        e_l = np.asarray([g.e_l for g in groups], dtype=np.float64)
        z = np.zeros(group_id.shape, dtype=np.float32)
        return dict(v_m=e_l[group_id], syn_ex=z, syn_in=z,
                    ref_count=np.zeros(group_id.shape, dtype=np.int32),
                    w_ad=z)


# --------------------------------------------------------------------------
# Poisson emitter population
# --------------------------------------------------------------------------

def _spike_prob(rate_hz: float, dt: float) -> float:
    return min(max(rate_hz, 0.0) * dt * 1e-3, 1.0)


class PoissonModel(NeuronModel):
    """Stateless stochastic emitter: ``spike = u < rate*dt`` for one
    uniform ``u`` per neuron and step, no membrane dynamics, inputs
    ignored.  No kernel: the update is a single draw, the same on every
    backend."""

    name = "poisson"
    param_cls = PoissonParams
    stochastic = True

    def _rows(self, groups, dt):
        return [[_spike_prob(g.rate_hz, dt)] for g in groups]

    def init_vars(self, group_id, groups):
        z = np.zeros(group_id.shape, dtype=np.float32)
        return dict(v_m=z, syn_ex=z, syn_in=z,
                    ref_count=np.zeros(group_id.shape, dtype=np.int32))

    def step(self, state, table, input_ex, input_in, *,
             synapse_model=snn.SynapseModel.CURRENT_EXP, seed=None, t=None,
             gid=None, uniform=None, surrogate=None):
        self.spike_fn(surrogate)
        p = table[state.group_id.long(), 0]
        u = _draws(self, p.shape[0], seed, t, gid, uniform)
        return dataclasses.replace(state, spike=u < p)


# --------------------------------------------------------------------------
# composite: a dynamical model + poisson emitter groups in ONE network
# --------------------------------------------------------------------------

class PoissonDriveModel(NeuronModel):
    """``"<base>+poisson"``: mixed group lists - base-model groups
    integrate, :class:`PoissonParams` groups emit Bernoulli spikes.

    The table is the base model's with one trailing ``p_spike`` column (0
    for dynamical groups).  Emitter rows keep their initial state; only
    their spike bit is drawn.  The kernel path runs the base kernel on the
    view ``table[:, :-1]`` (the kernels take the row stride), then the same
    elementwise overlay as the plain path.
    """

    def __init__(self, base: NeuronModel):
        if base.stochastic:
            raise ValueError(f"cannot stack poisson onto stochastic base "
                             f"{base.name!r}")
        self.base = base
        self.name = f"{base.name}+poisson"
        self.param_cls = base.param_cls   # + PoissonParams, see _split
        self.extra_fields = base.extra_fields
        self.stochastic = True
        self.kernel_step = (None if base.kernel_step is None
                            else self._kernel_step)

    def _split(self, groups):
        """Substitute emitter groups with base defaults; emit rate row."""
        base_groups, rates = [], []
        for i, g in enumerate(groups):
            if isinstance(g, PoissonParams):
                base_groups.append(self.base.param_cls())
                rates.append(g.rate_hz)
            elif isinstance(g, self.base.param_cls):
                base_groups.append(g)
                rates.append(0.0)
            else:
                raise TypeError(
                    f"model {self.name!r} takes {self.base.param_cls.__name__}"
                    f" or PoissonParams groups; group {i} is "
                    f"{type(g).__name__}")
        return base_groups, rates

    def check_groups(self, groups) -> None:
        self._split(groups)

    def make_param_table(self, groups, dt, dtype=torch.float32,
                         device="cuda"):
        base_groups, rates = self._split(groups)
        base_tbl = self.base.make_param_table(base_groups, dt, dtype=dtype,
                                              device=device)
        p = torch.as_tensor(np.asarray([_spike_prob(r, dt) for r in rates]),
                            dtype=dtype, device=base_tbl.device)
        return torch.cat([base_tbl, p[:, None]], dim=1)

    def init_vars(self, group_id, groups):
        base_groups, _ = self._split(groups)
        return self.base.init_vars(group_id, base_groups)

    def _overlay(self, state, new, table, seed, t, gid, uniform):
        """Emitter groups: freeze the dynamical update, draw the spike."""
        p = table[state.group_id.long(), -1]
        emit = p > 0
        u = _draws(self, p.shape[0], seed, t, gid, uniform)
        keep = lambda old, upd: torch.where(emit, old, upd)
        return snn.NeuronState(
            v_m=keep(state.v_m, new.v_m),
            syn_ex=keep(state.syn_ex, new.syn_ex),
            syn_in=keep(state.syn_in, new.syn_in),
            ref_count=keep(state.ref_count, new.ref_count),
            spike=torch.where(emit, u < p, new.spike),
            group_id=state.group_id,
            extra={f: keep(state.extra[f], new.extra[f])
                   for f in self.extra_fields})

    def step(self, state, table, input_ex, input_in, *,
             synapse_model=snn.SynapseModel.CURRENT_EXP, seed=None, t=None,
             gid=None, uniform=None, surrogate=None):
        self.spike_fn(surrogate)
        new = self.base.step(state, table[:, :-1], input_ex, input_in,
                             synapse_model=synapse_model)
        return self._overlay(state, new, table, seed, t, gid, uniform)

    def _kernel_step(self, state, table, input_ex, input_in, *,
                     synapse_model=snn.SynapseModel.CURRENT_EXP, seed=None,
                     t=None, gid=None, uniform=None):
        new = self.base.kernel_step(state, table[:, :-1], input_ex, input_in,
                                    synapse_model=synapse_model)
        return self._overlay(state, new, table, seed, t, gid, uniform)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, NeuronModel] = {}
# resolved "<base>+poisson" composites live in a side cache so the public
# listing stays the base models, as in the reference
_COMPOSITE_CACHE: dict[str, NeuronModel] = {}


def register_model(name: str, model: NeuronModel,
                   *, overwrite: bool = False) -> None:
    """Register a model under an ``EngineConfig.neuron_model`` name."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"neuron model {name!r} already registered")
    _REGISTRY[name] = model


def get_model(name) -> NeuronModel:
    if isinstance(name, NeuronModel):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _COMPOSITE_CACHE:
        return _COMPOSITE_CACHE[name]
    # "<base>+poisson" resolves (and caches) on first use
    if isinstance(name, str) and name.endswith("+poisson"):
        base = name[:-len("+poisson")]
        if base in _REGISTRY:
            model = PoissonDriveModel(_REGISTRY[base])
            _COMPOSITE_CACHE[name] = model
            return model
    raise ValueError(f"unknown neuron model {name!r}; available: "
                     f"{sorted(_REGISTRY)}")


def available_models() -> tuple[str, ...]:
    """The registered base models (``<base>+poisson`` composites are
    derived names and do not appear)."""
    return tuple(sorted(_REGISTRY))


register_model("lif", LIFModel())
register_model("izhikevich", IzhikevichModel())
register_model("adex", AdExModel())
register_model("poisson", PoissonModel())
