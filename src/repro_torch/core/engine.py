"""Single-shard simulation engine: delay ring buffer + indegree edge sweep.

The port of the reference package's ``core/engine.py``.  Each shard owns an
indegree sub-graph stored as flat, padded, owner-sorted edge arrays
(:class:`ShardGraph`, sorted by (delay, post)) plus their post-block ELL twin
(``ShardGraph.blocked``).  Spikes fired at step ``s`` are written to
``ring[s % D]``; at step ``t`` a delay-``d`` edge reads
``ring[(t - d) % D]``.

One step (:func:`engine_step`) draws the external drive, then runs sweep ->
+ drive -> neuron update (one backend call, which the kernel backend fuses
into one launch for LIF and AdEx) -> STDP -> trace update -> ring write,
dispatching the hot path through the backend registry of
:mod:`repro_torch.core.backends`
(``EngineConfig.sweep``: ``"cuda"``, the kernel path, by default;
``"cuda:sparse"``, the activity gate; or ``"flat"``).  A step issues no
host synchronisation: the step counter ``t`` lives on the device and the
kernels read it there, and the gate decides its branch on the device;
:func:`run` syncs once, at the end.  ``EngineState.gate_overflow`` counts
the steps whose gate saturated (always 0 on ungated backends).

The gated backend updates plastic weights IN PLACE when its capacity is
below the block count (kernel K7): the weights tensor of the state given to
:func:`engine_step` is then the new state's, updated.  :func:`run` copies
the caller's weights once at its start, so its input state is left as it
was.

Differences from the reference, by design:

* the external Poisson drive is drawn with ``torch.poisson`` from the
  state's ``torch.Generator`` - it cannot reproduce ``jax.random``'s stream,
  so :func:`engine_step` and :func:`run` take the drive as an optional
  input, which is how the parity tests feed the reference's draws;
* so do the stochastic neuron models' per-neuron uniforms
  (``model_uniform``); without them a stochastic model draws
  :func:`~repro_torch.core.neuron_models.gid_uniform`, a hash of (the
  state's ``model_seed``, ``t``, global id) that leaves the drive's
  generator untouched, as the reference's deterministic models leave its
  key stream;
* the pre trace is incremented with ``scatter_reduce_(..., "amax")`` from
  zeros, where the reference's ``segment_max`` leaves ``-inf`` on mirrors
  with no edge; no weight reads those entries.

Writes are conflict-free by construction: every backend reduces over
owner-sorted post rows it exclusively owns (eq. 14).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import backends as backends_mod
from repro_torch.core import neuron_models as neuron_models_mod
from repro_torch.core import snn
from repro_torch.core import stdp as stdp_mod
from repro_torch.core.device import resolve_device

__all__ = ["ShardGraph", "EngineConfig", "EngineState", "init_state",
           "engine_step", "run", "state_with_weights_layout"]


@dataclasses.dataclass(frozen=True)
class ShardGraph:
    """Static per-shard graph arrays (numpy at build, tensors after
    :meth:`to`)."""

    n_local: int
    n_mirror: int
    max_delay: int
    pre_idx: Any      # (E,) int32
    post_idx: Any     # (E,) int32
    delay: Any        # (E,) int32, 1..max_delay; 0 marks padding
    channel: Any      # (E,) int32: 0 ex, 1 in
    plastic: Any      # (E,) bool
    weight_init: Any  # (E,) float
    bucket_ptr: np.ndarray  # (max_delay + 2,) int64: edge range per delay d
    # mirror table: where each mirror row's spike bit comes from
    mirror_src_shard: Any   # (n_mirror,) int32
    mirror_src_idx: Any     # (n_mirror,) int32
    group_id: Any           # (n_local,) int32 neuron group per owned neuron
    # per-neuron external Poisson drive (rate [Hz], weight [pA or nS])
    ext_rate: Any = None    # (n_local,) float32
    ext_weight: Any = None  # (n_local,) float32
    # GLOBAL neuron id per owned row (-1 on padding rows)
    global_id: Any = None   # (n_local,) int32
    # post-block ELL twin of the flat arrays (repro_torch.core.layout)
    blocked: Any = None

    @property
    def n_edges(self) -> int:
        return int(np.shape(self.pre_idx)[0])

    def to(self, device="cuda") -> "ShardGraph":
        """The run-time fields as tensors on ``device`` (the card unless
        ``device="cpu"``; raises without one).  The blocked twin moves too,
        without its build-time ``weight``."""
        dev = resolve_device(device)

        def t(a, dtype):
            return None if a is None else torch.as_tensor(
                np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                dtype=dtype, device=dev)

        bg = self.blocked
        if bg is not None:
            bg = dataclasses.replace(
                bg, pre_idx=t(bg.pre_idx, torch.int32),
                post_rel=t(bg.post_rel, torch.int32),
                delay=t(bg.delay, torch.int32),
                channel=t(bg.channel, torch.int32),
                plastic=t(bg.plastic, torch.bool),
                edge_perm=t(bg.edge_perm, torch.int32), weight=None)
        return dataclasses.replace(
            self,
            pre_idx=t(self.pre_idx, torch.int32),
            post_idx=t(self.post_idx, torch.int32),
            delay=t(self.delay, torch.int32),
            channel=t(self.channel, torch.int32),
            plastic=t(self.plastic, torch.bool),
            weight_init=t(self.weight_init, torch.float32),
            mirror_src_shard=t(self.mirror_src_shard, torch.int32),
            mirror_src_idx=t(self.mirror_src_idx, torch.int32),
            group_id=t(self.group_id, torch.int32),
            ext_rate=t(self.ext_rate, torch.float32),
            ext_weight=t(self.ext_weight, torch.float32),
            global_id=t(self.global_id, torch.int32),
            blocked=bg)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dt: float = 0.1                        # [ms]
    synapse_model: str = snn.SynapseModel.CURRENT_EXP
    stdp: stdp_mod.STDPParams | None = None
    sweep: str = "cuda"                    # backend name: "cuda" | "flat"
    external_drive: bool = True            # per-neuron Poisson (graph.ext_*)
    neuron_model: str = "lif"


@dataclasses.dataclass
class EngineState:
    neurons: snn.NeuronState
    ring: torch.Tensor       # (D, n_mirror) spike bits in the state dtype
    weights: torch.Tensor    # (E,) flat or (NB*EB,) blocked - see marker
    traces: stdp_mod.TraceState
    t: torch.Tensor          # () int32 step counter, on the device
    generator: torch.Generator  # stream of the external Poisson drive
    #: () int32 on the device: steps whose activity gate saturated its
    #: worklist and fell back to the dense pass (DESIGN.md §13); always 0
    #: on ungated backends.  None (a state made without it) counts as 0.
    gate_overflow: torch.Tensor | None = None
    #: layout of ``weights`` - "flat" or a shape-qualified blocked tag like
    #: "blocked:256x2048" (backends.layout_tag)
    weights_layout: str = "flat"
    #: which NeuronModel ``neurons`` was built for
    neuron_model: str = "lif"
    #: seed of a stochastic model's per-neuron draws (None for
    #: deterministic models)
    model_seed: int | None = None


def _on(dev: torch.device, x: torch.Tensor) -> bool:
    return x.device.type == dev.type and (
        dev.index is None or x.device.index == dev.index)


def _require_on(dev: torch.device, **tensors) -> None:
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} is a {type(x).__name__}, not a tensor "
                            f"(move the graph with graph.to({str(dev)!r}))")
        if not _on(dev, x):
            raise ValueError(f"{name} is on {x.device} but the run is on "
                             f"{dev}")


def init_state(graph: ShardGraph, groups, seed: int = 0, *,
               dtype=torch.float32,
               sweep: str | None = None, neuron_model: str = "lif",
               device="cuda") -> EngineState:
    """Fresh engine state on ``device`` (the card unless ``device="cpu"``).

    ``graph`` must already be on that device (:meth:`ShardGraph.to`).
    ``seed`` seeds the state's ``torch.Generator``, the stream of the
    external drive, and a stochastic model's draws (``model_seed``).
    ``neuron_model`` picks the dynamics (DESIGN.md §12): ``groups`` must be
    that model's parameter class.  ``sweep`` (a backend name) stores the
    weights in that backend's native layout up front; without it the state
    is flat and :func:`engine_step` converts at the boundary.
    """
    dev = resolve_device(device)
    _require_on(dev, pre_idx=graph.pre_idx, weight_init=graph.weight_init)
    model = neuron_models_mod.get_model(neuron_model)
    neurons = model.init_state(graph.n_local, graph.group_id.cpu().numpy(),
                               groups, dtype=dtype, device=dev)
    weights = graph.weight_init.to(dtype)
    weights_layout = "flat"
    if sweep is not None:
        backend = backends_mod.get_backend(sweep)
        if backend.weights_layout != "flat":
            layout = backend.prepare(graph)
            weights = backend.to_native_weights(layout, weights)
            weights_layout = backends_mod.layout_tag(
                layout, backend.weights_layout)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return EngineState(
        neurons=neurons,
        ring=torch.zeros((graph.max_delay, graph.n_mirror), dtype=dtype,
                         device=dev),
        weights=weights,
        traces=stdp_mod.init_traces(graph.n_mirror, graph.n_local, dtype,
                                    device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        generator=gen,
        gate_overflow=torch.zeros((), dtype=torch.int32, device=dev),
        weights_layout=weights_layout,
        neuron_model=model.name,
        model_seed=int(seed) if model.stochastic else None)


def state_with_weights_layout(state: EngineState, graph: ShardGraph,
                              target: str = "flat", *,
                              backend=None) -> EngineState:
    """Checkpoint/telemetry boundary: re-express ``state.weights`` in
    ``target`` layout ("flat" or "blocked"), through ``edge_perm`` once."""
    layout = (backend.prepare(graph) if backend is not None
              else backends_mod.layout_of(graph))
    tag = backends_mod.layout_tag(layout, target)
    if state.weights_layout == tag:
        return state
    w = backends_mod.convert_weights(layout, state.weights,
                                     state.weights_layout, tag)
    return dataclasses.replace(state, weights=w, weights_layout=tag)


def _poisson_drive(generator, graph: ShardGraph, dt: float, dtype):
    """Background Poisson input for the excitatory channel."""
    lam = graph.ext_rate * (dt * 1e-3)
    events = torch.poisson(lam, generator=generator)
    return (graph.ext_weight * events).to(dtype)


def engine_step(state: EngineState, graph: ShardGraph, table: torch.Tensor,
                cfg: EngineConfig, *, drive: torch.Tensor | None = None,
                model_uniform: torch.Tensor | None = None,
                backend: "backends_mod.SweepBackend | None" = None,
                layout: "backends_mod.EdgeLayout | None" = None,
                model: "neuron_models_mod.NeuronModel | None" = None):
    """One dt: drive, sweep -> + drive -> neuron update, STDP, ring write.
    Returns ``(new_state, spike_bits)``.  ``state`` is not modified, except
    its native-layout weights when the backend updates them in place
    (:meth:`~repro_torch.core.backends.SweepBackend.stdp_in_place`).

    ``drive`` ((n_local,), the state dtype) replaces this step's own
    Poisson draw; ``model_uniform`` ((n_local,) float32) a stochastic
    model's own uniforms.  ``backend``/``layout``/``model`` may be
    pre-resolved by callers that step in a loop (:func:`run` does).
    """
    dtype = state.weights.dtype
    if backend is None:
        backend = backends_mod.get_backend(cfg.sweep)
    if layout is None:
        layout = backend.prepare(graph)
    if model is None:
        model = neuron_models_mod.get_model(cfg.neuron_model)
    if state.neuron_model != model.name:
        raise ValueError(
            f"state was initialized for neuron_model="
            f"{state.neuron_model!r} but cfg selects {model.name!r}; "
            "re-init with init_state(neuron_model=...)")
    model.check_state(state.neurons)

    # weights in the backend's native layout; converting here is the
    # compatibility path for states built without ``sweep=``
    w_native, native_tag, convert = backends_mod.resolve_runtime_weights(
        backend, layout, state.weights, state.weights_layout)

    # (1) external stochastic drive, drawn first: it is the generator's
    #     only consumer in a step, so the stream is the same as when it was
    #     drawn after the sweep
    if drive is None and cfg.external_drive and graph.ext_rate is not None:
        drive = _poisson_drive(state.generator, graph, cfg.dt, dtype)

    # (2) synaptic sweep over owned edges, + drive, neuron dynamics (+ the
    #     gate's saturation count, the int 0 where no gate can saturate)
    neurons, arrived, gate_ovf = backend.sweep_update(
        layout, w_native, state.ring, state.t, state.neurons, table, drive,
        synapse_model=cfg.synapse_model, model=model, seed=state.model_seed,
        gid=graph.global_id, uniform=model_uniform)
    spike_bits = neurons.spike
    gate_overflow = (state.gate_overflow if state.gate_overflow is not None
                     else torch.zeros((), dtype=torch.int32,
                                      device=state.t.device))
    if isinstance(gate_ovf, torch.Tensor):
        gate_overflow = gate_overflow + gate_ovf

    # (3) plasticity: weights first (traces exclude this step's spikes:
    #     all-pairs convention), then the traces.  The pre trace is indexed
    #     by ARRIVAL at the mirror, so arrivals map back through the pre
    #     index matching ``arrived``'s layout.
    if cfg.stdp is not None:
        weights = backend.stdp_update(layout, w_native, arrived, spike_bits,
                                      state.traces, cfg.stdp)
        pre_arrived = torch.zeros(graph.n_mirror, dtype=arrived.dtype,
                                  device=arrived.device).scatter_reduce_(
            0, layout.arrival_pre, arrived, "amax")
        traces = stdp_mod.update_traces(state.traces, cfg.stdp, cfg.dt,
                                        pre_arrived, spike_bits)
        if convert:  # keep the carried layout stable for loop callers
            weights = backends_mod.convert_weights(
                layout, weights, native_tag, state.weights_layout)
    else:
        weights, traces = state.weights, state.traces

    # (4) this step's spikes into ring slot t % D; in the single-shard
    #     engine the mirror table is the identity over local neurons
    mirror_bits = spike_bits.index_select(0, graph.mirror_src_idx)
    ring = backends_mod._write_ring(
        state.ring, mirror_bits, torch.remainder(state.t, graph.max_delay))

    new_state = EngineState(neurons=neurons, ring=ring, weights=weights,
                            traces=traces, t=state.t + 1,
                            generator=state.generator,
                            gate_overflow=gate_overflow,
                            weights_layout=state.weights_layout,
                            neuron_model=state.neuron_model,
                            model_seed=state.model_seed)
    return new_state, spike_bits


def run(state: EngineState, graph: ShardGraph, table: torch.Tensor,
        cfg: EngineConfig, n_steps: int, *,
        drive: torch.Tensor | None = None,
        model_uniform: torch.Tensor | None = None, device="cuda"):
    """Step ``n_steps`` times on ``device`` (the card unless
    ``device="cpu"``); returns ``(final_state, spikes)``, spikes
    (n_steps, n_local) bool.

    Flat-facing: whatever layout ``state`` arrives in, the loop carries the
    backend's NATIVE weights (one conversion in) and the returned state is
    FLAT (one conversion out).  ``drive`` ((n_steps, n_local)) replaces the
    per-step Poisson draws, ``model_uniform`` ((n_steps, n_local)) a
    stochastic model's per-step uniforms.  The loop never syncs with the
    host; ``run`` synchronises the device once, at the end.
    """
    dev = resolve_device(device)
    _require_on(dev, weights=state.weights, ring=state.ring,
                pre_idx=graph.pre_idx, table=table)
    for name, x in (("drive", drive), ("model_uniform", model_uniform)):
        if x is not None and tuple(x.shape) != (n_steps, graph.n_local):
            raise ValueError(f"{name} must be ({n_steps}, {graph.n_local}), "
                             f"got {tuple(x.shape)}")
    backend = backends_mod.get_backend(cfg.sweep)
    layout = backend.prepare(graph)
    model = neuron_models_mod.get_model(cfg.neuron_model)
    native_tag = backends_mod.layout_tag(layout, backend.weights_layout)
    if state.gate_overflow is None:
        state = dataclasses.replace(
            state, gate_overflow=torch.zeros((), dtype=torch.int32,
                                             device=dev))
    w = backends_mod.convert_weights(layout, state.weights,
                                     state.weights_layout, native_tag)
    if (w is state.weights and cfg.stdp is not None
            and backend.stdp_in_place(layout)):
        w = w.clone()   # the caller's weights stay as they were
    state = dataclasses.replace(state, weights=w, weights_layout=native_tag)
    del w   # else the first step's weights stay alive through the loop

    spikes = torch.empty((n_steps, graph.n_local), dtype=torch.bool,
                         device=dev)
    for i in range(n_steps):
        state, spikes[i] = engine_step(
            state, graph, table, cfg,
            drive=None if drive is None else drive[i],
            model_uniform=None if model_uniform is None else model_uniform[i],
            backend=backend, layout=layout, model=model)
    if state.weights_layout != "flat":
        state = dataclasses.replace(
            state,
            weights=backends_mod.convert_weights(
                layout, state.weights, state.weights_layout, "flat"),
            weights_layout="flat")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, spikes
