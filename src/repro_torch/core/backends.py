"""Pluggable execution backends for the sweep/update hot path (DESIGN.md §9).

The port of the reference package's ``core/backends.py``.  The three stages
of the per-dt hot path -

    sweep          edges -> per-neuron (input_ex, input_in) + per-edge arrivals
    neuron_update  fused propagate / threshold / reset / refractory
    stdp_update    pl-STDP weight update on owned edges

- sit behind one :class:`SweepBackend` interface; ``EngineConfig.sweep``
picks one by name.  The engine calls the first two, and the external
drive's add between them, as one method, :meth:`SweepBackend.sweep_update`,
so that a backend can fuse them:

* ``"cuda"`` (the default) - the hand-written Hopper kernels on the
  post-block ELL layout: K1 (:mod:`repro_torch.kernels.synaptic_gather`),
  K2 (:mod:`repro_torch.kernels.lif_step`) and K3
  (:mod:`repro_torch.kernels.stdp_update`); the mirror of the reference's
  ``PallasBackend``; the neuron update goes through the model's kernel
  (K2 for lif, K4 for izhikevich, K5 for adex).  For ``"lif"``,
  ``"izhikevich"`` and ``"adex"`` that update is K1's epilogue instead, one
  launch for the edge pass, the drive and the step
  (:meth:`CudaBackend.update_route`).  On CPU
  tensors each kernel wrapper runs its plain twin, which is how the CPU
  tests drive this backend.
* ``"cuda:sparse"`` - the activity gate (DESIGN.md §13), the mirror of the
  reference's ``pallas:sparse``: a plain-torch arrival pre-pass, then K6
  (:func:`~repro_torch.kernels.synaptic_gather.blocked_reduce_sweep`) and
  K7 (:func:`~repro_torch.kernels.stdp_update.stdp_update_worklist`) over
  a fixed-capacity worklist of active post blocks, bit-identical to
  ``"cuda"``.  ``"cuda:sparse:<rate>"`` and ``"cuda:sparse:measured:<path>"``
  pick its capacity (:class:`CudaSparseBackend`).
* ``"cuda:auto"`` - ``"cuda"`` on (PB, EB) block shapes tuned from the
  graph's degree distribution (:mod:`repro_torch.core.autotune`), the
  mirror of the reference's ``pallas:auto``; ``CudaBackend(block_shapes=)``
  and ``CudaSparseBackend(block_shapes=)`` take any spec.
* ``"flat"`` - plain torch on the flat owner-sorted arrays, the twin of the
  reference's ``flat``, and the gradient path (DESIGN.md §17).
* ``"bucketed"`` - the paper's literal low-to-high delay sweep, the
  reference's structural cross-check, in plain torch.

Backends register under their ``EngineConfig.sweep`` names with
:func:`register_backend`.

Surrogate mode (``surrogate=``, DESIGN.md §17) runs the kernel backends'
inference route and casts the spike to the membrane's float: the surrogate
forward's values are the bool spike's, so the trajectory is inference
mode's bit for bit.  The kernels have no backward: each wrapper raises
when grad mode is on and an input requires grad, so that a gradient never
silently stops at a kernel; gradients run on ``"flat"``.

Weights layout: a backend declares ``weights_layout`` - ``"flat"``
(owner-sorted (E,)) or ``"blocked"`` (ELL slot order, (NB*EB,)).  Run-time
weights live in the backend's native layout; ``edge_perm`` conversions
happen only at the build / checkpoint / telemetry boundaries.  Blocked
states carry the shape-qualified tag ``"blocked:{pb}x{eb}"``, so a vector
minted under one (PB, EB) can never be stepped under another.

Every backend reduces over post rows it exclusively owns (eq. 14): the
kernel path has no atomics at all.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.core import autotune as autotune_mod
from repro_torch.core import neuron_models as neuron_models_mod
from repro_torch.core import snn
from repro_torch.core import stdp as stdp_mod
from repro_torch.core.layout import (BlockedGraph, blocked_layout,
                                     blocked_layout_streamed)
from repro_torch.kernels.stdp_update import stdp_update as stdp_update_kernel
from repro_torch.kernels.stdp_update import stdp_update_worklist
from repro_torch.kernels.synaptic_gather import (NEURON_STATE,
                                                 blocked_reduce_sweep,
                                                 segment_bounds,
                                                 synaptic_gather,
                                                 synaptic_gather_update)

__all__ = ["EdgeLayout", "SweepBackend", "FlatBackend", "BucketedBackend",
           "CudaBackend", "CudaSparseBackend", "register_backend",
           "get_backend", "available_backends",
           "layout_of", "to_native_weights", "to_flat_weights",
           "flat_edge_values", "convert_weights", "layout_tag",
           "layout_kind", "resolve_runtime_weights"]


# --------------------------------------------------------------------------
# layout handed to backends
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeLayout:
    """Per-shard edge tensors + static geometry, as one backend-facing view.

    ``blocked`` carries the ELL layout for the kernel path.  ``arrival_pre``
    and ``seg_bounds`` are filled by :meth:`SweepBackend.prepare`: the int64
    pre index aligned with the backend's ``arrived`` (the index
    ``scatter_reduce_`` needs) and the run table of K1 and K6.  The gated
    backend also fills ``gate_index``, ``ring_offsets`` and ``block_ids``
    for its pre-pass and worklist.  ``bucket_ptr`` (numpy, the edge range
    of each delay) exists for a builder's graph only; the stacked step's
    shard views have None, and the bucketed backend masks by delay there.
    """

    n_local: int
    n_mirror: int
    max_delay: int
    pre_idx: Any       # (E,) int32
    post_idx: Any      # (E,) int32
    delay: Any         # (E,) int32; 0 marks padding
    channel: Any       # (E,) int32
    plastic: Any       # (E,) bool
    bucket_ptr: np.ndarray | None = None   # (max_delay + 2,) int64
    blocked: BlockedGraph | None = None
    arrival_pre: Any = None   # (native E,) int64
    seg_bounds: Any = None    # (NB, D*PB + 1) int32, kernel backends only
    # gated backend only: per slot, (D - delay)*M + pre into the step's
    # rolled ring (D*M on padding); -D..-1; 0..NB-1
    gate_index: Any = None    # (NB, EB) int32
    ring_offsets: Any = None  # (D,) int32
    block_ids: Any = None     # (NB,) int32

    @property
    def n_edges(self) -> int:
        return int(self.pre_idx.shape[0])


def layout_of(graph) -> EdgeLayout:
    """EdgeLayout view of a :class:`repro_torch.core.engine.ShardGraph`."""
    return EdgeLayout(
        n_local=graph.n_local, n_mirror=graph.n_mirror,
        max_delay=graph.max_delay,
        pre_idx=graph.pre_idx, post_idx=graph.post_idx, delay=graph.delay,
        channel=graph.channel, plastic=graph.plastic,
        bucket_ptr=graph.bucket_ptr, blocked=graph.blocked)


def device_blocked(bg: BlockedGraph, device) -> BlockedGraph:
    """``bg``'s run-time fields as tensors on ``device``, without its
    build-time ``weight``."""
    def t(a, dtype):
        return None if a is None else torch.as_tensor(
            a if isinstance(a, torch.Tensor) else np.asarray(a),
            dtype=dtype, device=device)

    return dataclasses.replace(
        bg, pre_idx=t(bg.pre_idx, torch.int32),
        post_rel=t(bg.post_rel, torch.int32),
        delay=t(bg.delay, torch.int32), channel=t(bg.channel, torch.int32),
        plastic=t(bg.plastic, torch.bool),
        edge_perm=t(bg.edge_perm, torch.int32), weight=None)


def _flat_arrivals(layout: EdgeLayout, ring, t):
    """``arrived[e] = ring[(t - delay[e]) mod D, pre_idx[e]]``, padding
    masked.  One gather over the flattened ring."""
    row = torch.remainder(t - layout.delay, layout.max_delay).long()
    arrived = ring.reshape(-1)[row * layout.n_mirror + layout.pre_idx.long()]
    return arrived * (layout.delay > 0)


def _accumulate(layout: EdgeLayout, weights, arrived):
    """Weighted per-edge arrivals -> (input_ex, input_in) via index_add_
    over the owner-sorted post rows."""
    contrib = weights * arrived
    zero = torch.zeros((), dtype=contrib.dtype, device=contrib.device)
    out = lambda c: torch.zeros(
        layout.n_local, dtype=contrib.dtype, device=contrib.device
    ).index_add_(0, layout.post_idx,
                 torch.where(layout.channel == c, contrib, zero))
    return out(0), out(1)


def _surrogate_cast(neurons, surrogate):
    """A kernel route's state in surrogate mode: the bool spike as the
    membrane's float, the surrogate forward's exact values.  No gradient
    can reach it - each kernel wrapper refuses inputs that require grad."""
    if surrogate is None:
        return neurons
    return dataclasses.replace(neurons,
                               spike=neurons.spike.to(neurons.v_m.dtype))


def _fresh_value(fresh):
    """``fresh`` as a tensor: a callable (the distributed step's pending
    exchange) is called here, where the backend first needs the bits."""
    return fresh() if callable(fresh) else fresh


def _write_ring(ring, bits, slot):
    """``ring`` with row ``slot`` (a one-element device tensor, already
    reduced mod D) replaced by ``bits`` - out of place, no host sync."""
    return ring.index_copy(0, slot.reshape(1).long(),
                           bits.to(ring.dtype).reshape(1, -1))


# --------------------------------------------------------------------------
# weight/arrivals layout conversion (build / checkpoint / telemetry only)
# --------------------------------------------------------------------------

def _require_blocked(layout: EdgeLayout) -> BlockedGraph:
    if layout.blocked is None:
        raise ValueError("layout carries no blocked ELL arrays; build "
                         "graphs via builder.build_shards(with_blocked="
                         "True)")
    return layout.blocked


def layout_kind(tag: str) -> str:
    """"flat" / "blocked:256x2048" / "blocked" -> the layout KIND."""
    return tag.split(":", 1)[0]


def layout_tag(layout: EdgeLayout, kind: str) -> str:
    """Canonical run-time layout tag: "flat", or ``"blocked:{pb}x{eb}"``
    for the blocked kind (a shape-qualified ``kind`` must name THIS
    layout)."""
    if kind == "flat":
        return "flat"
    if layout_kind(kind) == "blocked":
        if kind != "blocked":
            _check_blocked_tag(layout, kind)
        bg = _require_blocked(layout)
        return f"blocked:{bg.pb}x{bg.eb}"
    raise ValueError(f"unknown weights layout {kind!r}")


def _check_blocked_tag(layout: EdgeLayout, tag: str):
    """A blocked tag must name THIS layout's block shapes - converting a
    vector minted under different (PB, EB) through this layout's edge_perm
    would scramble it."""
    want = layout_tag(layout, "blocked")
    if tag not in ("blocked", want):   # bare "blocked" = trust the caller
        raise ValueError(
            f"weights carry layout {tag!r} but this graph's blocked layout "
            f"is {want!r} - different (PB, EB) block shapes; re-express "
            "through 'flat' with the ORIGINAL layout first")


def to_native_weights(layout: EdgeLayout, w_flat, target: str):
    """Flat owner-sorted weights -> ``target`` layout ("flat"|"blocked").

    Blocked padding slots receive ``w_flat[0]``; every consumer masks them
    (sweep by ``delay>0``, STDP by ``plastic``), and
    :func:`to_flat_weights` drops them on the way back.
    """
    kind = layout_kind(target)
    if kind == "flat":
        return w_flat
    if kind == "blocked":
        _check_blocked_tag(layout, target)
        bg = _require_blocked(layout)
        return w_flat.index_select(0, bg.edge_perm.reshape(-1))
    raise ValueError(f"unknown weights layout {target!r}")


def flat_edge_values(layout: EdgeLayout, vals, source: str):
    """Per-edge values in ``source`` layout -> FLAT edge order; blocked
    padding slots are dropped and flat padding edges read 0."""
    kind = layout_kind(source)
    if kind == "flat":
        return vals
    if kind == "blocked":
        _check_blocked_tag(layout, source)
        bg = _require_blocked(layout)
        e = layout.n_edges
        perm = bg.edge_perm.reshape(-1).long()
        live = bg.delay.reshape(-1) > 0
        idx = torch.where(live, perm, torch.full_like(perm, e))  # dump slot
        out = torch.zeros((e + 1,), dtype=vals.dtype, device=vals.device)
        return out.scatter_(0, idx, vals)[:e]
    raise ValueError(f"unknown weights layout {source!r}")


def to_flat_weights(layout: EdgeLayout, w, source: str):
    """Inverse of :func:`to_native_weights` (flat padding slots read 0)."""
    return flat_edge_values(layout, w, source)


def convert_weights(layout: EdgeLayout, w, src: str, dst: str):
    if layout_kind(src) == layout_kind(dst):
        if layout_kind(src) == "blocked":   # same kind: shapes must match
            _check_blocked_tag(layout, src)
            _check_blocked_tag(layout, dst)
        return w
    return to_native_weights(layout, to_flat_weights(layout, w, src), dst)


def resolve_runtime_weights(backend: "SweepBackend", layout: EdgeLayout,
                            weights, state_tag: str):
    """Per-step weight residency: ``(w_native, native_tag, convert_back)``.

    ``convert_back=True`` iff the caller must re-express the updated
    weights as ``state_tag`` (the flat-state compatibility path, one edge
    gather per direction per step; carry native state to avoid it).
    """
    native_tag = layout_tag(layout, backend.weights_layout)
    if state_tag == native_tag or (state_tag == "blocked"
                                   and layout_kind(native_tag) == "blocked"):
        ne = backend.native_edge_count(layout)
        if weights.shape[0] != ne:
            raise ValueError(
                f"state weights have {weights.shape[0]} slots but the "
                f"{native_tag!r} layout expects {ne} - mismatched block "
                "shapes; re-express through 'flat' first")
        return weights, native_tag, False
    if (layout_kind(state_tag) == "blocked"
            and layout_kind(native_tag) == "blocked"):
        raise ValueError(
            f"state weights carry layout {state_tag!r} but backend "
            f"{backend.name!r} on this graph expects {native_tag!r} - "
            "different (PB, EB) block shapes; convert the state to 'flat' "
            "with the layout it was built under first")
    w_native = convert_weights(layout, weights, state_tag, native_tag)
    return w_native, native_tag, True


# --------------------------------------------------------------------------
# backend interface + implementations
# --------------------------------------------------------------------------

class SweepBackend:
    """One execution substrate for the per-dt hot path.

    Subclasses override ``sweep`` and optionally ``neuron_update`` /
    ``stdp_update`` / ``sweep_overlap``; the base class provides the plain
    torch formulations.
    """

    name: str = "?"
    #: run-time layout of the weight and ``arrived`` vectors: "flat" or
    #: "blocked" (DESIGN.md §9)
    weights_layout: str = "flat"

    def __init__(self):
        # id(graph) -> (weakref(graph), EdgeLayout): repeated prepare calls
        # on one graph (init_state, run, hand-rolled step loops) reuse the
        # derived device tensors instead of rebuilding them
        self._layouts: dict[int, tuple] = {}

    def prepare(self, graph, *, baked: bool = False) -> EdgeLayout:
        """ShardGraph (on its device) -> the layout this backend consumes;
        cached per graph object, and dropped when the graph is freed (the
        layout holds device tensors as large as the graph's).

        ``baked=True`` takes the graph's blocked twin as it was built,
        whatever block shapes the backend was given: the stacked step's
        shards share the shape baked into their net."""
        key = (id(graph), baked)
        hit = self._layouts.get(key)
        if hit is not None and hit[0]() is graph:
            return hit[1]
        layout = self._prepare(graph, baked)

        def drop(ref, cache=self._layouts):
            if cache.get(key, (None,))[0] is ref:
                del cache[key]

        self._layouts[key] = (weakref.ref(graph, drop), layout)
        return layout

    def _prepare(self, graph, baked: bool) -> EdgeLayout:
        lay = layout_of(graph)
        return dataclasses.replace(lay, arrival_pre=lay.pre_idx.long())

    # -- run-time edge-vector layout --------------------------------------
    def native_edge_count(self, layout: EdgeLayout) -> int:
        """Length of the run-time weight/arrivals vectors."""
        if self.weights_layout == "blocked":
            bg = _require_blocked(layout)
            return bg.nb * bg.eb
        return layout.n_edges

    def to_native_weights(self, layout: EdgeLayout, w_flat):
        return to_native_weights(layout, w_flat, self.weights_layout)

    # -- synaptic sweep ---------------------------------------------------
    def sweep(self, layout: EdgeLayout, weights, ring, t):
        """Accumulate (input_ex, input_in, arrived) for step ``t`` (a
        one-element int32 device tensor).  ``weights`` and the returned
        ``arrived`` are in ``weights_layout`` order."""
        raise NotImplementedError

    def sweep_overlap(self, layout: EdgeLayout, weights, ring, t,
                      fresh_bits):
        """Sweep with last step's spikes ``fresh_bits`` not yet in the ring
        (paper §III.C): returns (input_ex, input_in, arrived, ring').

        ``fresh_bits`` is an (n_mirror,) tensor, or a callable returning
        one: the distributed step passes its pending exchange, which the
        backend calls where it first needs the bits (after the delay >= 2
        pass on the flat backend, before the one launch elsewhere).

        Default schedule: write the fresh bits into slot ``t-1`` and run one
        full sweep."""
        fresh_bits = _fresh_value(fresh_bits)
        ring = _write_ring(ring, fresh_bits,
                           torch.remainder(t - 1, layout.max_delay))
        ex, inh, arrived = self.sweep(layout, weights, ring, t)
        return ex, inh, arrived, ring

    # -- gate telemetry ---------------------------------------------------
    #: True iff the sweep is activity-gated: the ``*_with_stats`` variants
    #: then report real saturation counts (DESIGN.md §13)
    gated: bool = False

    def sweep_with_stats(self, layout: EdgeLayout, weights, ring, t):
        """:meth:`sweep` plus this step's gate-saturation count: 1 when an
        activity gate overflowed its worklist and fell back to the dense
        pass, else 0 - a () int32 device tensor where a gate can saturate,
        the int 0 elsewhere (no launch).  The engine accumulates it into
        ``EngineState.gate_overflow``."""
        ex, inh, arrived = self.sweep(layout, weights, ring, t)
        return ex, inh, arrived, 0

    def sweep_overlap_with_stats(self, layout: EdgeLayout, weights, ring,
                                 t, fresh_bits):
        """:meth:`sweep_overlap` plus the gate-saturation count."""
        ex, inh, arrived, ring = self.sweep_overlap(layout, weights, ring,
                                                    t, fresh_bits)
        return ex, inh, arrived, ring, 0

    def stdp_in_place(self, layout: EdgeLayout) -> bool:
        """True iff :meth:`stdp_update` writes into the weights it is given
        (and returns that tensor) instead of returning a new one."""
        return False

    # -- neuron dynamics --------------------------------------------------
    def neuron_update(self, layout: EdgeLayout, neurons, table, input_ex,
                      input_in, *,
                      synapse_model: str = snn.SynapseModel.CURRENT_EXP,
                      model=None, seed=None, t=None, gid=None, uniform=None,
                      surrogate=None):
        """Fused propagate/threshold/reset/refractory for one dt, through
        the NeuronModel registry (``model`` None = "lif").  ``seed``,
        ``t``, ``gid`` (global ids) and ``uniform`` feed stochastic models'
        draws; deterministic models ignore them.  ``surrogate`` (a spec,
        DESIGN.md §17) makes the spike the float surrogate spike; models
        without a threshold raise."""
        m = neuron_models_mod.get_model("lif" if model is None else model)
        return m.step(neurons, table, input_ex, input_in,
                      synapse_model=synapse_model, seed=seed, t=t, gid=gid,
                      uniform=uniform, surrogate=surrogate)

    # -- sweep, drive and neuron step as one -------------------------------
    def update_route(self, model, synapse_model: str) -> str:
        """How :meth:`sweep_update` runs for ``model`` (a NeuronModel or
        its name) under ``synapse_model``: ``"composed"`` here, the three
        stages one after the other.  A fixed function of (backend, model,
        synapse model)."""
        return "composed"

    def sweep_update(self, layout: EdgeLayout, weights, ring, t, neurons,
                     table, drive, *,
                     synapse_model: str = snn.SynapseModel.CURRENT_EXP,
                     model=None, seed=None, gid=None, uniform=None,
                     fresh=None, surrogate=None):
        """One dt's sweep, external drive and neuron step: returns
        ``(new_neurons, arrived, gate_overflow, ring)``, ``arrived`` as
        :meth:`sweep` gives it and ``gate_overflow`` as
        :meth:`sweep_with_stats` does.  ``drive`` ((n_local,), or None for
        none) is added to the excitatory input.  ``fresh`` (last step's
        spikes not yet in the ring, as :meth:`sweep_overlap` takes them)
        makes the sweep :meth:`sweep_overlap`'s, and ``ring`` is then the
        ring with them written to slot ``t-1``; without it ``ring`` is the
        ring given.  ``surrogate`` goes to :meth:`neuron_update`.

        This is the composed route: :meth:`sweep_with_stats` (or
        :meth:`sweep_overlap_with_stats`), ``+ drive``,
        :meth:`neuron_update`."""
        if fresh is None:
            ex, inh, arrived, overflow = self.sweep_with_stats(
                layout, weights, ring, t)
        else:
            ex, inh, arrived, ring, overflow = self.sweep_overlap_with_stats(
                layout, weights, ring, t, fresh)
        if drive is not None:
            ex = ex + drive
        new = self.neuron_update(layout, neurons, table, ex, inh,
                                 synapse_model=synapse_model, model=model,
                                 seed=seed, t=t, gid=gid, uniform=uniform,
                                 surrogate=surrogate)
        return new, arrived, overflow, ring

    # -- plasticity -------------------------------------------------------
    def stdp_update(self, layout: EdgeLayout, weights, arrived, post_spike,
                    traces, params: stdp_mod.STDPParams):
        """pl-STDP weight update on owned edges; non-plastic edges pass
        through unchanged."""
        new_w = stdp_mod.stdp_edge_update(
            weights, layout.pre_idx, layout.post_idx, arrived, post_spike,
            traces, params)
        return torch.where(layout.plastic, new_w, weights)


class FlatBackend(SweepBackend):
    """Plain torch on the flat arrays: one gather over the ring and one
    ``index_add_`` per channel - the twin of the reference's ``flat``."""

    name = "flat"

    def sweep(self, layout, weights, ring, t):
        arrived = _flat_arrivals(layout, ring, t)
        ex, inh = _accumulate(layout, weights, arrived)
        return ex, inh, arrived

    def sweep_overlap(self, layout, weights, ring, t, fresh_bits):
        # the reference's split schedule: delays >= 2 read only OLD ring
        # slots, so their gather and sums run before the fresh bits are
        # asked for (a pending exchange is waited on only then); the
        # delay-1 part consumes them
        dtype = ring.dtype
        mask_old = (layout.delay >= 2).to(dtype)
        arrived_old = _flat_arrivals(layout, ring, t) * mask_old
        ex_o, in_o = _accumulate(layout, weights, arrived_old)
        fresh_bits = _fresh_value(fresh_bits).to(dtype)
        mask_new = (layout.delay == 1).to(dtype)
        arrived_new = fresh_bits[layout.pre_idx.long()] * mask_new
        ex_n, in_n = _accumulate(layout, weights, arrived_new)
        ring = _write_ring(ring, fresh_bits,
                           torch.remainder(t - 1, layout.max_delay))
        return (ex_o + ex_n, in_o + in_n, arrived_old + arrived_new, ring)


class BucketedBackend(SweepBackend):
    """The paper's literal low-to-high delay sweep (what a Fugaku thread
    does), the reference's structural cross-check, in plain torch: one
    ring row, gather and ``index_add_`` per delay, each delay's sums added
    to the running total.  On a builder's graph it walks the static
    ``bucket_ptr`` slices; on the stacked step's shard views (no
    ``bucket_ptr``) one masked pass over every edge per delay."""

    name = "bucketed"

    def sweep(self, layout, weights, ring, t):
        d_max = layout.max_delay
        dtype = weights.dtype
        ex = torch.zeros(layout.n_local, dtype=dtype, device=weights.device)
        inh = torch.zeros_like(ex)
        row = lambda d: ring.index_select(
            0, torch.remainder(t - d, d_max).reshape(1).long())[0]
        if layout.bucket_ptr is not None:
            arrived = torch.zeros(layout.delay.shape, dtype=dtype,
                                  device=weights.device)
            bp = np.asarray(layout.bucket_ptr)
            for d in range(1, d_max + 1):
                lo, hi = int(bp[d]), int(bp[d + 1])
                if lo == hi:
                    continue
                a = row(d)[layout.pre_idx[lo:hi].long()].to(dtype)
                bucket = dataclasses.replace(
                    layout, post_idx=layout.post_idx[lo:hi],
                    channel=layout.channel[lo:hi])
                ex_d, in_d = _accumulate(bucket, weights[lo:hi], a)
                ex, inh = ex + ex_d, inh + in_d
                arrived[lo:hi] = a
            return ex, inh, arrived
        arrived = torch.zeros(layout.delay.shape, dtype=ring.dtype,
                              device=ring.device)
        for d in range(1, d_max + 1):
            a = (row(d)[layout.pre_idx.long()]
                 * (layout.delay == d).to(ring.dtype))
            ex_d, in_d = _accumulate(layout, weights, a)
            ex, inh = ex + ex_d, inh + in_d
            arrived = arrived + a
        return ex, inh, arrived


class CudaBackend(SweepBackend):
    """Kernel path: K1 edge pass, the neuron model's kernel (K2 LIF, K4
    Izhikevich, K5 AdEx) and K3 blocked STDP update on the post-block ELL
    layout - the mirror of the reference's ``PallasBackend``.  For LIF,
    Izhikevich and AdEx the neuron step is K1's epilogue
    (:meth:`update_route`), so a step launches K1 and K3 only.

    The blocked layout is the RESIDENT hot-path representation: run-time
    weights live in ELL slot order, K1 emits the per-slot arrivals from its
    own ring gather (one edge pass per step), and K3 consumes the blocked
    arrivals and weights directly with block-relative post rows.  The
    kernels take float32 only; on CPU tensors the wrappers run their plain
    twins, which take any float dtype.

    ``block_shapes``: None steps the graph's own blocked twin (the
    builder's shapes); ``"auto"``, ``"measured:<path>"``, a
    :class:`~repro_torch.core.autotune.BlockShapes` or a ``(pb, eb)`` pair
    resolves (PB, EB) against the graph (:func:`~repro_torch.core.autotune.
    resolve_block_shapes`), and :meth:`prepare` lays the graph out again at
    those shapes when its twin does not satisfy them: once per graph, on
    the host, the result moved to the graph's device.
    """

    name = "cuda"
    weights_layout = "blocked"

    def __init__(self, block_shapes=None):
        super().__init__()
        self.block_shapes = block_shapes

    def _blocked(self, graph, baked: bool):
        """The blocked twin this backend steps ``graph`` with."""
        bg = graph.blocked
        if self.block_shapes is None or baked:
            return bg
        # the graph is on its device and the layout code is numpy: the flat
        # edge arrays go to the host once, the relayout comes back
        host = dataclasses.replace(graph, **{
            k: getattr(graph, k).cpu().numpy()
            for k in ("pre_idx", "post_idx", "delay", "channel", "plastic",
                      "weight_init")})
        shapes = autotune_mod.resolve_block_shapes(host, self.block_shapes)
        if bg is not None and bg.pb == shapes.pb and bg.eb >= shapes.eb:
            return bg   # a wider (stacking) EB satisfies the shapes too
        fill = (blocked_layout if graph.bucket_ptr is None
                else blocked_layout_streamed)
        return device_blocked(fill(host, pb=shapes.pb, eb_min=shapes.eb),
                              graph.pre_idx.device)

    def _prepare(self, graph, baked: bool):
        lay = dataclasses.replace(layout_of(graph),
                                  blocked=self._blocked(graph, baked))
        bg = _require_blocked(lay)
        return dataclasses.replace(
            lay, arrival_pre=bg.pre_idx.reshape(-1).long(),
            seg_bounds=segment_bounds(bg.post_rel, bg.delay, pb=bg.pb,
                                      max_delay=lay.max_delay))

    def _gather(self, layout, weights, ring, t, fresh):
        bg = _require_blocked(layout)
        i_ex, i_in, arrived = synaptic_gather(
            bg.pre_idx, bg.post_rel, weights.reshape(bg.nb, bg.eb),
            bg.delay, bg.channel, ring, t, max_delay=layout.max_delay,
            pb=bg.pb, fresh=fresh, bounds=layout.seg_bounds)
        return (i_ex[:layout.n_local], i_in[:layout.n_local],
                arrived.reshape(-1))

    def sweep(self, layout, weights, ring, t):
        return self._gather(layout, weights, ring, t, None)

    def sweep_overlap(self, layout, weights, ring, t, fresh_bits):
        # one K1 launch serves the §III.C split: delay>=2 arrivals come
        # from the OLD ring, delay==1 from ``fresh_bits``, so the slot-(t-1)
        # ring write is independent of the sweep
        fresh = _fresh_value(fresh_bits).to(ring.dtype)
        ex, inh, arrived = self._gather(layout, weights, ring, t, fresh)
        ring = _write_ring(ring, fresh,
                           torch.remainder(t - 1, layout.max_delay))
        return ex, inh, arrived, ring

    def neuron_update(self, layout, neurons, table, input_ex, input_in, *,
                      synapse_model: str = snn.SynapseModel.CURRENT_EXP,
                      model=None, seed=None, t=None, gid=None, uniform=None,
                      surrogate=None):
        # the kernel when the model has one (lif K2, izhikevich K4, adex
        # K5, and their +poisson composites); poisson runs its plain draw
        m = neuron_models_mod.get_model("lif" if model is None else model)
        m.spike_fn(surrogate)   # raises on models without a threshold
        step = m.step if m.kernel_step is None else m.kernel_step
        return _surrogate_cast(
            step(neurons, table, input_ex, input_in,
                 synapse_model=synapse_model, seed=seed, t=t, gid=gid,
                 uniform=uniform), surrogate)

    def update_route(self, model, synapse_model: str) -> str:
        """``"fused:lif"`` for the LIF model (current or conductance),
        ``"fused:izhikevich"`` and ``"fused:adex"`` for Izhikevich and AdEx
        (current): K1 takes the neuron step as its epilogue.
        ``"composed"`` for every other model - the ``+poisson`` composites,
        ``poisson`` - and synapse model (a two-variable model's own step
        then rejects the conductance form).  The same in surrogate mode,
        whose spike is the route's cast to float."""
        name = neuron_models_mod.get_model(
            "lif" if model is None else model).name
        if name == "lif" and synapse_model in (snn.SynapseModel.CURRENT_EXP,
                                               snn.SynapseModel.COND_EXP):
            return "fused:lif"
        if (name in ("izhikevich", "adex")
                and synapse_model == snn.SynapseModel.CURRENT_EXP):
            return f"fused:{name}"
        return "composed"

    def sweep_update(self, layout, weights, ring, t, neurons, table, drive,
                     *, synapse_model: str = snn.SynapseModel.CURRENT_EXP,
                     model=None, seed=None, gid=None, uniform=None,
                     fresh=None, surrogate=None):
        route = self.update_route(model, synapse_model)
        if route == "composed":
            return super().sweep_update(
                layout, weights, ring, t, neurons, table, drive,
                synapse_model=synapse_model, model=model, seed=seed, gid=gid,
                uniform=uniform, fresh=fresh, surrogate=surrogate)
        # one launch: K1's edge pass (delay-1 arrivals from ``fresh`` when
        # given, which a pending exchange is waited on for first), + drive,
        # and the model's step; the state goes in and comes out in
        # NEURON_STATE's order, the common fields by their NeuronState
        # names and the model's own in extra
        neuron = route.split(":", 1)[1]
        if fresh is not None:
            fresh = _fresh_value(fresh).to(ring.dtype)
        bg = _require_blocked(layout)
        names = NEURON_STATE[neuron][0]
        fields = {"v": neurons.v_m, "syn_ex": neurons.syn_ex,
                  "syn_in": neurons.syn_in, "ref_count": neurons.ref_count,
                  **neurons.extra}
        arrived, out = synaptic_gather_update(
            bg.pre_idx, bg.post_rel, weights.reshape(bg.nb, bg.eb), bg.delay,
            bg.channel, ring, t, tuple(fields[k] for k in names),
            neurons.group_id, table, neuron=neuron,
            max_delay=layout.max_delay, pb=bg.pb,
            cond=synapse_model == snn.SynapseModel.COND_EXP, drive=drive,
            fresh=fresh, bounds=layout.seg_bounds)
        got = dict(zip(names, out[:-1]))
        extra = {k: got.pop(k, x) for k, x in neurons.extra.items()}
        new = snn.NeuronState(v_m=got.pop("v"), **got, spike=out[-1],
                              group_id=neurons.group_id, extra=extra)
        neuron_models_mod.get_model(neuron).spike_fn(surrogate)
        new = _surrogate_cast(new, surrogate)
        if fresh is not None:
            ring = _write_ring(ring, fresh,
                               torch.remainder(t - 1, layout.max_delay))
        return new, arrived.reshape(-1), 0, ring

    def stdp_update(self, layout, weights, arrived, post_spike, traces,
                    params: stdp_mod.STDPParams):
        bg = _require_blocked(layout)
        return stdp_update_kernel(
            weights, bg.pre_idx.reshape(-1), bg.post_rel.reshape(-1),
            bg.plastic.reshape(-1), arrived,
            post_spike.to(weights.dtype), traces.k_pre, traces.k_post,
            params=(params.lam, params.alpha, params.mu, params.w0,
                    params.w_min, params.w_max),
            eb=bg.eb, pb=bg.pb)


class CudaSparseBackend(CudaBackend):
    """Activity-gated sweep: the step's edge work scales with activity, not
    topology (DESIGN.md §13) - the mirror of the reference's
    ``SparsePallasBackend``.

    * A plain-torch pre-pass gathers every slot's arrival exactly as K1
      does in-kernel (same ring row, same
      ``delay == 1`` fresh overlay, 0 on padding) into one (NB, EB)
      array, in one gather (:meth:`_blocked_arrivals`); a post block is
      active when one of its slots has an arrival.
    * The active blocks are compacted into a fixed-capacity worklist
      without a host sync: a ``cumsum`` gives each active block its
      position and one scatter writes it into a (cap,) buffer prefilled
      with the sentinel NB.  Capacity comes from
      :func:`repro_torch.core.autotune.gate_capacity`.
    * K6 sums the listed blocks' rows in K1's order (bitwise K1's sums);
      dead blocks' rows stay +0.0.  K7 updates the listed blocks' weights
      IN PLACE, a block being active for plasticity when it has an arrival
      OR a post spike; the other blocks keep their weights, bit-identical
      to K3 while plastic weights sit inside [w_min, w_max] (the dense
      update's only effect on such a block is the clip).
    * Saturation (more active blocks than capacity) is decided on the
      device: K6 and K7 read ``n_active`` and walk every block instead -
      never a dropped spike - and :meth:`sweep_with_stats` reports 1.
    * ``capacity >= NB`` is decided on the host, once: the gate is then the
      dense pass with no branch - K6 over every block and K3 out of place.

    Launches per step: K6 once; K7 once when ``capacity < NB``, else K3
    once; K1 never.  The step reads no device value on the host.

    The neuron step stays a kernel of its own (K2, K4 or K5) after K6: K6
    leaves the rows of unlisted blocks at 0 without visiting them, and
    their neurons still need their step, so this backend takes the
    composed route of :class:`SweepBackend` for every model.
    """

    name = "cuda:sparse"
    gated = True
    update_route = SweepBackend.update_route
    sweep_update = SweepBackend.sweep_update

    def __init__(self, gate_rate=autotune_mod.DEFAULT_GATE_RATE,
                 min_capacity: int = autotune_mod.DEFAULT_GATE_MIN_CAPACITY,
                 block_shapes=None):
        super().__init__(block_shapes=block_shapes)
        if isinstance(gate_rate, str):
            # "measured:<path>": capacity from the BENCH file's gate_tune/
            # records for this layout's degree signature
            if not gate_rate.startswith("measured:"):
                raise ValueError(
                    f"gate rate must be a float in (0, 1] or "
                    f"'measured:<path>', got {gate_rate!r}")
            self.gate_rate = gate_rate
            self.name = f"cuda:sparse:{gate_rate}"
        else:
            if not 0.0 < gate_rate <= 1.0:
                raise ValueError(
                    f"gate rate must be in (0, 1], got {gate_rate!r}")
            self.gate_rate = float(gate_rate)
            if self.gate_rate != autotune_mod.DEFAULT_GATE_RATE:
                self.name = f"cuda:sparse:{self.gate_rate:g}"
        self.min_capacity = int(min_capacity)
        # id(layout) -> (weakref(layout), capacity)
        self._caps: dict[int, tuple] = {}

    def _prepare(self, graph, baked: bool):
        lay = super()._prepare(graph, baked)
        bg = lay.blocked
        d, m, dev = lay.max_delay, lay.n_mirror, bg.delay.device
        return dataclasses.replace(
            lay,
            gate_index=torch.where(bg.delay > 0,
                                   (d - bg.delay) * m + bg.pre_idx, d * m),
            ring_offsets=torch.arange(-d, 0, dtype=torch.int32, device=dev),
            block_ids=torch.arange(bg.nb, dtype=torch.int32, device=dev))

    # -- gate policy ------------------------------------------------------
    def gate_capacity(self, layout: EdgeLayout) -> int:
        """Static worklist capacity (in post blocks) for this layout;
        computed once per layout."""
        hit = self._caps.get(id(layout))
        if hit is not None and hit[0]() is layout:
            return hit[1]
        bg = _require_blocked(layout)
        sig = None
        if isinstance(self.gate_rate, str):
            # keyed by the LAYOUT's degree arrays, as the gate_tune records
            sig = autotune_mod.degree_signature(
                autotune_mod.degrees_from_graphs([layout]))
        cap = autotune_mod.gate_capacity(
            bg.nb, layout.n_edges, self.gate_rate,
            min_capacity=self.min_capacity, signature=sig)
        self._caps = {k: v for k, v in self._caps.items()
                      if v[0]() is not None}
        self._caps[id(layout)] = (weakref.ref(layout), cap)
        return cap

    def stdp_in_place(self, layout: EdgeLayout) -> bool:
        return self.gate_capacity(layout) < _require_blocked(layout).nb

    def _blocked_arrivals(self, layout: EdgeLayout, ring, t, fresh):
        """(NB, EB) per-slot arrivals - the pre-pass, equal to K1's
        in-kernel gather: ``ring[(t - delay) mod D, pre]``, ``fresh[pre]``
        where ``delay == 1`` and ``fresh`` is given, 0 on padding.

        One gather over the slots: the ring is first rolled so that row
        ``D - d`` holds ``ring[(t - d) mod D]`` (row D-1 is ``fresh`` when
        given) and row D is zeros, which turns each slot's index into a
        constant of the layout (``gate_index``, int32)."""
        bg = _require_blocked(layout)
        d, m = ring.shape
        rows = torch.remainder(t + layout.ring_offsets, d)
        rolled = ring.index_select(0, rows)
        tail = ring.new_zeros(m)
        if fresh is not None:
            rolled = rolled[:d - 1]
            tail = torch.cat([fresh.to(ring.dtype), tail])
        flat = torch.cat([rolled.reshape(-1), tail])
        return flat.index_select(0, layout.gate_index.reshape(-1)).reshape(
            bg.nb, bg.eb)

    def _worklist(self, layout: EdgeLayout, active, cap: int):
        """(NB,) bool active blocks -> ``(worklist (cap,) int32, n_active
        () int32)``: the active block ids ascending, then the sentinel NB.
        A fixed-size compaction, no host sync."""
        bg = _require_blocked(layout)
        n_active = active.sum(dtype=torch.int32)
        # each active block's 1-based position; buffer slot 0 takes the
        # inactive blocks and slot cap + 1 the active ones past capacity
        pos = (torch.cumsum(active, 0) * active).clamp_(max=cap + 1)
        wl = torch.full((cap + 2,), bg.nb, dtype=torch.int32,
                        device=active.device).scatter_(0, pos,
                                                       layout.block_ids)
        return wl[1:cap + 1], n_active

    def gate_stats(self, layout: EdgeLayout, ring, t, fresh=None):
        """(per-block arrival counts (NB,) int32, n_active () int32,
        capacity) - the observable the gate dispatches on."""
        arrived = self._blocked_arrivals(layout, ring, t, fresh)
        counts = (arrived > 0).sum(dim=1, dtype=torch.int32)
        n_active = (counts > 0).sum(dtype=torch.int32)
        return counts, n_active, self.gate_capacity(layout)

    # -- gated edge pass --------------------------------------------------
    def _gated_sweep(self, layout, weights, ring, t, fresh):
        bg = _require_blocked(layout)
        arrived = self._blocked_arrivals(layout, ring, t, fresh)
        cap = self.gate_capacity(layout)
        kw = dict(max_delay=layout.max_delay, pb=bg.pb,
                  bounds=layout.seg_bounds)
        if cap >= bg.nb:    # full-capacity gate == dense pass, no branch
            wl = n_active = None
            overflow = 0    # cannot saturate: no launch
        else:
            wl, n_active = self._worklist(layout, (arrived > 0).any(dim=1),
                                          cap)
            overflow = (n_active > cap).to(torch.int32)
        ex, inh = blocked_reduce_sweep(
            bg.post_rel, bg.delay, weights.reshape(bg.nb, bg.eb), arrived,
            bg.channel, worklist=wl, n_active=n_active, **kw)
        return (ex[:layout.n_local], inh[:layout.n_local],
                arrived.reshape(-1), overflow)

    def sweep(self, layout, weights, ring, t):
        return self._gated_sweep(layout, weights, ring, t, None)[:3]

    def sweep_with_stats(self, layout, weights, ring, t):
        return self._gated_sweep(layout, weights, ring, t, None)

    def sweep_overlap(self, layout, weights, ring, t, fresh_bits):
        return self.sweep_overlap_with_stats(layout, weights, ring, t,
                                             fresh_bits)[:4]

    def sweep_overlap_with_stats(self, layout, weights, ring, t,
                                 fresh_bits):
        # the §III.C split of the dense backend: the pre-pass folds
        # ``fresh_bits`` into the delay-1 arrivals, so the slot-(t-1) ring
        # write is independent of the sweep
        fresh = _fresh_value(fresh_bits).to(ring.dtype)
        ex, inh, arrived, overflow = self._gated_sweep(layout, weights, ring,
                                                       t, fresh)
        ring = _write_ring(ring, fresh,
                           torch.remainder(t - 1, layout.max_delay))
        return ex, inh, arrived, ring, overflow

    # -- gated plasticity -------------------------------------------------
    def stdp_update(self, layout, weights, arrived, post_spike, traces,
                    params: stdp_mod.STDPParams):
        """K3 out of place when ``capacity >= NB``; else K7 IN PLACE on
        ``weights`` (returned) over the blocks with an arrival or a post
        spike, or every block when they outnumber the capacity."""
        bg = _require_blocked(layout)
        cap = self.gate_capacity(layout)
        if cap >= bg.nb:    # full-capacity gate: the dense update
            return super().stdp_update(layout, weights, arrived, post_spike,
                                       traces, params)
        sp = post_spike.to(weights.dtype)
        sp_blk = torch.nn.functional.pad(
            sp > 0, (0, bg.nb * bg.pb - layout.n_local)).reshape(bg.nb,
                                                                 bg.pb)
        active = ((arrived.reshape(bg.nb, bg.eb) > 0).any(dim=1)
                  | sp_blk.any(dim=1))
        wl, n_active = self._worklist(layout, active, cap)
        return stdp_update_worklist(
            weights, bg.pre_idx.reshape(-1), bg.post_rel.reshape(-1),
            bg.plastic.reshape(-1), arrived, wl, n_active, sp,
            traces.k_pre, traces.k_post,
            params=(params.lam, params.alpha, params.mu, params.w0,
                    params.w_min, params.w_max),
            eb=bg.eb, pb=bg.pb)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

#: ``EngineConfig.sweep`` name -> backend (the reference's ``pallas``
#: names are ``cuda`` here)
_REGISTRY: dict[str, SweepBackend] = {}

#: parameterized variants ("cuda:auto", "cuda:sparse:<rate>",
#: "cuda:sparse:measured:<path>") resolve into THIS side cache, never the
#: registry, so ``available_backends()`` stays the same however many
#: variants a run touches
_VARIANT_CACHE: dict[str, SweepBackend] = {}


def register_backend(name: str, backend: SweepBackend,
                     *, overwrite: bool = False) -> None:
    """Register an execution backend under ``EngineConfig.sweep`` name
    ``name``; a registered name raises unless ``overwrite``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _REGISTRY[name] = backend


def _resolve_variant(name: str) -> SweepBackend | None:
    if name == "cuda:auto":
        hit = _VARIANT_CACHE.get(name)
        if hit is None:
            hit = _VARIANT_CACHE[name] = CudaBackend(block_shapes="auto")
        return hit
    prefix = "cuda:sparse:"
    if not name.startswith(prefix):
        return None
    text = name[len(prefix):]
    if text.startswith("measured:"):
        hit = _VARIANT_CACHE.get(name)
        if hit is None:
            hit = _VARIANT_CACHE[name] = CudaSparseBackend(gate_rate=text)
        return hit
    try:
        rate = float(text)
    except ValueError:
        raise ValueError(f"bad gate rate in backend name {name!r}: {text!r} "
                         "is not a float") from None
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"gate rate in backend name {name!r} must be in "
                         f"(0, 1], got {rate!r}")
    # canonical key: "cuda:sparse:0.01" and "cuda:sparse:0.010" share one
    # backend (and its layout caches)
    canon = f"{prefix}{rate:g}"
    hit = _VARIANT_CACHE.get(canon)
    if hit is None:
        hit = _VARIANT_CACHE[canon] = CudaSparseBackend(gate_rate=rate)
    return hit


def get_backend(name) -> SweepBackend:
    if isinstance(name, SweepBackend):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    hit = _resolve_variant(name)
    if hit is not None:
        return hit
    raise ValueError(f"unknown sweep backend {name!r}; available: "
                     f"{available_backends()}")


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend("flat", FlatBackend())
register_backend("bucketed", BucketedBackend())
register_backend("cuda", CudaBackend())
register_backend("cuda:sparse", CudaSparseBackend())

