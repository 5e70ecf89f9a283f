"""Pluggable execution backends for the sweep/update hot path (DESIGN.md §9).

The port of the reference package's ``core/backends.py``.  The three stages
of the per-dt hot path -

    sweep          edges -> per-neuron (input_ex, input_in) + per-edge arrivals
    neuron_update  fused propagate / threshold / reset / refractory
    stdp_update    pl-STDP weight update on owned edges

- sit behind one :class:`SweepBackend` interface; ``EngineConfig.sweep``
picks one by name:

* ``"cuda"`` (the default) - the hand-written Hopper kernels on the
  post-block ELL layout: K1 (:mod:`repro_torch.kernels.synaptic_gather`),
  K2 (:mod:`repro_torch.kernels.lif_step`) and K3
  (:mod:`repro_torch.kernels.stdp_update`); the mirror of the reference's
  ``PallasBackend``.  On CPU tensors each kernel wrapper runs its plain
  twin, which is how the CPU tests drive this backend.
* ``"flat"`` - plain torch on the flat owner-sorted arrays, the twin of the
  reference's ``flat``.

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

import torch

from repro_torch.core import neuron_models as neuron_models_mod
from repro_torch.core import snn
from repro_torch.core import stdp as stdp_mod
from repro_torch.core.layout import BlockedGraph
from repro_torch.kernels.stdp_update import stdp_update as stdp_update_kernel
from repro_torch.kernels.synaptic_gather import (segment_bounds,
                                                 synaptic_gather)

__all__ = ["EdgeLayout", "SweepBackend", "FlatBackend", "CudaBackend",
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
    ``scatter_reduce_`` needs) and K1's run table.
    """

    n_local: int
    n_mirror: int
    max_delay: int
    pre_idx: Any       # (E,) int32
    post_idx: Any      # (E,) int32
    delay: Any         # (E,) int32; 0 marks padding
    channel: Any       # (E,) int32
    plastic: Any       # (E,) bool
    blocked: BlockedGraph | None = None
    arrival_pre: Any = None   # (native E,) int64
    seg_bounds: Any = None    # (NB, D*PB + 1) int32, kernel backend only

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
        blocked=graph.blocked)


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

    def prepare(self, graph) -> EdgeLayout:
        """ShardGraph (on its device) -> the layout this backend consumes;
        cached per graph object."""
        hit = self._layouts.get(id(graph))
        if hit is not None and hit[0]() is graph:
            return hit[1]
        layout = self._prepare(graph)
        self._layouts = {k: v for k, v in self._layouts.items()
                         if v[0]() is not None}
        self._layouts[id(graph)] = (weakref.ref(graph), layout)
        return layout

    def _prepare(self, graph) -> EdgeLayout:
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

        Default schedule: write the fresh bits into slot ``t-1`` and run one
        full sweep."""
        ring = _write_ring(ring, fresh_bits,
                           torch.remainder(t - 1, layout.max_delay))
        ex, inh, arrived = self.sweep(layout, weights, ring, t)
        return ex, inh, arrived, ring

    # -- neuron dynamics --------------------------------------------------
    def neuron_update(self, layout: EdgeLayout, neurons, table, input_ex,
                      input_in, *,
                      synapse_model: str = snn.SynapseModel.CURRENT_EXP,
                      model=None):
        """Fused propagate/threshold/reset/refractory for one dt, through
        the NeuronModel registry (``model`` None = "lif")."""
        m = neuron_models_mod.get_model("lif" if model is None else model)
        return m.step(neurons, table, input_ex, input_in,
                      synapse_model=synapse_model)

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


class CudaBackend(SweepBackend):
    """Kernel path: K1 edge pass, K2 LIF update and K3 blocked STDP update
    on the post-block ELL layout - the mirror of the reference's
    ``PallasBackend``.

    The blocked layout is the RESIDENT hot-path representation: run-time
    weights live in ELL slot order, K1 emits the per-slot arrivals from its
    own ring gather (one edge pass per step), and K3 consumes the blocked
    arrivals and weights directly with block-relative post rows.  The
    kernels take float32 only; on CPU tensors the wrappers run their plain
    twins, which take any float dtype.
    """

    name = "cuda"
    weights_layout = "blocked"

    def _prepare(self, graph):
        lay = layout_of(graph)
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
        fresh = fresh_bits.to(ring.dtype)
        ex, inh, arrived = self._gather(layout, weights, ring, t, fresh)
        ring = _write_ring(ring, fresh,
                           torch.remainder(t - 1, layout.max_delay))
        return ex, inh, arrived, ring

    def neuron_update(self, layout, neurons, table, input_ex, input_in, *,
                      synapse_model: str = snn.SynapseModel.CURRENT_EXP,
                      model=None):
        m = neuron_models_mod.get_model("lif" if model is None else model)
        if m.kernel_step is None:
            return m.step(neurons, table, input_ex, input_in,
                          synapse_model=synapse_model)
        return m.kernel_step(neurons, table, input_ex, input_in,
                             synapse_model=synapse_model)

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


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

#: ``EngineConfig.sweep`` name -> backend (the reference's ``pallas``,
#: ``bucketed`` and ``pallas:sparse`` are not ported)
_REGISTRY: dict[str, SweepBackend] = {"cuda": CudaBackend(),
                                      "flat": FlatBackend()}


def get_backend(name) -> SweepBackend:
    if isinstance(name, SweepBackend):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown sweep backend {name!r}; available: "
                     f"{available_backends()}")


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))

