"""Distributed SNN engine: indegree sub-graphs stacked on one card, or one
per process, exchanging spikes in two tiers (paper §III).

The port of the reference package's ``core/distributed.py``.  The reference
maps the paper's two-level decomposition onto a (rows, row_width) device
mesh under ``shard_map``: each row is an Area-Processes group, each row is
multisection-divided into ``row_width`` cells, and each device owns one
indegree sub-graph.  Its mirror table splits into

* **intra-row** mirrors (the paper's local sub-graph ``inS^l``), served by
  a dense spike bitmap gathered along the row only; and
* **remote** mirrors (``inS^r``), served by gathering only the *boundary*
  neurons (those with consumers in other rows) across all shards - the
  fixed-width analogue of CORTEX's Spikes Broadcast of IDs, so traffic
  collapses from S*n_local to M*n_local + S*B under area mapping
  (``comm_mode="area"``; ``"global"`` gathers every shard's bits).

The build half (:func:`mesh_decompose`, :func:`prepare_stacked`, the
traffic model) is numpy and bit-identical to the reference's.  The step
half runs the same per-shard hot path as the single-shard engine, through
the backend registry of :mod:`repro_torch.core.backends` (the ``"cuda"``
kernels with the neuron step as K1's epilogue, ``"cuda:sparse"`` or
``"flat"``); only the exchange and its schedule are distributed-specific.
The exchange is written against an exchange object with four
implementations, each built on the index tables of the shards it steps
(:class:`ExchangeTables`, from a net or a raw step's consts):

* :class:`StackedExchange` - every shard in one process on one device.  A
  tier's all-gather is the stacked payload itself (the intra tier's viewed
  by row), so one encode, one decode and one mirror gather serve all S
  shards: the exchange costs a handful of launches whatever S is.
* :class:`HostExchange` - whole rows per ``torch.distributed`` process
  (the multi-host path, :mod:`repro_torch.core.multihost`): the intra tier
  stays in the process as in the stacked exchange, and the remote tier is
  the one collective, an all-gather over the world group;
* :class:`ProcessGroupExchange` - one shard per ``torch.distributed`` rank:
  the remote tier over the world group, the intra tier over a row
  subgroup, both issued with ``async_op=True`` (remote first) and waited
  on only where the bits are consumed;
* :class:`StandInExchange` - one shard of a grid stepped alone (the dry
  run): each gather is made up from the local payload and its delivered
  bytes are counted.

Overlap (paper §III.C): spikes fired at step t-1 are exchanged at the start
of step t, and the sweep takes them as ``fresh`` (delay-1 arrivals), so the
ring slot t-1 is written after the sweep instead of before it.  The
exchange's result reaches the backend as a callable: the ``"flat"`` backend
runs its delay >= 2 pass first and only then waits on the exchange; the
``"cuda"`` backend's one K1 launch reads delay 1 from ``fresh`` and so
waits first, as the reference's Pallas backend does in one dispatch.  A
real overlap on the card needs K1 split by delay.

Differences from the reference, by design:

* the external Poisson drive is drawn per shard from the shard's own
  ``torch.Generator`` (seeded from the seed and the GLOBAL shard index), so,
  as in the reference, it is not decomposition-invariant; parity runs turn
  it off or inject per-shard slices of one drive array (:func:`run`'s
  ``drive``).  A stochastic model's per-neuron draws hash the global id
  (``neuron_models.gid_uniform``) and are decomposition-invariant;
* the external drive is Poisson only: the reference's step draws
  ``jax.random.poisson`` whatever ``external_drive_mode`` says, so the
  diffusion drive is refused here rather than silently replaced.

The raw step (:func:`make_raw_distributed_step`) is the same step as
``fn(state, consts)``: the per-shard graph and exchange tables come in as a
dict of tensors (:func:`stacked_consts` makes one from a net) instead of a
:class:`StackedNetwork`, in int32 or compact dtypes.  With
:class:`StandInExchange` it steps one shard of a grid alone, on any device
including ``meta``, which is how :mod:`repro_torch.launch.dryrun_snn` costs
a production-scale step without building its graph.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import backends as backends_mod
from repro_torch.core import neuron_models as neuron_models_mod
from repro_torch.core import snn
from repro_torch.core import stdp as stdp_mod
from repro_torch.core import wire as wire_mod
from repro_torch.core.builder import NetworkSpec, build_shards
from repro_torch.core.decomposition import (Decomposition, apportion_devices,
                                            multisection_divide)
from repro_torch.core.device import resolve_device
from repro_torch.core import autotune as autotune_mod
from repro_torch.core import builder as builder_mod
from repro_torch.core.engine import EngineConfig, ShardGraph, _poisson_drive
from repro_torch.core.layout import DEFAULT_PB, BlockedGraph

__all__ = ["mesh_decompose", "StackedNetwork", "prepare_stacked",
           "procedural_stack_plan", "resolve_stack_pads",
           "procedural_shard_graphs",
           "DistributedConfig", "DistState", "init_stacked_state",
           "shard_generators", "advance_generators", "StackedExchange", "HostExchange",
           "ProcessGroupExchange",
           "StandInExchange", "ExchangeTables",
           "DistributedStep", "check_net_backend", "make_distributed_step",
           "stacked_consts", "RawDistributedStep",
           "make_raw_distributed_step", "run",
           "global_spikes",
           "wire_bytes_per_step", "wire_bytes_for_dims", "wire_bytes_split"]


# --------------------------------------------------------------------------
# mesh-aligned decomposition
# --------------------------------------------------------------------------

def mesh_decompose(spec: NetworkSpec, n_rows: int, row_width: int, *,
                   method: str = "area") -> Decomposition:
    """Two-level decomposition aligned to a (rows, row_width) shard grid.

    Level 1: pack areas onto rows proportionally to estimated edge memory
    (greedy largest-first into emptiest row - Area-Processes Mapping).
    Level 2: multisection-divide each row's neurons into ``row_width`` cells.

    ``method='random'`` is the Random Equivalent Mapping baseline on the same
    grid (areas ignored), for the Fig. 9-vs-10 comparison.
    """
    rng = np.random.default_rng(spec.seed)
    n_devices = n_rows * row_width
    off = spec.pop_offsets()
    sizes = spec.area_sizes()
    n_areas = len(spec.areas)

    # per-area edge-memory weights
    edge_w = np.zeros(n_areas)
    for pr in spec.projections:
        dst = spec.populations[pr.dst_pop]
        edge_w[dst.area] += pr.indegree * dst.n
    edge_w = np.maximum(edge_w, 1.0)

    area_starts = np.zeros(n_areas + 1, dtype=np.int64)
    for i, p in enumerate(spec.populations):
        area_starts[p.area + 1] = off[i + 1]
    for a in range(1, n_areas + 1):  # forward-fill empty areas
        area_starts[a] = max(area_starts[a], area_starts[a - 1])

    if method == "random":
        # equal random split across rows (Random Equivalent Mapping)
        perm = rng.permutation(spec.n_neurons)
        row_of_neuron = np.empty(spec.n_neurons, dtype=np.int64)
        for r, s in enumerate(np.array_split(perm, n_rows)):
            row_of_neuron[s] = r
    else:
        if n_areas >= n_rows:
            # pack areas into rows: largest weight first, into lightest row
            row_load = np.zeros(n_rows)
            area_row = np.zeros(n_areas, dtype=np.int64)
            for a in np.argsort(-edge_w, kind="stable"):
                r = int(np.argmin(row_load))
                area_row[a] = r
                row_load[r] += edge_w[a]
            row_of_neuron = np.empty(spec.n_neurons, dtype=np.int64)
            for a in range(n_areas):
                row_of_neuron[area_starts[a]:area_starts[a + 1]] = area_row[a]
        else:
            # more rows than areas: apportion rows to areas, then split each
            # area across its rows by multisection on positions
            counts = apportion_devices(edge_w, n_rows)
            row_of_neuron = np.empty(spec.n_neurons, dtype=np.int64)
            row0 = 0
            for a in range(n_areas):
                ga = np.arange(area_starts[a], area_starts[a + 1])
                pos = spec.areas[a].positions
                if pos is None:
                    pos = rng.uniform(size=(ga.size, 3))
                part = multisection_divide(pos, int(counts[a]), rng=rng)
                row_of_neuron[ga] = row0 + part
                row0 += int(counts[a])

    # level 2: multisection within each row
    owner = np.full(spec.n_neurons, -1, dtype=np.int32)
    parts: list[np.ndarray] = []
    all_pos = np.concatenate([
        (a.positions if a.positions is not None
         else rng.uniform(size=(sizes[i], 3)))
        for i, a in enumerate(spec.areas)], axis=0)
    for r in range(n_rows):
        gids = np.nonzero(row_of_neuron == r)[0].astype(np.int64)
        if gids.size < row_width:
            raise ValueError(f"row {r} has {gids.size} < {row_width} neurons")
        cell = multisection_divide(all_pos[gids], row_width, rng=rng)
        for m in range(row_width):
            d = r * row_width + m
            sel = np.sort(gids[cell == m])
            parts.append(sel)
            owner[sel] = d

    dec = Decomposition(n_neurons=spec.n_neurons, parts=parts, owner=owner,
                        device_area=np.full(n_devices, -1, dtype=np.int32))
    dec.validate()
    return dec


# --------------------------------------------------------------------------
# stacked (shard-major) network arrays + exchange metadata
# --------------------------------------------------------------------------

#: the graph fields every stacked net carries, (S, E) or (S, n_local) or
#: (S, n_mirror); with blocked layouts also the ``blk_*`` (S, NB, EB) ones
_GRAPH_FIELDS = ("pre_idx", "post_idx", "delay", "channel", "plastic",
                 "weight_init", "group_id", "ext_rate", "ext_weight",
                 "global_id", "mirror_src_idx")
_BLOCKED_FIELDS = ("pre_idx", "post_rel", "delay", "channel", "plastic",
                   "edge_perm")
_META_FIELDS = ("boundary_slots", "mirror_is_intra", "mirror_row_gather",
                "mirror_remote_gather", "mirror_src_flat")


class _HeldShards:
    """The rows of a grid's shards that an object's (S, ...) arrays hold:
    shards ``lo..hi-1`` of ``n_shards`` (``local_slice``; None: all)."""

    n_shards: int
    row_width: int
    local_slice: tuple[int, int] | None

    @property
    def n_rows(self) -> int:
        return self.n_shards // self.row_width

    @property
    def shard_range(self) -> tuple[int, int]:
        """The global shards ``lo..hi-1`` whose rows the arrays hold."""
        return ((0, self.n_shards) if self.local_slice is None
                else tuple(self.local_slice))

    def rows_of(self, shards) -> list[int]:
        """The rows of the (S, ...) arrays that hold global ``shards``."""
        lo, hi = self.shard_range
        bad = [int(s) for s in shards if not lo <= s < hi]
        if bad:
            raise ValueError(f"shards {bad} are not held by this net (it "
                             f"holds shards {lo}..{hi - 1})")
        return [int(s) - lo for s in shards]


@dataclasses.dataclass(frozen=True)
class StackedNetwork(_HeldShards):
    """All shard graphs stacked on a leading shard axis, plus exchange
    metadata.  Every array field has shape (S, ...): numpy at build,
    tensors after :meth:`to`.

    With ``local_slice=(lo, hi)`` (the multi-host build,
    :func:`repro_torch.core.multihost.prepare_stacked_local`) the arrays
    hold the rows of shards ``lo..hi-1`` only; ``n_shards`` stays the
    global count, and :meth:`rows_of` maps global shards to rows."""

    n_shards: int
    row_width: int
    n_local: int
    n_mirror: int
    n_edges: int
    b_pad: int                 # boundary slots per shard
    max_delay: int
    graph: dict[str, Any]      # stacked ShardGraph arrays (+ blk_*)
    boundary_slots: Any        # (S, B) int32 local idx published per slot
    mirror_is_intra: Any       # (S, n_mirror) bool
    mirror_row_gather: Any     # (S, n_mirror) int32 -> row-gathered flat idx
    mirror_remote_gather: Any  # (S, n_mirror) int32 -> remote-gathered idx
    mirror_src_flat: Any       # (S, n_mirror) int32 source shard (global)
    # (nb, eb, pb) when graph carries the stacked ELL arrays blk_*
    blocked_meta: tuple[int, int, int] | None = None
    # the ``block_shapes`` spec the net was built with (None: the fixed
    # defaults): a backend-side spec on a net built without one warns
    # (:func:`check_net_backend`)
    block_shapes_spec: Any = None
    # per-shard ShardGraph views of the stacked tensors (set by ``to``), by
    # row: the backends cache their layouts per graph object
    shard_graphs: tuple[ShardGraph, ...] | None = None
    # (lo, hi): the global shards the arrays hold; None: all of them
    local_slice: tuple[int, int] | None = None

    def select_shards(self, lo: int, hi: int) -> "StackedNetwork":
        """This net holding only the rows of global shards ``lo..hi-1``
        (host arrays: the per-shard views are dropped)."""
        r0, r1 = self.rows_of([lo])[0], self.rows_of([hi - 1])[0] + 1
        return dataclasses.replace(
            self, graph={k: v[r0:r1] for k, v in self.graph.items()},
            **{k: getattr(self, k)[r0:r1] for k in _META_FIELDS},
            local_slice=(lo, hi), shard_graphs=None)

    # per-shard per-step spike traffic: the fp32-bitmap figures are the
    # mapping-quality metric (exchanged NEURON SLOTS x 4, whatever the
    # wire); per-wire bytes go through :func:`wire_bytes_per_step`
    @property
    def comm_bytes_global(self) -> int:
        return int(wire_bytes_per_step(self, "global", "f32"))

    @property
    def comm_bytes_area(self) -> int:
        return int(wire_bytes_per_step(self, "area", "f32"))

    def to(self, device="cuda") -> "StackedNetwork":
        """The arrays as tensors on ``device`` (the card unless
        ``device="cpu"``; raises without one), with one :class:`ShardGraph`
        view per row in ``shard_graphs``."""
        dev = resolve_device(device)

        def t(a):
            a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            return a.to(dev)

        graph = {k: t(v) for k, v in self.graph.items()}
        meta = {k: t(getattr(self, k)) for k in _META_FIELDS}
        shards = _shard_views({**graph, **meta}, n_local=self.n_local,
                              n_mirror=self.n_mirror,
                              max_delay=self.max_delay,
                              blocked_meta=self.blocked_meta)
        return dataclasses.replace(self, graph=graph, **meta,
                                   shard_graphs=shards)

    def exchange_tables(self) -> "ExchangeTables":
        """The exchange's index tables of the shards the net holds."""
        return ExchangeTables(
            n_shards=self.n_shards, row_width=self.row_width,
            n_local=self.n_local, b_pad=self.b_pad,
            local_slice=self.shard_range,
            mirror_src_idx=self.graph["mirror_src_idx"],
            **{k: getattr(self, k) for k in _META_FIELDS})


def _shard_views(consts: dict, *, n_local: int, n_mirror: int,
                 max_delay: int, blocked_meta) -> tuple[ShardGraph, ...]:
    """One :class:`ShardGraph` view per row of the (S, ...) tensors of
    ``consts`` (a net's graph and exchange tables, or a raw step's
    consts); the blocked twin where ``blocked_meta`` is given and the
    ``blk_*`` tensors are there.  ``global_id`` may be absent (None)."""
    shards = []
    for s in range(consts["mirror_src_flat"].shape[0]):
        bg = None
        if blocked_meta is not None and "blk_pre_idx" in consts:
            nb, eb, pb = blocked_meta
            bg = BlockedGraph(nb=nb, eb=eb, pb=pb, n_local=nb * pb,
                              **{k: consts[f"blk_{k}"][s]
                                 for k in _BLOCKED_FIELDS})
        fields = {k: (None if consts.get(k) is None else consts[k][s])
                  for k in _GRAPH_FIELDS}
        shards.append(ShardGraph(
            n_local=n_local, n_mirror=n_mirror, max_delay=max_delay,
            bucket_ptr=None, mirror_src_shard=consts["mirror_src_flat"][s],
            blocked=bg, **fields))
    return tuple(shards)


def _alloc_stacked_graph(S: int, e_pad: int, n_local: int, n_mirror: int,
                         blocked_meta) -> dict[str, np.ndarray]:
    """Preallocate the (S, ...) stacked const arrays so shard graphs can be
    filled (and freed) one at a time."""
    graph = dict(
        pre_idx=np.zeros((S, e_pad), np.int32),
        post_idx=np.zeros((S, e_pad), np.int32),
        delay=np.zeros((S, e_pad), np.int32),
        channel=np.zeros((S, e_pad), np.int32),
        plastic=np.zeros((S, e_pad), bool),
        weight_init=np.zeros((S, e_pad), np.float32),
        group_id=np.zeros((S, n_local), np.int32),
        ext_rate=np.zeros((S, n_local), np.float32),
        ext_weight=np.zeros((S, n_local), np.float32),
        global_id=np.full((S, n_local), -1, np.int32),
        mirror_src_idx=np.zeros((S, n_mirror), np.int32),
    )
    if blocked_meta is not None:
        nb, eb, _pb = blocked_meta
        graph.update(
            blk_pre_idx=np.zeros((S, nb, eb), np.int32),
            blk_post_rel=np.zeros((S, nb, eb), np.int32),
            blk_delay=np.zeros((S, nb, eb), np.int32),
            blk_channel=np.zeros((S, nb, eb), np.int32),
            blk_plastic=np.zeros((S, nb, eb), bool),
            blk_edge_perm=np.zeros((S, nb, eb), np.int32),
        )
    return graph


def _fill_stacked_row(graph: dict, i: int, g: ShardGraph,
                      blocked_meta) -> None:
    """Write one ShardGraph into row ``i`` of the stacked const arrays."""
    for field in _GRAPH_FIELDS:
        graph[field][i] = np.asarray(getattr(g, field))
    if blocked_meta is not None:
        bg = g.blocked
        if (bg.nb, bg.eb, bg.pb) != blocked_meta:
            raise AssertionError(
                f"shard {i} blocked shape {(bg.nb, bg.eb, bg.pb)} != agreed "
                f"{blocked_meta}")
        for field in _BLOCKED_FIELDS:
            graph[f"blk_{field}"][i] = np.asarray(getattr(bg, field))


def _boundary_slots_from_lists(boundary: list[np.ndarray], n_local: int,
                               pad_to_multiple: int):
    """Pad per-shard boundary index lists to one (S, b_pad) table.

    Pad slots carry the out-of-range sentinel n_local: the exchange reads
    them with a zero fill, so a pad slot never aliases a real neuron's
    bit (it would inflate the sparse wire's spike count otherwise).
    """
    b_pad = max(max((b.size for b in boundary), default=1), 1)
    b_pad = -(-b_pad // pad_to_multiple) * pad_to_multiple
    slots = np.full((len(boundary), b_pad), n_local, dtype=np.int32)
    for s, b in enumerate(boundary):
        slots[s, :b.size] = b
    return b_pad, slots


def _mirror_meta_row(src: np.ndarray, idx: np.ndarray, s: int,
                     row_of: np.ndarray, boundary: list[np.ndarray],
                     b_pad: int, n_local: int, row_width: int):
    """Exchange gather indices for ONE shard's mirror table.

    Returns ``(intra, row_gather, remote_gather)``:

    - row gather: (model_idx_within_row, local_idx) -> flat;
    - remote gather: (src_flat, slot) -> flat; slot via searchsorted into
      the source's sorted boundary list (only meaningful where ~intra and
      the source actually publishes that neuron).
    """
    intra = row_of[src] == row_of[s]
    row_gather = ((src % row_width) * n_local + idx).astype(np.int32)
    slot = np.zeros(src.size, dtype=np.int64)
    for src_shard in np.unique(src[~intra]):
        m = (~intra) & (src == src_shard)
        b = boundary[int(src_shard)]
        pos = np.searchsorted(b, idx[m])
        pos = np.clip(pos, 0, max(b.size - 1, 0))
        slot[m] = pos
    remote_gather = (src * b_pad + slot).astype(np.int32)
    return intra, row_gather, remote_gather


def _stack_and_index(spec: NetworkSpec, shard_iter, *, S: int,
                     row_width: int, e_pad: int, n_local: int,
                     n_mirror: int, blocked_meta,
                     pad_to_multiple: int,
                     block_shapes_spec=None) -> StackedNetwork:
    """Consume shard graphs one at a time into the stacked const arrays and
    derive the exchange metadata."""
    row_of = np.arange(S) // row_width
    graph = _alloc_stacked_graph(S, e_pad, n_local, n_mirror, blocked_meta)
    src_all = np.zeros((S, n_mirror), np.int32)
    idx_all = np.zeros((S, n_mirror), np.int32)

    # boundary sets: local indices consumed by shards in OTHER rows
    consumers: list[list[np.ndarray]] = [[] for _ in range(S)]
    n_seen = 0
    for s, g in enumerate(shard_iter):
        _fill_stacked_row(graph, s, g, blocked_meta)
        src = np.asarray(g.mirror_src_shard)
        idx = np.asarray(g.mirror_src_idx)
        src_all[s] = src
        idx_all[s] = idx
        used = np.zeros(n_mirror, dtype=bool)
        used[np.asarray(g.pre_idx)[np.asarray(g.delay) > 0]] = True
        for src_shard in np.unique(src[used]):
            if row_of[src_shard] != row_of[s]:
                sel = used & (src == src_shard)
                consumers[int(src_shard)].append(np.unique(idx[sel]))
        n_seen += 1
    if n_seen != S:
        raise ValueError(f"got {n_seen} shard graphs for {S} shards")

    boundary = [np.unique(np.concatenate(c)) if c else np.zeros(0, np.int64)
                for c in consumers]
    b_pad, boundary_slots = _boundary_slots_from_lists(
        boundary, n_local, pad_to_multiple)

    mirror_is_intra = np.zeros((S, n_mirror), dtype=bool)
    mirror_row_gather = np.zeros((S, n_mirror), dtype=np.int32)
    mirror_remote_gather = np.zeros((S, n_mirror), dtype=np.int32)
    for s in range(S):
        (mirror_is_intra[s], mirror_row_gather[s],
         mirror_remote_gather[s]) = _mirror_meta_row(
            src_all[s], idx_all[s], s, row_of, boundary, b_pad,
            n_local, row_width)

    return StackedNetwork(
        n_shards=S, row_width=row_width, n_local=n_local, n_mirror=n_mirror,
        n_edges=e_pad, b_pad=b_pad, max_delay=spec.max_delay, graph=graph,
        blocked_meta=blocked_meta, block_shapes_spec=block_shapes_spec,
        boundary_slots=boundary_slots, mirror_is_intra=mirror_is_intra,
        mirror_row_gather=mirror_row_gather,
        mirror_remote_gather=mirror_remote_gather,
        mirror_src_flat=src_all)


def procedural_stack_plan(spec: NetworkSpec, dec: Decomposition, *,
                          devices=None, pad_to_multiple: int = 8,
                          with_blocked: bool = True,
                          block_shapes=None) -> dict:
    """Dims pre-pass of the procedural stacked build (pass A only, per
    shard): what every shard must agree on before any array is filled -
    the uniform pads and the shared blocked shape - without ever holding
    more than one shard's counts.

    ``devices`` restricts the pass to a subset of shards.  Returns
    ``dict(e, n_local, n_mirror, row_degree)`` lists per shard, plus the
    resolved pads under ``"pads"`` when every shard was scanned.
    """
    devs = range(dec.n_devices) if devices is None else devices
    dims = [builder_mod.procedural_shard_raw(spec, dec, int(s),
                                             dims_only=True)
            for s in devs]
    plan = dict(
        e=[d["e"] for d in dims],
        n_local=[int(d["owned"].size) for d in dims],
        n_mirror=[int(d["mirror_gids"].size) for d in dims],
        row_degree=[d["row_degree"] for d in dims],
    )
    if devices is None:
        plan["pads"] = resolve_stack_pads(plan, spec,
                                          pad_to_multiple=pad_to_multiple,
                                          with_blocked=with_blocked,
                                          block_shapes=block_shapes)
    return plan


def resolve_stack_pads(plan: dict, spec: NetworkSpec, *,
                       pad_to_multiple: int = 8,
                       with_blocked: bool = True,
                       block_shapes=None) -> dict:
    """Per-shard dims (possibly all-gathered) -> the agreed uniform pads
    and blocked meta.  Pure arithmetic, no RNG, so every process that
    holds the same dims derives the same answer.  ``block_shapes`` picks
    the shared (PB, EB) from the per-shard row degrees
    (:func:`repro_torch.core.autotune.resolve_block_shapes_from_degrees`);
    a pinned EB below the widest shard's need raises.
    """
    _pad = lambda n: max(((int(n) + pad_to_multiple - 1) // pad_to_multiple)
                         * pad_to_multiple, pad_to_multiple)
    e_pad = _pad(max(plan["e"]))
    n_local_pad = _pad(max(plan["n_local"]))
    n_mirror_pad = _pad(max(plan["n_mirror"]))
    blocked_meta = shapes = None
    if with_blocked:
        shapes = autotune_mod.resolve_block_shapes_from_degrees(
            plan["row_degree"], block_shapes, n_local=n_local_pad,
            n_mirror=n_mirror_pad, max_delay=spec.max_delay)
        pb = DEFAULT_PB if shapes is None else shapes.pb
        need = max(autotune_mod.eb_from_degrees(rd, n_local_pad, pb=pb)
                   for rd in plan["row_degree"])
        eb = need if shapes is None else shapes.eb
        if eb < need:
            raise ValueError(
                f"block_shapes eb={eb} is below the widest shard's "
                f"per-block edge count {need} at pb={pb} - raise eb (or "
                "use 'auto')")
        blocked_meta = (max(-(-n_local_pad // pb), 1), eb, pb)
    return dict(e_pad=e_pad, n_local_pad=n_local_pad,
                n_mirror_pad=n_mirror_pad, blocked_meta=blocked_meta,
                shapes=shapes)


def procedural_shard_graphs(spec: NetworkSpec, dec: Decomposition,
                            devices, pads: dict, *,
                            pad_to_multiple: int = 8,
                            with_blocked: bool = True):
    """Yield finalized ShardGraphs for ``devices`` one at a time, each built
    O(owned rows) and padded to the agreed ``pads``: the generator both
    :func:`prepare_stacked` (all shards) and the multi-host build (a
    process's own shards) drain."""
    bm = pads["blocked_meta"]
    pad_dims = (pads["e_pad"], pads["n_local_pad"], pads["n_mirror_pad"])
    for s in devices:
        raw = builder_mod.procedural_shard_raw(spec, dec, int(s))
        [g] = builder_mod.finalize_shards(
            spec, dec, [raw], pad_to_multiple=pad_to_multiple,
            with_blocked=with_blocked, block_shapes=pads["shapes"],
            streamed=True, pad_dims=pad_dims,
            blocked_eb_min=None if bm is None else bm[1])
        yield g


def prepare_stacked(spec: NetworkSpec, dec: Decomposition,
                    n_rows: int, row_width: int, *,
                    pad_to_multiple: int = 8,
                    with_blocked: bool = True,
                    block_shapes=None) -> StackedNetwork:
    """Build uniform shards and the area/remote exchange index tables, as
    numpy; move the result with :meth:`StackedNetwork.to`.

    ``with_blocked=False`` skips the post-block ELL arrays, for runs that
    never select a kernel backend.  ``block_shapes`` picks the shared
    (PB, EB) pair, as ``builder.build_shards`` says.

    A materialized spec goes through ``builder.build_shards(uniform_pad=
    True)``.  A procedural spec is built AND stacked one shard at a time: a
    dims pre-pass (:func:`procedural_stack_plan`) agrees on the uniform
    pads and blocked shape, then each shard is generated, written into the
    preallocated stacked arrays and dropped - peak host memory is the
    stacked arrays plus one shard, never the global edge list.
    """
    S = n_rows * row_width
    if S != dec.n_devices:
        raise ValueError(f"a {n_rows}x{row_width} grid has {S} shards but "
                         f"the decomposition has {dec.n_devices}")
    if spec.connectivity == "procedural":
        pads = procedural_stack_plan(spec, dec,
                                     pad_to_multiple=pad_to_multiple,
                                     with_blocked=with_blocked,
                                     block_shapes=block_shapes)["pads"]
        shard_iter = procedural_shard_graphs(
            spec, dec, range(S), pads, pad_to_multiple=pad_to_multiple,
            with_blocked=with_blocked)
        e_pad, n_local, n_mirror = (pads["e_pad"], pads["n_local_pad"],
                                    pads["n_mirror_pad"])
        blocked_meta = pads["blocked_meta"]
    else:
        shards = build_shards(spec, dec, pad_to_multiple=pad_to_multiple,
                              uniform_pad=True, with_blocked=with_blocked,
                              block_shapes=block_shapes)
        blocked_meta = None
        if with_blocked:
            bgs = [g.blocked for g in shards]
            blocked_meta = (bgs[0].nb, bgs[0].eb, bgs[0].pb)
        e_pad, n_local, n_mirror = (shards[0].n_edges, shards[0].n_local,
                                    shards[0].n_mirror)
        shard_iter = iter(shards)
    return _stack_and_index(
        spec, shard_iter, S=S, row_width=row_width, e_pad=e_pad,
        n_local=n_local, n_mirror=n_mirror, blocked_meta=blocked_meta,
        pad_to_multiple=pad_to_multiple, block_shapes_spec=block_shapes)


# --------------------------------------------------------------------------
# traffic model
# --------------------------------------------------------------------------

def wire_bytes_split(mode: str, wire, remote_wire=None, *, n_shards: int,
                     row_width: int, n_local: int, b_pad: int
                     ) -> dict[str, int]:
    """Per-shard spike-exchange bytes per step, split by tier, from
    decomposition dims alone.

    ``intra``: bytes that stay within a row - the M intra-row local
    payloads of "area" mode; ``inter``: bytes that cross rows - the S
    boundary payloads of "area" mode, or everything in "global" mode.
    """
    lw = wire_mod.get_wire(wire)
    rw = lw if remote_wire is None else wire_mod.get_wire(remote_wire)
    if mode == "global":
        return dict(intra=0, inter=n_shards * rw.bytes_per_step(n_local))
    if mode == "area":
        return dict(intra=row_width * lw.bytes_per_step(n_local),
                    inter=n_shards * rw.bytes_per_step(b_pad))
    raise ValueError(f"unknown comm mode {mode!r}")


def wire_bytes_for_dims(mode: str, wire, remote_wire=None, *,
                        n_shards: int, row_width: int,
                        n_local: int, b_pad: int) -> int:
    """Total per-shard spike-exchange bytes per step (both tiers)."""
    split = wire_bytes_split(mode, wire, remote_wire, n_shards=n_shards,
                             row_width=row_width, n_local=n_local,
                             b_pad=b_pad)
    return split["intra"] + split["inter"]


def wire_bytes_per_step(net: StackedNetwork, mode: str = "area",
                        wire="packed", remote_wire=None) -> int:
    """Per-shard spike-exchange bytes per step for a wire codec pair."""
    return wire_bytes_for_dims(mode, wire, remote_wire,
                               n_shards=net.n_shards,
                               row_width=net.row_width,
                               n_local=net.n_local, b_pad=net.b_pad)


# --------------------------------------------------------------------------
# configuration and state
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    engine: EngineConfig
    comm_mode: str = "area"       # "area" | "global"
    overlap: bool = True          # paper §III.C schedule
    # spike-exchange wire codec (repro_torch.core.wire): "f32" / "u8" /
    # "packed" dense bitmaps, "sparse" fixed-capacity (count, ids)
    # payloads, "sparse:<rate>"; a SpikeWire instance also works
    spike_wire: Any = "packed"
    # wire of the REMOTE tier: the cross-row boundary payload in "area"
    # mode and the whole gather in "global" mode.  None = ``spike_wire``
    spike_wire_remote: Any = None

    @property
    def neuron_model(self) -> str:
        return self.engine.neuron_model

    @property
    def wire(self) -> wire_mod.SpikeWire:
        return wire_mod.get_wire(self.spike_wire)

    @property
    def remote_wire(self) -> wire_mod.SpikeWire:
        spec = (self.spike_wire if self.spike_wire_remote is None
                else self.spike_wire_remote)
        return wire_mod.get_wire(spec)


@dataclasses.dataclass
class DistState:
    """Distributed engine state; every tensor is (S, ...) over the shards
    this process steps (``shards``, global shard indices)."""
    v_m: torch.Tensor
    syn_ex: torch.Tensor
    syn_in: torch.Tensor
    ref_count: torch.Tensor
    ring: torch.Tensor          # (S, D, n_mirror)
    weights: torch.Tensor       # (S, E) flat or (S, NB*EB) blocked
    k_pre: torch.Tensor         # (S, n_mirror)
    k_post: torch.Tensor        # (S, n_local)
    prev_bits: torch.Tensor     # (S, n_local) spikes fired last step
    t: torch.Tensor             # (S,) int32 step counter (equal values)
    wire_overflow: torch.Tensor  # (S,) int32 saturated lossy payloads
    #: (S,) int32 steps whose activity gate saturated (DESIGN.md §13)
    gate_overflow: torch.Tensor
    #: one drive generator per shard, seeded from the seed and the shard
    generators: list
    #: model-specific per-neuron state, (S, n_local) each
    aux: dict = dataclasses.field(default_factory=dict)
    #: layout of ``weights``: "flat" or "blocked:{pb}x{eb}"
    weights_layout: str = "flat"
    neuron_model: str = "lif"
    #: seed of a stochastic model's per-neuron draws (None: deterministic)
    model_seed: int | None = None
    #: global shard index of each leading row
    shards: tuple[int, ...] = ()


def shard_generators(seed: int, shards: Sequence[int], device) -> list:
    """One drive generator per shard of ``shards``, each seeded from the
    run seed and the GLOBAL shard index, so that a shard draws the same
    stream whichever process steps it."""
    gens = []
    for s in shards:
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([int(seed), int(s)])
                          .generate_state(1, dtype=np.uint64)[0] >> 1))
        gens.append(g)
    return gens


def advance_generators(generators, graphs, n_steps: int,
                       dt: float = 0.1) -> list:
    """Advance each shard's drive generator by ``n_steps`` steps of the
    distributed loop, in place, and return the list: the twin of the
    reference's ``advance_key_data``.

    The step draws one ``torch.poisson`` over the shard's rates a step
    (:func:`~repro_torch.core.engine._poisson_drive`), so the stream an
    uninterrupted run holds after ``n_steps`` is reached by replaying
    ``n_steps`` draws of those rates (``graphs[i]``, the shard's
    :class:`ShardGraph` on the generator's device).  That is exact on both
    devices because the rates are constant; no Philox offset is computed
    (the CPU generator has none, and how many numbers a ``torch.poisson``
    call consumes is the library's business).  Restart tooling that
    re-derives the generators for a NEW shard count (elastic shrink) uses
    this; a run with the drive off draws nothing and must not call it.
    """
    if len(generators) != len(graphs):
        raise ValueError(f"{len(generators)} generators for {len(graphs)} "
                         "shard graphs")
    for gen, g in zip(generators, graphs):
        for _ in range(int(n_steps)):
            _poisson_drive(gen, g, dt, torch.float32)
    return list(generators)


def _layout_tag_of(net: StackedNetwork, kind: str) -> str:
    """The run-time layout tag of ``kind`` on ``net``'s shards (they share
    one blocked shape)."""
    return backends_mod.layout_tag(
        backends_mod.layout_of(net.shard_graphs[0]), kind)


def _on_device(x: torch.Tensor, dev: torch.device) -> bool:
    return x.device.type == dev.type and (dev.index is None
                                          or x.device.index == dev.index)


def _require_net_on(net: StackedNetwork, dev: torch.device) -> None:
    if net.shard_graphs is None:
        raise TypeError(f"the StackedNetwork holds host arrays; move it "
                        f"with net.to({str(dev)!r})")
    x = net.graph["pre_idx"]
    if not _on_device(x, dev):
        raise ValueError(f"the StackedNetwork is on {x.device} but the run "
                         f"is on {dev}")


def init_stacked_state(net: StackedNetwork, groups, seed: int = 0, *,
                       dtype=torch.float32, sweep: str | None = None,
                       neuron_model: str = "lif",
                       shards: Sequence[int] | None = None,
                       device="cuda") -> DistState:
    """Fresh state of ``shards`` (global indices; every shard ``net``
    holds by default) on ``device`` (the card unless ``device="cpu"``);
    ``net`` must already be there (:meth:`StackedNetwork.to`).  Each
    shard's drive generator is seeded from its global index
    (:func:`shard_generators`), whichever rows the net holds.

    ``sweep`` (a backend name) stores the weights in that backend's native
    layout up front; without it they are flat.  ``neuron_model`` picks the
    dynamics; ``groups`` must be that model's parameter class.
    """
    dev = resolve_device(device)
    _require_net_on(net, dev)
    shards = tuple(range(*net.shard_range)) if shards is None else tuple(
        int(s) for s in shards)
    idx = torch.tensor(net.rows_of(shards), dtype=torch.long, device=dev)
    model = neuron_models_mod.get_model(neuron_model)
    gid = net.graph["group_id"].index_select(0, idx)
    nvars = model.init_vars(gid.cpu().numpy(), list(groups))
    f = lambda k, dt=dtype: torch.as_tensor(nvars[k], dtype=dt, device=dev)
    weights = net.graph["weight_init"].index_select(0, idx).to(dtype)
    weights_layout = "flat"
    if sweep is not None and backends_mod.get_backend(
            sweep).weights_layout == "blocked":
        weights_layout = _layout_tag_of(net, "blocked")
        perm = net.graph["blk_edge_perm"].index_select(0, idx)
        weights = torch.gather(weights, 1, perm.reshape(len(shards),
                                                        -1).long())
    n, S = net.n_local, len(shards)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    return DistState(
        v_m=f("v_m"), syn_ex=f("syn_ex"), syn_in=f("syn_in"),
        ref_count=f("ref_count", torch.int32),
        ring=zeros(S, net.max_delay, net.n_mirror), weights=weights,
        k_pre=zeros(S, net.n_mirror), k_post=zeros(S, n),
        prev_bits=zeros(S, n), t=zeros(S, dt=torch.int32),
        wire_overflow=zeros(S, dt=torch.int32),
        gate_overflow=zeros(S, dt=torch.int32),
        generators=shard_generators(seed, shards, dev),
        aux={k: f(k) for k in model.extra_fields},
        weights_layout=weights_layout, neuron_model=model.name,
        model_seed=int(seed) if model.stochastic else None, shards=shards)


# --------------------------------------------------------------------------
# the exchange
# --------------------------------------------------------------------------

class _Ready:
    """A gather that is already complete (the stacked exchange's)."""

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


@dataclasses.dataclass(frozen=True)
class ExchangeTables(_HeldShards):
    """The exchange's index tables of shards ``lo..hi-1`` of a grid
    (``local_slice``), each (S_loc, ...): what an exchange reads, from a
    :class:`StackedNetwork` (:meth:`StackedNetwork.exchange_tables`) or from
    a raw step's consts."""

    n_shards: int
    row_width: int
    n_local: int
    b_pad: int
    local_slice: tuple[int, int] | None
    boundary_slots: Any        # (S_loc, B) local idx published per slot
    mirror_is_intra: Any       # (S_loc, n_mirror) bool
    mirror_row_gather: Any     # (S_loc, n_mirror) -> row-gathered flat idx
    mirror_remote_gather: Any  # (S_loc, n_mirror) -> remote-gathered idx
    mirror_src_flat: Any       # (S_loc, n_mirror) source shard (global)
    mirror_src_idx: Any        # (S_loc, n_mirror) source's local idx


def _exchange_tables(src) -> ExchangeTables:
    return src if isinstance(src, ExchangeTables) else src.exchange_tables()


class _Exchange:
    """The exchange's index tables for the shards a process steps, and its
    two collectives; the tier logic is :func:`_exchange_issue` and
    :func:`_exchange_finish`.  Every exchange is built from a
    :class:`StackedNetwork` on its device or from :class:`ExchangeTables`.

    ``gather_world(payload)`` and ``gather_row(payload)`` take the local
    shards' payloads (S_loc, W) and return a handle whose ``wait()`` gives
    the gathered payloads: every shard's for the world, the row's for the
    row.  ``remote_idx`` indexes the flattened decoded world gather of
    boundary payloads, ``row_idx`` the row gather's and ``global_idx`` the
    world gather of whole payloads ("global" mode), each (S_loc,
    n_mirror)."""

    def __init__(self, src, cfg: DistributedConfig, shards: Sequence[int]):
        tab = _exchange_tables(src)
        self.mode = cfg.comm_mode
        if self.mode not in ("area", "global"):
            raise ValueError(f"unknown comm mode {self.mode!r}")
        self.wire, self.remote_wire = cfg.wire, cfg.remote_wire
        self.n_local, self.b_pad = tab.n_local, tab.b_pad
        self.shards = tuple(shards)
        dev = tab.mirror_src_flat.device
        idx = torch.tensor(tab.rows_of(self.shards), dtype=torch.long,
                           device=dev)
        take = lambda x: x.index_select(0, idx)
        self.boundary = take(tab.boundary_slots).long()
        self.is_intra = take(tab.mirror_is_intra)
        self.row_idx = take(tab.mirror_row_gather).long()
        self.remote_idx = take(tab.mirror_remote_gather).long()
        self.global_idx = (take(tab.mirror_src_flat).long() * tab.n_local
                           + take(tab.mirror_src_idx).long())

    def gather_world(self, payload):
        raise NotImplementedError

    def gather_row(self, payload):
        raise NotImplementedError


class _WholeRows(_Exchange):
    """Every shard of the whole rows ``src`` holds, in this process on one
    device: the row tier's all-gather is the stacked payload itself, and
    its decoded bits are indexed across the held rows at once
    (``row_idx`` offset by the shard's row among them)."""

    def __init__(self, src, cfg: DistributedConfig):
        lo, hi = src.shard_range
        if lo % src.row_width or hi % src.row_width:
            raise ValueError(f"shards {lo}..{hi - 1} split a row of "
                             f"{src.row_width}: a row must not span "
                             "processes")
        super().__init__(src, cfg, range(lo, hi))
        row = torch.arange(hi - lo, device=self.row_idx.device
                           ) // src.row_width
        self.row_idx = (row[:, None] * (src.row_width * src.n_local)
                        + self.row_idx)

    def gather_row(self, payload):
        return _Ready(payload)


class StackedExchange(_WholeRows):
    """Every shard in this process, on one device: a tier's all-gather is
    the stacked payload itself."""

    def __init__(self, src, cfg: DistributedConfig):
        if src.shard_range != (0, src.n_shards):
            raise ValueError(
                f"the net holds shards {src.shard_range} of "
                f"{src.n_shards}; step a process's own rows with "
                "HostExchange")
        super().__init__(src, cfg)

    def gather_world(self, payload):
        return _Ready(payload)


class StandInExchange(_Exchange):
    """One shard of a grid stepped alone, with no other shard anywhere
    (the dry run, :mod:`repro_torch.launch.dryrun_snn`): each gather gives
    a payload of the gathered shape made from the local one, (n_shards, W)
    for the world and (row_width, W) for the row, as a view.  The spikes
    it maps are not the grid's; its cost is.

    ``gathered_bytes`` accumulates each gather's output bytes by tier
    (``"world"``, ``"row"``), the bytes the gather would deliver to this
    shard: the reference's HLO analyser counts a collective so
    (``src/repro/utils/hlo_analysis.py``), and
    :func:`wire_bytes_split` is the model they meet."""

    def __init__(self, src, cfg: DistributedConfig):
        lo, hi = src.shard_range
        if hi - lo != 1:
            raise ValueError(f"the stand-in steps one shard; got shards "
                             f"{lo}..{hi - 1}")
        super().__init__(src, cfg, (lo,))
        self.n_shards, self.row_width = src.n_shards, src.row_width
        self.gathered_bytes = {"world": 0, "row": 0}

    def _stand_in(self, payload, n: int, tier: str):
        out = payload.expand(n, payload.shape[-1])
        self.gathered_bytes[tier] += out.numel() * out.element_size()
        return _Ready(out)

    def gather_world(self, payload):
        return self._stand_in(payload, self.n_shards, "world")

    def gather_row(self, payload):
        return self._stand_in(payload, self.row_width, "row")


class _Pending:
    """An all-gather in flight: ``wait()`` waits on the collective and
    concatenates the gathered payloads in rank order."""

    def __init__(self, work, parts):
        self.work, self.parts = work, parts

    def wait(self):
        self.work.wait()
        return torch.cat(self.parts)


class HostExchange(_WholeRows):
    """Whole rows per ``torch.distributed`` process: this process steps the
    shards its net holds (``net.local_slice``; the multi-host build,
    :func:`repro_torch.core.multihost.prepare_stacked_local`).

    The intra tier never leaves the process (the row gather is the stacked
    payload, as in :class:`StackedExchange`).  The remote tier is the only
    collective: one ``all_gather`` of the (S_loc, W) payload over the world
    group, issued with ``async_op=True`` first and waited on in
    :func:`_exchange_finish`.  The gather concatenates by rank, which is
    global shard order only if process p holds shards ``p*S_loc ..
    (p+1)*S_loc - 1``, every process as many: checked here.  Without an
    initialized process group (one process) the world is this process.

    On gloo a CUDA payload is staged through host memory by gloo itself
    (its CUDA all-gather copies to pinned buffers on side streams, and
    ``wait()`` makes the current stream wait on the copies back)."""

    def __init__(self, net, cfg: DistributedConfig):
        import torch.distributed as tdist
        self._dist = tdist
        if tdist.is_initialized():
            rank, self.world = tdist.get_rank(), tdist.get_world_size()
        else:
            rank, self.world = 0, 1
        S = net.n_shards
        if S % self.world:
            raise ValueError(f"{S} shards do not split evenly over "
                             f"{self.world} processes")
        s_loc = S // self.world
        want = (rank * s_loc, (rank + 1) * s_loc)
        if net.shard_range != want:
            raise ValueError(
                f"process {rank} of {self.world} holds shards "
                f"{net.shard_range}, but the world gather concatenates by "
                f"rank, so it must hold {want} (process-major order)")
        super().__init__(net, cfg)

    def gather_world(self, payload):
        if self.world == 1:
            return _Ready(payload)
        x = payload.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        work = self._dist.all_gather(parts, x, async_op=True)
        return _Pending(work, parts)


class ProcessGroupExchange(_Exchange):
    """One shard per ``torch.distributed`` rank (rank = global shard
    index; the world size must be the shard count).  The remote tier goes
    over the world group, the intra tier over the rank's row subgroup;
    both are issued with ``async_op=True`` and waited on in
    :func:`_exchange_finish`.

    Every rank must construct it (``new_group`` is collective)."""

    def __init__(self, net, cfg: DistributedConfig):
        import torch.distributed as dist
        self._dist = dist
        rank, world = dist.get_rank(), dist.get_world_size()
        if world != net.n_shards:
            raise ValueError(f"world size {world} != {net.n_shards} shards")
        super().__init__(net, cfg, (rank,))
        self.row_width = net.row_width
        self.row_group = None
        for r in range(net.n_rows):
            ranks = list(range(r * net.row_width, (r + 1) * net.row_width))
            g = dist.new_group(ranks)
            if rank in ranks:
                self.row_group = g

    def _gather(self, payload, n, group):
        x = payload.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        work = self._dist.all_gather(parts, x, group=group, async_op=True)
        return _Pending(work, parts)

    def gather_world(self, payload):
        return self._gather(payload, self._dist.get_world_size(), None)

    def gather_row(self, payload):
        return self._gather(payload, self.row_width, self.row_group)


def _issue_remote(bits, ex: _Exchange):
    """The remote tier: the boundary neurons' bits ("area"; pad slots, the
    sentinel n_local, read the zero column) or all of them ("global"),
    encoded on the remote wire, and the world gather issued.  Returns
    ``(handle, payload)``."""
    if ex.mode == "area":
        bits = torch.gather(torch.nn.functional.pad(bits, (0, 1)), 1,
                            ex.boundary)
    payload = ex.remote_wire.encode(bits)
    return ex.gather_world(payload), payload


def _issue_intra(bits, ex: _Exchange):
    """The intra tier: the local bitmap on the local wire, and the row
    gather issued.  Returns ``(handle, payload)``."""
    payload = ex.wire.encode(bits)
    return ex.gather_row(payload), payload


def _finish_remote(handle, ex: _Exchange, dtype):
    """Wait on the world gather and decode it, flattened."""
    n = ex.n_local if ex.mode == "global" else ex.b_pad
    return ex.remote_wire.decode(handle.wait(), n, dtype).reshape(-1)


def _finish_intra(handle, ex: _Exchange, dtype):
    """Wait on the row gather and decode it, flattened."""
    return ex.wire.decode(handle.wait(), ex.n_local, dtype).reshape(-1)


def _exchange_issue(bits, ex: _Exchange):
    """Encode the local shards' freshly fired bits (S_loc, n_local) and
    issue the exchange's gathers (nothing is decoded yet).

    Two tiers in "area" mode: the cross-row boundary payload (the slow hop,
    so its gather is issued FIRST) on the remote wire, then the intra-row
    local payload on the local wire.  "global" mode is one gather of every
    shard's payload on the remote wire.  Returns ``(handles, overflow)``:
    the handles for :func:`_exchange_finish` and this step's saturated
    payloads per local shard ((S_loc,) int32), or None on dense wires.
    """
    tiers = [(ex.remote_wire, *_issue_remote(bits, ex))]
    if ex.mode == "area":
        tiers.append((ex.wire, *_issue_intra(bits, ex)))
    overflow = None
    for wire, _, payload in tiers:
        if wire.lossy:
            sat = wire.saturated(payload)
            overflow = sat if overflow is None else overflow + sat
    return tuple(h for _, h, _ in tiers), overflow


def _exchange_finish(handles, ex: _Exchange, dtype):
    """Wait on the gathers, decode, and map the bits onto the local shards'
    mirror rows: (S_loc, n_mirror) in ``dtype``."""
    remote = _finish_remote(handles[0], ex, dtype)
    if ex.mode == "global":
        return remote[ex.global_idx]
    intra = _finish_intra(handles[1], ex, dtype)
    return torch.where(ex.is_intra, intra[ex.row_idx],
                       remote[ex.remote_idx])


def _exchange(bits, ex: _Exchange):
    """Map the local shards' freshly fired bits to their mirror rows:
    ``(mirror_bits, overflow)``, as the two halves give them."""
    handles, overflow = _exchange_issue(bits, ex)
    return _exchange_finish(handles, ex, bits.dtype), overflow


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Carry:
    """The loop's state: each local shard's pieces as tensors of their own,
    so that a step stacks nothing but its spikes; ``state_from`` stacks
    the rest once."""
    neurons: list
    ring: list
    weights: list          # native layout
    traces: list
    gate_overflow: list    # () int32 each
    generators: list       # the shards' drive generators
    model_seed: int | None
    prev_bits: torch.Tensor      # (S_loc, n_local) state dtype
    t: torch.Tensor              # () int32
    wire_overflow: torch.Tensor  # (S_loc,) int32


def check_net_backend(net: StackedNetwork,
                      cfg: DistributedConfig) -> backends_mod.SweepBackend:
    """``cfg``'s backend, checked against ``net``: a blocked backend needs
    the stacked ELL arrays.  The stacked step runs the shapes baked into
    the net; a backend-side ``block_shapes`` spec (``"cuda:auto"``) on a
    net built without one warns: the stacked path tunes through
    ``prepare_stacked(block_shapes=)``."""
    backend = backends_mod.get_backend(cfg.engine.sweep)
    if backend.weights_layout == "blocked" and net.blocked_meta is None:
        raise ValueError(
            f"sweep={cfg.engine.sweep!r} needs a StackedNetwork built "
            "with blocked layouts (prepare_stacked(with_blocked=True))")
    if (getattr(backend, "block_shapes", None) is not None
            and net.block_shapes_spec is None):
        warnings.warn(
            f"sweep={cfg.engine.sweep!r}: the distributed step uses the "
            f"StackedNetwork's baked block shapes {net.blocked_meta}; pass "
            "block_shapes to prepare_stacked to tune them", stacklevel=3)
    return backend


class DistributedStep:
    """The distributed step for the shards of ``exchange``, over their
    :class:`ShardGraph` views ``graphs`` (one per shard, in the exchange's
    order).  Built by :func:`make_distributed_step` (a net's shards) or
    :func:`make_raw_distributed_step` (a consts dict's); :func:`run`
    drives it in a loop.

    Calling it on a :class:`DistState` takes one step and returns
    ``(new_state, spike_bits (S_loc, n_local) bool)``, the state in the
    layout it came in.  In surrogate mode (``EngineConfig.surrogate``) the
    carried ``prev_bits`` hold the float surrogate spike, the gradient
    path, and the returned raster is its bool cast, as in the single-shard
    engine (:func:`~repro_torch.core.engine.normalize_spike_dtype`).
    """

    def __init__(self, graphs, table, cfg: DistributedConfig,
                 exchange: _Exchange, dev: torch.device, *,
                 backend: backends_mod.SweepBackend):
        if cfg.engine.external_drive_mode != "poisson":
            raise NotImplementedError(
                "the distributed step draws the Poisson drive only: the "
                "reference's distributed step has no diffusion drive (it "
                "draws jax.random.poisson whatever external_drive_mode "
                "says), so external_drive_mode="
                f"{cfg.engine.external_drive_mode!r} is refused rather than "
                "replaced; run it through repro_torch.core.engine.run")
        self.table, self.cfg, self.dev = table, cfg, dev
        self.backend = backend
        self.model = neuron_models_mod.get_model(cfg.engine.neuron_model)
        self.exchange = exchange
        self.shards = exchange.shards
        self.graphs = list(graphs)
        if len(self.graphs) != len(self.shards):
            raise ValueError(f"{len(self.graphs)} shard graphs for shards "
                             f"{self.shards}")
        self.n_local = self.graphs[0].n_local
        self.max_delay = self.graphs[0].max_delay
        self.layouts = [self.backend.prepare(g, baked=True)
                        for g in self.graphs]
        self.native_tag = backends_mod.layout_tag(
            self.layouts[0], self.backend.weights_layout)

    # -- DistState <-> loop carry -----------------------------------------
    def _check_state(self, state: DistState) -> None:
        if tuple(state.shards) != self.shards:
            raise ValueError(f"state holds shards {state.shards} but this "
                             f"step runs {self.shards}")
        if state.neuron_model != self.model.name:
            raise ValueError(
                f"DistState was initialized for neuron_model="
                f"{state.neuron_model!r} but cfg selects "
                f"{self.model.name!r}; re-init with "
                "init_stacked_state(neuron_model=...)")

    def carry_from(self, state: DistState) -> _Carry:
        """The loop carry of ``state``, weights in the backend's native
        layout (one conversion per shard when they are not); the carry
        never writes into ``state``'s tensors."""
        self._check_state(state)
        neurons, weights, traces = [], [], []
        for i, (g, lay) in enumerate(zip(self.graphs, self.layouts)):
            neurons.append(_neurons_of(state, i, g))
            w_in = state.weights[i]
            w = backends_mod.convert_weights(lay, w_in, state.weights_layout,
                                             self.native_tag)
            if (w is w_in and self.cfg.engine.stdp is not None
                    and self.backend.stdp_in_place(lay)):
                w = w.clone()   # the caller's weights stay as they were
            weights.append(w)
            traces.append(stdp_mod.TraceState(k_pre=state.k_pre[i],
                                              k_post=state.k_post[i]))
        return _Carry(
            neurons=neurons, ring=list(state.ring.unbind(0)),
            weights=weights, traces=traces,
            gate_overflow=list(state.gate_overflow.unbind(0)),
            generators=state.generators, model_seed=state.model_seed,
            prev_bits=state.prev_bits, t=state.t[0],
            wire_overflow=state.wire_overflow)

    def state_from(self, carry: _Carry, like: DistState,
                   weights_layout: str | None = None) -> DistState:
        """The carry as a :class:`DistState` (``like``'s generators and
        markers), weights re-expressed in ``weights_layout`` (``like``'s
        by default)."""
        target = like.weights_layout if weights_layout is None else \
            weights_layout
        st = lambda xs: torch.stack(list(xs))
        w = st(backends_mod.convert_weights(lay, x, self.native_tag, target)
               for lay, x in zip(self.layouts, carry.weights))
        return dataclasses.replace(
            like,
            v_m=st(n.v_m for n in carry.neurons),
            syn_ex=st(n.syn_ex for n in carry.neurons),
            syn_in=st(n.syn_in for n in carry.neurons),
            ref_count=st(n.ref_count for n in carry.neurons),
            ring=st(carry.ring), weights=w,
            k_pre=st(tr.k_pre for tr in carry.traces),
            k_post=st(tr.k_post for tr in carry.traces),
            prev_bits=carry.prev_bits,
            t=carry.t.reshape(1).repeat(len(self.shards)),
            wire_overflow=carry.wire_overflow,
            gate_overflow=st(carry.gate_overflow),
            aux={k: st(n.extra[k] for n in carry.neurons)
                 for k in self.model.extra_fields},
            weights_layout=target)

    # -- one step -----------------------------------------------------------
    def advance(self, carry: _Carry, drive=None, out=None):
        """One dt on ``carry`` in place: exchange of last step's spikes,
        then per shard the sweep (with the exchanged spikes as ``fresh``
        under ``overlap``, after a ring write without it), drive, neuron
        step and plasticity.  ``drive`` (S_loc, n_local) replaces the
        shards' own Poisson draws.  Writes the spikes into ``out``
        ((S_loc, n_local) bool, allocated if None) and returns it."""
        cfg, ecfg, model = self.cfg, self.cfg.engine, self.model
        dtype = carry.prev_bits.dtype
        t, D = carry.t, self.max_delay
        if (drive is None and ecfg.external_drive
                and len(carry.generators) != len(self.shards)):
            raise ValueError(
                f"the state has {len(carry.generators)} drive generators "
                f"for {len(self.shards)} shards (a state on the meta "
                "device has none): pass drive=")

        # (1) two-tier exchange of last step's spikes: both tiers are
        #     issued here, and waited on only where the bits are consumed
        handles, overflow = _exchange_issue(carry.prev_bits, self.exchange)
        mirror = []

        def fresh(i):
            if not mirror:
                mirror.append(_exchange_finish(handles, self.exchange,
                                               dtype))
            return mirror[0][i]

        bits = []
        for i, (g, lay) in enumerate(zip(self.graphs, self.layouts)):
            # (2) drive: injected slice or the shard's own generator
            if drive is not None:
                d_i = drive[i]
            elif ecfg.external_drive:
                d_i = _poisson_drive(carry.generators[i], g, ecfg.dt, dtype)
            else:
                d_i = None
            # (3) sweep + drive + neuron step; with overlap the backend
            #     takes the exchange as ``fresh`` and writes slot t-1 after
            #     its sweep, without it the slot is written first
            ring, f_i = carry.ring[i], functools.partial(fresh, i)
            if not cfg.overlap:
                ring = backends_mod._write_ring(
                    ring, f_i(), torch.remainder(t - 1, D))
                f_i = None
            neurons, arrived, gate_ovf, ring = self.backend.sweep_update(
                lay, carry.weights[i], ring, t, carry.neurons[i],
                self.table, d_i, synapse_model=ecfg.synapse_model,
                model=model, seed=carry.model_seed, gid=g.global_id,
                fresh=f_i, surrogate=ecfg.surrogate)
            spike = neurons.spike
            # (4) plasticity, as the single-shard engine
            if ecfg.stdp is not None:
                tr = carry.traces[i]
                carry.weights[i] = self.backend.stdp_update(
                    lay, carry.weights[i], arrived, spike, tr, ecfg.stdp)
                pre_arrived = torch.zeros(
                    g.n_mirror, dtype=arrived.dtype,
                    device=arrived.device).scatter_reduce_(
                    0, lay.arrival_pre, arrived, "amax")
                carry.traces[i] = stdp_mod.update_traces(
                    tr, ecfg.stdp, ecfg.dt, pre_arrived, spike)
            if isinstance(gate_ovf, torch.Tensor):
                carry.gate_overflow[i] = carry.gate_overflow[i] + gate_ovf
            carry.neurons[i], carry.ring[i] = neurons, ring
            bits.append(spike)
        if ecfg.surrogate is None:
            out = torch.stack(bits, out=out)
            carry.prev_bits = out.to(dtype)
        else:
            # the float surrogate spike is the gradient path: the carry
            # takes it as it is, and only the returned raster is cast
            spikes = torch.stack(bits)
            carry.prev_bits = spikes.to(dtype)
            out = (spikes.to(torch.bool) if out is None
                   else out.copy_(spikes))
        carry.t = t + 1
        if overflow is not None:
            carry.wire_overflow = carry.wire_overflow + overflow
        return out

    def __call__(self, state: DistState, drive=None):
        carry = self.carry_from(state)
        bits = self.advance(carry, drive)
        return self.state_from(carry, state), bits

    def run(self, state: DistState, n_steps: int, drive=None):
        """Step ``n_steps`` times: :func:`run` with this step."""
        S, n = len(self.shards), self.n_local
        if drive is not None and tuple(drive.shape) != (n_steps, S, n):
            raise ValueError(f"drive must be ({n_steps}, {S}, {n}), "
                             f"got {tuple(drive.shape)}")
        carry = self.carry_from(state)
        spikes = torch.empty((n_steps, S, n), dtype=torch.bool,
                             device=self.dev)
        for i in range(n_steps):
            self.advance(carry, None if drive is None else drive[i],
                         out=spikes[i])
        fin = self.state_from(carry, state, "flat")
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return fin, spikes


def _neurons_of(state: DistState, i: int, g: ShardGraph):
    """Shard ``i``'s neuron state: views of ``state``'s rows."""
    return snn.NeuronState(
        v_m=state.v_m[i], syn_ex=state.syn_ex[i], syn_in=state.syn_in[i],
        ref_count=state.ref_count[i],
        spike=torch.zeros_like(state.v_m[i], dtype=torch.bool),
        group_id=g.group_id, extra={k: v[i] for k, v in state.aux.items()})


def make_distributed_step(net: StackedNetwork, table,
                          cfg: DistributedConfig, *,
                          exchange: _Exchange | None = None,
                          device="cuda") -> DistributedStep:
    """The distributed step on ``device`` (the card unless
    ``device="cpu"``) over ``net`` (on that device) with neuron parameter
    table ``table``: every shard through a :class:`StackedExchange`, or the
    shards of ``exchange`` (a :class:`HostExchange` or
    :class:`ProcessGroupExchange`)."""
    dev = resolve_device(device)
    _require_net_on(net, dev)
    backend = check_net_backend(net, cfg)
    if exchange is None:
        exchange = StackedExchange(net, cfg)
    graphs = [net.shard_graphs[r] for r in net.rows_of(exchange.shards)]
    return DistributedStep(graphs, table, cfg, exchange, dev,
                           backend=backend)


def stacked_consts(net: StackedNetwork, *, needs_blocked: bool) -> dict:
    """The (S, ...) const arrays the raw step consumes: the net's graph
    arrays (the ``blk_*`` ones only with ``needs_blocked``) plus the
    exchange tables, as the net holds them (numpy, or tensors after
    :meth:`StackedNetwork.to`)."""
    consts = {k: v for k, v in net.graph.items()
              if needs_blocked or not k.startswith("blk_")}
    consts.update({k: getattr(net, k) for k in _META_FIELDS})
    return consts


#: const arrays the raw step takes in a compact dtype (uint16 ids, int8
#: delays and channels) and widens to int32, as the reference's step does
_WIDENED = ("pre_idx", "post_idx", "delay", "channel", "mirror_src_idx",
            "boundary_slots", "mirror_row_gather", "mirror_remote_gather",
            "mirror_src_flat", "global_id", "blk_pre_idx", "blk_post_rel",
            "blk_delay", "blk_channel", "blk_edge_perm")
#: the consts every raw step needs (global_id is optional)
_RAW_CONSTS = ("pre_idx", "post_idx", "delay", "channel", "plastic",
               "weight_init", "group_id", "ext_rate", "ext_weight",
               "mirror_src_idx", *_META_FIELDS)


class RawDistributedStep:
    """The distributed step as ``fn(state, consts)``: the graph and
    exchange tables of the shards it steps come in as a dict of (S_loc,
    ...) tensors, with no :class:`StackedNetwork`.  Built by
    :func:`make_raw_distributed_step`.

    A call binds ``consts`` first (:meth:`bind`): compact arrays are
    widened to int32 (the reference widens them at the top of its step),
    and the per-shard views, their backend layouts and the exchange are
    built.  Eager PyTorch cannot fuse the cast into its consumers as XLA
    does, so a caller that steps more than once binds once and steps the
    :class:`DistributedStep` that :meth:`bind` returns."""

    def __init__(self, mesh, groups, cfg: DistributedConfig, *,
                 max_delay: int, n_local: int, n_mirror: int,
                 blocked_meta, shards, exchange, dev: torch.device):
        self.cfg, self.dev = cfg, dev
        self.n_shards = int(mesh.size)
        self.row_width = int(mesh.shape[mesh.axis_names[-1]])
        shards = (tuple(range(self.n_shards)) if shards is None
                  else tuple(int(s) for s in shards))
        if (not shards or shards != tuple(range(shards[0],
                                                shards[0] + len(shards)))
                or shards[0] < 0 or shards[-1] >= self.n_shards):
            raise ValueError(f"shards must be a run of consecutive shards "
                             f"of 0..{self.n_shards - 1}, got {shards}")
        self.shards = shards
        self.max_delay, self.n_local, self.n_mirror = (max_delay, n_local,
                                                       n_mirror)
        self.blocked_meta = (None if blocked_meta is None
                             else tuple(int(x) for x in blocked_meta))
        self.exchange_cls = exchange
        self.backend = backends_mod.get_backend(cfg.engine.sweep)
        model = neuron_models_mod.get_model(cfg.engine.neuron_model)
        self.table = model.make_param_table(list(groups), cfg.engine.dt,
                                            device=dev)

    def bind(self, consts: dict) -> DistributedStep:
        """The step over ``consts``, built anew on every call."""
        missing = [k for k in _RAW_CONSTS if k not in consts]
        if self.backend.weights_layout == "blocked":
            missing += [f"blk_{k}" for k in _BLOCKED_FIELDS
                        if f"blk_{k}" not in consts]
        if missing:
            raise ValueError(f"consts lack {missing}")
        s_loc = len(self.shards)
        bad = {k: (type(v).__name__ if not isinstance(v, torch.Tensor)
                   else f"{tuple(v.shape)} on {v.device}")
               for k, v in consts.items()
               if not isinstance(v, torch.Tensor) or v.shape[0] != s_loc
               or not _on_device(v, self.dev)}
        if bad:
            raise ValueError(f"consts must be (S_loc={s_loc}, ...) tensors "
                             f"on {self.dev}; got {bad}")
        g = {k: (v.to(torch.int32) if k in _WIDENED
                 and v.dtype != torch.int32 else v)
             for k, v in consts.items()}
        tables = ExchangeTables(
            n_shards=self.n_shards, row_width=self.row_width,
            n_local=self.n_local, b_pad=int(g["boundary_slots"].shape[1]),
            local_slice=(self.shards[0], self.shards[-1] + 1),
            mirror_src_idx=g["mirror_src_idx"],
            **{k: g[k] for k in _META_FIELDS})
        if self.exchange_cls is not None:
            exchange = self.exchange_cls(tables, self.cfg)
        elif len(self.shards) == self.n_shards:
            exchange = StackedExchange(tables, self.cfg)
        else:
            raise ValueError(
                f"the raw step runs shards {self.shards} of "
                f"{self.n_shards}: pass exchange= (StandInExchange for one "
                "shard alone, HostExchange for a process's rows)")
        graphs = _shard_views(g, n_local=self.n_local,
                              n_mirror=self.n_mirror,
                              max_delay=self.max_delay,
                              blocked_meta=self.blocked_meta)
        return DistributedStep(graphs, self.table, self.cfg, exchange,
                               self.dev, backend=self.backend)

    def __call__(self, state: DistState, consts: dict, drive=None):
        """One step, ``consts`` bound for it: ``(new_state, spike_bits
        (S_loc, n_local) bool)``."""
        return self.bind(consts)(state, drive)

    def run(self, state: DistState, consts: dict, n_steps: int, drive=None):
        """``n_steps`` steps, as :func:`run`: ``(final_state, spikes)``."""
        return self.bind(consts).run(state, n_steps, drive)


def make_raw_distributed_step(mesh, groups, cfg: DistributedConfig, *,
                              max_delay: int, n_local: int, n_mirror: int,
                              blocked_meta=None, shards=None, exchange=None,
                              device="cuda") -> RawDistributedStep:
    """The distributed step as ``fn(state, consts)`` on ``device`` (the
    card unless ``device="cpu"`` or ``"meta"``), the port of the
    reference's ``make_raw_distributed_step``.

    ``mesh`` gives the grid: ``mesh.size`` shards in rows of
    ``mesh.shape[mesh.axis_names[-1]]`` (:mod:`repro_torch.launch.mesh`).
    The step runs ``shards`` (consecutive global indices; all by default),
    whose (S_loc, ...) consts carry the keys of :func:`stacked_consts`
    (``global_id`` optional; ``blk_*`` with ``blocked_meta=(nb, eb, pb)``
    for a blocked backend), in int32 or compact dtypes.  ``exchange`` is
    the exchange's class, built on the consts' tables: by default a
    :class:`StackedExchange` over every shard; :class:`StandInExchange`
    steps one shard alone.  On ``meta`` the drive comes in through
    ``drive=`` (no generator exists there)."""
    backend = backends_mod.get_backend(cfg.engine.sweep)
    if backend.weights_layout == "blocked" and blocked_meta is None:
        raise ValueError(
            f"sweep={cfg.engine.sweep!r} on the raw step needs "
            "blocked_meta=(nb, eb, pb) plus blk_* entries in the consts "
            "(incl. blk_plastic) and blocked-resident state weights")
    return RawDistributedStep(
        mesh, groups, cfg, max_delay=max_delay, n_local=n_local,
        n_mirror=n_mirror, blocked_meta=blocked_meta, shards=shards,
        exchange=exchange, dev=resolve_device(device))


def run(state: DistState, net: StackedNetwork, table,
        cfg: DistributedConfig, n_steps: int, *, drive=None,
        exchange: _Exchange | None = None, device="cuda"):
    """Step ``n_steps`` times on ``device`` (the card unless
    ``device="cpu"``); returns ``(final_state, spikes)``, spikes
    (n_steps, S_loc, n_local) bool.

    Flat-facing, as ``engine.run``: the loop carries the backend's NATIVE
    weights (one conversion in) and the returned state is FLAT (one
    conversion out).  ``drive`` ((n_steps, S_loc, n_local)) replaces the
    shards' per-step Poisson draws.  The loop never syncs with the host;
    ``run`` synchronises the device once, at the end.
    """
    return make_distributed_step(net, table, cfg, exchange=exchange,
                                 device=device).run(state, n_steps, drive)


def global_spikes(spikes, net: StackedNetwork, n_neurons: int):
    """Spikes of every shard ``net`` holds (n_steps, S, n_local) ->
    (n_steps, n_neurons) by global id (0 for neurons it does not hold)."""
    gid = net.graph["global_id"].to(spikes.device)
    live = gid >= 0
    out = torch.zeros((spikes.shape[0], n_neurons + 1), dtype=spikes.dtype,
                      device=spikes.device)
    col = torch.where(live, gid, n_neurons).long().reshape(-1)
    out[:, col] = spikes.reshape(spikes.shape[0], -1)
    return out[:, :n_neurons]
