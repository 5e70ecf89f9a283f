"""(PB, EB) block shapes and the activity-gate capacity policy (DESIGN.md
§2, §13) - the port of the reference package's ``core/autotune.py``.

**Block shapes.**  The post-block ELL layout (:mod:`repro_torch.core.layout`)
has two free shape parameters: ``PB`` (post rows per block) and ``EB``
(padded edge slots per block).  A shard's cost is

    padded_slots = NB * EB,   NB = ceil(n_local / PB),
    EB = roundup(max_b sum(indegree of block b), eb_multiple)

- every padded slot is a slot K1, K3, K6 and K7 walk or skip.  The tuner
walks the candidates :data:`DEFAULT_PB_CANDIDATES`, prices each by its
padded slots, rejects the shapes the card cannot hold or the kernels cannot
index (:func:`sweep_device_bytes`, :func:`kernel_index_limits`), and breaks
ties toward the larger PB - the reference's selection, unchanged.  Uniform
multi-shard tuning (stacked shards share one (NB, EB, PB)) takes the max EB
across shards per candidate, the ``eb_min`` contract of
:func:`repro_torch.core.layout.blocked_layout`.  Measured records
(``shape_tune/<signature>/pb{PB}xeb{EB}``, :func:`load_measured_timings`)
replace the padded-slots model among the feasible candidates.

Where the reference prices a candidate against TPU VMEM per grid cell (its
one-hot tile alone is EB*PB*4 bytes), the port prices what the shape makes
it keep on the card (the Hopper resource model): K1's grid is one warp per
post row whatever PB is, so PB changes no launch, only the layout's
padding, the size of K1's run table and the gate's granularity.

**The gate.**  The activity-gated backend (``"cuda:sparse"``) dispatches
K6 and K7 over a fixed-capacity worklist of post blocks.  This module sizes
that worklist: from a provisioned per-step firing fraction
(:func:`gate_capacity`), or from measured saturation records in a BENCH
file (:func:`load_measured_gate`, :func:`measured_gate_capacity`), keyed by
the layout's degree distribution (:func:`degrees_from_graphs`,
:func:`degree_signature`).

A jax-free numpy copy, apart from the resource model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.layout import DEFAULT_EB_MULTIPLE, DEFAULT_PB

__all__ = ["BlockShapes", "sweep_device_bytes", "gated_sweep_device_bytes",
           "kernel_index_limits", "autotune_block_shapes",
           "autotune_block_shapes_from_degrees", "resolve_block_shapes",
           "resolve_block_shapes_from_degrees", "autotune_report",
           "load_measured_timings", "eb_from_degrees",
           "DEFAULT_PB_CANDIDATES", "DEFAULT_DEVICE_BUDGET",
           "DEFAULT_GATE_RATE", "DEFAULT_GATE_MIN_CAPACITY", "gate_capacity",
           "load_measured_gate", "measured_gate_capacity",
           "recommend_gate_rate", "degrees_from_graphs", "degree_signature"]

#: post-block candidates, the reference's
DEFAULT_PB_CANDIDATES = (128, 256, 512, 1024)
#: device bytes the shape-dependent state of the stacked shards may take on
#: one card: half of an H100's 80 GB, the other half left to the flat edge
#: arrays (21 bytes an edge), the neuron state and the allocator's slack
DEFAULT_DEVICE_BUDGET = 40 * 10 ** 9
#: default per-step firing fraction the activity gate provisions its
#: worklist for - ~20 Hz at dt=0.1 ms, well above the few-Hz biological
#: regime
DEFAULT_GATE_RATE = 0.002
#: worklist floor
DEFAULT_GATE_MIN_CAPACITY = 8

_INT_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65_535   # CUDA's limit on gridDim.y


@dataclasses.dataclass(frozen=True)
class BlockShapes:
    """One chosen (PB, EB) pair plus the model terms that justified it."""

    pb: int
    eb: int
    nb: int                 # blocks (max across shards when uniform)
    padded_slots: int       # NB * EB summed over shards (= sweep work)
    device_bytes: int       # card bytes under :func:`sweep_device_bytes`
    feasible: bool          # within the budget and the kernels' index range

    def as_tuple(self) -> tuple[int, int]:
        return self.pb, self.eb


def sweep_device_bytes(pb: int, eb: int, *, nb: int, max_delay: int,
                       n_mirror: int, n_shards: int = 1) -> int:
    """Card bytes that the (PB, EB) shape makes the kernel backend keep for
    ``n_shards`` shards of ``nb`` blocks each (the stacked step holds every
    shard on one card), per shard:

    * the blocked layout on the card, per slot: int32 ``pre_idx``,
      ``post_rel``, ``delay``, ``channel``, ``edge_perm`` and bool
      ``plastic`` (21 bytes; the build-time f32 ``weight`` stays on the
      host);
    * the run-time f32 weights twice (K3 writes a new vector while the old
      one is live) and the f32 arrivals K1 emits: 12 bytes a slot;
    * K1's run table ``segment_bounds``: NB * (D*PB + 1) int32;
    * the ring, D * M f32, and the fresh row of the overlap schedule, M f32.
    """
    slots = nb * eb
    per_shard = (slots * (5 * 4 + 1) + slots * 3 * 4
                 + nb * (max_delay * pb + 1) * 4
                 + (max_delay + 1) * n_mirror * 4)
    return n_shards * per_shard


def gated_sweep_device_bytes(pb: int, eb: int, *, nb: int, max_delay: int,
                             n_mirror: int, capacity: int,
                             n_shards: int = 1) -> int:
    """:func:`sweep_device_bytes` plus what the activity gate
    (``"cuda:sparse"``) keeps on top of it, per shard: the pre-pass's
    (NB, EB) int32 gather index into the rolled ring, its (NB, EB) bool
    active mask, the rolled ring ((D + 1) * M f32), the (capacity + 2)
    int32 worklist buffer and the NB int32 block ids.  The pre-pass's
    (NB, EB) f32 arrivals take the place of K1's, counted there."""
    extra = (nb * eb * (4 + 1) + (max_delay + 1) * n_mirror * 4
             + (capacity + 2) * 4 + nb * 4)
    return sweep_device_bytes(pb, eb, nb=nb, max_delay=max_delay,
                              n_mirror=n_mirror, n_shards=n_shards) + \
        n_shards * extra


def kernel_index_limits(pb: int, eb: int, *, nb: int,
                        max_delay: int) -> list[str]:
    """The index ranges a (PB, EB) shape with ``nb`` blocks breaks, as
    text (empty when it breaks none).  The kernels index with 32-bit
    ``int`` where a range is bounded by the shape:

    * K1 (``csrc/synaptic_gather.cu``) and K6
      (``csrc/blocked_reduce_sweep.cu``): a slot's offset in its block and
      the ``bounds`` values are ``int`` (the ``s`` loops); the padded tail's
      loop strides ``32 * PB`` past ``s < EB``: EB + 32*PB <= 2^31 - 1.
      The run-table row stride ``D*PB + 1`` is ``int``:
      D*PB + 1 <= 2^31 - 1.  The grid, ceil(NB*PB / 8) CTAs, is an ``int``.
    * K3 (``csrc/stdp_update.cu``): the slot index is ``long long``, the
      post row ``post_rel + (e / EB) * PB`` an ``int``: NB*PB <= 2^31 - 1.
    * K7 (``csrc/stdp_update_worklist.cu``): the grid's y dimension is NB,
      and CUDA allows 65 535: NB <= 65 535; the row ``b * PB`` is ``int``
      (NB*PB as above); the slot loop strides 64 * 256 past ``s < EB``:
      EB + 16 384 <= 2^31 - 1.
    """
    out = []
    if eb + 32 * pb > _INT_MAX or eb + 64 * 256 > _INT_MAX:
        out.append(f"EB {eb} overflows the int slot loops of K1/K6/K7")
    if max_delay * pb + 1 > _INT_MAX:
        out.append(f"D*PB + 1 = {max_delay * pb + 1} overflows K1's int "
                   "run-table stride")
    if nb * pb > _INT_MAX:
        out.append(f"NB*PB = {nb * pb} overflows the int post rows of K3/K7")
    if nb > _GRID_Y_MAX:
        out.append(f"NB {nb} exceeds K7's grid y limit {_GRID_Y_MAX}")
    return out


def _shape(pb: int, eb: int, *, nbs, max_delay: int, n_mirror: int,
           budget: int) -> BlockShapes:
    """One candidate: ``nbs`` holds each shard's block count."""
    nb = max(nbs)
    nbytes = sweep_device_bytes(pb, eb, nb=nb, max_delay=max_delay,
                                n_mirror=n_mirror, n_shards=len(nbs))
    ok = nbytes <= budget and not kernel_index_limits(
        pb, eb, nb=nb, max_delay=max_delay)
    return BlockShapes(pb=pb, eb=eb, nb=nb,
                       padded_slots=sum(n * eb for n in nbs),
                       device_bytes=nbytes, feasible=ok)


def _row_degrees(g) -> np.ndarray:
    """Per-row live-edge counts over all ``n_local`` rows (padding rows
    included, as :func:`repro_torch.core.layout.blocked_eb` counts)."""
    post, d = _host(g.post_idx), _host(g.delay)
    return np.bincount(post[d > 0], minlength=int(g.n_local))


def _candidates(graphs, pb_candidates, eb_multiple, budget):
    D = max(int(g.max_delay) for g in graphs)
    M = max(int(g.n_mirror) for g in graphs)
    degs = [(_row_degrees(g), int(g.n_local)) for g in graphs]
    out = []
    for pb in pb_candidates:
        eb = max(eb_from_degrees(rd, n, pb=pb, eb_multiple=eb_multiple)
                 for rd, n in degs)
        nbs = [max(-(-n // pb), 1) for _, n in degs]
        out.append(_shape(pb, eb, nbs=nbs, max_delay=D, n_mirror=M,
                          budget=budget))
    return out


def eb_from_degrees(row_degree, n_local: int, *, pb: int = DEFAULT_PB,
                    eb_multiple: int = DEFAULT_EB_MULTIPLE) -> int:
    """Padded per-block edge count from per-row indegrees alone.

    The counts-only twin of :func:`repro_torch.core.layout.blocked_eb` for
    builds that never materialize the shard (the procedural dims
    pre-pass): a block's edge count is just the sum of its rows'
    indegrees.
    """
    rd = np.asarray(row_degree, dtype=np.int64)
    nb = max(-(-int(n_local) // pb), 1)
    full = np.zeros(nb * pb, np.int64)
    full[:rd.size] = rd
    counts = full.reshape(nb, pb).sum(axis=1)
    eb = int(max(counts.max() if counts.size else 1, 1))
    return ((eb + eb_multiple - 1) // eb_multiple) * eb_multiple


def load_measured_timings(path: str) -> dict:
    """Measured sweep timings from a BENCH_*.json-shaped file.

    Reads ``shape_tune/<signature>/pb{PB}xeb{EB}`` records (``chip_smoke.py``
    writes them from the card) into a ``{(signature, pb, eb): us_per_call}``
    map - the tuner's measured tie-break table.  A missing file or
    malformed records give an empty map (the tuner then uses the
    padded-slots model).
    """
    out: dict = {}
    if not os.path.exists(path):
        return out
    try:
        with open(path) as f:
            payload = json.load(f)
        recs = payload["records"] if isinstance(payload, dict) else payload
    except (json.JSONDecodeError, KeyError, TypeError):
        return out
    for r in recs:
        name = r.get("name", "")
        if not name.startswith("shape_tune/"):
            continue
        try:
            _, sig, shape = name.split("/")
            pb_s, eb_s = shape.split("x")
            out[(sig, int(pb_s[2:]), int(eb_s[2:]))] = float(
                r["us_per_call"])
        except (ValueError, KeyError):
            continue
    return out


def _select(cands, *, measured=None, signature=None) -> BlockShapes:
    """The reference's selection: measured timings (when present for this
    signature) beat the padded-slots model, fewest padded slots then the
    larger PB; the resource model gates feasibility either way.  Where the
    reference falls back to the smallest footprint when nothing is
    feasible, the port raises: an infeasible shape does not fit the card or
    breaks a kernel's index range."""
    feasible = [c for c in cands if c.feasible]
    if not feasible:
        raise ValueError(
            "no (PB, EB) candidate fits the device budget and the kernels' "
            "index ranges: " + "; ".join(
                f"pb={c.pb} eb={c.eb} nb={c.nb} {c.device_bytes} bytes"
                for c in cands))
    if measured and signature is not None:
        timed = [c for c in feasible
                 if (signature, c.pb, c.eb) in measured]
        if timed:
            return min(timed, key=lambda c: (
                measured[(signature, c.pb, c.eb)], -c.pb))
    return min(feasible, key=lambda c: (c.padded_slots, -c.pb))


def _measured_map(measured):
    return (load_measured_timings(measured) if isinstance(measured, str)
            else measured)


def autotune_block_shapes(graphs, *,
                          pb_candidates: Sequence[int] = DEFAULT_PB_CANDIDATES,
                          eb_multiple: int = DEFAULT_EB_MULTIPLE,
                          device_budget: int = DEFAULT_DEVICE_BUDGET,
                          measured=None) -> BlockShapes:
    """Pick (PB, EB) for one ShardGraph or a uniform set of them (numpy or
    torch fields, on any device).

    Fewest total padded slots over the feasible candidates, ties toward
    the larger PB; raises when no candidate is feasible.  ``measured`` (a
    ``{(signature, pb, eb): us}`` map or a BENCH-shaped file's path)
    replaces the padded-slots model with real timings whenever the shards'
    degree signature has measured candidates.
    """
    gs = list(graphs) if isinstance(graphs, (list, tuple)) else [graphs]
    if not gs:
        raise ValueError("autotune_block_shapes needs at least one shard")
    cands = _candidates(gs, pb_candidates, eb_multiple, device_budget)
    sig = None
    if measured is not None:
        measured = _measured_map(measured)
        sig = degree_signature(degrees_from_graphs(gs))
    return _select(cands, measured=measured, signature=sig)


def autotune_block_shapes_from_degrees(
        degrees, *, n_local: int, n_mirror: int, max_delay: int,
        pb_candidates: Sequence[int] = DEFAULT_PB_CANDIDATES,
        eb_multiple: int = DEFAULT_EB_MULTIPLE,
        device_budget: int = DEFAULT_DEVICE_BUDGET,
        measured=None) -> BlockShapes:
    """:func:`autotune_block_shapes` from per-shard row-degree arrays alone
    (uniform ``n_local`` / ``n_mirror`` pads) - the procedural build's
    entry point: same candidates, same selection, no shard graph."""
    ds = list(degrees)
    if not ds:
        raise ValueError("autotune_block_shapes_from_degrees needs at "
                         "least one shard's degrees")
    cands = []
    for pb in pb_candidates:
        eb = max(eb_from_degrees(rd, n_local, pb=pb,
                                 eb_multiple=eb_multiple) for rd in ds)
        nbs = [max(-(-int(n_local) // pb), 1)] * len(ds)
        cands.append(_shape(pb, eb, nbs=nbs, max_delay=max_delay,
                            n_mirror=n_mirror, budget=device_budget))
    sig = None
    if measured is not None:
        measured = _measured_map(measured)
        sig = degree_signature(ds)
    return _select(cands, measured=measured, signature=sig)


def _parse_shapes_spec(spec):
    """The passthrough and pinned cases of a block_shapes spec; returns
    (handled, value)."""
    if spec is None:
        return True, None
    if isinstance(spec, BlockShapes):
        return True, spec
    if isinstance(spec, tuple) and len(spec) == 2:
        pb, eb = int(spec[0]), int(spec[1])
        return True, BlockShapes(pb=pb, eb=eb, nb=0, padded_slots=0,
                                 device_bytes=0, feasible=True)
    return False, None


def _tuned(spec, tune):
    """``"auto"`` -> ``tune()``; ``"measured:<path>"`` ->
    ``tune(measured=<path>)``."""
    if spec == "auto":
        return tune()
    if isinstance(spec, str) and spec.startswith("measured:"):
        return tune(measured=spec.split(":", 1)[1])
    raise ValueError(f"unknown block_shapes spec {spec!r} (expected None, "
                     "'auto', 'measured:<path>', a BlockShapes or a "
                     "(pb, eb) pair)")


def resolve_block_shapes(graphs, spec) -> BlockShapes | None:
    """Normalize a user/backend ``block_shapes`` spec.

    None -> None (keep the builder's layout, the fixed defaults);
    ``"auto"`` -> :func:`autotune_block_shapes`; ``"measured:<path>"`` ->
    the same with the file's measured timings as the tie-break; a
    :class:`BlockShapes` (or a (pb, eb) pair) passes through pinned.
    """
    handled, val = _parse_shapes_spec(spec)
    if handled:
        return val
    return _tuned(spec, lambda **kw: autotune_block_shapes(graphs, **kw))


def resolve_block_shapes_from_degrees(degrees, spec, *, n_local: int,
                                      n_mirror: int,
                                      max_delay: int) -> BlockShapes | None:
    """:func:`resolve_block_shapes` for builds that only hold per-shard
    degree arrays (the procedural dims pre-pass)."""
    handled, val = _parse_shapes_spec(spec)
    if handled:
        return val
    return _tuned(spec, lambda **kw: autotune_block_shapes_from_degrees(
        degrees, n_local=n_local, n_mirror=n_mirror, max_delay=max_delay,
        **kw))


def autotune_report(graphs, **kw) -> dict:
    """Chosen against the fixed-default shapes, with the model's terms."""
    gs = list(graphs) if isinstance(graphs, (list, tuple)) else [graphs]
    chosen = autotune_block_shapes(gs, **kw)
    [default] = _candidates(gs, [DEFAULT_PB],
                            kw.get("eb_multiple", DEFAULT_EB_MULTIPLE),
                            kw.get("device_budget", DEFAULT_DEVICE_BUDGET))
    real = sum(int((_host(g.delay) > 0).sum()) for g in gs)
    return dict(
        pb=chosen.pb, eb=chosen.eb, nb=chosen.nb,
        padded_slots=chosen.padded_slots,
        device_kib=chosen.device_bytes // 1024,
        feasible=chosen.feasible,
        default_pb=default.pb, default_eb=default.eb,
        default_padded_slots=default.padded_slots,
        default_device_kib=default.device_bytes // 1024,
        real_edges=real,
        pad_ratio=round(chosen.padded_slots / max(real, 1), 3),
        default_pad_ratio=round(default.padded_slots / max(real, 1), 3),
        slots_vs_default=round(
            chosen.padded_slots / max(default.padded_slots, 1), 3),
    )


def gate_capacity(nb: int, n_edges: int, rate, *,
                  min_capacity: int = DEFAULT_GATE_MIN_CAPACITY,
                  signature: str | None = None) -> int:
    """Worklist capacity (in post blocks) for a per-step firing fraction.

    An edge sees an arrival with probability ``rate``, so a block with
    ``k ~= n_edges / nb`` edges is active with probability
    ``1 - (1 - rate)^k``.  Capacity is the expected active-block count at
    that rate, floored at ``min_capacity`` and capped at ``nb`` (a
    full-capacity gate is the dense pass and can never saturate).  No
    hidden headroom: :func:`recommend_gate_rate` adds the 2x.

    ``rate`` may also be ``"measured:<path>"``: the capacity then comes
    from the BENCH file's ``gate_tune/<signature>/cap{K}`` records
    (:func:`measured_gate_capacity`), falling back, with a one-time
    warning, to :data:`DEFAULT_GATE_RATE` when the file has no data for
    ``signature``.
    """
    if isinstance(rate, str):
        if not rate.startswith("measured:"):
            raise ValueError(
                f"gate rate spec must be a float or 'measured:<path>', "
                f"got {rate!r}")
        path = rate.split(":", 1)[1]
        cap = measured_gate_capacity(
            load_measured_gate(path), signature,
            nb=nb, min_capacity=min_capacity)
        if cap is not None:
            return cap
        _warn_measured_fallback(path, signature)
        rate = DEFAULT_GATE_RATE
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"gate rate must be in (0, 1], got {rate!r}")
    k = max(float(n_edges) / max(nb, 1), 1.0)
    p_active = 1.0 - (1.0 - rate) ** k
    cap = max(int(np.ceil(nb * p_active)), min_capacity)
    return min(cap, nb)


# (path, signature) pairs already warned about: once per distinct miss
_warned_measured_fallbacks: set = set()


def _warn_measured_fallback(path: str, signature: str | None) -> None:
    """One-time warning when a ``measured:<path>`` spec degrades to the
    firing-rate model (no ``gate_tune/`` record for this signature)."""
    key = (path, signature)
    if key in _warned_measured_fallbacks:
        return
    _warned_measured_fallbacks.add(key)
    warnings.warn(
        f"gate capacity spec 'measured:{path}' has no gate_tune record "
        f"for signature {signature!r}; falling back to the firing-rate "
        f"model at rate {DEFAULT_GATE_RATE} (benchmarks/bench_snn.py "
        "--gate-tune writes such records)", RuntimeWarning, stacklevel=3)


def load_measured_gate(path: str) -> dict:
    """``gate_tune/<signature>/cap{K}`` records of a BENCH_*.json file as
    ``{(signature, capacity): (overflow_rate, occupancy)}``; a missing file
    or malformed records give an empty map."""
    out: dict = {}
    if not os.path.exists(path):
        return out
    try:
        with open(path) as f:
            payload = json.load(f)
        recs = payload["records"] if isinstance(payload, dict) else payload
    except (json.JSONDecodeError, KeyError, TypeError):
        return out
    for r in recs:
        name = r.get("name", "")
        if not name.startswith("gate_tune/"):
            continue
        try:
            _, sig, cap_s = name.split("/")
            out[(sig, int(cap_s[3:]))] = (float(r["overflow_rate"]),
                                          float(r["occupancy"]))
        except (ValueError, KeyError):
            continue
    return out


def measured_gate_capacity(measured: dict, signature: str | None, *,
                           nb: int,
                           min_capacity: int = DEFAULT_GATE_MIN_CAPACITY
                           ) -> int | None:
    """The smallest measured capacity with zero overflow (else the least
    overflowing, largest on ties), clipped to ``[min_capacity, nb]``; None
    when ``measured`` has nothing for ``signature``."""
    if not measured or signature is None:
        return None
    caps = [(cap, ovf) for (sig, cap), (ovf, _) in measured.items()
            if sig == signature]
    if not caps:
        return None
    clean = [cap for cap, ovf in caps if ovf == 0.0]
    cap = min(clean) if clean else max(caps, key=lambda c: (-c[1], c[0]))[0]
    return min(max(cap, min_capacity), nb)


def recommend_gate_rate(frac_peak: float, *, headroom: float = 2.0) -> float:
    """Measured per-step firing fraction -> provisioned gate rate (2x the
    peak, clamped to [1e-4, 1]); feed it to ``"cuda:sparse:<rate>"``."""
    return round(min(max(headroom * frac_peak, 1e-4), 1.0), 5)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def degrees_from_graphs(graphs) -> list[np.ndarray]:
    """Per-shard per-row real-edge counts (padding rows, ``global_id``
    -1, dropped) - the distribution every signature keys on.  Takes
    graphs or edge layouts, with numpy or torch fields."""
    gs = list(graphs) if isinstance(graphs, (list, tuple)) else [graphs]
    out = []
    for g in gs:
        post = _host(g.post_idx)
        d = _host(g.delay)
        deg = np.bincount(post[d > 0], minlength=int(g.n_local))
        gid = getattr(g, "global_id", None)
        if gid is not None:
            deg = deg[_host(gid) >= 0]
        out.append(deg)
    return out


def degree_signature(degrees, *, n_quantiles: int = 8) -> str:
    """Short stable fingerprint of a (multi-shard) degree distribution:
    quantized degree quantiles plus shard count and totals."""
    ds = [np.asarray(d, dtype=np.int64) for d in degrees]
    alld = (np.concatenate(ds) if ds and sum(d.size for d in ds)
            else np.zeros(1, np.int64))
    qs = np.percentile(alld, np.linspace(0, 100, n_quantiles + 1),
                       method="nearest").astype(np.int64)
    raw = (f"s{len(ds)};n{alld.size};e{int(alld.sum())};"
           + ",".join(str(int(q)) for q in qs))
    return hashlib.sha256(raw.encode()).hexdigest()[:12]
