"""Activity-gate capacity policy (DESIGN.md §13) - the gate half of the
reference package's ``core/autotune.py``.

The activity-gated backend (``"cuda:sparse"``, :mod:`repro_torch.core.
backends`) dispatches its kernels over a fixed-capacity worklist of post
blocks.  This module sizes that worklist: from a provisioned per-step
firing fraction (:func:`gate_capacity`), or from measured saturation
records in a BENCH file (:func:`load_measured_gate`,
:func:`measured_gate_capacity`), keyed by the layout's degree distribution
(:func:`degrees_from_graphs`, :func:`degree_signature`).

Beside it, the counts-only half of the (PB, EB) block shapes that the
procedural stacked plan needs: :class:`BlockShapes`, :func:`eb_from_degrees`
and :func:`resolve_block_shapes_from_degrees` for the fixed defaults.

A jax-free numpy copy.  The reference's TPU VMEM models
(``sweep_vmem_bytes``, ``gated_sweep_vmem_bytes``) and its (PB, EB) tuner
are not here: any spec other than the fixed defaults raises until the port
has a Hopper resource model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings

import numpy as np
import torch

from repro_torch.core.layout import DEFAULT_EB_MULTIPLE, DEFAULT_PB

__all__ = ["BlockShapes", "eb_from_degrees",
           "resolve_block_shapes_from_degrees", "DEFAULT_GATE_RATE", "DEFAULT_GATE_MIN_CAPACITY", "gate_capacity",
           "load_measured_gate", "measured_gate_capacity",
           "recommend_gate_rate", "degrees_from_graphs", "degree_signature"]

#: default per-step firing fraction the activity gate provisions its
#: worklist for - ~20 Hz at dt=0.1 ms, well above the few-Hz biological
#: regime
DEFAULT_GATE_RATE = 0.002
#: worklist floor
DEFAULT_GATE_MIN_CAPACITY = 8


@dataclasses.dataclass(frozen=True)
class BlockShapes:
    """One chosen (PB, EB) pair plus the model terms that justified it."""

    pb: int
    eb: int
    nb: int                 # grid cells (max across shards when uniform)
    padded_slots: int       # NB * EB summed over shards (= sweep work)
    vmem_bytes: int         # kernel footprint under the reference's model
    feasible: bool          # vmem_bytes <= budget

    def as_tuple(self) -> tuple[int, int]:
        return self.pb, self.eb


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


def resolve_block_shapes_from_degrees(degrees, spec, *, n_local: int,
                                      n_mirror: int,
                                      max_delay: int) -> BlockShapes | None:
    """The block shapes of a ``block_shapes`` spec, for builds that only
    hold per-shard degree arrays (the procedural dims pre-pass).

    None keeps the fixed defaults and returns None.  Every other spec
    (``"auto"``, ``"measured:<path>"``, a pinned pair) raises
    ``NotImplementedError``, as ``builder.build_shards`` does: the
    reference sizes (PB, EB) against TPU VMEM, and the port has no Hopper
    resource model yet.
    """
    if spec is None:
        return None
    raise NotImplementedError(
        f"block_shapes={spec!r} needs an autotuner with a Hopper resource "
        "model, which the port does not have yet; build with the fixed "
        "defaults (block_shapes=None)")


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
