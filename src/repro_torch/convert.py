"""Carry a network and an engine state across from the reference package.

The reference (``src/repro``) and the port share no code, so state crosses
between them as numpy arrays, named by their dataclass paths.  The parity
tests use these functions so that both packages start from the same state.

* :func:`graph_from_numpy` - a port :class:`ShardGraph` (numpy fields, call
  ``.to(device)`` next) from the reference ``ShardGraph``'s fields;
* :func:`state_from_numpy` - a port :class:`EngineState` from the
  reference ``EngineState``'s leaves, weights re-expressed in the chosen
  backend's native layout;
* :func:`state_to_numpy` - the inverse, weights returned flat.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backends as backends_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import snn
from repro_torch.core import stdp as stdp_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.layout import BlockedGraph

__all__ = ["graph_from_numpy", "state_from_numpy", "state_to_numpy",
           "STATE_LEAVES"]

#: leaf names of a single-shard engine state, as dataclass paths
STATE_LEAVES = ("neurons.v_m", "neurons.syn_ex", "neurons.syn_in",
                "neurons.ref_count", "neurons.spike", "ring", "weights",
                "traces.k_pre", "traces.k_post", "t")


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def graph_from_numpy(fields) -> engine_mod.ShardGraph:
    """Port ``ShardGraph`` from the reference ``ShardGraph``'s fields.

    ``fields`` maps each field name to its value (numpy arrays, ints);
    ``fields["blocked"]`` is None or the blocked twin's fields, as a mapping
    or any object with ``BlockedGraph``'s attribute names.
    """
    names = [f.name for f in dataclasses.fields(engine_mod.ShardGraph)]
    kw = {}
    for name in names:
        if name == "blocked":
            continue
        val = _field(fields, name)
        kw[name] = val if val is None or np.isscalar(val) else np.asarray(val)
    bg = _field(fields, "blocked")
    if bg is not None:
        bnames = [f.name for f in dataclasses.fields(BlockedGraph)]
        bg = BlockedGraph(**{
            n: (_field(bg, n) if n in ("nb", "eb", "pb", "n_local")
                else None if _field(bg, n) is None
                else np.asarray(_field(bg, n)))
            for n in bnames})
    for name in ("n_local", "n_mirror", "max_delay"):
        kw[name] = int(kw[name])
    return engine_mod.ShardGraph(blocked=bg, **kw)


def state_from_numpy(arrays, graph: engine_mod.ShardGraph, *,
                     sweep: str, device="cuda",
                     seed=0) -> engine_mod.EngineState:
    """Port ``EngineState`` from the reference state's leaves.

    ``arrays`` maps every name of :data:`STATE_LEAVES` to a numpy array
    (``weights`` in FLAT order).  ``graph`` is the port graph on
    ``device``; the weights are re-expressed in backend ``sweep``'s native
    layout through ``edge_perm``.  ``seed`` seeds the port's own drive
    generator (the reference's ``jax.random`` key has no torch twin).
    """
    dev = resolve_device(device)
    missing = [k for k in STATE_LEAVES if k not in arrays]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    a = {k: np.array(arrays[k]) for k in STATE_LEAVES}   # owned copies
    dtype = getattr(torch, str(a["neurons.v_m"].dtype))   # float32/64
    tens = lambda k, dt=dtype: torch.as_tensor(a[k], dtype=dt, device=dev)
    neurons = snn.NeuronState(
        v_m=tens("neurons.v_m"), syn_ex=tens("neurons.syn_ex"),
        syn_in=tens("neurons.syn_in"),
        ref_count=tens("neurons.ref_count", torch.int32),
        spike=tens("neurons.spike", torch.bool),
        group_id=torch.as_tensor(np.asarray(graph.group_id.cpu()),
                                 dtype=torch.int32, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    state = engine_mod.EngineState(
        neurons=neurons, ring=tens("ring"), weights=tens("weights"),
        traces=stdp_mod.TraceState(k_pre=tens("traces.k_pre"),
                                   k_post=tens("traces.k_post")),
        t=torch.as_tensor(a["t"], dtype=torch.int32, device=dev).reshape(()),
        generator=gen, weights_layout="flat")
    backend = backends_mod.get_backend(sweep)
    return engine_mod.state_with_weights_layout(
        state, graph, backend.weights_layout, backend=backend)


def state_to_numpy(state: engine_mod.EngineState,
                   graph: engine_mod.ShardGraph) -> dict:
    """Inverse of :func:`state_from_numpy`: the leaves of
    :data:`STATE_LEAVES` as numpy arrays, weights in FLAT order."""
    flat = engine_mod.state_with_weights_layout(state, graph, "flat")
    np_ = lambda x: x.detach().cpu().numpy()
    return {
        "neurons.v_m": np_(flat.neurons.v_m),
        "neurons.syn_ex": np_(flat.neurons.syn_ex),
        "neurons.syn_in": np_(flat.neurons.syn_in),
        "neurons.ref_count": np_(flat.neurons.ref_count),
        "neurons.spike": np_(flat.neurons.spike),
        "ring": np_(flat.ring),
        "weights": np_(flat.weights),
        "traces.k_pre": np_(flat.traces.k_pre),
        "traces.k_post": np_(flat.traces.k_post),
        "t": np_(flat.t),
    }
