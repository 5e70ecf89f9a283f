"""Carry a network and an engine state across from the reference package.

The reference (``src/repro``) and the port share no code, so state crosses
between them as numpy arrays, named by their dataclass paths.  The parity
tests use these functions so that both packages start from the same state.

* :func:`graph_from_numpy` - a port :class:`ShardGraph` (numpy fields, call
  ``.to(device)`` next) from the reference ``ShardGraph``'s fields;
* :func:`state_from_numpy` - a port :class:`EngineState` from the
  reference ``EngineState``'s leaves, weights re-expressed in the chosen
  backend's native layout, for any neuron model (its ``extra`` variables
  are leaves ``neurons.extra.<name>``, :func:`state_leaves`) and with the
  gate's saturation count ``gate_overflow`` (0 when absent);
* :func:`state_to_numpy` - the inverse, weights returned flat;
* :func:`stacked_net_from_numpy` - a port ``StackedNetwork`` (numpy arrays,
  call ``.to(device)`` next) from the reference ``StackedNetwork``'s
  fields;
* :func:`dist_state_from_numpy` and :func:`dist_state_to_numpy` - the
  distributed engine's state from and to the reference ``DistState``'s
  leaves (:func:`dist_state_leaves`), weights flat on the numpy side;
* :func:`lm_params_from_numpy` and :func:`encdec_params_from_numpy` - the
  LM face: a port ``DecoderLM`` / ``EncDecLM`` ``state_dict`` from the
  reference's parameter tree;
* :func:`classifier_params_from_numpy` and :func:`opt_state_from_numpy` -
  the differentiable slice: the SNN classifier's params and an optimizer
  state of :mod:`repro_torch.train.optimizer`, as nested dicts of tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backends as backends_mod
from repro_torch.core import distributed as dist_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import neuron_models as neuron_models_mod
from repro_torch.core import snn
from repro_torch.core import stdp as stdp_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.layout import BlockedGraph

__all__ = ["graph_from_numpy", "state_from_numpy", "state_to_numpy",
           "state_leaves", "lm_params_from_numpy", "encdec_params_from_numpy",
           "STATE_LEAVES",
           "stacked_net_from_numpy", "dist_state_from_numpy",
           "dist_state_to_numpy", "dist_state_leaves", "DIST_STATE_LEAVES",
           "classifier_params_from_numpy", "opt_state_from_numpy"]

#: leaf names of a single-shard engine state, as dataclass paths (a LIF
#: state; other models add their extra variables, :func:`state_leaves`)
STATE_LEAVES = ("neurons.v_m", "neurons.syn_ex", "neurons.syn_in",
                "neurons.ref_count", "neurons.spike", "ring", "weights",
                "traces.k_pre", "traces.k_post", "t", "gate_overflow")
#: leaves a state may lack: ``gate_overflow`` then counts from 0, as the
#: reference reads a state made without it
_OPTIONAL_LEAVES = ("gate_overflow",)


def state_leaves(neuron_model: str = "lif") -> tuple[str, ...]:
    """Leaf names of a state of ``neuron_model``: :data:`STATE_LEAVES` and
    ``neurons.extra.<name>`` for each of the model's extra variables."""
    model = neuron_models_mod.get_model(neuron_model)
    return STATE_LEAVES + tuple(f"neurons.extra.{k}"
                                for k in model.extra_fields)


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
                     sweep: str, device="cuda", seed=0,
                     neuron_model: str = "lif") -> engine_mod.EngineState:
    """Port ``EngineState`` from the reference state's leaves.

    ``arrays`` maps every name of :func:`state_leaves` (``neuron_model``)
    to a numpy array (``weights`` in FLAT order).  ``graph`` is the port
    graph on ``device``; the weights are re-expressed in backend
    ``sweep``'s native layout through ``edge_perm``.  ``seed`` seeds the
    port's own drive generator and a stochastic model's draws (the
    reference's ``jax.random`` keys have no torch twin).
    """
    dev = resolve_device(device)
    model = neuron_models_mod.get_model(neuron_model)
    leaves = state_leaves(model)
    missing = [k for k in leaves
               if k not in arrays and k not in _OPTIONAL_LEAVES]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    a = {k: np.array(arrays[k]) for k in leaves if k in arrays}  # copies
    a.setdefault("gate_overflow", np.zeros((), np.int32))
    dtype = getattr(torch, str(a["neurons.v_m"].dtype))   # float32/64
    tens = lambda k, dt=dtype: torch.as_tensor(a[k], dtype=dt, device=dev)
    neurons = snn.NeuronState(
        v_m=tens("neurons.v_m"), syn_ex=tens("neurons.syn_ex"),
        syn_in=tens("neurons.syn_in"),
        ref_count=tens("neurons.ref_count", torch.int32),
        spike=tens("neurons.spike", torch.bool),
        group_id=torch.as_tensor(np.asarray(graph.group_id.cpu()),
                                 dtype=torch.int32, device=dev),
        extra={k: tens(f"neurons.extra.{k}") for k in model.extra_fields})
    model.check_state(neurons)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    state = engine_mod.EngineState(
        neurons=neurons, ring=tens("ring"), weights=tens("weights"),
        traces=stdp_mod.TraceState(k_pre=tens("traces.k_pre"),
                                   k_post=tens("traces.k_post")),
        t=torch.as_tensor(a["t"], dtype=torch.int32, device=dev).reshape(()),
        generator=gen,
        gate_overflow=torch.as_tensor(a["gate_overflow"], dtype=torch.int32,
                                      device=dev).reshape(()),
        weights_layout="flat", neuron_model=model.name,
        model_seed=int(seed) if model.stochastic else None)
    backend = backends_mod.get_backend(sweep)
    return engine_mod.state_with_weights_layout(
        state, graph, backend.weights_layout, backend=backend)


def state_to_numpy(state: engine_mod.EngineState,
                   graph: engine_mod.ShardGraph) -> dict:
    """Inverse of :func:`state_from_numpy`: the leaves of
    :func:`state_leaves` (the state's model) as numpy arrays, weights in
    FLAT order."""
    flat = engine_mod.state_with_weights_layout(state, graph, "flat")
    np_ = lambda x: x.detach().cpu().numpy()
    extra = {f"neurons.extra.{k}": np_(v)
             for k, v in flat.neurons.extra.items()}
    return extra | {
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
        "gate_overflow": (np.zeros((), np.int32)
                          if flat.gate_overflow is None
                          else np_(flat.gate_overflow)),
    }


# --------------------------------------------------------------------------
# the distributed engine
# --------------------------------------------------------------------------

#: leaf names of a distributed state (a LIF state; other models add
#: ``aux.<name>``, :func:`dist_state_leaves`), each (S, ...)
DIST_STATE_LEAVES = ("v_m", "syn_ex", "syn_in", "ref_count", "ring",
                     "weights", "k_pre", "k_post", "prev_bits", "t",
                     "wire_overflow", "gate_overflow")


def dist_state_leaves(neuron_model: str = "lif") -> tuple[str, ...]:
    """Leaf names of a distributed state of ``neuron_model``:
    :data:`DIST_STATE_LEAVES` and ``aux.<name>`` per extra variable."""
    model = neuron_models_mod.get_model(neuron_model)
    return DIST_STATE_LEAVES + tuple(f"aux.{k}" for k in model.extra_fields)


def stacked_net_from_numpy(fields) -> dist_mod.StackedNetwork:
    """Port ``StackedNetwork`` from the reference ``StackedNetwork``'s
    fields (a mapping, or the object itself): its graph dict and exchange
    tables as numpy arrays."""
    kw = {}
    for f in dataclasses.fields(dist_mod.StackedNetwork):
        if f.name == "shard_graphs":
            continue
        val = _field(fields, f.name)
        if f.name == "graph":
            val = {k: np.asarray(v) for k, v in val.items()}
        elif f.name in ("blocked_meta", "local_slice"):
            val = None if val is None else tuple(int(x) for x in val)
        elif f.name == "block_shapes_spec":
            # None or a spec string as it is; a reference BlockShapes or a
            # pair as the pinned (pb, eb) pair it stands for
            if val is not None and not isinstance(val, str):
                val = ((int(val.pb), int(val.eb)) if hasattr(val, "pb")
                       else tuple(int(x) for x in val))
        elif np.ndim(val) == 0:
            val = int(val)
        else:
            val = np.asarray(val)
        kw[f.name] = val
    return dist_mod.StackedNetwork(**kw)


def dist_state_from_numpy(arrays, net: dist_mod.StackedNetwork, *,
                          sweep: str | None = None, device="cuda", seed=0,
                          neuron_model: str = "lif",
                          shards=None) -> dist_mod.DistState:
    """Port ``DistState`` of ``shards`` (all by default) from the
    reference state's leaves.

    ``arrays`` maps every name of :func:`dist_state_leaves` to a numpy
    array with one row per shard of ``shards`` (``weights`` FLAT);
    ``gate_overflow`` may be missing (0).  ``net`` is the port net on
    ``device``; ``sweep`` re-expresses the weights in that backend's native
    layout.  ``seed`` seeds the port's own per-shard drive generators and
    a stochastic model's draws (the reference's keys have no torch twin).
    """
    dev = resolve_device(device)
    model = neuron_models_mod.get_model(neuron_model)
    leaves = dist_state_leaves(model)
    missing = [k for k in leaves if k not in arrays and k != "gate_overflow"]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    a = {k: np.array(arrays[k]) for k in leaves if k in arrays}  # copies
    S = a["v_m"].shape[0]
    a.setdefault("gate_overflow", np.zeros((S,), np.int32))
    dtype = getattr(torch, str(a["v_m"].dtype))
    ints = ("ref_count", "t", "wire_overflow", "gate_overflow")
    tens = {k: torch.as_tensor(v, dtype=torch.int32 if k in ints else dtype,
                               device=dev) for k, v in a.items()}
    shards = (tuple(range(*net.shard_range)) if shards is None
              else tuple(shards))
    state = dist_mod.DistState(
        **{k: tens[k] for k in DIST_STATE_LEAVES},
        generators=dist_mod.shard_generators(seed, shards, dev),
        aux={k: tens[f"aux.{k}"] for k in model.extra_fields},
        weights_layout="flat", neuron_model=model.name,
        model_seed=int(seed) if model.stochastic else None, shards=shards)
    if sweep is not None and backends_mod.get_backend(
            sweep).weights_layout == "blocked":
        state = _dist_weights_as(state, net, "blocked")
    return state


def _dist_weights_as(state: dist_mod.DistState,
                     net: dist_mod.StackedNetwork, kind: str):
    """``state`` with its weights re-expressed as ``kind`` per shard."""
    w = []
    for i, r in enumerate(net.rows_of(state.shards)):
        layout = backends_mod.layout_of(net.shard_graphs[r])
        tag = backends_mod.layout_tag(layout, kind)
        w.append(backends_mod.convert_weights(
            layout, state.weights[i], state.weights_layout, tag))
    return dataclasses.replace(state, weights=torch.stack(w),
                               weights_layout=tag)


def dist_state_to_numpy(state: dist_mod.DistState,
                        net: dist_mod.StackedNetwork) -> dict:
    """Inverse of :func:`dist_state_from_numpy`: the leaves of
    :func:`dist_state_leaves` as numpy arrays, weights FLAT."""
    flat = _dist_weights_as(state, net, "flat")
    np_ = lambda x: x.detach().cpu().numpy()
    out = {k: np_(getattr(flat, k)) for k in DIST_STATE_LEAVES}
    out.update({f"aux.{k}": np_(v) for k, v in flat.aux.items()})
    return out


#: leaves of an LM parameter tree kept in fp32, by the end of their dotted
#: name: those the reference keeps in fp32 whatever the dtype, or widens
#: to fp32 before every use - biases (added in fp32 before the one
#: rounding), norm scales and biases, the MoE router (fp32 logits), RWKV's
#: decay base, bonus and GroupNorm, Mamba's dt bias, ``a_log`` and skip.
#: Every other leaf is a matrix, a mix or the embedding, stored in the
#: config's compute dtype (the cast every reference use applies first)
_LM_FP32_LEAVES = ("b", "scale", "bias", "router.w", "decay_base",
                   "bonus_u", "gn_scale", "gn_bias", "dt_bias_init", "a_log",
                   "d_skip")


def _lm_fp32(name: str) -> bool:
    return any(name == s or name.endswith("." + s) for s in _LM_FP32_LEAVES)


def _flatten(tree, prefix: str, out: dict) -> dict:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            arr = np.asarray(val)
            # a bf16 leaf (ml_dtypes) widens exactly to fp32 for torch
            out[name] = (arr.astype(np.float32)
                         if arr.dtype.name == "bfloat16" else arr)
    return out


def _unstack(tree, prefix: str, index, out: dict) -> dict:
    """The leaves of a tree stacked ``(n, ...)`` as ``{prefix}{index(i)}.
    <name>`` for each ``i``."""
    for name, arr in _flatten(tree, "", {}).items():
        for i in range(arr.shape[0]):
            out[f"{prefix}{index(i)}.{name}"] = arr[i]
    return out


def _lm_tensors(flat: dict, cfg, dev, fp32=()) -> dict:
    dtype = getattr(torch, cfg.dtype)
    return {name: torch.tensor(      # a copy: the tree may be read-only
        arr, device=dev,
        dtype=(torch.float32 if _lm_fp32(name) or name in fp32 else dtype))
        for name, arr in flat.items()}


def lm_params_from_numpy(params, cfg, *, device="cuda") -> dict:
    """A port ``DecoderLM`` ``state_dict`` from the reference's parameter
    tree (``repro.models.transformer.init_params``) with numpy leaves.

    The port's layers are the prefix stack's (``params["prefix"][i]`` is
    layer ``i``), then the periods': the reference stacks each period
    slot's leaves ``(n_periods, ...)``, and slot ``j`` at index ``p`` is
    layer ``n_prefix + p * len(period) + j``.  A leaf whose dotted name
    ends in one of ``_LM_FP32_LEAVES`` is stored in fp32, every other one
    in ``cfg.dtype``.  Load the result with ``DecoderLM(cfg,
    device=...).load_state_dict(...)``."""
    from repro_torch.models import transformer   # the LM face only
    dev = resolve_device(device)
    prefix, period, n_periods = transformer.period_structure(cfg)
    flat = {}
    for key in ("embed", "final_norm", "unembed"):
        if key in params:
            _flatten(params[key], key + ".", flat)
    for i in range(len(prefix)):
        _flatten(params["prefix"][i], f"layers.{i}.", flat)
    for j in range(len(period)):
        _unstack(params["period"][j], "layers.",
                 lambda p, j=j: len(prefix) + p * len(period) + j, flat)
    return _lm_tensors(flat, cfg, dev)


def encdec_params_from_numpy(params, cfg, *, device="cuda") -> dict:
    """A port ``EncDecLM`` ``state_dict`` from the reference's
    ``repro.models.encdec.init_params`` tree with numpy leaves: its
    stacked ``encoder`` / ``decoder`` leaves ``(L, ...)`` as
    ``encoder.{i}`` / ``decoder.{i}``, the rule of
    :func:`lm_params_from_numpy` for dtypes, and the token and position
    tables in fp32 (the reference adds them in fp32 before it rounds)."""
    dev = resolve_device(device)
    flat = {}
    for key in ("embed", "pos_dec", "enc_norm", "final_norm"):
        _flatten(params[key], key + ".", flat)
    for key in ("encoder", "decoder"):
        _unstack(params[key], f"{key}.", lambda i: i, flat)
    return _lm_tensors(flat, cfg, dev,
                       fp32=("embed.table", "pos_dec.table"))


def _tree_to_torch(tree, dev):
    """A nested dict of numpy arrays (or scalars) as one of tensors on
    ``dev``, each a copy in its own dtype; a bf16 leaf (ml_dtypes) stays
    bf16 (it widens exactly to fp32 on the way)."""
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, dev) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(arr, device=dev)


def classifier_params_from_numpy(params, *, device="cuda") -> dict:
    """The port ``SNNClassifier``'s params (``{"w_in", "w_out", "b_out"}``,
    tensors on ``device``) from the reference's ``SNNClassifier.init`` tree
    with numpy leaves, each in its own dtype."""
    dev = resolve_device(device)
    want = {"w_in", "w_out", "b_out"}
    if set(params) != want:
        raise ValueError(f"classifier params must have the leaves "
                         f"{sorted(want)}, got {sorted(params)}")
    return _tree_to_torch(dict(params), dev)


def opt_state_from_numpy(state, *, device="cuda") -> dict:
    """An optimizer state of :mod:`repro_torch.train.optimizer` (``m``,
    ``v``, ``master``; ``v_row``, ``v_col``; or SGD's ``m``), as nested
    dicts of tensors on ``device``, from the reference's
    ``init_opt_state``/``apply_updates`` tree with numpy leaves."""
    return _tree_to_torch(dict(state), resolve_device(device))
