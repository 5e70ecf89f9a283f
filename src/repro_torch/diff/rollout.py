"""Gradient-safe engine rollout: chunks of steps under
``torch.utils.checkpoint`` (DESIGN.md §17).

The port of the reference package's ``diff/rollout.py``.  Reverse-mode AD
through ``T`` engine steps keeps every step's residuals - on the ``"flat"``
backend 23 bytes an edge a step (the int64 ring-gather index, the two
``index_add_`` sources, the arrivals ``w * arrived`` saves, three masks).  :func:`rollout` splits the
``T`` steps into chunks of ``checkpoint_every`` steps, each run under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
backward keeps one engine state per chunk boundary and recomputes one
chunk's residuals at a time.

Two things make a recomputed chunk replay the trajectory that ran:

* **The noise is drawn before the chunk.**  ``torch.utils.checkpoint``
  restores only the global CPU and CUDA RNG states, not the state's
  ``torch.Generator``.  So each chunk's drive is drawn from the generator
  ahead of it, one step at a time as
  :func:`~repro_torch.core.engine.engine_step` draws it, and passed in: the
  stream, the spikes and the generator's final state are the naive
  rollout's.
* **Sums run in a fixed order.**  On CUDA, ``index_add_`` (the flat
  sweep's per-row sums) adds with atomics in no fixed order, so a
  recomputed chunk could flip a spike that the first forward did not, and
  the backward would differentiate a trajectory that never ran.  Every
  step of a rollout that records a graph (grad mode on; the recomputed
  chunks too) runs under ``torch.use_deterministic_algorithms(True)``,
  restored afterwards.  Under ``torch.no_grad()`` nothing is recomputed or
  differentiated, and the steps keep the faster atomic sums.

The rollout is mode-agnostic: with ``cfg.surrogate`` set the spikes are
surrogate floats and the loss differentiates end to end (weights, drive
rates under ``external_drive_mode="diffusion"``, any table entry) on
``"flat"``; without it this is ``engine.run`` with another memory policy.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import backends as backends_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import neuron_models as neuron_models_mod
from repro_torch.core.device import resolve_device

__all__ = ["rollout", "grad_peak_memory_bytes"]


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block, the
    caller's setting restored after it."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _predraw(state, graph, cfg, n: int, dtype) -> dict:
    """The next ``n`` steps' drives from ``state.generator``, drawn one step
    at a time as ``engine_step`` draws them (still differentiable in
    ``graph.ext_rate``); nothing without a drive."""
    drives = [engine_mod._external_drive(state, graph, cfg, dtype)
              for _ in range(n)]
    return {} if drives[0] is None else {"drive": torch.stack(drives)}


def rollout(state, graph, table, cfg, n_steps: int, *,
            checkpoint_every: int | None = None, drive_noise=None,
            device="cuda"):
    """Step ``n_steps`` times on ``device`` (the card unless
    ``device="cpu"``); returns ``(final_state, spikes)``, ``spikes``
    ``(n_steps, n_local)`` stacked from the steps (surrogate floats when
    ``cfg.surrogate`` is set, bools otherwise).

    ``checkpoint_every`` (None = naive) runs each chunk of that many steps
    under ``torch.utils.checkpoint``; it must divide ``n_steps``.
    ``drive_noise`` (``(n_steps, n_local)``) replaces the diffusion drive's
    normal draws (how parity tests feed another package's draws).  Weights
    are carried in the backend's native layout, and the final state is
    returned AS CARRIED (no flat conversion to differentiate through).
    The caller's state is left as it was, its generator aside, which
    advances by the steps' draws.
    """
    if checkpoint_every is not None and checkpoint_every > 0:
        if n_steps % checkpoint_every:
            raise ValueError(
                f"n_steps={n_steps} must be a multiple of "
                f"checkpoint_every={checkpoint_every} (one static chunk "
                "shape; pad the horizon or pick a divisor)")
    dev = resolve_device(device)
    engine_mod._require_on(dev, weights=state.weights, ring=state.ring,
                           pre_idx=graph.pre_idx, table=table)
    engine_mod._check_step_inputs(graph, n_steps, drive_noise=drive_noise)
    backend = backends_mod.get_backend(cfg.sweep)
    layout = backend.prepare(graph)
    model = neuron_models_mod.get_model(cfg.neuron_model)
    state = engine_mod.normalize_spike_dtype(state, cfg)
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
    del w
    dtype = state.weights.dtype

    def steps(s, inputs: dict, n: int):
        bits = []
        with (_deterministic() if torch.is_grad_enabled()
              else contextlib.nullcontext()):
            for i in range(n):
                s, b = engine_mod.engine_step(
                    s, graph, table, cfg,
                    **{k: v[i] for k, v in inputs.items()},
                    backend=backend, layout=layout, model=model)
                bits.append(b)
        return s, torch.stack(bits)

    given = {} if drive_noise is None else {"drive_noise": drive_noise}
    if not checkpoint_every:
        # draws made inline by engine_step, unless given
        return steps(state, given, n_steps)

    chunks = []
    for c0 in range(0, n_steps, checkpoint_every):
        inputs = ({k: v[c0:c0 + checkpoint_every] for k, v in given.items()}
                  if given else _predraw(state, graph, cfg,
                                         checkpoint_every, dtype))
        state, bits = checkpoint(steps, state, inputs, checkpoint_every,
                                 use_reentrant=False)
        chunks.append(bits)
    return state, torch.cat(chunks)


def grad_peak_memory_bytes(loss_fn, *args) -> int:
    """Peak device memory [bytes] of one forward and backward of
    ``loss_fn(*args)`` with respect to ``args[0]``, above what was
    allocated before: ``reset_peak_memory_stats``, the forward,
    ``torch.autograd.grad``, then ``max_memory_allocated`` less the bytes
    allocated at the start.  -1 when ``args[0]`` is not on a CUDA device
    (no allocator statistics), as the reference returns -1 without memory
    statistics.

    The reference reports XLA's compiled ``temp_size_in_bytes`` instead: a
    static buffer-assignment peak.  This is the caching allocator's
    measured peak of an eager run, so the two are not the same number."""
    x = args[0]
    if x.device.type != "cuda":
        return -1
    dev = x.device
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    leaf = x.detach().requires_grad_(True)
    loss = loss_fn(leaf, *args[1:])
    torch.autograd.grad(loss, leaf)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return int(peak - base)
