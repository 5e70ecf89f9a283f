"""Resident multi-tenant SNN serving: the session engine (DESIGN.md §16).

The port of the reference package's ``serve/snn.py``.  The
indegree-decomposition consts are a pure read-only function of the
topology, so MANY independent simulation instances of the same scenario
can share ONE graph, ONE table and ONE resolved backend - memory scales
with per-instance :class:`~repro_torch.core.engine.EngineState`, not
topology.  :class:`SessionEngine` turns that into infrastructure:

* **one scenario, many sessions** - the engine binds to a single network
  identity (``models.scenario_id``) on the first ``create``; every session
  is just ``(seed, state)`` in one slot of the fixed
  :class:`~repro_torch.core.engine.SlotBatch` of
  :func:`repro_torch.core.engine.make_session_step_fn`.
* **slot allocation with an active mask** - the slot step runs only the
  active slots, so idle slots stay bit-for-bit frozen and a session
  stepped inside ANY admission pattern computes exactly its solo
  trajectory (same ``engine_step``, same kernels).
* **wave admission with a bounded queue** - when every slot is resident,
  ``create`` parks new sessions in a FIFO queue (zero device cost) and
  promotes them in waves as slots free; a full queue returns a
  :class:`~repro_torch.serve.sessions.Backpressure` VALUE, never raises.
* **LRU eviction through the checkpoint manager** - a session is exactly
  spec + seed + state (``session_metadata``), so evicting one is a
  blocking ``CheckpointManager.save`` of its flat-layout state (the drive
  generator's state included) and restoring it is the bit-exact
  round-trip into a free slot.
* **supervised residency** - :meth:`SessionEngine.run_supervised` drives
  every resident session under
  :class:`repro_torch.runtime.supervisor.SimulationSupervisor`; a crash
  restores EVERY resident session from its last committed snapshot and
  replays bit-exactly.

Every slot owns its tensors and its ``torch.Generator``: each session is
a fresh ``init_state`` of its seed, never a template shared between
slots (torch tensors alias where the reference's arrays cannot, and the
gated backend updates weights in place).

Cost model: a step of ``n`` slots is ``n`` solo steps, one slot after the
other, so aggregate session-steps/s does not grow with residency (a slot
axis in the kernels' grid would be one launch for all residents).  The
spike bits reach the host once per :meth:`SessionEngine.step` /
:meth:`SessionEngine.step_wave` call.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, session_metadata
from repro_torch.core import backends, builder, engine, models
from repro_torch.core import neuron_models
from repro_torch.core.device import resolve_device
from repro_torch.core.stdp import STDPParams
from repro_torch.runtime.supervisor import SimulationSupervisor
from repro_torch.serve.sessions import (EVICTED, RESIDENT, Backpressure,
                                        SessionTable)

__all__ = ["SessionEngine"]


class SessionEngine:
    """Persistent multi-tenant front door over the single-shard engine.

    Parameters
    ----------
    max_sessions:
        slot count of the slot batch - the resident capacity.  Device
        memory is ``max_sessions x`` one EngineState (consts shared).
    sweep:
        execution backend of the shared step (``"cuda"``, ``"cuda:sparse"``,
        ``"cuda:sparse:<rate>"`` or ``"flat"``); an unported name raises.
    queue_limit:
        bounded admission queue length (default ``2 * max_sessions``).
    ckpt_dir:
        root for per-session checkpoint dirs
        (``<ckpt_dir>/session_<sid:05d>``).  Required for LRU eviction and
        :meth:`run_supervised`; without it a full engine queues and then
        backpressures instead of evicting.
    spike_window:
        per-session host-side spike retention in steps (the
        ``spikes(sid, window)`` stream buffer).
    device:
        the card unless ``device="cpu"``; raises without one.
    """

    def __init__(self, *, max_sessions: int = 8, sweep: str = "cuda",
                 dt: float = 0.1, queue_limit: int | None = None,
                 ckpt_dir: str | None = None, spike_window: int = 512,
                 keep: int = 2, dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        backends.get_backend(sweep)          # an unknown name raises here
        self.max_sessions = int(max_sessions)
        self.sweep = sweep
        self.dt = float(dt)
        self.ckpt_dir = ckpt_dir
        self.keep = int(keep)
        self.dtype = dtype
        self.table = SessionTable(
            self.max_sessions,
            queue_limit=(2 * self.max_sessions if queue_limit is None
                         else queue_limit),
            spike_window=spike_window)
        # bound on first create()
        self.spec = None
        self.stdp: STDPParams | None = None
        self.scenario_id: str | None = None
        self.graph: engine.ShardGraph | None = None
        self.param_table: torch.Tensor | None = None
        self.cfg: engine.EngineConfig | None = None
        self.ctx: engine.StepContext | None = None
        self._step_fn = None
        self._batch: engine.SlotBatch | None = None
        self._active = np.zeros(self.max_sessions, dtype=bool)
        self._mgrs: dict[int, CheckpointManager] = {}
        self._committed_sup_step = 0

    # ------------------------------------------------------------------ bind
    def _bind(self, spec, stdp: STDPParams | None, scen_id: str) -> None:
        """First ``create``: build the graph and table once, resolve ONE
        slot step; every slot starts empty."""
        graph = builder.build_shards(
            spec, builder.decompose(spec, 1))[0].to(self.device)
        table = neuron_models.get_model(spec.neuron_model).make_param_table(
            list(spec.groups), dt=self.dt, device=self.device)
        cfg = engine.EngineConfig(dt=self.dt, stdp=stdp, sweep=self.sweep,
                                  neuron_model=spec.neuron_model)
        self._step_fn, self.ctx = engine.make_session_step_fn(
            graph, table, cfg, self.max_sessions)
        self.spec, self.stdp, self.scenario_id = spec, stdp, scen_id
        self.graph, self.param_table, self.cfg = graph, table, cfg
        self._batch = engine.stack_states([None] * self.max_sessions)

    def _check_bound(self, scen_id: str, stdp) -> None:
        if self.scenario_id is None:
            return
        if scen_id != self.scenario_id or stdp != self.stdp:
            raise ValueError(
                "a SessionEngine serves ONE scenario (consts sharing is "
                f"the point): bound to {self.scenario_id}, got {scen_id}. "
                "Spin up another engine for a different network.")

    # ------------------------------------------------------------ session api
    def create(self, scenario="brunel", seed: int = 0,
               **scenario_kwargs) -> "int | Backpressure":
        """Open a session -> session id, or :class:`Backpressure` when
        neither a free slot nor queue space exists.

        ``scenario`` is a zoo name (kwargs forwarded, e.g.
        ``create("brunel", seed=3, scale=0.02)``) or a ``NetworkSpec``.
        Every session of one engine must resolve to the SAME scenario
        identity; the seed is what makes sessions distinct.
        """
        spec, stdp, scen_id = models.resolve_scenario(scenario,
                                                      **scenario_kwargs)
        self._check_bound(scen_id, stdp)
        if self.scenario_id is None:
            self._bind(spec, stdp, scen_id)
        rec = self.table.new_session(seed)
        # admission only claims a FREE slot - evicting a resident to seat a
        # brand-new session would thrash; the queue absorbs the burst and
        # eviction happens on demand when a parked session is stepped
        slot = self.table.free_slot()
        if slot is not None:
            self._materialize(rec, slot)
            return rec.sid
        if self.table.enqueue(rec.sid):
            return rec.sid
        bp = self.table.backpressure(
            f"admission refused: {self.max_sessions} slots resident, "
            f"queue at limit {self.table.queue_limit}")
        del self.table.sessions[rec.sid]   # admission failed: no record
        return bp

    def step(self, sid: int, n: int = 1, *, drive=None, model_uniform=None
             ) -> "np.ndarray | Backpressure":
        """Advance ONE session ``n`` dt -> its spike bits
        ``(n, n_local) bool`` (other residents stay frozen).
        ``drive``/``model_uniform`` (``(n, n_local)``) replace the
        session's own draws.  Backpressure when the session cannot be made
        resident."""
        got = self._run_wave([sid], n, {sid: drive}, {sid: model_uniform})
        return got if isinstance(got, Backpressure) else got[sid]

    def step_wave(self, sids=None, n: int = 1, *, drive=None,
                  model_uniform=None
                  ) -> "dict[int, np.ndarray] | Backpressure":
        """Advance a wave of sessions TOGETHER -> ``{sid: (n, n_local)
        bool}``.  ``sids=None`` steps every resident session; an explicit
        list is made resident first (members of the wave are never evicted
        to place each other).  ``drive``/``model_uniform`` are ``{sid:
        (n, n_local)}`` maps covering every session of the wave."""
        if sids is None:
            sids = [s for s, r in self.table.sessions.items()
                    if r.status == RESIDENT]
        if not sids:
            return {}
        return self._run_wave(list(sids), n, drive or {},
                              model_uniform or {})

    def _run_wave(self, sids, n, drive: dict, uniform: dict):
        pinned = frozenset(sids)
        for sid in sids:
            got = self._ensure_resident(sid, exclude=pinned)
            if isinstance(got, Backpressure):
                return got
        slots = {sid: self.table.get(sid).slot for sid in sids}
        mask = np.zeros(self.max_sessions, dtype=bool)
        mask[list(slots.values())] = True
        bits = self._advance(mask, n, self._by_slot("drive", drive, slots, n),
                             self._by_slot("model_uniform", uniform, slots,
                                           n))
        return {sid: bits[:, slot, :] for sid, slot in slots.items()}

    def _by_slot(self, name: str, per_sid: dict, slots: dict, n: int):
        """``{sid: (n, n_local)}`` -> the slot step's ``(n, max_sessions,
        n_local)`` input, or None when no session of the wave has one."""
        given = {sid: x for sid, x in per_sid.items() if x is not None}
        if not given:
            return None
        if set(given) != set(slots):
            raise ValueError(f"{name} must be given for every session of "
                             f"the wave {sorted(slots)} or for none, got "
                             f"{sorted(given)}")
        first = next(iter(given.values()))
        out = torch.zeros((n, self.max_sessions, self.graph.n_local),
                          dtype=first.dtype, device=self.device)
        for sid, x in given.items():
            if tuple(x.shape) != (n, self.graph.n_local):
                raise ValueError(f"{name} of session {sid} must be "
                                 f"{(n, self.graph.n_local)}, got "
                                 f"{tuple(x.shape)}")
            out[:, slots[sid]] = x
        return out

    def spikes(self, sid: int, window: int | None = None
               ) -> tuple[int, np.ndarray]:
        """Stream the session's recorded spikes: ``(first_step, bits
        (w, n_local) bool)`` for the last ``window`` recorded steps (all
        retained when None).  Works in every non-closed state - the log is
        host-side and survives eviction."""
        return self.table.get(sid).spike_log.window_bits(window)

    def snapshot(self, sid: int) -> tuple[engine.EngineState, dict]:
        """``(flat-layout EngineState, checkpoint metadata)`` of the
        session as of its last completed step - the state + identity an
        eviction would commit, as a copy that shares nothing with the
        slot."""
        rec = self.table.get(sid)
        if rec.status == RESIDENT:
            state = self._extract_flat(rec.slot)
        elif rec.status == EVICTED:
            state, _ = self._mgr(sid).restore(
                self._flat_target(rec.seed),
                rec.committed_step if rec.committed_step >= 0 else None)
        else:  # queued: never materialized -> its (deterministic) t=0 state
            state = self._flat_target(rec.seed)
        return engine.clone_state(state), self._metadata(sid, rec)

    def close(self, sid: int) -> None:
        """Terminal: free the slot (if resident) and promote queued
        sessions into whatever capacity opened up (wave admission)."""
        rec = self.table.get(sid)
        if rec.slot is not None:
            self._vacate(rec.slot)
        self.table.close(sid)
        self._pump()

    # ------------------------------------------------------------- telemetry
    def session_info(self, sid: int) -> dict:
        rec = self.table.get(sid)
        info = dict(sid=sid, seed=rec.seed, status=rec.status,
                    slot=rec.slot, step=rec.step,
                    committed_step=rec.committed_step,
                    recorded_steps=rec.spike_log.recorded_steps)
        if rec.status == RESIDENT:
            # per-slot telemetry (gate saturation); one device read
            info["gate_overflow"] = int(
                engine.slot_state(self._batch, rec.slot).gate_overflow)
        return info

    def stats(self) -> dict:
        out = self.table.counts()
        out["slots"] = self.max_sessions
        out["queue_limit"] = self.table.queue_limit
        out["scenario_id"] = self.scenario_id
        return out

    # ---------------------------------------------------------- resident set
    def _materialize(self, rec, slot: int) -> None:
        """Fresh (never-stepped) session -> slot: ``init_state`` of its
        seed in the backend's native layout, with its own tensors and its
        own generator."""
        self._place(rec, slot, self.ctx.init_state(
            list(self.spec.groups), rec.seed, dtype=self.dtype))

    def _place(self, rec, slot: int, state: engine.EngineState) -> None:
        self._batch = engine.set_slot_state(self._batch, slot, state)
        self._active[slot] = True
        self.table.place(rec.sid, slot)

    def _vacate(self, slot: int) -> None:
        """Drop the slot's state (its device memory goes with it)."""
        self._batch = engine.set_slot_state(self._batch, slot, None)
        self._active[slot] = False

    def _ensure_resident(self, sid: int,
                         exclude: frozenset = frozenset()
                         ) -> "int | Backpressure":
        rec = self.table.get(sid)
        if rec.status == RESIDENT:
            self.table.touch(sid)
            return rec.slot
        slot = self._acquire_slot(exclude=exclude | {sid})
        if slot is None:
            return self.table.backpressure(
                f"session {sid} cannot be placed: no free slot and no "
                "evictable resident"
                + ("" if self.ckpt_dir else " (no ckpt_dir: eviction off)"))
        if rec.status == EVICTED:
            self._restore_into(rec, slot)
        else:                      # queued -> first materialization
            self._materialize(rec, slot)
        return slot

    def _acquire_slot(self, exclude) -> int | None:
        slot = self.table.free_slot()
        if slot is not None:
            return slot
        if self.ckpt_dir is None:
            return None
        victim = self.table.lru_resident(exclude)
        if victim is None:
            return None
        return self._evict(victim)

    def _evict(self, sid: int) -> int:
        """Blocking commit of the victim's flat state, then free its slot.
        Eviction IS a checkpoint: spec + seed + state round-trip through
        the manager."""
        rec = self.table.get(sid)
        self._save(sid, rec)
        slot = self.table.displace(sid, status=EVICTED)
        self._vacate(slot)
        return slot

    def _save(self, sid: int, rec) -> None:
        self._mgr(sid).save(rec.step, self._extract_flat(rec.slot),
                            metadata=self._metadata(sid, rec),
                            blocking=True)
        rec.committed_step = rec.step

    def _metadata(self, sid: int, rec) -> dict:
        return session_metadata(self.spec, seed=rec.seed, session_id=sid,
                                 step=rec.step,
                                 extra={"scenario_id": self.scenario_id})

    def _native(self, state: engine.EngineState) -> engine.EngineState:
        return engine.state_with_weights_layout(
            state, self.graph, self.ctx.backend.weights_layout,
            backend=self.ctx.backend)

    def _restore_into(self, rec, slot: int) -> None:
        state, md = self._mgr(rec.sid).restore(
            self._flat_target(rec.seed),
            rec.committed_step if rec.committed_step >= 0 else None)
        rec.step = int(md["session"]["step"])
        self._place(rec, slot, self._native(state))

    def _pump(self) -> None:
        """Wave admission: promote queued sessions FIFO into free slots."""
        while True:
            sid = self.table.next_queued()
            if sid is None:
                return
            slot = self.table.free_slot()
            if slot is None:
                return
            self._materialize(self.table.get(sid), slot)

    # ------------------------------------------------------------- internals
    def _advance(self, mask: np.ndarray, n: int, drive=None,
                 model_uniform=None) -> np.ndarray:
        """Run ``n`` slot steps of the active slots; record + return host
        bits ``(n, max_sessions, n_local)`` (one copy to the host)."""
        self._batch, bits = self._step_fn(self._batch, mask, n, drive=drive,
                                          model_uniform=model_uniform)
        host = bits.cpu().numpy()
        for slot in np.flatnonzero(mask):
            rec = self.table.get(self.table.slots[slot])
            rec.spike_log.append(rec.step, host[:, slot, :])
            rec.step += n
            rec.last_used = self.table._tick()
        return host

    def _extract_flat(self, slot: int) -> engine.EngineState:
        return engine.state_with_weights_layout(
            engine.slot_state(self._batch, slot), self.graph, "flat",
            backend=self.ctx.backend)

    def _flat_target(self, seed: int) -> engine.EngineState:
        """Flat-layout state skeleton matching the committed tree (its
        generator on the engine's device, as the saved one was)."""
        return engine.init_state(self.graph, list(self.spec.groups), seed,
                                 dtype=self.dtype,
                                 neuron_model=self.cfg.neuron_model,
                                 device=self.device)

    def _mgr(self, sid: int) -> CheckpointManager:
        if self.ckpt_dir is None:
            raise RuntimeError(
                "this SessionEngine has no ckpt_dir: eviction and "
                "supervised running need per-session checkpoints")
        mgr = self._mgrs.get(sid)
        if mgr is None:
            mgr = CheckpointManager(
                os.path.join(self.ckpt_dir, f"session_{sid:05d}"),
                keep=self.keep)
            self._mgrs[sid] = mgr
        return mgr

    # ------------------------------------------------------------ supervision
    def _commit_all(self, sup_step: int) -> None:
        """Blocking snapshot of EVERY resident session at its own step -
        the supervised run's commit point."""
        for sid, rec in self.table.sessions.items():
            if rec.status == RESIDENT:
                self._save(sid, rec)
        self._committed_sup_step = sup_step

    def _restore_resident(self, _state):
        """Supervisor ``restore_fn``: reload every resident session from
        its last committed snapshot (never-committed ones rewind to their
        t=0 state and a fresh generator) and truncate spike logs past the
        commit - the replayed steps re-record identical bits."""
        for sid, rec in self.table.sessions.items():
            if rec.status != RESIDENT:
                continue
            if rec.committed_step >= 0:
                state, md = self._mgr(sid).restore(
                    self._flat_target(rec.seed), rec.committed_step)
                rec.step = int(md["session"]["step"])
            else:
                state = self._flat_target(rec.seed)
                rec.step = 0
            self._batch = engine.set_slot_state(self._batch, rec.slot,
                                                self._native(state))
            rec.spike_log.truncate(rec.step)
        return self._batch, self._committed_sup_step

    def run_supervised(self, n_steps: int, *, save_every: int = 20,
                       policy=None, injector=None, heartbeat=None,
                       on_step=None) -> SimulationSupervisor:
        """Drive every resident session ``n_steps`` dt under
        :class:`SimulationSupervisor` (Layer 3 of DESIGN.md §16).

        The supervisor's commit point (``save_every``, plus a final
        commit) is a blocking save of ALL resident sessions; an injected
        or real crash restores the whole resident set from the last commit
        and replays bit-exactly.  Returns the supervisor (its ``events`` /
        ``delays`` are the fault-handling telemetry).
        """
        if self._batch is None:
            raise RuntimeError("no sessions: create() before supervising")
        if self.ckpt_dir is None:
            raise RuntimeError(
                "run_supervised needs ckpt_dir (the commit target)")
        self._committed_sup_step = 0
        mask = self._active.copy()
        resident = [(sid, rec.slot) for sid, rec in
                    self.table.sessions.items() if rec.status == RESIDENT]

        def step_fn(batch, step):
            self._batch, bits = self._step_fn(batch, mask, 1)
            host = bits.cpu().numpy()
            for sid, slot in resident:
                rec = self.table.get(sid)
                rec.spike_log.append(rec.step, host[:, slot, :])
                rec.step += 1
            return self._batch, bits

        sup = SimulationSupervisor(
            None, save_every=save_every, policy=policy, injector=injector,
            heartbeat=heartbeat,
            pre_save=lambda step, _state: self._commit_all(step),
            restore_fn=self._restore_resident)
        self._batch, _ = sup.run(self._batch, step_fn, n_steps,
                                 on_step=on_step, final_save=True)
        return sup
