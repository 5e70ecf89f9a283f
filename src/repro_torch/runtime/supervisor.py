"""Fault-tolerant SIMULATION runtime: the supervised step loop.

The port of the reference package's ``runtime/supervisor.py``.
:class:`SimulationSupervisor` wraps any per-step engine - the single-shard
``engine.engine_step``, the stacked distributed step, or the
multi-process multihost step - with:

* **periodic async checkpointing** through a
  :class:`repro_torch.checkpoint.manager.CheckpointManager`, with
  ``network_metadata``-style metadata so every snapshot is a complete
  spec+seed+state network identity;
* **heartbeat files** (:class:`HeartbeatFile`) an external gang supervisor
  (``repro_torch.launch.multihost``) watches to detect hung workers;
* **deterministic fault injection** (:mod:`repro_torch.runtime.inject`) fired at
  the top of each step;
* **policy-driven recovery**: with a ``restore_fn`` the supervisor catches
  the failure, backs off per :class:`repro_torch.runtime.fault.RestartPolicy`
  (real capped-exponential delays, recorded in ``events``/``delays``) and
  resumes from the latest committed checkpoint; without one (the gang
  worker case) the failure propagates so the PROCESS dies and the launcher
  restarts the whole gang.

The hooks keep the loop collective-safe in a multi-process program: every
rank runs the same schedule (same ``save_every``, same ``snapshot_fn``
collectives); only ranks holding a ``ckpt`` manager write bytes.

The train-loop twin (simulated telemetry, LM half) remains
:class:`repro_torch.runtime.fault.TrainSupervisor`; this module is the
simulation runtime whose resumed runs are pinned bit-exactly against
uninterrupted ones.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

from repro_torch.runtime.fault import RestartPolicy

__all__ = ["HeartbeatFile", "SimulationSupervisor"]


class HeartbeatFile:
    """Per-worker liveness file: ``<dir>/hb_<rank>`` touched every step.

    The watcher side reads file mtimes (:meth:`ages`): a worker whose
    heartbeat is older than the timeout - or that never beat at all - is
    presumed hung.  Writes are write-then-rename so a reader never sees a
    partial file even on a shared filesystem.
    """

    def __init__(self, directory: str, rank: int):
        self.dir = directory
        self.rank = rank
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"hb_{rank:05d}")

    def beat(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{time.time()}\n")
        os.replace(tmp, self.path)

    @staticmethod
    def ages(directory: str, now: float | None = None) -> dict[int, float]:
        """rank -> seconds since last beat, for every hb file present."""
        now = time.time() if now is None else now
        out: dict[int, float] = {}
        if not os.path.isdir(directory):
            return out
        for n in os.listdir(directory):
            if not n.startswith("hb_") or n.endswith(".tmp"):
                continue
            try:
                rank = int(n.split("_")[1])
                out[rank] = now - os.path.getmtime(
                    os.path.join(directory, n))
            except (ValueError, OSError):
                continue
        return out


class SimulationSupervisor:
    """Run ``n_steps`` of a simulation step function under supervision.

    Parameters
    ----------
    ckpt:
        CheckpointManager, or None on ranks that must not write (they
        still run ``snapshot_fn`` - it may contain collectives every rank
        must join).
    save_every:
        checkpoint period in steps (0/None disables saving).
    policy:
        RestartPolicy consulted when a step fails AND ``restore_fn`` is
        set; restart delays are the policy's real capped-exponential
        backoff, recorded in ``delays``.
    heartbeat:
        HeartbeatFile beaten once before the loop and after every step.
    injector:
        FaultInjector fired at the top of every step (before the step
        function), so an injected fault lands between committed states.
    snapshot_fn:
        ``state -> tree`` host-side snapshot passed to ``ckpt.save``
        (e.g. :func:`repro_torch.core.multihost.snapshot_host_state`);
        identity when None.  The port's steps advance their state in
        place, so a snapshot must be a host COPY taken here, before the
        next step runs (``CheckpointManager.save`` copies tensors to the
        host synchronously).  Runs on EVERY rank at every save step.
    metadata_fn:
        ``(step, state) -> dict`` checkpoint metadata (use
        ``checkpoint.manager.network_metadata`` for a full network
        identity); defaults to ``{"step": step}``.
    pre_save:
        ``(step, state) -> None`` called right before ``ckpt.save`` - the
        hook where the launcher worker flushes its trajectory prefix so
        checkpoint and trajectory commit together.
    restore_fn:
        ``state -> (state, step)`` in-process recovery (single-process
        supervision); None means failures propagate to the process
        boundary (gang supervision).
    on_step:
        ``(step, state, out) -> None`` called after every step with the
        step function's auxiliary output (e.g. spike bits).

    ``step_fn(state, step) -> (state, out)``.
    """

    def __init__(self, ckpt, *, save_every: int | None = 50,
                 policy: RestartPolicy | None = None,
                 heartbeat: HeartbeatFile | None = None,
                 injector=None,
                 snapshot_fn: Callable[[Any], Any] | None = None,
                 metadata_fn: Callable[[int, Any], dict] | None = None,
                 pre_save: Callable[[int, Any], None] | None = None,
                 restore_fn=None):
        self.ckpt = ckpt
        self.save_every = save_every or 0
        self.policy = policy or RestartPolicy()
        self.heartbeat = heartbeat
        self.injector = injector
        self.snapshot_fn = snapshot_fn
        self.metadata_fn = metadata_fn
        self.pre_save = pre_save
        self.restore_fn = restore_fn
        self.events: list[str] = []
        self.delays: list[float] = []

    # ------------------------------------------------------------------ loop
    def run(self, state, step_fn: Callable, n_steps: int, *,
            start_step: int = 0,
            on_step: Callable[[int, Any, Any], None] | None = None,
            final_save: bool = False):
        """-> (final_state, final_step).  Bit-exact contract: a supervised
        run that failed and resumed from a checkpoint produces the same
        trajectory as an uninterrupted run (the replayed steps recompute
        identical values from the restored state).

        ``final_save`` commits once more at loop exit when ``n_steps`` is
        not on the ``save_every`` grid - callers whose commit point doubles
        as an external consistency boundary (the session engine: every
        resident session's last step must be on disk when the run returns)
        set it so the tail steps are never lost."""
        step = start_step
        if self.heartbeat is not None:
            self.heartbeat.beat()
        while step < n_steps:
            try:
                if self.injector is not None:
                    self.injector.fire(step)
                state, out = step_fn(state, step)
                step += 1
                if on_step is not None:
                    on_step(step, state, out)
                if self.heartbeat is not None:
                    self.heartbeat.beat()
                if self.save_every and step % self.save_every == 0:
                    self._save(step, state)
            except Exception as e:
                if self.restore_fn is None:
                    raise  # gang mode: die, the launcher restarts us
                action, delay = self.policy.next_action()
                self.events.append(f"fail@{step}:{type(e).__name__}")
                if action == "abort":
                    self._settle()
                    raise RuntimeError(
                        f"exceeded max restarts at step {step}") from e
                self.delays.append(delay)
                self.events.append(f"backoff@{step}:{delay:.6g}")
                time.sleep(delay)
                state, step = self.restore_fn(state)
                self.events.append(f"restore@{step}")
        if final_save and not (self.save_every
                               and step % self.save_every == 0):
            self._save(step, state)
        self._settle()
        return state, step

    # ----------------------------------------------------------------- hooks
    def _save(self, step: int, state) -> None:
        # snapshot on EVERY rank (may be a collective), write on writers
        snap = (self.snapshot_fn(state) if self.snapshot_fn is not None
                else state)
        if self.pre_save is not None:
            self.pre_save(step, state)
        if self.ckpt is not None:
            md = (self.metadata_fn(step, state)
                  if self.metadata_fn is not None else {"step": step})
            self.ckpt.save(step, snap, metadata=md, blocking=False)
            self.events.append(f"save@{step}")

    def _settle(self) -> None:
        if self.ckpt is not None:
            self.ckpt.wait()
