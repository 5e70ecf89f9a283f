"""Fault tolerance runtime: heartbeats, straggler detection, restart policy.

The port of the reference package's ``runtime/fault.py`` (no jax there
either; kept as the port's own copy).  The monitor is tested against
simulated worker telemetry; on a cluster the same monitor consumes
per-host heartbeat RPCs (the integration point is
``HeartbeatMonitor.observe``).

Components
----------
* :class:`HeartbeatMonitor` - per-worker liveness (timeout => dead) and
  per-step duration tracking with robust straggler detection
  (> ``straggler_factor`` x running median).  The mitigation hook reports
  which workers to evict/replace; with a (pod,data,model) mesh the natural
  unit of eviction is a whole pod row.
* :class:`RestartPolicy` - bounded restarts with exponential backoff;
  decides between "resume from latest checkpoint" and "give up".
* :class:`TrainSupervisor` - wraps a step loop, feeds the monitor, saves
  periodic checkpoints, and on a (simulated) failure restores and
  continues.  Elastic re-meshing on shrink is
  :mod:`repro_torch.runtime.elastic`; the simulation's supervised loop is
  :class:`repro_torch.runtime.supervisor.SimulationSupervisor`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

__all__ = ["HeartbeatMonitor", "RestartPolicy", "TrainSupervisor"]


class HeartbeatMonitor:
    def __init__(self, n_workers: int, *, timeout_s: float = 60.0,
                 straggler_factor: float = 3.0, window: int = 32):
        self.n = n_workers
        self.timeout_s = timeout_s
        self.factor = straggler_factor
        self.last_seen = [time.monotonic()] * n_workers
        self.durations: list[deque] = [deque(maxlen=window)
                                       for _ in range(n_workers)]

    def observe(self, worker: int, step_duration_s: float,
                now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.last_seen[worker] = now
        self.durations[worker].append(step_duration_s)

    def _median_all(self) -> float:
        all_d = sorted(d for dq in self.durations for d in dq)
        return all_d[len(all_d) // 2] if all_d else 0.0

    def stragglers(self) -> list[int]:
        med = self._median_all()
        if med <= 0:
            return []
        out = []
        for w, dq in enumerate(self.durations):
            if dq and dq[-1] > self.factor * med:
                out.append(w)
        return out

    def dead(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [w for w, t in enumerate(self.last_seen)
                if now - t > self.timeout_s]

    def healthy(self, now: float | None = None) -> bool:
        return not self.dead(now)


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    #: ceiling on the exponential backoff delay; tests pin a small cap,
    #: production keeps real exponential backoff (None = uncapped)
    backoff_cap_s: float | None = 30.0
    restarts: int = 0

    def next_action(self) -> tuple[str, float]:
        """-> ("restore", delay_s) or ("abort", 0)."""
        if self.restarts >= self.max_restarts:
            return "abort", 0.0
        delay = self.backoff_s * (self.backoff_mult ** self.restarts)
        if self.backoff_cap_s is not None:
            delay = min(delay, self.backoff_cap_s)
        self.restarts += 1
        return "restore", delay


class TrainSupervisor:
    """Run ``n_steps`` of ``step_fn`` with checkpoint/restart supervision.

    ``step_fn(state, step) -> state`` must be pure w.r.t. ``state``;
    ``fail_injector(step)`` (tests only) raises to simulate a worker loss.
    """

    def __init__(self, ckpt_mgr, *, save_every: int = 50,
                 policy: RestartPolicy | None = None,
                 monitor: HeartbeatMonitor | None = None):
        self.ckpt = ckpt_mgr
        self.save_every = save_every
        self.policy = policy or RestartPolicy()
        self.monitor = monitor or HeartbeatMonitor(1)
        self.events: list[str] = []

    def run(self, state, step_fn: Callable, n_steps: int, *,
            start_step: int = 0,
            fail_injector: Callable[[int], None] | None = None):
        step = start_step
        while step < n_steps:
            try:
                t0 = time.monotonic()
                if fail_injector is not None:
                    fail_injector(step)
                state = step_fn(state, step)
                self.monitor.observe(0, time.monotonic() - t0)
                step += 1
                if step % self.save_every == 0:
                    self.ckpt.save(step, state, blocking=False,
                                   metadata={"step": step})
                    self.events.append(f"save@{step}")
            except Exception as e:  # worker failure
                action, delay = self.policy.next_action()
                self.events.append(f"fail@{step}:{type(e).__name__}")
                if action == "abort":
                    self.ckpt.wait()
                    raise RuntimeError(
                        f"exceeded max restarts at step {step}") from e
                # the policy's backoff_cap_s bounds the delay; sleep the
                # REAL capped delay and record it so telemetry shows what
                # actually happened, not what the schedule promised
                self.events.append(f"backoff@{step}:{delay:.6g}")
                time.sleep(delay)
                last = self.ckpt.latest_step()
                if last is not None:
                    state, _ = self.ckpt.restore(state)
                    step = last
                    self.events.append(f"restore@{last}")
                else:
                    step = start_step
                    self.events.append("restart@0")
        self.ckpt.wait()
        return state, step
