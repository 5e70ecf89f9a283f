"""Deterministic fault injection for the simulation runtime.

The port of the reference package's ``runtime/inject.py``, with the same
grammar, environment variable and kill exit code, so that the launcher's
command line means the same in both packages.

Fault specs are tiny strings usable identically from tests, the launcher
CLI (``--fault-inject``) and CI (``REPRO_FAULT_INJECT``)::

    kind@step[:factor][#rank]

    kill@70            rank 0 dies at step 70
    kill@70#1          rank 1 dies at step 70
    hang@40#2          rank 2 stops heartbeating at step 40
    slow@10:5          rank 0 sleeps 5 x slow_unit_s at step 10
    ckpt-corrupt@35    truncate the newest committed checkpoint array

Multiple specs are comma- (or semicolon-) separated.  Every fault fires
EXACTLY ONCE: with a shared ``state_dir`` (the gang case - restarted
incarnations must not replay the kill) the claim is an ``O_CREAT|O_EXCL``
marker file on the shared filesystem; without one it is an in-process set
(the unit-test case).

``mode`` selects how a fatal fault manifests: ``"process"`` (the launcher
workers - ``kill`` is a real ``os._exit``, ``hang`` a real sleep past the
heartbeat timeout) or ``"raise"`` (in-process supervisors/tests - fatal
faults raise :class:`SimulatedFault`, which the supervision layer treats
as a worker loss).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

__all__ = ["SimulatedFault", "FaultSpec", "parse_specs", "FaultInjector",
           "ENV_VAR", "KILL_EXIT_CODE"]

#: environment variable the launcher/CI can set instead of --fault-inject
ENV_VAR = "REPRO_FAULT_INJECT"
#: exit code of an injected kill - distinguishable from organic crashes
KILL_EXIT_CODE = 117

KINDS = ("kill", "hang", "slow", "ckpt-corrupt")


class SimulatedFault(RuntimeError):
    """Raised (in ``mode="raise"``) when an injected fault fires."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    step: int
    factor: float = 1.0
    rank: int = 0

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """``kind@step[:factor][#rank]`` -> FaultSpec."""
        s = text.strip()
        rank = 0
        if "#" in s:
            s, r = s.rsplit("#", 1)
            rank = int(r)
        if "@" not in s:
            raise ValueError(f"fault spec {text!r}: expected kind@step")
        kind, rhs = s.split("@", 1)
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"fault spec {text!r}: unknown kind {kind!r} "
                f"(one of {KINDS})")
        factor = 1.0
        if ":" in rhs:
            rhs, f = rhs.split(":", 1)
            factor = float(f)
        return cls(kind=kind, step=int(rhs), factor=factor, rank=rank)

    @property
    def key(self) -> str:
        """Stable fire-once identity (also the marker filename)."""
        return f"{self.kind}@{self.step}x{self.factor:g}#{self.rank}"


def parse_specs(text: str | None) -> tuple[FaultSpec, ...]:
    if not text:
        return ()
    parts = [p for chunk in text.split(";") for p in chunk.split(",")]
    return tuple(FaultSpec.parse(p) for p in parts if p.strip())


class FaultInjector:
    """Fires the matching fault specs from inside the step loop.

    Call :meth:`fire` once per step BEFORE the step executes; a fault
    whose (step, rank) matches - and whose fire-once claim succeeds -
    executes its effect.  ``slow`` and ``ckpt-corrupt`` return control to
    the loop; ``kill``/``hang`` do not (process exit / heartbeat-silent
    sleep in ``mode="process"``, :class:`SimulatedFault` in
    ``mode="raise"``).
    """

    def __init__(self, specs, *, rank: int = 0, mode: str = "raise",
                 state_dir: str | None = None, ckpt_dir: str | None = None,
                 slow_unit_s: float = 0.05, hang_s: float = 3600.0):
        if mode not in ("raise", "process"):
            raise ValueError(f"mode {mode!r}: 'raise' or 'process'")
        self.specs = tuple(specs)
        self.rank = rank
        self.mode = mode
        self.state_dir = state_dir
        self.ckpt_dir = ckpt_dir
        self.slow_unit_s = slow_unit_s
        self.hang_s = hang_s
        self._fired: set[str] = set()
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)

    @classmethod
    def from_args(cls, spec_text: str | None, **kw) -> "FaultInjector | None":
        """Injector from a CLI spec string, falling back to $REPRO_FAULT_
        INJECT; None when neither is set (zero overhead in the loop)."""
        text = spec_text or os.environ.get(ENV_VAR)
        specs = parse_specs(text)
        return cls(specs, **kw) if specs else None

    # ---------------------------------------------------------------- firing
    def _claim(self, spec: FaultSpec) -> bool:
        """True exactly once per spec across every incarnation/instance
        sharing ``state_dir`` (O_CREAT|O_EXCL is atomic on a shared fs)."""
        if self.state_dir is None:
            if spec.key in self._fired:
                return False
            self._fired.add(spec.key)
            return True
        path = os.path.join(self.state_dir, spec.key + ".fired")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.write(fd, f"{time.time()}\n".encode())
        os.close(fd)
        return True

    def fire(self, step: int) -> None:
        for spec in self.specs:
            if spec.step != step or spec.rank != self.rank:
                continue
            if not self._claim(spec):
                continue
            self._execute(spec, step)

    def _execute(self, spec: FaultSpec, step: int) -> None:
        if spec.kind == "slow":
            time.sleep(self.slow_unit_s * spec.factor)
            return
        if spec.kind == "ckpt-corrupt":
            self._corrupt_checkpoint()
            return
        if spec.kind == "kill":
            if self.mode == "process":
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(KILL_EXIT_CODE)
            raise SimulatedFault(f"injected kill at step {step} "
                                 f"(rank {spec.rank})")
        if spec.kind == "hang":
            if self.mode == "process":
                # stop heartbeating without exiting: the supervisor must
                # detect this via heartbeat timeout, not an exit code
                time.sleep(self.hang_s)
                os._exit(KILL_EXIT_CODE)
            raise SimulatedFault(f"injected hang at step {step} "
                                 f"(rank {spec.rank})")

    def _corrupt_checkpoint(self) -> None:
        """Truncate the largest array of the newest committed checkpoint.

        Plain os-level damage (no CheckpointManager import): the restore
        path must recover from EXTERNAL corruption, so the injector must
        not share code with the thing under test.
        """
        if self.ckpt_dir is None or not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(
            n for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        if not steps:
            return
        d = os.path.join(self.ckpt_dir, steps[-1])
        arrs = sorted(n for n in os.listdir(d) if n.endswith(".npy"))
        if not arrs:
            return
        target = os.path.join(
            d, max(arrs, key=lambda n: os.path.getsize(os.path.join(d, n))))
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
