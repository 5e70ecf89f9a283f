"""Session bookkeeping for the resident multi-tenant engines.

The port of the reference package's ``serve/sessions.py``, kept as its own
copy (numpy only): the state machine and admission policy of DESIGN.md §16,
engine-agnostic.  :mod:`repro_torch.serve.snn`'s
:class:`~repro_torch.serve.snn.SessionEngine` composes these records with
the slot batch; nothing here touches torch.

A session moves through four states::

            create                    admit (slot free / LRU evictee)
    [queued] -----> bounded queue  ------------------------------.
       ^                                                         v
       |  (queue full -> Backpressure, returned not raised)  [resident]
       |                                                       |    ^
       `---- close() at any state --> [closed]          evict  v    | restore
                                                           [evicted]

* **resident** - owns a slot of the fixed slot batch; its state lives at
  ``batch[slot]`` and advances when the slot is active.
* **evicted** - its state round-tripped to disk through
  ``checkpoint.manager`` (spec + seed + state IS the session); stepping it
  again restores into a slot, evicting someone else's LRU slot if needed.
* **queued** - admitted to the engine but never materialized (zero device
  cost: just ``(seed, scenario)``); waves of queued sessions are admitted
  FIFO as slots free up.
* **closed** - terminal.

Slot exhaustion is an OPERATING condition, not an error: when neither a
slot nor queue space is available, admission returns a
:class:`Backpressure` value (callers retry / shed load) instead of
raising.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

__all__ = ["Backpressure", "SessionRecord", "SessionTable", "SpikeLog",
           "RESIDENT", "EVICTED", "QUEUED", "CLOSED"]

RESIDENT = "resident"
EVICTED = "evicted"
QUEUED = "queued"
CLOSED = "closed"


@dataclasses.dataclass(frozen=True)
class Backpressure:
    """Admission/placement could not be satisfied *right now*.

    Returned (never raised) by admission paths so a serving front end can
    distinguish "shed load" from programming errors; carries enough
    telemetry to make the retry decision."""

    reason: str
    resident: int
    queued: int

    def __bool__(self) -> bool:   # admission results are falsy on refusal
        return False


class SpikeLog:
    """Bounded per-session spike history: the ``spikes(session, window)``
    stream source.

    Chunks of ``(start_step, bits (n, n_local))`` append after every step
    call; retention is capped at ``window`` most recent steps.  On a
    supervised restore the log truncates back to the committed step so the
    bit-exact replay never double-records."""

    def __init__(self, window: int):
        self.window = int(window)
        self._chunks: deque[tuple[int, np.ndarray]] = deque()
        self._steps = 0

    def append(self, start_step: int, bits: np.ndarray) -> None:
        if bits.ndim != 2:
            raise ValueError(f"bits must be (steps, n), got {bits.shape}")
        self._chunks.append((int(start_step), np.asarray(bits, dtype=bool)))
        self._steps += bits.shape[0]
        while self._chunks and (
                self._steps - self._chunks[0][1].shape[0] >= self.window):
            self._steps -= self._chunks.popleft()[1].shape[0]

    def truncate(self, step: int) -> None:
        """Drop every recorded step >= ``step`` (the restore path)."""
        while self._chunks:
            s0, bits = self._chunks[-1]
            if s0 >= step:
                self._chunks.pop()
                self._steps -= bits.shape[0]
            elif s0 + bits.shape[0] > step:
                self._chunks[-1] = (s0, bits[:step - s0])
                self._steps -= bits.shape[0] - (step - s0)
                break
            else:
                break

    def window_bits(self, window: int | None = None
                    ) -> tuple[int, np.ndarray]:
        """``(first_step, bits)`` of the last ``window`` recorded steps
        (all retained steps when None).  Empty log -> ``(0, (0, 0))``."""
        if not self._chunks:
            return 0, np.zeros((0, 0), dtype=bool)
        bits = np.concatenate([b for _, b in self._chunks], axis=0)
        first = self._chunks[0][0]
        w = bits.shape[0] if window is None else min(int(window),
                                                     bits.shape[0])
        return first + (bits.shape[0] - w), bits[bits.shape[0] - w:]

    @property
    def recorded_steps(self) -> int:
        return self._steps


@dataclasses.dataclass
class SessionRecord:
    sid: int
    seed: int
    status: str
    slot: int | None
    step: int                      # host mirror of the state's ``t``
    last_used: int                 # LRU clock tick
    created: float
    spike_log: SpikeLog
    #: step of the last committed on-disk snapshot (-1: never committed)
    committed_step: int = -1


class SessionTable:
    """Slots + LRU clock + bounded FIFO admission queue.

    Pure bookkeeping: the caller moves the actual states in and out of
    the slot batch; this table answers "which slot", "who is LRU",
    and "is there room"."""

    def __init__(self, n_slots: int, *, queue_limit: int,
                 spike_window: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.queue_limit = int(queue_limit)
        self.spike_window = int(spike_window)
        self.slots: list[int | None] = [None] * self.n_slots
        self.sessions: dict[int, SessionRecord] = {}
        self.queue: deque[int] = deque()
        self._clock = 0
        self._next_sid = 0

    # ------------------------------------------------------------- lifecycle
    def new_session(self, seed: int) -> SessionRecord:
        rec = SessionRecord(sid=self._next_sid, seed=int(seed),
                            status=QUEUED, slot=None, step=0,
                            last_used=self._tick(), created=time.time(),
                            spike_log=SpikeLog(self.spike_window))
        self._next_sid += 1
        self.sessions[rec.sid] = rec
        return rec

    def get(self, sid: int) -> SessionRecord:
        rec = self.sessions.get(sid)
        if rec is None or rec.status == CLOSED:
            raise KeyError(f"no open session {sid}")
        return rec

    def close(self, sid: int) -> SessionRecord:
        rec = self.get(sid)
        if rec.slot is not None:
            self.slots[rec.slot] = None
        if rec.status == QUEUED and rec.sid in self.queue:
            self.queue.remove(rec.sid)
        rec.status, rec.slot = CLOSED, None
        return rec

    # ------------------------------------------------------------ placement
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def touch(self, sid: int) -> None:
        self.get(sid).last_used = self._tick()

    def free_slot(self) -> int | None:
        for i, owner in enumerate(self.slots):
            if owner is None:
                return i
        return None

    def lru_resident(self, exclude: set[int] = frozenset()) -> int | None:
        """Least-recently-used resident session (the eviction victim)."""
        cands = [r for r in self.sessions.values()
                 if r.status == RESIDENT and r.sid not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda r: r.last_used).sid

    def place(self, sid: int, slot: int) -> None:
        rec = self.get(sid)
        if self.slots[slot] is not None:
            raise RuntimeError(
                f"slot {slot} still owned by session {self.slots[slot]}")
        self.slots[slot] = sid
        rec.status, rec.slot = RESIDENT, slot
        rec.last_used = self._tick()
        if sid in self.queue:
            self.queue.remove(sid)

    def displace(self, sid: int, status: str = EVICTED) -> int:
        """Take ``sid`` out of its slot -> freed slot index."""
        rec = self.get(sid)
        if rec.slot is None:
            raise RuntimeError(f"session {sid} is not resident")
        slot, rec.slot = rec.slot, None
        self.slots[slot] = None
        rec.status = status
        return slot

    # ------------------------------------------------------------ admission
    def enqueue(self, sid: int) -> bool:
        if len(self.queue) >= self.queue_limit:
            return False
        self.queue.append(sid)
        self.get(sid).status = QUEUED
        return True

    def next_queued(self) -> int | None:
        return self.queue[0] if self.queue else None

    def backpressure(self, reason: str) -> Backpressure:
        return Backpressure(
            reason=reason,
            resident=sum(1 for r in self.sessions.values()
                         if r.status == RESIDENT),
            queued=len(self.queue))

    def counts(self) -> dict[str, int]:
        out = {RESIDENT: 0, EVICTED: 0, QUEUED: 0, CLOSED: 0}
        for r in self.sessions.values():
            out[r.status] += 1
        return out
