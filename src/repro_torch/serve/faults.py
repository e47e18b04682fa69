"""Fault injection for the simulated cloud-edge channel.

Counterpart of ``repro.serve.faults``, whole: the same seeded RNG
(``np.random.default_rng``, three uniforms per unscripted attempt), so
a seed draws the same faults here as there.

``FaultyChannel`` wraps any channel (``costmodel.Channel`` or
``transport.DriftingChannel`` — anything duck-typing ``transfer_time``)
and injects message **drops**, payload **corruption**, tail-latency
**stalls**, and hard **outage windows**, either from a seeded RNG or
from an explicit per-message script.  All of it plays out on the
wrapper's simulated clock (``clock_s``), which only advances through
transfers and explicit ``wait`` calls — the same convention
``DriftingChannel`` uses — so fault schedules are deterministic and
replayable.

Two consumption modes:

* ``attempt(nbytes)`` — one send attempt with the failure *exposed*:
  returns a ``FaultOutcome`` and never blocks past the attempt itself.
  A dropped message (or one inside an outage window) costs the sender
  nothing here — the sender discovers the loss by its own deadline and
  pays for it via ``wait`` (``transport.ReliableTransport``).
* ``transfer_time(nbytes)`` — the naive blocking semantics the
  collaborative engine's plain ``Transport`` assumes: retry forever on
  a fixed ``rto_s`` until the message lands, so a cloud outage simply
  *stalls* the caller for the remainder of the window.  The overload
  engines use a fault-free ``FaultyChannel`` as their clocked channel.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FaultOutcome", "FaultyChannel", "PressureSchedule"]


@dataclasses.dataclass(frozen=True)
class FaultOutcome:
    """One send attempt: did it arrive, did it arrive intact, and how
    much simulated time the *attempt* consumed on the sender's clock
    (0 for a silent drop — the sender only learns at its deadline)."""
    delivered: bool
    corrupt: bool
    seconds: float
    kind: str = "ok"             # ok | drop | corrupt | stall | outage


class FaultyChannel:
    """Wrap ``base`` with seeded or scripted faults.

    ``drop_p`` / ``corrupt_p`` / ``stall_p`` are independent per-message
    probabilities drawn from ``np.random.default_rng(seed)``;
    ``stall_s`` is added to a stalled message's transfer time (late
    arrival — a deadline-driven sender counts it as a miss).
    ``outages`` are hard ``(t0_s, t1_s)`` windows on the simulated
    clock during which nothing is delivered.  ``script`` overrides the
    RNG with an explicit event list (``"ok"``/``"drop"``/``"corrupt"``/
    ``"stall"``), consumed one entry per attempt; when it runs dry the
    channel falls back to the seeded probabilities (outage windows apply
    in both modes).
    """

    def __init__(self, base, *, seed: Optional[int] = 0,
                 drop_p: float = 0.0, corrupt_p: float = 0.0,
                 stall_p: float = 0.0, stall_s: float = 0.25,
                 outages: Sequence[Tuple[float, float]] = (),
                 script: Optional[Sequence[str]] = None,
                 rto_s: float = 1.0):
        self.base = base
        self.drop_p, self.corrupt_p, self.stall_p = drop_p, corrupt_p, stall_p
        self.stall_s = stall_s
        self.outages = [(float(a), float(b)) for a, b in outages]
        if not all(b > a for a, b in self.outages):
            raise ValueError(f"empty outage window in {self.outages}")
        self._script: List[str] = list(script or [])
        self._rng = np.random.default_rng(seed)
        self.rto_s = rto_s
        self.clock_s = 0.0
        self.attempts = 0
        self.faults = {"drop": 0, "corrupt": 0, "stall": 0, "outage": 0}

    # -- the underlying link -------------------------------------------------
    @property
    def phase(self):
        """The base channel's current conditions (a ``Channel``) — what
        a site survey at this instant would measure.  Engines use it to
        seed their offline tune, exactly as for ``DriftingChannel``."""
        base = self.base
        if hasattr(base, "phase"):            # DriftingChannel: sync clocks
            base.clock_s = self.clock_s
            return base.phase
        return base

    @property
    def name(self) -> str:
        return f"faulty[{getattr(self.base, 'name', '?')}]"

    def _base_time(self, nbytes: float) -> float:
        # never call DriftingChannel.transfer_time here — it advances its
        # own clock; this wrapper owns the clock and mirrors it across
        return self.phase.transfer_time(nbytes)

    # -- fault model ---------------------------------------------------------
    def in_outage(self, t: Optional[float] = None) -> bool:
        t = self.clock_s if t is None else t
        return any(a <= t < b for a, b in self.outages)

    def outage_end(self, t: Optional[float] = None) -> Optional[float]:
        t = self.clock_s if t is None else t
        for a, b in self.outages:
            if a <= t < b:
                return b
        return None

    def wait(self, seconds: float) -> None:
        """Sender-side time passing (deadline expiry, retry backoff)."""
        self.clock_s += max(0.0, float(seconds))

    def attempt(self, nbytes: float) -> FaultOutcome:
        """One send attempt at the current simulated time."""
        self.attempts += 1
        kind = "ok"
        if self.in_outage():
            kind = "outage"
        elif self._script:
            kind = self._script.pop(0)
        else:
            u = self._rng.random(3)
            if u[0] < self.drop_p:
                kind = "drop"
            elif u[1] < self.corrupt_p:
                kind = "corrupt"
            elif u[2] < self.stall_p:
                kind = "stall"
        if kind in ("drop", "outage"):
            self.faults[kind] += 1
            return FaultOutcome(False, False, 0.0, kind)
        t = self._base_time(nbytes)
        if kind == "stall":
            t += self.stall_s
        self.clock_s += t
        if kind != "ok":
            self.faults[kind] += 1
        return FaultOutcome(True, kind == "corrupt", t, kind)

    # -- naive blocking semantics (the baseline engines') --------------------
    def transfer_time(self, nbytes: float) -> float:
        """Deliver-or-die: retry on a fixed ``rto_s`` until the message
        lands intact.  An outage window stalls the caller until the
        window closes — the pre-reliability engines' behaviour, kept as
        the chaos benchmark's baseline."""
        total = 0.0
        while True:
            out = self.attempt(nbytes)
            total += out.seconds
            if out.delivered and not out.corrupt:
                return total
            if out.kind == "outage":
                # a blocked sender's next useful attempt is at window end
                end = self.outage_end()
                dt = max(self.rto_s, (end - self.clock_s)
                         if end is not None else self.rto_s)
                self.wait(dt)
                total += dt
            elif not out.delivered:
                self.wait(self.rto_s)
                total += self.rto_s
            # corrupt: checksum fails on arrival; retransmit immediately


class PressureSchedule:
    """Scripted *resource*-fault injection: the page-pool analogue of
    ``FaultyChannel``'s outage windows.

    ``windows`` is a list of ``(t0_s, t1_s, free_pages)`` intervals on
    the simulated clock; inside a window the schedule squeezes a
    ``kvcache.PageAllocator``'s free list down to at most ``free_pages``
    by holding pages itself (a co-tenant claiming HBM, a cgroup limit
    tightening), and past the window it gives them back.  ``apply`` is
    called by the scheduler at the top of every turn with the current
    simulated time, so the squeeze lands at deterministic points of the
    round structure — overload chaos tests are seeded and replayable,
    exactly like the outage tests.  The squeeze can only take pages that
    are actually free (live requests are never corrupted); if admission
    races it to the free list, the schedule simply grabs the remainder
    as retirements return pages.
    """

    def __init__(self, windows: Sequence[Tuple[float, float, int]]):
        self.windows = [(float(a), float(b), int(n)) for a, b, n in windows]
        if not all(b > a and n >= 0 for a, b, n in self.windows):
            raise ValueError(f"bad pressure window in {self.windows}")
        self._held: List[int] = []

    def target_free(self, t: float) -> Optional[int]:
        """The free-list ceiling at simulated time ``t`` (None = no
        pressure; overlapping windows compose to the tightest)."""
        targets = [n for a, b, n in self.windows if a <= t < b]
        return min(targets) if targets else None

    def next_change(self, t: float) -> Optional[float]:
        """The next window edge after ``t`` — how long a stalled
        scheduler must wait before the free list can look different."""
        edges = [e for a, b, _ in self.windows for e in (a, b) if e > t]
        return min(edges) if edges else None

    @property
    def held_pages(self) -> int:
        return len(self._held)

    def apply(self, allocator, t: float) -> None:
        """Move the allocator's free list toward the time-``t`` target:
        grab free pages down to the ceiling, or return held pages when
        the window has passed (all of them) or the ceiling rose."""
        target = self.target_free(t)
        if target is None:
            if self._held:
                allocator.free(self._held)
                self._held = []
            return
        while allocator.num_free > target:
            self._held.extend(allocator.alloc(1))
        while allocator.num_free < target and self._held:
            allocator.free([self._held.pop()])
