"""Straggler mitigation: step-time outlier detection + adaptive response.

At 1000+ nodes, slow hosts (thermal throttling, failing NICs, noisy
neighbors) stretch every synchronous step.  The monitor keeps an EWMA of
step times, flags outliers, and drives two mitigations:

* **prefetch boost** — tell the data pipeline to deepen its prefetch queue
  so a host-side hiccup doesn't starve the device;
* **escalation** — after ``evict_after`` consecutive outlier steps, report
  the host for eviction; with elastic restore (checkpoint.py) the job
  resumes on the surviving topology.

The monitor is exercised by the tests with synthetic timings; the
interface is what the trainer wires in (the reference's
``repro/train/straggler.py``, whose logic it keeps line for line).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerEvent:
    step: int
    dt: float
    ewma: float
    action: str


class StragglerMonitor:
    def __init__(self, *, alpha: float = 0.1, threshold: float = 2.0,
                 evict_after: int = 5,
                 on_prefetch_boost: Optional[Callable[[int], None]] = None,
                 on_evict: Optional[Callable[[], None]] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.evict_after = evict_after
        self.ewma: Optional[float] = None
        self.consecutive = 0
        self.events: List[StragglerEvent] = []
        self._on_boost = on_prefetch_boost
        self._on_evict = on_evict
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int, dt: Optional[float] = None) -> Optional[str]:
        """Record a step; returns the action taken ('boost'|'evict'|None)."""
        if dt is None:
            dt = time.monotonic() - (self._t0 or time.monotonic())
        if self.ewma is None:
            self.ewma = dt
            return None
        action = None
        if dt > self.threshold * self.ewma:
            self.consecutive += 1
            if self.consecutive >= self.evict_after:
                action = "evict"
                if self._on_evict:
                    self._on_evict()
                self.consecutive = 0
            else:
                action = "boost"
                if self._on_boost:
                    self._on_boost(self.consecutive)
        else:
            self.consecutive = 0
        # outliers update the EWMA slowly so one hiccup doesn't poison it
        a = self.alpha if action is None else self.alpha / 4
        self.ewma = (1 - a) * self.ewma + a * dt
        if action:
            self.events.append(StragglerEvent(step, dt, self.ewma, action))
        return action

    def escalate(self, step: int, reason: str = "") -> str:
        """Immediate eviction, bypassing the EWMA streak — for faults the
        runtime *knows* about (a rank died, a retry budget exhausted)
        rather than infers from timing.  Fires ``on_evict`` and records
        the event; returns 'evict'."""
        self.consecutive = 0
        self.events.append(
            StragglerEvent(step, 0.0, self.ewma or 0.0,
                           f"evict:{reason}" if reason else "evict"))
        if self._on_evict:
            self._on_evict()
        return "evict"

    def reset(self) -> None:
        """Forget the timing distribution — call after a topology change
        (elastic restart on fewer devices shifts every step time, and the
        old EWMA would flag the whole new regime as outliers)."""
        self.ewma = None
        self.consecutive = 0
        self._t0 = None
