"""Retry/timeout/backoff and circuit breaking for the communication verbs.

Ported from the reference's ``core/resilience.py``, which is pure Python:

* ``TransientFault`` / ``FaultTimeout`` — what a failed wire attempt
  raises; ``RetryError`` — a spent per-verb retry budget.
* ``RetryPolicy`` — per-verb retry budgets with capped exponential
  backoff and deterministic jitter (``sha256(seed, verb, attempt)``), so a
  seeded run replays bit-identically.
* ``call_with_retries`` — the retry loop itself.
* ``CircuitBreaker`` — the escalation layer above the retry loop: keys
  (the serving engine uses ``(verb, rank)``) that keep spending whole retry
  budgets open, are routed around, and are probed again after a cooldown.
* ``derive_rng`` — a process-stable RNG for a structured key (the request
  traces and the engine's sampling streams).
* ``content_digest`` / ``corrupt_digest`` — the RMA-window checksums the
  KV allocator's validated migration uses.

Fault injection itself (``FaultPlan``, ``ChaosBackend``) is
:mod:`repro_torch.core.faults`; the communicator runs every dispatch under
``call_with_retries`` with its context's ``RetryPolicy``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import time
from typing import Callable, Mapping, Optional

__all__ = [
    "TransientFault",
    "FaultTimeout",
    "RetryError",
    "RetryPolicy",
    "CircuitBreaker",
    "call_with_retries",
    "derive_rng",
    "content_digest",
    "corrupt_digest",
]


class TransientFault(RuntimeError):
    """A retryable wire fault: a dropped put, a failed collective, a
    corrupted payload caught by the transport CRC.  Carries the injected
    fault record (when raised by ``ChaosBackend``) as ``.fault`` so the
    retry loop can mark it recovered."""

    def __init__(self, msg: str, fault=None):
        super().__init__(msg)
        self.fault = fault


class FaultTimeout(TransientFault):
    """An attempt exceeded its completion budget (modeled, not slept)."""


class RetryError(RuntimeError):
    """The per-verb retry budget is exhausted; ``.last`` holds the final
    ``TransientFault``.  This is the point where the runtime escalates —
    the serving engine requeues, the trainer evicts and restores."""

    def __init__(self, msg: str, last: Optional[TransientFault] = None):
        super().__init__(msg)
        self.last = last


def derive_rng(*key) -> random.Random:
    """A process-stable RNG for a structured key.

    Python's ``hash()`` of strings is randomized per process, which
    would make a "deterministic" fault plan differ between the run that
    found a bug and the run trying to reproduce it — so all seeded
    decisions in this layer and in `faults.py` go through sha256.
    """
    blob = ":".join(str(k) for k in key).encode()
    return random.Random(int.from_bytes(
        hashlib.sha256(blob).digest()[:8], "little"))


def content_digest(buf) -> str:
    """sha256 hex digest of a host buffer (what a put *should* land)."""
    return hashlib.sha256(bytes(memoryview(buf).cast("B"))).hexdigest()


def corrupt_digest(digest: str, salt) -> str:
    """A deterministic wrong digest: what a corrupted/dropped put lands.

    Guaranteed to differ from ``digest`` so window validation always
    notices.
    """
    bad = hashlib.sha256(f"corrupt:{salt}:{digest}".encode()).hexdigest()
    if bad == digest:  # pragma: no cover - sha256 collision
        bad = "0" * 64 if digest != "0" * 64 else "f" * 64
    return bad


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Timeout + capped exponential backoff + jitter, per verb.

    ``max_retries`` is the default budget; ``per_verb`` overrides it for
    verbs with different urgency (a barrier can afford more retries than
    a latency-critical decode put).  Backoff for attempt *k* is
    ``min(base * 2^(k-1), max) * jitter`` with jitter drawn
    deterministically from ``(seed, verb, attempt)``.
    """

    max_retries: int = 8
    per_verb: Mapping[str, int] = dataclasses.field(default_factory=dict)
    base_backoff_s: float = 1e-4
    max_backoff_s: float = 5e-3
    jitter: float = 0.5            # backoff scaled by [1 - j/2, 1 + j/2)
    timeout_s: float = 0.25        # per-attempt completion budget (modeled)
    seed: int = 0
    sleep: bool = True             # False: account backoff, do not sleep

    def budget(self, verb: str) -> int:
        return int(self.per_verb.get(verb, self.max_retries))

    def backoff_s(self, verb: str, attempt: int) -> float:
        base = min(self.base_backoff_s * (2.0 ** max(attempt - 1, 0)),
                   self.max_backoff_s)
        u = derive_rng(self.seed, verb, attempt).random()
        return base * (1.0 - self.jitter / 2.0 + self.jitter * u)


class CircuitBreaker:
    """Closed / open / half-open breaker over arbitrary hashable keys.

    One failure here means "a whole retry budget was spent" (a
    :class:`RetryError` / ``RMAError`` surfaced), so the breaker sits
    strictly *above* :class:`RetryPolicy` in the escalation ladder:
    transient faults are retried, repeat budget exhaustion quarantines
    the destination.  States per key:

    * ``closed`` — healthy; ``allow`` always grants.  ``failure_threshold``
      consecutive failures trip it to ``open``.
    * ``open`` — quarantined; ``allow`` denies until ``cooldown_s`` has
      elapsed on the injected ``clock``, then flips to ``half_open``.
    * ``half_open`` — probing; ``allow`` grants at most
      ``half_open_probes`` attempts.  A recorded success closes the key,
      a failure re-opens it (and restarts the cooldown).

    ``record_success(key, retries=...)`` accepts the retry-ledger delta of
    the successful call so per-key wear is visible in :meth:`snapshot`
    even while the key stays closed.  All transitions land in
    ``self.transitions`` — the deterministic audit log the overload tests
    and ``bench_overload`` decision logs replay.
    """

    def __init__(self, *, failure_threshold: int = 3,
                 cooldown_s: float = 0.25, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self.clock = clock
        self._cells: dict = {}
        self.transitions: list = []   # (key, old_state, new_state)
        self.stats = {"opened": 0, "reopened": 0, "closed": 0, "probes": 0,
                      "denied": 0}

    def _cell(self, key) -> dict:
        return self._cells.setdefault(
            key, {"state": "closed", "failures": 0, "opened_at": 0.0,
                  "probes": 0, "retries": 0, "successes": 0})

    def _trans(self, key, cell: dict, new: str) -> None:
        self.transitions.append((key, cell["state"], new))
        cell["state"] = new

    # -- the gate -----------------------------------------------------------
    def allow(self, key) -> bool:
        """May a call to ``key`` be attempted now?  Open keys flip to
        half-open once the cooldown elapses; half-open keys grant at most
        ``half_open_probes`` probe slots (``allow`` consumes one — call it
        only when about to attempt)."""
        cell = self._cell(key)
        if cell["state"] == "open":
            if self.clock() - cell["opened_at"] < self.cooldown_s:
                self.stats["denied"] += 1
                return False
            self._trans(key, cell, "half_open")
            cell["probes"] = 0
        if cell["state"] == "half_open":
            if cell["probes"] >= self.half_open_probes:
                self.stats["denied"] += 1
                return False
            cell["probes"] += 1
            self.stats["probes"] += 1
        return True

    # -- outcome feed (the retry ledger reports here) -----------------------
    def record_failure(self, key) -> str:
        """A call to ``key`` spent its whole retry budget.  Returns the
        key's state after accounting."""
        cell = self._cell(key)
        if cell["state"] == "half_open":
            self._trans(key, cell, "open")
            cell["opened_at"] = self.clock()
            self.stats["reopened"] += 1
            return cell["state"]
        cell["failures"] += 1
        if cell["state"] == "closed" \
                and cell["failures"] >= self.failure_threshold:
            self._trans(key, cell, "open")
            cell["opened_at"] = self.clock()
            self.stats["opened"] += 1
        return cell["state"]

    def record_success(self, key, *, retries: int = 0) -> str:
        """A call to ``key`` completed (``retries`` = re-issued attempts it
        needed, from the caller's retry ledger)."""
        cell = self._cell(key)
        cell["retries"] += int(retries)
        cell["successes"] += 1
        if cell["state"] == "half_open":
            self._trans(key, cell, "closed")
            cell["failures"] = 0
            self.stats["closed"] += 1
        elif cell["state"] == "closed":
            cell["failures"] = 0
        return cell["state"]

    # -- introspection ------------------------------------------------------
    def state(self, key) -> str:
        """Current recorded state (non-mutating: an elapsed cooldown shows
        as ``open`` until :meth:`allow` probes it)."""
        return self._cells.get(key, {"state": "closed"})["state"]

    def open_keys(self) -> list:
        return [k for k, c in self._cells.items() if c["state"] != "closed"]

    def snapshot(self) -> dict:
        return {k: dict(c) for k, c in self._cells.items()}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"CircuitBreaker(keys={len(self._cells)}, "
                f"open={len(self.open_keys())}, stats={self.stats})")


def call_with_retries(thunk: Callable[[], object], verb: str,
                      policy: RetryPolicy, *,
                      on_retry: Optional[Callable] = None,
                      on_recover: Optional[Callable] = None):
    """Run ``thunk`` under ``policy``, retrying on ``TransientFault``.

    ``on_retry(attempt, fault)`` fires before each re-issue — the
    communicator uses it to log the retried wire bytes separately from
    the logical byte log.  ``on_recover(n_faults)`` fires once when a
    faulted call finally succeeds.  Injected-fault records attached to
    the raised exceptions are marked ``recovered`` on success.
    """
    faults = []
    backoff_total = 0.0
    while True:
        try:
            out = thunk()
        except TransientFault as tf:
            faults.append(tf)
            attempt = len(faults)
            if attempt > policy.budget(verb):
                raise RetryError(
                    f"{verb}: retry budget ({policy.budget(verb)}) "
                    f"exhausted after {attempt} attempts: {tf}",
                    last=tf) from tf
            if on_retry is not None:
                on_retry(attempt, tf)
            delay = policy.backoff_s(verb, attempt)
            backoff_total += delay
            if policy.sleep and delay > 0.0:
                time.sleep(delay)
            continue
        for tf in faults:
            if tf.fault is not None:
                tf.fault.recovered = True
        if faults and on_recover is not None:
            on_recover(len(faults))
        return out
