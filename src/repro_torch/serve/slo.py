"""SLO layer for the serving engine: deadlines, admission, degraded modes.

The engine's scheduler (engine.py) decides *which* admitted request runs
next; this module decides *whether a request should be admitted at all*
and *how hard the engine should work* under sustained pressure — the
request-level robustness layer on top of the runtime's wire-level
resilience (``core/resilience.py``; docs/SERVING.md "Overload & SLOs" is the design doc).

Everything here is evaluated on an **injectable clock** (any
``() -> float`` callable; :class:`ManualClock` for tests and the
deterministic ``bench_overload`` runs, ``time.perf_counter`` in
production), so admission, shedding, and degraded-mode decisions replay
bit-identically for a fixed seed and trace.

Pieces:

* :class:`TierPolicy` / :class:`SLOPolicy` — per-priority-tier TTFT and
  total-latency deadlines, a token-bucket rate limit per tier, a bounded
  queue with high/low depth watermarks, and the degraded-mode knobs.
* :class:`TokenBucket` — the rate limiter, refilled from clock deltas.
* :class:`AdmissionController` — turns a submit into an explicit
  :class:`AdmissionDecision` (``admit`` / ``reject`` / ``backpressure``)
  and runs the degraded-mode ladder (level 0..3) off sustained queue
  pressure with hysteresis.
* :func:`percentile` / :func:`percentiles` — the latency-aggregation
  math ``latency_stats()`` reports (pinned by ``tests/test_overload.py``).

Admission state machine (evaluated in ``decide`` order)::

     submit ──► infeasible deadline? ──► REJECT "infeasible"
                │ queue at max_queue? ─► REJECT "queue_full"
                │ tier bucket empty? ──► REJECT "rate_limited"
                │ depth ≥ queue_high ──► BACKPRESSURE (queued, slow down)
                ▼
              ADMIT "ok" (queued)

Degraded-mode ladder (one level per ``degrade_sustain_steps`` of queue
depth above ``queue_high``; one level back per ``degrade_recover_steps``
at-or-below ``queue_low``)::

     L0 normal ─► L1 cap max_new ─► L2 cap prefill chunk ─► L3 suspend
                                                            spill
                                                            migration
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "ManualClock",
    "TokenBucket",
    "TierPolicy",
    "SLOPolicy",
    "AdmissionDecision",
    "AdmissionController",
    "percentile",
    "percentiles",
]


class ManualClock:
    """A clock the caller advances explicitly — the deterministic time
    base for SLO tests and ``bench_overload`` (one fixed ``dt`` per
    engine step models a serving tick)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    __call__ = now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t += float(dt)
        return self._t


class TokenBucket:
    """Token-bucket rate limiter on an injectable clock.

    Refill is computed from clock deltas (``rate_per_s`` tokens/second,
    capped at ``burst``), so behavior is a pure function of the take
    times — deterministic under :class:`ManualClock`.
    """

    def __init__(self, rate_per_s: float, burst: float,
                 clock: Callable[[], float]):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("rate_per_s and burst must be positive")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)          # starts full
        self._last = clock()

    def _refill(self) -> None:
        now = self.clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Per-priority-tier SLO targets.  ``None`` disables a limit."""

    ttft_deadline_s: Optional[float] = None    # submit -> first token
    total_deadline_s: Optional[float] = None   # submit -> finish
    rate_per_s: Optional[float] = None         # admission rate limit
    burst: float = 8.0                         # bucket depth for the limiter


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """The engine-wide SLO configuration (knob table: docs/SERVING.md).

    ``tiers`` maps a ``submit(priority=...)`` value to its
    :class:`TierPolicy`; unlisted priorities use ``default_tier``.
    ``min_step_s`` is the modeled floor of one engine step — it powers the
    admission feasibility check (a request whose minimal service time
    cannot fit its deadline is rejected at the door, never admitted to
    violate); ``0`` disables feasibility checking.
    """

    tiers: Mapping[int, TierPolicy] = dataclasses.field(default_factory=dict)
    default_tier: TierPolicy = dataclasses.field(default_factory=TierPolicy)
    max_queue: int = 64                 # hard bound: beyond it, reject
    queue_high: int = 16                # backpressure + degrade watermark
    queue_low: int = 4                  # hysteresis: clears both
    min_step_s: float = 0.0             # modeled engine-step floor
    # degraded-mode ladder
    degrade_sustain_steps: int = 4      # steps above high before escalating
    degrade_recover_steps: int = 8      # steps at/below low before recovering
    degraded_max_new: Optional[int] = None   # L1: cap admissions' max_new
    degraded_chunk: Optional[int] = None     # L2: cap prefill tokens/call

    def __post_init__(self):
        if not (0 <= self.queue_low <= self.queue_high <= self.max_queue):
            raise ValueError(
                f"need queue_low <= queue_high <= max_queue, got "
                f"{self.queue_low}/{self.queue_high}/{self.max_queue}")

    def tier(self, priority: int) -> TierPolicy:
        return self.tiers.get(priority, self.default_tier)

    def min_service_s(self, prompt_remaining: int, max_new: int,
                      chunk: int) -> float:
        """Modeled lower bound on serving time: one step per prefill chunk
        plus one per generated token, at the ``min_step_s`` floor."""
        if self.min_step_s <= 0.0:
            return 0.0
        steps = -(-max(prompt_remaining, 0) // max(chunk, 1)) + max(max_new, 0)
        return steps * self.min_step_s

    def min_ttft_s(self, prompt_remaining: int, chunk: int) -> float:
        """Modeled lower bound on TTFT: the prefill chunks alone (the
        final chunk commits the first token)."""
        if self.min_step_s <= 0.0:
            return 0.0
        return -(-max(prompt_remaining, 1) // max(chunk, 1)) * self.min_step_s


@dataclasses.dataclass
class AdmissionDecision:
    """The explicit result of a ``submit`` under an SLO policy.

    ``action`` is ``"admit"`` (queued), ``"backpressure"`` (queued, but
    the caller should slow down — queue depth crossed ``queue_high`` and
    has not fallen back to ``queue_low``), or ``"reject"`` (NOT queued;
    ``reason`` says why: ``infeasible`` / ``queue_full`` /
    ``rate_limited``).
    """

    action: str
    reason: str
    tier: int = 0
    queue_depth: int = 0

    @property
    def admitted(self) -> bool:
        return self.action != "reject"


class AdmissionController:
    """Evaluates :class:`SLOPolicy` for one engine.

    Owns the per-tier token buckets, the backpressure flag (watermark
    hysteresis), and the degraded-mode ladder.  Every decision and ladder
    transition is appended to ``log`` (the engine's ``slo_log``), which is
    the deterministic decision record ``bench_overload`` replays and
    diffs across seeds.
    """

    def __init__(self, policy: SLOPolicy, clock: Callable[[], float],
                 log: Optional[List[tuple]] = None):
        self.policy = policy
        self.clock = clock
        self.log = log if log is not None else []
        self._buckets: Dict[int, TokenBucket] = {}
        self.backpressure = False
        self.level = 0                       # degraded-mode ladder level
        self._above = 0
        self._below = 0
        self.transitions: List[tuple] = []   # (step, old_level, new_level)

    def bucket(self, priority: int) -> Optional[TokenBucket]:
        tier = self.policy.tier(priority)
        if tier.rate_per_s is None:
            return None
        if priority not in self._buckets:
            self._buckets[priority] = TokenBucket(
                tier.rate_per_s, tier.burst, self.clock)
        return self._buckets[priority]

    # -- admission ----------------------------------------------------------
    def decide(self, *, priority: int, prompt_len: int, max_new: int,
               chunk: int, queue_depth: int,
               ttft_deadline_s: Optional[float],
               total_deadline_s: Optional[float]) -> AdmissionDecision:
        p = self.policy
        d = lambda action, reason: AdmissionDecision(
            action, reason, tier=priority, queue_depth=queue_depth)
        # 1. a deadline that cannot be met even unqueued is never admitted
        if ttft_deadline_s is not None \
                and p.min_ttft_s(prompt_len, chunk) > ttft_deadline_s:
            return d("reject", "infeasible")
        if total_deadline_s is not None \
                and p.min_service_s(prompt_len, max_new,
                                    chunk) > total_deadline_s:
            return d("reject", "infeasible")
        # 2. hard queue bound
        if queue_depth >= p.max_queue:
            return d("reject", "queue_full")
        # 3. per-tier rate limit
        bucket = self.bucket(priority)
        if bucket is not None and not bucket.try_take(1.0):
            return d("reject", "rate_limited")
        # 4. watermark backpressure (queued, with a slow-down signal)
        if queue_depth >= p.queue_high:
            self.backpressure = True
        elif queue_depth <= p.queue_low:
            self.backpressure = False
        if self.backpressure:
            return d("backpressure", "queue_high")
        return d("admit", "ok")

    # -- degraded-mode ladder ----------------------------------------------
    def update_pressure(self, queue_depth: int, step: int) -> int:
        """One engine step's pressure sample; returns the ladder level."""
        p = self.policy
        if queue_depth > p.queue_high:
            self._above += 1
            self._below = 0
            if self._above >= p.degrade_sustain_steps and self.level < 3:
                self._above = 0
                self._move(step, self.level + 1, queue_depth)
        elif queue_depth <= p.queue_low:
            self._below += 1
            self._above = 0
            if self._below >= p.degrade_recover_steps and self.level > 0:
                self._below = 0
                self._move(step, self.level - 1, queue_depth)
            if queue_depth <= p.queue_low:
                self.backpressure = False
        else:
            self._above = 0
            self._below = 0
        return self.level

    def _move(self, step: int, new: int, depth: int) -> None:
        self.transitions.append((step, self.level, new))
        self.log.append(("degrade", step, self.level, new, depth))
        self.level = new


# -- latency aggregation -----------------------------------------------------

def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy's default convention): the
    value at fractional rank ``q/100 * (n-1)`` between order statistics.
    ``None`` on empty input."""
    if not xs:
        return None
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    rank = (float(q) / 100.0) * (len(s) - 1)
    lo = min(int(rank), len(s) - 2)
    frac = rank - lo
    return float(s[lo] + (s[lo + 1] - s[lo]) * frac)


def percentiles(xs: Sequence[float],
                qs: Sequence[float] = (50, 95, 99)) -> Optional[dict]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` or ``None`` on empty."""
    if not xs:
        return None
    return {f"p{q:g}": percentile(xs, q) for q in qs}
