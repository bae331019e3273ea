"""Seeded bursty request traces for overload experiments.

Overload and disaggregated-serving experiments need simulated
millions-of-users request traces (bursty arrivals, mixed prompt lengths,
priority tiers); this module is that trace source, scaled down to CI.
``bursty_trace`` models the canonical serving workload shape:

* **Poisson bursts**: arrivals come in bursts whose inter-burst gaps are
  exponential (a Poisson process over bursts) and whose sizes are
  geometric — long quiet stretches punctuated by pile-ups, the pattern
  that actually overloads an admission queue (uniform arrivals never do).
* **Heavy-tail prompt lengths**: log-normal, clamped to the engine's
  cache bounds — most prompts are short, a few are huge (the huge ones
  are what trip watermark preemption and spill migration).
* **Priority tiers**: each request draws a tier from a weighted
  distribution; the tier index is passed straight through as the engine
  ``priority`` (higher wins at admission), and the SLO policy maps it
  to per-tier deadlines and rate limits.  The weights only set the mix.

Determinism: all draws go through :func:`repro_torch.core.resilience.derive_rng`
(sha256-seeded ``random.Random``), NOT numpy Generators, because Python's
``random`` distribution algorithms are stable across versions/platforms —
the same seed must produce the same trace on every CI machine, since
``bench_overload``'s decision-log digest is computed over it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..core.resilience import derive_rng

__all__ = ["TraceRequest", "bursty_trace"]


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival in a trace (engine-agnostic: modeled seconds)."""

    arrival_s: float       # modeled arrival time
    prompt_len: int
    max_new: int
    priority: int          # engine priority (higher wins)


def bursty_trace(seed: int, n: int, *,
                 burst_rate_per_s: float = 4.0,
                 mean_burst: float = 3.0,
                 prompt_mu: float = 2.6,
                 prompt_sigma: float = 0.6,
                 min_prompt: int = 4,
                 max_prompt: int = 96,
                 max_new_choices: Sequence[int] = (8, 16, 24),
                 tier_weights: Sequence[float] = (0.2, 0.5, 0.3),
                 ) -> List[TraceRequest]:
    """``n`` seeded arrivals: Poisson bursts, log-normal prompts, tiers.

    ``tier_weights[i]`` is the probability a request lands in priority
    tier ``i`` (passed straight through as the engine ``priority`` —
    the SLO policy maps it to deadlines; by repo convention HIGHER is
    more urgent, so put the premium tier's weight LAST).
    """
    if n < 1:
        return []
    rng = derive_rng("trace", seed, n)
    cum, acc = [], 0.0
    for w in tier_weights:
        acc += float(w)
        cum.append(acc)
    out: List[TraceRequest] = []
    t = 0.0
    while len(out) < n:
        # next burst: exponential gap, geometric size (>= 1)
        t += rng.expovariate(burst_rate_per_s)
        burst = 1
        while rng.random() < 1.0 - 1.0 / max(mean_burst, 1.0):
            burst += 1
        for _ in range(burst):
            if len(out) >= n:
                break
            plen = int(round(rng.lognormvariate(prompt_mu, prompt_sigma)))
            plen = max(min_prompt, min(max_prompt, plen))
            u = rng.random() * acc
            tier = next(i for i, c in enumerate(cum) if u <= c)
            out.append(TraceRequest(
                arrival_s=t,
                prompt_len=plen,
                max_new=max_new_choices[
                    rng.randrange(len(max_new_choices))],
                priority=tier))
    return out
