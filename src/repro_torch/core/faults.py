"""Deterministic fault injection for the communication stack.

Ported from the reference's ``core/faults.py`` (pure Python).  A seeded
:class:`FaultPlan` decides, reproducibly, which verb dispatches fail and
which ranks die at which step, and :class:`ChaosBackend` wraps any
registered :class:`~repro_torch.core.backends.CclBackend` to inject those
faults at the verb level.  A fault is raised before the inner backend
computes anything, so the communicator's retry re-runs the same
computation on the same stacked tensors: every result is bit-identical
to a calm run, while the retry logs show that the faults were hit and
recovered.

Fault model (what each kind means on real hardware):

* ``drop``    — a one-sided put or collective whose completion event
  never arrives (GASNet-EX would surface a failed AM reply).  Raised as
  :class:`~repro_torch.core.resilience.TransientFault`; the
  communicator's retry loop re-issues the verb.
* ``fail``    — the transport returned an error code for the whole
  collective (a GPI-2 queue error).  Same recovery path as ``drop``.
* ``timeout`` — the completion budget elapsed.  Raised as
  :class:`~repro_torch.core.resilience.FaultTimeout` (still transient).
* ``delay``   — a slow link: the dispatch sleeps briefly, then
  proceeds.  No retry; latency only.
* ``corrupt`` — payload damaged in flight.  On collectives the transport
  CRC catches it and reports a failed transfer (so it degenerates to
  ``drop``); on host-buffer RMA paths (the paged-KV ``migrate``) the
  corruption lands a wrong *window checksum*, which the reader's
  ``RMATracker.validate`` detects and repairs by re-putting.  Either way:
  detected, never silently absorbed.
* rank death — scheduled with :meth:`FaultPlan.kill_rank`; consumed by
  the serving engine (drain/requeue) and the training launcher (elastic
  restore), not by the backend wrapper.

Determinism: every decision derives from ``sha256(seed, verb,
call_index)`` (:func:`~repro_torch.core.resilience.derive_rng`), never
from Python's randomized ``hash()``: for the same seed and the same
per-verb call sequence a plan injects the reference's exact
``(verb, call_index, kind)`` stream.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from .backends import CclBackend
from .resilience import FaultTimeout, TransientFault, derive_rng

__all__ = [
    "INJECTABLE_VERBS",
    "TRANSIENT_KINDS",
    "FaultSpec",
    "InjectedFault",
    "RankDeath",
    "FaultPlan",
    "ChaosBackend",
]

#: verbs the plan can target (``migrate`` is the host-side paged-KV path).
INJECTABLE_VERBS = (
    "allreduce", "bcast", "allgather", "reducescatter", "alltoall",
    "permute", "barrier", "put", "put_perm", "halo_exchange", "migrate",
)

TRANSIENT_KINDS = ("drop", "fail", "timeout", "corrupt", "delay")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """An explicit scheduled fault: the ``at_call``-th dispatch (0-based,
    counted per verb) of ``verb`` suffers ``kind``."""

    verb: str
    at_call: int
    kind: str = "drop"

    def __post_init__(self):
        if self.kind not in TRANSIENT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass
class InjectedFault:
    """Log record of one injected fault; ``recovered`` is flipped by the
    retry machinery when the faulted call eventually succeeds."""

    verb: str
    call_index: int
    kind: str
    recovered: bool = False


@dataclasses.dataclass
class RankDeath:
    """A scheduled rank death, consumed once via :meth:`FaultPlan.deaths_at`.

    ``graceful`` deaths announce themselves (the engine drains the rank's
    paged KV over RMA before removing it); abrupt deaths lose the pages.
    """

    step: int
    rank: int
    graceful: bool = False
    fired: bool = False


class FaultPlan:
    """Seeded, deterministic schedule of wire faults and rank deaths.

    Two sources of faults compose:

    * explicit ``specs`` — exact (verb, call_index, kind) triples;
    * probabilistic — each dispatch of a verb in ``verbs`` faults with
      probability ``p``, kind drawn uniformly from ``kinds``, both from
      the per-call sha256 stream.

    The plan is shared across backends and threads; the per-verb call
    counters are lock-protected.  Everything injected lands in
    ``self.injected``, so a caller can check that faults were hit *and*
    recovered.
    """

    def __init__(self, seed: int, *, p: float = 0.0,
                 kinds: Sequence[str] = ("drop",),
                 verbs: Sequence[str] = INJECTABLE_VERBS,
                 specs: Sequence[FaultSpec] = (),
                 max_faults: Optional[int] = None,
                 max_delay_s: float = 1e-3):
        for k in kinds:
            if k not in TRANSIENT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        self.seed = int(seed)
        self.p = float(p)
        self.kinds = tuple(kinds)
        self.verbs = tuple(verbs)
        self.specs = tuple(specs)
        self.max_faults = max_faults
        self.max_delay_s = float(max_delay_s)
        self.injected: List[InjectedFault] = []
        self.deaths: List[RankDeath] = []
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- schedule authoring -------------------------------------------------
    def kill_rank(self, step: int, rank: int, *,
                  graceful: bool = False) -> "FaultPlan":
        self.deaths.append(RankDeath(step=step, rank=rank, graceful=graceful))
        return self

    # -- runtime queries ----------------------------------------------------
    def deaths_at(self, step: int) -> List[RankDeath]:
        """Deaths due at-or-before ``step`` that have not fired yet (each
        fires exactly once)."""
        due = []
        for d in self.deaths:
            if not d.fired and d.step <= step:
                d.fired = True
                due.append(d)
        return due

    def next_fault(self, verb: str) -> Optional[InjectedFault]:
        """Advance the per-verb call counter; return a fault record if this
        dispatch is scheduled to fail, else None."""
        with self._lock:
            idx = self._counters.get(verb, 0)
            self._counters[verb] = idx + 1
            kind = None
            for spec in self.specs:
                if spec.verb == verb and spec.at_call == idx:
                    kind = spec.kind
                    break
            if kind is None and self.p > 0.0 and verb in self.verbs:
                if (self.max_faults is None
                        or len(self.injected) < self.max_faults):
                    rng = derive_rng(self.seed, verb, idx)
                    if rng.random() < self.p:
                        kind = self.kinds[rng.randrange(len(self.kinds))]
            if kind is None:
                return None
            record = InjectedFault(verb=verb, call_index=idx, kind=kind)
            self.injected.append(record)
            return record

    # -- introspection ------------------------------------------------------
    def injected_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.injected:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def unrecovered(self) -> List[InjectedFault]:
        return [f for f in self.injected if not f.recovered]

    def reset_counters(self) -> None:
        """Restart the per-verb call streams (same schedule, from call 0)."""
        with self._lock:
            self._counters.clear()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"FaultPlan(seed={self.seed}, p={self.p}, "
                f"kinds={self.kinds}, specs={len(self.specs)}, "
                f"deaths={len(self.deaths)}, injected={len(self.injected)})")

    # -- ambient chaos ------------------------------------------------------
    @classmethod
    def from_env(cls, env=None) -> Optional["FaultPlan"]:
        """Build a plan from ``DIOMP_CHAOS_*`` environment variables, or None.

        ``DIOMP_CHAOS_SEED`` (required to enable), ``DIOMP_CHAOS_P``
        (default 0.02), ``DIOMP_CHAOS_KINDS`` and ``DIOMP_CHAOS_VERBS``
        (comma lists).  Lets a whole test run go under chaos without
        touching each test.
        """
        env = os.environ if env is None else env
        seed = env.get("DIOMP_CHAOS_SEED")
        if seed is None or seed == "":
            return None
        p = float(env.get("DIOMP_CHAOS_P", "0.02"))
        kinds = tuple(k for k in env.get(
            "DIOMP_CHAOS_KINDS", "drop,fail,timeout").split(",") if k)
        verbs = tuple(v for v in env.get(
            "DIOMP_CHAOS_VERBS", ",".join(INJECTABLE_VERBS)).split(",") if v)
        return cls(int(seed), p=p, kinds=kinds, verbs=verbs)


class ChaosBackend(CclBackend):
    """Wrap any backend and inject the plan's faults at verb dispatch.

    Every verb delegates *directly* to ``inner.<verb>``, never through the
    base-class defaults: a wrapped ``bcast`` routed through
    ``self.allreduce`` would roll the plan twice.  Transient kinds raise
    before the inner backend runs, so the communicator's retry runs an
    identical computation (bit-identical results); ``delay`` sleeps and
    proceeds.
    """

    def __init__(self, inner: CclBackend, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.name = f"chaos:{inner.name}"

    def roll(self, verb: str) -> None:
        """One dispatch of ``verb``: raise its scheduled fault, sleep a
        ``delay``, or return."""
        fault = self.plan.next_fault(verb)
        if fault is None:
            return
        if fault.kind == "delay":
            time.sleep(min(self.plan.max_delay_s,
                           derive_rng(self.plan.seed, "delay",
                                      fault.call_index).random()
                           * self.plan.max_delay_s))
            fault.recovered = True
            return
        if fault.kind == "timeout":
            raise FaultTimeout(
                f"injected timeout on {verb} (call {fault.call_index})",
                fault=fault)
        raise TransientFault(
            f"injected {fault.kind} on {verb} (call {fault.call_index})",
            fault=fault)

    # -- collectives --------------------------------------------------------
    def allreduce(self, x, group, mesh, *, op="sum"):
        self.roll("allreduce")
        return self.inner.allreduce(x, group, mesh, op=op)

    def bcast(self, x, group, mesh, *, root=0):
        self.roll("bcast")
        return self.inner.bcast(x, group, mesh, root=root)

    def allgather(self, x, group, mesh, *, axis=0, tiled=True,
                  invariant=False):
        self.roll("allgather")
        return self.inner.allgather(x, group, mesh, axis=axis, tiled=tiled,
                                    invariant=invariant)

    def reducescatter(self, x, group, mesh, *, axis=0):
        self.roll("reducescatter")
        return self.inner.reducescatter(x, group, mesh, axis=axis)

    def alltoall(self, x, group, mesh, *, split_axis=0, concat_axis=0):
        self.roll("alltoall")
        return self.inner.alltoall(x, group, mesh, split_axis=split_axis,
                                   concat_axis=concat_axis)

    def permute(self, x, group, mesh, *, shift=1):
        self.roll("permute")
        return self.inner.permute(x, group, mesh, shift=shift)

    def barrier(self, group, mesh, *, device=None):
        self.roll("barrier")
        return self.inner.barrier(group, mesh, device=device)

    # -- one-sided RMA ------------------------------------------------------
    def put(self, x, group, mesh, *, shift=1):
        self.roll("put")
        return self.inner.put(x, group, mesh, shift=shift)

    def put_perm(self, x, group, mesh, perm):
        self.roll("put_perm")
        return self.inner.put_perm(x, group, mesh, perm)

    def halo_exchange(self, x, group, mesh, *, halo, axis=0):
        self.roll("halo_exchange")
        return self.inner.halo_exchange(x, group, mesh, halo=halo, axis=axis)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ChaosBackend({self.inner!r}, {self.plan!r})"
