"""Continuous-batching serving engine (slot-based, vLLM-shaped).

The production serving loop documented in docs/SERVING.md (layer map:
docs/ARCHITECTURE.md).  A fixed pool of B slots; requests admit into free
slots via the PagedKV allocator (PGAS page tables — the paper's second-
level-pointer machinery), prompts stream in through **chunked prefill**
(one device call per ``prefill_chunk`` prompt tokens, interleaved with
decode in the same engine loop), every decode step advances all decode-
ready slots by one sampled token (per-slot ``pos`` vector in the cache),
finished slots release their pages to the allocator free list and refill
from the queue.

Scheduling: the queue is priority-ordered (then FIFO); when KV pressure
crosses the high watermark — or a page allocation fails mid-decode — the
lowest-priority / latest-arrived victim is **preempted**: its device rows
are snapshotted host-side and its KV pages migrate to a spill rank's heap
via one-sided RMA (recorded on the OMPCCL call log and the request's
RMATracker window); preempted requests resume into the next free slot by
migrating their pages home again.  Slots that are free or mid-prefill are
*parked* during decode steps (their device write lands on the reserved
scratch row S-1, and the engine re-asserts the authoritative per-slot
positions afterwards), which fixes the seed engine's leak of stale pending
tokens / phantom position advances on released slots.

The engine is single-controller host code: the paper's "single-process
multi-GPU" deployment — the host orchestrates, OMPCCL moves data, and host
threads (StreamPool) stay free for tokenize/detokenize work.

Port notes: the cache is one stacked tensor per leaf on the context's
device (ranks leading, the slot dim sharded like the batch), decode steps
update it in place, and a chunk-prefill step runs on a copy of one slot's
rows that is written back.  Rank deaths scheduled on the context's
``FaultPlan`` fire in ``step()``; ``on_rank_death`` drains a dying rank's
pages over the validated ``migrate`` (graceful) or requeues its requests
(abrupt), as the reference does.

Overload behavior (docs/SERVING.md "Overload & SLOs"): with an
``SLOPolicy`` attached, ``submit()`` returns an explicit admit / reject /
backpressure decision (``req.decision``) instead of queueing
unconditionally; each ``step()`` sheds queued requests whose deadlines
expired (or can no longer be met) and cancels mid-flight expired requests
with their KV pages freed and accounted; sustained queue pressure walks a
staged degraded-mode ladder (cap ``max_new`` → cap prefill chunk →
suspend spill migration) with hysteretic recovery.  All timestamps come
from an **injectable clock** (wall clock by default), so the whole
decision sequence replays deterministically under a ``ManualClock``.
Spill-target selection runs through a per-``(verb, rank)``
``CircuitBreaker``: a spill rank that keeps exhausting migrate retry
budgets is quarantined (open), routed around, probed after cooldown
(half-open), and readmitted on a clean success.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.context import DiompContext, use_default
from ..core.groups import DiompGroup
from ..core.pgas import GlobalMemory
from ..core.resilience import CircuitBreaker
from ..core.rma import RMAError
from ..interop import local_shape, stack_shards, unstack_shards
from ..launch.mesh import RankMesh
from ..models import api as model_api
from ..models.config import ModelConfig, ParallelCtx
from .kvcache import PagedKVAllocator, Request
from .slo import AdmissionController, AdmissionDecision, SLOPolicy, percentiles
from .step import build_chunk_prefill_step, build_decode_step

__all__ = ["ServeEngine", "GenRequest"]


@dataclasses.dataclass(eq=False)       # identity semantics: requests are
class GenRequest:                      # scheduled objects, not values
    prompt: np.ndarray          # (len,) int32
    max_new: int
    priority: int = 0           # higher wins at admission / survives preemption
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    fed: int = 0                # prompt tokens consumed so far
    kv: Optional[Request] = None
    done: bool = False
    arrival: int = 0
    # per-request accounting (docs/SERVING.md "measurement")
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    admit_step: int = -1
    finish_step: int = -1
    prefill_steps: int = 0      # chunk-prefill device calls for this request
    decode_steps: int = 0       # decode steps this request participated in
    preemptions: int = 0
    # SLO surface (docs/SERVING.md "Overload & SLOs"): deadlines are
    # ABSOLUTE clock times (submit_t + the relative deadline); `decision`
    # is the explicit admission verdict, `shed_reason` is set when the
    # engine rejected/shed/cancelled this request instead of finishing it
    ttft_deadline: Optional[float] = None
    total_deadline: Optional[float] = None
    decision: Optional[AdmissionDecision] = None
    shed_reason: Optional[str] = None
    _snapshot: Optional[dict] = None  # host copy of device rows while swapped
    _rng: Optional[np.random.Generator] = None

    def deadline_met(self) -> bool:
        """Did this request meet every deadline it carried?  (Vacuously
        true with no deadlines; requires the respective timestamp.)"""
        if self.ttft_deadline is not None and (
                self.first_token_t is None
                or self.first_token_t > self.ttft_deadline):
            return False
        if self.total_deadline is not None and (
                self.finish_t is None or self.finish_t > self.total_deadline):
            return False
        return True

    def stats(self) -> dict:
        ttft = (self.first_token_t - self.submit_t
                if self.first_token_t else None)
        total = (self.finish_t - self.submit_t) if self.finish_t else None
        return {
            "prompt_len": int(len(self.prompt)), "generated": len(self.out),
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            "ttft_s": ttft, "total_s": total,
            "shed_reason": self.shed_reason,
            "deadline_met": self.deadline_met(),
        }


class ServeEngine:
    """See module docstring; knob reference in docs/SERVING.md."""

    def __init__(self, cfg: ModelConfig, mesh: RankMesh, ctx: ParallelCtx,
                 params, *,
                 slots: int = 4, max_len: int = 256,
                 prefill_chunk: int = 16, page_tokens: int = 64,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 high_watermark: float = 0.92, low_watermark: float = 0.80,
                 memory: Optional[GlobalMemory] = None,
                 context: Optional[DiompContext] = None,
                 slo: Optional[SLOPolicy] = None,
                 clock=None,
                 breaker: Optional[CircuitBreaker] = None):
        if cfg.family not in model_api.TRANSFORMER_FAMILIES \
                or not model_api.has_decode(cfg):
            raise ValueError(
                f"ServeEngine supports decode-capable transformer families "
                f"(positional KV caches); got family {cfg.family!r}")
        self.cfg, self.mesh, self.ctx = cfg, mesh, ctx
        self.params = params
        self.B, self.S = slots, max_len
        self.chunk = max(int(prefill_chunk), 1)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        # the engine runs on a DiompContext: the KV-page arena is its PGAS
        # memory, the world group its communicator domain, its device the
        # card unless the context says otherwise.  A caller-provided
        # `memory` (legacy) still wins for the arena.
        if context is None:
            context = DiompContext(mesh=mesh, segment_bytes=1 << 26,
                                   allocator="buddy")
        self.dctx = context
        self.device = context.device
        self.memory = memory or context.memory
        self._group = context.groups.get(
            "world", DiompGroup(tuple(mesh.axis_names), name="world"))
        self._comm = self.dctx.communicator(self._group)
        kv_bpt = 2 * 2 * max(cfg.kv_heads, 1) * max(cfg.head_dim, 1) \
            * cfg.num_layers
        self.alloc = PagedKVAllocator(
            self.memory, self._group,
            page_tokens=page_tokens, kv_bytes_per_token=max(kv_bpt, 64))
        self.decode_step = build_decode_step(cfg, mesh, ctx, B=slots,
                                             S=max_len, slot_pos=True)
        # chunked prefill: one (B=1, C) step reused for every slot; chunk=1
        # falls back to the token-by-token teacher-forced path (the
        # equivalence baseline in tests)
        self.chunk_step = (
            build_chunk_prefill_step(cfg, mesh, ctx, C=self.chunk,
                                     S_cache=max_len)
            if self.chunk > 1 else None)
        # the cache, stacked over the mesh from its global view
        # (cache_structs shapes, laid out by the decode step's specs)
        structs, _ = model_api.cache_structs(cfg, mesh, ctx, self.B, self.S)
        self._specs = self.decode_step.cache_specs
        self.cache = {
            k: torch.zeros(local_shape(st.shape, mesh, self._specs[k]),
                           dtype=st.dtype, device=self.device)
            for k, st in structs.items() if k != "pos"}
        # every leaf is (L, B, ...): the slot axes are the batch dim's
        self._slot_axes = next(spec for n, spec in self._specs.items()
                               if n != "pos")[1] or ()
        if isinstance(self._slot_axes, str):
            self._slot_axes = (self._slot_axes,)
        self.queue: List[GenRequest] = []
        self.preempted: List[GenRequest] = []
        self.active: Dict[int, GenRequest] = {}
        self.free_slots = list(range(slots))
        self.pending = np.zeros((slots, 1), np.int32)
        # authoritative per-slot device positions (rows written); the device
        # copy is re-asserted from this after every decode step
        self.host_pos = np.zeros((slots,), np.int32)
        self._set_pos(self.host_pos)
        self.steps = 0
        self.device_calls = 0
        self._arrival = 0
        self._all: List[GenRequest] = []
        # rank-death recovery (docs/RESILIENCE.md): deaths scheduled on the
        # context's FaultPlan fire in step(); dead ranks leave the scheduling
        # set, their pages drain (graceful) or their requests requeue
        self.faults = context.fault_plan
        self.dead_ranks: set = set()
        self.rank_death_log: List[tuple] = []
        self.requeued = 0
        # SLO layer (docs/SERVING.md "Overload & SLOs"): injectable clock
        # (every timestamp in the engine reads it), optional admission
        # controller, spill-rank circuit breaker.  With slo=None behavior
        # is identical to the pre-SLO engine except that timestamps come
        # from `clock` and explicit per-submit deadlines are *recorded*
        # (never enforced) — that is the bench's admit-everything baseline.
        self.clock = clock if clock is not None else time.perf_counter
        self._now = self.clock()
        self.slo_log: List[tuple] = []   # (event, ...) decision record
        self.shed: Dict[str, int] = {}   # per-reason shed counters
        self.tokens_wasted = 0           # tokens generated for cancelled reqs
        self.tokens_late = 0             # tokens committed past total deadline
        self.slo_ctl = (AdmissionController(slo, self.clock,
                                            log=self.slo_log)
                        if slo is not None else None)
        # one exhausted migrate budget marks a spill rank sick: quarantine
        # immediately, probe again after the cooldown
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=1, cooldown_s=0.5, clock=self.clock)

    # -- API --------------------------------------------------------------
    def submit(self, prompt, max_new: int = 32, *, priority: int = 0,
               ttft_deadline_s: Optional[float] = None,
               total_deadline_s: Optional[float] = None) -> GenRequest:
        """Submit a request.  Returns the :class:`GenRequest` either way;
        with an SLO policy attached its ``decision`` field carries the
        explicit admit / backpressure / reject verdict, and a rejected
        request is NOT queued (``done`` stays False, ``shed_reason`` set).

        ``ttft_deadline_s`` / ``total_deadline_s`` are RELATIVE deadlines
        (seconds from now); omitted ones fall back to the request's SLO
        tier.  Without an SLO policy, explicit deadlines are recorded for
        measurement but never enforced — the admit-everything baseline.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.S - 1:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds the "
                f"cache ({self.S} rows, one reserved for slot parking)")
        if self.chunk_step is not None \
                and -(-len(prompt) // self.chunk) * self.chunk > self.S:
            # the final chunk is padded to full width and written in place:
            # its whole span must fit the cache or the device write would
            # clamp and corrupt live rows
            raise ValueError(
                f"prompt {len(prompt)} needs "
                f"{-(-len(prompt) // self.chunk) * self.chunk} cache rows "
                f"for chunked prefill (chunk {self.chunk}, cache {self.S}); "
                f"lower prefill_chunk or raise max_len")
        now = self.clock()
        if self.slo_ctl is not None:
            tier = self.slo_ctl.policy.tier(priority)
            if ttft_deadline_s is None:
                ttft_deadline_s = tier.ttft_deadline_s
            if total_deadline_s is None:
                total_deadline_s = tier.total_deadline_s
        r = GenRequest(prompt=prompt, max_new=max_new, priority=priority,
                       arrival=self._arrival, submit_t=now)
        if ttft_deadline_s is not None:
            r.ttft_deadline = now + float(ttft_deadline_s)
        if total_deadline_s is not None:
            r.total_deadline = now + float(total_deadline_s)
        r._rng = np.random.default_rng(self.seed * 1_000_003 + self._arrival)
        self._arrival += 1
        self._all.append(r)
        if self.slo_ctl is not None:
            dec = self.slo_ctl.decide(
                priority=priority, prompt_len=len(prompt), max_new=max_new,
                chunk=self.chunk, queue_depth=len(self.queue),
                ttft_deadline_s=ttft_deadline_s,
                total_deadline_s=total_deadline_s)
            r.decision = dec
            self.slo_log.append(("submit", r.arrival, dec.action, dec.reason,
                                 priority, int(len(prompt)), int(max_new)))
            if not dec.admitted:
                r.shed_reason = dec.reason
                self.shed[dec.reason] = self.shed.get(dec.reason, 0) + 1
                return r
        self.queue.append(r)
        return r

    def run(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not (self.active or self.queue or self.preempted):
                break
            self.step()
        return self

    def step(self) -> None:
        """One engine iteration: shed/cancel expired work, update the
        degraded-mode ladder, preempt-on-pressure, admit/resume, chunked
        prefill for filling slots, one decode step for decode-ready slots."""
        self.steps += 1
        self._now = self.clock()
        if self.faults is not None:
            for death in self.faults.deaths_at(self.steps):
                self.on_rank_death(death.rank, graceful=death.graceful)
        if self.slo_ctl is not None:
            self._shed_expired()
            self.slo_ctl.update_pressure(len(self.queue), self.steps)
        self._maybe_preempt()
        self._admit()
        if not self.active:
            return
        self._prefill_chunks()
        self._decode()

    # -- deadline shedding / cancellation (SLO layer) -----------------------
    def _shed(self, req: GenRequest, reason: str) -> None:
        req.shed_reason = reason
        self.shed[reason] = self.shed.get(reason, 0) + 1
        self.slo_log.append(("shed", self.steps, req.arrival, reason))

    def _cancel(self, req: GenRequest, reason: str) -> None:
        """Cancel an admitted (active or preempted) request: free its slot,
        release its KV pages back to the allocator (accounted in the
        ledger), unregister its RMA window, count its generated tokens as
        wasted work."""
        slot = req.slot
        if slot >= 0 and self.active.get(slot) is req:
            del self.active[slot]
            self.free_slots.append(slot)
            self.pending[slot, 0] = 0
            self.host_pos[slot] = 0
            self._set_pos(self.host_pos)
        elif req in self.preempted:
            self.preempted.remove(req)
        if req.kv is not None:
            try:
                self.dctx.rma.unregister(self._win(req))
            except RMAError:
                pass
            self.alloc.release(req.kv)
            req.kv = None
        req.slot = -1
        req._snapshot = None
        self.tokens_wasted += len(req.out)
        self._shed(req, reason)

    def _shed_expired(self) -> None:
        """Deadline enforcement, once per step BEFORE admission: expired
        queued requests are shed (no resources were ever bound); queued
        requests that can no longer make their deadline even if admitted
        this instant are shed as hopeless; admitted requests past their
        deadline are cancelled with pages freed."""
        now = self._now
        p = self.slo_ctl.policy
        for req in list(self.queue):
            reason = None
            if req.ttft_deadline is not None and now > req.ttft_deadline:
                reason = "queue_expired"
            elif req.total_deadline is not None and now + p.min_service_s(
                    len(req.prompt), req.max_new,
                    self.chunk) > req.total_deadline:
                reason = "hopeless"
            elif req.ttft_deadline is not None and now + p.min_ttft_s(
                    len(req.prompt), self.chunk) > req.ttft_deadline:
                reason = "hopeless"
            if reason is not None:
                self.queue.remove(req)
                self._shed(req, reason)
        for req in list(self.active.values()) + list(self.preempted):
            if req.total_deadline is not None and now > req.total_deadline:
                self._cancel(req, "expired")
            elif req.first_token_t is None \
                    and req.ttft_deadline is not None \
                    and now > req.ttft_deadline:
                self._cancel(req, "ttft_expired")

    # -- scheduling ---------------------------------------------------------
    @staticmethod
    def _order(reqs: List[GenRequest]) -> List[GenRequest]:
        return sorted(reqs, key=lambda r: (-r.priority, r.arrival))

    def _live_ranks(self) -> List[int]:
        return [r for r in range(self.memory.nranks)
                if r not in self.dead_ranks]

    def _home(self, slot: int) -> int:
        # every ACTIVE request's pages live on the controller heap (the
        # lowest LIVE rank; rank 0 until it dies), so freeing a victim's
        # pages always relieves the rank the OOM'd request allocates from;
        # preempted requests park on spill ranks
        del slot
        live = self._live_ranks()
        return live[0] if live else 0

    def _spill(self, req: GenRequest) -> int:
        # round-robin over the live non-home ranks so swapped-out requests
        # spread across the remote heaps; ranks whose migrate breaker is
        # open are routed around (returning home_rank makes the preemption
        # recompute-style: migrate is a no-op, pages drop, snapshot holds)
        live = [r for r in self._live_ranks() if r != req.kv.home_rank]
        if not live:
            return req.kv.home_rank
        if self.slo_ctl is not None and self.slo_ctl.level >= 3:
            return req.kv.home_rank     # L3 degraded: spill suspended
        start = req.kv.rid % len(live)
        for r in live[start:] + live[:start]:
            if self.breaker.allow(("migrate", r)):
                return r
        return req.kv.home_rank         # every spill target quarantined

    def _migrate(self, req: GenRequest, dst: int) -> int:
        """``alloc.migrate`` with circuit-breaker accounting: an exhausted
        retry budget (RMAError; the allocator already rolled the
        destination pages back) records a breaker failure for
        ``("migrate", dst)`` and reports 0 bytes moved; a successful move
        records a success with the retry-ledger delta it cost."""
        if req.kv is None or dst == req.kv.home_rank:
            return 0
        key = ("migrate", dst)
        before = self.alloc.stats["retried_page_puts"]
        try:
            moved = self.alloc.migrate(req.kv, dst, **self._migrate_kw(req))
        except RMAError:
            state = self.breaker.record_failure(key)
            self.slo_log.append(
                ("breaker", self.steps, dst, "failure", state))
            return 0
        if moved:
            self.breaker.record_success(
                key, retries=self.alloc.stats["retried_page_puts"] - before)
        return moved

    def _win(self, req: GenRequest) -> str:
        return f"kv/req{req.kv.rid}"

    def _migrate_kw(self, req: GenRequest) -> dict:
        kw = dict(comm=self._comm, tracker=self.dctx.rma,
                  window=self._win(req))
        if self.faults is not None:
            # chaos active: validate every page transfer get-side so an
            # injected corrupt/drop is detected and re-put, never absorbed
            kw.update(faults=self.faults, policy=self.dctx.retry_policy,
                      validate=True)
        return kw

    def _admit(self) -> None:
        # resumptions first: preempted requests hold committed progress
        for req in self._order(list(self.preempted)):
            if not self.free_slots:
                break
            slot = self.free_slots[-1]
            home = self._home(slot)
            if req.kv.page_table:
                if req.kv.home_rank != home \
                        and self._migrate(req, home) == 0:
                    continue        # spill heap -> home heap OOM: wait
            else:
                req.kv.home_rank = home
                if not self.alloc.reserve(req.kv, req.kv.pos + 1):
                    continue
            self.free_slots.pop()
            self.preempted.remove(req)
            self._restore(slot, req)
        for req in self._order(self.queue):
            if not self.free_slots:
                break
            slot = self.free_slots[-1]
            if self.slo_ctl is not None and self.slo_ctl.level >= 1 \
                    and self.slo_ctl.policy.degraded_max_new is not None:
                # L1 degraded: fresh admissions get a capped token budget
                # (shed load by finishing sooner, not by rejecting more)
                req.max_new = min(req.max_new,
                                  self.slo_ctl.policy.degraded_max_new)
            kv = self.alloc.admit(len(req.prompt),
                                  len(req.prompt) + req.max_new,
                                  home_rank=self._home(slot))
            if kv is None:
                break                      # KV OOM — wait for a release
            self.free_slots.pop()
            self.queue.remove(req)
            req.kv = kv
            req.slot = slot
            req.admit_t = self.clock()
            req.admit_step = self.steps
            self.dctx.rma.register(self._win(req))
            self.pending[slot, 0] = 0
            self.host_pos[slot] = 0
            self.active[slot] = req

    def _restore(self, slot: int, req: GenRequest) -> None:
        if req._snapshot is not None:
            self._write_slot(slot, req._snapshot)
            req._snapshot = None
        req.slot = slot
        self.active[slot] = req
        self.host_pos[slot] = req.kv.pos
        self.pending[slot, 0] = 0

    # -- preemption (RMA swap to a spill rank) ------------------------------
    def _pick_victim(self, exclude: Optional[int] = None) -> Optional[int]:
        cands = [s for s in self.active if s != exclude]
        if not cands:
            return None
        return max(cands, key=lambda s: (-self.active[s].priority,
                                         self.active[s].arrival))

    def _preempt(self, slot: int) -> None:
        req = self.active.pop(slot)
        # the swap payload: this slot's device rows, snapshotted host-side
        # (the same rows are what the one-sided page transfers below move
        # between heaps)
        req._snapshot = {k: self._slot_rows(v, slot).cpu()
                         for k, v in self.cache.items() if k != "pos"}
        moved = self._migrate(req, self._spill(req))
        if moved == 0 and req.kv.page_table:
            # spill heap full (or single-rank deployment): the swap moved
            # nothing, so drop the page plan instead — the snapshot above
            # holds the rows and resume re-reserves pages.  Either way a
            # preemption always relieves home-rank pressure.
            self.alloc.drop_pages(req.kv)
        req.preemptions += 1
        req.slot = -1
        self.free_slots.append(slot)
        self.pending[slot, 0] = 0
        self.host_pos[slot] = 0
        self.preempted.append(req)

    def _maybe_preempt(self) -> None:
        while len(self.active) > 1:
            homes = {req.kv.home_rank for req in self.active.values()}
            if self.alloc.pressure(homes) <= self.high_watermark:
                break
            self._preempt(self._pick_victim())
            homes = {req.kv.home_rank for req in self.active.values()}
            if self.alloc.pressure(homes) <= self.low_watermark:
                break

    # -- rank death (docs/RESILIENCE.md lifecycle) --------------------------
    def on_rank_death(self, rank: int, *, graceful: bool = False) -> None:
        """Remove ``rank`` from the serving set.

        ``graceful`` (the rank announced eviction): its requests' paged KV
        drains to surviving ranks over the one-sided ``migrate`` path
        first.  Abrupt: pages homed there are gone — preempted requests
        survive on their host row snapshots (resume re-reserves pages);
        active requests requeue from scratch.  Either way the scheduler's
        rank set shrinks and latency stats keep flowing.
        """
        if rank in self.dead_ranks or not (0 <= rank < self.memory.nranks):
            return
        live_after = [r for r in self._live_ranks() if r != rank]
        if not live_after:
            raise RuntimeError("cannot remove the last live rank")
        holders = [r for r in (list(self.active.values())
                               + list(self.preempted))
                   if r.kv is not None and r.kv.home_rank == rank
                   and r.kv.page_table]
        drained, lost = 0, []
        if graceful:
            for req in holders:
                dst = live_after[req.kv.rid % len(live_after)]
                moved = self._migrate(req, dst)
                if moved:
                    drained += moved
                else:
                    lost.append(req)    # surviving heaps full: treat as lost
        else:
            lost = holders
        self.dead_ranks.add(rank)
        # purge the free list, forget remaining page tables homed there
        self.alloc.forget_rank(rank)
        for req in lost:
            if req in self.preempted:
                # pages gone, but the host snapshot holds the rows:
                # recompute-style resume (reserve at re-admission)
                continue
            self._requeue(req)
        self.rank_death_log.append(
            (self.steps, rank, graceful, drained, len(lost)))

    def _requeue(self, req: GenRequest) -> None:
        """An active request lost its KV pages: reset all generation
        progress and put it back on the arrival queue (priority kept)."""
        slot = req.slot
        if slot >= 0 and self.active.get(slot) is req:
            del self.active[slot]
            self.free_slots.append(slot)
            self.pending[slot, 0] = 0
            self.host_pos[slot] = 0
            self._set_pos(self.host_pos)
        try:
            self.dctx.rma.unregister(self._win(req))
        except RMAError:
            pass
        if req.kv is not None:
            self.alloc.forget_pages(req.kv)
            self.alloc.forget(req.kv)
            req.kv = None
        req.slot = -1
        req.fed = 0
        req.out = []
        req.done = False
        req._snapshot = None
        # deterministic replay: the fresh attempt samples the same stream
        req._rng = np.random.default_rng(
            self.seed * 1_000_003 + req.arrival)
        self.requeued += 1
        self.queue.append(req)

    # -- chunked prefill ----------------------------------------------------
    def _set_pos(self, pos: np.ndarray) -> None:
        """The per-slot device positions, laid out like the batch."""
        self.cache["pos"] = stack_shards(pos.astype(np.int32), self.mesh,
                                         self._specs["pos"],
                                         device=self.device)

    def _slot_index(self, slot: int):
        """Index of a cache leaf ``(*mesh, L, B_loc, ...)`` that selects the
        ranks holding ``slot`` along the batch axes and its local row."""
        shards = [self.mesh.shape[a] for a in self._slot_axes]
        b_loc = self.B // int(np.prod(shards)) if shards else self.B
        shard, local = divmod(slot, b_loc)
        coords = dict(zip(self._slot_axes,
                          np.unravel_index(shard, shards) if shards else ()))
        return tuple(slice(int(coords[a]), int(coords[a]) + 1)
                     if a in coords else slice(None)
                     for a in self.mesh.axis_names) \
            + (slice(None), slice(local, local + 1))

    def _slot_rows(self, t: torch.Tensor, slot: int) -> torch.Tensor:
        """One slot's rows of a cache leaf, replicated over the batch axes
        (the B = 1 layout of the chunk step)."""
        rows = t[self._slot_index(slot)]
        return rows.expand(*self.mesh.sizes, *rows.shape[self.mesh.ndim:]) \
            .contiguous()

    def _slot_cache(self, slot: int) -> dict:
        sl = {k: self._slot_rows(v, slot)
              for k, v in self.cache.items() if k != "pos"}
        sl["pos"] = torch.full(self.mesh.sizes, int(self.host_pos[slot]),
                               dtype=torch.int32, device=self.device)
        return sl

    def _write_slot(self, slot: int, sl: dict) -> None:
        idx = self._slot_index(slot)
        for k, v in sl.items():
            if k != "pos":
                self.cache[k][idx].copy_(v[idx[:self.mesh.ndim]])

    def _prefill_chunks(self) -> None:
        if self.chunk_step is None:
            return                      # legacy: prompts feed through decode
        cap = self.chunk
        if self.slo_ctl is not None and self.slo_ctl.level >= 2 \
                and self.slo_ctl.policy.degraded_chunk is not None:
            # L2 degraded: feed fewer prompt tokens per device call so
            # decode-ready slots keep their share of the engine loop (the
            # device call shape stays (1, chunk); only `take` shrinks)
            cap = max(1, min(cap, self.slo_ctl.policy.degraded_chunk))
        for slot in sorted(self.active):
            req = self.active[slot]
            plen = len(req.prompt)
            if req.fed >= plen:
                continue
            take = min(cap, plen - req.fed)
            toks = np.zeros((1, self.chunk), np.int32)
            toks[0, :take] = req.prompt[req.fed:req.fed + take]
            step = self.chunk_step
            with use_default(self.dctx):
                logits, sl = step(
                    self.params,
                    stack_shards(toks, self.mesh, step.token_spec,
                                 device=self.device, dtype=torch.int64),
                    self._slot_cache(slot), take)
            self._write_slot(slot, sl)
            req.fed += take
            req.kv.pos += take          # rows actually written, nothing else
            self.host_pos[slot] = req.fed
            req.prefill_steps += 1
            self.device_calls += 1
            if req.fed >= plen:
                # the final chunk's last-position logits commit the first
                # generated token (prefill produces token 1 of max_new)
                row = unstack_shards(logits, self.mesh,
                                     step.logits_spec)[0, 0]
                self._commit(slot, req, row)

    # -- decode -------------------------------------------------------------
    def _decode(self) -> None:
        if self.chunk_step is None:
            ready = sorted(self.active)
        else:
            ready = sorted(s for s, r in self.active.items()
                           if r.fed >= len(r.prompt))
        # capacity BEFORE the device write: one page alloc at most per slot;
        # on OOM, preempt the lowest-priority victim and retry
        for slot in list(ready):
            if slot not in self.active:
                continue
            req = self.active[slot]
            while not self.alloc.extend(req.kv):
                # victim = lowest priority / latest arrival among ALL
                # active slots — if that is the requester itself, it yields
                # (never evict a higher-priority request to keep a lower-
                # priority one decoding)
                victim = self._pick_victim()
                self._preempt(victim if victim is not None else slot)
                if victim is None or victim == slot:
                    break
        ready = [s for s in ready if s in self.active]
        if not ready:
            return
        for slot in ready:
            req = self.active[slot]
            if self.chunk_step is None and req.fed < len(req.prompt):
                self.pending[slot, 0] = req.prompt[req.fed]
            else:
                self.pending[slot, 0] = req.out[-1] if req.out else 0
        # park every other slot on the reserved scratch row S-1: its write
        # cannot touch live rows and the true positions are re-asserted below
        dev_pos = np.full((self.B,), self.S - 1, np.int32)
        for slot in ready:
            dev_pos[slot] = self.host_pos[slot]
        self._set_pos(dev_pos)
        step = self.decode_step
        with use_default(self.dctx):
            logits, self.cache = step(
                self.params,
                stack_shards(self.pending, self.mesh, step.token_spec,
                             device=self.device, dtype=torch.int64),
                self.cache)
        self.device_calls += 1
        rows = unstack_shards(logits, self.mesh, step.logits_spec)
        for slot in ready:
            req = self.active.get(slot)
            if req is None:
                continue
            req.kv.pos += 1
            self.host_pos[slot] += 1
            req.decode_steps += 1
            if self.chunk_step is None and req.fed < len(req.prompt):
                req.fed += 1
                if req.fed < len(req.prompt):
                    continue               # still prefilling: ignore logits
            self._commit(slot, req, rows[slot, 0])
        # authoritative positions back onto the device (parked slots kept)
        self._set_pos(self.host_pos)

    # -- commit / sampling / release ----------------------------------------
    def _sample(self, req: GenRequest, row: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(row.argmax())
        z = row.astype(np.float64) / max(self.temperature, 1e-6)
        if self.top_k > 0 and self.top_k < len(z):
            keep = np.argpartition(z, -self.top_k)[-self.top_k:]
        else:
            keep = np.arange(len(z))
        zk = z[keep] - z[keep].max()
        p = np.exp(zk)
        p /= p.sum()
        return int(req._rng.choice(keep, p=p))

    def _commit(self, slot: int, req: GenRequest, row: np.ndarray) -> None:
        req.out.append(self._sample(req, row))
        now = self.clock()
        if req.first_token_t is None:
            req.first_token_t = now
        if req.total_deadline is not None and now > req.total_deadline:
            # a token served past the deadline is wasted work the SLO
            # engine sheds pre-emptively; the baseline accumulates these
            self.tokens_late += 1
        if len(req.out) >= req.max_new:
            self._finish(slot, req)

    def _finish(self, slot: int, req: GenRequest) -> None:
        req.done = True
        req.finish_t = self.clock()
        req.finish_step = self.steps
        self.dctx.rma.unregister(self._win(req))
        self.alloc.release(req.kv)
        del self.active[slot]
        self.free_slots.append(slot)
        # no stale state may leak into the next tenant of this slot: clear
        # the pending token and the device position (the seed engine left
        # both behind, so freed slots kept teacher-forcing garbage)
        self.pending[slot, 0] = 0
        self.host_pos[slot] = 0
        self._set_pos(self.host_pos)

    # -- introspection -------------------------------------------------------
    @property
    def kv_stats(self):
        s = dict(self.alloc.stats)
        live = self.alloc.live_pages()
        # the allocator ledger must balance: every page handed out is either
        # live in a page table or back on the free list
        assert s["pages_allocated"] - s["pages_freed"] == live, \
            (s["pages_allocated"], s["pages_freed"], live)
        s["live_pages"] = live
        s["free_list_pages"] = self.alloc.free_list_pages()
        s["ptr_cache_hit_rate"] = self.memory.ptr_cache.hit_rate
        return s

    def latency_stats(self) -> dict:
        done = [r for r in self._all if r.done]
        ttft = [r.first_token_t - r.submit_t for r in done
                if r.first_token_t is not None]
        total = [r.finish_t - r.submit_t for r in done
                 if r.finish_t is not None]
        toks = sum(len(r.out) for r in done)
        # goodput = deadline-met completions (the SLO layer's objective);
        # a finished request that missed a deadline it carried is a
        # violation (structurally zero under an SLO policy — violators are
        # cancelled before they can finish)
        good = [r for r in done if r.deadline_met()]

        def _agg(xs):
            if not xs:
                return None
            return {"mean": sum(xs) / len(xs),
                    **percentiles(xs, (50, 95, 99)),
                    "max": max(xs)}

        return {
            "requests_done": len(done),
            "tokens": toks,
            "engine_steps": self.steps,
            "device_calls": self.device_calls,
            "preemptions": sum(r.preemptions for r in self._all),
            "rank_deaths": len(self.rank_death_log),
            "requeued": self.requeued,
            "live_ranks": len(self._live_ranks()),
            "ttft_s": _agg(ttft),
            "request_s": _agg(total),
            "tokens_per_device_call": (toks / self.device_calls
                                       if self.device_calls else 0.0),
            # SLO surface (docs/SERVING.md "Overload & SLOs")
            "goodput": len(good),
            "goodput_tokens": sum(len(r.out) for r in good),
            "deadline_violations": len(done) - len(good),
            "shed": dict(self.shed),
            "shed_total": sum(self.shed.values()),
            "tokens_wasted": self.tokens_wasted,
            "tokens_late": self.tokens_late,
            "degrade_level": (self.slo_ctl.level
                              if self.slo_ctl is not None else 0),
            "breaker_open": len(self.breaker.open_keys()),
        }
