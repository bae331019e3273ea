"""Paged KV-cache allocator on the DiOMP PGAS heap.

This is the paper's *asymmetric allocation* machinery doing real work (the
serving design is documented in docs/SERVING.md; the layer map in
docs/ARCHITECTURE.md): every KV **page** is an asymmetric region (the
request's bytes live on its *home rank*; other ranks hold only the region
metadata), the per-request ``page_table`` is the second-level-pointer table
of paper Fig. 2 (uniformly allocated wrappers whose values point at ragged
payloads), and the remote-pointer cache amortizes repeated lookups — the
Fig. 2 (as-1) mechanism, reused as a vLLM-style page table.

Key properties (the whole point of this allocator vs the old
whole-region-realloc design, kept below as :class:`ReallocKVAllocator` for
the benchmark baseline):

* ``extend`` performs exactly ONE page allocation (call-log asserted in
  tests) instead of re-allocating the whole region — O(1) churn per token
  of growth instead of O(pages);
* ``release`` returns pages to a per-home-rank **free list**, so steady-
  state request churn causes ZERO arena traffic (audited against
  ``GlobalMemory.alloc_counts``);
* ``lookup`` resolves token -> (rank, byte offset) through the page table
  (one cached second-level-pointer dereference per page);
* ``migrate`` moves a request's pages to another rank's heap with
  one-sided RMA get/put semantics — the engine's preemption/swap path.

The allocator plans *addresses*; the device-side cache tensor is dense per
slot (the serve step's layout) and its bytes live in the engine's stacked
cache tensors on the card.  What the
plan buys at scale: KV for a preempted/migrated request is addressed on a
remote device's heap by (rank, offset) — one-sided, no registration
handshake.  The migration helper therefore records its page transfers
against the OMPCCL communicator call log (count under ``get``, payload
bytes under ``put`` — the same leaf-op byte accounting every delegating
verb uses) and the :class:`~repro_torch.core.rma.RMATracker` window of the
request.  Ported from the reference's ``serve/kvcache.py`` (pure Python).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.groups import DiompGroup
from ..core.pgas import AllocError, GlobalMemory, SecondLevelPtr
from ..core.rma import RMAError

__all__ = ["PagedKVAllocator", "ReallocKVAllocator", "Request"]


@dataclasses.dataclass
class Request:
    """One serving request's KV plan: a page table over the PGAS heap."""

    rid: int
    prompt_len: int
    max_len: int
    home_rank: int = 0
    page_table: List[SecondLevelPtr] = dataclasses.field(default_factory=list)
    pos: int = 0                # tokens written so far (engine-driven)
    done: bool = False
    # legacy field kept for the realloc baseline
    handle: Optional[SecondLevelPtr] = None

    @property
    def pages(self) -> List[int]:
        """Page indices (legacy surface; the table itself is page_table)."""
        return list(range(len(self.page_table)))


class PagedKVAllocator:
    """Page-granular KV planning over GlobalMemory's buddy arena.

    Every page is one ``page_bytes`` asymmetric region homed on
    ``home_rank`` (other ranks carry only the 32-byte second-level-pointer
    wrapper + minimal metadata), tracked in the request's ``page_table``.
    Released pages park on a per-home-rank free list and are handed out
    again before the arena is ever touched.
    """

    def __init__(self, memory: GlobalMemory, group: DiompGroup, *,
                 page_tokens: int = 128, kv_bytes_per_token: int = 2 * 2 * 128):
        self.memory = memory
        self.group = group
        self.page_tokens = page_tokens
        self.token_bytes = kv_bytes_per_token
        self.page_bytes = page_tokens * kv_bytes_per_token
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._free_pages: Dict[int, List[SecondLevelPtr]] = {}
        self.dead_ranks: set = set()
        # (event, ...) tuples; tests assert the per-op allocation counts
        self.call_log: List[Tuple] = []
        self.stats = {
            "pages_allocated": 0,   # pages handed to requests (incl. reuse)
            "pages_freed": 0,       # pages returned (free list or rollback)
            "arena_page_allocs": 0,  # actual GlobalMemory allocations
            "page_reuses": 0,       # free-list hits
            "oom_events": 0,
            "migrations": 0,
            "bytes_migrated": 0,
            "pages_lost": 0,        # pages on a dead rank (subset of freed)
            "retried_page_puts": 0,  # re-issued page transfers (faults)
        }
        # watermark-pressure denominator; the buddy allocator rounds each
        # page up to a power-of-two block, so size pages accordingly for an
        # exact capacity (docs/SERVING.md "knobs")
        self.capacity_pages = max(
            1, memory.segment_bytes // max(self.page_bytes, 1))

    # -- page pool ------------------------------------------------------------
    def _alloc_page(self, home: int, rid: int, idx: int) -> Optional[SecondLevelPtr]:
        if home in self.dead_ranks:
            return None
        free = self._free_pages.get(home)
        if free:
            slp = free.pop()
            self.stats["page_reuses"] += 1
            self.call_log.append(("page_reuse", home))
        else:
            sizes = [self.page_bytes if r == home else 0
                     for r in range(self.memory.nranks)]
            try:
                slp = self.memory.alloc_asymmetric(
                    f"kv/r{rid}/p{idx}", sizes, self.group)
            except AllocError:
                return None
            self.stats["arena_page_allocs"] += 1
            self.call_log.append(("arena_alloc", home))
        self.stats["pages_allocated"] += 1
        return slp

    def _release_page(self, slp: SecondLevelPtr, home: int) -> None:
        self._free_pages.setdefault(home, []).append(slp)
        self.stats["pages_freed"] += 1

    # -- request lifecycle ----------------------------------------------------
    def admit(self, prompt_len: int, max_len: int, *,
              home_rank: int = 0) -> Optional[Request]:
        """Allocate pages for the prompt + one growth page; None if OOM."""
        rid = self._next_rid
        pages_needed = -(-max(prompt_len, 1) // self.page_tokens) + 1
        table: List[SecondLevelPtr] = []
        for i in range(pages_needed):
            page = self._alloc_page(home_rank, rid, i)
            if page is None:
                for p in table:          # rollback to the free list
                    self._release_page(p, home_rank)
                self.stats["oom_events"] += 1
                self.call_log.append(("admit_oom", rid))
                return None
            table.append(page)
        req = Request(rid=rid, prompt_len=prompt_len, max_len=max_len,
                      home_rank=home_rank, page_table=table, pos=0)
        self.requests[rid] = req
        self._next_rid += 1
        self.call_log.append(("admit", rid, pages_needed))
        return req

    def extend(self, req: Request) -> bool:
        """Ensure capacity for ``req.pos + 1`` tokens — AT MOST one page
        allocation (the O(1) growth the page table exists for)."""
        if req.pos < len(req.page_table) * self.page_tokens:
            return True
        page = self._alloc_page(req.home_rank, req.rid, len(req.page_table))
        if page is None:
            self.stats["oom_events"] += 1
            self.call_log.append(("extend_oom", req.rid))
            return False
        req.page_table.append(page)
        self.call_log.append(("extend", req.rid, 1))
        return True

    def reserve(self, req: Request, tokens: int) -> bool:
        """Grow the page table to cover ``tokens`` rows (the resume path
        after a recompute-style preemption dropped the pages)."""
        while len(req.page_table) * self.page_tokens < tokens:
            page = self._alloc_page(req.home_rank, req.rid,
                                    len(req.page_table))
            if page is None:
                self.stats["oom_events"] += 1
                self.call_log.append(("reserve_oom", req.rid))
                return False
            req.page_table.append(page)
            self.call_log.append(("reserve", req.rid, 1))
        return True

    def drop_pages(self, req: Request) -> int:
        """Return a live request's pages to the free list WITHOUT releasing
        the request (recompute-style preemption: the engine holds the row
        snapshot and re-``reserve``s pages at resume).  Returns the count."""
        n = len(req.page_table)
        for page in req.page_table:
            self._release_page(page, req.home_rank)
        req.page_table = []
        self.call_log.append(("drop_pages", req.rid, n))
        return n

    def release(self, req: Request) -> None:
        for page in req.page_table:
            self._release_page(page, req.home_rank)
        self.call_log.append(("release", req.rid, len(req.page_table)))
        req.page_table = []
        req.done = True
        del self.requests[req.rid]

    # -- preemption / migration ----------------------------------------------
    def migrate(self, req: Request, dst_rank: int, *, comm=None,
                tracker=None, window: Optional[str] = None,
                faults=None, policy=None, validate: bool = False) -> int:
        """Move every page of ``req`` to ``dst_rank``'s heap; returns bytes.

        Per page: allocate a destination page, issue a one-sided transfer
        (dst-side ``get`` of page_bytes — recorded on the OMPCCL
        communicator handle and the RMA tracker window, see module
        docstring), then return the source page to its free list.  One
        fence completes the epoch.

        ``validate=True`` turns on get-side integrity checking: each page
        transfer carries a content digest, is fenced and validated through
        the tracker, and a digest mismatch (an injected ``corrupt``/
        ``drop`` from ``faults``) is repaired by re-putting the page —
        retried wire traffic lands in the tracker/communicator *retry*
        logs, so the logical byte-parity audits still hold.  The default
        path (no validation) is byte-for-byte the historical one: N puts,
        one fence.
        """
        import numpy as np

        from ..core.resilience import content_digest, corrupt_digest

        if dst_rank == req.home_rank:
            return 0
        name = window or f"kv/req{req.rid}"
        pagebuf = np.zeros((self.page_bytes,), np.uint8)
        new_table: List[SecondLevelPtr] = []
        for i, _old in enumerate(req.page_table):
            page = self._alloc_page(dst_rank, req.rid, i)
            if page is None:
                # roll the partial destination back; caller keeps the source
                # and NOTHING is recorded (no bytes moved on a failed swap)
                for p in new_table:
                    self._release_page(p, dst_rank)
                self.stats["oom_events"] += 1
                self.call_log.append(("migrate_oom", req.rid, dst_rank))
                return 0
            new_table.append(page)
        digest = content_digest(pagebuf) if validate else None
        budget = policy.budget("migrate") if policy is not None else 3
        try:
            for _ in new_table:
                attempt = 0
                pending = []      # faults hit on this page, not yet repaired
                while True:
                    fault = faults.next_fault("migrate") \
                        if faults is not None else None
                    wire = digest
                    if fault is not None:
                        if fault.kind == "delay":
                            fault.recovered = True
                        elif validate:
                            # damaged in flight: a wrong digest lands
                            wire = corrupt_digest(digest, fault.call_index)
                            pending.append(fault)
                    if comm is not None:
                        if attempt == 0:
                            # one-sided read of the page: count under "get",
                            # payload bytes under the leaf "put" (the
                            # communicator's delegating-op convention, so wire
                            # volume is never double-counted)
                            comm.record("get")
                            comm.record("put", pagebuf)
                        else:
                            comm.record_retry("put", pagebuf)
                    if tracker is not None:
                        tracker.on_put(name, self.page_bytes,
                                       checksum=wire, retry=attempt > 0)
                    if not validate or tracker is None:
                        break
                    tracker.on_fence(name)
                    try:
                        tracker.validate(name, digest)
                    except RMAError:
                        attempt += 1
                        self.stats["retried_page_puts"] += 1
                        if attempt > budget:
                            raise
                        continue
                    for hit in pending:   # a clean re-put repaired these
                        hit.recovered = True
                    break
        except RMAError:
            # budget exhausted mid-migration: the source pages are intact
            # (nothing released yet), so roll the destination table back to
            # its free list — otherwise the allocated-minus-freed == live
            # ledger breaks the moment a caller catches this error.  The
            # caller (engine/circuit-breaker) decides whether dst is sick.
            for p in new_table:
                self._release_page(p, dst_rank)
            self.call_log.append(("migrate_failed", req.rid, dst_rank))
            raise
        for old in req.page_table:
            self._release_page(old, req.home_rank)
        if tracker is not None and not validate:
            tracker.on_fence(name)
        moved = len(new_table) * self.page_bytes
        self.call_log.append(
            ("migrate", req.rid, req.home_rank, dst_rank, len(new_table)))
        req.page_table = new_table
        req.home_rank = dst_rank
        self.stats["migrations"] += 1
        self.stats["bytes_migrated"] += moved
        return moved

    # -- rank death -----------------------------------------------------------
    def forget_pages(self, req: Request) -> int:
        """A request's pages are GONE (their home rank died): unmap them
        without recycling.  Lost pages count under ``pages_lost`` AND
        ``pages_freed`` so the allocated-minus-freed == live ledger stays
        balanced.  Returns the count."""
        n = len(req.page_table)
        if n == 0:
            return 0
        for slp in req.page_table:
            self.memory.free(slp)
        req.page_table = []
        self.stats["pages_freed"] += n
        self.stats["pages_lost"] += n
        self.call_log.append(("forget_pages", req.rid, n))
        return n

    def forget(self, req: Request) -> None:
        """Drop a request whose pages were forgotten (no release recycling)."""
        req.page_table = []
        self.requests.pop(req.rid, None)
        self.call_log.append(("forget", req.rid))

    def forget_rank(self, rank: int) -> int:
        """Rank ``rank`` died abruptly: purge its free list, forget every
        tracked request's pages homed there, and refuse future allocations
        on it.  Returns pages lost from live requests (the engine decides
        what to do with their owners)."""
        self.dead_ranks.add(rank)
        for slp in self._free_pages.pop(rank, []):
            self.memory.free(slp)
        lost = 0
        for req in list(self.requests.values()):
            if req.home_rank == rank and req.page_table:
                lost += self.forget_pages(req)
        self.call_log.append(("rank_death", rank, lost))
        return lost

    # -- addressing -----------------------------------------------------------
    def lookup(self, req: Request, token_pos: int,
               rank: Optional[int] = None) -> Tuple[int, int]:
        """(rank, byte offset) of a token's KV — page-table indirection via
        the cached second-level pointer (paper Fig. 2 (as-1))."""
        page_idx, within = divmod(token_pos, self.page_tokens)
        slp = req.page_table[page_idx]
        r, base = self.memory.translate(
            slp, req.home_rank if rank is None else rank)
        return r, base + within * self.token_bytes

    # -- pressure / introspection ---------------------------------------------
    def live_pages(self, rank: Optional[int] = None) -> int:
        return sum(
            len(r.page_table) for r in self.requests.values()
            if rank is None or r.home_rank == rank)

    def free_list_pages(self, rank: Optional[int] = None) -> int:
        return sum(
            len(v) for k, v in self._free_pages.items()
            if rank is None or k == rank)

    def pressure(self, ranks=None) -> float:
        """max over ``ranks`` (default: all live) of live-KV-page
        utilization — the engine's watermark-preemption signal.  Dead
        ranks are excluded: their heaps no longer exist."""
        ranks = range(self.memory.nranks) if ranks is None else ranks
        util = [self.live_pages(r) / self.capacity_pages
                for r in ranks if r not in self.dead_ranks]
        return max(util, default=0.0)

    def trim(self) -> int:
        """Return every free-list page to the arena; returns pages trimmed."""
        n = 0
        for home, pages in self._free_pages.items():
            for slp in pages:
                self.memory.free(slp)
                n += 1
            pages.clear()
        return n

    @property
    def bytes_in_use(self) -> int:
        return self.memory.bytes_in_use(0)


class ReallocKVAllocator:
    """The pre-page-table design (whole-region realloc on every growth).

    Kept as the measured baseline for ``benchmarks/bench_kvcache.py``:
    ``extend`` re-allocates the ENTIRE region one page larger and frees the
    old one — O(pages) bytes of churn per page-boundary crossing, O(pages²)
    over a request's life — which is exactly the churn the page table
    eliminates.  Same stats surface as :class:`PagedKVAllocator` so the
    bench compares rows directly.
    """

    def __init__(self, memory: GlobalMemory, group: DiompGroup, *,
                 page_tokens: int = 128, kv_bytes_per_token: int = 2 * 2 * 128):
        self.memory = memory
        self.group = group
        self.page_tokens = page_tokens
        self.token_bytes = kv_bytes_per_token
        self.page_bytes = page_tokens * kv_bytes_per_token
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._npages: Dict[int, int] = {}
        self.stats = {
            "pages_allocated": 0, "pages_freed": 0, "arena_page_allocs": 0,
            "page_reuses": 0, "oom_events": 0, "migrations": 0,
            "bytes_migrated": 0,
        }

    def admit(self, prompt_len: int, max_len: int, *,
              home_rank: int = 0) -> Optional[Request]:
        rid = self._next_rid
        pages = -(-max(prompt_len, 1) // self.page_tokens) + 1
        sizes = [pages * self.page_bytes] * self.memory.nranks
        try:
            handle = self.memory.alloc_asymmetric(
                f"kv/req{rid}", sizes, self.group)
        except AllocError:
            self.stats["oom_events"] += 1
            return None
        req = Request(rid=rid, prompt_len=prompt_len, max_len=max_len,
                      home_rank=home_rank, pos=0, handle=handle)
        self.requests[rid] = req
        self._npages[rid] = pages
        self._next_rid += 1
        self.stats["pages_allocated"] += pages
        self.stats["arena_page_allocs"] += pages
        return req

    def extend(self, req: Request) -> bool:
        pages = self._npages[req.rid]
        if req.pos < pages * self.page_tokens:
            return True
        sizes = [(pages + 1) * self.page_bytes] * self.memory.nranks
        try:
            new = self.memory.alloc_asymmetric(
                f"kv/req{req.rid}p{pages}", sizes, self.group)
        except AllocError:
            self.stats["oom_events"] += 1
            return False
        self.memory.free(req.handle)
        req.handle = new
        self._npages[req.rid] = pages + 1
        # the realloc moves the whole region: pages+1 pages of fresh
        # allocation (and pages of copy+free) for ONE page of growth
        self.stats["pages_allocated"] += 1
        self.stats["arena_page_allocs"] += pages + 1
        return True

    def release(self, req: Request) -> None:
        if req.handle is not None:
            self.memory.free(req.handle)
            self.stats["pages_freed"] += self._npages.pop(req.rid)
            req.handle = None
        req.done = True
        del self.requests[req.rid]

    def lookup(self, req: Request, token_pos: int,
               rank: Optional[int] = None) -> Tuple[int, int]:
        r, base = self.memory.translate(
            req.handle, req.home_rank if rank is None else rank)
        return r, base + token_pos * self.token_bytes

    @property
    def bytes_in_use(self) -> int:
        return self.memory.bytes_in_use(0)
