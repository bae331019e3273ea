"""PGAS global memory for the DiOMP runtime.

The paper's §3.1–3.2 memory architecture:

* a **global segment** per rank (the GASNet-EX segment), carved up by a
  **linear** or **buddy** allocator;
* **symmetric allocation**: every rank allocates identical bytes, so a region
  is addressed remotely as ``(rank, offset)`` with one offset everywhere;
* **asymmetric allocation**: per-rank sizes differ; a uniformly-replicated
  **second-level pointer** (32-byte wrapper) holds each rank's actual address,
  and a **remote-pointer cache** avoids re-fetching it (paper Fig. 2 (as-1));
* a **centralized mapping table** shared by compute, P2P and collective layers
  (paper Fig. 1(b)).

What the runtime owns is the *address space plan*: which arena offsets a
logical region uses on which rank.  Every collective allocation goes through
a :class:`~repro_torch.core.coordination.ProcessCoordinator`: the identity
:class:`LocalCoordinator` in a single-process job, the gloo exchange
(:class:`~repro_torch.core.coordination.TorchCoordinator`) across
processes, where each process owns only its ranks' arenas.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .coordination import LocalCoordinator, ProcessCoordinator
from .groups import DiompGroup

__all__ = [
    "AllocError",
    "LocalCoordinator",
    "LinearAllocator",
    "BuddyAllocator",
    "Region",
    "SecondLevelPtr",
    "RemotePtrCache",
    "GlobalMemory",
]

_ALIGN = 256  # bytes; the CUDA allocator's own block alignment
_SLP_BYTES = 32  # the paper's 32-byte second-level pointer wrapper


def _align_up(n: int, a: int = _ALIGN) -> int:
    return (n + a - 1) // a * a


class AllocError(RuntimeError):
    """Out of segment space / invalid free."""


# ---------------------------------------------------------------------------
# allocators (paper: "strategies such as a linear heap allocator or a buddy
# allocator to build a unified PGAS global space")
# ---------------------------------------------------------------------------


class LinearAllocator:
    """Bump allocator with free-list coalescing — the paper's 'linear heap'."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        # sorted list of (offset, size) free extents
        self._free: List[Tuple[int, int]] = [(0, capacity)]
        self._live: Dict[int, int] = {}  # offset -> size

    def alloc(self, size: int) -> int:
        size = _align_up(max(size, 1))
        for i, (off, ext) in enumerate(self._free):
            if ext >= size:
                if ext == size:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + size, ext - size)
                self._live[off] = size
                return off
        raise AllocError(f"linear allocator: no extent for {size} bytes")

    def free(self, offset: int) -> None:
        size = self._live.pop(offset, None)
        if size is None:
            raise AllocError(f"invalid free at offset {offset}")
        self._free.append((offset, size))
        self._free.sort()
        # coalesce
        merged: List[Tuple[int, int]] = []
        for off, ext in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + ext)
            else:
                merged.append((off, ext))
        self._free = merged

    def free_extents(self) -> List[Tuple[int, int]]:
        """Sorted (offset, size) free extents — coordinated-alloc input."""
        return list(self._free)

    def alloc_at(self, offset: int, size: int) -> int:
        """Place ``size`` bytes at exactly ``offset`` (coordinated symmetric
        allocation: every rank commits the same offset)."""
        size = _align_up(max(size, 1))
        for i, (off, ext) in enumerate(self._free):
            if off <= offset and offset + size <= off + ext:
                pieces: List[Tuple[int, int]] = []
                if offset > off:
                    pieces.append((off, offset - off))
                if off + ext > offset + size:
                    pieces.append((offset + size, off + ext - offset - size))
                self._free[i:i + 1] = pieces
                self._live[offset] = size
                return offset
        raise AllocError(f"linear allocator: offset {offset} not free for "
                         f"{size} bytes")

    def alignment_for(self, size: int) -> int:
        del size
        return _ALIGN

    @property
    def bytes_in_use(self) -> int:
        return sum(self._live.values())

    @property
    def bytes_free(self) -> int:
        return sum(ext for _, ext in self._free)

    def check_invariants(self) -> None:
        """Free + live extents exactly tile [0, capacity) without overlap."""
        extents = sorted(
            [(o, s, "free") for o, s in self._free]
            + [(o, s, "live") for o, s in self._live.items()]
        )
        cursor = 0
        for off, size, _kind in extents:
            if off != cursor:
                raise AssertionError(f"gap/overlap at {cursor}..{off}")
            cursor = off + size
        if cursor != self.capacity:
            raise AssertionError(f"heap ends at {cursor}, capacity {self.capacity}")


class BuddyAllocator:
    """Power-of-two buddy allocator — the paper's alternative strategy.

    O(log n) alloc/free with bounded fragmentation; preferred for the
    serving KV-page arena where pages churn at high rate.
    """

    MIN_BLOCK = _ALIGN

    def __init__(self, capacity: int):
        cap = self.MIN_BLOCK
        while cap < capacity:
            cap <<= 1
        self.capacity = cap
        self._max_order = (cap // self.MIN_BLOCK).bit_length() - 1
        self._free: List[List[int]] = [[] for _ in range(self._max_order + 1)]
        self._free[self._max_order].append(0)
        self._live: Dict[int, int] = {}  # offset -> order

    def _order_for(self, size: int) -> int:
        size = max(size, self.MIN_BLOCK)
        order = 0
        block = self.MIN_BLOCK
        while block < size:
            block <<= 1
            order += 1
        return order

    def alloc(self, size: int) -> int:
        order = self._order_for(size)
        if order > self._max_order:
            raise AllocError(f"buddy: request {size} exceeds capacity")
        o = order
        while o <= self._max_order and not self._free[o]:
            o += 1
        if o > self._max_order:
            raise AllocError(f"buddy: no block of order {order}")
        off = self._free[o].pop()
        while o > order:  # split down
            o -= 1
            buddy = off + (self.MIN_BLOCK << o)
            self._free[o].append(buddy)
        self._live[off] = order
        return off

    def free(self, offset: int) -> None:
        order = self._live.pop(offset, None)
        if order is None:
            raise AllocError(f"buddy: invalid free at {offset}")
        while order < self._max_order:
            size = self.MIN_BLOCK << order
            buddy = offset ^ size
            if buddy in self._free[order]:
                self._free[order].remove(buddy)
                offset = min(offset, buddy)
                order += 1
            else:
                break
        self._free[order].append(offset)

    def free_extents(self) -> List[Tuple[int, int]]:
        """Sorted (offset, size) of free blocks (uncoalesced: adjacent buddy
        blocks of different parents cannot serve one allocation)."""
        return sorted(
            (off, self.MIN_BLOCK << o)
            for o, blocks in enumerate(self._free)
            for off in blocks
        )

    def alloc_at(self, offset: int, size: int) -> int:
        """Claim the block at exactly ``offset`` (must be block-aligned for
        the request's order), splitting a containing free block down."""
        order = self._order_for(size)
        bsize = self.MIN_BLOCK << order
        if offset % bsize:
            raise AllocError(f"buddy: offset {offset} misaligned for {size}")
        for o in range(order, self._max_order + 1):
            sz = self.MIN_BLOCK << o
            cand = (offset // sz) * sz
            if cand in self._free[o]:
                self._free[o].remove(cand)
                while o > order:  # split toward the requested offset
                    o -= 1
                    half = self.MIN_BLOCK << o
                    if offset < cand + half:
                        self._free[o].append(cand + half)
                    else:
                        self._free[o].append(cand)
                        cand = cand + half
                self._live[offset] = order
                return offset
        raise AllocError(f"buddy: offset {offset} not free for {size} bytes")

    def alignment_for(self, size: int) -> int:
        return self.MIN_BLOCK << self._order_for(size)

    @property
    def bytes_in_use(self) -> int:
        return sum(self.MIN_BLOCK << o for o in self._live.values())

    @property
    def bytes_free(self) -> int:
        return sum(len(blocks) * (self.MIN_BLOCK << o) for o, blocks in enumerate(self._free))

    def check_invariants(self) -> None:
        if self.bytes_in_use + self.bytes_free != self.capacity:
            raise AssertionError("buddy accounting mismatch")
        seen = set()
        for o, blocks in enumerate(self._free):
            for off in blocks:
                if off % (self.MIN_BLOCK << o) != 0:
                    raise AssertionError(f"misaligned free block {off} order {o}")
                rng = (off, off + (self.MIN_BLOCK << o))
                for s in seen:
                    if rng[0] < s[1] and s[0] < rng[1]:
                        raise AssertionError("overlapping free blocks")
                seen.add(rng)


# ---------------------------------------------------------------------------
# regions + second-level pointers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Region:
    """One PGAS allocation in the centralized mapping table."""

    rid: int
    name: str
    symmetric: bool
    # per-rank byte sizes; for symmetric regions all entries are equal
    sizes: Tuple[int, ...]
    # per-rank arena offsets
    offsets: Tuple[int, ...]
    group: DiompGroup
    # sharding metadata (logical axis names of the region's dims)
    logical_axes: Tuple[Optional[str], ...] = ()
    dtype: str = "bfloat16"

    def remote_address(self, rank: int) -> Tuple[int, int]:
        """(rank, offset) of this region on ``rank`` — the put/get target.

        For symmetric regions offset is identical on every rank (offset-based
        translation); for asymmetric regions callers must go through the
        second-level pointer instead (enforced here).
        """
        if not self.symmetric:
            raise AllocError(
                f"region {self.name!r} is asymmetric: dereference via "
                "SecondLevelPtr, not direct offset translation"
            )
        return (rank, self.offsets[rank])


@dataclasses.dataclass(frozen=True)
class SecondLevelPtr:
    """The paper's 32-byte uniformly-allocated pointer wrapper.

    Symmetrically allocated on all ranks (same slot offset everywhere), its
    *value* on rank r is the address of rank r's asymmetric payload.
    """

    slot_offset: int  # symmetric — identical on all ranks
    region: Region

    def dereference(self, rank: int) -> Tuple[int, int]:
        if self.region.sizes[rank] == 0:
            raise AllocError(
                f"rank {rank} holds no payload of region "
                f"{self.region.name!r} (zero-size asymmetric rank)")
        return (rank, self.region.offsets[rank])


class RemotePtrCache:
    """Cache of fetched second-level pointer values (paper §3.2).

    Each miss models a round-trip fetch of the remote pointer value; hits skip
    it.  The runtime invalidates entries when a region is freed — validity is
    guaranteed "throughout the lifetime of its corresponding allocation".
    """

    def __init__(self):
        self._cache: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.hits = 0
        self.misses = 0

    def lookup(self, ptr: SecondLevelPtr, rank: int) -> Tuple[int, int]:
        key = (ptr.region.rid, rank)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1  # first access pays the two-step communication
        addr = ptr.dereference(rank)
        self._cache[key] = addr
        return addr

    def invalidate_region(self, rid: int) -> None:
        for key in [k for k in self._cache if k[0] == rid]:
            del self._cache[key]

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# ---------------------------------------------------------------------------
# the global memory manager
# ---------------------------------------------------------------------------


class GlobalMemory:
    """DiOMP's unified memory view: one arena per rank + one mapping table.

    ``nranks`` is the number of participants of the world group (ranks).
    ``segment_bytes`` models each rank's registered global segment
    (default 16 GiB).

    Collective allocations run the paper's "all participating nodes
    coordinate" protocol over ``coordinator``: symmetric allocs agree on one
    common offset from the intersection of the participants' free extents,
    asymmetric allocs assemble the global size/offset vectors from
    per-process contributions.  With the :class:`LocalCoordinator` every
    rank is local and each exchange is the identity.
    """

    def __init__(
        self,
        nranks: int,
        segment_bytes: int = 16 * 2**30,
        allocator: str = "linear",
        *,
        local_ranks: Optional[Sequence[int]] = None,
        coordinator: Optional[ProcessCoordinator] = None,
    ):
        if nranks <= 0:
            raise ValueError("nranks must be positive")
        self.nranks = nranks
        self.segment_bytes = segment_bytes
        self.coordinator = coordinator if coordinator is not None \
            else LocalCoordinator()
        if local_ranks is None:
            local_ranks = range(nranks)
        self.local_ranks: Tuple[int, ...] = tuple(int(r) for r in local_ranks)
        if not self.local_ranks:
            raise ValueError("a process must own at least one rank")
        for r in self.local_ranks:
            if not 0 <= r < nranks:
                raise ValueError(f"local rank {r} outside [0, {nranks})")
        alloc_cls = {"linear": LinearAllocator, "buddy": BuddyAllocator}[allocator]
        local = set(self.local_ranks)
        self._arenas: List[Optional[object]] = [
            alloc_cls(segment_bytes) if r in local else None
            for r in range(nranks)
        ]
        self._slp_arena = LinearAllocator(2**20)  # symmetric 1 MiB SLP table
        self._regions: Dict[int, Region] = {}
        self._slps: Dict[int, SecondLevelPtr] = {}
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self.ptr_cache = RemotePtrCache()
        # arena-traffic counters: how many collective alloc/free calls hit
        # the arenas.  The serving KV allocator's free-list is audited
        # against these (page churn must NOT translate into arena churn —
        # see docs/SERVING.md).
        self.alloc_counts = {"symmetric": 0, "asymmetric": 0, "free": 0}

    @property
    def multiprocess(self) -> bool:
        return self.coordinator.num_processes > 1

    def _local_arenas(self):
        """(rank, arena) pairs this process owns, in rank order."""
        return [(r, self._arenas[r]) for r in self.local_ranks]

    def _arena(self, rank: int):
        if not 0 <= rank < self.nranks:
            raise AllocError(f"rank {rank} outside [0, {self.nranks})")
        arena = self._arenas[rank]
        if arena is None:
            raise AllocError(
                f"rank {rank} is not process-local (this process owns "
                f"{self.local_ranks}); remote arenas are reachable only "
                "through the coordinated collective calls")
        return arena

    # -- collective allocation (paper: "all participating nodes coordinate") --
    def alloc_symmetric(
        self,
        name: str,
        size: int,
        group: DiompGroup,
        logical_axes: Tuple[Optional[str], ...] = (),
        dtype: str = "bfloat16",
    ) -> Region:
        """Identical ``size`` bytes at the SAME offset on every rank —
        the offset-translation property remote puts/gets rely on.

        Fast path: arenas still in lockstep (collective alloc/free only)
        hand out identical offsets independently.  Once asymmetric
        allocations have diverged the arenas, the collective falls back to
        a *coordinated* allocation: intersect every rank's free extents —
        across all processes in a multi-controller job — and commit the
        first common offset on all ranks (the paper's "all participating
        nodes coordinate").
        """
        with self._lock:
            self.alloc_counts["symmetric"] += 1
            offsets = []
            done = []
            try:
                for _, arena in self._local_arenas():
                    offsets.append(arena.alloc(size))
                    done.append(arena)
            except AllocError:
                for arena, off in zip(done, offsets):
                    arena.free(off)
                offsets, done = [], []
            candidate = offsets[0] if offsets and len(set(offsets)) == 1 \
                else -1
            if self.multiprocess:
                # one common offset needs *global* agreement, not just the
                # local arenas': vote the candidate across processes
                votes = self.coordinator.allgather(candidate)
                if candidate >= 0 and any(v != candidate for v in votes):
                    candidate = -1
            if candidate < 0 and offsets:
                # diverged (asymmetric churn, or a remote process saw a
                # different offset): roll back and retry coordinated
                for arena, off in zip(done, offsets):
                    arena.free(off)
                offsets = []
            if not offsets:
                common = self._alloc_common_offset(size)
                offsets = [common] * len(self.local_ranks)
            offsets = self._assemble_symmetric(offsets)
            region = Region(
                rid=next(self._rid),
                name=name,
                symmetric=True,
                sizes=tuple([size] * self.nranks),
                offsets=tuple(offsets),
                group=group,
                logical_axes=logical_axes,
                dtype=dtype,
            )
            self._regions[region.rid] = region
            return region

    def _assemble_symmetric(self, local_offsets: List[int]) -> List[int]:
        """Expand the agreed common offset to the global per-rank vector
        (symmetric by construction: one offset everywhere)."""
        return [local_offsets[0]] * self.nranks

    def _alloc_common_offset(self, size: int) -> int:
        """Coordinated symmetric allocation across diverged arenas.

        Intersects all ranks' free extents — every process contributes its
        *local* arenas' extents, and the global intersection is computed
        identically everywhere from the exchanged lists — then commits the
        first aligned offset every arena of every process can honor.  A
        candidate any process cannot place is rolled back on all of them
        (a per-candidate commit vote), so the chosen offset is common by
        protocol, not by assumption.
        """

        def intersect(a: List[Tuple[int, int]], b: List[Tuple[int, int]]):
            out: List[Tuple[int, int]] = []
            i = j = 0
            while i < len(a) and j < len(b):
                lo = max(a[i][0], b[j][0])
                hi = min(a[i][0] + a[i][1], b[j][0] + b[j][1])
                if lo < hi:
                    out.append((lo, hi - lo))
                if a[i][0] + a[i][1] < b[j][0] + b[j][1]:
                    i += 1
                else:
                    j += 1
            return out

        local = self._local_arenas()
        exts = sorted(local[0][1].free_extents())
        for _, arena in local[1:]:
            exts = intersect(exts, sorted(arena.free_extents()))
        align = max(arena.alignment_for(size) for _, arena in local)
        if self.multiprocess:
            # per-process contributions -> one global view on every process
            contributions = self.coordinator.allgather(
                {"extents": [list(e) for e in exts], "align": align})
            exts = [tuple(e) for e in contributions[0]["extents"]]
            for contrib in contributions[1:]:
                exts = intersect(
                    exts, [tuple(e) for e in contrib["extents"]])
            align = max(int(c["align"]) for c in contributions)
        needed = _align_up(max(size, 1), align)
        for off, ext in exts:
            cand = _align_up(off, align)
            if cand + needed > off + ext:
                continue
            placed = []
            ok = True
            try:
                for _, arena in local:
                    arena.alloc_at(cand, size)
                    placed.append(arena)
            except AllocError:
                ok = False
            if self.multiprocess:
                ok = all(self.coordinator.allgather(ok))
            if ok:
                return cand
            for arena in placed:
                arena.free(cand)
        raise AllocError(
            f"no common symmetric offset for {size} bytes across "
            f"{self.nranks} diverged arenas"
            + (f" on {self.coordinator.num_processes} processes"
               if self.multiprocess else ""))

    def alloc_asymmetric(
        self,
        name: str,
        sizes: Optional[Sequence[int]] = None,
        group: DiompGroup = None,
        logical_axes: Tuple[Optional[str], ...] = (),
        dtype: str = "bfloat16",
        *,
        local_sizes: Optional[Sequence[int]] = None,
    ) -> SecondLevelPtr:
        """Per-rank sizes differ; returns the second-level pointer handle.

        Implementation detail from the paper: the wrapper slots are
        symmetric (identical offset on all ranks), while payloads land
        "at the end of the global segment" wherever each arena has room.
        A size of 0 means the rank holds NO payload at all (fully ragged
        allocation — e.g. a KV page homed on one rank): only the symmetric
        32-byte wrapper exists there, recorded as offset -1.

        Multi-controller extent exchange: callers pass either the full
        global ``sizes`` vector (every process must pass the same one —
        verified collectively, a torn bootstrap raises everywhere) or
        ``local_sizes`` covering only this process's :attr:`local_ranks`;
        the global vector is then *assembled from per-process
        contributions*.  Either way each process places payloads only in
        its own arenas, and the per-rank offsets of the mapping-table
        entry are exchanged so every process records the identical,
        globally-consistent :class:`Region`.
        """
        if (sizes is None) == (local_sizes is None):
            raise ValueError("pass exactly one of sizes / local_sizes")
        if local_sizes is not None:
            if len(local_sizes) != len(self.local_ranks):
                raise ValueError(
                    f"need {len(self.local_ranks)} local sizes for ranks "
                    f"{self.local_ranks}, got {len(local_sizes)}")
            sizes = self._exchange_sizes(local_sizes)
        if len(sizes) != self.nranks:
            raise ValueError(f"need {self.nranks} sizes, got {len(sizes)}")
        with self._lock:
            self.alloc_counts["asymmetric"] += 1
            slot = self._slp_arena.alloc(_SLP_BYTES)
            offsets = {}
            ok = True
            try:
                for rank, arena in self._local_arenas():
                    size = sizes[rank]
                    offsets[rank] = -1 if size <= 0 else arena.alloc(size)
            except AllocError:
                ok = False
            err = None
            if self.multiprocess:
                offsets, ok, err = self._exchange_asymmetric(
                    sizes, offsets, slot, ok)
            if not ok:
                for rank, off in offsets.items():
                    if off >= 0 and self._arenas[rank] is not None:
                        self._arenas[rank].free(off)
                self._slp_arena.free(slot)
                raise AllocError(
                    err or f"asymmetric allocation {name!r} failed "
                    "collectively (no room on at least one rank)")
            offsets = [offsets.get(r, -1) for r in range(self.nranks)]
            region = Region(
                rid=next(self._rid),
                name=name,
                symmetric=False,
                sizes=tuple(int(s) for s in sizes),
                offsets=tuple(offsets),
                group=group,
                logical_axes=logical_axes,
                dtype=dtype,
            )
            self._regions[region.rid] = region
            slp = SecondLevelPtr(slot_offset=slot, region=region)
            self._slps[region.rid] = slp
            return slp

    def _exchange_sizes(self, local_sizes: Sequence[int]) -> List[int]:
        """Assemble the global size vector from per-process contributions
        (each process speaks only for its own ranks)."""
        payload = [[int(r), int(s)]
                   for r, s in zip(self.local_ranks, local_sizes)]
        rows = self.coordinator.allgather(payload)
        full: Dict[int, int] = {}
        for row in rows:
            for r, s in row:
                if int(r) in full:
                    raise AllocError(
                        f"extent exchange: rank {r} contributed twice "
                        "(overlapping local_ranks across processes)")
                full[int(r)] = int(s)
        if sorted(full) != list(range(self.nranks)):
            raise AllocError(
                f"extent exchange covered ranks {sorted(full)}, "
                f"expected 0..{self.nranks - 1}")
        return [full[r] for r in range(self.nranks)]

    def _exchange_asymmetric(self, sizes, offsets, slot, ok):
        """One collective round that (a) verifies every process ran the
        same allocation (sizes + SLP slot agree — a torn bootstrap fails
        everywhere), (b) votes local placement success into a collective
        verdict, and (c) assembles the global per-rank offset vector from
        each owner's contribution."""
        payload = {
            "ok": bool(ok),
            "slot": int(slot),
            "sizes": [int(s) for s in sizes],
            "offsets": [[int(r), int(o)] for r, o in sorted(offsets.items())],
        }
        rows = self.coordinator.allgather(payload)
        err = None
        if any(row["sizes"] != payload["sizes"] for row in rows):
            err = ("asymmetric extent exchange: processes disagree on the "
                   "per-rank size vector (torn SPMD bootstrap)")
        elif any(row["slot"] != payload["slot"] for row in rows):
            err = ("asymmetric allocation: second-level-pointer slots "
                   "diverged across processes (SLP arenas out of lockstep)")
        if err is not None:
            return offsets, False, err
        if not all(row["ok"] for row in rows):
            return offsets, False, None
        merged: Dict[int, int] = {}
        for row in rows:
            for r, o in row["offsets"]:
                merged[int(r)] = int(o)
        return merged, True, None

    def free(self, handle) -> None:
        """Collective free; invalidates any cached remote pointers."""
        region = handle.region if isinstance(handle, SecondLevelPtr) else handle
        with self._lock:
            self.alloc_counts["free"] += 1
            if region.rid not in self._regions:
                raise AllocError(f"double free of region {region.name!r}")
            for arena, off in zip(self._arenas, region.offsets):
                if off < 0 or arena is None:
                    # zero-size rank, or a rank another process owns:
                    # nothing was placed in *this* process's arenas
                    continue
                arena.free(off)
            slp = self._slps.pop(region.rid, None)
            if slp is not None:
                self._slp_arena.free(slp.slot_offset)
            del self._regions[region.rid]
            self.ptr_cache.invalidate_region(region.rid)

    # -- address translation ---------------------------------------------------
    def translate(self, handle, rank: int) -> Tuple[int, int]:
        """Resolve a handle to a (rank, offset) remote address.

        Symmetric regions use offset translation directly; asymmetric ones go
        through the cached second-level pointer — transparently, which is the
        "consistent and efficient access model" the runtime promises.
        """
        if isinstance(handle, SecondLevelPtr):
            return self.ptr_cache.lookup(handle, rank)
        return handle.remote_address(rank)

    # -- introspection ----------------------------------------------------------
    def bytes_in_use(self, rank: int = 0) -> int:
        return self._arena(rank).bytes_in_use

    def bytes_free(self, rank: int = 0) -> int:
        return self._arena(rank).bytes_free

    def capacity(self, rank: int = 0) -> int:
        """Actual arena capacity (the buddy allocator rounds the segment up
        to a power of two)."""
        return self._arena(rank).capacity

    def regions(self) -> List[Region]:
        return list(self._regions.values())

    def mapping_table(self) -> List[dict]:
        """The centralized mapping table of paper Fig. 1(b), for inspection."""
        return [
            {
                "rid": r.rid,
                "name": r.name,
                "symmetric": r.symmetric,
                "bytes": r.sizes,
                "offsets": r.offsets,
                "group": r.group.name,
                "logical_axes": r.logical_axes,
                "dtype": r.dtype,
            }
            for r in self._regions.values()
        ]

    def check_invariants(self) -> None:
        for _, arena in self._local_arenas():
            arena.check_invariants()
