"""Stream/event management — the paper's §3.2 policy.

The paper manages CUDA/HIP streams with four techniques: lazy allocation,
stream reuse, bounded concurrency (``MAX_ACTIVE_STREAMS`` + *partial
synchronization*: when the bound is hit, sync-and-release only half of the
completed streams so the pipeline keeps moving), and hybrid polling of network
and device events inside ``ompx_fence``.

Here a stream is a host lane (a worker thread) for genuinely asynchronous
host work; device work is ordered on PyTorch's current CUDA stream.  The
same bound also sizes kernels' in-flight staging buffers:
``StreamPool.plan_slots`` is consumed by
:class:`repro_torch.kernels.plan.OverlapPlanner`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List

__all__ = ["Stream", "StreamPool", "HybridPoller"]

MAX_ACTIVE_STREAMS_DEFAULT = 8


class Stream:
    """One asynchronous lane: a worker thread consuming a task queue."""

    _ids = 0
    _ids_lock = threading.Lock()   # pools on different threads share the counter

    def __init__(self):
        with Stream._ids_lock:
            Stream._ids += 1
            self.sid = Stream._ids
        self._queue: Deque = deque()
        self._cv = threading.Condition()
        self._pending = 0
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                fn, args, fut = self._queue.popleft()
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # noqa: BLE001 - propagate via future
                fut.set_exception(e)
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    def submit(self, fn: Callable, *args) -> Future:
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("stream closed")
            self._queue.append((fn, args, fut))
            self._pending += 1
            self._cv.notify_all()
        return fut

    @property
    def idle(self) -> bool:
        with self._cv:
            return self._pending == 0

    def synchronize(self) -> None:
        with self._cv:
            while self._pending:
                self._cv.wait()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


class StreamPool:
    """Lazy-allocating, reusing, bounded pool of streams (paper §3.2).

    * **Lazy allocation** — no stream exists until the first submit.
    * **Reuse** — an idle pooled stream is handed out before creating new ones.
    * **Bounded concurrency** — at most ``max_active`` streams are live; on
      overflow the pool performs *partial synchronization*: it waits for
      completions and releases only ``len(completed)//2`` of the completed
      streams, keeping the rest warm, so throughput is sustained while memory
      and scheduler pressure stay bounded.
    """

    def __init__(self, max_active: int = MAX_ACTIVE_STREAMS_DEFAULT):
        if max_active < 1:
            raise ValueError("max_active must be >= 1")
        self.max_active = max_active
        self._idle: List[Stream] = []
        self._active: List[Stream] = []
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "created": 0,
            "reused": 0,
            "partial_syncs": 0,
            "released": 0,
        }

    # -- acquisition -----------------------------------------------------------
    def acquire(self) -> Stream:
        with self._lock:
            if self._idle:  # stream reuse
                s = self._idle.pop()
                self.stats["reused"] += 1
                self._active.append(s)
                return s
            if len(self._active) >= self.max_active:
                self._partial_sync_locked()
                if self._idle:   # the sync released streams: reuse, don't grow
                    s = self._idle.pop()
                    self.stats["reused"] += 1
                    self._active.append(s)
                    return s
            s = Stream()  # lazy allocation
            self.stats["created"] += 1
            self._active.append(s)
            return s

    def release(self, stream: Stream) -> None:
        with self._lock:
            if stream in self._active:
                self._active.remove(stream)
            if stream not in self._idle:   # tolerate racing double-release
                self._idle.append(stream)

    def _partial_sync_locked(self) -> None:
        """Paper's partial synchronization: release half the *completed*.

        Called with the pool lock held.  When nothing has finished yet we
        must block on the oldest stream, which requires DROPPING the lock
        (the stream's completion path re-enters ``release``); while the
        lock is down, concurrent ``release``/``acquire`` calls may mutate
        ``_active`` and even recycle the stream we waited on — so after
        reacquiring, everything is re-derived from the pool's current
        membership and nothing is removed without a membership check.
        """
        self.stats["partial_syncs"] += 1
        completed = [s for s in self._active if s.idle]
        while not completed and self._active:
            # nothing finished yet: block on the oldest stream only
            oldest = self._active[0]
            self._lock.release()
            try:
                oldest.synchronize()
            finally:
                self._lock.acquire()
            if oldest not in self._active:
                # a concurrent release() recycled it while we were blocked;
                # the pool shrank, so the bound no longer forces a sync
                if len(self._active) < self.max_active:
                    return
            completed = [s for s in self._active if s.idle]
        n_release = max(1, len(completed) // 2) if completed else 0
        for s in completed[:n_release]:
            if s in self._active:          # guard against racing release()
                self._active.remove(s)
                if s not in self._idle:
                    self._idle.append(s)
                self.stats["released"] += 1

    # -- convenience -----------------------------------------------------------
    def submit(self, fn: Callable, *args) -> Future:
        s = self.acquire()
        fut = s.submit(fn, *args)
        fut.add_done_callback(lambda _f: self.release(s))
        return fut

    def synchronize_all(self) -> None:
        with self._lock:
            streams = list(self._active) + list(self._idle)
        for s in streams:
            s.synchronize()

    def close(self) -> None:
        self.synchronize_all()
        with self._lock:
            for s in self._active + self._idle:
                s.close()
            self._active.clear()
            self._idle.clear()

    # -- planning hook for kernels ------------------------------------------------
    def plan_slots(self, working_set_bytes: int, budget: int = 64 * 2**20) -> int:
        """How many staging buffers a kernel may keep in flight.

        The kernel analogue of MAX_ACTIVE_STREAMS: enough slots to overlap
        (≥2 = double buffering), bounded by the staging memory the slots
        would pin.
        """
        if working_set_bytes <= 0:
            return 2
        by_budget = max(1, budget // max(working_set_bytes, 1))
        return max(2, min(self.max_active, by_budget))


class HybridPoller:
    """Unified polling over heterogeneous completion sources (paper §3.2).

    DiOMP's ``ompx_fence`` polls GASNet-EX events and CUDA/HIP stream events in
    one loop so neither side stalls the other.  Our fence polls every
    registered completion source (host futures, data-pipeline queues, stream
    pools) round-robin until all are quiescent.
    """

    def __init__(self, interval_s: float = 1e-4):
        self._sources: List[Callable[[], bool]] = []  # each returns "is done"
        self.interval_s = interval_s
        self.polls = 0

    def register(self, is_done: Callable[[], bool]) -> None:
        self._sources.append(is_done)

    def fence(self, timeout_s: float = 120.0) -> None:
        deadline = time.monotonic() + timeout_s
        pending = list(self._sources)
        while pending:
            self.polls += 1
            pending = [src for src in pending if not src()]
            if not pending:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"fence timed out with {len(pending)} pending sources")
            time.sleep(self.interval_s)
