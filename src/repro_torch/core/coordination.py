"""Multi-process coordination — the SPMD bootstrap layer and its data plane.

A single process drives every rank of a mesh as a leading dim of stacked
tensors.  DiOMP's runtime is *multi-controller*: every process runs the
same program and holds only its own ranks, and global state (the PGAS
mapping table, group descriptors, call/byte logs) is consistent only
because the processes *exchange* their contributions (GASNet-EX's
segment-exchange bootstrap, OMPCCL's UniqueID handshake).  This module is
that exchange, over ``torch.distributed`` with the gloo transport:

* :func:`init_distributed` — joins the job (``init_process_group("gloo")``
  over ``tcp://host:port``) with an idempotence guard; the transport under
  ``diomp.init(coordinator=...)``.  ``local_device_count`` is the number
  of ranks this process owns.
* :class:`ProcessCoordinator` — host-metadata allgather/broadcast/barrier.
  :class:`LocalCoordinator` is the single-process identity;
  :class:`TorchCoordinator` moves JSON payloads over gloo.  Both are
  deterministic: every process receives the identical, process-indexed
  list.
* the data plane — :func:`rank_gather` and :func:`assemble` move rank
  slices of stacked tensors between the processes that own them:
  point-to-point gloo messages of host copies (staged through pinned
  memory when the tensors are on the card).  gloo's point-to-point takes
  CPU tensors, and NCCL refuses two ranks of one communicator on one GPU,
  so one card shared by several processes goes through the host.
  :data:`TRANSPORT` counts the messages and bytes that really moved.
* :func:`fetch_global` — the full stacked value of a process's box on
  every process, the way the harness compares outputs bit for bit across
  runs with different process counts.

Design rule: everything here is **collective** — either every process of
the job calls it in the same order, or none does.  The PGAS allocator, the
context handshake and every cross-process verb are built on that
discipline, mirroring the paper's "all participating nodes coordinate"
allocation contract.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

__all__ = [
    "CoordinationError",
    "ProcessCoordinator",
    "LocalCoordinator",
    "TorchCoordinator",
    "TRANSPORT",
    "assemble",
    "coordinator_for",
    "device_process_map",
    "fetch_global",
    "init_distributed",
    "is_distributed",
    "local_device_count",
    "process_local_ranks",
    "rank_gather",
    "shutdown",
]

#: ranks a process holds when it has joined no job: the smoke mesh's eight
SINGLE_PROCESS_RANKS = 8
#: seconds a gloo exchange may wait for its peers before it fails
TIMEOUT_S = 300


class CoordinationError(RuntimeError):
    """Raised when the multi-process bootstrap or an exchange fails."""


# ---------------------------------------------------------------------------
# torch.distributed bootstrap
# ---------------------------------------------------------------------------

_job: Optional[Dict[str, int]] = None


def is_distributed() -> bool:
    """True once :func:`init_distributed` has run in this process."""
    return _job is not None


def local_device_count() -> int:
    """Ranks this process owns: ``init_distributed``'s
    ``local_device_count``, or :data:`SINGLE_PROCESS_RANKS` outside a
    job."""
    return _job["local"] if _job is not None else SINGLE_PROCESS_RANKS


def init_distributed(
    coordinator: str,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    local_device_count: Optional[int] = None,
) -> tuple:
    """Join the multi-process job; returns ``(process_id, num_processes)``.

    ``coordinator`` is the ``host:port`` of process 0's rendezvous (the
    GASNet-EX conduit bootstrap analogue).  ``num_processes`` /
    ``process_id`` default to the ``WORLD_SIZE`` / ``RANK`` environment
    variables.  ``local_device_count`` (default 1) is the number of ranks
    this process owns; every process must own the same number, which is
    checked collectively.

    Idempotent: a second call with the same topology is a no-op; a second
    call with a different one raises :class:`CoordinationError`.
    """
    global _job
    import torch.distributed as dist

    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    want = {"process_id": process_id, "num_processes": num_processes,
            "local": local_device_count}
    if _job is not None:
        clash = {k: (_job[k], v) for k, v in want.items()
                 if v is not None and v != _job[k]}
        if clash:
            raise CoordinationError(
                f"init_distributed called twice with a different topology "
                f"(was, now): {clash}")
        return (_job["process_id"], _job["num_processes"])
    if num_processes is None or process_id is None:
        raise CoordinationError(
            "init_distributed needs num_processes and process_id (or the "
            "WORLD_SIZE and RANK environment variables)")
    if not dist.is_gloo_available():
        raise CoordinationError("torch.distributed has no gloo transport")
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    except Exception as e:
        raise CoordinationError(
            f"init_process_group('gloo', tcp://{coordinator}, "
            f"world_size={num_processes}, rank={process_id}) failed: "
            f"{e}") from e
    local = 1 if local_device_count is None else int(local_device_count)
    _job = {"process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(), "local": local}
    counts = TorchCoordinator().allgather(local)
    if any(c != local for c in counts):
        shutdown()
        raise CoordinationError(
            f"processes own different rank counts {counts}: every process "
            "must pass the same local_device_count")
    return (_job["process_id"], _job["num_processes"])


def shutdown() -> None:
    """Leave the job (tests; a worker's exit)."""
    global _job
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _job = None


# ---------------------------------------------------------------------------
# host-metadata exchange
# ---------------------------------------------------------------------------


class ProcessCoordinator:
    """Deterministic host-metadata exchange among the job's processes.

    The unit of exchange is a JSON-serializable object; every collective
    returns the same process-indexed list on every process.  Subclasses
    provide :meth:`allgather_bytes`; the object layer is shared.
    """

    process_id: int = 0
    num_processes: int = 1

    def allgather_bytes(self, payload: bytes) -> List[bytes]:
        raise NotImplementedError

    def allgather(self, obj: Any) -> List[Any]:
        """Every process contributes ``obj``; all receive ``[obj_0..obj_n]``.

        JSON round-trips the payload, so tuples come back as lists —
        callers normalize shapes themselves (the PGAS layer does).
        """
        rows = self.allgather_bytes(
            json.dumps(obj, sort_keys=True).encode("utf-8"))
        return [json.loads(r.decode("utf-8")) for r in rows]

    def broadcast(self, obj: Any, *, root: int = 0) -> Any:
        return self.allgather(obj)[root]

    def agree(self, obj: Any) -> bool:
        """True iff every process contributed an identical value."""
        rows = self.allgather(obj)
        return all(r == rows[0] for r in rows[1:]) if rows else True

    def barrier(self, tag: str = "barrier") -> None:
        self.allgather_bytes(tag.encode("utf-8"))


class LocalCoordinator(ProcessCoordinator):
    """The single-process job: every exchange is the identity."""

    def allgather_bytes(self, payload: bytes) -> List[bytes]:
        return [payload]

    def barrier(self, tag: str = "barrier") -> None:
        pass


class TorchCoordinator(ProcessCoordinator):
    """Exchange over the initialized ``torch.distributed`` gloo group.

    Lengths are exchanged first, then the max-length-padded byte rows — two
    small allgathers per exchange, which is bootstrap and audit traffic,
    never a hot path.
    """

    def __init__(self):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise CoordinationError(
                "TorchCoordinator needs an initialized torch.distributed "
                "group (init_distributed)")
        self.process_id = dist.get_rank()
        self.num_processes = dist.get_world_size()

    def allgather_bytes(self, payload: bytes) -> List[bytes]:
        import torch.distributed as dist

        if self.num_processes == 1:
            return [payload]
        n = self.num_processes
        lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
        dist.all_gather(lens, torch.tensor([len(payload)], dtype=torch.int64))
        width = max(max(int(v) for v in lens), 1)
        row = torch.zeros(width, dtype=torch.uint8)
        if payload:
            row[:len(payload)] = torch.frombuffer(bytearray(payload),
                                                  dtype=torch.uint8)
        rows = [torch.empty(width, dtype=torch.uint8) for _ in range(n)]
        dist.all_gather(rows, row)
        return [bytes(rows[i][:int(lens[i])].tolist()) for i in range(n)]


def coordinator_for(mesh=None) -> ProcessCoordinator:
    """The coordinator matching this process: :class:`LocalCoordinator`
    outside a job (no traffic, identical semantics), else
    :class:`TorchCoordinator`.  ``mesh`` is accepted for call-site
    symmetry; topology comes from the job, not the mesh."""
    del mesh
    return TorchCoordinator() if is_distributed() else LocalCoordinator()


# ---------------------------------------------------------------------------
# rank ownership
# ---------------------------------------------------------------------------


def process_local_ranks(mesh) -> List[int]:
    """Global ranks (flat positions in mesh order) owned by this process —
    the same order the PGAS arenas, group rings and permutes use."""
    return list(mesh.local_ranks)


def device_process_map(mesh) -> List[int]:
    """Per-global-rank owning process ids, in mesh order."""
    return [mesh.owner(r) for r in range(mesh.size)]


# ---------------------------------------------------------------------------
# the data plane: rank slices between processes
# ---------------------------------------------------------------------------


#: what this process's data plane really moved: gloo messages sent and
#: received, and their payload bytes (a message per process pair and verb)
TRANSPORT = {"sent": 0, "sent_bytes": 0, "received": 0, "received_bytes": 0}


def _flat(x: torch.Tensor, mesh) -> torch.Tensor:
    """A box tensor as (local ranks, *rest): row r holds the r-th local
    rank in mesh order."""
    return x.reshape(mesh.local_size, *x.shape[mesh.ndim:])


def _exchange(rows: torch.Tensor, mesh,
              need: Callable[[int], Sequence[int]]) -> Dict[int, torch.Tensor]:
    """Send every process the rows of my ranks it needs; return the rows I
    need from other processes, keyed by global rank (host tensors: the
    caller copies each into its place on the device).

    ``rows`` is (local ranks, *rest); ``need(p)`` lists the global ranks
    process ``p`` reads (every process evaluates it for every process, so
    both ends of each message agree on its contents).  One gloo message
    per ordered process pair that has anything to move, host copies staged
    through pinned memory for tensors on the card."""
    import torch.distributed as dist

    me = mesh.process_id
    local = {r: i for i, r in enumerate(mesh.local_ranks)}
    rest, dtype = rows.shape[1:], rows.dtype
    pin = rows.is_cuda
    sends, recvs = [], []
    for q in range(mesh.num_processes):
        if q == me:
            continue
        out = sorted({r for r in need(q) if r in local})
        inc = sorted({r for r in need(me) if mesh.owner(r) == q})
        if out:
            payload = rows[[local[r] for r in out]]
            host = torch.empty(payload.shape, dtype=dtype, pin_memory=pin)
            host.copy_(payload)
            sends.append((q, host))
        if inc:
            buf = torch.empty((len(inc), *rest), dtype=dtype, pin_memory=pin)
            recvs.append((q, inc, buf))
    reqs = [dist.isend(h.reshape(-1).view(torch.uint8), q)
            for q, h in sends]
    reqs += [dist.irecv(b.reshape(-1).view(torch.uint8), q)
             for q, _, b in recvs]
    for req in reqs:
        req.wait()
    for _, h in sends:
        TRANSPORT["sent"] += 1
        TRANSPORT["sent_bytes"] += h.numel() * h.element_size()
    got: Dict[int, torch.Tensor] = {}
    for _, inc, b in recvs:
        TRANSPORT["received"] += 1
        TRANSPORT["received_bytes"] += b.numel() * b.element_size()
        for i, r in enumerate(inc):
            got[r] = b[i]
    return got


def rank_gather(x: torch.Tensor, mesh,
                src: Sequence[Optional[int]]) -> torch.Tensor:
    """Every local rank ``r`` receives global rank ``src[r]``'s slice of
    ``x`` (zeros where ``src[r]`` is None): a box tensor of ``x``'s shape.

    ``x`` is this process's box of a stacked tensor; ``src`` has an entry
    for every global rank.  Only the slices that cross a process boundary
    move; a copy is a copy, so the result is bit for bit what the one
    process holding every rank computes."""
    rows = _flat(x, mesh)
    local = {r: i for i, r in enumerate(mesh.local_ranks)}

    def need(p):
        return [src[r] for r in mesh.ranks_of(p) if src[r] is not None]

    got = _exchange(rows, mesh, need) if mesh.multiprocess else {}
    out = torch.zeros_like(rows)
    for i, r in enumerate(mesh.local_ranks):
        s = src[r]
        if s is not None:
            out[i].copy_(rows[local[s]] if s in local else got[s],
                         non_blocking=True)
    return out.reshape(x.shape)


def assemble(x: torch.Tensor, mesh,
             need: Callable[[int], Sequence[int]]) -> torch.Tensor:
    """The full stacked tensor ``(*mesh.sizes, *rest)`` holding this
    process's box and the ranks ``need(me)`` names (zeros elsewhere).

    ``need(p)`` lists the global ranks process ``p`` reads; every process
    evaluates it for every process.  The single-process verb then runs on
    the assembled stack in its own order, so a reduction over a group that
    crosses processes sums exactly what one process sums."""
    rows = _flat(x, mesh)
    full = torch.zeros(mesh.size, *rows.shape[1:], dtype=x.dtype,
                       device=x.device)
    full[list(mesh.local_ranks)] = rows
    if mesh.multiprocess:
        for r, t in _exchange(rows, mesh, need).items():
            full[r].copy_(t, non_blocking=True)
    return full.reshape(*mesh.sizes, *rows.shape[1:])


def fetch_global(x, mesh=None):
    """Full logical value of ``x`` on every process.

    A numpy array, a tensor without a mesh, or a tensor over a mesh this
    process holds whole come back as they are (no traffic).  A process's
    box of a stacked tensor over a multi-process mesh is assembled into
    the full stacked tensor (every rank's slice, on ``x``'s device) —
    identical on every process, which is what the equivalence harness
    diffs across runs with different process counts.  Collective."""
    import numpy as np

    if isinstance(x, np.ndarray):
        return np.asarray(x)
    if mesh is None or not mesh.multiprocess:
        return x
    every = list(range(mesh.size))
    return assemble(x, mesh, lambda p: every)
