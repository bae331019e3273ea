"""DiompContext — the explicit entry point of the DiOMP runtime.

The paper's runtime owns ONE table: every group maps to one registered
communicator, and every collective/RMA call dispatches through it (§3.3,
Fig. 1b).  :class:`DiompContext` is that object::

    import repro_torch as diomp

    ctx = diomp.init(mesh=RankMesh(("x",), (4,)))   # install process default
    comm = ctx.communicator(group)                   # the OMPCCL handle
    y = comm.allreduce(x)                            # recorded + dispatched

The context owns the group registry, the GlobalMemory PGAS arena plan, the
StreamPool + HybridPoller, the RMATracker and the communicator table (one
shared per-group call/byte log, one handle per (group, backend) pair).

Tensors are stacked: their leading dimensions are the mesh axes, so every
verb needs the context's mesh.  The context also fixes the device its
entry points run on: the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import contextvars
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..launch.mesh import RankMesh
from . import backends as _backends
from .backends import CclBackend, get_backend
from .groups import DiompGroup, standard_groups
from .pgas import GlobalMemory
from .rma import RMATracker
from .streams import HybridPoller, StreamPool

__all__ = [
    "Communicator",
    "CommTable",
    "DiompContext",
    "DispatchStats",
    "resolve_device",
    "init",
    "default_context",
    "default_communicator",
    "install_default",
    "use_default",
    "reset_default_context",
    "scratch_context",
    "recorded_once",
]

BackendLike = Union[str, CclBackend, None]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises where the card is asked
    for and absent — an entry point never falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


class Communicator:
    """The OMPCCL communicator handle for one (group, backend) pair.

    Every op is (1) recorded against the group's shared call log and its
    per-rank payload bytes against the parallel byte log, and (2)
    dispatched through the backend instance.  Delegating ops (``reduce``
    via ``allreduce``, ``get`` via ``put``) log their bytes only at the
    leaf op, so summing a group's ops never double-counts wire volume.
    Dispatch goes straight through: fault injection and retries are not
    part of this package yet.
    """

    __slots__ = ("group", "backend", "mesh", "device", "calls", "nbytes")

    def __init__(self, group: DiompGroup, backend: CclBackend,
                 mesh: Optional[RankMesh], device: torch.device,
                 calls: Dict[str, int], nbytes: Dict[str, int]):
        self.group = group
        self.backend = backend
        self.mesh = mesh
        self.device = device
        self.calls = calls    # shared across handles of the same group
        self.nbytes = nbytes  # op -> cumulative per-rank payload bytes

    def _mesh(self) -> RankMesh:
        if self.mesh is None:
            raise ValueError(
                "this context has no mesh: stacked-rank verbs need one "
                "(DiompContext(mesh=RankMesh(...)))")
        return self.mesh

    def record(self, op: str, payload=None) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        if payload is not None:
            self.nbytes[op] = self.nbytes.get(op, 0) \
                + _backends.payload_bytes(payload, self._mesh().size)

    def _dispatch(self, op: str, payload, thunk):
        self.record(op, payload)
        return thunk()

    # -- collectives --------------------------------------------------------
    def allreduce(self, x, *, op: str = "sum"):
        """ompx_allreduce: reduction across the group, result everywhere."""
        return self._dispatch(
            "allreduce", x,
            lambda: self.backend.allreduce(x, self.group, self._mesh(), op=op))

    def reduce(self, x, *, root: int = 0, op: str = "sum"):
        """ompx_reduce: like allreduce but only ``root`` keeps the result
        (others receive zeros).  Counts only: the inner allreduce logs the
        payload bytes."""
        self.record("reduce")
        full = self.allreduce(x, op=op)
        mesh = self._mesh()
        rank = _backends.group_rank(self.group, mesh, full.device)
        rank = rank.reshape(*mesh.sizes, *([1] * (full.dim() - mesh.ndim)))
        return torch.where(rank == root, full, torch.zeros_like(full))

    def bcast(self, x, *, root: int = 0):
        """ompx_bcast: root's value delivered to every group member."""
        return self._dispatch(
            "bcast", x,
            lambda: self.backend.bcast(x, self.group, self._mesh(), root=root))

    def allgather(self, x, *, axis: int = 0, tiled: bool = True,
                  invariant: bool = False):
        """ompx_allgather along a local axis (tiled: concatenates shards)."""
        return self._dispatch(
            "allgather", x,
            lambda: self.backend.allgather(x, self.group, self._mesh(),
                                           axis=axis, tiled=tiled,
                                           invariant=invariant))

    def reducescatter(self, x, *, axis: int = 0):
        """ompx_reducescatter: sum across group, scatter along ``axis``."""
        return self._dispatch(
            "reducescatter", x,
            lambda: self.backend.reducescatter(x, self.group, self._mesh(),
                                               axis=axis))

    def alltoall(self, x, *, split_axis: int = 0, concat_axis: int = 0):
        """ompx_alltoall — the MoE dispatch primitive."""
        return self._dispatch(
            "alltoall", x,
            lambda: self.backend.alltoall(x, self.group, self._mesh(),
                                          split_axis=split_axis,
                                          concat_axis=concat_axis))

    def permute(self, x, *, shift: int = 1):
        """Ring permute within the group — the transport under ompx_put."""
        return self._dispatch(
            "permute", x,
            lambda: self.backend.permute(x, self.group, self._mesh(),
                                         shift=shift))

    def barrier(self):
        """A collective-ordering token (ompx_barrier)."""
        return self._dispatch(
            "barrier", None,
            lambda: self.backend.barrier(self.group, self._mesh(),
                                         device=self.device))

    # -- one-sided RMA ------------------------------------------------------
    def put(self, x, *, shift: int = 1):
        """One-sided put to the rank ``shift`` ahead on the group's ring."""
        return self._dispatch(
            "put", x,
            lambda: self.backend.put(x, self.group, self._mesh(), shift=shift))

    def put_perm(self, x, perm: Sequence[Tuple[int, int]]):
        """General one-sided put along an arbitrary (src, dst) permutation."""
        return self._dispatch(
            "put", x,
            lambda: self.backend.put_perm(x, self.group, self._mesh(), perm))

    def get(self, x, *, shift: int = 1):
        """One-sided get of the shard owned by the rank ``shift`` ahead.
        Counts only: the inner put logs the payload bytes once."""
        self.record("get")
        return self.put(x, shift=-shift)

    def fence(self, *arrays):
        """Complete all outstanding RMA before anything downstream runs."""
        return _backends.fence(*arrays)

    def halo_exchange(self, x, *, halo: int, axis: int = 0):
        """Minimod's halo pattern (paper Listing 1) as one fused exchange."""
        return self._dispatch(
            "halo_exchange", x,
            lambda: self.backend.halo_exchange(x, self.group, self._mesh(),
                                               halo=halo, axis=axis))

    @property
    def backend_name(self) -> str:
        return self.backend.name

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Communicator(group={self.group.name}, "
                f"backend={self.backend.name})")


class CommTable:
    """The context's communicator table (OMPCCL's per-group comm registry):
    one call log per group descriptor, shared by every backend's handle for
    that group, plus one cached backend instance per backend name."""

    def __init__(self, mesh: Optional[RankMesh], device: torch.device):
        self.mesh = mesh
        self.device = device
        self._comms: Dict[Tuple[str, str], Communicator] = {}
        self._calls: Dict[str, Dict[str, int]] = {}
        self._nbytes: Dict[str, Dict[str, int]] = {}
        self._backends: Dict[str, CclBackend] = {}

    def backend_instance(self, backend: BackendLike,
                         default: str = "xla") -> CclBackend:
        if isinstance(backend, CclBackend):
            return backend
        name = backend or default
        if name not in self._backends:
            self._backends[name] = get_backend(name)()
        return self._backends[name]

    def communicator(self, group: DiompGroup,
                     backend: BackendLike = None) -> Communicator:
        if isinstance(backend, CclBackend):
            # caller-owned instance: keyed by identity so two differently
            # configured instances of one backend class never alias
            inst, bkey = backend, f"instance:{id(backend)}"
        else:
            inst = self.backend_instance(backend)
            bkey = inst.name
        key = (group.descriptor(), bkey)
        if key not in self._comms:
            calls = self._calls.setdefault(key[0], {})
            nbytes = self._nbytes.setdefault(key[0], {})
            self._comms[key] = Communicator(group, inst, self.mesh,
                                            self.device, calls, nbytes)
        return self._comms[key]

    def reset(self) -> None:
        """Zero every call count IN PLACE (live handles keep recording)."""
        for calls in self._calls.values():
            calls.clear()
        for nbytes in self._nbytes.values():
            nbytes.clear()

    def stats(self) -> Dict[str, Dict[str, int]]:
        """descriptor -> per-op call counts, aggregated over backends."""
        return {k: dict(v) for k, v in self._calls.items() if v}

    def byte_stats(self) -> Dict[str, Dict[str, int]]:
        """descriptor -> per-op cumulative per-rank payload bytes."""
        return {k: dict(v) for k, v in self._nbytes.items() if v}


class DispatchStats:
    """Auxiliary-stat collector for the MoE dispatch paths.

    The call/byte logs are host-side counters; token drops depend on the
    data (the ``slot < cap`` overflow mask), so they are device tensors.  A
    caller that wants them opens a frame around the work::

        with ctx.dispatch_stats.collect() as ds:
            logits, cache = step(params, tokens, cache)
        dropped, routed = ds.get("moe_dropped"), ds.get("moe_routed")

    ``moe_block`` and ``moe_dispatch`` record ``moe_dropped`` (zero on the
    dropless paths) and ``moe_routed`` (the (token, choice) pairs) into the
    innermost frame; records made outside any frame are dropped, so a step
    that does not ask pays nothing.  Values recorded under one key add up
    (over layers and calls).
    """

    def __init__(self):
        self._frames = []

    def record(self, **values) -> None:
        if not self._frames:
            return
        frame = self._frames[-1]
        for key, val in values.items():
            frame[key] = frame[key] + val if key in frame else val

    @contextmanager
    def collect(self):
        frame: Dict[str, object] = {}
        self._frames.append(frame)
        try:
            yield frame
        finally:
            self._frames.pop()


class DiompContext:
    """One deployment's unified runtime state (paper Fig. 1b, host side).

    ``mesh`` may be None for a bootstrap context (PGAS planning and group
    algebra need none); stacked-rank verbs need one.  ``device`` is where
    the context's entry points run: the card by default, ``"cpu"`` only
    when asked; asking for the card where there is none raises.
    """

    def __init__(
        self,
        mesh: Optional[RankMesh] = None,
        *,
        device="cuda",
        segment_bytes: int = 16 * 2**30,
        allocator: str = "linear",
        max_active_streams: int = 8,
        default_backend: str = "xla",
        comm_backend: str = "gasnet-ex",  # config fidelity; no-op here
        fault_plan=None,
    ):
        if fault_plan is not None:
            raise NotImplementedError(
                "fault injection (FaultPlan/ChaosBackend/RetryPolicy) is not "
                "ported yet: ROADMAP queue 1, item 14")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.comm_backend = comm_backend
        self.default_backend = default_backend
        self.ndev = mesh.size if mesh is not None else 1
        self.memory = GlobalMemory(self.ndev, segment_bytes,
                                   allocator=allocator)
        self.groups: Dict[str, DiompGroup] = (
            standard_groups(mesh) if mesh is not None else {})
        self.streams = StreamPool(max_active=max_active_streams)
        self.poller = HybridPoller()
        self.rma = RMATracker()
        self.dispatch_stats = DispatchStats()
        self.comms = CommTable(mesh, self.device)
        # bootstrap: validate every group's descriptor (UniqueID handshake)
        self._descriptors = {
            name: g.validate(mesh).descriptor()
            for name, g in self.groups.items()
        } if mesh is not None else {}

    def require_mesh(self) -> RankMesh:
        if self.mesh is None:
            raise ValueError("this context has no mesh")
        return self.mesh

    # -- group management ---------------------------------------------------
    def group(self, name: str) -> DiompGroup:
        return self.groups[name]

    def add_group(self, name: str, group: DiompGroup) -> DiompGroup:
        if self.mesh is not None:
            group.validate(self.mesh)
        self.groups[name] = group
        self._descriptors[name] = group.descriptor()
        return group

    # -- the communicator-handle API ----------------------------------------
    def communicator(self, group: Union[DiompGroup, str],
                     backend: BackendLike = None) -> Communicator:
        """The OMPCCL handle for ``group`` (by handle or registered name)."""
        if isinstance(group, str):
            group = self.groups[group]
        if self.mesh is not None:
            group.validate(self.mesh)
        return self.comms.communicator(
            group, backend if backend is not None else self.default_backend)

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-group, per-op collective call counts (the OMPCCL call log)."""
        return self.comms.stats()

    def byte_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-group, per-op cumulative per-rank payload bytes."""
        return self.comms.byte_stats()

    def retry_stats(self) -> Dict[str, Dict[str, int]]:
        """Re-issued wire attempts: none, since nothing injects faults."""
        return {}

    def reset_stats(self) -> None:
        self.comms.reset()

    # -- synchronization -----------------------------------------------------
    def fence(self, timeout_s: float = 120.0) -> None:
        """Host-side ompx_fence: drain host lanes, every registered poll
        source and the card's stream, then advance the RMA epoch."""
        self.streams.synchronize_all()
        self.poller.fence(timeout_s=timeout_s)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rma.on_fence()

    def close(self) -> None:
        self.streams.close()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        shape = self.mesh.shape if self.mesh is not None else None
        return (f"DiompContext(ndev={self.ndev}, mesh={shape}, "
                f"device={self.device}, groups={sorted(self.groups)}, "
                f"default_backend={self.default_backend!r})")


# ---------------------------------------------------------------------------
# default context (backs the paper-verbatim ompx_* free functions)
#
# Two layers: a process-wide default (init / install_default) and a
# ContextVar overlay for scoped use (use_default — per-thread/per-task).
# ---------------------------------------------------------------------------

_default: Optional[DiompContext] = None
_default_lock = threading.Lock()
_scoped: "contextvars.ContextVar[Optional[DiompContext]]" = \
    contextvars.ContextVar("diomp_torch_scoped_context", default=None)


def install_default(ctx: DiompContext) -> DiompContext:
    """Install ``ctx`` as the process default (returns it)."""
    global _default
    with _default_lock:
        _default = ctx
    return ctx


def init(mesh: Optional[RankMesh] = None, **kwargs) -> DiompContext:
    """Create a :class:`DiompContext` and install it as the process default."""
    return install_default(DiompContext(mesh=mesh, **kwargs))


def default_context() -> DiompContext:
    """The active context: the innermost ``use_default`` scope if one is
    open on this thread, else the process default (bootstrapping a meshless
    one on the card on first use)."""
    scoped = _scoped.get()
    if scoped is not None:
        return scoped
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = DiompContext(segment_bytes=1 << 20)
    return _default


@contextmanager
def use_default(ctx: DiompContext):
    """Make ``ctx`` the active context within the ``with`` block."""
    token = _scoped.set(ctx)
    try:
        yield ctx
    finally:
        _scoped.reset(token)


def default_communicator(group: DiompGroup,
                         backend: BackendLike = None) -> Communicator:
    """The active context's communicator handle for ``group``."""
    return default_context().communicator(group, backend)


_scratch: Dict[tuple, "DiompContext"] = {}


def scratch_context(ctx: DiompContext) -> DiompContext:
    """A context with ``ctx``'s mesh and device whose logs nobody reads.

    The reference records the verbs of a traced body once, however often
    the compiled body runs (a ``lax.scan`` body, a jitted step).  The port
    runs Python loops eagerly, so it replays every pass after the first
    against this context: ``ctx``'s call, byte and RMA logs then hold what
    the reference's hold."""
    key = (ctx.mesh, str(ctx.device))
    with _default_lock:
        if key not in _scratch:
            _scratch[key] = DiompContext(mesh=ctx.mesh, device=ctx.device,
                                         segment_bytes=1 << 20)
        return _scratch[key]


@contextmanager
def recorded_once(first: bool, parent: Optional[DiompContext] = None):
    """Run the block against the active context when ``first``, else
    against its :func:`scratch_context` (the trace-time logging rule).

    ``parent`` names the context to log against in place of the active one,
    which it becomes for the block: a layer's recompute under
    ``torch.utils.checkpoint`` runs in the autograd engine's thread on the
    card, where the caller's ``use_default`` scope is not seen.

    Only the logs are replayed silently: the scratch context lends the
    active context's ``dispatch_stats`` for the block, since the reference
    sums those over every layer its scan runs."""
    if first:
        if parent is None:
            yield default_context()
        else:
            with use_default(parent) as ctx:
                yield ctx
        return
    parent = default_context() if parent is None else parent
    scratch = scratch_context(parent)
    lent = scratch.dispatch_stats
    scratch.dispatch_stats = parent.dispatch_stats
    try:
        with use_default(scratch) as ctx:
            yield ctx
    finally:
        scratch.dispatch_stats = lent


def reset_default_context() -> None:
    """Drop the process default (tests); the next use bootstraps afresh."""
    global _default
    with _default_lock:
        _default = None
