"""OMPCCL backends — pluggable collective implementations on stacked ranks.

The paper's OMPCCL registers one communicator per DiOMP group and dispatches
every collective to a vendor library behind a stable API (§3.3).  Here the
"vendor libraries" are backend classes implementing :class:`CclBackend`
over stacked tensors: every verb takes the tensor holding ALL ranks (the
mesh axes are its leading dimensions, :mod:`repro_torch.launch.mesh`) and
returns the stacked result, i.e. what every rank holds afterwards.

* :class:`XlaBackend` — the flat path; the registry keeps the reference's
  name ``"xla"`` (alias ``"flat"``) so logs and ``default_backend`` compare
  equal.  Its verbs are torch ops over the group's rank dimensions.
* :class:`HierarchicalBackend` — pod-aware two-level algorithms from
  :mod:`repro_torch.distributed.hierarchical` (reduce-scatter over the fast
  axes -> all-reduce over the slow one -> all-gather over the fast ones).
* :class:`CompressedBackend` — int8 quantization + error feedback around
  the wire collective (:mod:`repro_torch.distributed.compression`);
* :class:`AnalyticBackend` — the flat path plus a per-call cost estimate on
  an H100 NVLink :class:`LinkModel`.

The analytic link-cost models (ring and hierarchical time bounds, the
gradient-reduction schedules) also live here; :mod:`.ompccl` re-exports
them.

A backend instance never records call counts — that is the communicator
handle's job (:mod:`repro_torch.core.context`).

Across processes (a mesh of a multi-process job,
:func:`repro_torch.launch.mesh.make_process_mesh`) a stacked operand holds
only this process's box of ranks.  A verb whose group lies inside every
process's box runs as above on the box.  A verb whose group crosses a
process boundary moves the slices it needs through the data plane of
:mod:`.coordination`: the one-sided verbs (``put``, ``put_perm``,
``permute``, ``halo_exchange``) fetch only the source ranks' slices
(:func:`~.coordination.rank_gather`); the collectives assemble the
group-major stack of every group touching the box
(:func:`~.coordination.assemble`) and apply the single-process verb to it
in its own order, so every result is bit for bit the one-process verb's.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..launch.mesh import RankMesh
from . import coordination
from .groups import DiompGroup

__all__ = [
    "CclBackend",
    "XlaBackend",
    "HierarchicalBackend",
    "CompressedBackend",
    "AnalyticBackend",
    "register_backend",
    "get_backend",
    "available_backends",
    "BackendError",
    "group_rank",
    "group_size",
    "payload_bytes",
    "fence",
    "check_stacked",
    "crosses_processes",
    "group_peers",
    "ring_roll",
    "zero_rank",
    "psum_axis",
    "psum_scatter_axis",
    "all_gather_axis",
    "LinkModel",
    "INTER_NODE_LINK",
    "ring_allreduce_time",
    "ring_allgather_time",
    "hierarchical_allreduce_time",
    "per_param_reduce_time",
    "bucketed_reduce_time",
    "overlapped_reduce_time",
]


class BackendError(ValueError):
    """Unknown backend name / invalid backend registration."""


# ---------------------------------------------------------------------------
# helpers shared by every backend
# ---------------------------------------------------------------------------


def _check_group(group: DiompGroup) -> None:
    if group.is_self_group():
        raise ValueError("collective on empty (self) group")


def _ring_dim(group: DiompGroup, mesh: RankMesh) -> int:
    if len(group.axes) != 1:
        raise ValueError(
            f"RMA rings need a single-axis group (one ring), got {group.axes}")
    return group.rank_dims(mesh)[0]


def crosses_processes(group: DiompGroup, mesh: RankMesh) -> bool:
    """True when some instance of ``group`` spans ranks of more than one
    process (its verbs need the cross-process data plane)."""
    return mesh.multiprocess and not mesh.spans(group.rank_dims(mesh))


def group_peers(group: DiompGroup, mesh: RankMesh, process: int) -> List[int]:
    """Global ranks sharing a ``group`` instance with a rank of
    ``process``: what a collective over the group reads there."""
    dims = group.rank_dims(mesh)
    out = set()
    for r in mesh.ranks_of(process):
        c = list(mesh.coords(r))
        for idx in itertools.product(*(range(mesh.sizes[d]) for d in dims)):
            for d, i in zip(dims, idx):
                c[d] = i
            out.add(mesh.flat(c))
    return sorted(out)


def _ring_sources(group: DiompGroup, mesh: RankMesh, shift: int,
                  edge: Optional[int] = None) -> List[Optional[int]]:
    """For every global rank, the rank ``shift`` behind it on the group's
    ring (None for ranks whose ring index is ``edge``)."""
    d = _ring_dim(group, mesh)
    n = mesh.sizes[d]
    src: List[Optional[int]] = []
    for r in range(mesh.size):
        c = list(mesh.coords(r))
        if c[d] == edge:
            src.append(None)
            continue
        c[d] = (c[d] - shift) % n
        src.append(mesh.flat(c))
    return src


def ring_roll(x: torch.Tensor, group: DiompGroup, mesh: RankMesh,
              shift: int, edge: Optional[int] = None) -> torch.Tensor:
    """A ring roll of the stacked ``x`` along the group's rank dim, across
    processes where the ring crosses them.  The ranks at ring index
    ``edge`` receive zeros in place of the wrapped slice (a non-periodic
    boundary: across processes nothing moves for them)."""
    if crosses_processes(group, mesh):
        return coordination.rank_gather(
            x, mesh, _ring_sources(group, mesh, shift, edge))
    d = _ring_dim(group, mesh)
    out = torch.roll(x, shifts=shift, dims=d)
    return out if edge is None else zero_rank(out, mesh, d, edge)


def zero_rank(t: torch.Tensor, mesh: RankMesh, dim: int,
              index: int) -> torch.Tensor:
    """Zero, in place, the slices of leading ``dim`` at global ``index``
    that lie in this process's box (a ring's non-periodic edge)."""
    b = mesh.box[dim]
    if b.start <= index < b.stop:
        t.select(dim, index - b.start).zero_()
    return t


def _local_dim(x: torch.Tensor, mesh: RankMesh, axis: int) -> int:
    """Tensor dimension of the per-rank (local) ``axis``."""
    nloc = x.dim() - mesh.ndim
    if nloc < 1 or not -nloc <= axis < nloc:
        raise ValueError(
            f"local axis {axis} out of range for a stacked tensor of shape "
            f"{tuple(x.shape)} over {mesh.ndim} mesh dims")
    return mesh.ndim + axis % nloc


def check_stacked(x: torch.Tensor, group: DiompGroup, mesh: RankMesh) -> None:
    """Refuse the self group and a tensor that does not lead with the mesh
    dims (this process's box of them)."""
    _check_group(group)
    if tuple(x.shape[:mesh.ndim]) != mesh.local_sizes:
        raise ValueError(
            f"stacked tensor of shape {tuple(x.shape)} does not lead with "
            f"the mesh dims {mesh.local_sizes}")


def _group_major(x: torch.Tensor, group: DiompGroup, mesh: RankMesh):
    """View ``x`` with the group's rank dims first, flattened to one dim of
    the group's row-major rank; returns ``(y, back)`` where ``back`` undoes
    the permutation on a tensor of the same rank layout (local dims may
    have changed size)."""
    check_stacked(x, group, mesh)
    if crosses_processes(group, mesh):
        raise ValueError(
            f"group {group.axes} crosses processes: run its verbs through "
            "a Communicator (the cross-process data plane)")
    dims = group.rank_dims(mesh)
    rest = [d for d in range(x.dim()) if d not in dims]
    perm = list(dims) + rest
    inv = [perm.index(d) for d in range(mesh.ndim)]   # mesh dims lead in y
    gsizes = [x.shape[d] for d in dims]
    y = x.permute(perm).reshape(math.prod(gsizes), *[x.shape[d] for d in rest])

    def back(z: torch.Tensor) -> torch.Tensor:
        z = z.reshape(*gsizes, *z.shape[1:])
        return z.permute(inv + list(range(mesh.ndim, z.dim()))).contiguous()

    return y, back


# -- one mesh axis's collective on a stacked tensor: the lax primitives the
#    reference's algorithms are written in.  ``dim`` indexes the stacked
#    tensor, so a local dim's index is past the leading mesh dims.

def psum_axis(x: torch.Tensor, mesh: RankMesh, axis: str) -> torch.Tensor:
    """``lax.psum`` over one mesh axis: every rank of the axis holds the
    sum (an expanded view)."""
    return x.sum(mesh.dim(axis), keepdim=True).expand_as(x)


def psum_scatter_axis(x: torch.Tensor, mesh: RankMesh, axis: str,
                      dim: int) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)`` over one mesh axis along tensor dim
    ``dim``: the sum over the axis, its chunk ``i`` to the axis' rank ``i``."""
    d, n = mesh.dim(axis), mesh.shape[axis]
    s = x.sum(d)
    if s.shape[dim - 1] % n:
        raise ValueError(f"axis extent {s.shape[dim - 1]} not divisible by "
                         f"{n} ranks of {axis!r}")
    return s.unflatten(dim - 1, (n, -1)).movedim(dim - 1, d)


def all_gather_axis(x: torch.Tensor, mesh: RankMesh, axis: str,
                    dim: int) -> torch.Tensor:
    """``lax.all_gather(tiled=True)`` over one mesh axis along tensor dim
    ``dim``: the axis' shards concatenated in rank order, on every rank of
    the axis (an expanded view)."""
    d, n = mesh.dim(axis), mesh.shape[axis]
    g = torch.cat(x.unbind(d), dim=dim - 1)
    return g.unsqueeze(d).expand(*g.shape[:d], n, *g.shape[d:])


def group_size(group: DiompGroup, mesh: RankMesh) -> int:
    return group.axis_size(mesh)


def group_rank(group: DiompGroup, mesh: RankMesh,
               device=None) -> torch.Tensor:
    """Linearized rank of every rank within the group (row-major over the
    group's axes), as an int tensor of the mesh's shape (this process's
    box of it)."""
    rank = torch.zeros(mesh.sizes, dtype=torch.int64, device=device)
    for ax in group.axes:
        d, n = mesh.dim(ax), mesh.shape[ax]
        idx = torch.arange(n, device=device).reshape(
            [n if i == d else 1 for i in range(mesh.ndim)])
        rank = rank * n + idx
    return rank[mesh.box]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)


def payload_bytes(x, ranks: int = 1) -> int:
    """Per-rank payload bytes of a stacked operand (or a nest of them).

    The reference counts one rank's shard (``shard_map`` sees local
    shapes); a stacked tensor carries every rank, so its bytes are divided
    by ``ranks`` — the ONE byte counter behind the communicator's
    wire-volume log and the analytic backend's estimates.  A numpy array
    is one rank's host buffer (the serving allocator's page payload) and
    counts whole.
    """
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    total = sum(t.numel() * t.element_size() for t in _leaves(x))
    if total % ranks:
        raise ValueError(
            f"payload of {total} bytes does not split over {ranks} ranks")
    return total // ranks


def fence(*arrays):
    """Complete all outstanding RMA before anything downstream runs.

    On the card every verb is stream-ordered, so the fence is an ordering
    point that returns its inputs; the host-side epoch discipline lives in
    :class:`~repro_torch.core.rma.RMATracker`.
    """
    if not arrays:
        return ()
    return arrays[0] if len(arrays) == 1 else tuple(arrays)


# ---------------------------------------------------------------------------
# the backend protocol + flat implementation
# ---------------------------------------------------------------------------


class CclBackend:
    """Protocol + default flat lowering for every OMPCCL verb.

    Subclasses override individual collectives; anything not overridden
    falls through to the flat algorithm.
    """

    #: registry name; subclasses must override.
    name = "xla"

    # -- collectives ---------------------------------------------------------
    def _across(self, verb: str, x, group: DiompGroup, mesh: RankMesh,
                **kw):
        """``verb`` over a group that crosses processes: the group-major
        stack of every group touching this box assembled, the verb run on
        it as one process runs it, this box's part of the result kept."""
        check_stacked(x, group, mesh)
        full = coordination.assemble(
            x, mesh, lambda p: group_peers(group, mesh, p))
        out = getattr(self, verb)(full, group, mesh.whole(), **kw)
        return out[mesh.box].contiguous()

    def allreduce(self, x, group: DiompGroup, mesh: RankMesh, *,
                  op: str = "sum"):
        if crosses_processes(group, mesh):
            return self._across("allreduce", x, group, mesh, op=op)
        y, back = _group_major(x, group, mesh)
        if op == "sum":
            r = y.sum(0, keepdim=True)
        elif op == "max":
            r = y.amax(0, keepdim=True)
        elif op == "min":
            r = y.amin(0, keepdim=True)
        elif op == "mean":
            r = y.mean(0, keepdim=True)
        else:
            raise ValueError(f"unsupported op {op!r}")
        return back(r.expand_as(y))

    def bcast(self, x, group: DiompGroup, mesh: RankMesh, *, root: int = 0):
        """Root's value delivered to every member: non-root contributions
        are zeroed and summed through ``self.allreduce``, so a backend that
        only overrides allreduce broadcasts over its own algorithm."""
        rank = group_rank(group, mesh, x.device)
        rank = rank.reshape(*mesh.local_sizes,
                            *([1] * (x.dim() - mesh.ndim)))
        contribution = torch.where(rank == root, x, torch.zeros_like(x))
        return self.allreduce(contribution, group, mesh)

    def allgather(self, x, group: DiompGroup, mesh: RankMesh, *,
                  axis: int = 0, tiled: bool = True, invariant: bool = False):
        """Concatenate every member's shard along local ``axis`` in the
        group's row-major rank order (``invariant`` changes no bytes)."""
        if crosses_processes(group, mesh):
            return self._across("allgather", x, group, mesh, axis=axis,
                                tiled=tiled, invariant=invariant)
        del invariant
        ld = _local_dim(x, mesh, axis)
        y, back = _group_major(x, group, mesh)
        at = ld - len(group.axes)          # the local dim inside one y[g]
        parts = y.unbind(0)
        if tiled:
            g = torch.cat(parts, dim=at)
        else:
            g = torch.stack(parts, dim=at).unflatten(
                at, [mesh.shape[a] for a in group.axes])
        return back(g.unsqueeze(0).expand(y.shape[0], *g.shape))

    def reducescatter(self, x, group: DiompGroup, mesh: RankMesh, *,
                      axis: int = 0):
        """Sum across the group; rank ``g`` keeps chunk ``g`` of ``axis``."""
        if crosses_processes(group, mesh):
            return self._across("reducescatter", x, group, mesh, axis=axis)
        ld = _local_dim(x, mesh, axis)
        y, back = _group_major(x, group, mesh)
        G, at = y.shape[0], ld - len(group.axes)
        s = y.sum(0)
        if s.shape[at] % G:
            raise ValueError(f"axis extent {s.shape[at]} not divisible by {G}")
        return back(s.unflatten(at, (G, -1)).movedim(at, 0))

    def alltoall(self, x, group: DiompGroup, mesh: RankMesh, *,
                 split_axis: int = 0, concat_axis: int = 0):
        if crosses_processes(group, mesh):
            return self._across("alltoall", x, group, mesh,
                                split_axis=split_axis,
                                concat_axis=concat_axis)
        ls = _local_dim(x, mesh, split_axis) - len(group.axes)
        lc = _local_dim(x, mesh, concat_axis) - len(group.axes)
        y, back = _group_major(x, group, mesh)
        G = y.shape[0]
        if y.shape[1 + ls] % G:
            raise ValueError(
                f"split extent {y.shape[1 + ls]} not divisible by {G}")
        chunks = [y[g].chunk(G, dim=ls) for g in range(G)]
        out = torch.stack([torch.cat([chunks[g][j] for g in range(G)], dim=lc)
                           for j in range(G)])
        return back(out)

    def permute(self, x, group: DiompGroup, mesh: RankMesh, *,
                shift: int = 1):
        if len(group.axes) != 1:
            raise ValueError("permute requires a single-axis group")
        check_stacked(x, group, mesh)
        return ring_roll(x, group, mesh, shift)

    def barrier(self, group: DiompGroup, mesh: RankMesh, *, device=None):
        """A collective-ordering token: the group sum of a zero per rank
        (across processes, a real exchange among the group's processes)."""
        _check_group(group)
        token = torch.zeros(mesh.local_sizes, dtype=torch.float32,
                            device=device)
        if crosses_processes(group, mesh):
            return self._across("allreduce", token, group, mesh)
        return token

    # -- one-sided RMA -------------------------------------------------------
    def put(self, x, group: DiompGroup, mesh: RankMesh, *, shift: int = 1):
        """One-sided put of every rank's shard to the rank ``shift`` ahead.

        Every rank's window receives the shard of the rank ``shift`` behind
        it (``shift`` may be negative): a roll along the ring's rank dim.
        """
        check_stacked(x, group, mesh)
        return ring_roll(x, group, mesh, shift)

    def put_perm(self, x, group: DiompGroup, mesh: RankMesh,
                 perm: Sequence[Tuple[int, int]]):
        """General one-sided put along a (src, dst) permutation; ranks that
        receive nothing hold zeros."""
        d = _ring_dim(group, mesh)
        check_stacked(x, group, mesh)
        if crosses_processes(group, mesh):
            of = dict((int(b), int(a)) for a, b in perm)
            src: List[Optional[int]] = []
            for r in range(mesh.size):
                c = list(mesh.coords(r))
                if c[d] not in of:
                    src.append(None)
                    continue
                c[d] = of[c[d]]
                src.append(mesh.flat(c))
            return coordination.rank_gather(x, mesh, src)
        out = torch.zeros_like(x)
        for src, dst in perm:
            out.select(d, dst).copy_(x.select(d, src))
        return out

    def halo_exchange(self, x, group: DiompGroup, mesh: RankMesh, *,
                      halo: int, axis: int = 0):
        """Minimod's halo pattern (paper Listing 1) as one exchange.

        Every rank puts its left slab to the left neighbour's right halo and
        its right slab to the right neighbour's left halo, then fences.
        Returns ``(left_halo, right_halo)``; edge ranks receive zeros.
        """
        from .rma import validate_halo   # rma imports this module

        ld = _local_dim(x, mesh, axis)
        extent = x.shape[ld]
        validate_halo(halo, extent, axis)
        d = _ring_dim(group, mesh)
        check_stacked(x, group, mesh)
        n = mesh.sizes[d]
        from_left = ring_roll(x.narrow(ld, extent - halo, halo), group,
                              mesh, 1, edge=0)
        from_right = ring_roll(x.narrow(ld, 0, halo), group, mesh, -1,
                               edge=n - 1)
        return fence(from_left, from_right)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}({self.name!r})"


class XlaBackend(CclBackend):
    """The flat path: every verb is the base-class lowering."""

    name = "xla"


class HierarchicalBackend(CclBackend):
    """Pod-aware two-level algorithms (NCCL's topology-trees analogue).

    The group's first axis is the slow (inter-pod) one, the rest are fast.
    Every verb this class does not override is the flat one."""

    name = "hierarchical"

    def allreduce(self, x, group: DiompGroup, mesh: RankMesh, *,
                  op: str = "sum"):
        if crosses_processes(group, mesh):
            return self._across("allreduce", x, group, mesh, op=op)
        from ..distributed.hierarchical import hierarchical_allreduce

        return hierarchical_allreduce(x, group, mesh, op=op)

    def reducescatter(self, x, group: DiompGroup, mesh: RankMesh, *,
                      axis: int = 0):
        """Fast-axes-first reduce-scatter: the payload is cut to 1/F
        intra-pod before anything crosses the slow link.

        Shard order is therefore fast-major — the exact inverse of this
        backend's ``allgather(invariant=True)``, so an RS -> invariant-AG
        pair through one hierarchical handle reconstructs the flat result.
        It is NOT the row-major shard order of the flat backend, and the
        handle's non-invariant allgather keeps the row-major concat order:
        pairing RS with ``invariant=False`` returns element-permuted data.
        """
        if len(group.axes) < 2 or crosses_processes(group, mesh):
            return super().reducescatter(x, group, mesh, axis=axis)
        check_stacked(x, group, mesh)
        dim = _local_dim(x, mesh, axis)
        slow, fast = group.axes[0], group.axes[1:]
        out = x
        for ax in (*fast, slow):
            out = psum_scatter_axis(out, mesh, ax, dim)
        return out.contiguous()

    def allgather(self, x, group: DiompGroup, mesh: RankMesh, *,
                  axis: int = 0, tiled: bool = True, invariant: bool = False):
        if len(group.axes) < 2 or not tiled \
                or crosses_processes(group, mesh):
            return super().allgather(x, group, mesh, axis=axis, tiled=tiled,
                                     invariant=invariant)
        if not invariant:
            from ..distributed.hierarchical import hierarchical_allgather

            return hierarchical_allgather(x, group, mesh, axis=axis)
        # slow link first, while the payload is smallest; inverts this
        # backend's reducescatter step for step
        check_stacked(x, group, mesh)
        dim = _local_dim(x, mesh, axis)
        slow, fast = group.axes[0], group.axes[1:]
        out = x
        for ax in (slow, *reversed(fast)):
            out = all_gather_axis(out, mesh, ax, dim)
        return out.contiguous()


class CompressedBackend(CclBackend):
    """int8 + error-feedback wire compression around the reduce.

    ``allreduce`` honors the CclBackend contract (returns the reduced
    tensor); the quantization residual is dropped.  Error-feedback
    training loops need the residual as a carry from step to step, so they
    call :func:`repro_torch.distributed.compression.compressed_allreduce`
    directly: a backend instance cannot thread a per-step carry."""

    name = "compressed"

    def allreduce(self, x, group: DiompGroup, mesh: RankMesh, *,
                  op: str = "sum", error=None):
        from ..distributed.compression import compressed_allreduce

        if op != "sum":
            raise ValueError(
                f"compressed backend reduces op='sum' only, got {op!r} "
                "(min/max do not decompose through quantized chunks)")
        if crosses_processes(group, mesh):
            return self._across("allreduce", x, group, mesh, op=op,
                                error=error)
        check_stacked(x, group, mesh)
        # compressed_allreduce returns the group MEAN; scale back to the
        # sum the CclBackend contract promises
        out, _residual = compressed_allreduce(x, group, mesh, error=error)
        return out * group_size(group, mesh)


class AnalyticBackend(CclBackend):
    """Flat path + a host-side analytic cost log per call.

    Each collective appends an estimate row to :attr:`estimates` (op,
    per-rank payload bytes, group size, modeled seconds on
    :class:`LinkModel`).
    """

    name = "analytic"

    def __init__(self, link: Optional["LinkModel"] = None):
        self.link = link or LinkModel()
        self.estimates: List[dict] = []

    def _note(self, op: str, x, group: DiompGroup, mesh: RankMesh,
              time_fn) -> None:
        nbytes = payload_bytes(x, mesh.local_size)
        ndev = group_size(group, mesh)
        self.estimates.append({"op": op, "bytes": nbytes, "ndev": ndev,
                               "est_s": time_fn(nbytes, ndev)})

    def allreduce(self, x, group, mesh, *, op: str = "sum"):
        self._note("allreduce", x, group, mesh,
                   lambda b, n: ring_allreduce_time(b, n, self.link))
        return super().allreduce(x, group, mesh, op=op)

    def allgather(self, x, group, mesh, *, axis: int = 0, tiled: bool = True,
                  invariant: bool = False):
        self._note("allgather", x, group, mesh,
                   lambda b, n: ring_allgather_time(b * n, n, self.link))
        return super().allgather(x, group, mesh, axis=axis, tiled=tiled,
                                 invariant=invariant)

    def reducescatter(self, x, group, mesh, *, axis: int = 0):
        self._note("reducescatter", x, group, mesh,
                   lambda b, n: ring_allgather_time(b, n, self.link))
        return super().reducescatter(x, group, mesh, axis=axis)

    def alltoall(self, x, group, mesh, *, split_axis: int = 0,
                 concat_axis: int = 0):
        self._note("alltoall", x, group, mesh,
                   lambda b, n: ring_allgather_time(b, n, self.link))
        return super().alltoall(x, group, mesh, split_axis=split_axis,
                                concat_axis=concat_axis)

    def put(self, x, group, mesh, *, shift: int = 1):
        self._note("put", x, group, mesh,
                   lambda b, n: b / self.link.bandwidth_Bps
                   + self.link.latency_s)
        return super().put(x, group, mesh, shift=shift)


# ---------------------------------------------------------------------------
# backend registry (models OMPCCL's vendor-library dispatch table)
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Type[CclBackend]] = {}


def register_backend(cls: Type[CclBackend], *,
                     name: Optional[str] = None,
                     aliases: Sequence[str] = ()) -> Type[CclBackend]:
    """Register a backend class under ``cls.name`` (usable as a decorator)."""
    if not (isinstance(cls, type) and issubclass(cls, CclBackend)):
        raise BackendError(f"{cls!r} is not a CclBackend subclass")
    key = name or cls.name
    if not key:
        raise BackendError(f"{cls.__name__} has no backend name")
    _BACKENDS[key] = cls
    for alias in aliases:
        _BACKENDS[alias] = cls
    return cls


def get_backend(name: str) -> Type[CclBackend]:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise BackendError(
            f"unknown OMPCCL backend {name!r}; available: "
            f"{sorted(set(_BACKENDS))}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(set(_BACKENDS)))


register_backend(XlaBackend, aliases=("flat",))
register_backend(HierarchicalBackend)
register_backend(CompressedBackend)
register_backend(AnalyticBackend)


# ---------------------------------------------------------------------------
# analytic cost model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """H100 NVLink link model: one direction of one card's NVLink.

    ``bandwidth_Bps``: 900 GB/s to the other cards of the host, all to all,
    i.e. 450 GB/s each way (NVIDIA's H100 SXM data sheet).

    ``latency_s``: the per-hop latency of a ring step.  It stays 0.0: with
    every rank on one card no collective crosses an NVLink hop, so no run
    of the port can measure it, and the data sheet gives none.

    ``dispatch_s``: the host's time to issue one collective: the host time
    of one ``ompccl.allreduce`` call of a 4 KiB payload a rank over the
    (pod, data) group of the 8-rank smoke mesh, measured by
    ``chip_smoke.py``'s runtime phase on an NVIDIA H100 80GB HBM3 at a
    700 W power limit: 74.75 µs, the middle of the medians of the eight
    runs recorded so far (50.90, 56.14, 56.82, 69.12, 80.38, 80.76, 80.89
    and 91.03 µs; single timings of 200 calls from 46.99 to 96.32 µs).
    The runs disagree: one's timings fell into two groups, 49.13 to 50.90
    and 81.06 to 88.84 µs, another's lay from 46.99 to 70.60, another's
    from 81.51 to 96.32, a later one's from 70.07 to 137.03 (median
    117.03); the host's cores are shared.  The least timing of a run is
    the one other processes disturb least (45.78 to 81.51 µs where
    recorded), and ``chip_smoke.py`` fails if it lies outside half to one
    and a half times this value.
    """

    bandwidth_Bps: float = 450e9
    latency_s: float = 0.0
    dispatch_s: float = 74.75e-6

    def collective_time(self, nbytes: int, ndev: int) -> float:
        """One ring all-reduce including the per-call dispatch overhead —
        the unit cost both gradient-reduction schedules are built from."""
        return self.dispatch_s + ring_allreduce_time(nbytes, ndev, self)


#: One H100's network port between hosts: a ConnectX-7 adapter at 400 Gb/s,
#: i.e. 50 GB/s each way (NVIDIA's ConnectX-7 data sheet; one adapter a card
#: in the DGX H100).  Its latency is not measured here either.
INTER_NODE_LINK = LinkModel(bandwidth_Bps=50e9)


def ring_allreduce_time(bytes_: int, ndev: int,
                        link: LinkModel = LinkModel()) -> float:
    """2(n-1)/n · B / bw + 2(n-1) · lat — the classic ring bound."""
    if ndev <= 1:
        return 0.0
    steps = 2 * (ndev - 1)
    return steps * link.latency_s + (steps / ndev) * bytes_ \
        / link.bandwidth_Bps


def ring_allgather_time(bytes_out: int, ndev: int,
                        link: LinkModel = LinkModel()) -> float:
    if ndev <= 1:
        return 0.0
    steps = ndev - 1
    return steps * link.latency_s + (steps / ndev) * bytes_out \
        / link.bandwidth_Bps


def hierarchical_allreduce_time(
    bytes_: int,
    intra: int,
    inter: int,
    intra_link: LinkModel = LinkModel(),
    inter_link: LinkModel = INTER_NODE_LINK,
) -> float:
    """RS(intra) + AR(inter, on 1/intra of the data) + AG(intra)."""
    t_rs = ring_allgather_time(bytes_, intra, intra_link)  # RS cost == AG cost
    t_ar = ring_allreduce_time(bytes_ // max(intra, 1), inter, inter_link)
    t_ag = ring_allgather_time(bytes_, intra, intra_link)
    return t_rs + t_ar + t_ag


def per_param_reduce_time(sizes_bytes: Sequence[int], ndev: int,
                          link: LinkModel = LinkModel(),
                          *, compute_s: float = 0.0) -> float:
    """The per-param issue schedule: the whole backward finishes, then one
    collective per parameter runs back-to-back — nothing overlaps."""
    return compute_s + sum(link.collective_time(b, ndev) for b in sizes_bytes)


def bucketed_reduce_time(bucket_bytes: Sequence[int], ndev: int,
                         link: LinkModel = LinkModel(),
                         *, compute_s: float = 0.0) -> float:
    """The non-overlapped bucketed schedule: the whole backward finishes,
    then every bucket's all-reduce runs back-to-back.  Its cost model is
    per-param issue's, over the bucket payloads."""
    return per_param_reduce_time(bucket_bytes, ndev, link,
                                 compute_s=compute_s)


def overlapped_reduce_time(bucket_bytes: Sequence[int], ndev: int,
                           link: LinkModel = LinkModel(),
                           *, compute_s: float = 0.0,
                           microbatches: int = 1) -> float:
    """The backward-overlap schedule: every microbatch's buckets
    reduce-scatter under the next microbatch's backward, and one all-gather
    per bucket trails.  Wire volume is ``(k + 1)·B·(n-1)/n`` per bucket
    against the single all-reduce's ``2B(n-1)/n``."""
    buckets = list(bucket_bytes)
    k = max(microbatches, 1)
    if not buckets:
        return compute_s

    def phase(b):  # one RS or AG pass: half an allreduce + its dispatch
        if ndev <= 1:
            return link.dispatch_s
        return link.dispatch_s + (ndev - 1) * (
            link.latency_s + b / (ndev * link.bandwidth_Bps))

    per_slot_compute = compute_s / (k * len(buckets))
    done = 0.0
    slot = 0
    for _ in range(k):
        for b in buckets:
            slot += 1
            done = max(done, slot * per_slot_compute) + phase(b)
    for b in buckets:            # trailing all-gathers: nothing hides them
        done += phase(b)
    return done
