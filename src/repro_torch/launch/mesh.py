"""The rank mesh: named axes with sizes, laid out as leading tensor dims.

The reference builds a ``jax`` device mesh; here one card holds every
rank, so a mesh is only names and sizes.  A stacked tensor over a mesh has
``len(axis_names)`` leading dimensions, one per axis in mesh order, followed
by the per-rank (local) dimensions.

A mesh of a multi-process job (:func:`make_process_mesh`) also says which
process owns each rank: process-major contiguous blocks of
``ranks_per_process`` ranks in mesh order, as jax's global device order
is.  Each block must be a box of the leading dims (``box``), and a
process's stacked tensors hold only its box: their leading dims are
``local_sizes``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["RankMesh", "make_production_mesh", "make_smoke_mesh",
           "make_process_mesh"]


def _box(sizes: Tuple[int, ...], k: int, p: int) -> Tuple[slice, ...]:
    """The box of flat ranks ``[p·k, (p+1)·k)`` in a row-major mesh of
    ``sizes``; raises where the block is not one."""
    trail = 1
    for j in range(len(sizes) - 1, -1, -1):
        if k % trail == 0 and sizes[j] % (k // trail) == 0:
            m = k // trail          # the block spans m of dim j, all after it
            lead = p * k // (trail * sizes[j])
            start = (p * k // trail) % sizes[j]
            box = []
            for d in range(j - 1, -1, -1):
                box.append(slice(lead % sizes[d], lead % sizes[d] + 1))
                lead //= sizes[d]
            return (*reversed(box), slice(start, start + m),
                    *(slice(0, s) for s in sizes[j + 1:]))
        trail *= sizes[j]
    raise ValueError(
        f"blocks of {k} ranks are not boxes of the mesh {sizes}: a "
        "process's ranks must be whole trailing dims and a divisor of the "
        "next one")


class RankMesh:
    """Named mesh axes with sizes (the counterpart of ``jax.sharding.Mesh``).

    ``ranks_per_process`` (None: this process holds every rank) splits the
    ranks over the processes of a job, process-major; ``process_id`` is
    this process's, whose ranks make :attr:`box`."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int], *,
                 ranks_per_process: Optional[int] = None,
                 process_id: int = 0):
        axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in sizes)
        if len(axis_names) != len(sizes):
            raise ValueError(f"axes {axis_names} vs sizes {sizes} rank mismatch")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axes {axis_names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
        self.axis_names: Tuple[str, ...] = axis_names
        self.sizes: Tuple[int, ...] = sizes
        size = math.prod(sizes)
        k = size if ranks_per_process is None else int(ranks_per_process)
        if k < 1 or size % k:
            raise ValueError(f"{size} ranks do not split into blocks of {k}")
        self.ranks_per_process = k
        self.num_processes = size // k
        if not 0 <= process_id < self.num_processes:
            raise ValueError(f"process {process_id} outside the mesh's "
                             f"{self.num_processes} processes")
        self.process_id = int(process_id)
        self.box: Tuple[slice, ...] = _box(sizes, k, self.process_id)
        self.local_sizes: Tuple[int, ...] = tuple(b.stop - b.start
                                                  for b in self.box)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in mesh order (as ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    @property
    def size(self) -> int:
        """Number of ranks."""
        return math.prod(self.sizes)

    @property
    def multiprocess(self) -> bool:
        return self.num_processes > 1

    @property
    def local_size(self) -> int:
        """Number of ranks this process holds."""
        return self.ranks_per_process

    def owner(self, rank: int) -> int:
        """The process owning global flat ``rank``."""
        return rank // self.ranks_per_process

    def ranks_of(self, process: int) -> range:
        """Global flat ranks of ``process``, in mesh order."""
        k = self.ranks_per_process
        return range(process * k, (process + 1) * k)

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        return tuple(self.ranks_of(self.process_id))

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Mesh coordinates of global flat ``rank``."""
        out = []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def flat(self, coords: Sequence[int]) -> int:
        """Global flat rank of mesh ``coords``."""
        r = 0
        for c, s in zip(coords, self.sizes):
            r = r * s + c
        return r

    def spans(self, dims: Sequence[int]) -> bool:
        """True when this process's box holds every index of the leading
        ``dims`` (a group over them lies inside every process)."""
        return all(self.local_sizes[d] == self.sizes[d] for d in dims)

    def whole(self) -> "RankMesh":
        """The same mesh held by one process (every rank local)."""
        return RankMesh(self.axis_names, self.sizes)

    def local_box(self, t):
        """This process's box of a full stacked tensor: ``t`` itself when
        the process holds every rank, else a copy (so ``t`` can be
        freed)."""
        return t[self.box].clone() if self.multiprocess else t

    def dim(self, axis: str) -> int:
        """Leading tensor dimension that carries ``axis``."""
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(
                f"axis {axis!r} not in mesh {self.axis_names}") from None

    def _key(self):
        return (self.axis_names, self.sizes, self.ranks_per_process,
                self.process_id)

    def __eq__(self, other) -> bool:
        return isinstance(other, RankMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        proc = (f", process {self.process_id} of {self.num_processes}"
                if self.multiprocess else "")
        return f"RankMesh({self.shape}{proc})"


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """16x16 = 256 ranks per pod; multi_pod prepends a 2-pod axis (512)."""
    if multi_pod:
        return RankMesh(("pod", "data", "model"), (2, 16, 16))
    return RankMesh(("data", "model"), (16, 16))


def _smoke_shape(ndev: int, pods: bool) -> Tuple[Tuple[int, ...],
                                                 Tuple[str, ...]]:
    if pods and ndev % 4 == 0:
        return (2, ndev // 4, 2), ("pod", "data", "model")
    return (max(ndev // 2, 1), min(ndev, 2)), ("data", "model")


def make_smoke_mesh(ndev: int = 8, *, pods: bool = True) -> RankMesh:
    """Small mesh for tests and examples (8 virtual ranks by default)."""
    if ndev <= 0:
        raise ValueError(f"ndev must be positive, got {ndev}")
    shape, axes = _smoke_shape(ndev, pods)
    return RankMesh(axes, shape)


def make_process_mesh(
    ndev_per_proc: Optional[int] = None,
    num_processes: Optional[int] = None,
    *,
    shape: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[str]] = None,
    pods: bool = False,
) -> RankMesh:
    """Mesh over the **global** rank set of a multi-process job.

    ``ndev_per_proc`` / ``num_processes`` default to the job's actual
    topology (:func:`repro_torch.core.coordination.init_distributed`; one
    process of :data:`~repro_torch.core.coordination.SINGLE_PROCESS_RANKS`
    ranks outside a job); passing them pins the expectation and raises if
    the launch does not match, so a worker that came up with the wrong
    rank count dies loudly.  ``shape``/``axes`` override the default
    layout (e.g. ``shape=(n,), axes=("x",)`` for ring suites); the default
    is the smoke-mesh layout over ``ndev_per_proc * num_processes`` ranks.

    Rank order is process-major, so consecutive mesh positions within a
    process's block are process-local and every process computes the
    identical global layout; each block must be a box of the leading dims.
    """
    from ..core import coordination

    actual_local = coordination.local_device_count()
    if coordination.is_distributed():
        import torch.distributed as dist

        actual_procs, me = dist.get_world_size(), dist.get_rank()
    else:
        actual_procs, me = 1, 0
    if ndev_per_proc is None:
        ndev_per_proc = actual_local
    if num_processes is None:
        num_processes = actual_procs
    if ndev_per_proc != actual_local:
        raise ValueError(
            f"make_process_mesh(ndev_per_proc={ndev_per_proc}) but this "
            f"process holds {actual_local} local devices (ranks) — pass "
            "local_device_count to diomp.init / init_distributed")
    if num_processes != actual_procs:
        raise ValueError(
            f"make_process_mesh(num_processes={num_processes}) but the "
            f"job has {actual_procs} processes — check the launch "
            "(coordinator/num_processes/process_id)")
    total = ndev_per_proc * num_processes
    if shape is None:
        shape, default_axes = _smoke_shape(total, pods)
        axes = tuple(axes) if axes is not None else default_axes
    else:
        shape = tuple(int(s) for s in shape)
        if axes is None:
            raise ValueError("explicit shape needs explicit axes")
        axes = tuple(axes)
    if math.prod(shape) != total:
        raise ValueError(
            f"mesh shape {shape} covers {math.prod(shape)} ranks, the "
            f"job has {total}")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes} rank mismatch")
    return RankMesh(axes, shape, ranks_per_process=ndev_per_proc,
                    process_id=me)
