"""OMPCCL — the portable collective communication layer (paper §3.3).

The wire algorithms live in :mod:`repro_torch.core.backends`; the
communicator handles and the per-group call log live in
:mod:`repro_torch.core.context`.  This module is the paper-verbatim *free
function* surface: every call resolves the active
:class:`~repro_torch.core.context.DiompContext`, obtains the communicator
handle for ``(group, backend)``, and dispatches through it, so
listing-style and handle-style code record the same call stream.
"""

from __future__ import annotations

from .backends import (  # noqa: F401  (re-exports)
    LinkModel,
    group_rank,
    group_size,
    ring_allgather_time,
    ring_allreduce_time,
)
from .context import Communicator, default_communicator as _comm
from .groups import DiompGroup

__all__ = [
    "Communicator",
    "allreduce",
    "reduce",
    "bcast",
    "allgather",
    "reducescatter",
    "alltoall",
    "permute",
    "barrier_value",
    "group_rank",
    "group_size",
    "LinkModel",
    "ring_allreduce_time",
    "ring_allgather_time",
]


def allreduce(x, group: DiompGroup, *, op: str = "sum", backend: str = None):
    """ompx_allreduce: reduction across the group, result on every member."""
    return _comm(group, backend).allreduce(x, op=op)


def reduce(x, group: DiompGroup, *, root: int = 0, op: str = "sum",
           backend: str = None):
    """ompx_reduce: like allreduce but only ``root`` keeps the result."""
    return _comm(group, backend).reduce(x, root=root, op=op)


def bcast(x, group: DiompGroup, *, root: int = 0, backend: str = None):
    """ompx_bcast: root's value delivered to every group member."""
    return _comm(group, backend).bcast(x, root=root)


def allgather(x, group: DiompGroup, *, axis: int = 0, tiled: bool = True,
              invariant: bool = False, backend: str = None):
    """ompx_allgather along a local axis (tiled: concatenates shards)."""
    return _comm(group, backend).allgather(x, axis=axis, tiled=tiled,
                                           invariant=invariant)


def reducescatter(x, group: DiompGroup, *, axis: int = 0,
                  backend: str = None):
    """ompx_reducescatter: sum across group, scatter shards along ``axis``."""
    return _comm(group, backend).reducescatter(x, axis=axis)


def alltoall(x, group: DiompGroup, *, split_axis: int = 0,
             concat_axis: int = 0, backend: str = None):
    """ompx_alltoall — the MoE dispatch primitive."""
    return _comm(group, backend).alltoall(x, split_axis=split_axis,
                                          concat_axis=concat_axis)


def permute(x, group: DiompGroup, *, shift: int = 1, backend: str = None):
    """Ring permute within the group — the transport under ompx_put."""
    return _comm(group, backend).permute(x, shift=shift)


def barrier_value(group: DiompGroup, *, backend: str = None):
    """A collective-ordering token: the group sum of a zero per rank."""
    return _comm(group, backend).barrier()
